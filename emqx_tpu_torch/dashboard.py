"""Single-file web dashboard (the role of EMQX's ``emqx_dashboard``,
which serves a packaged single-page app).  The whole UI is one
dependency-free HTML document talking to the same JSON API operators
script against: JWT login (POST /api/v5/login), overview cards and live
counters, and clients/subscriptions/topics/alarms/rules tables with
kick and refresh actions.  No build step and no external assets: it
works air-gapped.  The document is the JAX package's, byte for byte.
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>emqx_tpu dashboard</title>
<style>
:root{--bg:#10151c;--panel:#1a222d;--line:#2c3a4a;--fg:#d8e1ea;
  --dim:#8296aa;--acc:#3fd08c;--warn:#e0a34a;--err:#e06060}
*{box-sizing:border-box}
body{margin:0;font:14px/1.5 -apple-system,'Segoe UI',Roboto,sans-serif;
  background:var(--bg);color:var(--fg)}
header{display:flex;align-items:center;gap:1em;padding:.7em 1.2em;
  background:var(--panel);border-bottom:1px solid var(--line)}
header h1{font-size:1.05em;margin:0;color:var(--acc)}
header .node{color:var(--dim);font-size:.85em}
header button{margin-left:auto}
nav{display:flex;gap:.25em;padding:.4em 1.2em;background:var(--panel);
  border-bottom:1px solid var(--line)}
nav a{color:var(--dim);text-decoration:none;padding:.3em .8em;
  border-radius:4px;cursor:pointer}
nav a.on{color:var(--fg);background:var(--line)}
main{padding:1.2em;max-width:1200px;margin:0 auto}
.cards{display:grid;grid-template-columns:repeat(auto-fill,minmax(170px,1fr));
  gap:.8em;margin-bottom:1.2em}
.card{background:var(--panel);border:1px solid var(--line);
  border-radius:6px;padding:.8em 1em}
.card .v{font-size:1.6em;font-weight:600}
.card .k{color:var(--dim);font-size:.8em}
table{width:100%;border-collapse:collapse;background:var(--panel);
  border:1px solid var(--line);border-radius:6px;overflow:hidden}
th,td{text-align:left;padding:.45em .8em;border-bottom:1px solid var(--line);
  font-size:.88em}
th{color:var(--dim);font-weight:500;text-transform:uppercase;
  font-size:.72em;letter-spacing:.05em}
tr:last-child td{border-bottom:none}
button{background:var(--line);color:var(--fg);border:1px solid #3d4f63;
  border-radius:4px;padding:.3em .9em;cursor:pointer;font-size:.85em}
button:hover{background:#37485c}
button.danger{color:var(--err)}
input{background:var(--bg);color:var(--fg);border:1px solid var(--line);
  border-radius:4px;padding:.45em .7em;font-size:.95em}
#login{display:flex;min-height:100vh;align-items:center;
  justify-content:center}
#login form{background:var(--panel);border:1px solid var(--line);
  border-radius:8px;padding:2em;display:flex;flex-direction:column;
  gap:.8em;width:300px}
#login h1{font-size:1.1em;margin:0 0 .5em;color:var(--acc)}
.err{color:var(--err);font-size:.85em;min-height:1.2em}
.pill{display:inline-block;padding:0 .5em;border-radius:8px;
  font-size:.78em;background:var(--line)}
.pill.up{color:var(--acc)}.pill.down{color:var(--dim)}
.muted{color:var(--dim)}
</style>
</head>
<body>
<div id="login" hidden>
  <form onsubmit="return doLogin(event)">
    <h1>emqx_tpu</h1>
    <input id="u" placeholder="username" autocomplete="username">
    <input id="p" type="password" placeholder="password"
      autocomplete="current-password">
    <button type="submit">Sign in</button>
    <div class="err" id="lerr"></div>
  </form>
</div>
<div id="app" hidden>
  <header>
    <h1>emqx_tpu</h1><span class="node" id="node"></span>
    <button onclick="logout()">Sign out</button>
  </header>
  <nav id="tabs"></nav>
  <main id="view"></main>
</div>
<script>
"use strict";
const TABS = ["overview","clients","subscriptions","topics","alarms",
              "rules","metrics"];
let tab = location.hash.slice(1) || "overview";
let timer = null;
const $ = id => document.getElementById(id);
const tok = () => sessionStorage.getItem("token");

async function api(path, opts) {
  const r = await fetch(path, Object.assign({headers:
    {"Authorization": "Bearer " + tok(),
     "Content-Type": "application/json"}}, opts));
  if (r.status === 401) { logout(); throw new Error("unauthorized"); }
  if (!r.ok) throw new Error(await r.text());
  const t = await r.text();
  return t ? JSON.parse(t) : null;
}
function esc(s) {
  return String(s).replace(/[&<>"]/g,
    c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
}
async function doLogin(ev) {
  ev.preventDefault();
  try {
    const r = await fetch("/api/v5/login", {method:"POST",
      headers:{"Content-Type":"application/json"},
      body: JSON.stringify({username:$("u").value,
                            password:$("p").value})});
    if (!r.ok) { $("lerr").textContent = "login failed"; return false; }
    const d = await r.json();
    sessionStorage.setItem("token", d.token);
    boot();
  } catch (e) { $("lerr").textContent = String(e); }
  return false;
}
function logout() {
  sessionStorage.removeItem("token");
  clearInterval(timer);
  $("app").hidden = true; $("login").hidden = false;
}
function setTab(t) {
  tab = t; location.hash = t;
  document.querySelectorAll("nav a").forEach(a =>
    a.classList.toggle("on", a.dataset.t === t));
  render();
}
function card(k, v) {
  return `<div class="card"><div class="v">${esc(v)}</div>` +
         `<div class="k">${esc(k)}</div></div>`;
}
function tbl(heads, rows) {
  return `<table><tr>${heads.map(h=>`<th>${esc(h)}</th>`).join("")}</tr>` +
    (rows.length ? rows.join("") :
     `<tr><td colspan="${heads.length}" class="muted">none</td></tr>`) +
    `</table>`;
}
async function render() {
  const v = $("view");
  try {
    if (tab === "overview") {
      const [stats, metrics, nodes] = await Promise.all([
        api("/api/v5/stats"), api("/api/v5/metrics"),
        api("/api/v5/nodes")]);
      const m = k => metrics[k] ?? 0;
      v.innerHTML = `<div class="cards">` +
        card("connections", stats["connections.count"] ?? 0) +
        card("subscriptions", stats["subscriptions.count"] ?? 0) +
        card("topics", stats["topics.count"] ?? 0) +
        card("retained", stats["retained.count"] ?? 0) +
        card("msgs received", m("messages.received")) +
        card("msgs sent", m("messages.sent")) +
        card("msgs dropped", m("messages.dropped")) +
        card("bytes received", m("bytes.received")) +
        `</div>` +
        tbl(["node","status","uptime (s)","connections"],
          nodes.data.map(n => `<tr><td>${esc(n.node)}</td>` +
            `<td><span class="pill up">${esc(n.node_status)}</span></td>` +
            `<td>${esc(Math.round(n.uptime))}</td>` +
            `<td>${esc(n.connections ?? "")}</td></tr>`));
    } else if (tab === "clients") {
      const d = await api("/api/v5/clients?limit=200");
      v.innerHTML = tbl(["clientid","connected","subs","mqueue",
                         "inflight","actions"],
        d.data.map(c => `<tr><td>${esc(c.clientid)}</td>` +
          `<td><span class="pill ${c.connected?"up":"down"}">` +
          `${c.connected?"connected":"detached"}</span></td>` +
          `<td>${esc(c.subscriptions_cnt ?? 0)}</td>` +
          `<td>${esc(c.mqueue_len ?? 0)}</td>` +
          `<td>${esc(c.inflight_cnt ?? 0)}</td>` +
          `<td><button class="danger kick" data-cid="` +
          `${esc(encodeURIComponent(c.clientid))}">kick</button>` +
          `</td></tr>`));
    } else if (tab === "subscriptions") {
      const d = await api("/api/v5/subscriptions?limit=500");
      v.innerHTML = tbl(["clientid","topic"],
        d.data.map(s => `<tr><td>${esc(s.clientid)}</td>` +
          `<td>${esc(s.topic)}</td></tr>`));
    } else if (tab === "topics") {
      const d = await api("/api/v5/topics?limit=500");
      v.innerHTML = tbl(["topic","node"],
        d.data.map(t => `<tr><td>${esc(t.topic)}</td>` +
          `<td>${esc(t.node ?? "")}</td></tr>`));
    } else if (tab === "alarms") {
      const d = await api("/api/v5/alarms");
      v.innerHTML = tbl(["name","message","since"],
        d.data.map(a => `<tr><td>${esc(a.name)}</td>` +
          `<td>${esc(a.message ?? "")}</td>` +
          `<td>${esc(new Date(a.activated_at*1000)
                      .toISOString())}</td></tr>`));
    } else if (tab === "rules") {
      const d = await api("/api/v5/rules");
      v.innerHTML = tbl(["id","sql","enabled"],
        d.data.map(r => `<tr><td>${esc(r.id)}</td><td>${esc(r.sql)}</td>` +
          `<td>${r.enabled ?? true}</td></tr>`));
    } else if (tab === "metrics") {
      const m = await api("/api/v5/metrics");
      v.innerHTML = tbl(["metric","value"],
        Object.keys(m).sort().map(k =>
          `<tr><td>${esc(k)}</td><td>${esc(m[k])}</td></tr>`));
    }
  } catch (e) {
    if (String(e).indexOf("unauthorized") < 0)
      v.innerHTML = `<div class="err">${esc(e)}</div>`;
  }
}
async function kick(cid) {
  await api("/api/v5/clients/" + cid, {method: "DELETE"});
  render();
}
document.addEventListener("click", e => {
  if (e.target.classList && e.target.classList.contains("kick"))
    kick(e.target.dataset.cid);
});
async function boot() {
  if (!tok()) { $("login").hidden = false; return; }
  try {
    const nodes = await api("/api/v5/nodes");
    $("node").textContent = nodes.data[0] ? nodes.data[0].node : "";
  } catch (e) { return; }
  $("login").hidden = true; $("app").hidden = false;
  $("tabs").innerHTML = TABS.map(t =>
    `<a data-t="${t}" onclick="setTab('${t}')">${t}</a>`).join("");
  setTab(TABS.includes(tab) ? tab : "overview");
  clearInterval(timer);
  timer = setInterval(render, 5000);
}
boot();
</script>
</body>
</html>
"""
