"""`emqx_tpu_torch.ctl` — the operator CLI against a running broker's
management API.

A copy of the JAX package's ``ctl`` (the role of EMQX's ``emqx_ctl``):
commands are HTTP calls to the REST surface (`mgmt.MgmtApi`) over
``urllib``, so the CLI works against any reachable broker:

    python -m emqx_tpu_torch.ctl status
    python -m emqx_tpu_torch.ctl clients [kick <clientid>]
    python -m emqx_tpu_torch.ctl subscriptions | topics | rules | metrics
    python -m emqx_tpu_torch.ctl stats
    python -m emqx_tpu_torch.ctl publish <topic> <payload> [--qos N]
    python -m emqx_tpu_torch.ctl banned [add <as> <who>] [del <as> <who>]
    python -m emqx_tpu_torch.ctl profiler [summary|windows|reset
                                           |trace [out.json]]

``--api`` is the API's base URL (http://127.0.0.1:18083), ``--user``
``user:password`` (logs in for a Bearer token) and ``--api-key``
``key:secret`` (HTTP Basic).  The commands of modules this package has
not ported (trace, data, rebalance, failpoints, tracing, olp, flight)
are kept: the server answers them 501 and the CLI exits with
``error 501: ...``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import urllib.error
import urllib.request
from typing import Any, Optional


class Ctl:
    def __init__(self, base: str, user: Optional[str] = None,
                 api_key: Optional[str] = None) -> None:
        """`user`/`api_key` are "name:secret" pairs; user logs in for a
        Bearer token, api_key goes as HTTP Basic (emqx_mgmt_auth)."""
        self.base = base.rstrip("/")
        self._auth: Optional[str] = None
        if api_key:
            self._auth = "Basic " + base64.b64encode(
                api_key.encode()
            ).decode()
        elif user:
            username, _, password = user.partition(":")
            out = self._req("/api/v5/login", method="POST", body={
                "username": username, "password": password,
            })
            self._auth = "Bearer " + out["token"]

    def _req(
        self,
        path: str,
        method: str = "GET",
        body: Optional[dict] = None,
        raw: Optional[bytes] = None,
        timeout: float = 10.0,
    ) -> Any:
        if raw is not None:
            headers = {"Content-Type": "application/octet-stream"}
            data = raw
        else:
            headers = {"Content-Type": "application/json"}
            data = None if body is None else json.dumps(body).encode()
        if self._auth:
            headers["Authorization"] = self._auth
        req = urllib.request.Request(
            self.base + path, method=method, data=data, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                out = resp.read()
                return json.loads(out) if out else None
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            raise SystemExit(f"error {exc.code}: {detail}")
        except urllib.error.URLError as exc:
            raise SystemExit(f"cannot reach broker API at {self.base}: {exc}")

    # ------------------------------------------------------- commands

    def status(self) -> None:
        nodes = self._req("/api/v5/nodes")
        for n in nodes["data"]:
            print(
                f"node {n['node']} is {n['node_status']}; "
                f"uptime {n['uptime']}s; {n['connections']} connections"
                + (f"; olp level {n['olp_level']}"
                   if "olp_level" in n else "")
            )
            resume = n.get("resume")
            if resume:
                print(
                    f"  resume queue: {resume['active']} active / "
                    f"{resume['parked']} parked / "
                    f"{resume['paused']} paused "
                    f"(max_concurrent={resume['max_concurrent']}, "
                    f"park_cap={resume['park_queue_cap']}, "
                    f"windowed={resume['windowed']})"
                )
            dura = n.get("durability")
            if dura:
                print(
                    f"  durability: fsync={dura['fsync']}; "
                    f"{dura['sync_count']} syncs "
                    f"({dura['sync_errors']} errors), "
                    f"{dura['unsynced']} unsynced / "
                    f"{dura['parked']} parked acks; "
                    f"corruption: {dura['corrupt_records']} records "
                    f"quarantined, {dura['meta_corruption']} meta"
                )
                if dura.get("meta_rebuild"):
                    print(
                        "    census rebuild in progress: "
                        f"{dura.get('meta_rebuild_scanned', 0)}/"
                        f"{dura.get('meta_rebuild_total', 0)} streams"
                    )
                for row in dura.get("per_shard") or ():
                    print(
                        f"    shard {row.get('shard')}: "
                        f"{row.get('sync_count', 0)} syncs "
                        f"({row.get('sync_errors', 0)} errors), "
                        f"{row.get('unsynced', 0)} unsynced / "
                        f"{row.get('parked', 0)} parked; "
                        f"{row.get('corrupt_records', 0)} corrupt / "
                        f"{row.get('quarantined_segments', 0)} "
                        "quarantined segs"
                    )
            eg = n.get("egress")
            if eg:
                print(
                    f"  egress: {eg['sinks']} sinks, "
                    f"{eg['buffered']} buffered, "
                    f"{eg['batches']} batches flushed "
                    f"({eg['flush_deferred']} deferred); "
                    f"{eg['breakers_open']} breakers open"
                )
            mc = n.get("multicore")
            if mc:
                svc = mc.get("service") or {}
                ring = svc.get("ring") or {}
                state = "attached" if svc.get("attached") else "detached"
                print(
                    f"  multicore: worker {mc.get('worker_id')}"
                    f"/{mc.get('n_workers')} {state}"
                    + (f"; ring {ring.get('in_flight')}/"
                       f"{ring.get('slots')} in flight "
                       f"(hwm={ring.get('high_watermark')}, "
                       f"full={ring.get('full')})" if ring else "")
                )
                rstats = (svc.get("service") or {}).get("stats") or {}
                if rstats:
                    print(
                        "    matchsvc: "
                        + " ".join(f"{k}={rstats[k]}"
                                   for k in sorted(rstats))
                    )
            fl = n.get("flight")
            if fl:
                print(
                    f"  flight: armed; {fl.get('events_recorded')} "
                    f"events in ring; {fl.get('triggers')} triggers "
                    f"({fl.get('triggers_suppressed')} suppressed); "
                    f"last dump {fl.get('last_id') or '-'}"
                )
        cluster = nodes.get("cluster") or {}
        if cluster:
            print(
                f"cluster: peers={cluster.get('alive', [])} "
                f"down={cluster.get('down', [])} "
                f"routes={cluster.get('routes')}"
            )
            fwd = cluster.get("forward") or {}
            if fwd:
                print(
                    f"  forward: mode={fwd.get('mode')} "
                    f"quic_demotions={fwd.get('quic_demotions')}"
                )
                for peer, st in (fwd.get("peers") or {}).items():
                    print(
                        f"    {peer}: breaker={st['breaker']} "
                        f"unacked={st['unacked_frames']}f/"
                        f"{st['unacked_msgs']}m "
                        f"acked={st['acked_frames']} "
                        f"shed={st['shed_msgs']}"
                    )

    def clients(self, kick: Optional[str] = None) -> None:
        if kick:
            self._req(f"/api/v5/clients/{kick}", method="DELETE")
            print(f"kicked {kick}")
            return
        data = self._req("/api/v5/clients")
        for c in data["data"]:
            state = "connected" if c["connected"] else "detached"
            print(
                f"{c['clientid']}\t{state}\tsubs={c['subscriptions_cnt']}"
                f"\tmqueue={c['mqueue_len']}"
            )
        print(f"({data['meta']['count']} clients)")

    def subscriptions(self) -> None:
        data = self._req("/api/v5/subscriptions")
        for s in data["data"]:
            print(f"{s['clientid']}\t{s['topic']}")
        print(f"({data['meta']['count']} subscriptions)")

    def topics(self) -> None:
        data = self._req("/api/v5/topics")
        for t in data["data"]:
            print(f"{t['topic']}\t{t['node']}")
        print(f"({data['meta']['count']} topics)")

    def rules(self) -> None:
        for r in self._req("/api/v5/rules")["data"]:
            state = "enabled" if r["enabled"] else "disabled"
            print(f"{r['id']}\t{state}\tmatched={r['matched']}\t{r['sql']}")

    def metrics(self, name: Optional[str] = None) -> None:
        data = self._req("/api/v5/metrics")
        for k in sorted(data):
            if name is None or name in k:
                print(f"{k}\t{data[k]}")

    def stats(self) -> None:
        data = self._req("/api/v5/stats")
        for k in sorted(data):
            print(f"{k}\t{data[k]}")

    def publish(self, topic: str, payload: str, qos: int = 0) -> None:
        out = self._req(
            "/api/v5/publish",
            method="POST",
            body={"topic": topic, "payload": payload, "qos": qos},
        )
        print(f"delivered to {out['delivered']} subscribers")

    def trace(self, action: str, *args: str) -> None:
        if action == "list":
            for t in self._req("/api/v5/trace")["data"]:
                print(
                    f"{t['name']}\t{t['type']}={t['match']}\t"
                    f"hits={t['hits']}\t{t['file']}"
                )
        elif action == "start":
            name, kind, match = args[0], args[1], args[2]
            out = self._req(
                "/api/v5/trace",
                method="POST",
                body={"name": name, "type": kind, "match": match},
            )
            print(f"tracing to {out['file']}")
        elif action == "stop":
            self._req(f"/api/v5/trace/{args[0]}", method="DELETE")
            print(f"stopped {args[0]}")
        else:
            raise SystemExit(f"unknown trace action {action!r}")

    def data(self, action: str, *args: str) -> None:
        """Backup/restore (emqx ctl data export|import <file>)."""
        if action == "export":
            out = self._req("/api/v5/data/export", method="POST")
            print(f"exported {out['filename']}: {out['counts']}")
        elif action == "import":
            if not args:
                raise SystemExit("usage: data import <archive.tar.gz>")
            with open(args[0], "rb") as f:
                blob = f.read()
            report = self._req(
                "/api/v5/data/import", method="POST", raw=blob,
                timeout=60,
            )
            print(f"restored: {report['restored']}")
            if report.get("skipped"):
                print(f"skipped (reboot-only): {report['skipped']}")
            for err in report.get("errors", ()):
                print(f"error: {err}")
        else:
            raise SystemExit(f"unknown data action {action!r}")

    def rebalance(self, action: str = "status", *args: str) -> None:
        """Elastic ops (emqx ctl rebalance): evacuation, cluster
        balance, detached-session purge."""
        if action == "status":
            info = self._req("/api/v5/load_rebalance/status")
            for kind, d in info.items():
                line = "\t".join(f"{k}={v}" for k, v in d.items()
                                 if k != "plan")
                print(f"{kind}:\t{line}")
                if d.get("plan"):
                    print(f"\tplan: {json.dumps(d['plan'])}")
        elif action == "start":
            out = self._req("/api/v5/load_rebalance/start",
                            method="POST", body={})
            print(f"rebalance: {out['status']}")
            if out.get("plan"):
                print(f"plan: {json.dumps(out['plan'])}")
        elif action == "stop":
            self._req("/api/v5/load_rebalance/stop", method="POST")
            print("rebalance stopped")
        elif action == "evacuation":
            sub = args[0] if args else "status"
            if sub == "status":
                info = self._req("/api/v5/load_rebalance/status")
                print(json.dumps(info["evacuation"]))
            elif sub == "start":
                out = self._req(
                    "/api/v5/load_rebalance/evacuation/start",
                    method="POST", body={},
                )
                print(f"evacuation: {out['status']}")
            elif sub == "stop":
                out = self._req(
                    "/api/v5/load_rebalance/evacuation/stop",
                    method="POST",
                )
                print(f"evacuation: {out['status']} "
                      f"(evicted {out['evicted']})")
            else:
                raise SystemExit(f"unknown evacuation action {sub!r}")
        elif action == "purge":
            sub = args[0] if args else "status"
            if sub == "status":
                info = self._req("/api/v5/load_rebalance/status")
                print(json.dumps(info["purge"]))
            elif sub == "start":
                out = self._req(
                    "/api/v5/load_rebalance/purge/start",
                    method="POST", body={"cluster": True},
                )
                print(f"purge: {out['status']}")
            elif sub == "stop":
                out = self._req(
                    "/api/v5/load_rebalance/purge/stop",
                    method="POST", body={"cluster": True},
                )
                print(f"purge: {out['status']} "
                      f"(purged {out['purged']})")
            else:
                raise SystemExit(f"unknown purge action {sub!r}")
        else:
            raise SystemExit(f"unknown rebalance action {action!r}")

    def failpoints(self, action: str = "list", *args: str) -> None:
        """Chaos controls: list/arm/clear failpoints on a live broker.

            failpoints list
            failpoints set <name> <action> [prob=0.3] [delay=0.1]
                           [after=10] [times=5] [seed=7] [match=n0]
            failpoints clear [name]
        """
        if action == "list":
            info = self._req("/api/v5/failpoints")
            brk = info.get("engine_breaker", {})
            print(
                f"framework {'ARMED' if info['enabled'] else 'disabled'}"
                f"; engine breaker "
                f"{'OPEN' if brk.get('open') else 'closed'} "
                f"(trips={brk.get('trips')})"
            )
            for p in info["data"]:
                opts = " ".join(
                    f"{k}={p[k]}"
                    for k in ("prob", "delay", "after", "times",
                              "match", "seed")
                    if p.get(k) not in (None, "")
                )
                print(f"{p['name']}\t{p['action']}\t{opts}\t"
                      f"hits={p['hits']} fires={p['fires']}")
        elif action == "set":
            if len(args) < 2:
                raise SystemExit(
                    "usage: failpoints set <name> <action> [k=v ...]"
                )
            body = {"action": args[1]}
            for kv in args[2:]:
                k, _, v = kv.partition("=")
                body[k] = v
            out = self._req(
                f"/api/v5/failpoints/{args[0]}", method="PUT", body=body
            )
            print(f"armed {out['name']}: {out['action']}")
        elif action == "clear":
            path = "/api/v5/failpoints" + (f"/{args[0]}" if args else "")
            self._req(path, method="DELETE")
            print(f"cleared {args[0] if args else 'all failpoints'}")
        else:
            raise SystemExit(f"unknown failpoints action {action!r}")

    def profiler(self, action: str = "summary", *args: str) -> None:
        """Window-pipeline profiler: stage latencies, the flight
        recorder's recent windows, Perfetto trace export.

            profiler summary
            profiler windows [n]
            profiler trace [out.json] [n]
            profiler reset
        """
        if action == "summary":
            info = self._req("/api/v5/profiler")
            print(f"profiler {'on' if info['enabled'] else 'OFF'}")
            print("stage\tcount\tp50_us\tp95_us\tp99_us")
            for name, d in sorted(info["histograms_us"].items()):
                if not d["count"]:
                    continue
                print(f"{name}\t{d['count']}\t{d['p50']:.0f}"
                      f"\t{d['p95']:.0f}\t{d['p99']:.0f}")
            eng = info.get("engine", {})
            line = " ".join(
                f"{k}={eng[k]}"
                for k in ("base", "delta", "residual", "deep",
                          "auto_host_windows", "auto_dev_windows",
                          "breaker_open")
                if k in eng
            )
            print(f"engine: {line}")
        elif action == "windows":
            n = int(args[0]) if args else 16
            info = self._req(f"/api/v5/profiler?windows={n}")
            for w in info["windows"]:
                stages = " ".join(
                    f"{k}={v:.0f}us"
                    for k, v in w["stages_us"].items()
                )
                print(
                    f"#{w['seq']}\t{w['source']}\tmsgs={w['n_msgs']}"
                    f"\tdeliv={w['n_deliveries']}\tpath={w['path']}"
                    f"\t{stages}"
                )
        elif action == "trace":
            out_path = args[0] if args else "profiler_trace.json"
            q = f"?windows={args[1]}" if len(args) > 1 else ""
            trace = self._req(f"/api/v5/profiler/trace{q}")
            with open(out_path, "w") as f:
                json.dump(trace, f)
            print(
                f"wrote {len(trace['traceEvents'])} trace events to "
                f"{out_path}; open it at https://ui.perfetto.dev or "
                "chrome://tracing"
            )
        elif action == "reset":
            self._req("/api/v5/profiler", method="DELETE")
            print("profiler histograms + flight recorder reset")
        else:
            raise SystemExit(f"unknown profiler action {action!r}")

    def tracing(self, action: str = "status", *args: str) -> None:
        """Per-message lifecycle tracing: sampler control, trace/mid
        queries, merged multi-node Perfetto export.

            tracing status
            tracing on [rate] | off | rate <r> | filter <topic> ...
            tracing traces [n]
            tracing show <trace_id>
            tracing mid <message-id-hex>
            tracing perfetto [out.json] [peer-api-url ...]
            tracing reset
        """
        if action == "status":
            info = self._req("/api/v5/tracing")
            state = (
                ("ACTIVE" if info["sampling"]
                 else "on (adopting upstream contexts only)")
                if info["active"] else "off"
            )
            print(f"lifecycle tracing {state}; node {info['node']}")
            print(
                f"rate={info['sample_rate']} "
                f"filters={info['topic_filters']} "
                f"traces={info['traces']}/{info['store_max']} "
                f"spans={info['spans']} sampled={info['sampled']} "
                f"remote={info['remote']} forwards={info['forwards']} "
                f"evicted={info['evicted']}"
            )
        elif action in ("on", "off", "rate", "filter"):
            body: dict = {}
            if action == "on":
                body["enable"] = True
                if args:
                    body["sample_rate"] = float(args[0])
            elif action == "off":
                body["enable"] = False
            elif action == "rate":
                body["enable"] = True
                body["sample_rate"] = float(args[0])
            else:
                body["enable"] = True
                body["topic_filters"] = list(args)
            info = self._req("/api/v5/tracing", method="PUT", body=body)
            print(f"tracing {'ACTIVE' if info['active'] else 'off'}: "
                  f"rate={info['sample_rate']} "
                  f"filters={info['topic_filters']}")
        elif action == "traces":
            n = int(args[0]) if args else 32
            data = self._req(f"/api/v5/tracing/traces?limit={n}")["data"]
            for t in data:
                print(
                    f"{t['trace_id']}\t{t['topic']}\t"
                    f"{t['duration_ms']}ms\tspans={t['n_spans']}\t"
                    f"nodes={','.join(t['nodes'])}"
                )
            print(f"({len(data)} traces)")
        elif action == "show":
            out = self._req(f"/api/v5/tracing/traces/{args[0]}")
            self._print_spans(out["spans"])
        elif action == "mid":
            out = self._req(f"/api/v5/tracing/messages/{args[0]}")
            print(f"trace {out['trace_id']}")
            self._print_spans(out["spans"])
        elif action == "perfetto":
            # the span dump's merge into a timeline needs the lifecycle
            # tracer, which is not ported: the server answers 501 here
            self._req("/api/v5/tracing/spans")
            raise SystemExit("tracing perfetto: message lifecycle "
                             "tracing is not ported to emqx_tpu_torch")
        elif action == "reset":
            self._req("/api/v5/tracing", method="DELETE")
            print("trace store cleared")
        else:
            raise SystemExit(f"unknown tracing action {action!r}")

    @staticmethod
    def _print_spans(spans: list) -> None:
        spans = sorted(spans, key=lambda s: s["start_ns"])
        t0 = spans[0]["start_ns"] if spans else 0
        for s in spans:
            off_ms = (s["start_ns"] - t0) / 1e6
            dur_ms = (s["end_ns"] - s["start_ns"]) / 1e6
            a = s.get("attrs", {})
            extra = " ".join(
                f"{k}={a[k]}" for k in
                ("topic", "deliveries", "target", "ok", "path")
                if k in a
            )
            print(
                f"+{off_ms:8.3f}ms {dur_ms:8.3f}ms  {s['node']:<14} "
                f"{s['name']:<18} span={s['span_id'][:8]} "
                f"parent={(s.get('parent_id') or '-')[:8]} {extra}"
            )

    def flight(self, action: str = "status", *args: str) -> None:
        """Always-on flight recorder: status, manual dump, merged
        cross-process Perfetto export.

            flight status
            flight dump
            flight show <id> [out.json]
        """
        if action == "status":
            info = self._req("/api/v5/flight")
            st = info["status"]
            state = "armed" if st["armed"] else "DISARMED"
            print(
                f"flight recorder {state} [{st['role']} {st['node']} "
                f"pid={st['pid']}]; ring {st['events_recorded']}"
                f"/{st['ring_size']} events; "
                f"{st['triggers']} triggers "
                f"({st['triggers_suppressed']} suppressed, "
                f"debounce {st['min_dump_interval']}s)"
            )
            if st.get("slo_p99_ms"):
                print("  slo p99 (ms): " + " ".join(
                    f"{k}={v}" for k, v in
                    sorted(st["slo_p99_ms"].items())))
            dumps = info.get("dumps") or []
            if not dumps:
                print("  no dumps captured")
            for row in dumps:
                print(f"  dump {row['id']}: "
                      f"{len(row['files'])} process file(s)")
        elif action == "dump":
            out = self._req("/api/v5/flight/dump", method="POST",
                            body={})
            print(f"dump triggered: id {out['id']}")
        elif action == "show":
            if not args:
                raise SystemExit("usage: flight show <id> [out.json]")
            trig_id = args[0]
            out_path = args[1] if len(args) > 1 else (
                f"flight_{trig_id}.json")
            info = self._req(f"/api/v5/flight/{trig_id}")
            for p in info["processes"]:
                print(f"  {p['role']} {p['node']} pid={p['pid']} "
                      f"({p['reason']})")
            if info.get("torn"):
                print(f"  {info['torn']} torn dump file(s) skipped")
            trace = info["trace"]
            with open(out_path, "w") as f:
                json.dump(trace, f)
            print(
                f"wrote {len(trace['traceEvents'])} merged trace "
                f"events from {len(info['processes'])} process(es) to "
                f"{out_path}; open it at https://ui.perfetto.dev or "
                "chrome://tracing"
            )
        else:
            raise SystemExit(f"unknown flight action {action!r}")

    def olp(self, action: str = "status") -> None:
        """Overload-protection ladder: level, signals vs thresholds,
        shed/deferred/refused accounting, recent transitions.

            olp [status]
            olp history
        """
        info = self._req("/api/v5/olp")
        if action == "history":
            trans = info["transitions"]
            if not trans:
                print("no olp transitions recorded")
                return
            for t in trans:
                sig = " ".join(
                    f"{k}={v}" for k, v in sorted(
                        (t.get("signals") or {}).items())
                )
                print(f"L{t['from']} -> L{t['to']} at {t['at']:.3f}"
                      + (f"  [{sig}]" if sig else ""))
            return
        if action != "status":
            raise SystemExit(f"unknown olp action {action!r}")
        state = "enabled" if info["enable"] else "disabled"
        print(
            f"olp {state}; level {info['level']}"
            + (f" (hold {info['hold_remaining']}s)"
               if info["hold_remaining"] else "")
            + (f"; window_cap={info['window_cap']}"
               if info["window_cap"] else "")
            + ("; limiters clamped" if info["clamped"] else "")
        )
        ths = info["thresholds"]
        for name, val in sorted(info["signals"].items()):
            t = ths.get(name, [])
            print(f"  {name:>16} = {val}\t(L1/L2/L3: "
                  f"{'/'.join(str(x) for x in t)})")
        counters = {
            k: v for k, v in info["counters"].items() if v
        }
        if counters:
            print("  shed/deferred/refused:")
            for k, v in sorted(counters.items()):
                print(f"    {k} = {v}")
        if info["retained_deferred"]:
            print(f"  retained catch-up deferred: "
                  f"{info['retained_deferred']} jobs")
        for t in info["transitions"][-8:]:
            print(f"  transition {t['from']} -> {t['to']} at {t['at']:.1f}"
                  f" (signals {t['signals']})")

    def banned(self, action: str = "list", *args: str) -> None:
        if action == "list":
            for b in self._req("/api/v5/banned")["data"]:
                print(f"{b['as']}={b['who']}\tuntil={b['until']}")
        elif action == "add":
            self._req(
                "/api/v5/banned",
                method="POST",
                body={"as": args[0], "who": args[1]},
            )
            print(f"banned {args[0]}={args[1]}")
        elif action == "del":
            self._req(
                f"/api/v5/banned/{args[0]}/{args[1]}", method="DELETE"
            )
            print(f"unbanned {args[0]}={args[1]}")
        else:
            raise SystemExit(f"unknown banned action {action!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="emqx_tpu_torch.ctl")
    ap.add_argument(
        "--api",
        default="http://127.0.0.1:18083",
        help="management API base URL",
    )
    ap.add_argument(
        "--user",
        default=os.environ.get("EMQX_CTL_USER", "admin:public"),
        help="admin credentials as user:password "
        "(env EMQX_CTL_USER; logs in for a Bearer token)",
    )
    ap.add_argument(
        "--api-key",
        default=os.environ.get("EMQX_CTL_API_KEY"),
        help="API key as key:secret (env EMQX_CTL_API_KEY; "
        "preferred over --user when set)",
    )
    ap.add_argument("command", help="status|clients|subscriptions|topics|"
                    "rules|metrics|stats|publish|trace|banned|data|"
                    "rebalance|failpoints|profiler|tracing|olp|flight")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--qos", type=int, default=0)
    ns = ap.parse_args(argv)
    ctl = Ctl(ns.api, user=ns.user, api_key=ns.api_key)

    cmd = ns.command
    if cmd == "status":
        ctl.status()
    elif cmd == "clients":
        ctl.clients(kick=ns.args[1] if ns.args[:1] == ["kick"] else None)
    elif cmd == "subscriptions":
        ctl.subscriptions()
    elif cmd == "topics":
        ctl.topics()
    elif cmd == "rules":
        ctl.rules()
    elif cmd == "metrics":
        ctl.metrics(ns.args[0] if ns.args else None)
    elif cmd == "stats":
        ctl.stats()
    elif cmd == "publish":
        ctl.publish(ns.args[0], ns.args[1] if len(ns.args) > 1 else "",
                    qos=ns.qos)
    elif cmd == "trace":
        ctl.trace(ns.args[0] if ns.args else "list", *ns.args[1:])
    elif cmd == "banned":
        ctl.banned(ns.args[0] if ns.args else "list", *ns.args[1:])
    elif cmd == "failpoints":
        ctl.failpoints(ns.args[0] if ns.args else "list", *ns.args[1:])
    elif cmd == "profiler":
        ctl.profiler(ns.args[0] if ns.args else "summary", *ns.args[1:])
    elif cmd == "tracing":
        ctl.tracing(ns.args[0] if ns.args else "status", *ns.args[1:])
    elif cmd == "data":
        ctl.data(ns.args[0] if ns.args else "export", *ns.args[1:])
    elif cmd == "rebalance":
        ctl.rebalance(ns.args[0] if ns.args else "status",
                      *ns.args[1:])
    elif cmd == "olp":
        ctl.olp(ns.args[0] if ns.args else "status")
    elif cmd == "flight":
        ctl.flight(ns.args[0] if ns.args else "status", *ns.args[1:])
    else:
        raise SystemExit(f"unknown command {cmd!r}")


if __name__ == "__main__":
    main()
