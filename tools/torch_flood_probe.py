"""Flood probe: one client floods QoS 0 publishes at a broker while a
light client sends QoS 1 publishes 20 ms apart and a subscriber on
``fair/#`` takes everything; all three share the broker's event loop,
as `chip_smoke.py`'s fairness part does.  It prints the flood's time to
the subscriber, the longest gap between two flood arrivals, light's
PUBACK times, the kernel's TCP counters (``/proc/net/netstat``,
``/proc/net/snmp``) read before and after, and the flood connection's
two ends sampled from ``/proc/net/tcp`` every 0.25 s: bytes the broker
has not read (the server end's receive queue) tell a broker that does
not resume reading apart from bytes the kernel has not delivered (the
client end's send queue, with its retransmit or window-probe timer).

    python tools/torch_flood_probe.py --server port --device cpu --per-write 1
    JAX_PLATFORMS=cpu python tools/torch_flood_probe.py --server ref --per-write 1
    python tools/torch_flood_probe.py --server port --root OTHER_CHECKOUT
    python tools/torch_flood_probe.py --filters 1000000 --trace OUT.json

``port`` is emqx_tpu_torch's `BrokerServer` (``--root`` imports the
package from another checkout, such as an older commit unpacked
beside this one), ``ref`` the JAX package's on the CPU.  ``--per-write``
is how many publishes the flooder puts in one socket write;
``--filters`` puts that many other filters in the port's engine, as the
card's listeners phase does; ``--no-pause`` raises the batcher's
watermarks out of reach, so no read is ever paused.  Prints one
JSON line last; exits 1 when the run did not finish within
``--timeout`` seconds."""

import argparse
import asyncio
import json
import os
import sys
import threading
import time
from typing import Optional

KEYS = ("TCPRcvQDrop", "TCPBacklogDrop", "PruneCalled", "RcvPruned",
        "OfoPruned", "TCPRcvCollapsed", "TCPTimeouts", "TCPLossProbes",
        "TCPZeroWindowDrop", "TCPToZeroWindowAdv", "TCPFromZeroWindowAdv",
        "TCPWantZeroWindowAdv", "TCPLostRetransmit", "TCPSpuriousRTOs",
        "TCPSlowStartRetrans", "TCPOFOQueue", "TCPOFODrop",
        "TCPMemoryPressures")


def tcp_counters() -> dict:
    """TcpExt's counters of ``KEYS`` and Tcp's RetransSegs/OutSegs."""
    out = {}
    for path, table in (("/proc/net/netstat", "TcpExt:"),
                        ("/proc/net/snmp", "Tcp:")):
        try:
            with open(path) as f:
                lines = [ln.split() for ln in f]
        except OSError:
            continue
        rows = [ln for ln in lines if ln and ln[0] == table]
        for names, vals in zip(rows[0::2], rows[1::2]):
            for k, v in zip(names[1:], vals[1:]):
                if k in KEYS or k in ("RetransSegs", "OutSegs", "InSegs"):
                    out[k] = int(v)
    return out


TIMERS = {0: "none", 1: "retransmit", 2: "keepalive", 3: "time_wait",
          4: "window_probe"}


def tcp_socket(local_port: int, remote_port: int) -> Optional[dict]:
    """The IPv4 socket ``local_port`` -> ``remote_port`` in
    ``/proc/net/tcp``: its send and receive queues (bytes), its timer
    and its count of unanswered retransmits or probes."""
    want = (f":{local_port:04X}", f":{remote_port:04X}")
    try:
        with open("/proc/net/tcp") as f:
            next(f)
            for ln in f:
                c = ln.split()
                if c[1].endswith(want[0]) and c[2].endswith(want[1]):
                    tx, rx = (int(x, 16) for x in c[4].split(":"))
                    return {"tx": tx, "rx": rx,
                            "timer": TIMERS.get(int(c[5].split(":")[0], 16),
                                                c[5]),
                            "retrans": int(c[6], 16)}
    except OSError:
        pass
    return None


def make_server(kind: str, device: str, n_filters: int = 0):
    if kind == "ref":
        import emqx_tpu.broker  # noqa: F401  (the router's import order)
        from emqx_tpu import config as RC
        from emqx_tpu.broker.listener import BrokerServer

        cfg = RC.BrokerConfig(listeners=[RC.ListenerConfig(
            bind="127.0.0.1", port=0)])
        cfg.engine.use_device = False
        return BrokerServer(cfg)
    from emqx_tpu_torch import config as PC
    from emqx_tpu_torch.broker.listener import BrokerServer

    if hasattr(PC, "ListenerConfig") and "listeners" in {
            f for f in PC.BrokerConfig.__dataclass_fields__}:
        cfg = PC.BrokerConfig(listeners=[PC.ListenerConfig(
            bind="127.0.0.1", port=0)])
    else:  # an older port: one listener, BrokerConfig.bind/port
        cfg = PC.BrokerConfig(bind="127.0.0.1", port=0)
    server = BrokerServer(cfg, device=device)
    if n_filters:
        # filters no flood topic matches, on int fids (the router's are
        # the filter strings)
        server.broker.router.engine.insert_many(
            [(f"bg/{i % 1000}/{i}/#", i) for i in range(n_filters)])
    return server


class Client:
    """An MQTT 3.1.1 client on the imported port's codec."""

    def __init__(self, C, port: int, cid: str) -> None:
        self.C, self.port, self.cid = C, port, cid
        self.parser = C.StreamParser(version=4)
        self.inbox: asyncio.Queue = asyncio.Queue()

    async def connect(self) -> None:
        C = self.C
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port)
        self.task = asyncio.ensure_future(self._pump())
        self.send(C.Connect(client_id=self.cid, proto_ver=4, keepalive=0))
        ack = await self.expect(C.CONNACK)
        assert ack.reason_code == 0, ack

    async def _pump(self) -> None:
        while True:
            data = await self.reader.read(65536)
            if not data:
                self.inbox.put_nowait(None)
                return
            for p in self.parser.feed(data):
                self.inbox.put_nowait(p)

    def send(self, *pkts) -> None:
        self.writer.write(b"".join(self.C.serialize(p, 4) for p in pkts))

    async def expect(self, ptype: int, timeout: float = 60.0):
        pkt = await asyncio.wait_for(self.inbox.get(), timeout)
        if pkt is None or pkt.type != ptype:
            raise AssertionError(f"{self.cid}: wanted {ptype}, got {pkt!r}")
        return pkt

    async def close(self) -> None:
        self.task.cancel()
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def probe(args) -> dict:
    from emqx_tpu_torch.codec import mqtt as C

    server = make_server(args.server, args.device, args.filters)
    await server.start()
    if args.no_pause:
        # watermarks out of reach: no connection's reads ever pause
        b = server.broker.batcher
        b.high_watermark = 1 << 60
        if hasattr(b, "global_high"):
            b.global_high = 1 << 60
    port = (server.listeners[0].port if hasattr(server, "listeners")
            else server.port)
    out = {"server": args.server, "root": args.root or ".",
           "device": args.device, "filters": args.filters,
           "flood": args.flood, "per_write": args.per_write,
           "no_pause": args.no_pause}
    sub = Client(C, port, "fair-sub")
    flood = Client(C, port, "flood")
    light = Client(C, port, "light")
    try:
        for cl in (sub, flood, light):
            await cl.connect()
        sub.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="fair/#", qos=1)]))
        await sub.expect(C.SUBACK)
        if args.filters:
            server.broker.router.engine.rebuild()
        arrivals, acks = [], []
        ends = (flood.writer.get_extra_info("sockname")[1], port)
        samples, stop = [], threading.Event()

        def sample():
            # a thread: it samples while the event loop is busy too
            while not stop.wait(0.25):
                samples.append((time.perf_counter() - t0, len(arrivals),
                                tcp_socket(*ends), tcp_socket(*ends[::-1])))

        got = {"f": 0, "l": 0}
        t_sent = [None]

        async def consume():
            while got["f"] < args.flood or got["l"] < args.light:
                pkt = await sub.inbox.get()
                if pkt is None:
                    raise AssertionError("fair-sub disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                if pkt.qos:
                    sub.send(C.Puback(packet_id=pkt.packet_id))
                got[pkt.topic[-1]] += 1
                if pkt.topic[-1] == "f":
                    arrivals.append(time.perf_counter())

        async def blast():
            for k in range(0, args.flood, args.per_write):
                flood.send(*(C.Publish(topic="fair/f", payload=b"%d" % i,
                                       qos=0)
                             for i in range(k, min(k + args.per_write,
                                                   args.flood))))
                await flood.writer.drain()
            t_sent[0] = time.perf_counter()

        async def trickle():
            for k in range(args.light):
                t = time.perf_counter()
                light.send(C.Publish(topic="fair/l", payload=b"%d" % k,
                                     qos=1, packet_id=k + 1))
                await light.expect(C.PUBACK, args.timeout)
                acks.append((time.perf_counter() - t) * 1e3)
                await asyncio.sleep(max(0.0, 0.02 - (time.perf_counter()
                                                     - t)))

        before = tcp_counters()
        t0 = time.perf_counter()
        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        tasks = [asyncio.ensure_future(f()) for f in (consume, blast,
                                                      trickle)]
        done, pending = await asyncio.wait(tasks, timeout=args.timeout)
        t1 = time.perf_counter()
        after = tcp_counters()
        stop.set()
        await asyncio.to_thread(sampler.join)
        for t in pending:
            t.cancel()
        for t in done:
            if t.exception() is not None:
                out["error"] = repr(t.exception())
        gaps = [b - a for a, b in zip([t0] + arrivals, arrivals)]
        worst = max(range(len(gaps)), key=gaps.__getitem__) if gaps else 0
        acks.sort()
        t_gap = (arrivals[worst - 1] - t0 if worst else 0.0,
                 arrivals[worst] - t0 if gaps else 0.0)
        in_gap = [(cl, sv) for ts, _n, cl, sv in samples
                  if t_gap[0] <= ts <= t_gap[1]]

        def peak(rows, end, key):
            vals = [r[end][key] for r in rows if r[end] is not None]
            return max(vals) if vals else None

        out.update({
            "finished": not pending and "error" not in out,
            "seconds": t1 - t0,
            "flood_received": got["f"], "light_received": got["l"],
            "flood_s": arrivals[-1] - t0 if arrivals else None,
            "flood_sent_s": t_sent[0] - t0 if t_sent[0] else None,
            "longest_gap_s": gaps[worst] if gaps else None,
            "longest_gap_after_msgs": worst,
            "longest_gap_starts_s": (arrivals[worst - 1] - t0
                                     if worst else 0.0),
            "gap_samples": len(in_gap),
            "gap_client_send_queue_max_b": peak(in_gap, 0, "tx"),
            "gap_server_recv_queue_max_b": peak(in_gap, 1, "rx"),
            "gap_client_timers": sorted({cl["timer"] for cl, _ in in_gap
                                         if cl is not None}),
            "gap_client_retrans_max": peak(in_gap, 0, "retrans"),
            "server_recv_queue_max_b": peak([s[2:] for s in samples], 1,
                                            "rx"),
            "light_puback_p50_ms": acks[len(acks) // 2] if acks else None,
            "light_puback_max_ms": acks[-1] if acks else None,
            "tcp_counters_delta": {k: after[k] - before.get(k, 0)
                                   for k in sorted(after)
                                   if after[k] != before.get(k, 0)},
        })
    finally:
        if args.trace and "samples" in locals():
            with open(args.trace, "w") as f:
                json.dump({"out": out, "samples": samples}, f)
        for cl in (sub, flood, light):
            try:
                await cl.close()
            except Exception:  # noqa: BLE001  (a half-open client)
                pass
        await asyncio.wait_for(server.stop(), 60)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--server", choices=("port", "ref"), default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="import emqx_tpu_torch from this checkout")
    ap.add_argument("--flood", type=int, default=20_000)
    ap.add_argument("--light", type=int, default=50)
    ap.add_argument("--per-write", type=int, default=1)
    ap.add_argument("--filters", type=int, default=0)
    ap.add_argument("--no-pause", action="store_true",
                    help="raise the batcher's watermarks out of reach")
    ap.add_argument("--trace", default=None,
                    help="write every /proc/net/tcp sample here (JSON)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(
        args.root or os.path.join(os.path.dirname(__file__), "..")))
    out = asyncio.run(probe(args))
    print(json.dumps(out), flush=True)
    return 0 if out["finished"] else 1


if __name__ == "__main__":
    sys.exit(main())
