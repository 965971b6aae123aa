"""Typed broker configuration: the knobs the port's broker reads,
with the JAX package's defaults, and the ways a deployment sets them.

`ConfigHandler` loads a JSON file (``from_dict``/``load``; an unknown
key is an error) and gives dotted-path ``get``/``update`` with
validating handlers; `apply_env_overrides` applies the
``EMQX_TPU_<PATH>`` environment variables; `check_config` lists the
problems a typo would cause at boot.  A key of a section this package
has not ported yet (overload protection, clustering, ...) and ``engine.use_device`` (``--device`` chooses the device here)
raise ValueError naming the key: such a setting is never dropped
silently.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class MqttConfig:
    max_packet_size: int = 1024 * 1024
    max_clientid_len: int = 65535
    max_topic_levels: int = 128
    # NODE-aggregate ingress limits shared by every connection (the
    # hierarchical limiter's zone level); 0 = off
    zone_messages_rate: float = 0.0
    zone_bytes_rate: float = 0.0
    max_qos_allowed: int = 2
    max_topic_alias: int = 65535
    retain_available: bool = True
    wildcard_subscription: bool = True
    shared_subscription: bool = True
    exclusive_subscription: bool = False
    max_inflight: int = 32
    max_awaiting_rel: int = 100
    await_rel_timeout: float = 300.0
    max_mqueue_len: int = 1000
    mqueue_priorities: Dict[str, int] = field(default_factory=dict)
    mqueue_default_priority: str = "lowest"  # lowest | highest
    mqueue_store_qos0: bool = True
    upgrade_qos: bool = False
    keepalive_multiplier: float = 1.5
    session_expiry_interval: float = 7200.0
    server_keepalive: Optional[int] = None
    retry_interval: float = 30.0
    idle_timeout: float = 15.0
    # per-connection OUTBOUND high watermark (bytes buffered in the
    # transport toward one subscriber): past it, QoS 0 deliveries to
    # that connection drop (``delivery.dropped.out_buffer``) and QoS>0
    # ones park on the mqueue, so a stalled subscriber's wire buffer
    # stays bounded.  0 = off.
    outbound_high_watermark: int = 4 * 1024 * 1024


@dataclass
class ListenerConfig:
    name: str = "tcp_default"
    type: str = "tcp"  # tcp | ssl | ws | wss
    bind: str = "0.0.0.0"
    port: int = 1883
    max_connections: int = 1024000
    # prefix every topic of the listener's clients lives under (their
    # publishes, subscriptions and wills); None = no mountpoint
    mountpoint: Optional[str] = None
    enable: bool = True
    # SO_REUSEPORT: several processes may bind the same port
    reuse_port: bool = False
    # TLS (ssl and wss listeners)
    certfile: Optional[str] = None
    keyfile: Optional[str] = None
    cacertfile: Optional[str] = None
    verify: bool = False  # require and verify client certificates
    # PEM CRL checked against client leaf certificates (needs verify);
    # reloaded into the live context when the file changes
    crlfile: Optional[str] = None
    # per-connection rate limits (emqx_limiter); 0 = unlimited
    messages_rate: float = 0.0  # PUBLISH packets per second
    bytes_rate: float = 0.0  # inbound bytes per second
    # listener-AGGREGATE limits shared by all its connections (the
    # hierarchical limiter's listener level); 0 = unlimited
    max_messages_rate: float = 0.0
    max_bytes_rate: float = 0.0


@dataclass
class AuthConfig:
    allow_anonymous: bool = True
    authz_default: str = "allow"  # allow | deny
    deny_action: str = "ignore"  # ignore | disconnect


@dataclass
class SysConfig:
    enable: bool = True
    interval: float = 60.0  # $SYS heartbeat publish interval


@dataclass
class FlappingConfig:
    """Flapping-client detection (emqx_flapping defaults)."""

    enable: bool = True
    max_count: int = 15
    window: float = 60.0
    ban_time: float = 300.0


@dataclass
class SlowSubsConfig:
    """Slow-subscriber top-K table (emqx_slow_subs): deliveries slower
    than ``threshold_ms`` enter a top-K board; entries expire after
    ``expire_interval`` seconds."""

    enable: bool = True
    threshold_ms: float = 500.0
    top_k: int = 10
    expire_interval: float = 300.0


@dataclass
class BrokerEngineConfig:
    """Knobs for the match engine and the publish batcher."""

    max_levels: int = 16
    f_width: int = 16
    m_cap: int = 128
    rebuild_threshold: int = 4096
    # rebuild the base automaton in a builder thread, off the insert
    # path (the delta tiers keep results exact meanwhile)
    background_rebuild: bool = True
    # route live publishes through the `PublishBatcher` (False: each
    # publish is matched on its own, synchronously)
    batch_publish: bool = True
    batch_window_ms: float = 1.0  # micro-batch accumulation window
    batch_max: int = 4096
    # windows matched concurrently: the collector fills window N+1..N+k
    # while window N's kernel runs; dispatch stays in window order
    pipeline_windows: int = 4
    # rule WHERE predicates run as one rules x window matrix (K4);
    # False pins the per-rule interpreter
    rules_matrix: bool = True


@dataclass
class ProfilerConfig:
    """The window profiler (`observability.Profiler`): stage-latency
    histograms and a ring of the last ``ring_size`` dispatch windows,
    on by default (two ``perf_counter`` reads a stage, one lock a
    window)."""

    enable: bool = True
    ring_size: int = 256
    events_cap: int = 256


@dataclass
class RetainerConfig:
    enable: bool = True
    max_retained_messages: int = 0  # 0 = unlimited
    max_payload_size: int = 1024 * 1024
    msg_expiry_interval: float = 0.0  # 0 = never


@dataclass
class ApiConfig:
    """Management REST + Prometheus endpoint (`mgmt.MgmtApi`).

    Authentication is always on (emqx_mgmt_auth): a default admin is
    bootstrapped on first start from default_username/default_password
    (EMQX ships admin/public the same way); set ``default_password`` to
    None to disable bootstrap entirely (then seed users via MgmtAuth
    directly)."""

    enable: bool = False
    bind: str = "127.0.0.1"
    port: int = 18083
    data_dir: str = "data/mgmt"
    default_username: str = "admin"
    default_password: Optional[str] = "public"
    token_ttl: float = 3600.0
    # whether /metrics (Prometheus scrape) also requires credentials;
    # EMQX leaves the scrape endpoint open by default
    prometheus_auth: bool = False


@dataclass
class ResumeConfig:
    """Resume admission control (the mass-reconnect scheduler): a
    bounded number of sessions replay their durable backlog
    concurrently, each scheduler round reads at most
    ``replay_byte_budget`` payload bytes before yielding the event
    loop back to live traffic, and reconnects beyond
    ``max_concurrent`` park in a FIFO (CONNACK-then-drain: the client
    is connected and live immediately, its backlog streams in when a
    replay slot frees).  Past ``park_queue_cap`` the broker answers
    CONNACK server-busy so the client backs off."""

    # sessions replaying concurrently (active replay slots)
    max_concurrent: int = 64
    # payload bytes read per scheduler round before yielding
    replay_byte_budget: int = 4 * 1024 * 1024
    # parked (admitted-but-waiting) sessions beyond the active slots;
    # past this, reconnects get CONNACK server-busy (client backoff)
    park_queue_cap: int = 4096
    # messages pulled per session per round (cursor-batch granular)
    chunk_msgs: int = 1024
    # windowed replay: batch DS reads across resuming sessions and
    # dispatch backlogs as one window through the live pipeline (the
    # decide kernel, encode-once slots, the native splice).  False pins
    # the scalar per-session mqueue path, the referee.
    windowed: bool = True
    # multicore resume sharding (the JAX package's worker pools): only
    # the single-process (0, 1) loads here; `check_config` refuses any
    # other until the multicore pool is ported (ROADMAP.md item 9)
    shard_index: int = 0
    shard_count: int = 1


@dataclass
class DurableConfig:
    """Durable storage + persistent sessions (emqx_durable_storage)."""

    enable: bool = False
    data_dir: str = "data/ds"
    # storage layout: "lts" (learned topic structure + bitmask keys —
    # wildcard replay scans only overlapping structures) or "hash"
    # (2-level topic-prefix hash shards); pinned per data directory
    layout: str = "lts"
    n_streams: int = 16  # hash layout only
    # physical store shards: each shard is an independent segment log
    # + fsync barrier + metadata journal.  Pinned per data directory
    # like the layout — it decides WHERE records live.
    n_shards: int = 1
    store_qos0: bool = False
    # durability mode — what "acked" means for a captured QoS>=1
    # publish:
    #   never    no fsync: a power cut may take everything since the
    #            OS last flushed (process crashes still lose nothing
    #            the log absorbed — appends are write()-complete)
    #   interval periodic group flush off the broker tick every
    #            `fsync_interval` s: a power cut loses at most that
    #            window
    #   always   group-commit: the PUBACK parks until the covering
    #            dslog_sync lands — ONE fsync amortized per dispatch
    #            window ("acked means durable", crash-tested with
    #            tools/crashsim)
    fsync: str = "interval"
    fsync_interval: float = 5.0
    sync_interval: float = 5.0  # metadata checkpoint + gc cadence
    retention_hours: float = 168.0  # segment GC horizon (7 days)
    # mass-reconnect admission control + windowed replay
    resume: ResumeConfig = field(default_factory=ResumeConfig)


@dataclass
class BrokerConfig:
    mqtt: MqttConfig = field(default_factory=MqttConfig)
    listeners: List[ListenerConfig] = field(
        default_factory=lambda: [ListenerConfig()]
    )
    auth: AuthConfig = field(default_factory=AuthConfig)
    retainer: RetainerConfig = field(default_factory=RetainerConfig)
    engine: BrokerEngineConfig = field(default_factory=BrokerEngineConfig)
    sys: SysConfig = field(default_factory=SysConfig)
    flapping: FlappingConfig = field(default_factory=FlappingConfig)
    slow_subs: SlowSubsConfig = field(default_factory=SlowSubsConfig)
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    # server-side subscriptions made at every connect: entries
    # {"topic": ..., "qos": 0}; %c (client id) and %u (username)
    auto_subscribe: List[Dict[str, Any]] = field(default_factory=list)
    # data-integration sinks started at boot, addressable from rule
    # SinkActions by id: {"id": ..., "type": "http", "url": ...,
    # "method": "POST", "headers": {...}, "max_buffer": 10000}
    sinks: List[Dict[str, Any]] = field(default_factory=list)
    # GCP IoT-Core compat device registry (emqx_gcp_device): devices
    # keep their projects/.../devices/D clientids and JWT-per-connect
    # credentials after migrating off Google IoT Core
    gcp_device_enable: bool = False
    gcp_device_file: str = "data/gcp_devices.json"
    durable: DurableConfig = field(default_factory=DurableConfig)
    node_name: str = "emqx_tpu@127.0.0.1"
    # exhook CLIENT servers this broker calls out to (emqx_exhook):
    # [{"name", "url", "timeout", "failure_action": "deny"|"ignore"}]
    exhooks: List[Dict[str, Any]] = field(default_factory=list)


# keys of the JAX package's configuration whose modules this package
# has not ported: loading one raises, naming the key and its module
NOT_PORTED = {
    "olp": "overload protection",
    "flight": "the flight recorder",
    "tracing": "message tracing",
    "otel": "OpenTelemetry export",
    "log": "structured logging",
    "telemetry_enable": "telemetry",
    "telemetry_url": "telemetry",
    "telemetry_interval": "telemetry",
    "multicore": "the match service and multicore",
    "cluster": "clustering",
    "cluster_name": "cluster linking",
    "cluster_links": "cluster linking",
    "gateways": "the gateways",
    "plugins": "plugins",
    "plugin_dir": "plugins",
    "ft": "file transfer",
    "engine.use_device": "no device switch: --device chooses the device",
    "retainer.deliver_rate": "a retained-delivery rate nothing reads",
}


# the resume shard keys load only at the single process's (0, 1)
RESUME_SHARD_REFUSED = (
    "durable.resume.shard_index/shard_count: multicore resume sharding "
    "is not ported to emqx_tpu_torch (ROADMAP.md section 1, item 9); "
    "only (0, 1) boots")


def _not_ported(path: str) -> ValueError:
    return ValueError(
        f"config key {path}: not ported to emqx_tpu_torch "
        f"({NOT_PORTED[path]})")


class ConfigHandler:
    """Dotted-path get/update with validating listeners."""

    def __init__(self, cfg: Optional[BrokerConfig] = None) -> None:
        self.root = cfg or BrokerConfig()
        self._handlers: Dict[str, List[Callable[[Any, Any], None]]] = {}

    def get(self, path: str) -> Any:
        obj: Any = self.root
        for part in path.split("."):
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        return obj

    def update(self, path: str, value: Any) -> Any:
        """Set ``path`` to ``value``, running the handlers registered on
        it or on a prefix first; a handler that raises aborts the
        update."""
        old = self.get(path)
        for prefix, fns in self._handlers.items():
            if path == prefix or path.startswith(prefix + "."):
                for fn in fns:
                    fn(old, value)
        parts = path.split(".")
        obj: Any = self.root
        for part in parts[:-1]:
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        if isinstance(obj, dict):
            obj[parts[-1]] = value
        else:
            setattr(obj, parts[-1], value)
        return value

    def add_handler(self, path: str,
                    fn: Callable[[Any, Any], None]) -> None:
        self._handlers.setdefault(path, []).append(fn)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self.root)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ConfigHandler":
        root = BrokerConfig()
        _merge_dataclass(root, data)
        return cls(root)

    @classmethod
    def load(cls, path: str) -> "ConfigHandler":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _merge_dataclass(obj: Any, data: Dict[str, Any],
                     prefix: str = "") -> None:
    for key, val in data.items():
        if prefix + key in NOT_PORTED:
            raise _not_ported(prefix + key)
        if not hasattr(obj, key):
            raise ValueError(f"unknown config key: {key}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _merge_dataclass(cur, val, prefix + key + ".")
        elif key == "listeners" and isinstance(val, list):
            setattr(obj, key, [ListenerConfig(**item) for item in val])
        else:
            setattr(obj, key, val)


# ------------------------------------------------- environment overrides

ENV_PREFIX = "EMQX_TPU_"

# switches that share the prefix but are not config paths: the JAX
# package's switches that take a native helper or the decide kernel off.
# This package has no such switch, so setting one raises, naming it
ENV_RESERVED = {
    "EMQX_TPU_NO_NATIVE_SORT": "the native sort helpers",
    "EMQX_TPU_NO_NATIVE_TOKDICT": "the native token dictionary",
    "EMQX_TPU_NO_NATIVE_TRIE": "the native host trie",
    "EMQX_TPU_NO_NATIVE_DISPATCH": "the native window wire assembly",
    "EMQX_TPU_NO_DECIDE": "the decide kernel",
}


def apply_env_overrides(
    cfg: BrokerConfig, environ: Optional[Dict[str, str]] = None
) -> List[Tuple[str, Any]]:
    """Every variable ``EMQX_TPU_A__B__C=value`` sets config path
    ``a.b.c``.  Values parse as JSON when they can (numbers, booleans,
    lists, objects) and are plain strings otherwise, coerced to the
    type of a scalar leaf; an unknown path is an error, as an unknown
    key in a config file is, and so is one of the JAX package's switches
    in ``ENV_RESERVED``.  Returns the applied (path, value) list."""
    import os

    environ = dict(os.environ) if environ is None else environ
    applied: List[Tuple[str, Any]] = []
    for name in sorted(environ):
        if not name.startswith(ENV_PREFIX):
            continue
        if name in ENV_RESERVED:
            raise ValueError(
                f"{name}: not ported to emqx_tpu_torch (no switch takes "
                f"{ENV_RESERVED[name]} off)")
        path = name[len(ENV_PREFIX):].lower().replace("__", ".")
        raw = environ[name]
        try:
            value: Any = json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            value = raw
        parts = path.split(".")
        for k in range(1, len(parts) + 1):
            if ".".join(parts[:k]) in NOT_PORTED:
                raise _not_ported(".".join(parts[:k]))
        obj: Any = cfg
        for part in parts[:-1]:
            if isinstance(obj, dict):
                if part not in obj:
                    raise ValueError(f"unknown config path in {name}")
                obj = obj[part]
            else:
                if not hasattr(obj, part):
                    raise ValueError(f"unknown config path in {name}")
                obj = getattr(obj, part)
        leaf = parts[-1]
        if isinstance(obj, dict):
            obj[leaf] = value
        else:
            if not hasattr(obj, leaf):
                raise ValueError(f"unknown config path in {name}")
            old = getattr(obj, leaf)
            if old is not None and value is not None \
                    and not isinstance(value, type(old)) \
                    and not isinstance(old, (dict, list)):
                try:
                    value = type(old)(value)
                except (TypeError, ValueError) as exc:
                    raise ValueError(
                        f"{name}: cannot coerce {raw!r} to "
                        f"{type(old).__name__}"
                    ) from exc
            setattr(obj, leaf, value)
        applied.append((path, value))
    return applied


# -------------------------------------------------------- boot-time check

def check_config(cfg: BrokerConfig) -> List[str]:
    """The problems that would make a boot go wrong, as messages; empty
    when the configuration boots cleanly.  Checks the enum-valued and
    cross-field settings of the ported sections."""
    problems: List[str] = []
    bad = problems.append
    for i, lst in enumerate(cfg.listeners):
        if lst.type == "quic":
            bad(f"listeners[{i}].type: quic is not ported to "
                "emqx_tpu_torch")
        elif lst.type not in ("tcp", "ssl", "ws", "wss"):
            bad(f"listeners[{i}].type: unknown type {lst.type!r}")
        if lst.type in ("ssl", "wss", "quic") and not (
            lst.certfile and lst.keyfile
        ):
            bad(f"listeners[{i}]: {lst.type} requires certfile+keyfile")
        if not (0 <= int(lst.port) <= 65535):
            bad(f"listeners[{i}].port: {lst.port} out of range")
    if cfg.mqtt.max_qos_allowed not in (0, 1, 2):
        bad(f"mqtt.max_qos_allowed: {cfg.mqtt.max_qos_allowed}")
    if cfg.mqtt.mqueue_default_priority not in ("lowest", "highest"):
        bad("mqtt.mqueue_default_priority must be lowest|highest")
    if int(cfg.mqtt.outbound_high_watermark) < 0:
        bad("mqtt.outbound_high_watermark must be >= 0")
    if cfg.durable.layout not in ("lts", "hash"):
        bad(f"durable.layout: {cfg.durable.layout!r} (lts|hash)")
    if not 1 <= int(cfg.durable.n_shards) <= 64:
        bad("durable.n_shards must be in [1, 64]")
    if cfg.durable.fsync not in ("never", "interval", "always"):
        bad(
            f"durable.fsync: {cfg.durable.fsync!r} "
            "(never|interval|always)"
        )
    if not 0.05 <= float(cfg.durable.fsync_interval) <= 3600.0:
        bad("durable.fsync_interval must be in [0.05, 3600]")
    res = cfg.durable.resume
    if int(res.max_concurrent) < 1:
        bad("durable.resume.max_concurrent must be >= 1")
    if int(res.replay_byte_budget) < 4096:
        bad("durable.resume.replay_byte_budget must be >= 4096")
    if int(res.park_queue_cap) < 0:
        bad("durable.resume.park_queue_cap must be >= 0")
    if int(res.chunk_msgs) < 1:
        bad("durable.resume.chunk_msgs must be >= 1")
    if (int(res.shard_index), int(res.shard_count)) != (0, 1):
        bad(RESUME_SHARD_REFUSED)
    if not isinstance(cfg.sinks, list):
        bad("sinks: expected a list of sink objects")
        return problems
    for j, sink in enumerate(cfg.sinks):
        if not isinstance(sink, dict):
            bad(f"sinks[{j}]: expected an object")
            continue
        if "id" not in sink:
            bad(f"sinks[{j}]: missing id")
        stype = sink.get("type", "http")
        if stype == "kafka":
            bad(f"sinks[{j}].type: kafka is not ported to emqx_tpu_torch")
        elif stype == "http":
            if not sink.get("url"):
                bad(f"sinks[{j}]: http sink needs url")
        else:
            bad(f"sinks[{j}]: unknown type {stype!r}")
    return problems
