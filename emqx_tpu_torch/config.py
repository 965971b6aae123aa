"""Typed broker configuration: the knobs the port's broker reads,
with the JAX package's defaults."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


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


@dataclass
class ListenerConfig:
    """The TCP listener's per-connection options (the server binds
    ``BrokerConfig.bind``/``port``)."""

    # prefix every topic of the listener's clients lives under (their
    # publishes, subscriptions and wills); None = no mountpoint
    mountpoint: Optional[str] = None
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
    batch_window_ms: float = 1.0  # micro-batch accumulation window
    batch_max: int = 4096
    # windows matched concurrently: the collector fills window N+1..N+k
    # while window N's kernel runs; dispatch stays in window order
    pipeline_windows: int = 4


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
class BrokerConfig:
    mqtt: MqttConfig = field(default_factory=MqttConfig)
    engine: BrokerEngineConfig = field(default_factory=BrokerEngineConfig)
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    retainer: RetainerConfig = field(default_factory=RetainerConfig)
    listener: ListenerConfig = field(default_factory=ListenerConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    sys: SysConfig = field(default_factory=SysConfig)
    flapping: FlappingConfig = field(default_factory=FlappingConfig)
    slow_subs: SlowSubsConfig = field(default_factory=SlowSubsConfig)
    bind: str = "0.0.0.0"
    port: int = 1883
    node_name: str = "emqx_tpu@127.0.0.1"
