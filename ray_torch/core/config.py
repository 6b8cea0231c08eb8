"""Config/flag system: the port's copy of ``ray_tpu/core/config.py``.

Every flag has a typed default, is overridable by the environment variable
``RAY_TPU_<NAME>``, and by the ``_system_config`` blob in
``RAY_TPU_SYSTEM_CONFIG`` (JSON; propagated to spawned processes through
the environment). The field names, defaults, variable names and blob are
the reference's, so one environment configures either package, as
``LLMConfig``'s shared field names do. The port reads the observability
flags so far (``events_*`` in ``observability/events.py``, ``tracing_*``
and ``trace_flush_*`` in ``observability/tracing.py``); the other flags
wait for the port's runtime core.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RAY_TPU_"
_SYSTEM_CONFIG_ENV = "RAY_TPU_SYSTEM_CONFIG"


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class Config:
    """All runtime flags. Field name == flag name."""

    # --- object store ---
    # Objects at or below this size are returned inline to the owner's
    # in-process memory store (ref: ray_config_def.h max_direct_call_object_size).
    max_inline_object_size: int = 100 * 1024
    # Default shared-memory store capacity per node (bytes).
    object_store_memory: int = 512 * 1024 * 1024
    # Evict-on-full policy headroom fraction.
    object_store_eviction_headroom: float = 0.1
    # Use the native C++ shared-memory store if built; fall back to pure python.
    use_native_object_store: bool = True
    # Spill sealed+unpinned objects to disk instead of evicting them
    # (ref: local_object_manager.h:44 SpillObjects).
    enable_object_spilling: bool = True
    spill_dir: str = ""
    # Pull admission control: max bytes of concurrent inbound object pulls
    # (ref: pull_manager.h:49 bundle admission).
    max_inflight_pull_bytes: int = 256 * 1024 * 1024

    # --- scheduling ---
    # Max worker processes per node agent (0 = num_cpus).
    max_workers_per_node: int = 0
    # Idle worker keep-alive before reaping (seconds).
    idle_worker_ttl_s: float = 300.0
    # Lease request timeout.
    lease_timeout_s: float = 60.0
    # Hybrid scheduling policy: prefer local node until its utilization
    # exceeds this threshold, then pack remote nodes by score
    # (ref: hybrid_scheduling_policy.cc).
    hybrid_threshold: float = 0.5
    # Weight of ICI distance in node scoring (TPU-native addition).
    ici_distance_weight: float = 0.2

    # --- control-plane persistence ---
    # Path for the control plane's durable metadata store (sqlite). Empty =
    # in-memory only (CP restart loses the cluster; ref: redis_store_client).
    cp_store_path: str = ""

    # --- memory / OOM protection (ref: memory_monitor.h:52) ---
    # Kill the newest killable worker when host memory use crosses this
    # fraction; 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0

    # --- fault tolerance ---
    task_max_retries: int = 3
    actor_max_restarts: int = 0
    # Enable lineage-based reconstruction of lost shared-memory objects
    # (ref: object_recovery_manager.h:41).
    enable_object_reconstruction: bool = True
    # Health-check period/timeout (ref: gcs_health_check_manager.h:45).
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    health_check_failure_threshold: int = 5
    # Agent resource-heartbeat period. Each beat scans /proc for system
    # gauges; many-node single-host harnesses (scale tests: 50+ in-process
    # agents) raise this so heartbeat CPU doesn't crowd out the workload.
    agent_heartbeat_interval_s: float = 1.0
    # Graceful drain (ref: node_manager.proto:448 DrainRaylet): how long a
    # DRAINING node may run in-flight leases to completion before the CP
    # finalizes the drain anyway. In-flight work past the deadline is lost
    # (the same as a kill), so size it to the workload's task length.
    drain_deadline_s: float = 30.0

    # --- watchdog ---
    # get()/wait() called with no explicit timeout raise GetTimeoutError
    # after this many seconds. Default 0 = disabled: bare get() blocks
    # indefinitely, matching the reference's ray.get semantics — a
    # legitimate multi-hour get in the job's main program must not
    # fail in production. Opt in (RAY_TPU_BLOCKING_WATCHDOG_S) to convert
    # wedges into loud GetTimeoutErrors; the test suite pins it to 300 so
    # a wedge surfaces in minutes (tests/conftest.py).
    blocking_watchdog_s: float = 0.0

    # --- streaming generator returns ---
    # Max streamed items the producer may run AHEAD OF THE CONSUMER's
    # cursor (ref: generator_backpressure_num_objects).
    streaming_backpressure_items: int = 16

    # --- data (streaming executor; ref: resource_manager.py budgets) ---
    # Read tasks stream blocks through ObjectRefGenerators (first block
    # flows downstream before the datasource finishes). Default OFF: an
    # intermittent libarrow fault under the early-exit (take/limit) cancel
    # path is still being chased — see tests/test_data.py
    # test_streaming_read_incremental, which opts in.
    data_streaming_reads: bool = False
    # Per-operator cap on BYTES of input blocks with in-flight transform
    # tasks (a 100 MB block charges 100 MB, not "1 task").
    data_op_inflight_bytes: int = 128 * 1024 * 1024
    # Per-operator cap on bytes buffered in its output queue.
    data_op_output_buffer_bytes: int = 128 * 1024 * 1024

    # --- serve robustness (serve/proxy.py, core/deadline.py) ---
    # Default end-to-end request deadline when the client sends no
    # X-Request-Deadline / X-Request-Timeout-S header and the deployment
    # sets no request_timeout_s. Every internal wait on the request path is
    # bounded by the REMAINING budget ("The Tail at Scale": refuse expired
    # work, never wait past the deadline, cancel on expiry).
    serve_request_timeout_s: float = 60.0
    # Proxy admission control: requests beyond this many concurrently
    # in-flight are shed with a fast 503 + Retry-After instead of queueing.
    proxy_max_inflight: int = 1000

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    # A refused connect means nothing is listening: peers publish their
    # address only after binding, so refusal almost always means the
    # process is gone. Retry refused connects only this long (port-reuse
    # grace), not the full connect budget — otherwise every caller that
    # races a death (the CP's publish fan-out, the submitters' shared
    # flusher) wedges for rpc_connect_timeout_s per dead peer.
    rpc_refused_grace_s: float = 1.0
    rpc_retries: int = 3
    # Deterministic fault injection: "method:prob_req:prob_resp,..."
    # (ref: rpc_chaos.cc, ray_config_def.h:842-849).
    testing_rpc_failure: str = ""

    # --- task events / observability ---
    task_events_buffer_size: int = 10000
    task_events_flush_interval_s: float = 1.0
    # Distributed tracing (observability/tracing.py). Head-based sampling:
    # the root caller rolls tracing_sample_rate once; the decision
    # propagates by carrier presence, so rate 0 / disabled leaves the hot
    # path span-free everywhere.
    tracing_enabled: bool = False
    tracing_sample_rate: float = 1.0
    # finished spans per report_spans RPC (also flushed when the local
    # span stack unwinds and on shutdown)
    trace_flush_batch: int = 256
    # control-plane trace store: evict whole oldest traces past this
    # total span count (bounded ring, ref: GcsTaskManager's bounded sink)
    trace_store_max_spans: int = 50000
    # Critical-path attribution (observability/attribution.py): per-request
    # stage timelines stamped at the proxy/router/engine; SLO-violating
    # requests persist full timelines to the CP exemplar store. Stamping is
    # host-side dict appends (A/B-bounded by `bench_serve.py --slo-ab`).
    slo_attribution_enabled: bool = True
    # CP exemplar store cap: oldest records evict first past this
    slo_exemplar_max_records: int = 512
    # Metrics pipeline (util/metrics.py MetricsFlusher → CP TimeSeriesStore).
    # Every worker, main-program and node-agent process runs one flusher
    # pushing delta snapshots on this period (plus once on clean shutdown).
    metrics_enabled: bool = True
    metrics_flush_interval_s: float = 10.0
    # CP-outage tolerance: delta snapshots that fail to publish are kept
    # (original timestamps) and folded into the next flush instead of
    # dropped. Bounded: past this many unsent payloads the OLDEST drops
    # first. At the default 10s flush period, 32 payloads ≈ 5 minutes of
    # CP outage with zero counter loss.
    metrics_flush_buffer_max: int = 32
    # Same for the trace flusher: spans whose report_spans RPC failed are
    # re-queued at the buffer head, bounded to this many spans.
    trace_flush_buffer_max: int = 4096
    # CP time-series retention: points older than the window are evicted;
    # a series past the point cap is downsampled (every other point of its
    # older half dropped) instead of hard-truncated.
    metrics_retention_s: float = 3600.0
    metrics_max_points_per_series: int = 1024
    # Flight recorder (observability/events.py): structured cluster
    # events batch-flushed to a bounded CP journal. Emit is a host-side
    # dict append + queue push (A/B-bounded by `bench_serve.py
    # --events-ab`); the flusher keeps unsent batches across CP outages,
    # bounded to this many payloads with oldest-first eviction.
    events_enabled: bool = True
    events_flush_interval_s: float = 2.0
    events_flush_buffer_max: int = 64
    # CP journal retention: past the cap, older INFOs downsample first
    # (every other one of the older half drops), then the oldest
    # non-ERROR evicts — ERRORs outlive chatty INFO streams.
    events_max_records: int = 2048

    # --- misc ---
    worker_register_timeout_s: float = 30.0
    # runtime_env["pip"] needs network access; opt in explicitly
    # (RAY_TPU_ALLOW_RUNTIME_ENV_PIP=1).
    allow_runtime_env_pip: bool = False
    # Cached runtime-env eviction (ref: _private/runtime_env/uri_cache.py):
    # LRU over /tmp/ray_tpu_envs, keeping at most max_envs entries; entries
    # used within min_age_s are never evicted (a live worker may hold one).
    runtime_env_cache_max_envs: int = 16
    runtime_env_cache_min_age_s: float = 600.0
    log_dir: str = ""
    # Stream worker stdout/stderr to the job's main program (ref:
    # _private/log_monitor.py + worker.py log_to_driver).
    log_to_driver: bool = True
    log_monitor_interval_s: float = 0.3

    def __post_init__(self) -> None:
        # env overrides
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                setattr(self, f.name, _coerce(env, f.type if isinstance(f.type, type) else type(getattr(self, f.name))))
        # _system_config propagated via env (JSON)
        blob = os.environ.get(_SYSTEM_CONFIG_ENV)
        if blob:
            self.apply(json.loads(blob))

    def apply(self, overrides: dict[str, Any] | None) -> None:
        if not overrides:
            return
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown system config flag: {k}")
            setattr(self, k, v)

    def to_env(self, overrides: dict[str, Any] | None = None) -> dict[str, str]:
        """Serialize overrides for child process environments."""
        merged = dict(overrides or {})
        return {_SYSTEM_CONFIG_ENV: json.dumps(merged)} if merged else {}


def package_parent_path() -> str:
    """Directory containing the ray_torch package — prepended to PYTHONPATH
    of spawned processes (workers, job entrypoints) so the framework stays
    importable when a runtime_env or entrypoint changes their cwd."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    global _config
    _config = None
