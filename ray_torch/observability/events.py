"""Flight recorder — structured event journal: the port's copy of
``ray_tpu/observability/events.py``.

Every operationally interesting state transition (scale decisions,
replica deaths, ejections, failover splices, node drains, CP restarts,
injected chaos faults, mid-traffic compiles, partial restores, ...) is
recorded as one structured event: a dict with a timestamp, a kind from
``KINDS``, a severity, entity keys (node / deployment / replica) and
correlation ids (request id, trace id), so it joins against attribution
records and traces.

Transport is the acknowledged-flusher shape: events queue locally,
batch-flush on a short period, and a failed batch is NOT dropped — it
re-queues (original timestamps kept) bounded by
``events_flush_buffer_max`` payloads with oldest-first eviction. A
process that hosts the journal (or a test, or ``chip_smoke.py``) installs
a local sink instead, which takes every event at once.

The port has no runtime core yet, so ``_default_send`` has nowhere to
ship a batch and raises: without a sink, events stay in the flusher's
bounded backlog and count in ``dropped`` once evicted — what the
reference does outside a cluster. Config (``events_*``) is read lazily
from the port's copy of the runtime config (``ray_torch.core.config``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# Fixed kind taxonomy. The README "Flight recorder" table and the CP
# store's accept filter are both drift-guarded against this tuple —
# add kinds here first.
KINDS = (
    "replica_scale",       # controller changed a deployment's target
    "replica_death",       # controller declared a replica dead
    "replica_ejected",     # router circuit-breaker ejected a replica
    "replica_readmitted",  # ejection TTL expired; replica back in rotation
    "failover_resume",     # engine resumed an in-flight request mid-stream
    "node_drain",          # node entered DRAINING
    "node_dead",           # node left the cluster (drained or lost)
    "cp_restart",          # control plane came up with a fresh epoch
    "chaos_fault",         # FaultSchedule injected a fault (ground truth)
    "mid_traffic_compile", # XLA compile after warmup, with its signature
    "restore_partial",     # KV restore degraded to a partial chain
    "disagg_fallback",     # disagg prefill leg failed; colocated instead
    "warm_start",          # replica promoted with a pre-warmed cache
    "table_publish",       # controller atomically published a new table
    "slo_violation",       # a request blew its deployment's SLO policy
)

SEVERITIES = ("INFO", "WARNING", "ERROR")
SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITIES)}


def make_event(kind: str, severity: str = "INFO", *,
               node: Optional[str] = None,
               deployment: Optional[str] = None,
               replica: Optional[str] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               reason: Optional[str] = None,
               attrs: Optional[dict] = None,
               ts: Optional[float] = None) -> dict:
    """Build one journal event. Unknown kinds/severities are rejected
    here (emit sites fail loudly in tests, silently in `emit`) so the
    store only ever holds taxonomy members."""
    if kind not in KINDS:
        raise ValueError(f"unknown event kind: {kind!r}")
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity: {severity!r}")
    ev = {"ts": time.time() if ts is None else float(ts),
          "kind": kind, "severity": severity}
    if node is not None:
        ev["node"] = str(node)
    if deployment is not None:
        ev["deployment"] = str(deployment)
    if replica is not None:
        ev["replica"] = str(replica)
    if request_id is not None:
        ev["request_id"] = str(request_id)
    if trace_id is not None:
        ev["trace_id"] = str(trace_id)
    if reason is not None:
        ev["reason"] = str(reason)
    if attrs:
        ev["attrs"] = dict(attrs)
    return ev


class EventFlusher:
    """Acknowledged batch flusher for journal events (the metrics
    flusher's shape and backlog semantics). `emit(event)` enqueues; a
    daemon thread batches the queue into one payload per period and
    hands it to `send` (the CP's `report_events` in the reference). A failed payload re-queues
    ahead of fresh batches, bounded by `events_flush_buffer_max`
    payloads with oldest-first eviction. All CP I/O happens on the
    flusher thread — never on a request path."""

    PENDING_CAP = 1024  # un-batched events per process (oldest drop first)

    def __init__(self, send: Callable[[dict], None], source: str = "",
                 interval_s: float = 2.0):
        self._send = send
        self.source = source
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._flush_lock = threading.Lock()
        self._pending: list[dict] = []   # events not yet batched
        self._backlog: list[dict] = []   # unsent payloads, oldest first
        self._sending = False            # a flush() is mid-drain
        self._thread: Optional[threading.Thread] = None
        self.shipped = 0
        self.dropped = 0

    def emit(self, event: dict) -> None:
        with self._flush_lock:
            self._pending.append(event)
            while len(self._pending) > self.PENDING_CAP:
                self._pending.pop(0)
                self.dropped += 1
        self._ensure_thread()

    def _ensure_thread(self) -> None:
        if self._thread is not None or self._stop.is_set():
            return
        with self._flush_lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"event-flusher:{self.source[:12]}")
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.flush()

    def flush(self) -> None:
        # Batch + backlog bookkeeping under the lock; sends outside it —
        # `_send` is an RPC that can stall on a dead CP, and holding the
        # lock across that would wedge every emit() in the process.
        with self._flush_lock:
            if self._pending:
                self._backlog.append(
                    {"source": self.source, "ts": time.time(),
                     "events": self._pending})
                self._pending = []
            if not self._backlog or self._sending:
                return
            try:
                from ray_torch.core.config import get_config
                cap = max(1, int(get_config().events_flush_buffer_max))
            except Exception:  # noqa: BLE001 — config mid-teardown
                cap = 64
            for stale in self._backlog[:-cap]:
                self.dropped += len(stale.get("events", ()))
            del self._backlog[:-cap]
            pending, self._backlog = self._backlog, []
            self._sending = True
        # oldest first so the journal stays in timestamp order; stop at
        # the first failure — later payloads would arrive out of order
        sent = 0
        try:
            for payload in pending:
                try:
                    self._send(payload)
                except Exception:  # noqa: BLE001 — retry next interval
                    break
                sent += 1
                self.shipped += len(payload.get("events", ()))
        finally:
            with self._flush_lock:
                # unsent payloads predate anything queued while we were
                # draining — splice them back at the front
                self._backlog[:0] = pending[sent:]
                self._sending = False

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        if final:
            self.flush()


def _default_send(payload: dict) -> None:
    """Ship one batch to the control plane through this process's
    runtime. The port has no runtime core yet, so there is never a
    cluster to ship to: raise, and the flusher's backlog keeps the batch
    (bounded), as the reference's does with no runtime up."""
    raise RuntimeError("no runtime")


# One flusher per process (lazy — most processes never emit). The CP
# process instead installs a local sink: it hosts the store, so its own
# events (node state machine, restart marker) skip the RPC hop.
_flusher: Optional[EventFlusher] = None
_local_sink: Optional[Callable[[dict], None]] = None
_guard = threading.Lock()


def set_local_sink(fn: Callable[[dict], None]) -> None:
    global _local_sink
    with _guard:
        _local_sink = fn


def clear_local_sink(fn: Optional[Callable[[dict], None]] = None) -> None:
    """Uninstall the local sink (CP stop). Passing the sink makes the
    clear conditional, so a stale CP's teardown can't silence a newer
    CP that already installed its own."""
    global _local_sink
    with _guard:
        # == not `is`: sinks are bound methods, re-created per access
        if fn is None or _local_sink == fn:
            _local_sink = None


def get_flusher() -> EventFlusher:
    global _flusher
    with _guard:
        if _flusher is None or not _flusher.alive:
            try:
                from ray_torch.core.config import get_config
                interval = get_config().events_flush_interval_s
            except Exception:  # noqa: BLE001
                interval = 2.0
            _flusher = EventFlusher(_default_send, interval_s=interval)
    return _flusher


def emit(kind: str, severity: str = "INFO", **fields) -> Optional[dict]:
    """Record one journal event (non-blocking, never raises on the
    caller's path). Returns the event dict, or None when the journal is
    disabled / the event is malformed."""
    try:
        from ray_torch.core.config import get_config
        if not get_config().events_enabled:
            return None
    except Exception:  # noqa: BLE001 — no config yet: journal stays on
        pass
    try:
        ev = make_event(kind, severity, **fields)
    except Exception:  # noqa: BLE001 — bad emit site must not 500
        return None
    with _guard:
        sink = _local_sink
    if sink is not None:
        try:
            sink(ev)
        except Exception:  # noqa: BLE001
            pass
        return ev
    try:
        get_flusher().emit(ev)
    except Exception:  # noqa: BLE001
        pass
    return ev


def flush_now() -> None:
    """One immediate flush (bench sync points, worker teardown)."""
    with _guard:
        cur = _flusher
    if cur is not None and cur.alive:
        cur.flush()


def reset(final: bool = True) -> None:
    """Stop and drop the process flusher (shutdown / test isolation)."""
    global _flusher
    with _guard:
        cur, _flusher = _flusher, None
    if cur is not None:
        cur.stop(final=final)
