"""Engine performance introspection: the JAX-free part of
``ray_tpu/observability/profiling.py``, over torch.

- **Phase timers** (``EngineProfiler.record``): the engine loop stamps each
  phase — queue_wait / admit / prefill / chunk_prefill / decode_dispatch /
  harvest — into bounded rings. Dispatch phases measure host-side dispatch
  cost (the loop never waits for the device there); ``harvest`` is where
  the device sync lives, so device slowness shows up there, attributed.
- **First-use tracking** (``compile_scope``): the first dispatch of every
  static signature (prefill bucket, chunk length, decode (width, block)) is
  timed and counted. Eager PyTorch compiles nothing, but a first use still
  pays one-off costs (the kernel library's build and load, cuBLAS
  heuristics, allocator growth); one that lands while traffic is in flight
  is flagged ``mid_traffic`` and logged.
- **Device-memory accounting**: weights / KV-pool byte gauges computed from
  tensor sizes, KV page occupancy, and the CUDA caching allocator's
  live/peak bytes (``None`` on the CPU, never guessed).

Metric-registry export, the cluster-wide capture controller and the trace
helpers come with the port's runtime layers.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

# engine phases, in loop order
PHASES = ("queue_wait", "admit", "prefill", "chunk_prefill",
          "decode_dispatch", "verify_dispatch", "harvest")


def _pct(sorted_vals: list, q: float) -> float:
    """Interpolated percentile of an ascending list (non-empty)."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class _Noop:
    """Reusable no-op context manager (compile_scope fast path: the
    signature was already seen, so the per-dispatch cost is one set
    lookup and no allocation)."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _CompileScope:
    def __init__(self, prof: "EngineProfiler", kind: str, sig,
                 mid_traffic: bool):
        self._prof = prof
        self._kind = kind
        self._sig = sig
        self._mid = mid_traffic

    def __enter__(self):
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._prof._record_compile(
                self._kind, self._sig, time.perf_counter() - self._t0,
                self._mid)
        return False


class EngineProfiler:
    """Per-engine introspection state: phase rings, first-use tracker, ITL
    ring, memory layout. ``enabled=False`` reduces phase/ITL recording to
    a single attribute check; first-use tracking stays on either way (it
    only does work on the FIRST dispatch of a new signature)."""

    def __init__(self, enabled: bool = True, ring_size: int = 256,
                 itl_ring_size: int = 2048):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {
            p: collections.deque(maxlen=ring_size) for p in PHASES}
        self._itl: collections.deque = collections.deque(maxlen=itl_ring_size)
        self._seen: set = set()
        self.compile_events = 0
        self.mid_traffic_compiles = 0
        self.compile_s = 0.0
        # memory layout (set once by the engine after weights/pool init)
        self.weights_bytes = 0
        self.kv_pool_bytes = 0

    # ---- phase timers --------------------------------------------------
    def record(self, phase: str, dt: float) -> None:
        if not self.enabled:
            return
        self._rings[phase].append(dt)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a block as one phase sample (skips the clock reads
        entirely when disabled)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record_itl(self, gap_s: float) -> None:
        if not self.enabled:
            return
        self._itl.append(gap_s)

    def phase_stats(self) -> dict:
        """`phase_<name>_p50_ms` / `_p95_ms` per phase plus `itl_s` (p50);
        None where no samples exist yet (or profiling is disabled)."""
        out: dict[str, Optional[float]] = {}
        for p in PHASES:
            vals = sorted(self._rings[p])
            out[f"phase_{p}_p50_ms"] = (
                round(_pct(vals, 0.5) * 1e3, 4) if vals else None)
            out[f"phase_{p}_p95_ms"] = (
                round(_pct(vals, 0.95) * 1e3, 4) if vals else None)
        itl = sorted(self._itl)
        out["itl_s"] = round(_pct(itl, 0.5), 6) if itl else None
        return out

    # ---- first-use tracking --------------------------------------------
    def compile_scope(self, kind: str, sig, mid_traffic: bool = False):
        """Context manager around a dispatch. First use of ``sig`` is
        timed and counted; later uses return a shared no-op.
        ``mid_traffic`` should be True when any request has been
        submitted — such a first use stalled live work."""
        if sig in self._seen:
            return _NOOP
        return _CompileScope(self, kind, sig, mid_traffic)

    def compile_count(self, kinds) -> int:
        """Signatures seen for the given scope kinds (each sig's first
        element is its kind — e.g. ("decode", w, k))."""
        kinds = tuple(kinds)
        with self._lock:
            return sum(1 for s in self._seen
                       if isinstance(s, tuple) and s and s[0] in kinds)

    def _record_compile(self, kind: str, sig, dt: float,
                        mid_traffic: bool) -> None:
        with self._lock:
            if sig in self._seen:
                return
            self._seen.add(sig)
            self.compile_events += 1
            self.compile_s += dt
            if mid_traffic:
                self.mid_traffic_compiles += 1
        if mid_traffic:
            logger.warning(
                "mid-traffic first use: kind=%s sig=%s took %.2fs — every "
                "active generation stalled for it (warm this signature at "
                "startup, see engine warmup_compile)", kind, sig, dt)

    # ---- memory accounting ---------------------------------------------
    def set_memory_layout(self, weights_bytes: int,
                          kv_pool_bytes: int) -> None:
        self.weights_bytes = int(weights_bytes)
        self.kv_pool_bytes = int(kv_pool_bytes)

    def memory_stats(self, device: torch.device,
                     used_pages: Optional[int] = None,
                     total_pages: Optional[int] = None) -> dict:
        occ = None
        if used_pages is not None and total_pages:
            occ = round(used_pages / total_pages, 4)
        in_use, peak = device_memory_stats(device)
        return {"weights_bytes": self.weights_bytes,
                "kv_pool_bytes": self.kv_pool_bytes,
                "kv_page_occupancy": occ,
                "device_bytes_in_use": in_use,
                "device_peak_bytes": peak}


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf in a nested dict/list (weights / KV
    pool sizing; size*itemsize, no device round trip)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def device_memory_stats(device: torch.device
                        ) -> tuple[Optional[int], Optional[int]]:
    """(bytes allocated now, peak bytes allocated) from the CUDA caching
    allocator of ``device``, or (None, None) on the CPU."""
    if torch.device(device).type != "cuda":
        return None, None
    stats = torch.cuda.memory_stats(device)
    return (stats.get("allocated_bytes.all.current"),
            stats.get("allocated_bytes.all.peak"))
