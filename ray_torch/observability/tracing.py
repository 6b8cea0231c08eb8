"""Distributed tracing: span propagation + batched export — the port's
copy of ``ray_tpu/observability/tracing.py``.

Spans are plain dicts, the current span lives in a contextvar, and
finished spans buffer process-locally until the registered flusher takes
them (no OpenTelemetry dependency).

Propagation model (head-based sampling):

- A ROOT span is started only where ``tracing_enabled`` is set and the
  sampler (``tracing_sample_rate``) says yes. The decision travels by
  PRESENCE: a sampled call carries ``{"trace_id", "span_id"}``; an
  unsampled call carries nothing, so downstream code never starts orphan
  spans and the unsampled hot path stays span-free end to end.
- ``inject()`` snapshots the current span as a carrier dict (or None);
  the LLM engine takes one at ``submit`` and records its
  ``llm.generate`` span under it when the request finishes
  (``record_span``: the engine loop thread has no ambient context).
- ``span_from(carrier, ...)`` is the receiving side's extract: a hard
  no-op when the carrier is falsy.
- ``span(..., child_only=True)`` is for hot-path internals: it only
  records when already inside a trace.

Finished spans flush to the registered flusher (``register_flusher``)
when the batch fills, when the local span stack unwinds to empty, or on
demand; a failed flush re-queues them at the buffer's head, bounded by
``trace_flush_buffer_max``. The flags are read lazily from the port's
copy of the runtime config (``ray_torch.core.config``). The exporters
(``to_chrome_trace``, ``to_otlp_json``) are the reference's.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import threading
import time
from typing import Any, Callable, Iterator, Optional

# current span of THIS thread/coroutine (coroutines get contained copies
# of the context)
_current: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "ray_torch_trace_span", default=None)

_buffer: list[dict] = []
_buffer_lock = threading.Lock()
_flusher: Optional[Callable[[list], None]] = None


def _cfg():
    from ray_torch.core.config import get_config
    return get_config()


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


# ---- context API --------------------------------------------------------

def current_span() -> Optional[dict]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    s = _current.get()
    return s["trace_id"] if s else None


def inject() -> Optional[dict]:
    """Carrier for the current span context (None when not tracing).
    Goes into TaskSpec.trace_ctx / request metadata."""
    s = _current.get()
    if s is None:
        return None
    return {"trace_id": s["trace_id"], "span_id": s["span_id"]}


def register_flusher(cb: Optional[Callable[[list], None]]) -> None:
    """Install the span sink (the reference's worker runtime wires
    notify("report_spans"); the port's callers install their own)."""
    global _flusher
    _flusher = cb


# ---- span lifecycle -----------------------------------------------------

def start_span(name: str, kind: str = "internal",
               attrs: Optional[dict] = None, parent: Optional[dict] = None,
               child_only: bool = False) -> Optional[dict]:
    """Start a span; returns None when this call is not traced.

    Parent resolution: explicit `parent` carrier > current contextvar >
    new root (only if sampling says yes and not `child_only`)."""
    if parent is None:
        cur = _current.get()
        if cur is not None:
            parent = {"trace_id": cur["trace_id"], "span_id": cur["span_id"]}
    if parent:
        trace_id = parent.get("trace_id")
        if not trace_id:
            return None
        parent_id = parent.get("span_id")
    else:
        if child_only:
            return None
        cfg = _cfg()
        if not cfg.tracing_enabled:
            return None
        if random.random() >= cfg.tracing_sample_rate:
            return None
        trace_id, parent_id = _new_trace_id(), None
    return {
        "trace_id": trace_id,
        "span_id": _new_span_id(),
        "parent_id": parent_id,
        "name": name,
        "kind": kind,
        "start": time.time(),
        "end": None,
        "status": "ok",
        "pid": os.getpid(),
        "attrs": dict(attrs or {}),
    }


def finish_span(span: Optional[dict]) -> None:
    if span is None:
        return
    if span.get("end") is None:
        span["end"] = time.time()
    _record(span)


@contextlib.contextmanager
def span(name: str, kind: str = "internal", attrs: Optional[dict] = None,
         parent: Optional[dict] = None,
         child_only: bool = False) -> Iterator[Optional[dict]]:
    s = start_span(name, kind=kind, attrs=attrs, parent=parent,
                   child_only=child_only)
    if s is None:
        yield None
        return
    token = _current.set(s)
    try:
        yield s
    except BaseException as e:
        s["status"] = "error"
        s["attrs"]["error"] = type(e).__name__
        raise
    finally:
        _current.reset(token)
        finish_span(s)


@contextlib.contextmanager
def span_from(carrier: Optional[dict], name: str, kind: str = "server",
              attrs: Optional[dict] = None) -> Iterator[Optional[dict]]:
    """Worker-side extract: parent under a propagated carrier. Hard no-op
    when the carrier is falsy — unsampled specs never root new traces."""
    if not carrier:
        yield None
        return
    with span(name, kind=kind, attrs=attrs, parent=carrier) as s:
        yield s


def record_span(name: str, start: float, end: float,
                parent: Optional[dict] = None, kind: str = "internal",
                attrs: Optional[dict] = None) -> Optional[dict]:
    """Manually record a completed span under `parent` — for threads with
    no ambient context (lease pool, LLM engine loop). No-op without a
    usable parent carrier."""
    if not parent or not parent.get("trace_id"):
        return None
    s = {
        "trace_id": parent["trace_id"],
        "span_id": _new_span_id(),
        "parent_id": parent.get("span_id"),
        "name": name,
        "kind": kind,
        "start": start,
        "end": end,
        "status": "ok",
        "pid": os.getpid(),
        "attrs": dict(attrs or {}),
    }
    _record(s)
    return s


# ---- buffering / flush --------------------------------------------------

def _record(span: dict) -> None:
    try:
        batch = max(1, int(_cfg().trace_flush_batch))
    except Exception:  # noqa: BLE001 — config may be mid-teardown
        batch = 256
    with _buffer_lock:
        _buffer.append(span)
        full = len(_buffer) >= batch
    # flush when the batch fills OR the local span stack just unwound to
    # empty (trace likely complete on this process — export promptly)
    if full or _current.get() is None:
        flush()


def flush() -> None:
    with _buffer_lock:
        if not _buffer:
            return
        spans = list(_buffer)
        _buffer.clear()
    cb = _flusher
    if cb is None:
        # no sink (e.g. module used standalone): drop rather than grow
        return
    try:
        cb(spans)
    except Exception:  # noqa: BLE001 — tracing must never break the app
        # sink unreachable (e.g. CP outage): keep the spans for the next
        # flush instead of losing the trace tail. Re-inserted at the front
        # so export order stays chronological; bounded so a long outage
        # can't grow the buffer without limit (oldest spans dropped first).
        try:
            cap = max(1, int(_cfg().trace_flush_buffer_max))
        except Exception:  # noqa: BLE001 — config may be mid-teardown
            cap = 4096
        with _buffer_lock:
            _buffer[:0] = spans
            del _buffer[:-cap]


def _reset_for_tests() -> None:
    global _flusher
    with _buffer_lock:
        _buffer.clear()
    _flusher = None


# ---- exporters ----------------------------------------------------------

def to_chrome_trace(spans: list[dict]) -> list[dict]:
    """Chrome-trace (catapult) complete events — same shape as
    util/state.timeline() so traces merge into the existing timeline
    tooling. pid groups by trace, tid by originating process."""
    out = []
    for s in spans:
        if s.get("start") is None:
            continue
        end = s.get("end") or s["start"]
        out.append({
            "cat": s.get("kind", "span"),
            "ph": "X",
            "name": s.get("name", "span"),
            "pid": f"trace:{s.get('trace_id', '')[:8]}",
            "tid": f"pid:{s.get('pid', 0)}",
            "ts": s["start"] * 1e6,
            "dur": (end - s["start"]) * 1e6,
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "status": s.get("status"),
                **(s.get("attrs") or {}),
            },
        })
    return out


def _otlp_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def to_otlp_json(spans: list[dict],
                 service_name: str = "ray_torch") -> dict:
    """OTLP/JSON (ExportTraceServiceRequest shape) — importable by any
    OpenTelemetry collector's file receiver."""
    otlp_spans = []
    for s in spans:
        start = s.get("start") or 0.0
        end = s.get("end") or start
        otlp_spans.append({
            "traceId": s.get("trace_id", ""),
            "spanId": s.get("span_id", ""),
            "parentSpanId": s.get("parent_id") or "",
            "name": s.get("name", "span"),
            "kind": 1,
            "startTimeUnixNano": str(int(start * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "status": {"code": 2 if s.get("status") == "error" else 1},
            "attributes": [
                {"key": k, "value": _otlp_value(v)}
                for k, v in (s.get("attrs") or {}).items()
            ],
        })
    return {
        "resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": service_name}}]},
            "scopeSpans": [{
                "scope": {"name": "ray_torch.observability.tracing"},
                "spans": otlp_spans,
            }],
        }],
    }
