"""Per-request critical-path attribution: the port's copy of
``ray_tpu/observability/attribution.py``.

One ordered timeline per serve request, assembled from stamps made at
every layer the request crosses. In the port the engine is the only
layer that stamps: it reports its stages as raw numbers in each
completion's metadata, and :func:`engine_stages` converts them into
``queue`` (submit→admit wait), ``restore`` (KV-tier pull), ``prefill``
(admit→first token minus restore) and ``decode`` (first→last token)
stage dicts. ``LLMServer`` returns them under ``ray_tpu.stages``.
:func:`aggregate_report` answers "where did p99 go" over a set of
records: per-stage percentiles and the dominant stage of the tail.

Left out: the exemplar shipper (``_Shipper`` / ``ship_record``), which
hands finished records to the control plane's SLO exemplar store, and
with it the SLO policy the proxy judges records against. Both need the
runtime core (control plane, proxy), which the port does not have yet;
they come back with it (ROADMAP Queue 1 item 6). Everything here is
pure and imports the standard library only.

The context variables have names of their own, so a process that imports
both this module and the reference's never shares a timeline or a
request id between them.
"""

from __future__ import annotations

import contextvars
import time
from typing import Any, Optional

# Canonical stage order. A request's record sorts stamps by
# (STAGES index, start time) so retries and out-of-order arrival from
# different layers still render as one coherent waterfall. ``failover``
# sits between route and queue: a mid-stream resume re-enters the
# pipeline (re-route + continuation admit), so its engine-side stages
# (queue/restore/prefill/decode of the resumed leg) sort after it while
# the original leg's stamps keep their earlier start times.
# ``prefill_remote`` (disaggregated prefill) sits between failover and
# queue: the proxy runs the remote prefill BEFORE dispatching the decode
# leg, so the decode replica's queue/restore/decode stages sort after it.
STAGES = ("ingress", "route", "failover", "prefill_remote", "queue",
          "restore", "prefill", "decode")

_STAGE_INDEX = {s: i for i, s in enumerate(STAGES)}


class Timeline:
    """Mutable per-request stage collector.

    Held in a contextvar and carried into executor threads by
    ``contextvars.copy_context()`` — the threads mutate the SAME object,
    so stamps made off the event loop are visible when the request is
    finalized. Single-request, single-writer-at-a-time; no lock.
    """

    __slots__ = ("request_id", "app", "deployment", "started_wall",
                 "stages", "route_attrs", "replica", "trace_id")

    def __init__(self, request_id: str, app: str = "", deployment: str = ""):
        self.request_id = request_id
        self.app = app
        self.deployment = deployment
        self.started_wall = time.time()
        self.stages: list[dict] = []
        self.route_attrs: dict[str, Any] = {}
        self.replica: str = ""
        self.trace_id: str = ""

    def stamp(self, stage: str, start: float, end: float, **attrs) -> None:
        """Record one stage occurrence (wall-clock seconds). A ``route``
        stamp absorbs any annotations accumulated through :meth:`note`
        (the routing decision is made piecemeal, but renders as one
        stage)."""
        merged = dict(attrs) if attrs else {}
        if stage == "route" and self.route_attrs:
            merged = {**self.route_attrs, **merged}
            self.route_attrs = {}
        self.stages.append({
            "stage": stage, "start": float(start), "end": float(end),
            "attrs": merged,
        })

    def note(self, **attrs) -> None:
        """Merge routing-decision attributes (demotion reason, matched
        pages, chosen replica) — folded into the next ``route`` stamp."""
        self.route_attrs.update(attrs)
        rep = attrs.get("replica")
        if rep:
            self.replica = str(rep)

    def extend(self, stages: list[dict]) -> None:
        """Append engine-side stage dicts (see :func:`engine_stages`)."""
        for s in stages or []:
            if isinstance(s, dict) and "stage" in s:
                self.stages.append(s)

    def ordered_stages(self) -> list[dict]:
        return sorted(
            self.stages,
            key=lambda s: (_STAGE_INDEX.get(s.get("stage"), len(STAGES)),
                           s.get("start", 0.0)))


# ---------------------------------------------------------------------------
# request-scoped context

_current_tl: contextvars.ContextVar[Optional[Timeline]] = \
    contextvars.ContextVar("ray_torch_attr_timeline", default=None)
_current_rid: contextvars.ContextVar[str] = \
    contextvars.ContextVar("ray_torch_attr_request_id", default="")


def begin(request_id: str, app: str = "", deployment: str = "") -> Timeline:
    """Start a timeline for the current request context."""
    tl = Timeline(request_id, app=app, deployment=deployment)
    _current_tl.set(tl)
    _current_rid.set(request_id)
    return tl


def current() -> Optional[Timeline]:
    return _current_tl.get()


def stamp(stage: str, start: float, end: float, **attrs) -> None:
    """Stamp onto the current request's timeline; no-op when the caller
    is outside a request context."""
    tl = _current_tl.get()
    if tl is not None:
        tl.stamp(stage, start, end, **attrs)


def note(**attrs) -> None:
    """Annotate the current request's routing decision; no-op outside a
    request context."""
    tl = _current_tl.get()
    if tl is not None:
        tl.note(**attrs)


def set_request_id(rid: str) -> None:
    """Bind a request id (an ingress-assigned X-Request-Id) in the
    current context, so the engine's record carries the same id."""
    _current_rid.set(rid or "")


def get_request_id() -> str:
    return _current_rid.get()


# ---------------------------------------------------------------------------
# engine-side stage assembly

def engine_stages(*, submitted_wall: float, submitted_at: float,
                  admitted_at: Optional[float],
                  first_token_at: Optional[float],
                  finished_at: Optional[float],
                  cached_tokens: int = 0, restored_tokens: int = 0,
                  restore_bytes: int = 0, restore_ms: float = 0.0,
                  restore_wire_bytes: int = 0,
                  restore_decode_ms: float = 0.0,
                  restore_overlap_ms: float = 0.0,
                  restore_partial: bool = False,
                  prompt_tokens: int = 0, generated_tokens: int = 0,
                  itl_s: Optional[float] = None) -> list[dict]:
    """Build ordered stage dicts from the engine's raw per-request
    numbers. Monotonic stamps map onto the wall clock via the request's
    ``(submitted_wall, submitted_at)`` pair so cross-process stages line
    up with wall-clock stamps of other layers (same-host skew only).

    Stages degrade gracefully: a request shed while waiting yields only
    ``queue``; a request with no tokens yields no ``decode``.
    """
    def wall(mono: float) -> float:
        return submitted_wall + (mono - submitted_at)

    out: list[dict] = []
    if admitted_at is None:
        # never admitted (shed/cancelled in the waiting list)
        now_wall = submitted_wall + (time.monotonic() - submitted_at)
        out.append({"stage": "queue", "start": submitted_wall,
                    "end": now_wall, "attrs": {"admitted": False}})
        return out
    admit_wall = wall(admitted_at)
    out.append({"stage": "queue", "start": submitted_wall,
                "end": admit_wall, "attrs": {"admitted": True}})
    restore_end = admit_wall
    if restored_tokens > 0:
        restore_end = admit_wall + restore_ms / 1e3
        out.append({"stage": "restore", "start": admit_wall,
                    "end": restore_end,
                    "attrs": {"restored_tokens": int(restored_tokens),
                              "restore_bytes": int(restore_bytes),
                              "restore_ms": round(float(restore_ms), 3),
                              # streaming split: encoded bytes actually
                              # moved, codec decode cost, and how much
                              # of the wall hid under other requests'
                              # compute instead of blocking this one
                              "bytes_wire": int(restore_wire_bytes),
                              "decode_ms": round(
                                  float(restore_decode_ms), 3),
                              "overlap_ms": round(
                                  float(restore_overlap_ms), 3),
                              # stream cut short (chunk fault / chunk
                              # timeout): landed pages were kept, the
                              # tail was re-prefilled
                              "partial": bool(restore_partial)}})
    if first_token_at is not None:
        ft_wall = wall(first_token_at)
        prefilled = max(0, int(prompt_tokens) - int(cached_tokens))
        out.append({"stage": "prefill", "start": restore_end,
                    "end": max(restore_end, ft_wall),
                    "attrs": {"cached_tokens": int(cached_tokens),
                              "restored_tokens": int(restored_tokens),
                              "prefilled_tokens": prefilled}})
        end_wall = wall(finished_at) if finished_at is not None else ft_wall
        dec = {"stage": "decode", "start": ft_wall,
               "end": max(ft_wall, end_wall),
               "attrs": {"generated_tokens": int(generated_tokens)}}
        if itl_s is not None:
            dec["attrs"]["itl_ms"] = round(float(itl_s) * 1e3, 3)
        out.append(dec)
    return out


# ---------------------------------------------------------------------------
# record assembly

def build_record(tl: Timeline, *, kind: str, violated: list[str],
                 policy: dict, ttft_ms: Optional[float],
                 e2e_ms: Optional[float], source: str = "",
                 error: Optional[str] = None) -> dict:
    """One request's exemplar record: what :func:`aggregate_report` and
    :func:`stages_to_spans` read."""
    return {
        "request_id": tl.request_id,
        "ts": time.time(),
        "app": tl.app,
        "deployment": tl.deployment,
        "replica": tl.replica,
        "source": source,
        "kind": kind,                      # "violation" | "baseline"
        "violated": list(violated),
        "ttft_ms": None if ttft_ms is None else round(float(ttft_ms), 3),
        "e2e_ms": None if e2e_ms is None else round(float(e2e_ms), 3),
        "policy": dict(policy or {}),
        "error": error,
        "trace_id": tl.trace_id,
        "stages": tl.ordered_stages(),
    }


# ---------------------------------------------------------------------------
# fleet aggregation

def percentile(sorted_vals: list[float], q: float) -> float:
    """Interpolated percentile over an already-sorted list (the
    profiling.py ``_pct`` convention, shared so numbers agree)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _stage_durations_ms(record: dict) -> dict[str, float]:
    """Total wall-ms per canonical stage for one record (retries sum)."""
    out: dict[str, float] = {}
    for s in record.get("stages") or []:
        st = s.get("stage")
        if st not in _STAGE_INDEX:
            continue
        dur = max(0.0, (s.get("end", 0.0) - s.get("start", 0.0)) * 1e3)
        out[st] = out.get(st, 0.0) + dur
    return out


def aggregate_report(records: list[dict]) -> dict:
    """Tail-latency breakdown over exemplar records.

    Returns::

        {"count", "violations",
         "ttft_ms": {"p50","p95","p99","count"} | None,
         "stage_ms": {stage: {"p50","p95","p99","count"}},
         "dominant_stage": {stage: n},      # over tail requests
         "replica_skew": {replica: {"count","queue_wait_p50_ms",
                                    "queue_wait_p95_ms","affinity_hit_share",
                                    "prefilled_tokens"}}}

    ``ttft_ms`` percentiles cover every record carrying a ttft (None when
    no record has one).

    "Tail requests" are the SLO violations when any exist, else the
    slowest-decile records by e2e — so the dominant-stage table is
    meaningful even when every request is healthy.
    """
    records = [r for r in records or [] if isinstance(r, dict)]
    per_stage: dict[str, list[float]] = {s: [] for s in STAGES}
    durs: list[tuple[dict, dict]] = []
    for r in records:
        d = _stage_durations_ms(r)
        durs.append((r, d))
        for st, ms in d.items():
            per_stage[st].append(ms)

    stage_ms = {}
    for st in STAGES:
        vals = sorted(per_stage[st])
        if not vals:
            continue
        stage_ms[st] = {
            "p50": round(percentile(vals, 0.50), 3),
            "p95": round(percentile(vals, 0.95), 3),
            "p99": round(percentile(vals, 0.99), 3),
            "count": len(vals),
        }

    ttfts = sorted(float(r["ttft_ms"]) for r in records
                   if r.get("ttft_ms") is not None)
    ttft_ms = None
    if ttfts:
        ttft_ms = {
            "p50": round(percentile(ttfts, 0.50), 3),
            "p95": round(percentile(ttfts, 0.95), 3),
            "p99": round(percentile(ttfts, 0.99), 3),
            "count": len(ttfts),
        }

    violations = [(r, d) for r, d in durs if r.get("violated")]
    tail = violations
    if not tail and durs:
        ranked = sorted(durs, key=lambda rd: (rd[0].get("e2e_ms") or 0.0),
                        reverse=True)
        tail = ranked[:max(1, len(ranked) // 10)]
    dominant: dict[str, int] = {}
    for _r, d in tail:
        if not d:
            continue
        top = max(d.items(), key=lambda kv: kv[1])[0]
        dominant[top] = dominant.get(top, 0) + 1

    replicas: dict[str, dict] = {}
    for r, d in durs:
        rep = r.get("replica") or "?"
        agg = replicas.setdefault(rep, {"count": 0, "queue_waits": [],
                                        "hits": 0, "prefilled_tokens": 0})
        agg["count"] += 1
        if "queue" in d:
            agg["queue_waits"].append(d["queue"])
        route_attrs = {}
        for s in r.get("stages") or []:
            if s.get("stage") == "route":
                route_attrs.update(s.get("attrs") or {})
        if (route_attrs.get("matched_pages") or 0) > 0:
            agg["hits"] += 1
        for s in r.get("stages") or []:
            if s.get("stage") == "prefill":
                agg["prefilled_tokens"] += int(
                    (s.get("attrs") or {}).get("prefilled_tokens") or 0)
    replica_skew = {}
    for rep, agg in replicas.items():
        qs = sorted(agg["queue_waits"])
        replica_skew[rep] = {
            "count": agg["count"],
            "queue_wait_p50_ms": round(percentile(qs, 0.50), 3),
            "queue_wait_p95_ms": round(percentile(qs, 0.95), 3),
            "affinity_hit_share": round(agg["hits"] / agg["count"], 3)
            if agg["count"] else 0.0,
            "prefilled_tokens": agg["prefilled_tokens"],
        }

    return {
        "count": len(records),
        "violations": len(violations),
        "ttft_ms": ttft_ms,
        "stage_ms": stage_ms,
        "dominant_stage": dominant,
        "replica_skew": replica_skew,
    }


def stages_to_spans(record: dict) -> list[dict]:
    """Convert one exemplar's stages into span dicts (the reference's
    tracing span shape), so trace renderers draw exemplars as they draw
    traces."""
    rid = record.get("request_id") or "?"
    trace_id = record.get("trace_id") or f"slo-{rid}"
    spans = []
    starts = [s.get("start", 0.0) for s in record.get("stages") or []]
    ends = [s.get("end", 0.0) for s in record.get("stages") or []]
    root_id = f"{rid}-root"
    if starts:
        spans.append({
            "trace_id": trace_id, "span_id": root_id, "parent_id": None,
            "name": f"request:{rid}", "kind": "server",
            "start": min(starts), "end": max(ends), "status": "OK",
            "pid": record.get("deployment") or "serve",
            "attrs": {"request_id": rid,
                      "replica": record.get("replica") or "",
                      "kind": record.get("kind") or "",
                      "violated": ",".join(record.get("violated") or [])},
        })
    for i, s in enumerate(record.get("stages") or []):
        spans.append({
            "trace_id": trace_id, "span_id": f"{rid}-{i}",
            "parent_id": root_id if starts else None,
            "name": f"stage:{s.get('stage')}", "kind": "internal",
            "start": s.get("start", 0.0), "end": s.get("end", 0.0),
            "status": "OK",
            "pid": record.get("deployment") or "serve",
            "attrs": dict(s.get("attrs") or {}),
        })
    return spans
