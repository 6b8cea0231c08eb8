"""The flight-recorder journal, tracing spans and runtime config of the
PyTorch port (``ray_torch/observability/{events,tracing}.py``,
``ray_torch/core/config.py``) against the reference's modules, pure
Python, no engine.

- config: the same fields, defaults, ``RAY_TPU_<NAME>`` variables and
  ``_system_config`` blob;
- events: the same taxonomy and event dicts; ``emit`` to a local sink and
  the kill switch through the config; the flusher's backlog across a send
  outage and a failure mid-drain, with a fake send, as
  ``tests/test_events.py`` holds the reference's; without a sink and with
  no runtime the port keeps events in the bounded backlog;
- the profiler's ``mid_traffic_compile`` event equals the reference's
  apart from ``ts``, and warmup emits nothing;
- tracing: disabled, sample rate 0, propagation by presence, batching,
  error status, ``record_span`` without a parent, the bounded re-queue of
  a failed flush, and the Chrome / OTLP exporters on the same spans.

Every test leaves both packages' process-global state (sink, flusher,
span buffer and sink, config) as it found it.
"""

import json
import os

import pytest

import ray_tpu.util  # noqa: F401  (before ray_tpu.observability.profiling)
from ray_tpu.core import config as rconfig
from ray_tpu.observability import events as revents
from ray_tpu.observability import profiling as rprofiling
from ray_tpu.observability import tracing as rtracing
from ray_torch.core import config as tconfig
from ray_torch.observability import events as tevents
from ray_torch.observability import profiling as tprofiling
from ray_torch.observability import tracing as ttracing

PACKAGES = {"ray_tpu": (revents, rtracing, rconfig),
            "ray_torch": (tevents, ttracing, tconfig)}


@pytest.fixture(autouse=True)
def _isolated_globals():
    """Save the reference's globals and restore them; reset the port's."""
    saved = (revents._local_sink, revents._flusher, rtracing._flusher,
             list(rtracing._buffer))
    yield
    tevents.clear_local_sink()
    tevents.reset(final=False)
    ttracing._reset_for_tests()
    tconfig.reset_config()
    revents._local_sink, flusher, rtracing._flusher = saved[:3]
    if revents._flusher is not flusher:
        revents.reset(final=False)
        revents._flusher = flusher
    rtracing._buffer[:] = saved[3]


def _both(run):
    """``run(events, tracing, config)`` for each package: {name: result}."""
    return {name: run(*mods) for name, mods in PACKAGES.items()}


# ---------------------------------------------------------------------------
# config


def test_config_fields_and_defaults_equal_the_reference():
    got, want = tconfig.Config(), rconfig.Config()
    names = [f.name for f in tconfig.fields(got)]
    assert names == [f.name for f in rconfig.fields(want)]
    assert {n: getattr(got, n) for n in names} == \
        {n: getattr(want, n) for n in names}
    assert (tconfig._ENV_PREFIX, tconfig._SYSTEM_CONFIG_ENV) == \
        (rconfig._ENV_PREFIX, rconfig._SYSTEM_CONFIG_ENV)


def test_one_environment_configures_both(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TRACING_ENABLED", "yes")
    monkeypatch.setenv("RAY_TPU_EVENTS_FLUSH_BUFFER_MAX", "7")
    monkeypatch.setenv("RAY_TPU_SYSTEM_CONFIG",
                       json.dumps({"tracing_sample_rate": 0.25}))

    def read(_ev, _tr, cfg_mod):
        c = cfg_mod.Config()
        with pytest.raises(ValueError, match="unknown system config flag"):
            c.apply({"no_such_flag": 1})
        return (c.tracing_enabled, c.events_flush_buffer_max,
                c.tracing_sample_rate, c.to_env({"events_enabled": False}),
                c.to_env())

    got = _both(read)
    assert got["ray_torch"] == got["ray_tpu"] == (
        True, 7, 0.25,
        {"RAY_TPU_SYSTEM_CONFIG": '{"events_enabled": false}'}, {})
    first = tconfig.get_config()
    assert tconfig.get_config() is first
    tconfig.reset_config()
    assert tconfig.get_config() is not first
    assert os.path.isdir(os.path.join(tconfig.package_parent_path(),
                                      "ray_torch"))


# ---------------------------------------------------------------------------
# events


def test_taxonomy_equals_the_reference():
    assert tevents.KINDS == revents.KINDS and len(tevents.KINDS) == 15
    assert tevents.SEVERITIES == revents.SEVERITIES
    assert tevents.SEVERITY_RANK == revents.SEVERITY_RANK


@pytest.mark.parametrize("kind,severity,fields", [
    ("replica_ejected", "WARNING",
     dict(node="n1", deployment="app#D", replica="r9", request_id="req-1",
          trace_id="t-1", reason="3 consecutive faults",
          attrs={"threshold": 3}, ts=123.5)),
    ("warm_start", "INFO", dict(ts=5)),
    ("restore_partial", "WARNING",
     dict(request_id=17, attrs={"restored_pages": 1, "planned_pages": 3},
          ts=1.0)),
    ("made_up_kind", "INFO", {}),
    ("warm_start", "FATAL", {}),
])
def test_make_event_equals_the_reference(kind, severity, fields):
    def make(ev, _tr, _cfg):
        try:
            return ev.make_event(kind, severity, **fields)
        except ValueError as e:
            return str(e)

    got = _both(make)
    assert got["ray_torch"] == got["ray_tpu"]
    if kind in tevents.KINDS and severity in tevents.SEVERITIES:
        assert got["ray_torch"]["kind"] == kind


def test_emit_routes_to_local_sink_and_respects_kill_switch(monkeypatch):
    def run(ev, _tr, cfg_mod):
        cap = []
        ev.set_local_sink(cap.append)
        try:
            first = ev.emit("table_publish", "INFO", reason="unit", ts=1.0)
            bad = ev.emit("made_up_kind")
            monkeypatch.setattr(cfg_mod.get_config(), "events_enabled", False)
            off = ev.emit("table_publish", ts=2.0)
        finally:
            ev.clear_local_sink(cap.append)
            monkeypatch.undo()
        return first, bad, off, cap

    got = _both(run)
    assert got["ray_torch"] == got["ray_tpu"]
    first, bad, off, cap = got["ray_torch"]
    assert cap == [first] and bad is None and off is None
    assert tevents._local_sink is None


def _outage_run(ev, cfg_mod, monkeypatch):
    sent, down = [], [True]

    def send(payload):
        if down[0]:
            raise ConnectionError("cp down")
        sent.append(payload)

    f = ev.EventFlusher(send, source="unit", interval_s=999.0)
    for i in range(5):
        f.emit(ev.make_event("warm_start", ts=float(i)))
        f.flush()
    held = len(f._backlog)
    down[0] = False
    f.flush()
    first = ([p["events"][0]["ts"] for p in sent], f.shipped, f.dropped)
    monkeypatch.setattr(cfg_mod.get_config(), "events_flush_buffer_max", 3)
    down[0] = True
    for i in range(6):
        f.emit(ev.make_event("warm_start", ts=10.0 + i))
        f.flush()
    capped = len(f._backlog)
    down[0] = False
    f.flush()
    f.stop(final=True)
    monkeypatch.undo()
    return (held, first, capped, [p["events"][0]["ts"] for p in sent[5:]],
            f.dropped, f._backlog, f._thread.daemon)


def test_flusher_backlog_across_send_outage(monkeypatch):
    got = _both(lambda ev, _tr, cfg: _outage_run(ev, cfg, monkeypatch))
    assert got["ray_torch"] == got["ray_tpu"] == (
        5, ([0.0, 1.0, 2.0, 3.0, 4.0], 5, 0), 3, [13.0, 14.0, 15.0], 3, [],
        True)


def test_flusher_midstream_failure_preserves_order():
    def run(ev, _tr, _cfg):
        sent, fail_at = [], [1.0]

        def send(payload):
            if payload["events"][0]["ts"] == fail_at[0]:
                raise ConnectionError("flaky")
            sent.append(payload)

        f = ev.EventFlusher(send, source="unit", interval_s=999.0)
        for i in range(3):
            f.emit(ev.make_event("warm_start", ts=float(i)))
            f.flush()
        mid = ([p["events"][0]["ts"] for p in sent],
               [p["events"][0]["ts"] for p in f._backlog])
        fail_at[0] = -1.0
        f.emit(ev.make_event("warm_start", ts=3.0))
        f.flush()
        f.stop(final=True)
        return mid, [p["events"][0]["ts"] for p in sent]

    got = _both(run)
    assert got["ray_torch"] == got["ray_tpu"] == (
        ([0.0], [1.0, 2.0]), [0.0, 1.0, 2.0, 3.0])


def test_emit_without_a_sink_keeps_events_in_the_bounded_backlog(
        monkeypatch):
    """The port has no runtime: ``_default_send`` raises at once, so the
    process flusher (a daemon thread) keeps each batch, bounded by
    ``events_flush_buffer_max`` with the oldest evicted and counted."""
    with pytest.raises(RuntimeError, match="no runtime"):
        tevents._default_send({"events": []})
    monkeypatch.setattr(tconfig.get_config(), "events_flush_interval_s",
                        999.0)
    monkeypatch.setattr(tconfig.get_config(), "events_flush_buffer_max", 2)
    for i in range(4):
        assert tevents.emit("warm_start", ts=float(i))["ts"] == float(i)
        tevents.flush_now()
    f = tevents.get_flusher()
    assert f._thread.daemon and f.interval_s == 999.0
    assert [p["events"][0]["ts"] for p in f._backlog] == [2.0, 3.0]
    assert (f.shipped, f.dropped) == (0, 2)
    tevents.reset(final=False)
    assert not f.alive and tevents._flusher is None


def test_profiler_mid_traffic_compile_event_equals_the_reference():
    def run(ev, prof_mod):
        cap = []
        ev.set_local_sink(cap.append)
        try:
            prof = prof_mod.EngineProfiler(enabled=True)
            for sig in (("decode", 8, 0), ("prefill", 32), ("verify", 8, 2)):
                prof._record_compile(sig[0], sig, 0.3, mid_traffic=False)
            warm = list(cap)
            prof._record_compile("decode", ("decode", 16, 0), 0.712345678,
                                 mid_traffic=True)
            prof._record_compile("decode", ("decode", 16, 0), 0.7,
                                 mid_traffic=True)
            prof._record_compile("chunk", ("chunk", 64), 0.05,
                                 mid_traffic=True)
            prof._record_compile("kv_tier_inject", "inject", 0.01,
                                 mid_traffic=True)
        finally:
            ev.clear_local_sink()
        return (warm, [{k: v for k, v in e.items() if k != "ts"}
                       for e in cap],
                prof.compile_events, prof.mid_traffic_compiles)

    got = run(tevents, tprofiling)
    assert got == run(revents, rprofiling)
    warm, evs, n, mid = got
    assert warm == [] and (n, mid) == (6, 3)
    assert evs[0] == {"kind": "mid_traffic_compile", "severity": "WARNING",
                      "reason": "decode",
                      "attrs": {"kind": "decode", "sig": ["decode", 16, 0],
                                "seconds": 0.7123}}
    assert [e["attrs"]["sig"] for e in evs[1:]] == [["chunk", 64],
                                                     ["inject"]]


# ---------------------------------------------------------------------------
# tracing


def _captured(tr, run):
    """``run()`` with a span sink installed on ``tr``; the batches."""
    batches = []
    tr.flush()
    old = tr._flusher
    tr.register_flusher(batches.append)
    try:
        run()
        tr.flush()
    finally:
        tr.register_flusher(old)
    return batches


def _traced(monkeypatch, run, **flags):
    """``run(tracing)`` per package with its config's ``flags`` set; the
    span batches each sink took."""
    def per(_ev, tr, cfg_mod):
        for k, v in flags.items():
            monkeypatch.setattr(cfg_mod.get_config(), k, v)
        try:
            return _captured(tr, lambda: run(tr))
        finally:
            monkeypatch.undo()

    return _both(per)


def test_tracing_disabled_and_sample_rate_zero_are_noops(monkeypatch):
    def run(tr):
        with tr.span("root") as s:
            assert s is None and tr.inject() is None

    assert _traced(monkeypatch, run, tracing_enabled=False) == \
        {"ray_tpu": [], "ray_torch": []}

    def unsampled(tr):
        for _ in range(20):
            with tr.span("root") as s:
                assert s is None
        with tr.span_from(None, "task.run:x") as s:
            assert s is None

    assert _traced(monkeypatch, unsampled, tracing_enabled=True,
                   tracing_sample_rate=0.0) == \
        {"ray_tpu": [], "ray_torch": []}

    def child_only(tr):
        with tr.span("hot", child_only=True) as s:
            assert s is None

    assert _traced(monkeypatch, child_only, tracing_enabled=True,
                   tracing_sample_rate=1.0) == \
        {"ray_tpu": [], "ray_torch": []}


def test_propagation_decision_by_presence(monkeypatch):
    carrier = {"trace_id": "ab" * 16, "span_id": "cd" * 8}

    def run(tr):
        with tr.span_from(carrier, "task.run:x", attrs={"n": 1}) as s:
            assert s["trace_id"] == carrier["trace_id"]
            assert s["parent_id"] == carrier["span_id"]
            assert tr.inject() == {"trace_id": s["trace_id"],
                                   "span_id": s["span_id"]}
            assert tr.current_trace_id() == carrier["trace_id"]
        assert tr.current_span() is None

    got = _traced(monkeypatch, run, tracing_enabled=False)
    shape = {name: [[(s["name"], s["trace_id"], s["parent_id"], s["kind"],
                      s["status"], s["attrs"]) for s in b] for b in batches]
             for name, batches in got.items()}
    assert shape["ray_torch"] == shape["ray_tpu"] == [[
        ("task.run:x", "ab" * 16, "cd" * 8, "server", "ok", {"n": 1})]]


def test_flush_batching(monkeypatch):
    def run(tr):
        with tr.span("outer"):
            for i in range(7):
                with tr.span(f"child-{i}"):
                    pass

    got = _traced(monkeypatch, run, tracing_enabled=True,
                  tracing_sample_rate=1.0, trace_flush_batch=3)
    for batches in got.values():
        assert [len(b) for b in batches] == [3, 3, 2]
        flat = [s for b in batches for s in b]
        assert len({s["trace_id"] for s in flat}) == 1
        outer = next(s for s in flat if s["name"] == "outer")
        assert outer["parent_id"] is None
        assert all(s["parent_id"] == outer["span_id"]
                   for s in flat if s is not outer)
    assert [[s["name"] for s in b] for b in got["ray_torch"]] == \
        [[s["name"] for s in b] for b in got["ray_tpu"]]


def test_error_span_status(monkeypatch):
    def run(tr):
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("nope")

    got = _traced(monkeypatch, run, tracing_enabled=True,
                  tracing_sample_rate=1.0)
    for batches in got.values():
        (s,), = batches
        assert s["status"] == "error" and s["attrs"] == {"error": "ValueError"}
        assert s["pid"] == os.getpid() and s["end"] >= s["start"]


def test_record_span_requires_parent(monkeypatch):
    parent = {"trace_id": "ef" * 16, "span_id": "01" * 8}

    def run(tr):
        assert tr.record_span("orphan", 0.0, 1.0, parent=None) is None
        assert tr.record_span("orphan", 0.0, 1.0, parent={}) is None
        s = tr.record_span("llm.generate", 1.0, 2.5, parent=parent,
                           kind="llm", attrs={"request_id": "r1"})
        assert s["parent_id"] == parent["span_id"]

    got = _traced(monkeypatch, run, tracing_enabled=True)
    strip = {name: [[{k: v for k, v in s.items() if k != "span_id"}
                     for s in b] for b in batches]
             for name, batches in got.items()}
    assert strip["ray_torch"] == strip["ray_tpu"] == [[{
        "trace_id": "ef" * 16, "parent_id": "01" * 8, "name": "llm.generate",
        "kind": "llm", "start": 1.0, "end": 2.5, "status": "ok",
        "pid": os.getpid(), "attrs": {"request_id": "r1"}}]]


def test_failed_flush_requeues_at_the_front_bounded(monkeypatch):
    """A sink that raises keeps the spans for the next flush, in order,
    bounded by ``trace_flush_buffer_max`` (oldest dropped first)."""
    def run(_ev, tr, cfg_mod):
        monkeypatch.setattr(cfg_mod.get_config(), "trace_flush_buffer_max", 3)
        parent = {"trace_id": "12" * 16, "span_id": "34" * 8}
        got, down = [], [True]

        def sink(spans):
            if down[0]:
                raise ConnectionError("store down")
            got.append([s["name"] for s in spans])

        old = tr._flusher
        tr.register_flusher(sink)
        try:
            for i in range(5):
                tr.record_span(f"s{i}", 0.0, 1.0, parent=parent)
            held = [s["name"] for s in tr._buffer]
            down[0] = False
            tr.flush()
        finally:
            tr.register_flusher(old)
            monkeypatch.undo()
        return held, got, list(tr._buffer)

    got = _both(run)
    assert got["ray_torch"] == got["ray_tpu"] == (
        ["s2", "s3", "s4"], [["s2", "s3", "s4"]], [])


def test_exporters_equal_the_reference(monkeypatch):
    monkeypatch.setattr(tconfig.get_config(), "tracing_enabled", True)
    parent = ttracing.start_span("a", kind="submit",
                                 attrs={"n": 1, "ok": True, "x": 0.5})
    child = ttracing.start_span(
        "b", parent={"trace_id": parent["trace_id"],
                     "span_id": parent["span_id"]},
        attrs={"name": "llama"})
    child["end"] = child["start"] + 0.5
    parent["end"] = parent["start"] + 1.0
    child["status"] = "error"
    spans = [parent, child, {"name": "open", "start": None}]
    assert ttracing.to_chrome_trace(spans) == rtracing.to_chrome_trace(spans)
    chrome = ttracing.to_chrome_trace(spans)
    assert [e["name"] for e in chrome] == ["a", "b"]
    assert chrome[0]["dur"] == pytest.approx(1e6)
    got = ttracing.to_otlp_json(spans, service_name="svc")
    want = rtracing.to_otlp_json(spans, service_name="svc")
    # the instrumentation scope names the module that exported the spans
    assert got["resourceSpans"][0]["scopeSpans"][0].pop("scope") == \
        {"name": "ray_torch.observability.tracing"}
    assert want["resourceSpans"][0]["scopeSpans"][0].pop("scope") == \
        {"name": "ray_tpu.observability.tracing"}
    assert got == want
    out = got["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert out[1]["parentSpanId"] == parent["span_id"]
    assert out[1]["status"] == {"code": 2}
    assert out[0]["attributes"] == [
        {"key": "n", "value": {"intValue": "1"}},
        {"key": "ok", "value": {"boolValue": True}},
        {"key": "x", "value": {"doubleValue": 0.5}}]
    default = ttracing.to_otlp_json([])["resourceSpans"][0]
    assert default["resource"]["attributes"][0]["value"] == \
        {"stringValue": "ray_torch"}
