"""The readers of the program's child phases and counters: their arithmetic
on made-up records, None where the program records nothing, and on a tiny
CPU run each new reader gives None or a number while every reader that was
there gives the same value with the counters in each request's or build's
``phases`` (``count:<name>``) as without them."""

import numbers

import pytest

from perfbench import cache, harness, spec
from perfbench.tests.tiny import TINY

NEW = ("lookup1_host_ms.testset", "lookup2_host_ms.testset",
       "engine_ms.testset", "syncs.testset", "copy_mb.testset",
       "kernel_mb.testset", "lookup2_yield.testset",
       "precompute_host_s.build")


def read(name, rec):
    return spec.reader(name)(rec)


def _requests(phases, counters=None, n=2, batch=100):
    """``n`` requests of ``batch`` sentences, each with ``phases`` and the
    ``counters`` as the program's timer gives them."""
    counts = {"count:" + k: v for k, v in (counters or {}).items()}
    return dict(kind="requests", per="sentence", window_s=10.0, setup_s=1.0,
                peak_bytes=0, launches=3, per_count=n * batch,
                requests=[dict(sentences=batch, wall_s=5.0, write_s=0.1,
                               ok=True, phases={**phases, **counts})
                          for _ in range(n)])


def _uncounted(rec):
    """``rec`` as a program without counters records it."""
    key = "requests" if rec["kind"] == "requests" else "builds"
    return {**rec, key: [
        {**it, "phases": {k: v for k, v in it["phases"].items()
                          if not k.startswith("count:")}}
        for it in rec[key]]}


def test_host_time_is_the_phase_less_its_engine_calls():
    rec = _requests({"lookup1": 2.0, "lookup1/route": 0.5,
                     "lookup1/engine.scan_expanded": 0.6,
                     "lookup1/engine.sa_values": 0.2,
                     "lookup2": 3.0, "lookup2/match": 1.0,
                     "lookup2/engine.two_expanded": 0.5,
                     "extractkernel": 1.0, "extractkernel/engine.contig": 0.4})
    assert read("lookup1_host_ms.testset", rec) == pytest.approx(
        1e3 * 2 * 1.2 / 200)
    assert read("lookup2_host_ms.testset", rec) == pytest.approx(
        1e3 * 2 * 2.5 / 200)
    assert read("engine_ms.testset", rec) == pytest.approx(
        1e3 * 2 * (0.6 + 0.2 + 0.5 + 0.4) / 200)


def test_span_readers_are_silent_without_children():
    rec = _requests({"lookup1": 2.0, "lookup2": 3.0})
    for name in ("lookup1_host_ms.testset", "lookup2_host_ms.testset",
                 "engine_ms.testset"):
        assert read(name, rec) is None
    build = dict(kind="build", per="build", window_s=30.0, setup_s=1.0,
                 peak_bytes=0, launches=4, per_count=2,
                 builds=[dict(wall_s=14.0, ok=True,
                              phases={"precompute": 3.0})] * 2)
    assert read("precompute_host_s.build", build) is None
    build["builds"] = [dict(wall_s=14.0, ok=True, phases={
        "precompute": 3.0, "precompute/scan": 1.5,
        "precompute/engine.gap_check": 0.25})] * 2 + [
        dict(wall_s=1.0, ok=False, phases={})]
    assert read("precompute_host_s.build", build) == pytest.approx(2.75)
    assert read("lookup1_host_ms.testset", build) is None


def test_counter_readers():
    c = {"syncs": 400, "h2d_bytes": 3_000_000, "d2h_bytes": 1_000_000,
         "bytes.A5": 2_000_000, "bytes.A2f": 6_000_000, "items.A5": 10,
         "lookup2.items": 1000, "lookup2.rows": 50}
    # each of two requests counted c
    rec = _requests({"lookup2": 3.0}, c)
    assert read("syncs.testset", rec) == pytest.approx(4.0)
    assert read("copy_mb.testset", rec) == pytest.approx(0.04)
    assert read("kernel_mb.testset", rec) == pytest.approx(0.08)
    assert read("lookup2_yield.testset", rec) == pytest.approx(0.05)
    # a program without counters, or a CPU run, which counts no copy
    for counters in (None, {}, {"lookup2.items": 0, "lookup2.rows": 0}):
        rec = _requests({}, counters)
        for name in ("syncs.testset", "copy_mb.testset", "kernel_mb.testset",
                     "lookup2_yield.testset"):
            assert read(name, rec) is None, (name, counters)


@pytest.fixture(scope="module")
def tiny_records(tmp_path_factory):
    """A traced request window and a build window of the tiny
    configuration on the CPU, as the harness records them."""
    saved = cache.CACHE
    cache.CACHE = str(tmp_path_factory.mktemp("cache"))
    try:
        bench = spec.benchmark()
        out = {}
        for cell, mix in (("iwslt14-de-en.testset",
                           dict(spec.mix("testset"), batch=8)),
                          ("iwslt14-de-en.build", spec.mix("build"))):
            run = harness.Run(cell=spec.cell(bench, cell), conf=TINY, mix=mix,
                              seed=2**31 + 7, seconds=1.0, trace=False,
                              device="cpu")
            work = str(tmp_path_factory.mktemp("work"))
            fn = (harness.run_builds if mix["kind"] == "build"
                  else harness.run_requests)
            out[cell] = (fn(run, work)[0], bench)
        return out
    finally:
        cache.CACHE = saved


def test_new_readers_on_the_tiny_run(tiny_records):
    rec, _ = tiny_records["iwslt14-de-en.testset"]
    got = {n: read(n, rec) for n in NEW if n.endswith(".testset")}
    for name, v in got.items():
        assert v is None or isinstance(v, numbers.Real), (name, v)
    # the spans and the lookups' counters exist on the CPU too; no copy or
    # launch does
    for name in ("lookup1_host_ms.testset", "lookup2_host_ms.testset",
                 "engine_ms.testset", "lookup2_yield.testset"):
        assert isinstance(got[name], numbers.Real), name
    assert got["lookup1_host_ms.testset"] > 0
    assert 0 < got["lookup2_yield.testset"] <= 1
    for name in ("syncs.testset", "copy_mb.testset", "kernel_mb.testset"):
        assert got[name] is None, name
    brec, _ = tiny_records["iwslt14-de-en.build"]
    v = read("precompute_host_s.build", brec)
    assert isinstance(v, numbers.Real) and v > 0


def test_old_readers_ignore_the_counters(tiny_records):
    for cell, (rec, bench) in tiny_records.items():
        without = _uncounted(rec)
        # the CPU run counts lookup2's work (a build has no lookup2)
        assert (without != rec) == (rec["kind"] == "requests"), cell
        for trace in (False, True):
            for m in spec.metrics(bench, cell, trace):
                if m["name"] in NEW or m["name"].startswith(
                        "device_idle_pct") or m["name"].startswith(
                        "kernel_device_ms"):
                    continue      # new, or read from a trace not taken here
                assert read(m["name"], rec) == read(m["name"], without), \
                    m["name"]
