"""The port's tracing on the CPU: ``utils/timing.PhaseTimer``'s nested
phases (a stack per thread, ``parent/child`` keys, no synchronise in a
child, top-level output unchanged, profiler ranges while a profiler
records), the engine calls as child phases, the counter registry of
``kernels/build.py`` (``counted``, ``to_device``, ``to_host``,
``snapshot``, the lookups' rows, the extraction's items, the grammar's
lines, the timer's ``count:<name>`` keys) and the child phases of a whole
run of the pipeline (lookup2's on both its routes, extraction's sampled
and unsampled) and of ``cli --profile``."""

import json
import pathlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine, traced  # noqa: E402
from cgx_tpu_torch.kernels import build as kb  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.utils import timing  # noqa: E402
from cgx_tpu_torch.utils.timing import PhaseTimer  # noqa: E402
from test_torch_launch_device import FakeCards  # noqa: E402

# the child phases of a replicated run, by parent (PERF.md section 3)
CHILDREN = {
    "refsin": {"source", "target", "align", "lex"},
    "precompute": {"top", "scan", "rows", "sort", "engine.gap_check"},
    "lookup1": {"route", "scan_rows", "sort", "engine.scan_rows"},
    "lookup2": {"items", "keys", "match", "sort", "engine.two_rows"},
    "extractkernel": {"occurrences", "rules", "engine.contig",
                      "engine.onegap", "engine.twogap"},
    "lexicon": {"onegap", "twogap", "contig"},
    "printout": {"updown", "format", "lines"},
}
# lookup2's children on each route: the replicated engine matches on the
# device (A5m), every other engine (here ``scan_cols``) on the host (A5)
LOOKUP2_ROUTES = {
    "device": ({}, CHILDREN["lookup2"]),
    "host": ({"scan_cols": True},
             {"items", "keys", "match", "sort", "engine.two_expanded"}),
}


def _ticking(monkeypatch):
    """Each thread's clock advances 1 s a read."""
    local = threading.local()

    def tick():
        local.now = getattr(local, "now", 0.0) + 1.0
        return local.now
    monkeypatch.setattr(timing.time, "perf_counter", tick)


def test_nested_phases_are_kept_under_their_parent(monkeypatch):
    _ticking(monkeypatch)
    t = PhaseTimer("cpu")
    with t.phase("lookup2"):
        assert t.open_phase() == "lookup2"
        with t.phase("match", sync=False):
            assert t.open_phase() == "lookup2/match"
            with timing.child(t, "inner"):
                pass
        with timing.child(t, "sort"):
            pass
    assert t.open_phase() is None
    # clock reads 1 (lookup2 opens), 2-5 (match, inner inside), 6-7 (sort)
    # and 8 (lookup2 closes)
    assert t.buckets == {"lookup2": 7.0}
    assert t.children == {"lookup2/match": 3.0, "lookup2/match/inner": 1.0,
                          "lookup2/sort": 1.0}
    assert t.as_dict() == {**t.buckets, **t.children}
    assert t.as_dict(children=False) == t.buckets


def test_each_thread_keeps_its_own_stack():
    """Two threads inside phases at once: each child lands under its own
    thread's parent, never under the other's."""
    t = PhaseTimer("cpu")
    inside = threading.Barrier(2, timeout=30)
    seen = {}

    def work(parent, child):
        with t.phase(parent, sync=False):
            inside.wait()              # both parents open at once
            with timing.child(t, child):
                seen[child] = t.open_phase()
            inside.wait()
    threads = [threading.Thread(target=work, args=a)
               for a in (("lookup2", "match"), ("lexicon", "onegap"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert seen == {"match": "lookup2/match", "onegap": "lexicon/onegap"}
    assert set(t.children) == {"lookup2/match", "lexicon/onegap"}
    assert set(t.buckets) == {"lookup2", "lexicon"}


def test_child_without_a_parent_or_timer_is_nothing():
    t = PhaseTimer("cpu")
    with timing.child(t, "match"):
        assert t.open_phase() is None
    with timing.child(None, "match"):
        pass
    assert t.as_dict() == {}


def test_report_and_timefile_line_ignore_children(monkeypatch):
    """``report`` (the ``--timefile`` line) and the peak read only the
    top-level phases: the same text with children as without."""
    _ticking(monkeypatch)
    plain, nested = PhaseTimer("cpu"), PhaseTimer("cpu")
    for t, kids in ((plain, False), (nested, True)):
        for name in ("kernel", "lookup2", "printout"):
            with t.phase(name):
                if kids:
                    for c in ("items", "match"):
                        with timing.child(t, c):
                            pass
                else:       # the same clock reads as the children take
                    for _ in range(4):
                        timing.time.perf_counter()
        t.mem_after.update({"kernel": 7})
    assert nested.report() == plain.report()
    assert nested.peak_memory() == plain.peak_memory() == 7
    assert "match" not in nested.report()


def test_a_child_adds_no_synchronise(monkeypatch):
    """On a card a top-level phase synchronises once and reads the peak (a
    sync counted); its children do neither."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append("sync"))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: calls.append("peak") or 5)
    t = PhaseTimer("cpu")
    t.device = torch.device("cuda", 0)    # a card, as the phases see it
    before = kb.COUNTS["syncs"]
    with t.phase("lookup2"):
        with timing.child(t, "match"):
            with t.phase("sort"):          # sync asked for, not done
                pass
        assert calls == []
    assert calls == ["sync", "peak"]
    assert kb.COUNTS["syncs"] - before == 1
    assert t.mem_after == {"lookup2": 5}


def test_phases_are_profiler_ranges_only_while_recording():
    from torch.profiler import ProfilerActivity, profile
    t = PhaseTimer("cpu")
    with t.phase("quiet"):
        with timing.child(t, "inner"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("lookup2"):
            with timing.child(t, "match"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"phase:lookup2", "phase:lookup2/match"} <= names
    assert not {n for n in names if "quiet" in n}


class _Engine:
    timer = None

    @traced
    def scan_expanded(self, x):
        return self.contig(x) + 1

    @traced
    def contig(self, x):
        return x * 2


def test_engine_calls_are_children_of_the_open_phase(monkeypatch):
    _ticking(monkeypatch)
    eng = _Engine()
    assert eng.scan_expanded(3) == 7          # no timer: no span
    t = PhaseTimer("cpu")
    eng.timer = t
    assert eng.scan_expanded(3) == 7          # no open phase: no span
    assert t.as_dict() == {}
    with t.phase("lookup1"):
        assert eng.scan_expanded(3) == 7
    # the engine call inside the engine call is no span of its own
    assert set(t.children) == {"lookup1/engine.scan_expanded"}
    assert ReplicatedEngine.scan_expanded.__name__ == "scan_expanded"


def test_counted_adds_a_launch_its_items_and_bytes():
    snap = {k: c.copy() for k, c in (("l", kb.LAUNCHES), ("i", kb.ITEMS),
                                     ("b", kb.BYTES))}
    try:
        a = torch.zeros(10, dtype=torch.int32)
        b = torch.zeros((2, 3), dtype=torch.int64)
        assert kb.nbytes(a, b) == 40 + 48
        kb.counted("T0", 10, kb.nbytes(a, b))
        kb.counted("T0", 5, 12)
        assert kb.LAUNCHES["T0"] - snap["l"]["T0"] == 2
        assert kb.ITEMS["T0"] - snap["i"]["T0"] == 15
        assert kb.BYTES["T0"] - snap["b"]["T0"] == 100
        got = kb.snapshot()
        assert got["launches.T0"] == kb.LAUNCHES["T0"]
        assert got["items.T0"] == kb.ITEMS["T0"]
        assert got["bytes.T0"] == kb.BYTES["T0"]
    finally:
        for c in (kb.LAUNCHES, kb.ITEMS, kb.BYTES):
            del c["T0"]


def test_as_dict_carries_the_counters_that_grew():
    """The counters that grew since the timer began come with its phases
    as ``count:<name>``; the top-level view leaves them out."""
    t = PhaseTimer("cpu")
    try:
        with t.phase("kernel"):
            kb.counted("T0", 4, 64)
        kb.COUNTS["lookup2.rows"] += 3
        assert t.as_dict() == {**t.buckets, "count:launches.T0": 1,
                               "count:items.T0": 4, "count:bytes.T0": 64,
                               "count:lookup2.rows": 3}
        assert t.as_dict(children=False) == t.buckets
        assert PhaseTimer("cpu").as_dict() == {}
    finally:
        for c in (kb.LAUNCHES, kb.ITEMS, kb.BYTES):
            del c["T0"]
        kb.COUNTS["lookup2.rows"] -= 3


def test_copies_count_bytes_and_syncs_only_on_a_card(monkeypatch):
    before = dict(kb.COUNTS)
    h = np.arange(10, dtype=np.int32)
    t = kb.to_device(h, "cpu")
    assert kb.to_host(t).numpy().tolist() == h.tolist()
    assert dict(kb.COUNTS) == before            # the CPU counts nothing
    FakeCards(monkeypatch, 1)
    d = kb.to_device(h, "cuda:0")
    assert d.device == torch.device("cuda", 0)
    d2 = kb.to_device(torch.zeros((3, 2), dtype=torch.int64), "cuda:0")
    assert kb.to_device(d, "cuda:0") is d       # on the card already
    back = kb.to_host(d)
    assert back.tolist() == h.tolist()
    kb.to_host(d2)

    def grew(k):
        return kb.COUNTS[k] - before.get(k, 0)
    assert grew("h2d_bytes") == 40 + 48
    assert grew("d2h_bytes") == 40 + 48
    assert grew("syncs") == 2


@pytest.fixture(scope="module")
def toy_run(toy_fixture):
    d = pathlib.Path(toy_fixture)
    args = [cp.read_lines(str(d / n)) for n in ("corpus.f", "corpus.e",
                                                "corpus.a")]
    counts0 = dict(kb.COUNTS)
    items0 = dict(kb.ITEMS)
    res = tpl.run_pipeline(*args, cp.read_tokens(str(d / "lex.txt")),
                           cp.read_lines(str(d / "query.f")),
                           ExtractorConfig(), device="cpu")
    grew = {k: v - counts0.get(k, 0) for k, v in kb.COUNTS.items()}
    return res, grew, items0


def test_pipeline_children_are_named_and_within_their_parent(toy_run):
    res = toy_run[0]
    t = res.timing
    for parent, kids in CHILDREN.items():
        got = {k.split("/", 1)[1] for k in t.children
               if k.split("/")[0] == parent and k.count("/") == 1}
        assert kids <= got, (parent, got)
    direct = {}
    for k, v in t.children.items():
        parent = k.rsplit("/", 1)[0]
        direct[parent] = direct.get(parent, 0.0) + v
    for parent, total in direct.items():
        assert total <= t.as_dict()[parent] + 1e-9, parent
    assert "/" not in " ".join(t.buckets)
    assert "match" not in t.report()


def test_lookups_count_their_rows_and_a_cpu_run_no_copy(toy_run):
    res, grew, items0 = toy_run
    assert grew["lookup2.rows"] == res.counters["twogap_sa"] > 0
    assert grew["lookup2.items"] >= grew["lookup2.rows"]
    assert grew["lookup2.device_items"] == grew["lookup2.items"]
    assert grew["lookup1.device_items"] == grew["lookup1.items"] > 0
    assert [grew.get(k, 0) for k in ("syncs", "h2d_bytes", "d2h_bytes")] \
        == [0, 0, 0]
    assert dict(kb.ITEMS) == items0            # no launch on the CPU


# the extraction's item counters and the engine call whose items each counts
EXTRACT_ITEMS = {"contig": "extract.contig_items",
                 "onegap": "extract.onegap_items",
                 "twogap": "extract.twogap_items"}


@pytest.mark.parametrize("is_sample", [True, False],
                         ids=["sampled", "unsampled"])
def test_extraction_counts_the_items_of_each_engine_call(
        toy_fixture, monkeypatch, is_sample):
    """``extract.<family>_items`` grow by the items handed to the engine's
    ``contig``, ``onegap`` and ``twogap`` (A6, A7, A8), ``grammar.lines``
    by the lines formatted, and ``extractkernel``'s children are the host
    stages and the three engine calls, with and without sampling."""
    handed = {k: 0 for k in EXTRACT_ITEMS}
    for name in EXTRACT_ITEMS:
        real = getattr(ReplicatedEngine, name)

        def rec(self, *args, _real=real, _name=name, **kw):
            handed[_name] += len(args[0])
            return _real(self, *args, **kw)
        monkeypatch.setattr(ReplicatedEngine, name, rec)
    d = pathlib.Path(toy_fixture)
    args = [cp.read_lines(str(d / n)) for n in ("corpus.f", "corpus.e",
                                                "corpus.a")]
    counts0 = dict(kb.COUNTS)
    res = tpl.run_pipeline(*args, cp.read_tokens(str(d / "lex.txt")),
                           cp.read_lines(str(d / "query.f")),
                           ExtractorConfig(is_sample=is_sample),
                           device="cpu")
    grew = {k: v - counts0.get(k, 0) for k, v in kb.COUNTS.items()}
    assert {k: grew.get(c, 0) for k, c in EXTRACT_ITEMS.items()} == handed
    assert all(handed.values()), handed
    assert grew["grammar.lines"] == res.counters["total_lines"] > 0
    got = {k.split("/", 1)[1] for k in res.timing.children
           if k.startswith("extractkernel/") and k.count("/") == 1}
    assert got == CHILDREN["extractkernel"]
    d = res.timing.as_dict()
    for k, c in EXTRACT_ITEMS.items():
        assert d["count:" + c] == handed[k]


# lookup1's children on each route: the replicated engine turns the scans'
# hits into rows on the device (A2m), every other engine (here
# ``scan_cols``) on the host (A2, then the SA words); ``pcs_rows`` and
# ``engine.pcs_expanded`` (A3) are the same on both
LOOKUP1_ROUTES = {
    "device": ({}, CHILDREN["lookup1"]),
    "host": ({"scan_cols": True},
             {"route", "scan_rows", "sort", "engine.scan_expanded",
              "engine.sa_values"}),
}


@pytest.mark.parametrize("route", sorted(LOOKUP1_ROUTES))
def test_lookup1_children_on_each_route(toy_fixture, route):
    """lookup1's child phases name its engine calls: ``engine.scan_rows``
    on the device route, ``engine.scan_expanded`` and ``engine.sa_values``
    on the host route; ``lookup1.items`` counts A2's items on both, and
    ``lookup1.device_items`` all of them on the device route, none on the
    host route."""
    kw, kids = LOOKUP1_ROUTES[route]
    d = pathlib.Path(toy_fixture)
    args = [cp.read_lines(str(d / n)) for n in ("corpus.f", "corpus.e",
                                                "corpus.a")]
    counts0 = dict(kb.COUNTS)
    res = tpl.run_pipeline(*args, cp.read_tokens(str(d / "lex.txt")),
                           cp.read_lines(str(d / "query.f")),
                           ExtractorConfig(), device="cpu", **kw)
    got = {k.split("/", 1)[1] for k in res.timing.children
           if k.startswith("lookup1/") and k.count("/") == 1}
    assert got - {"pcs_rows", "engine.pcs_expanded"} == kids
    grew = {k: v - counts0.get(k, 0) for k, v in kb.COUNTS.items()}
    assert grew["lookup1.items"] > 0
    assert grew.get("lookup1.device_items", 0) == (
        grew["lookup1.items"] if route == "device" else 0)
    d = res.timing.as_dict()
    assert d["count:lookup1.items"] == grew["lookup1.items"]


@pytest.mark.parametrize("route", sorted(LOOKUP2_ROUTES))
def test_lookup2_children_on_each_route(toy_fixture, route):
    """lookup2's child phases name its engine call: ``engine.two_rows`` on
    the device route, ``engine.two_expanded`` on the host route, whose
    items ``lookup2.device_items`` does not count."""
    kw, kids = LOOKUP2_ROUTES[route]
    d = pathlib.Path(toy_fixture)
    args = [cp.read_lines(str(d / n)) for n in ("corpus.f", "corpus.e",
                                                "corpus.a")]
    counts0 = dict(kb.COUNTS)
    res = tpl.run_pipeline(*args, cp.read_tokens(str(d / "lex.txt")),
                           cp.read_lines(str(d / "query.f")),
                           ExtractorConfig(), device="cpu", **kw)
    got = {k.split("/", 1)[1] for k in res.timing.children
           if k.startswith("lookup2/") and k.count("/") == 1}
    assert got == kids
    grew = {k: v - counts0.get(k, 0) for k, v in kb.COUNTS.items()}
    assert grew["lookup2.items"] > 0
    assert grew.get("lookup2.device_items", 0) == (
        grew["lookup2.items"] if route == "device" else 0)


def test_cli_profile_names_the_child_phases(toy_fixture, tmp_path):
    d = pathlib.Path(toy_fixture)
    prof = tmp_path / "prof"
    tf = tmp_path / "times.txt"
    rc = cli.main(["--device", "cpu", "--profile", str(prof), "-s", str(tf),
                   str(d / "corpus.f"), str(d / "query.f"),
                   str(d / "corpus.e"), str(d / "corpus.a"),
                   str(d / "lex.txt"), str(tmp_path / "out")])
    assert rc == 0
    trace = json.loads((prof / "trace.json").read_text())
    names = {ev.get("name") or "" for ev in trace["traceEvents"]}
    assert {"phase:lookup2", "phase:lookup2/match",
            "phase:lookup1/route"} <= names
    assert any(n.startswith("phase:") and "/engine." in n for n in names)
    line = tf.read_text().splitlines()[-1]
    assert line.startswith("wall: ") and "lookup2: " in line
    assert "/" not in line and "match" not in line
