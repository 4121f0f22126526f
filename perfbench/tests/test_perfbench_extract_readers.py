"""The readers of the extraction's host time, its items and the grammar's
lines: their arithmetic on made-up records, None where a record lacks the
span or counter, and what they read of a program that times the engine
calls under ``extractkernel`` and counts neither items nor lines."""

import pytest

from perfbench import spec

NEW = ("extract_host_ms.testset", "extract_items.testset",
       "grammar_lines.testset")
ITEMS = {"extract.contig_items": 700, "extract.onegap_items": 200,
         "extract.twogap_items": 100}


def read(name, rec):
    return spec.reader(name)(rec)


def _requests(phases, n=2, batch=100):
    return dict(kind="requests", per="sentence", window_s=10.0, setup_s=1.0,
                peak_bytes=0, launches=3, per_count=n * batch,
                requests=[dict(sentences=batch, wall_s=5.0, write_s=0.1,
                               ok=True, phases=dict(phases))
                          for _ in range(n)])


CHILDREN = {"extractkernel": 1.0, "extractkernel/occurrences": 0.3,
            "extractkernel/rules": 0.2, "extractkernel/engine.contig": 0.25,
            "extractkernel/engine.onegap": 0.15,
            "extractkernel/engine.twogap": 0.05}


def test_extract_host_time_is_extractkernel_less_its_engine_calls():
    rec = _requests(CHILDREN)
    assert read("extract_host_ms.testset", rec) == pytest.approx(
        1e3 * 2 * (1.0 - 0.45) / 200)


def test_counters_are_summed_over_the_window_per_sentence():
    counts = {"count:" + k: v for k, v in ITEMS.items()}
    rec = _requests({**CHILDREN, **counts, "count:grammar.lines": 3000})
    assert read("extract_items.testset", rec) == pytest.approx(
        2 * 1000 / 200)
    assert read("grammar_lines.testset", rec) == pytest.approx(
        2 * 3000 / 200)
    # a family with no item in a request counts nothing there
    del rec["requests"][0]["phases"]["count:extract.twogap_items"]
    assert read("extract_items.testset", rec) == pytest.approx(1900 / 200)


def test_none_where_a_record_lacks_the_span_or_counter():
    bare = _requests({"extractkernel": 1.0, "lexicon": 2.0})
    for name in NEW:
        assert read(name, bare) is None, name
    build = dict(kind="build", per="build", window_s=30.0, setup_s=1.0,
                 peak_bytes=0, launches=4, per_count=2,
                 builds=[dict(wall_s=14.0, ok=True,
                              phases={"precompute": 3.0})] * 2)
    for name in NEW:
        assert read(name, build) is None, name
    empty = dict(_requests(CHILDREN, n=0), per_count=0)
    for name in NEW:
        assert read(name, empty) is None, name


def test_a_program_without_the_counters():
    """A program that times the engine calls under ``extractkernel`` and
    counts neither items nor lines: the host time reads, the counters do
    not."""
    rec = _requests({"extractkernel": 1.0,
                     "extractkernel/engine.contig": 0.25,
                     "extractkernel/engine.onegap": 0.15,
                     "count:lookup2.rows": 50, "count:syncs": 4})
    assert read("extract_host_ms.testset", rec) == pytest.approx(
        1e3 * 2 * 0.6 / 200)
    assert read("extract_items.testset", rec) is None
    assert read("grammar_lines.testset", rec) is None


def test_the_metrics_are_declared_for_every_testset_cell():
    bench = spec.benchmark()
    cells = sorted(w["name"] for w in bench["workloads"]
                   if w["traffic"].startswith("testset"))
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW}
    assert sorted(got) == sorted(NEW)
    for m in got.values():
        assert sorted(m["workloads"]) == cells
        assert m["moves"] == "sentences_per_s"
