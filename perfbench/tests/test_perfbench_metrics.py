"""The metric arithmetic: a window's rate over whole requests, a build's
time over the completed builds, idle time as the complement of a union of
intervals, and the per-unit phase sums."""

import pytest

from perfbench import spec, trace


def _rec(walls, per="sentence", batch=256, window=None, ok=None):
    reqs = [dict(sentences=batch, wall_s=w, write_s=0.01, ok=True if ok is None
                 else ok[i], phases={"lexicon": 0.2 * w, "kernel": 0.1 * w,
                                     "printout": 0.05 * w})
            for i, w in enumerate(walls)]
    return dict(kind="requests", per=per, requests=reqs,
                window_s=window or sum(walls), setup_s=3.0, peak_bytes=2e9,
                launches=10 * len(walls),
                per_count=(batch * len(walls) if per == "sentence"
                           else len(walls)))


def read(name, rec):
    return spec.reader(name)(rec)


def test_rate_is_all_sentences_over_the_whole_window():
    rec = _rec([2.0, 3.0, 5.0], window=10.5)
    assert read("sentences_per_s", rec) == pytest.approx(768 / 10.5)
    rec = _rec([2.0, 3.0, 5.0], window=10.5, ok=[True, False, True])
    assert read("sentences_per_s", rec) == pytest.approx(512 / 10.5)
    assert read("sentences_per_s", _rec([1.0], per="request", batch=1)) is None


def test_per_unit_phase_sums():
    rec = _rec([2.0, 4.0])
    assert read("features_ms.testset", rec) == pytest.approx(
        1e3 * 0.2 * 6.0 / 512)
    assert read("search_ms.testset", rec) == pytest.approx(1e3 * 0.6 / 512)
    assert read("grammar_ms.testset", rec) == pytest.approx(
        1e3 * (0.3 + 0.02) / 512)
    other = 1e3 * (6.0 - 0.02 - 0.6 - 1.2 - 0.3) / 512
    assert read("pipeline_other_ms.testset", rec) == pytest.approx(other)
    assert read("launches.testset", rec) == pytest.approx(20 / 512)
    assert read("preproc_s.build", rec) is None


def test_build_metrics():
    rec = dict(kind="build", per="build", window_s=31.0, setup_s=1.0,
               peak_bytes=1e8, launches=32, per_count=2,
               builds=[dict(wall_s=15.0, phases={"refsin": 9.0,
                                                 "suffixarray": 1.0,
                                                 "precompute": 3.0,
                                                 "qrysin": 0.5})] * 2)
    assert read("index_build_s", rec) == pytest.approx(15.5)
    assert read("preproc_s.build", rec) == pytest.approx(10.0)
    assert read("precompute_s.build", rec) == pytest.approx(3.0)
    assert read("upload_s.build", rec) == pytest.approx(0.5)
    assert read("peak_device_mb", rec) == pytest.approx(100.0)
    assert read("search_ms.testset", rec) is None
    # a build that raised: counted neither in the time nor in the phases
    failed = dict(wall_s=0.5, phases={})
    rec = dict(rec, builds=rec["builds"] + [failed], per_count=2)
    assert read("index_build_s", rec) == pytest.approx(15.5)
    assert read("preproc_s.build", rec) == pytest.approx(10.0)
    assert read("index_build_s", dict(rec, per_count=0)) is None


def test_idle_is_the_complement_of_the_union():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert trace.union_length(iv) == 15 + 11 + 1
    assert trace.gaps(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    events = [(0.0, 100.0, "bench:window", False),
              (10.0, 40.0, "phase:lexicon", False),
              (50.0, 90.0, "phase:extractkernel", False),
              (0.0, 10.0, "cgx_onegap_kernel", True),
              (5.0, 10.0, "Memcpy HtoD", True),
              (60.0, 70.0, "cgx_contig_kernel", True)]
    d = trace.reduce(events)
    assert d["busy_s"] == pytest.approx(20e-6)
    assert d["kernel_s"] == pytest.approx(20e-6)
    assert d["window_s"] == pytest.approx(100e-6)
    labels = dict(d["idle_gaps"])
    assert labels == pytest.approx({"lexicon": 50e-6, "extractkernel": 30e-6})
    rec = dict(kind="requests", device=d, per_count=2)
    assert read("device_idle_pct.testset", rec) == pytest.approx(80.0)
