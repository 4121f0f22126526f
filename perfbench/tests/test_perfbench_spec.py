"""The harness finds each configuration, mix and metric by its file name,
and BENCHMARK.json names only what exists."""

import os

import pytest

from perfbench import spec

BENCH = spec.benchmark()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    conf = spec.config(w["config"])
    assert conf["name"] == w["config"]
    assert spec.mix(w["traffic"])["kind"] in ("requests", "build")
    assert spec.cell(BENCH, w["name"]) is w
    names = {m["name"] for m in spec.metrics(BENCH, w["name"], False)}
    assert "setup_s" in names and len(names) >= 3
    assert spec.metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(spec.reader(m["name"]))
    for w in m.get("workloads", []):
        spec.cell(BENCH, w)


def test_config_files_are_under_paths():
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert spec.config(c["name"])["reduced"] == c["reduced"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "nope.testset")
    with pytest.raises(FileNotFoundError):
        spec.config("nope")
    with pytest.raises(ModuleNotFoundError):
        spec.reader("nope_ms.testset")
