"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped): correct on the sound program, not correct when the timed path is
broken underneath, and no module of JAX or of the JAX package loaded.  The
chip test runs ``run.py`` itself on the card."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import cache, harness, spec
from perfbench.tests.tiny import TINY

# the benchmark, with an on-demand cell of the kind a later change may add
# by data alone: one sentence a request, counted per request
BENCH = spec.benchmark()
BENCH["workloads"].append({"name": "iwslt14-de-en.ondemand",
                           "config": "iwslt14-de-en", "traffic": "ondemand",
                           "chips": 1, "why": "test"})
CELLS = {"testset": "iwslt14-de-en.testset",
         "ondemand": "iwslt14-de-en.ondemand",
         "build": "iwslt14-de-en.build"}
ONDEMAND = {"kind": "requests", "batch": 1, "per": "request"}


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(cache, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "cache"))


def _run(mix_name, trace=False, seconds=1.0):
    if mix_name == "ondemand":
        mix = ONDEMAND
    else:
        mix = spec.mix(mix_name)
    if mix_name == "testset":
        mix = dict(mix, batch=8)
    run = harness.Run(cell=spec.cell(BENCH, CELLS[mix_name]), conf=TINY,
                      mix=mix, seed=2**31 + 101, seconds=seconds,
                      trace=trace, device="cpu")
    return harness.run_cell(run, BENCH)


@pytest.mark.parametrize("mix_name", ["testset", "ondemand", "build"])
def test_sound_run_is_correct(mix_name):
    res, lines = _run(mix_name)
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "compared"
    assert res["compared"]["lines_off"] == {"value": 0, "limit": 0}
    names = {m["name"] for m in spec.metrics(BENCH, CELLS[mix_name], False)}
    assert set(res["metrics"]) == names - {"peak_device_mb"}
    assert lines[0].startswith("lines_off 0 limit 0")


def _alter_line(res):
    """Each answer altered where it is made."""
    res.per_query_lines = [[x[0].replace("|||", "||| ~", 1)] + x[1:] if x
                           else x for x in res.per_query_lines]


def _drop_half(res):
    """Half of the batch left out: the grammar of its second half never
    comes."""
    import dataclasses
    half = res.queries.qryscount // 2
    res.per_query_lines = res.per_query_lines[:half]
    res.queries = dataclasses.replace(res.queries,
                                      offsets=res.queries.offsets[:half])


@pytest.mark.parametrize("fault", [_alter_line, _drop_half],
                         ids=["alter_line", "drop_half"])
@pytest.mark.parametrize("mix_name", ["testset", "ondemand", "build"])
def test_broken_path_is_not_correct(mix_name, fault, monkeypatch):
    from cgx_tpu_torch import pipeline
    sound = pipeline.run_queries

    def broken(*args, **kwargs):
        res = sound(*args, **kwargs)
        fault(res)
        return res

    monkeypatch.setattr(pipeline, "run_queries", broken)
    res, _ = _run(mix_name)
    assert res["correct"] is False
    c = res["compared"]
    assert c["lines_off"]["value"] > 0 or c["unanswered"]["value"] > 0


@pytest.mark.parametrize("mix_name", ["testset", "build"])
def test_a_request_or_build_that_raises_is_not_correct(mix_name,
                                                        monkeypatch):
    from cgx_tpu_torch import pipeline
    name = "prepare" if mix_name == "build" else "run_queries"
    sound, calls = getattr(pipeline, name), []

    def raises_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:          # the first timed one
            raise RuntimeError("planted")
        return sound(*args, **kwargs)

    monkeypatch.setattr(pipeline, name, raises_once)
    res, lines = _run(mix_name)
    assert res["failed"] == 1 and res["correct"] is False
    assert res["compared"]["failed"] == {"value": 1, "limit": 0}
    assert "failed 1 limit 0" in lines


def test_traced_run_reads_layers_and_loads_no_jax():
    code = f"""
import sys
sys.path.insert(0, {spec.ROOT!r})
from perfbench import cache, harness, spec
from perfbench.tests.tiny import TINY
cache.CACHE = {str(cache.CACHE)!r}
bench = spec.benchmark()
mix = dict(spec.mix("testset"), batch=8)
run = harness.Run(cell=spec.cell(bench, "iwslt14-de-en.testset"), conf=TINY,
                  mix=mix, seed=7, seconds=1.0, trace=True, device="cpu")
res, _ = harness.run_cell(run, bench)
import json
print(json.dumps(dict(res=res, top=sorted({{m.split('.')[0] for m in sys.modules}}))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    got = json.loads(out)
    res, top = got["res"], set(got["top"])
    assert res["correct"] is True
    assert "search_ms.testset" in res["metrics"]
    assert "window_s" in res["device"] and "breakdown" in res
    assert "cgx_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "cgx_tpu"}


def test_a_loaded_jax_module_refuses_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax"]
    with pytest.raises(RuntimeError, match="jax"):
        _run("testset")


def test_run_py_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                        "--workload", "iwslt14-de-en.testset", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
def test_run_py_on_the_card(card):
    p = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"),
                        "--workload", "iwslt14-de-en.testset", "--seed",
                        "2147483777", "--seconds", "5", "--trace", "1"],
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["busy_s"] > 0
