"""The exhaustive deployment (``extractor.is_sample`` false) through the
harness on the CPU at a tiny size: correct on the sound program, not
correct when the timed path is broken underneath, and the mode really
taken (``grammar.<i>.n`` files, exact counts past the sampler's size)."""

import dataclasses
import math
import os
import re

import numpy as np
import pytest

from perfbench import cache, harness, spec
from perfbench.gen import queries as gqueries
from perfbench.gen.corpus import src_word
from perfbench.tests.tiny import TINY

BENCH = spec.benchmark()
CELL = "iwslt14-de-en-exhaustive.testset64"
TINY_EXHAUSTIVE = dict(TINY, name="tiny-exhaustive",
                       extractor={"is_sample": False})
SEED = 2**31 + 101
SAMPLE_COUNT = re.compile(r"SampleCountF=([0-9.]+)")


@pytest.fixture(autouse=True)
def tmp_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(cache, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "cache"))


def _run(conf=TINY_EXHAUSTIVE, seconds=1.0):
    mix = dict(spec.mix(spec.cell(BENCH, CELL)["traffic"]), batch=8)
    run = harness.Run(cell=spec.cell(BENCH, CELL), conf=conf, mix=mix,
                      seed=SEED, seconds=seconds, trace=False, device="cpu")
    return harness.run_cell(run, BENCH)


def test_the_cell_names_an_unsampled_configuration_of_the_same_corpus():
    cell = spec.cell(BENCH, CELL)
    conf = spec.config(cell["config"])
    sampled = spec.config("iwslt14-de-en")
    assert conf["extractor"] == {"is_sample": False}
    assert harness.extractor_config(conf).is_sample is False
    for key in ("corpus", "corpus_seed", "testset"):
        assert conf[key] == sampled[key], key
    mix = spec.mix(cell["traffic"])
    assert (mix["kind"], mix["batch"], mix["per"]) == ("requests", 64,
                                                       "sentence")


@pytest.mark.parametrize("mode", ["unsampled"])
def test_sound_run_is_correct(mode):
    res, lines = _run()
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared"]["lines_off"] == {"value": 0, "limit": 0}
    assert res["compared"]["unanswered"] == {"value": 0, "limit": 0}
    names = {m["name"] for m in spec.metrics(BENCH, CELL, False)}
    assert set(res["metrics"]) == names - {"peak_device_mb"}
    assert lines[0].startswith("lines_off 0 limit 0")


def _alter_line(res):
    """Each answer altered where it is made."""
    res.per_query_lines = [[x[0].replace("|||", "||| ~", 1)] + x[1:] if x
                           else x for x in res.per_query_lines]


def _drop_half(res):
    """Half of the batch left out: the grammar of its second half never
    comes."""
    half = res.queries.qryscount // 2
    res.per_query_lines = res.per_query_lines[:half]
    res.queries = dataclasses.replace(res.queries,
                                      offsets=res.queries.offsets[:half])


def _sampled_lines(res):
    """The sampled grammar written where the exhaustive one was asked
    for: the right files, the wrong counts."""
    sound, prepared, lines, cfg = res.asked
    res.per_query_lines = sound(
        prepared, lines, dataclasses.replace(cfg, is_sample=True)
    ).per_query_lines


@pytest.mark.parametrize("fault", [_alter_line, _drop_half, _sampled_lines],
                         ids=["alter_line", "drop_half", "sampled_lines"])
@pytest.mark.parametrize("mode", ["unsampled"])
def test_broken_path_is_not_correct(mode, fault, monkeypatch):
    from cgx_tpu_torch import pipeline
    sound = pipeline.run_queries

    def broken(prepared, lines, cfg, *args, **kwargs):
        res = sound(prepared, lines, cfg, *args, **kwargs)
        res.asked = (sound, prepared, lines, cfg)
        fault(res)
        return res

    monkeypatch.setattr(pipeline, "run_queries", broken)
    res, _ = _run()
    assert res["correct"] is False
    c = res["compared"]
    assert c["lines_off"]["value"] > 0 or c["unanswered"]["value"] > 0


def _grammar(conf, tmp_path):
    """One request of the test set's first 8 sentences on the CPU -> (the
    corpus, the sentences, the grammar dir, the config)."""
    cfg = harness.extractor_config(conf)
    run = harness.Run(cell=spec.cell(BENCH, CELL), conf=conf, mix={},
                      seed=SEED, seconds=1.0, trace=False, device="cpu")
    corpus, prepared = harness._prepare_serving(
        run, cfg, harness.span_timer("cpu", False))
    sents = gqueries.make_testset(corpus.src, conf["testset"],
                                  conf["corpus_seed"], SEED)[:8]
    dest = str(tmp_path / conf["name"])
    harness._one_request(prepared, cfg, [" ".join(s) for s in sents], dest)
    return corpus, sents, dest, cfg


def _sample_counts(dest):
    return [float(m.group(1)) for f in sorted(os.listdir(dest))
            for line in open(os.path.join(dest, f), encoding="utf-8")
            for m in [SAMPLE_COUNT.search(line)]]


def test_the_unsampled_mode_is_taken(tmp_path):
    """Every file is ``grammar.<i>.n``; a query word occurs more often in
    the corpus than the sampler takes, and its one-word rules carry its
    whole count (log10(1 + count) past log10(301), which sampled
    extraction cannot give, and the sampled run's counts never pass)."""
    corpus, sents, dest, cfg = _grammar(TINY_EXHAUSTIVE, tmp_path)
    files = sorted(os.listdir(dest))
    assert files == sorted(f"grammar.{i}.n" for i in range(len(sents)))
    counts = np.bincount(corpus.src)
    seen = {w for s in sents for w in s}
    n, word = max((int(c), src_word(i)) for i, c in enumerate(counts)
                  if src_word(i) in seen)
    assert n > cfg.sampler
    want = float(np.float32(np.log10(np.float64(1 + n))))
    one_word = [float(SAMPLE_COUNT.search(line).group(1))
                for f in files
                for line in open(os.path.join(dest, f), encoding="utf-8")
                if line.startswith(f"[X] ||| {word} ||| ")]
    assert one_word and all(v == pytest.approx(want, abs=1e-5)
                            for v in one_word)
    assert max(_sample_counts(dest)) > math.log10(301)
    _, _, sdest, scfg = _grammar(TINY, tmp_path)
    assert scfg.is_sample
    assert sorted(os.listdir(sdest)) == [f.replace(".n", ".s") for f in files]
    assert max(_sample_counts(sdest)) <= math.log10(301) + 1e-5
