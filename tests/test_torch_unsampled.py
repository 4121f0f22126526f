"""The exhaustive mode (``is_sample`` off) of the port on the CPU against
the JAX package and ``perfbench.reference``, as ``chip_smoke.py``'s
unsampled row checks it on the card: a size's text turned into the
reference's arrays (``tools/reference_text.py``) gives the port's grammar
line for line, sampled and unsampled, and the unsampled grammar carries
counts past the sampler's size; extraction's engine calls and MaxLex's
launches cut to a fixed size give the JAX package's grammar and
counters."""

import dataclasses
import math
import pathlib
import random
import re
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as xdev  # noqa: E402
from cgx_tpu_torch.features import maxlex as ml  # noqa: E402
from cgx_tpu_torch.pipeline import run_pipeline  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.utils.batching import in_calls  # noqa: E402
from tools import make_fixture as mf  # noqa: E402
from tools.reference_text import (reference_corpus,  # noqa: E402
                                  reference_grammar)


def _data(d):
    d = pathlib.Path(d)
    return tuple(cp.read_lines(str(d / n)) for n in
                 ("corpus.f", "corpus.e", "corpus.a")) + (
        cp.read_tokens(str(d / "lex.txt")), cp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module")
def runs():
    """A corpus of medium's generator, cut to 3,000 sentences and 6
    queries, both ways: its frequent words occur more often than the
    samplers take."""
    rng = random.Random(20261018)
    f, e, a = mf.make_parallel_corpus(rng, 3000)
    lex = " ".join(mf.make_lex_file(rng, f, e, a)).split()
    data = (f, e, a, lex, mf.make_queries(rng, f, 6))
    return data, {s: run_pipeline(*data, dataclasses.replace(
        DEFAULT_CONFIG, is_sample=s), device="cpu").per_query_lines
        for s in (True, False)}


@pytest.mark.parametrize("is_sample", [True, False],
                         ids=["sampled", "unsampled"])
def test_reference_on_the_text_equals_the_port(runs, is_sample):
    data, lines = runs
    picks = list(range(len(data[4])))
    want = reference_grammar(data, {"is_sample": is_sample}, picks)
    assert len(want) == len(picks)
    for q, w in zip(picks, want):
        assert lines[is_sample][q] == w, q


def test_reference_corpus_keeps_the_texts_words(real_fixture):
    f, e, a, lex, _ = _data(real_fixture)
    c, sw, tw = reference_corpus(f, e, a, lex)
    assert [sw[i] for i in c.src[:len(f[0].split())]] == f[0].split()
    assert [tw[i] for i in c.tgt[:len(e[0].split())]] == e[0].split()
    assert c.src_len.sum() == len(c.src) and len(c.src_len) == len(f)
    assert c.link_len.tolist() == [len(ln.split()) for ln in a]
    assert len(c.lex_p1) == len(c.lex_src) <= len(lex) // 4


def test_unsampled_counts_pass_the_sampler(runs):
    """Some rule of the unsampled grammar counts more occurrences than
    the sampler takes; none of the sampled grammar does."""
    _, lines = runs

    def counts(s):
        return [float(m.group(1)) for q in lines[s] for ln in q
                for m in [re.search(r"SampleCountF=([0-9.]+)", ln)]]
    cap = math.log10(1 + DEFAULT_CONFIG.sampler)
    assert max(counts(False)) > cap
    assert max(counts(True)) <= cap + 1e-5
    assert sum(map(len, lines[False])) >= sum(map(len, lines[True]))


@pytest.fixture(scope="module")
def jax_runs(runs):
    """The JAX package's runs on the CPU of ``runs``' data, both ways."""
    data, _ = runs
    return {s: jpl.run_pipeline(*data, JaxConfig(is_sample=s))
            for s in (True, False)}


@pytest.mark.parametrize("is_sample", [True, False],
                         ids=["sampled", "unsampled"])
def test_calls_cut_to_size_give_the_same_grammar(runs, jax_runs, monkeypatch,
                                                 is_sample):
    """With ``CALL_ITEMS`` and ``CALL_RULES`` far below a request's items
    and rules, A6, A7 and A8 take several engine calls of at most
    ``CALL_ITEMS`` items each, A9/A10 several launches of at most
    ``CALL_RULES`` rules, and every line and counter is the JAX
    package's (and the lines those of the port's run in whole calls)."""
    data, lines = runs
    want = jax_runs[is_sample]
    monkeypatch.setattr(xdev, "CALL_ITEMS", 200)
    monkeypatch.setattr(ml, "CALL_RULES", 777)
    sizes = {}
    for name in ("contig", "onegap", "twogap"):
        real = getattr(ReplicatedEngine, name)

        def rec(self, *args, _real=real, _name=name, **kw):
            sizes.setdefault(_name, []).append(len(args[0]))
            return _real(self, *args, **kw)
        monkeypatch.setattr(ReplicatedEngine, name, rec)
    # the rules' source patterns: the 7th column from the end (A10 takes
    # its step count after the columns)
    for name, at in (("accum_dense", -7), ("accum_range", -8)):
        real = getattr(ml, name)

        def rec_ml(*args, _real=real, _at=at, **kw):
            sizes.setdefault("maxlex", []).append(len(args[_at]))
            return _real(*args, **kw)
        monkeypatch.setattr(ml, name, rec_ml)
    res = run_pipeline(*data, dataclasses.replace(
        DEFAULT_CONFIG, is_sample=is_sample), device="cpu")
    got = res.per_query_lines
    assert len(got) == len(want.per_query_lines)
    for q, (g, w) in enumerate(zip(got, want.per_query_lines)):
        assert g == w, q
    for k, v in want.counters.items():
        assert res.counters[k] == v, k
    assert got == lines[is_sample]
    for name, cap in (("contig", 200), ("onegap", 200), ("twogap", 200),
                      ("maxlex", 777)):
        assert len(sizes[name]) > 1 and max(sizes[name]) <= cap, (
            name, sizes[name])
        assert all(n == cap for n in sizes[name][:-1]), name


@pytest.mark.parametrize("n,size", [(0, 4), (3, 4), (4, 4), (9, 4), (9, 1)])
def test_in_calls_cuts_and_joins_in_item_order(n, size):
    """``in_calls`` hands ``call`` slices of at most ``size`` rows, in
    order, and joins each output column as one call over all rows gives
    it."""
    a = np.arange(n, dtype=np.int64)
    b = a * 10
    seen = []

    def call(x, y):
        seen.append(x.tolist())
        return x + y, x * y
    got = in_calls(call, size, a, b)
    assert [g.tolist() for g in got] == [(a + b).tolist(), (a * b).tolist()]
    assert sum(seen, []) == a.tolist()
    assert len(seen) == max(1, -(-n // size))
    assert all(len(x) == size for x in seen[:-1]) and len(seen[-1]) <= size
