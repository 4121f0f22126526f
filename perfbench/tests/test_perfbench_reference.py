"""The reference against the port's plain CPU path on a tiny corpus, its
numpy scans against its sequential loops, its independence from the
program, and the control: the reference in bfloat16 fails the comparison."""

import subprocess
import sys

import pytest

from perfbench import check
from perfbench.gen import corpus as gc
from perfbench.gen import queries as gq
from perfbench.reference import config as rc
from perfbench.reference import index as ri
from perfbench.reference import pipeline as rp
from perfbench.reference import search as rs
from perfbench.tests.tiny import TINY


@pytest.fixture(scope="module")
def world():
    c = gc.make_corpus(TINY["corpus"], TINY["corpus_seed"])
    cfg = rc.ExtractorConfig()
    return c, cfg, ri.build(c, cfg)


def _port_lines(c, sents):
    from cgx_tpu_torch import pipeline as tp
    from cgx_tpu_torch.config import DEFAULT_CONFIG
    f, e, a, lex = gc.render(c)
    prep = tp.prepare(f, e, a, lex, DEFAULT_CONFIG, None, "cpu")
    res = tp.run_queries(prep, [" ".join(s) for s in sents], DEFAULT_CONFIG)
    return res.per_query_lines, prep[0]


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_reference_equals_the_port_on_the_cpu(world, seed):
    c, cfg, ix = world
    sents = gq.make_testset(c.src, TINY["testset"], TINY["corpus_seed"],
                            seed)[:10]
    want, art = _port_lines(c, sents)
    assert rp.grammar(ix, sents, cfg) == want
    assert sum(map(len, want)) > 1000
    assert ix.pc.count == art.precomp.count


def test_numpy_scans_equal_the_loops(world, monkeypatch):
    c, cfg, ix = world
    sents = gq.make_testset(c.src, TINY["testset"], TINY["corpus_seed"],
                            17)[:8]
    monkeypatch.setattr(rs, "VEC_MIN", 10**9)
    loops = rp.grammar(ix, sents, cfg)
    monkeypatch.setattr(rs, "VEC_MIN", 0)
    assert rp.grammar(ix, sents, cfg) == loops


def test_index_arrays_match_the_programs(world):
    from cgx_tpu_torch.preproc import corpus as cp
    from cgx_tpu_torch.preproc import suffix_array as sab
    c, _, ix = world
    f, e, a, lex = gc.render(c)
    src = cp.load_source_corpus_text(f)
    tgt = cp.load_target_corpus_text(e)
    al = cp.load_alignment_fast(a, src, tgt)
    sa = sab.build_index(src.str_, use_native=False)
    assert (ix.source.str_ == src.str_).all()
    assert (ix.align.RLP == al.RLP).all()
    assert (ix.align.L_tar == al.L_tar).all()
    assert (ix.sa.sa == sa.sa).all() and (ix.sa.lcp == sa.lcp).all()
    assert (ix.sa.lcpleft == sa.lcpleft).all()
    assert (ix.sa.lcpright == sa.lcpright).all()


def test_control_fails_the_comparison(world):
    c, cfg, ix = world
    sents = gq.make_testset(c.src, TINY["testset"], TINY["corpus_seed"],
                            23)[:3]
    want = rp.grammar(ix, sents, cfg)
    low = rp.grammar(ix, sents, cfg, "bfloat16")
    off = sum(check.lines_off(g, w) for g, w in zip(low, want))
    assert off > 100


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.pipeline, perfbench.reference.index; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cgx_tpu_torch', 'cgx_tpu', 'jax', 'jaxlib'}); print(bad)"
            % check.__file__.rsplit("/perfbench/", 1)[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
