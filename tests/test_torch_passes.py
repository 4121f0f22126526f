"""Pass 1 / pass 2 in the port: kernel A1's plain version against the JAX
``_refine_chunk_local``, ``refine_passes`` against the JAX package's, kernel
B1's plain passes against ``_pass1_batch``/``_pass2_batch``, and the LCP
passes against the refinement, bit for bit."""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402


def _inputs(name, request):
    if name == "adversarial":     # the corpus of test_passes_tpu.py
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(200, vocab=120, seed=7)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 8, seed=5) + ["zzz-oov qqq-oov"])
    if name == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 6, seed=3))
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")), jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")), jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


def _worlds(f, e, a, lex_t, q):
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jidx = jic.build_index(jsrc, jtgt, jsab.build_index(jsrc.str_),
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           JaxConfig())
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tidx = tic.build_index(tsrc, ttgt, tsab.build_index(tsrc.str_),
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           ExtractorConfig(), "cpu")
    return (jidx, jcp.load_queries(q, jsrc.vocab), tidx,
            tcp.load_queries(q, tsrc.vocab))


@pytest.mark.parametrize("depths", [4, 16])
def test_plain_a1_equals_refine_chunk_local(toy_fixture, depths, request):
    """Random lanes, including exhausted queries (depth >= sl), empty and
    full-corpus intervals."""
    jidx, jqs, tidx, tqs = _worlds(*_inputs("toy", request))
    rng = np.random.default_rng(depths)
    n = 300
    toks = rng.integers(0, jqs.totaltokens, n).astype(np.int32)
    sls = rng.integers(1, 12, n).astype(np.int32)
    a = rng.integers(0, jidx.reflen + 1, n)
    b = rng.integers(0, jidx.reflen + 1, n)
    lo = np.minimum(a, b).astype(np.int32)
    hi = np.maximum(a, b).astype(np.int32)
    hi[:10] = jidx.reflen
    lo[:10] = 0
    d0 = int(rng.integers(0, 5))
    want = jpasses._refine_chunk_local(
        jidx.sa, jidx.refstr_padded, jqs.device_tokens(), jnp.asarray(toks),
        jnp.asarray(sls), jnp.asarray(lo), jnp.asarray(hi), jnp.int32(d0),
        depths=depths)
    got = tpasses.refine_chunk(
        tidx.sa, tidx.refstr_padded, tidx.query_tokens(tqs),
        *(torch.from_numpy(x) for x in (toks, sls, lo, hi)), d0, depths)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("corpus", ["toy", "real", "hard"])
def test_refine_passes_equal_jax(corpus, request):
    jidx, jqs, tidx, tqs = _worlds(*_inputs(corpus, request))
    j1, j2 = jpasses.refine_passes(jidx, jqs)
    stats = {}
    t1, t2 = tpasses.refine_passes(tidx, tqs, stats=stats)
    for want, got in ((j1, t1), (j2, t2)):
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)
    assert int(t1.longestmatch.max()) >= 3 and stats["max_depth"] >= 4


def _fields_equal(got, want, names=None):
    for f in dataclasses.fields(want):
        if names is None or f.name in names:
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name),
                                          err_msg=f.name)


@pytest.mark.parametrize("corpus", ["toy", "adversarial"])
def test_plain_b1_equals_pass_batches(corpus, request):
    """Pass 1 on every query token and pass 2 on every work item, through
    the wrappers (plain versions on the CPU) and through pass1_lcp /
    pass2_lcp, against the JAX batches and pass1_tpu / pass2_tpu."""
    jidx, jqs, tidx, tqs = _worlds(*_inputs(corpus, request))
    n = jqs.totaltokens
    sls = tpasses._suffix_lens(tqs)
    toks = np.arange(n, dtype=np.int32)
    want1 = jpasses._pass1_batch(
        jidx.refstr_padded, jidx.sa, jidx.lcpleft, jidx.lcpright,
        jqs.device_tokens(), jnp.asarray(toks), jnp.asarray(sls),
        jnp.int32(jidx.reflen))
    lcpl, lcpr = tidx.lcp_tables()
    got1 = tpasses.pass1(tidx.refstr_padded, tidx.sa, lcpl, lcpr,
                         tidx.query_tokens(tqs), torch.from_numpy(toks),
                         torch.from_numpy(sls), tidx.reflen)
    assert len(got1) == 6
    for g, w in zip(got1, want1):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    j1 = jpasses.pass1_tpu(jidx, jqs)
    t1 = tpasses.pass1_lcp(tidx, tqs)
    _fields_equal(t1, j1)
    assert (t1.firstfindhit >= 0).any() and (t1.longestmatch == 0).any()

    _, it_toks, it_match = tpasses.pass2_work_items(t1)
    cols = [it_toks, it_match, t1.firstfindhitL[it_toks],
            t1.firstfindhit[it_toks], t1.firstfindhitR[it_toks]]
    want2 = jpasses._pass2_batch(
        jidx.refstr_padded, jidx.sa, jidx.lcpleft, jidx.lcpright,
        jqs.device_tokens(), *(jnp.asarray(c) for c in cols))
    got2 = tpasses.pass2(tidx.refstr_padded, tidx.sa, lcpl, lcpr,
                         tidx.query_tokens(tqs),
                         *(torch.from_numpy(np.ascontiguousarray(c))
                           for c in cols))
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _fields_equal(tpasses.pass2_lcp(tidx, tqs, t1),
                  jpasses.pass2_tpu(jidx, jqs, j1))
    assert len(it_toks) > 0


@pytest.mark.parametrize("corpus", ["toy", "real", "hard", "adversarial"])
def test_lcp_passes_equal_refinement(corpus, request):
    """The LCP search and the interval refinement agree on everything the
    later stages read: up, down, longestmatch and pass 2's ranges."""
    _, _, tidx, tqs = _worlds(*_inputs(corpus, request))
    r1, r2 = tpasses.refine_passes(tidx, tqs)
    l1 = tpasses.pass1_lcp(tidx, tqs)
    l2 = tpasses.pass2_lcp(tidx, tqs, l1)
    _fields_equal(l1, r1, ("up", "down", "longestmatch"))
    _fields_equal(l2, r2)
    assert int(l1.longestmatch.max()) >= 3
