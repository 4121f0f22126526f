"""Frequent-pair precompute in the port: kernel A4's plain version against the
JAX ``_gc_batch``, and ``precompute`` against the JAX package's
``precompute_tpu`` on every ``Precomp`` field, bit for bit."""

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
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402


def _inputs(name, request):
    if name == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return f.split("\n"), e.split("\n"), a, lex_t
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")))


@pytest.fixture(scope="module", params=["toy", "real", "hard"])
def world(request):
    """Both packages' indices of one corpus, with one configuration (the
    default, precompute_count 100) on both sides."""
    f, e, a, lex_t = _inputs(request.param, request)
    jcfg, tcfg = JaxConfig(), ExtractorConfig()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa,
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jsrc=jsrc, jsa=jsa, jidx=jidx,
                tsrc=tsrc, tsa=tsa, tidx=tidx)


@pytest.mark.parametrize("fwd", [True, False])
def test_plain_a4_equals_gc_batch(world, fwd):
    """Every occurrence of the precompute's top tokens, plus random anchors
    that run off both ends of the corpus."""
    w = world
    cfg = w["jcfg"]
    tokens, counts, run_start = jpcx.top_tokens(w["jsrc"], w["jsa"], cfg)
    sa = np.asarray(w["jsa"].sa)
    occ = np.concatenate([sa[s:s + c] for s, c in zip(run_start, counts)])
    reflen = w["jidx"].reflen
    rng = np.random.default_rng(1)
    gostart = np.concatenate([occ, rng.integers(-20, 20, 64),
                              rng.integers(reflen - 20, reflen + 40, 64),
                              rng.integers(0, reflen, 256)]).astype(np.int32)
    ix = w["jidx"]
    want = np.asarray(jpcx._gc_batch(ix.rlp, ix.lr_tar, jnp.asarray(gostart),
                                     ix.offs0, cfg.max_rule_span,
                                     cfg.min_gap_size, fwd))
    t = w["tidx"]
    got = tpcx.gap_check(t.rlp, t.lr_tar, torch.from_numpy(gostart),
                         cfg.max_rule_span, cfg.min_gap_size, fwd)
    assert got.dtype == torch.int32 and got.shape == (len(gostart),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want != 0).any() and (want != 0xFFFF).any()


def test_precompute_equals_jax(world):
    w = world
    want = jpcx.precompute_tpu(w["jidx"], w["jsrc"], w["jsa"], w["jcfg"])
    got = tpcx.precompute(ReplicatedEngine(w["tidx"], w["tcfg"]), w["tsrc"], w["tsa"], w["tcfg"])
    for f in ("frequent_list", "tok_start", "tok_len", "index_start",
              "index_end", "onegap_start", "onegap_length",
              "feature_missing"):
        g, j = getattr(got, f), getattr(want, f)
        assert g.dtype == j.dtype, f
        np.testing.assert_array_equal(g, j, err_msg=f)
    assert got.count == want.count > 0
    assert got.feature_missing.any()
