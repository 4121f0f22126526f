"""One-gap patterns in the port: the enumeration and distinct scan, kernel A7's
plain version against the JAX ``_onegap_batch`` on all six output columns,
and ``extract_onegap`` against the JAX package's ``extract_onegap_tpu``, bit
for bit."""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract import device as jdev  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.oracle import search as ose  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import enumerate_fast as jef  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import enumerate_fast as tef  # noqa: E402
from cgx_tpu_torch.search import lookup as tlk  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402
from cgx_tpu_torch.types import Pass1Result  # noqa: E402
from cgx_tpu_torch.utils.views import OffsetView  # noqa: E402


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], w["tcfg"])


def _inputs(name, request):
    if name == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 6, seed=3))
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module", params=["toy", "real", "hard"])
def world(request):
    """Both packages run one corpus through lookup1, with one configuration
    (the default) on both sides."""
    f, e, a, lex_t, q = _inputs(request.param, request)
    jcfg, tcfg = JaxConfig(), ExtractorConfig()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa,
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           jcfg)
    jqs = jcp.load_queries(q, jsrc.vocab)
    jp1, jp2 = jpasses.refine_passes(jidx, jqs)
    jenum, jsearch = jef.fast_sort_and_dedup_onegap(
        jef.fast_one_gap_enumeration(jqs, jp1, jcfg), jqs)
    jpc = jpcx.precompute_tpu(jidx, jsrc, jsa, jcfg)
    jog = jlk.one_gap_lookup_tpu(jidx, np.asarray(jsa.sa), jqs, jp1, jp2,
                                 jsearch, jpc, jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    tqs = tcp.load_queries(q, tsrc.vocab)
    tp1, tp2 = tpasses.refine_passes(tidx, tqs)
    tenum, tsearch = tef.fast_sort_and_dedup_onegap(
        tef.fast_one_gap_enumeration(tqs, tp1, tcfg), tqs)
    teng = ReplicatedEngine(tidx, tcfg)
    tpc = tpcx.precompute(teng, tsrc, tsa, tcfg)
    tog = tlk.one_gap_lookup(teng, tqs, tp1, tp2, tsearch, tpc, tcfg)
    return dict(jcfg=jcfg, jidx=jidx, jqs=jqs, jenum=jenum, jsearch=jsearch,
                jpc=jpc, jog=jog, tcfg=tcfg, tidx=tidx, tqs=tqs, tp1=tp1,
                tenum=tenum, tsearch=tsearch, tpc=tpc, tog=tog)


def _eq(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_onegap_enumeration_equals_jax(world):
    w = world
    _eq(w["tenum"], w["jenum"])
    _eq(w["tsearch"], w["jsearch"])
    assert len(w["tsearch"].qrystart) > 0


def test_empty_onegap_enumeration_equals_oracle(world):
    """No token matches: the enumeration is empty, and the distinct table
    equals the sequential oracle's, with no import of the oracle."""
    w = world
    p1 = dataclasses.replace(
        w["tp1"], longestmatch=np.zeros_like(w["tp1"].longestmatch))
    enum = tef.fast_one_gap_enumeration(w["tqs"], p1, w["tcfg"])
    assert len(enum.qrystart) == 0
    got_enum, got = tef.fast_sort_and_dedup_onegap(enum, w["tqs"])
    want_enum, want = ose.sort_and_dedup_onegap(
        jef.fast_one_gap_enumeration(w["jqs"], p1, w["jcfg"]), w["jqs"])
    _eq(got_enum, want_enum)
    _eq(got, want)


def test_plain_a7_equals_onegap_batch(world):
    """Every (unsampled) aXb occurrence of lookup1's result, plus random
    lanes that run into corpus and sentence edges."""
    w = world
    s, og, pc = w["tsearch"], w["tog"], w["tpc"]
    ids, css, fes = tdev._onegap_occurrences(s, og, pc, 0, False)
    sls = s.qrystart_len[ids].astype(np.int64)
    els = s.qryend_len[ids].astype(np.int64)
    rng = np.random.default_rng(6)
    extra = 300
    reflen = w["tidx"].reflen
    r_sl = rng.integers(1, 4, extra)
    r_el = rng.integers(1, 4, extra)
    r_fe = r_sl + r_el + rng.integers(0, 10, extra)
    r_cs = np.concatenate([rng.integers(0, 4, 20),
                           rng.integers(reflen - 20, reflen, 20),
                           rng.integers(0, reflen, extra - 40)])
    cols = [np.concatenate([x, y]).astype(np.int32)
            for x, y in ((css, r_cs), (fes, r_fe), (sls, r_sl), (els, r_el))]
    cfg = w["jcfg"]
    ix = w["jidx"]
    want = jdev._onegap_batch(ix.refstr_padded, ix.rlp, ix.lr_tar,
                              *(jnp.asarray(c) for c in cols), ix.offs0,
                              cfg.max_rule_span, cfg.max_rule_symbols)
    t = w["tidx"]
    got = tdev.onegap(t.refstr_padded, t.rlp, t.lr_tar,
                      *(torch.from_numpy(c) for c in cols),
                      cfg.max_rule_span, cfg.max_rule_symbols)
    assert got.shape == (6, len(cols[0])) and got.dtype == torch.int32
    for col, wcol in enumerate(want):
        np.testing.assert_array_equal(got[col].numpy(), np.asarray(wcol),
                                      err_msg=f"column {col}")
    for col in (1, 3, 5):                         # every family emits
        assert (got[col].numpy() & 1).any(), col


@pytest.mark.parametrize("sample", [True, False])
def test_extract_onegap_equals_jax(world, sample):
    w = world
    jcfg = dataclasses.replace(w["jcfg"], is_sample=sample)
    tcfg = dataclasses.replace(w["tcfg"], is_sample=sample)
    want = jdev.extract_onegap_tpu(w["jidx"], w["jsearch"], w["jog"],
                                   w["jpc"], jcfg)
    got = tdev.extract_onegap(_engine(w), w["tsearch"], w["tog"], w["tpc"],
                              tcfg)
    for g, j in zip(got, want):
        _eq(g, j)
    assert len(got[0].gappy_index) > 0 and len(got[1].gappy_index) > 0


@pytest.mark.parametrize("sample", [True, False])
def test_plain_identity_views_change_nothing(world, sample, monkeypatch):
    """A7's plain version, on the inputs of the one-gap extraction's own
    call (sampled or not), gives the same words when the corpus arrays come
    as explicit identity views (offset 0, global length = local length)."""
    w = world
    calls = []
    real = tdev.onegap

    def hook(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(tdev, "onegap", hook)
    tdev.extract_onegap(_engine(w), w["tsearch"], w["tog"], w["tpc"],
                        dataclasses.replace(w["tcfg"], is_sample=sample))
    (args,) = calls
    want = tdev.onegap_plain(*args)
    got = tdev.onegap_plain(*[OffsetView(a, 0, a.shape[0]) if i < 3 else a
                              for i, a in enumerate(args)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want[1] & 1).any()
