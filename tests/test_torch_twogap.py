"""Two-gap patterns in the port: the enumeration and distinct scan, kernel
A5's plain version against the JAX ``_two_batch_exp``, ``two_gap_lookup``
against ``two_gap_lookup_tpu``, kernel A8's plain version against
``_twogap_batch`` (three span limits) and ``extract_twogap`` against
``extract_twogap_tpu``, bit for bit."""

import copy
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
from cgx_tpu.utils.batching import bucket_size  # noqa: E402
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
    """Both packages run one corpus through the two-gap enumeration, with
    one configuration (the default) on both sides; ``*tg`` is lookup2's
    result and ``*search2`` the table it filled."""
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
    jenum2, jsearch2 = jef.fast_sort_and_dedup_twogap(
        jef.fast_two_gap_enumeration(jqs, jp1, jenum, jsearch, jcfg), jqs)
    jsearch2_0 = copy.deepcopy(jsearch2)
    jtg = jlk.two_gap_lookup_tpu(jidx, jqs, jsearch, jog, jsearch2, jpc, jcfg,
                                 refstr_host=np.asarray(jsrc.str_))

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
    tenum2, tsearch2 = tef.fast_sort_and_dedup_twogap(
        tef.fast_two_gap_enumeration(tqs, tp1, tenum, tsearch, tcfg), tqs)
    tsearch2_0 = copy.deepcopy(tsearch2)
    ttg = tlk.two_gap_lookup(teng, tqs, tsearch, tog, tsearch2, tpc, tcfg,
                             np.asarray(tsrc.str_))
    return dict(jcfg=jcfg, jidx=jidx, jqs=jqs, jp1=jp1, jenum=jenum,
                jsearch=jsearch, jpc=jpc, jog=jog, jenum2=jenum2,
                jsearch2=jsearch2, jsearch2_0=jsearch2_0, jtg=jtg,
                jstr=np.asarray(jsrc.str_),
                tcfg=tcfg, tidx=tidx, tqs=tqs, tenum=tenum, tsearch=tsearch,
                tpc=tpc, tog=tog, tenum2=tenum2, tsearch2=tsearch2,
                tsearch2_0=tsearch2_0, ttg=ttg, tstr=np.asarray(tsrc.str_))


def _eq(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_twogap_enumeration_equals_jax(world):
    w = world
    _eq(w["tenum2"], w["jenum2"])
    _eq(w["tsearch2_0"], w["jsearch2_0"])
    assert len(w["tsearch2_0"].blockid) > 0


def test_empty_twogap_enumeration_equals_oracle(world):
    """No one-gap pattern occurs: the enumeration is empty, and the distinct
    table equals the sequential oracle's, with no import of the oracle."""
    w = world
    s = copy.deepcopy(w["tsearch"])
    s.start_on_salist[:] = -1
    s.end_on_salist[:] = -1
    enum = tef.fast_two_gap_enumeration(w["tqs"], w["jp1"], w["tenum"], s,
                                        w["tcfg"])
    assert len(enum.blockid) == 0
    got_enum, got = tef.fast_sort_and_dedup_twogap(enum, w["tqs"])
    want_enum, want = ose.sort_and_dedup_twogap(
        jef.fast_two_gap_enumeration(w["jqs"], w["jp1"], w["jenum"], s,
                                     w["jcfg"]), w["jqs"])
    _eq(got_enum, want_enum)
    _eq(got, want)


def _bucket_rows(start, length):
    """(start, len) rows padded with zero rows to the JAX engine's bucket."""
    rows = np.zeros((bucket_size(max(len(start), 1)), 2), np.int32)
    rows[:len(start), 0] = start
    rows[:len(length), 1] = length
    return rows


@pytest.mark.parametrize("mrs", [15, 8, 2])
def test_plain_a5_equals_two_batch_exp(world, mrs):
    """lookup2's own layout (every distinct one-gap pattern, precomputed
    cells expanded), random patterns over both row tables and patterns over
    occurrences that end at the corpus end (the logical and the padded
    one), compared on the first N words, under the default span limit and
    narrower ones."""
    w = world
    cfg = w["jcfg"]
    og, pc = w["tog"], w["tpc"]
    lo, counts, pcmode = tlk.two_gap_items(w["tsearch"], og, pc)
    assert pcmode[counts > 0].any() and (~pcmode[counts > 0]).any()
    rng = np.random.default_rng(8)
    extra = 200
    r_pcm = rng.random(extra) < 0.5
    r_lo = np.where(r_pcm, rng.integers(0, max(pc.count, 1), extra),
                    rng.integers(0, max(len(og.length), 1), extra))
    r_cnt = rng.integers(0, 4, extra)
    r_cnt = np.minimum(r_cnt, np.where(r_pcm, pc.count, len(og.length)) - r_lo)
    # one-gap rows ending at the corpus end: each alone, then all six
    t = w["tidx"]
    tail_len = np.array([1, 2, 3, 1, 2, 3])
    tail_start = np.concatenate([t.reflen - tail_len[:3],
                                 t.refstr_padded.shape[0] - tail_len[3:]])
    n_og = len(og.length)
    t_lo = n_og + np.array([0, 1, 2, 3, 4, 5, 0])
    t_cnt = np.array([1, 1, 1, 1, 1, 1, 6])
    lo = np.concatenate([lo, r_lo, t_lo])
    counts = np.concatenate([counts, r_cnt, t_cnt]).astype(np.int64)
    pcmode = np.concatenate([pcmode, r_pcm, np.zeros(len(t_lo), bool)])
    D = len(lo)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    N = int(offs[-1])
    pattab = np.stack([lo, pcmode], axis=1).astype(np.int32)
    ogrows = _bucket_rows(np.concatenate([og.str_position, tail_start]),
                          np.concatenate([og.length, tail_len]))
    pcrows = _bucket_rows(pc.onegap_start, pc.onegap_length)
    tab = np.zeros((bucket_size(D), 2), np.int32)
    tab[:D] = pattab
    offs_pad = np.full(len(tab) + 1, offs[-1], np.int64)
    offs_pad[:D + 1] = offs
    pat0 = max(int(np.searchsorted(offs, 0, side="right")) - 1, 0)
    ix = w["jidx"]
    (want,) = jlk._two_batch_exp(
        ix.refstr_padded, ix.rlp, ix.lr_tar, jnp.asarray(ogrows),
        jnp.asarray(pcrows), jnp.asarray(tab),
        jnp.asarray(offs_pad.astype(np.int32)), jnp.int32(0),
        jnp.int32(pat0), jnp.int32(D), ix.offs0, mrs, cfg.min_gap_size,
        bucket_size(N), do_gap=True)
    got = tlk.two(t.refstr_padded, t.rlp, t.lr_tar, torch.from_numpy(ogrows),
                  torch.from_numpy(pcrows), torch.from_numpy(pattab),
                  torch.from_numpy(offs.astype(np.int32)), N, mrs,
                  cfg.min_gap_size)
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(want, np.uint32)[:N].view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    # gc always; cand only where a core of >= 1 token, the gap and a move
    # fit in the span limit
    assert (want >> 16).any()
    assert (want & 0xFFFF).any() == (mrs > 2)


def test_two_gap_lookup_equals_jax(world):
    """All GapOnSA fields and the per-pattern row ranges."""
    w = world
    got, want = w["ttg"], w["jtg"]
    for f in ("position", "str_position", "length", "length2"):
        assert getattr(got, f).dtype == np.int32, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(w["tsearch2"].start_on_salist,
                                  w["jsearch2"].start_on_salist)
    np.testing.assert_array_equal(w["tsearch2"].end_on_salist,
                                  w["jsearch2"].end_on_salist)
    assert len(got.position) > 0


@pytest.mark.parametrize("mrs", [15, 8, 2])
def test_plain_a8_equals_twogap_batch(world, mrs):
    """Every (unsampled) aXbXc occurrence of lookup2's result, plus random
    lanes that run into corpus and sentence edges, at the default span
    limit (15) and two narrower ones."""
    w = world
    s1, s2, tg = w["tsearch"], w["tsearch2"], w["ttg"]
    one = s2.blockid[tg.position].astype(np.int64)
    cols = [tg.str_position, tg.length, tg.length2, s1.qrystart_len[one],
            s1.qryend_len[one], s2.qryend_len[tg.position]]
    rng = np.random.default_rng(9)
    extra = 300
    reflen = w["tidx"].reflen
    r_sl = rng.integers(1, 4, extra)
    r_el = rng.integers(1, 4, extra)
    r_cl = np.ones(extra, np.int64)
    r_fe = r_sl + r_el + rng.integers(0, 5, extra)
    r_se = r_fe + 1 + r_cl + rng.integers(0, 5, extra)
    r_cs = np.concatenate([rng.integers(0, 4, 20),
                           rng.integers(reflen - 20, reflen, 20),
                           rng.integers(0, reflen, extra - 40)])
    cols = [np.concatenate([x, y]).astype(np.int32) for x, y in zip(
        cols, (r_cs, r_fe, r_se, r_sl, r_el, r_cl))]
    cfg = w["jcfg"]
    ix = w["jidx"]
    assert cfg.max_rule_span == 15
    want = jdev._twogap_batch(ix.refstr_padded, ix.rlp, ix.lr_tar,
                              *(jnp.asarray(c) for c in cols), ix.offs0, mrs)
    t = w["tidx"]
    got = tdev.twogap(t.refstr_padded, t.rlp, t.lr_tar,
                      *(torch.from_numpy(c) for c in cols), mrs)
    assert got.shape == (2, len(cols[0])) and got.dtype == torch.int32
    for col, wcol in enumerate(want):
        np.testing.assert_array_equal(got[col].numpy(), np.asarray(wcol),
                                      err_msg=f"column {col}")
    assert not (got[1].numpy() & 1).all()
    if mrs > 2:
        assert (got[1].numpy() & 1).any()


@pytest.mark.parametrize("sample", [True, False])
def test_extract_twogap_equals_jax(world, sample):
    w = world
    jcfg = dataclasses.replace(w["jcfg"], is_sample=sample)
    tcfg = dataclasses.replace(w["tcfg"], is_sample=sample)
    want = jdev.extract_twogap_tpu(w["jidx"], w["jsearch"], w["jsearch2"],
                                   w["jtg"], jcfg)
    got = tdev.extract_twogap(_engine(w), w["tsearch"], w["tsearch2"],
                              w["ttg"], tcfg)
    _eq(got, want)
    assert len(got.gappy_index) > 0


@pytest.mark.parametrize("kernel", ["A5", "A8"])
def test_plain_identity_views_change_nothing(world, kernel, monkeypatch):
    """The plain versions of A5 and A8, on the inputs of lookup2's and the
    two-gap extraction's own calls, give the same words when the corpus
    arrays come as explicit identity views (offset 0, global length = local
    length)."""
    w = world
    calls = {}
    site = (tlk, "two") if kernel == "A5" else (tdev, "twogap")
    real = getattr(*site)

    def hook(*args):
        calls[kernel] = args
        return real(*args)
    monkeypatch.setattr(*site, hook)
    if kernel == "A5":
        tlk.two_gap_lookup(_engine(w), w["tqs"], w["tsearch"], w["tog"],
                           copy.deepcopy(w["tsearch2_0"]), w["tpc"],
                           w["tcfg"], w["tstr"])
        plain = tlk.two_plain
    else:
        tdev.extract_twogap(_engine(w), w["tsearch"], w["tsearch2"],
                            w["ttg"], w["tcfg"])
        plain = tdev.twogap_plain
    args = calls[kernel]
    want = plain(*args)
    got = plain(*[OffsetView(a, 0, a.shape[0]) if i < 3 else a
                  for i, a in enumerate(args)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != 0).any()
