"""Two-gap patterns in the port: the enumeration and distinct scan, kernel
A5's plain version against the JAX ``_two_batch_exp``, ``two_gap_lookup``
against ``two_gap_lookup_tpu``, kernel A8's plain version against
``_twogap_batch`` (three span limits) and ``extract_twogap`` against
``extract_twogap_tpu``, bit for bit.  lookup2's device route (kernel A5m's
plain version) against its host route (A5 and the host match) on random
two-gap tables, on empty inputs, under split write passes, the stable
sort by two-gap id against the four-column order, and the engines that
keep the host route."""

import copy
import dataclasses
import pathlib
import sys
import types

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
from cgx_tpu_torch.engine import ReplicatedEngine, two_gap_occurrences  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.kernels import build as kb  # noqa: E402
from cgx_tpu_torch.parallel import sharded as tshx  # noqa: E402
from cgx_tpu_torch.parallel.localdp import LocalDPEngine  # noqa: E402
from cgx_tpu_torch.parallel.sharded import ShardedEngine  # noqa: E402
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


class _HostRouteEngine(ReplicatedEngine):
    """The replicated engine with lookup2's match on the host (A5's
    ``two_expanded``, then ``_two_gap_rows``): the route of every engine
    but ``ReplicatedEngine`` without ``scan_cols``."""
    two_rows_on_device = False


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
    tal = tcp.load_alignment_fast(a, tsrc, ttgt)
    tidx = tic.build_index(tsrc, ttgt, tsa, tal,
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
                tsearch2_0=tsearch2_0, ttg=ttg, tstr=np.asarray(tsrc.str_),
                tsrc=tsrc, ttgt=ttgt, tsa=tsa, tal=tal)


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


@pytest.mark.parametrize("kernel", ["A5", "A5m", "A8"])
def test_plain_identity_views_change_nothing(world, kernel, monkeypatch):
    """The plain versions of A5, A5m and A8, on the inputs of lookup2's
    (A5 on the host route, A5m on the replicated engine's) and the two-gap
    extraction's own calls, give the same words when the corpus arrays
    come as explicit identity views (offset 0, global length = local
    length)."""
    w = world
    calls = {}
    site = {"A5": (tlk, "two"), "A5m": (tlk, "two_rows"),
            "A8": (tdev, "twogap")}[kernel]
    real = getattr(*site)

    def hook(*args):
        calls[kernel] = args
        return real(*args)
    monkeypatch.setattr(*site, hook)
    if kernel in ("A5", "A5m"):
        eng = (_HostRouteEngine if kernel == "A5" else ReplicatedEngine)(
            w["tidx"], w["tcfg"])
        tlk.two_gap_lookup(eng, w["tqs"], w["tsearch"], w["tog"],
                           copy.deepcopy(w["tsearch2_0"]), w["tpc"],
                           w["tcfg"], w["tstr"])
        plain = tlk.two_plain if kernel == "A5" else tlk.two_rows_plain
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


# ---------------------------------------------------------------------------
# lookup2's match on the device (kernel A5m) against the host route
# ---------------------------------------------------------------------------

def _hits(w, cfg):
    """Every (item, move) that A5 keeps (a candidate that passes the gap
    check) over lookup2's items at ``cfg``'s span limit -> the items'
    patterns and the moves' c tokens."""
    og, pc = w["tog"], w["tpc"]
    lo, counts, pcmode = tlk.two_gap_items(w["tsearch"], og, pc)
    cand, gc = _HostRouteEngine(w["tidx"], cfg).two_expanded(og, pc, lo,
                                                             counts, pcmode)
    ii, mm = tlk._mask_hits(cand & gc)
    pat = tlk.expand_hits(ii, counts)[0]
    css, fes = two_gap_occurrences(og, pc, lo, counts, pcmode)
    pos = css[ii] + fes[ii] + 1 + cfg.min_gap_size + mm
    return pat, w["tstr"][np.minimum(pos, len(w["tstr"]) - 1)], len(lo)


def _random_table(w, cfg, seed, shares=(0.3, 0.3, 0.4)):
    """A random two-gap table over the world's one-gap patterns (a query
    whose tokens are the c tokens, and a ``TwoGapSearch`` over it, sorted
    by one-gap pattern as the enumeration sorts it): each pattern has no
    extension, one or many (up to 12) with the shares given, their c
    tokens drawn from the moves A5 keeps for it and from the vocabulary,
    so that some match no occurrence."""
    rng = np.random.default_rng(seed)
    pat, ctok, D = _hits(w, cfg)
    vocab = int(w["tstr"].max()) + 1
    blockid, toks = [], []
    for p in range(D):
        k = rng.choice([0, 1, int(rng.integers(2, 13))], p=shares)
        seen = np.unique(ctok[pat == p])
        pool = np.unique(np.concatenate([
            rng.choice(seen, min(len(seen), k)) if len(seen) else [],
            rng.integers(2, vocab + 50, k)]).astype(np.int64))
        pick = rng.permutation(pool)[:k]
        blockid += [p] * len(pick)
        toks += list(pick)
    D2 = len(blockid)
    search2 = types.SimpleNamespace(
        blockid=np.asarray(blockid, np.int32),
        gap2=np.arange(D2, dtype=np.int32),
        start_on_salist=np.full(D2, -1, np.int32),
        end_on_salist=np.full(D2, -1, np.int32))
    return types.SimpleNamespace(tokens=np.asarray(toks, np.int32)), search2


def _lookup2(w, eng, queries, search2, cfg):
    return tlk.two_gap_lookup(eng, queries, w["tsearch"], w["tog"], search2,
                              w["tpc"], cfg, w["tstr"])


def _same_lookup(got, want, s2_got, s2_want):
    for f in ("position", "str_position", "length", "length2"):
        assert getattr(got, f).dtype == np.int32, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(s2_got.start_on_salist,
                                  s2_want.start_on_salist)
    np.testing.assert_array_equal(s2_got.end_on_salist,
                                  s2_want.end_on_salist)


@pytest.mark.parametrize("mrs", [15, 10, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_a5m_route_equals_the_host_route(world, mrs, seed):
    """On random two-gap tables (patterns with no, one and many
    extensions, c tokens that match no occurrence), at the default span
    limit and narrower ones that cut moves: the replicated engine's device
    route (A5m's plain version on the CPU) gives the host route's GapOnSA
    and row ranges; pcmode patterns and patterns with one and with many
    extensions all keep rows."""
    w = world
    cfg = dataclasses.replace(
        w["tcfg"], max_rule_span=mrs,
        max_rule_span_pattern=min(w["tcfg"].max_rule_span_pattern, mrs))
    queries, s2 = _random_table(w, cfg, seed)
    s2_host = copy.deepcopy(s2)
    before = kb.COUNTS["lookup2.device_items"]
    got = _lookup2(w, ReplicatedEngine(w["tidx"], cfg), queries, s2, cfg)
    assert kb.COUNTS["lookup2.device_items"] > before
    want = _lookup2(w, _HostRouteEngine(w["tidx"], cfg), queries, s2_host,
                    cfg)
    _same_lookup(got, want, s2, s2_host)
    assert len(got.position)
    if mrs < 15:
        return
    lo, counts, pcmode = tlk.two_gap_items(w["tsearch"], w["tog"], w["tpc"])
    one = s2.blockid[got.position]
    ext = np.bincount(s2.blockid, minlength=len(lo))[one]
    assert pcmode[one].any() and (~pcmode[one]).any()
    assert (ext == 1).any() and (ext > 1).any()


@pytest.mark.parametrize("case", ["no_twogap", "no_onegap_rows",
                                  "no_match"])
def test_a5m_route_on_empty_inputs(world, case):
    """No two-gap pattern, no one-gap occurrence to scan, and c tokens
    that match no occurrence: both routes give the same empty GapOnSA."""
    w = world
    cfg = w["tcfg"]
    queries, s2 = _random_table(w, cfg, 2)
    search1 = w["tsearch"]
    if case == "no_twogap":
        s2 = types.SimpleNamespace(**{k: v[:0] for k, v in
                                      vars(s2).items()})
    elif case == "no_onegap_rows":
        search1 = copy.deepcopy(search1)
        search1.start_on_salist[:] = -1
        search1.end_on_salist[:] = -1
    else:
        queries = types.SimpleNamespace(
            tokens=np.full_like(queries.tokens, int(w["tstr"].max()) + 7))
    outs = []
    for eng in (ReplicatedEngine, _HostRouteEngine):
        s2c = copy.deepcopy(s2)
        outs.append((tlk.two_gap_lookup(eng(w["tidx"], cfg), queries,
                                        search1, w["tog"], s2c, w["tpc"],
                                        cfg, w["tstr"]), s2c))
    (got, s2_got), (want, s2_want) = outs
    _same_lookup(got, want, s2_got, s2_want)
    assert len(got.position) == 0
    assert (s2_got.start_on_salist == -1).all()


def _a5m_args(w, cfg, queries, search2):
    """A5m's arguments over the world's lookup2 items and a two-gap table,
    built as the replicated engine builds them."""
    args = []
    real = tlk.two_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlk, "two_rows",
                   lambda *a, **kw: args.append(a) or real(*a, **kw))
        _lookup2(w, ReplicatedEngine(w["tidx"], cfg), queries,
                 copy.deepcopy(search2), cfg)
    return args[0]


@pytest.mark.parametrize("table", ["world", "random"])
def test_stable_two_id_sort_is_the_four_column_order(world, table):
    """A5m's rows come in (item, move) order, and a stable sort by two-gap
    id alone orders them as the lexsort by (two_id, start, length,
    length2) does: each one-gap pattern's items are in (start, length)
    order (its lookup1 rows, or its precomputed cell's) and its moves
    ascend.  The enumeration's own table also lists the two-gap ids of
    each one-gap pattern as one run, in the patterns' order."""
    w = world
    cfg, mgs = w["tcfg"], w["tcfg"].min_gap_size
    if table == "world":
        queries, s2 = w["tqs"], w["tsearch2_0"]
        assert (np.diff(s2.blockid.astype(np.int64)) >= 0).all()
    else:
        queries, s2 = _random_table(w, cfg, 3)
    rows = tlk.two_rows_plain(*_a5m_args(w, cfg, queries, s2)).numpy()
    assert len(rows)
    two_id, css = rows[:, 0], rows[:, 1]
    fes, move = rows[:, 2] & 0xFFFF, rows[:, 2] >> 16
    length2 = fes + 1 + mgs + move
    cols = np.stack([two_id, css, fes, length2], axis=1)
    stable = cols[np.argsort(two_id, kind="stable")]
    lex = cols[np.lexsort((length2, fes, css, two_id))]
    np.testing.assert_array_equal(stable, lex)
    # the premise: every pattern's occurrences in (start, length) order
    lo, counts, pcmode = tlk.two_gap_items(w["tsearch"], w["tog"], w["tpc"])
    css_i, fes_i = two_gap_occurrences(w["tog"], w["tpc"], lo, counts,
                                       pcmode)
    pat = np.repeat(np.arange(len(lo)), counts)
    key = np.stack([pat, css_i, fes_i], axis=1)
    order = np.lexsort((fes_i, css_i, pat))
    np.testing.assert_array_equal(key[order], key)


@pytest.mark.parametrize("warps", [1, 4, 16])
def test_a5m_row_budget_splits_the_write_pass(world, warps):
    """A5m's default row budget keeps the write pass's buffer, the warp
    counts and their prefix within A5's word column (4 bytes an item), on
    ragged warps too; at the test-set cells' yield (0.46 rows an item) the
    write pass splits into ranges, at 0.25 it does not.  (The ranges
    themselves are checked on the card, ``chip_smoke.py``'s A5m rows; on
    the CPU the wrapper runs the plain version whatever the budget.)"""
    for n in (32_000 * warps - 31, 32_000 * warps - 5, 32_000 * warps):
        W = -(-n // 32)
        budget = tlk._row_budget(n)
        assert 12 * budget + 4 * W + 8 * (W + 1) <= 4 * n
        assert 12 * (budget + 1) + 4 * W + 8 * (W + 1) > 4 * n
        assert -(-int(0.46 * n) // budget) > 1
        assert -(-int(0.25 * n) // budget) == 1
    assert tlk._row_budget(1) == 1
    w = world
    args = _a5m_args(w, w["tcfg"], *_random_table(w, w["tcfg"], 4))
    whole = tlk.two_rows_plain(*args).numpy()
    assert len(whole) > warps
    np.testing.assert_array_equal(
        tlk.two_rows(*args, row_budget=warps).numpy(), whole)


@pytest.mark.parametrize("which", ["sharded", "localdp", "scan_cols"])
def test_other_engines_keep_the_host_route(world, which):
    """``ShardedEngine``, ``LocalDPEngine`` and ``scan_cols`` declare no
    device match: lookup2 runs ``two_expanded`` and the host match on
    them, never ``two_rows``, counts no device item, and gives the
    replicated engine's GapOnSA and row ranges."""
    w = world
    cfg = w["tcfg"]
    if which == "sharded":
        eng = ShardedEngine(tshx.build_sharded_index(
            w["tsrc"], w["ttgt"], w["tsa"], w["tal"], cfg, 3, "cpu"), cfg)
    elif which == "localdp":
        eng = LocalDPEngine(w["tidx"], w["tsa"].sa, cfg, n_devices=2)
    else:
        eng = ReplicatedEngine(w["tidx"], cfg, scan_cols=True,
                               sa_host=w["tsa"].sa)
    assert not getattr(eng, "two_rows_on_device", False)
    calls = []
    real = eng.two_expanded
    eng.two_expanded = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    eng.two_rows = None          # any call would raise
    s2 = copy.deepcopy(w["tsearch2_0"])
    before = kb.COUNTS["lookup2.device_items"]
    got = tlk.two_gap_lookup(eng, w["tqs"], w["tsearch"], w["tog"], s2,
                             w["tpc"], cfg, w["tstr"])
    assert calls and kb.COUNTS["lookup2.device_items"] == before
    _same_lookup(got, w["ttg"], s2, w["tsearch2"])
