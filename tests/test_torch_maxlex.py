"""MaxLex in the port: kernels A9/A10's plain versions against the JAX
``_accum_batch_dense`` / ``_accum_batch_range`` on random tables (probability
1.0, i.e. the -0.0 case, missing pairs, NULL rows, duplicate pairs), and
``compute_maxlex`` against the JAX package's host loop.  float32 results are
compared by bit pattern."""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.features import maxlex as jml  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.types import (GapOnSA, OneGapEnum,  # noqa: E402
                                 OneGapSearch, Precomp, TwoGapEnum,
                                 TwoGapSearch)
from cgx_tpu_torch.extract.blocks import generate_blocks  # noqa: E402
from cgx_tpu_torch.features import lexicon as tlx  # noqa: E402
from cgx_tpu_torch.features import maxlex as tml  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402

S, TV = 40, 50   # source / target vocabulary ids


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _random_lex(rng, n=600):
    src = rng.integers(-1, S, n)
    tgt = rng.integers(-1, TV, n)
    src[:5] = -1                                     # NULL source rows
    tgt[5:10] = -1                                   # NULL target rows
    src[10:14], tgt[10:14] = src[20], tgt[20]        # duplicate pairs
    probs = np.array([1.0, 0.5, 0.25, 0.05, 1e-6, 0.0], np.float32)
    v1 = rng.choice(probs, n).astype(np.float32)
    v2 = rng.choice(probs, n).astype(np.float32)
    order = np.lexsort((tgt, src))
    return types.SimpleNamespace(
        lex_key=jic.pack_lex_key(src[order], tgt[order]),
        lex_val1_host=v1[order], lex_val2_host=v2[order])


def _random_tasks(rng, T=500, n_tgt=300):
    nsrc = rng.integers(1, 6, T)
    sp = rng.integers(-1, S + 3, (T, 5)).astype(np.int32)   # some unknown ids
    sp[np.arange(5)[None, :] >= nsrc[:, None]] = -99
    t0 = rng.integers(0, n_tgt + 4, T).astype(np.int32)      # reads past the end
    tend = rng.integers(0, 15, T).astype(np.int32)

    def gap():
        gs = np.where(rng.random(T) < 0.4, -1, rng.integers(0, 8, T))
        ge = np.where(gs < 0, -1, gs + rng.integers(0, 4, T))
        return gs.astype(np.int32), ge.astype(np.int32)
    g1, g11 = gap()
    g2, g21 = gap()
    tgt_str = rng.integers(-1, TV + 3, n_tgt).astype(np.int32)
    return tgt_str, (sp, t0, tend, g1, g11, g2, g21)


@pytest.mark.parametrize("mode", ["dense", "range"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_a9_a10_equal_jax(mode, seed, monkeypatch):
    if mode == "range":    # the JAX size rule picks row ranges below the limit
        monkeypatch.setattr(jml, "DEV_DENSE_LIMIT", 0)
        monkeypatch.setattr(tml, "DEV_DENSE_LIMIT", 0)
    rng = np.random.default_rng(seed)
    lex = _random_lex(rng)
    tgt_str, cols = _random_tasks(rng)
    jmode, jtabs = jml._device_lex_tables(copy.copy(lex))
    tix = types.SimpleNamespace(**vars(lex), device=torch.device("cpu"),
                                maxlex_tables=None)
    tmode, ttabs = tml.lex_tables(tix)
    assert jmode == tmode == mode
    jcols = [jnp.asarray(c) for c in cols]
    tcols = [torch.from_numpy(c) for c in cols]
    tt = torch.from_numpy(tgt_str)
    if mode == "dense":
        for jt, t in zip(jtabs, ttabs):
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(jt))
        want = jml._accum_batch_dense(*jtabs, jnp.asarray(tgt_str),
                                      jnp.float32(99.0), *jcols)
        got = tml.accum_dense(*ttabs, tt, 99.0, *tcols)
    else:
        *jarr, steps = jtabs
        *tarr, tsteps = ttabs
        assert steps == tsteps
        for jt, t in zip(jarr, tarr):
            np.testing.assert_array_equal(
                t.numpy().view(np.int32), np.asarray(jt).view(np.int32))
        want = jml._accum_batch_range(*jarr, jnp.asarray(tgt_str),
                                      jnp.float32(99.0), *jcols, steps=steps)
        got = tml.accum_range(*tarr, tt, 99.0, *tcols, tsteps)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    # the -0.0 canonicalisation leaves no negative zero in any feature, and
    # the probes found table entries (features that are not all maxscore)
    egf = got[1].numpy()
    assert not np.signbit(got[0].numpy()).any()
    assert ((egf > 0) & (egf % np.float32(99.0) != 0)).any()


def _no_gappy_structures():
    """The gappy search structures of a query set with no gappy patterns:
    (search1, enum1, onegap_sa, pc, search2, enum2)."""
    z = np.empty(0, np.int32)
    search1 = OneGapSearch(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                           position=z, start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum1 = OneGapEnum(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                       pattern=np.empty((0, 5), np.int32), number=z)
    pc = Precomp(frequent_list=z, tok_start=z, tok_len=z, index_start=z,
                 index_end=z, onegap_start=z, onegap_length=z,
                 feature_missing=z)
    search2 = TwoGapSearch(blockid=z, position=z, qryend_len=z, gap2=z,
                           start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum2 = TwoGapEnum(blockid=z, gap2=z, qryend_len=z,
                       pattern=np.empty((0, 1), np.int32), number=z)
    return (search1, enum1, GapOnSA(z, z, z, z), pc, search2, enum2)


def _toy_tasks(toy_fixture):
    """The three lexicon families' MaxLex tasks on the toy corpus (contiguous
    extraction in the port, on the CPU)."""
    rd = tcp.read_lines
    d = toy_fixture
    f, e, a = rd(str(d / "corpus.f")), rd(str(d / "corpus.e")), rd(str(d / "corpus.a"))
    lex_t, q = tcp.read_tokens(str(d / "lex.txt")), rd(str(d / "query.f"))
    cfg = ExtractorConfig()
    src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    sa = tsab.build_index(src.str_)
    tidx = tic.build_index(src, tgt, sa, tcp.load_alignment_fast(a, src, tgt),
                           tcp.load_lex_table(lex_t, src.vocab, tgt.vocab),
                           cfg, "cpu")
    qs = tcp.load_queries(q, src.vocab)
    blocks = generate_blocks(sa, qs, *tpasses.refine_passes(tidx, qs))
    contig, r1, r2 = tdev.extract_contiguous(ReplicatedEngine(tidx, cfg),
                                             blocks, cfg)
    s1, e1, og, pc, s2, e2 = _no_gappy_structures()
    one = tlx.fast_create_lexicon_onegap(r1, src, tgt, blocks, s1, e1, og, pc,
                                         len(r1.gappy_index), cfg)
    two = tlx.fast_create_lexicon_twogap(r2, src, tgt, blocks, s1, e1, s2, e2,
                                         og, pc, len(r2.gappy_index),
                                         len(r2.gappy_index), cfg)
    con = tlx.fast_create_lexicon_contig(contig, src, tgt, blocks, cfg)
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jidx = jic.build_index(jsrc, jtgt, jsab.build_index(jsrc.str_),
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           JaxConfig())
    return tidx, jidx, one, two, con


@pytest.mark.parametrize("limit", [None, 0])
def test_compute_maxlex_equals_jax_host_loop(toy_fixture, monkeypatch, limit):
    """Dense tables (A9) and, with the size limit forced to 0, row-range
    tables (A10) -- both bit-equal to the JAX package's host backend."""
    if limit is not None:
        monkeypatch.setattr(tml, "DEV_DENSE_LIMIT", limit)
    tidx, jidx, one, two, con = _toy_tasks(toy_fixture)
    tasks = {"onegap": one[1], "twogap": two[1], "contig": con[1]}
    rules_t = [copy.deepcopy(x[0]) for x in (one, two, con)]
    rules_j = [copy.deepcopy(x[0]) for x in (one, two, con)]
    tml.compute_maxlex(tasks, tidx, *rules_t, ExtractorConfig())
    jml.compute_maxlex_tpu(tasks, jidx, *rules_j, JaxConfig(), use_device=False)
    assert tidx.maxlex_tables[0] == ("dense" if limit is None else "range")
    for rt, rj in zip(rules_t, rules_j):
        assert len(rt) > 0
        np.testing.assert_array_equal(_bits(rt.max_lex_fge), _bits(rj.max_lex_fge))
        np.testing.assert_array_equal(_bits(rt.max_lex_egf), _bits(rj.max_lex_egf))


def _edge_lex():
    """A row-range table with a largest source (3: every target once and two
    duplicate rows, so its range is the longest), duplicate (5, 7) rows of
    differing values (the first row wins), NULL source and target rows, and
    sources with no row (9, and every id past the largest)."""
    probs = [1.0, 0.5, 0.25, 0.05, 1e-6, 0.0]
    rows = [(3, t, probs[t % 6]) for t in range(-1, TV)]
    rows += [(3, 4, 0.125), (3, 11, 0.75)]
    rows += [(5, 7, 0.25), (5, 7, 1.0), (5, 7, 0.5), (5, 2, 0.5)]
    rows += [(-1, t, p) for t, p in zip([-1, 0, 2, 7, 11, 30],
                                        [0.5, 1.0, 0.05] * 2)]
    rows += [(1, -1, 0.25), (1, 2, 0.5), (12, 7, 1.0), (12, 40, 0.0)]
    src, tgt, v = (list(c) for c in zip(*rows))
    src, tgt = np.array(src), np.array(tgt)
    v1 = np.array(v, np.float32)
    v2 = np.roll(v1, 3)
    order = np.lexsort((tgt, src))        # stable: duplicates keep their order
    return types.SimpleNamespace(
        lex_key=jic.pack_lex_key(src[order], tgt[order]),
        lex_val1_host=v1[order], lex_val2_host=v2[order])


def _edge_rules(case, rng, T=64):
    """The rule columns of one edge case (sp, t0, tend, g1, g11, g2, g21)
    over ``_EDGE_TGT``."""
    sp = np.full((T, 5), -99, np.int32)
    t0 = rng.integers(0, len(_EDGE_TGT) - 4, T)
    tend = rng.integers(0, 16, T)
    no_gap = np.full(T, -1)
    g1, g11, g2, g21 = no_gap, no_gap, no_gap, no_gap
    if case == "sources":         # nsrc 0 and 5, the NULL source, no rows
        pool = np.array([-1, 1, 3, 5, 9, 12, 40, 41])
        nsrc = np.where(np.arange(T) % 2 == 0, 0, 5)
        for r in range(T):
            sp[r, :nsrc[r]] = rng.choice(pool, nsrc[r])
        sp[1] = [-1, -1, 3, 40, 5]
    elif case == "tmask":         # every position kept, then none
        sp[:, :3] = rng.choice([-1, 1, 3, 5, 12], (T, 3))
        half = np.arange(T) < T // 2
        tend = np.where(half, 15, rng.integers(0, 16, T))
        g1 = np.where(half, -1, 0)                      # one gap over all
        g11 = np.where(half, -1, 15)
        g2, g21 = np.where(half, -1, 3), np.where(half, -1, 5)
    elif case == "absent_dup":    # targets the rows lack, the (5, 7) rows
        sp[:, 0] = 5
        sp[:, 1] = rng.choice([1, 12, 9], T)
        t0 = np.where(np.arange(T) % 2 == 0, 0, len(_EDGE_TGT) - 3)
    elif case == "max_rows":      # the largest source's whole range
        sp[:, 0] = 3
        sp[:, 1] = rng.choice([3, -1, 5], T)
    return tuple(np.ascontiguousarray(c, np.int32)
                 for c in (sp, t0, tend, g1, g11, g2, g21))


# targets 7 (the duplicate rows) first, then ids the rows lack, the NULL
# target -1 and ids past every row
_EDGE_TGT = np.array([7, 2, 49, 0, 11, 30, -1, 4, 7, 13, 45, 52, 60, 7, 2,
                      11, 23, 37, 41, 1, 3, 5, 7], np.int32)


_EDGE_CASES = ["sources", "tmask", "absent_dup", "max_rows"]


@pytest.mark.parametrize("mode,case", [
    pytest.param("range", c, id=c) for c in _EDGE_CASES] + [
    pytest.param("dense", c, id=f"dense-{c}") for c in _EDGE_CASES])
def test_plain_a10_edge_rules_equal_jax(mode, case, monkeypatch):
    """A10's plain version against the JAX ``_accum_batch_range`` (and, for
    ``mode`` dense, A9's against ``_accum_batch_dense``) on edge rules: nsrc
    0 and 5 with the NULL source, every target position kept and none,
    targets absent from a row and duplicate (src, tgt) rows, and a range of
    exactly ``max_rows`` rows with ``steps = bit_length(max_rows)`` (dense:
    the same source's whole row); float32 compared by bit pattern."""
    if mode == "range":
        monkeypatch.setattr(jml, "DEV_DENSE_LIMIT", 0)
        monkeypatch.setattr(tml, "DEV_DENSE_LIMIT", 0)
    lex = _edge_lex()
    jmode, jtabs = jml._device_lex_tables(copy.copy(lex))
    tix = types.SimpleNamespace(**vars(lex), device=torch.device("cpu"),
                                maxlex_tables=None)
    tmode, ttabs = tml.lex_tables(tix)
    assert jmode == tmode == mode
    cols = _edge_rules(case, np.random.default_rng(len(case)))
    jcols = [jnp.asarray(c) for c in cols]
    tcols = [torch.from_numpy(c) for c in cols]
    if mode == "dense":
        want = jml._accum_batch_dense(*jtabs, jnp.asarray(_EDGE_TGT),
                                      jnp.float32(99.0), *jcols)
        got = tml.accum_dense(*ttabs, torch.from_numpy(_EDGE_TGT), 99.0,
                              *tcols)
    else:
        *jarr, steps = jtabs
        rs, re, lt, lnv1, lnv2, tsteps = ttabs
        assert steps == tsteps
        rows = (re - rs).numpy()
        assert rows.max() == rows[4] == TV + 3
        assert steps == (TV + 3).bit_length()
        want = jml._accum_batch_range(*jarr, jnp.asarray(_EDGE_TGT),
                                      jnp.float32(99.0), *jcols, steps=steps)
        got = tml.accum_range(rs, re, lt, lnv1, lnv2,
                              torch.from_numpy(_EDGE_TGT), 99.0, *tcols,
                              steps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    fge, egf = (g.numpy() for g in got)
    if case == "sources":
        assert (fge[::2] == 0).all() and (fge[1::2] > 0).all()
    elif case == "tmask":
        assert (egf[32:] == 0).all() and (egf[:32] > 0).all()
    elif case == "absent_dup" and mode == "range":
        # the first (5, 7) row's P(t|s) wins over the later duplicates
        first = int(rs[6]) + int((lt[rs[6]:re[6]] == 7).int().argmax())
        assert int(lt[first]) == int(lt[first + 1]) == 7
        got7 = tml._range_lookup(lt, lnv2, rs[6], re[6], torch.tensor(7),
                                 steps)
        assert _bits(got7.numpy()) == _bits(lnv2[first].numpy())
        assert float(lnv2[first]) != float(lnv2[first + 1])
    elif case == "absent_dup":
        # the dense cell (5, 7) holds the first duplicate row's value
        src = (lex.lex_key >> 32).astype(np.int64)
        tgt = ((lex.lex_key & 0xFFFFFFFF) - 2**31).astype(np.int64)
        first = int(np.flatnonzero((src == 5) & (tgt == 7))[0])
        assert _bits(ttabs[1][6, 8].numpy()) == _bits(
            tml._neglog(lex.lex_val2_host[first:first + 1]))[0]
    # some probes found a table entry in every case but the empty rules
    assert ((egf > 0) & (egf % np.float32(99.0) != 0)).any()


@pytest.mark.parametrize("fixture", ["toy", "real"])
def test_dense_tables_hold_no_nan_or_negative_zero(fixture, request):
    """The premise that lets kernels A9 and A10 take their minimums in any
    order: ``lex_tables``' dense neg-log tables (the fixture's own lexicon)
    hold no NaN and no -0.0, only non-negative values and +inf, so two
    entries that compare equal are the same bits."""
    d = request.getfixturevalue(f"{fixture}_fixture")
    f, e, a = (tcp.read_lines(str(d / n))
               for n in ("corpus.f", "corpus.e", "corpus.a"))
    src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    idx = tic.build_index(src, tgt, tsab.build_index(src.str_),
                          tcp.load_alignment_fast(a, src, tgt),
                          tcp.load_lex_table(tcp.read_tokens(
                              str(d / "lex.txt")), src.vocab, tgt.vocab),
                          ExtractorConfig(), "cpu")
    mode, tables = tml.lex_tables(idx)
    assert mode == "dense"
    for t in tables:
        v = t.numpy()
        assert not np.isnan(v).any()
        assert not (np.signbit(v) & (v == 0)).any()
        assert (v >= 0).all()
        assert np.isinf(v).any() and np.isfinite(v).any()
