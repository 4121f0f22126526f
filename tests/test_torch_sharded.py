"""The sharded index in the port (``cgx_tpu_torch.parallel.sharded``) against
the JAX package's (``cgx_tpu.parallel.sharded``) on the toy corpus, exactly:
the per-shard arrays, kernel B2's plain versions (refinement, SA gather),
kernel B3's (per-item scans, verification, second-gap scan, contiguous
extraction) and A4, A7, A8 on shard views, the passes, the pipeline and the
CLI with ``sa_shards``, the build that never places a replicated index,
the per-shard memory accounting and the host MaxLex backend, the premise
of kernel B2r's search read through the shards, and B2r's limit on the
shard count.  The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py; the port side on the CPU, that is, on the kernels'
plain versions."""

import copy
import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract import device as jdev  # noqa: E402
from cgx_tpu.features import maxlex as jml  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.parallel import sharded as jshx  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.extract.blocks import generate_blocks  # noqa: E402
from cgx_tpu_torch.features import lexicon as tlx  # noqa: E402
from cgx_tpu_torch.features import maxlex as tml  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.parallel import sharded as tshx  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import lookup as tlk  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402
from cgx_tpu_torch.utils.views import take  # noqa: E402

SHARDS = (3, 8)          # 3: uneven shards; 8: the whole virtual mesh
MRS, MGS, MSYM = 15, 1, 5


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], w["tcfg"])


def _cfgs():
    return JaxConfig(precompute_count=30), ExtractorConfig(precompute_count=30)


@pytest.fixture(scope="module")
def data(toy_fixture):
    d = toy_fixture
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module")
def world(data):
    """Both packages' corpora, the JAX sharded index for each S, and the
    port's replicated index on the CPU."""
    f, e, a, lex, q = data
    jcfg, tcfg = _cfgs()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jal = jcp.load_alignment(a, jsrc, jtgt)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa, jal,
                           jcp.load_lex_table(lex, jsrc.vocab, jtgt.vocab),
                           jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tal = tcp.load_alignment_fast(a, tsrc, ttgt)
    tlex = tcp.load_lex_table(lex, tsrc.vocab, ttgt.vocab)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa, tal, tlex, tcfg, "cpu")
    return dict(
        jcfg=jcfg, tcfg=tcfg, jsrc=jsrc, jsa=jsa, jidx=jidx,
        jqs=jcp.load_queries(q, jsrc.vocab),
        jsidx={S: jshx.build_sharded_index(jsrc, jtgt, jsa, jal, jcfg,
                                           n_devices=S) for S in SHARDS},
        tsrc=tsrc, ttgt=ttgt, tal=tal, tlex=tlex, tsa=tsa, tidx=tidx,
        tqs=tcp.load_queries(q, tsrc.vocab))


def _carried(w, S):
    """The JAX sharded index of S shards carried across to the CPU."""
    j = w["jsidx"][S]
    return tshx.from_jax_sharded(
        {f: (np.asarray(getattr(j, f)) if getattr(j, f) is not None
             else None) for f in tshx.SHARDED_FIELDS}, "cpu")


@pytest.mark.parametrize("S", SHARDS)
def test_build_sharded_index_equals_jax(world, S):
    """Every array and scalar field, word for word."""
    w = world
    j = w["jsidx"][S]
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    for f in ("S", "reflen", "ref_glen", "rlp_glen", "tgt_glen", "B", "BR",
              "BH"):
        assert getattr(t, f) == int(getattr(j, f)), f
    for f in ("sa_l", "ref_l", "lrt_l"):
        got = torch.stack(getattr(t, f)).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(
        torch.stack(t.rlp_l).numpy().view(np.uint32), np.asarray(j.rlp_l))
    for f in ("src_off", "tgt_off", "seed_lo1", "seed_hi1", "seed_pk",
              "seed_pk3"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    np.testing.assert_array_equal(t.rmeta, np.asarray(j.rmeta)[:, 0, :])
    np.testing.assert_array_equal(t.smeta, np.asarray(j.smeta)[:, 0, :])
    assert len(t.sa_l) == S and all(x.device.type == "cpu" for x in t.ref_l)


@pytest.mark.parametrize("S", (1, 3, 4, 8))
def test_rank_token_slices_of_the_replicated_index(world, S):
    """``rank_token_slices`` over the replicated index's SA and padded
    corpus (cut to the sharded index's ``ref_glen``) gives the sharded
    index's rank and token slices and meta rows, as ``chip_smoke.py`` uses
    it to lay out B2r's and B2g's edge inputs on other shard counts."""
    w = world
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    tidx, reflen = w["tidx"], int(w["tidx"].reflen)
    FH = t.ref_l[0].shape[0] - t.B - t.BH
    sl = tshx.rank_token_slices(tidx.refstr_padded[:t.ref_glen].numpy(),
                                tidx.sa[:reflen].numpy(), reflen, S, t.BH,
                                FH)
    assert (sl["B"], sl["BR"]) == (t.B, t.BR)
    for f in ("sa_l", "ref_l"):
        np.testing.assert_array_equal(
            sl[f], torch.stack(getattr(t, f)).numpy(), err_msg=f)
    np.testing.assert_array_equal(sl["src_off"], t.src_off)
    np.testing.assert_array_equal(sl["rmeta"], t.rmeta)
    np.testing.assert_array_equal(sl["smeta"], t.smeta)


def test_shards_on_several_devices_are_refused(world):
    w = world
    with pytest.raises(ValueError, match="ROADMAP queue A item 10b"):
        tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], 2, ["cpu", "meta"])


@pytest.mark.parametrize("S", SHARDS)
def test_plain_b2r_equals_refine_chunk(world, S):
    """B2r's plain version against ``_refine_chunk``, with intervals
    that run off both ends of the SA (unowned ranks read 0)."""
    w = world
    j = w["jsidx"][S]
    t = _carried(w, S)
    reflen = t.reflen
    rng = np.random.default_rng(S)
    n = 120
    qtok = np.asarray(w["jqs"].padded_tokens())
    toks = rng.integers(0, w["jqs"].totaltokens, n).astype(np.int32)
    sls = rng.integers(1, 8, n).astype(np.int32)
    lo = rng.integers(0, reflen, n).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, n), reflen).astype(np.int32)
    lo[:6], hi[:6] = -7, rng.integers(0, 30, 6)          # off the front
    lo[6:12] = reflen - 5
    hi[6:12] = reflen + rng.integers(1, 40, 6)           # off the back
    for d0, depths in ((0, 4), (3, 16)):
        want = jshx._refine_chunk(
            j.sa_l, j.ref_l, j.rmeta, j.smeta, jnp.asarray(qtok),
            jnp.asarray(toks), jnp.asarray(sls), jnp.asarray(lo),
            jnp.asarray(hi), jnp.int32(d0), mesh=j.mesh, depths=depths)
        got = tshx.refine_sharded(t, *(torch.from_numpy(x) for x in (
            qtok, toks, sls, lo, hi)), d0, depths)
        for g, wv in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("S", SHARDS)
def test_plain_b2g_equals_gather_sa_chunk(world, S):
    """B2g's plain version against ``_gather_sa_chunk``; ranks no shard
    owns (before 0, at and past reflen) give 0."""
    w = world
    j = w["jsidx"][S]
    t = _carried(w, S)
    rng = np.random.default_rng(10 + S)
    rows = np.concatenate([rng.integers(0, t.reflen, 300),
                           [-3, -1, t.reflen, t.reflen + 1,
                            t.BR * S + 5]]).astype(np.int32)
    want = np.asarray(jshx._gather_sa_chunk(j.sa_l, j.rmeta,
                                            jnp.asarray(rows), mesh=j.mesh))
    got = tshx.gather_sa_sharded(t, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-5:], 0)
    np.testing.assert_array_equal(got[:300],
                                  np.asarray(w["tsa"].sa)[rows[:300]])


def _shard_positions(rng, t, s, n):
    """Corpus positions owned by shard s: random ones and the first and last
    MRS of its range, next to the halo edges."""
    lo, hi = int(t.smeta[s, 1]), int(min(t.smeta[s, 2], t.reflen))
    edge = np.concatenate([np.arange(lo, min(lo + MRS, hi)),
                           np.arange(max(hi - MRS, lo), hi)])
    return np.concatenate([edge, rng.integers(lo, hi, n)]).astype(np.int32)


KERNELS = ("B3f", "B3b", "B3p", "B3t", "B3c", "A4f", "A4b", "A7", "A8",
           "B3f-nogap", "B3b-nogap")


@pytest.mark.parametrize("shard", ["first", "middle", "last"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_shard_view_kernels_equal_jax(world, kernel, shard):
    """Each per-item kernel on one shard's views against its JAX
    function on ``shard_arrays(s)`` of the 8-shard index.  The scans and the
    verification compare against query tokens read from the corpus itself
    (``qtok`` = the padded corpus), so that moves match and the gap check
    and the halos decide; some verification tokens are shifted to mismatch.
    Query positions are >= 0, as the engines give them (a negative index
    would wrap in JAX).  B3f and B3b also without the gap check (``nogap``:
    the plain version's candidate masks against ``do_gap=False``)."""
    w = world
    S = 8
    j = w["jsidx"][S]
    t = _carried(w, S)
    # the last shard that owns corpus tokens (on the toy corpus the 8th
    # owns only the padding past the corpus end)
    last = int(np.flatnonzero(t.smeta[:, 1] < t.reflen)[-1])
    s = {"first": 0, "middle": last // 2, "last": last}[shard]
    jref, jrlp, jlrt, offs = j.shard_arrays(s)
    views = t.shard_arrays(s)
    rng = np.random.default_rng(3 * KERNELS.index(kernel) + s)
    pos = _shard_positions(rng, t, s, 300)
    n = len(pos)
    qtok = np.array(w["jidx"].refstr_padded)
    tq = torch.from_numpy(qtok)

    def T(*cols):
        return [torch.from_numpy(np.asarray(c, np.int32)) for c in cols]

    def J(*cols):
        return [jnp.asarray(np.asarray(c, np.int32)) for c in cols]

    sl = rng.integers(1, 4, n)
    el = rng.integers(1, 4, n)
    m = rng.integers(0, 4, n)
    if kernel.startswith(("B3f", "B3b")):
        fwd = kernel.startswith("B3f")
        gap = not kernel.endswith("nogap")
        qpos = pos + sl + MGS + m if fwd \
            else np.maximum(pos - MGS - m - sl, 0)   # query positions >= 0
        (want,) = (jlk._fwd_batch if fwd else jlk._bwd_batch)(
            jref, jrlp, jlrt, jnp.asarray(qtok), *J(pos, sl, el, qpos), offs,
            MRS, MGS, do_gap=gap)
        if gap:
            got = [(tlk.fwd_items if fwd else tlk.bwd_items)(
                *views, tq, *T(pos, sl, el, qpos), MRS, MGS)]
        else:
            got = [tlk.scan_items_plain(*views, tq, *T(pos, sl, el, qpos),
                                        MRS, MGS, fwd, gap=False)]
        want = [want]
    elif kernel == "B3p":
        plen = rng.integers(1, 9, n)
        tok = np.maximum(pos + 1 - sl + (rng.random(n) < 0.2), 0)
        stok = pos + plen
        (want,) = jlk._pcs_batch(jref, jnp.asarray(qtok),
                                 *J(pos, plen, sl, el, tok, stok), offs, MRS)
        got = [tlk.pcs_items(views[0], tq, *T(pos, plen, sl, el, tok, stok),
                             MRS)]
        want = [np.asarray(want).astype(np.int32)]
    elif kernel == "B3t":
        plen = rng.integers(1, 9, n)
        want = jlk._two_batch(jref, jrlp, jlrt, *J(pos, plen), offs, MRS,
                              MGS)
        got = list(tlk.two_items(*views, *T(pos, plen), MRS, MGS))
    elif kernel == "B3c":
        lm = rng.integers(1, 6, n)
        want = jdev._contig_batch_pos(jref, jrlp, jlrt, *J(pos, lm), offs,
                                      MRS, MSYM)
        got = list(tdev.contig_pos(*views, *T(pos, lm), MRS, MSYM))
    elif kernel in ("A4f", "A4b"):
        fwd = kernel == "A4f"
        want = [np.asarray(jpcx._gc_batch(jrlp, jlrt, *J(pos), offs, MRS,
                                          MGS, fwd)).view(np.int32)]
        got = [tpcx.gap_check(views[1], views[2], *T(pos), MRS, MGS, fwd)]
    elif kernel == "A7":
        fe = sl + el + MGS + m
        want = jdev._onegap_batch(jref, jrlp, jlrt, *J(pos, fe, sl, el), offs,
                                  MRS, MSYM)
        got = list(tdev.onegap(*views, *T(pos, fe, sl, el), MRS, MSYM))
    else:
        cl = rng.integers(1, 3, n)
        fe = sl + el + MGS + m
        se = fe + 1 + MGS + cl + rng.integers(0, 3, n)
        want = jdev._twogap_batch(jref, jrlp, jlrt, *J(pos, fe, se, sl, el, cl),
                                  offs, MRS)
        got = list(tdev.twogap(*views, *T(pos, fe, se, sl, el, cl), MRS))
    assert len(got) == len(want)
    nonzero = False
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
        nonzero |= bool((g != 0).any())
    assert nonzero


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_passes_equal_jax_and_refine_passes(world, S):
    """The sharded passes against the JAX package's and against the
    port's refinement on the replicated index."""
    w = world
    jp1, jp2 = jshx.sharded_passes(w["jsidx"][S], w["jqs"])
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    p1, p2 = tshx.sharded_passes(t, w["tqs"])
    r1, r2 = tpasses.refine_passes(w["tidx"], w["tqs"])
    for ref1, ref2 in ((jp1, jp2), (r1, r2)):
        for f in ("up", "down", "longestmatch"):
            np.testing.assert_array_equal(getattr(p1, f), getattr(ref1, f))
        for f in ("connectoffset", "up", "down"):
            np.testing.assert_array_equal(getattr(p2, f), getattr(ref2, f))
    assert p1.longestmatch.max() > 1


def _premise_world(corpus, world, S):
    """(the port's sharded index of S shards, its replicated index, its
    queries) over the toy corpus or a small-vocabulary one with deep
    intervals."""
    if corpus == "toy":
        w = world
        src, tgt, sa, al = w["tsrc"], w["ttgt"], w["tsa"], w["tal"]
        tidx, tqs, cfg = w["tidx"], w["tqs"], w["tcfg"]
    else:
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=3, seed=11)
        q = make_big_queries(f, 6, seed=3)
        f, e = f.split("\n"), e.split("\n")
        q += f[:2]
        cfg = _cfgs()[1]
        src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
        sa, al = tsab.build_index(src.str_), tcp.load_alignment_fast(a, src,
                                                                      tgt)
        tidx = tic.build_index(src, tgt, sa, al,
                               tcp.load_lex_table(lex_t, src.vocab,
                                                  tgt.vocab), cfg, "cpu")
        tqs = tcp.load_queries(q, src.vocab)
    return (tshx.build_sharded_index(src, tgt, sa, al, cfg, S, "cpu"), tidx,
            tqs)


@pytest.mark.parametrize("corpus", ["toy", "deep"])
@pytest.mark.parametrize("S", [1, 3, 4])
def test_shard_reads_keep_the_keys_sorted(world, corpus, S):
    """The premise of kernel B2r's 16-ary search (csrc/refine.cuh): over
    every interval that ``sharded_passes`` searches, at every depth, the key
    column read through the shards, ``_g_ref(_g_sa(M) + depth)``, is
    non-decreasing and equals the replicated key ``refstr[sa[M] + depth]``
    (every row and position read lies inside the SA and the corpus, so one
    shard owns it).  The lanes run one depth at a time through
    ``refine_sharded`` (the plain version here), and the passes must come
    out as the replicated refinement's."""
    t, tidx, tqs = _premise_world(corpus, world, S)
    qtok = t.query_tokens(tqs)
    seen = {"intervals": 0, "rows": 0, "rows_straddle": 0}

    def dispatch(toks, sls, lo, hi, depth, dchunk):
        toks, sls, l, h = (torch.from_numpy(x) for x in (toks, sls, lo, hi))
        ups, downs = [], []
        for c in range(dchunk):
            d = depth + c
            live = h > l
            lens = (h - l)[live].long()
            lane = torch.repeat_interleave(torch.arange(len(lens)), lens)
            first = torch.cumsum(lens, 0) - lens
            M = (l[live].long()[lane] + torch.arange(int(lens.sum()))
                 - first[lane]).int()
            keys = tshx._g_ref(t, tshx._g_sa(t, M) + d)
            assert torch.equal(keys, take(tidx.refstr_padded,
                                          take(tidx.sa, M) + d)), (S, d)
            same = lane[1:] == lane[:-1]
            assert bool((keys[1:] >= keys[:-1])[same].all()), (S, d)
            seen["intervals"] += int(live.sum())
            seen["rows"] += int(lens.sum())
            for b in range(1, S):
                seen["rows_straddle"] += int(
                    (live & (l < b * t.BR) & (h > b * t.BR)).sum())
            u, dn, l, h = tshx.refine_sharded(t, qtok, toks, sls, l, h, d, 1)
            ups.append(u)
            downs.append(dn)
        return (torch.cat(ups, 1).numpy(), torch.cat(downs, 1).numpy(),
                l.numpy(), h.numpy())
    got = tpasses.drive_refinement(
        tqs, t.reflen, (t.seed_lo1, t.seed_hi1, t.seed_pk, t.seed_pk3),
        dispatch)
    want = tpasses.refine_passes(tidx, tqs)
    for g, wv in zip(got, want):
        for f in dataclasses.fields(wv):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(wv, f.name), err_msg=f.name)
    assert seen["intervals"] > 0 and seen["rows"] > seen["intervals"]
    if corpus == "deep" and S > 1:   # intervals across a rank-shard boundary
        assert seen["rows_straddle"] > 0


def _div_magic(d):
    """csrc/sharded.cu ``div_magic``: (m, l) with l = ceil(log2 d), m =
    floor(2^32 (2^l - d) / d) + 1, as unsigned 32-bit."""
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


@pytest.mark.parametrize("seed", [0, 1])
def test_b2r_owner_division_is_exact(seed):
    """Kernel B2r finds a read's owner shard as x / BR (ranks) and x / B
    (positions) by a multiply and a shift, ``(umulhi(m, x) + x) >> l``: it
    must equal x // d for 0 <= x < 2^31 and 1 <= d < 2^31 (m fits 32 bits,
    and t + x, with t < x, does not overflow them).  This checks the
    formula, through a Python copy of ``div_magic`` (``_div_magic``); the
    compiled one is held to the plain versions on the card by
    ``chip_smoke.py`` (B2r and B2g, on 1, 3 and 4 shards)."""
    rng = np.random.default_rng(seed)
    ds = np.concatenate([np.arange(1, 2049), [2**31 - 1, 2**30, 2**30 + 1],
                         rng.integers(1, 2**31, 3000)])
    for d in ds.tolist():
        m, l = _div_magic(d)
        assert 0 < m < 2**32
        x = np.concatenate([[0, 1, d - 1, d, 2**31 - 1],
                            rng.integers(0, 2**31, 64),
                            np.arange(1, 5) * d - 1, np.arange(1, 5) * d])
        x = x[(x >= 0) & (x < 2**31)].astype(np.uint64)
        t = (x * np.uint64(m)) >> np.uint64(32)
        np.testing.assert_array_equal((t + x) >> np.uint64(l),
                                      x // np.uint64(d))


@pytest.mark.parametrize("S,fits", [(1, True), (4, True), (1365, True),
                                    (1366, False), (5000, False)])
def test_b2r_refuses_shard_rows_past_shared_memory(S, fits):
    """Kernel B2r holds every shard's row (two slice pointers, rmeta's 2
    words and smeta's 3: 36 bytes) in a block's 48 KiB of shared memory; the
    wrapper refuses a shard count whose rows do not fit, naming B2r."""
    assert tshx.B2R_SHARD_ROW_BYTES == 36
    if fits:
        tshx.check_b2r_shards(S)
    else:
        with pytest.raises(ValueError, match="B2r"):
            tshx.check_b2r_shards(S)


_JAX_RUNS = {}


def _jax_run(data, S):
    """The JAX package's pipeline, replicated (S = 0) or sharded, once per S
    in this module."""
    if S not in _JAX_RUNS:
        _JAX_RUNS[S] = jpl.run_pipeline(*data, _cfgs()[0], sa_shards=S)
    return _JAX_RUNS[S]


@pytest.fixture(scope="module")
def port_replicated(data):
    return tpl.run_pipeline(*data, _cfgs()[1], device="cpu")


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_pipeline_equals_jax_and_replicated(data, port_replicated,
                                                    S):
    """Lines and counters against the JAX sharded run and the port's
    replicated run."""
    got = tpl.run_pipeline(*data, _cfgs()[1], device="cpu", sa_shards=S)
    want = _jax_run(data, S)
    assert isinstance(got.index, tshx.ShardedGrammarIndex)
    assert got.index.S == S
    assert got.per_query_lines == want.per_query_lines
    assert got.per_query_lines == port_replicated.per_query_lines
    assert {k: got.counters[k] for k in want.counters} == want.counters
    assert got.counters == port_replicated.counters
    assert got.counters["total_lines"] > 100
    assert got.counters["twogap_sa"] > 0 and got.counters["onegap_sa"] > 0


def test_sharded_build_never_replicates(data, world, monkeypatch):
    """With the replicated index build made to fail, the sharded build and
    pipeline run, and the precompute equals the replicated one."""
    def boom(*args, **kwargs):
        raise AssertionError("replicated device index built in sharded mode")
    monkeypatch.setattr(tic, "build_index", boom)
    monkeypatch.setattr(tpl.ic, "build_index", boom)
    f, e, a, lex, _ = data
    art, index, _ = tpl.build_artifact(f, e, a, lex, _cfgs()[1],
                                       device="cpu", sa_shards=8)
    assert isinstance(index, tshx.ShardedGrammarIndex)
    w = world
    want = tpcx.precompute(_engine(w), w["tsrc"], w["tsa"], w["tcfg"])
    for fld in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(art.precomp, fld.name),
                                      getattr(want, fld.name),
                                      err_msg=fld.name)
    assert want.count > 0
    res = tpl.run_pipeline(*data, _cfgs()[1], device="cpu", sa_shards=8)
    assert res.counters["total_lines"] > 0


@pytest.mark.parametrize("S", SHARDS)
def test_memory_per_device_equals_jax(world, S):
    """The per-shard byte accounting of both packages."""
    w = world
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    want = w["jsidx"][S].memory_per_device()
    assert t.memory_per_device() == {k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("jax_tables", ["dense", "sorted"])
def test_host_maxlex_equals_jax_host_backend(world, monkeypatch, jax_tables):
    """The host backend on a HostLexIndex (one path: ``np.searchsorted``
    over the packed keys) against the JAX package's
    ``compute_maxlex_tpu(..., use_device=False)``, float32 bit for bit, with
    the JAX side on its dense tables and (its limit forced to 0) on its
    sorted-key search."""
    if jax_tables == "sorted":
        monkeypatch.setattr(jml, "DENSE_LIMIT", 0)
    w = world
    blocks = generate_blocks(w["tsa"], w["tqs"],
                             *tpasses.refine_passes(w["tidx"], w["tqs"]))
    contig, _, _ = tdev.extract_contiguous(_engine(w), blocks, w["tcfg"])
    rules, tasks = tlx.fast_create_lexicon_contig(contig, w["tsrc"],
                                                  w["ttgt"], blocks,
                                                  w["tcfg"])
    empty = type(tasks)(**{f.name: getattr(tasks, f.name)[:0]
                           for f in dataclasses.fields(tasks)})
    all_tasks = {"onegap": empty, "twogap": empty, "contig": tasks}
    got_rules, want_rules = copy.deepcopy(rules), copy.deepcopy(rules)
    tml.compute_maxlex(all_tasks, tic.build_host_lex_index(w["ttgt"],
                                                          w["tlex"]),
                       None, None, got_rules, w["tcfg"])
    jml.compute_maxlex_tpu(all_tasks, w["jidx"], None, None, want_rules,
                           w["jcfg"], use_device=False)
    assert len(got_rules) > 100
    for f in ("max_lex_fge", "max_lex_egf"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got_rules, f), np.float32).view(np.int32),
            np.asarray(getattr(want_rules, f), np.float32).view(np.int32))


def _cli_args(d, out, extra):
    return extra + [str(d / "corpus.f"), str(d / "query.f"),
                    str(d / "corpus.e"), str(d / "corpus.a"),
                    str(d / "lex.txt"), str(out)]


def test_cli_sa_shards(toy_fixture, tmp_path):
    """``--sa-shards 8`` writes the files a run without it writes;
    ``--sa-shards auto`` exits non-zero."""
    assert cli.main(_cli_args(toy_fixture, tmp_path / "r",
                              ["--device", "cpu"])) == 0
    assert cli.main(_cli_args(toy_fixture, tmp_path / "s",
                              ["--device", "cpu", "--sa-shards", "8"])) == 0
    rep = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert rep and rep == sorted(p.name for p in (tmp_path / "s").iterdir())
    for name in rep:
        assert (tmp_path / "r" / name).read_bytes() == \
            (tmp_path / "s" / name).read_bytes(), name
    with pytest.raises(SystemExit) as exc:
        cli.main(_cli_args(toy_fixture, tmp_path / "a",
                           ["--device", "cpu", "--sa-shards", "auto"]))
    assert exc.value.code != 0
    with pytest.raises(ValueError, match="ROADMAP"):
        tpl.run_pipeline([], [], [], [], [], sa_shards="auto")


def test_lcp_passes_with_sa_shards_raises(data):
    """The sharded index keeps no LCP tree on the device."""
    with pytest.raises(ValueError, match="lcp_passes"):
        tpl.run_pipeline(*data, _cfgs()[1], device="cpu", lcp_passes=True,
                         sa_shards=4)
