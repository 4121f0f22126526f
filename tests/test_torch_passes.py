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
from cgx_tpu_torch.utils.views import take  # noqa: E402


def _inputs(name, request):
    if name.startswith("random"):  # small vocabularies: deep, long matches
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        seed = int(name[len("random"):])
        f, e, a, lex_t = make_hard_corpus(400, vocab=3 + 2 * seed,
                                          seed=100 + seed)
        # whole corpus sentences match to their end: lanes past it
        q = make_big_queries(f, 4, seed=seed) + f.split("\n")[:3]
        return f.split("\n"), e.split("\n"), a, lex_t, q
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


def _torch_world(f, e, a, lex_t, q):
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tidx = tic.build_index(tsrc, ttgt, tsab.build_index(tsrc.str_),
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           ExtractorConfig(), "cpu")
    return tidx, tcp.load_queries(q, tsrc.vocab)


def _sorted_keys(sa, refstr, lo, hi, depth):
    """Whether the key column refstr[sa[M] + depth] is non-decreasing over
    each lane's [lo, hi) (clamped reads, as the kernel's)."""
    live = hi > lo
    lens = (hi - lo)[live].long()
    if not len(lens):
        return True
    lane = torch.repeat_interleave(torch.arange(len(lens)), lens)
    first = torch.cumsum(lens, 0) - lens
    M = lo[live].long()[lane] + torch.arange(int(lens.sum())) - first[lane]
    keys = take(refstr, take(sa, M) + depth)
    same = lane[1:] == lane[:-1]
    return bool((keys[1:] >= keys[:-1])[same].all())


@pytest.mark.parametrize("corpus", ["toy", "real", "hard", "adversarial",
                                    "random0", "random1"])
def test_refined_intervals_are_sorted(corpus, request):
    """The premise of kernel A1's 16-ary search (csrc/refine.cu): over every
    interval the refinement searches, at every depth, the key column
    refstr[sa[M] + depth] is non-decreasing.  ``drive_refinement``'s lanes
    run one depth at a time through ``refine_chunk`` (the plain version
    here), and the passes must come out as the chunked refinement's."""
    tidx, tqs = _torch_world(*_inputs(corpus, request))
    sa, ref = tidx.sa, tidx.refstr_padded
    qtok = tidx.query_tokens(tqs)
    seen = {"intervals": 0, "past_end": 0, "rows": 0}

    def dispatch(toks, sls, lo, hi, depth, dchunk):
        toks, sls, l, h = (torch.from_numpy(x) for x in (toks, sls, lo, hi))
        ups, downs = [], []
        for c in range(dchunk):
            d = depth + c
            assert _sorted_keys(sa, ref, l, h, d), (corpus, d)
            live = h > l
            seen["intervals"] += int(live.sum())
            seen["past_end"] += int((live & (sls <= d)).sum())
            seen["rows"] += int((h - l)[live].sum())
            u, dn, l, h = tpasses.refine_chunk(sa, ref, qtok, toks, sls, l, h,
                                               d, 1)
            ups.append(u)
            downs.append(dn)
        return (torch.cat(ups, 1).numpy(), torch.cat(downs, 1).numpy(),
                l.numpy(), h.numpy())
    got = tpasses.drive_refinement(tqs, tidx.reflen, tidx.seed_host,
                                   dispatch)
    want = tpasses.refine_passes(tidx, tqs)
    for g, w in zip(got, want):
        _fields_equal(g, w)
    assert seen["intervals"] > 0 and seen["rows"] > seen["intervals"]
    if corpus.startswith("random"):     # wide intervals, lanes past the end
        assert seen["rows"] > 10 * seen["intervals"] and seen["past_end"] > 0


def _edge_lanes(case, sa, reflen, refstr, rng):
    """(toks, sls, lo, hi, d0, qtok) of A1 edge lanes whose query tokens are
    the corpus itself (``qtok``: the padded corpus, or a copy with some
    tokens replaced)."""
    n = 24
    qtok = refstr.copy()
    toks = rng.integers(0, reflen, n)
    sls = np.full(n, 30)
    lo, hi = np.zeros(n, np.int64), np.full(n, reflen)
    d0 = 0
    if case == "sa_ends":          # the SA's first and last rows
        toks[:4] = sa[[0, 1, reflen - 2, reflen - 1]]
        lo[4:8] = [0, 0, reflen - 3, reflen - 1]
        hi[4:8] = [1, 3, reflen, reflen]
    elif case == "empty":          # [l, l) at both ends and inside
        lo[:8] = hi[:8] = [0, reflen, 1, reflen - 1] + list(
            rng.integers(0, reflen, 4))
    elif case == "max_token":      # the largest id, the sentinel, past both
        top = int(refstr[:reflen - 1].max())
        for k, t in enumerate((top, top + 1, top + 2, top, 0)):
            qtok[toks[k] + k % 3] = t
        toks[5] = reflen - 1       # the sentinel's own suffix
    elif case == "past_sls":       # d0 at and past the query's end
        d0 = 2
        sls[:8] = [0, 1, 2, 2, 3, 2, 1, 0]
    return (toks.astype(np.int32), sls.astype(np.int32), lo.astype(np.int32),
            hi.astype(np.int32), d0, qtok.astype(np.int32))


@pytest.mark.parametrize("case", ["sa_ends", "empty", "max_token",
                                  "past_sls"])
def test_plain_a1_edge_lanes_equal_jax(toy_fixture, case, request):
    """Kernel A1's plain version against the JAX ``_refine_chunk_local`` on
    edge lanes: intervals at the SA's first and last rows, empty intervals,
    the largest token id (and the sentinel, and an id past every token),
    and d0 at and past the query's end; 4 and 16 depths."""
    jidx, _, tidx, _ = _worlds(*_inputs("toy", request))
    reflen = int(tidx.reflen)
    sa_h, ref_h = tidx.sa.numpy(), tidx.refstr_padded.numpy()
    rng = np.random.default_rng(len(case))
    toks, sls, lo, hi, d0, qtok = _edge_lanes(case, sa_h, reflen, ref_h, rng)
    if d0:      # the lanes' intervals at depth d0: from the whole SA
        _, _, lo_t, hi_t = tpasses.refine_chunk(
            tidx.sa, tidx.refstr_padded, torch.from_numpy(qtok),
            torch.from_numpy(toks), torch.full_like(torch.from_numpy(sls), 99),
            torch.from_numpy(lo), torch.from_numpy(hi), 0, d0)
        lo, hi = lo_t.numpy(), hi_t.numpy()
    for depths in (4, 16):
        want = jpasses._refine_chunk_local(
            jidx.sa, jidx.refstr_padded, jnp.asarray(qtok),
            *(jnp.asarray(x) for x in (toks, sls, lo, hi)), jnp.int32(d0),
            depths=depths)
        got = tpasses.refine_chunk(
            tidx.sa, tidx.refstr_padded, torch.from_numpy(qtok),
            *(torch.from_numpy(x) for x in (toks, sls, lo, hi)), d0, depths)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ups = got[0].numpy()
        if case == "empty":
            assert (ups[:8] == lo[:8, None]).all()
        if case == "past_sls":
            assert (got[2][:8] == got[3][:8]).all()    # collapsed
        if case == "sa_ends":
            assert ups[0, 0] == 0 and got[1][3, 0] == reflen - 1
