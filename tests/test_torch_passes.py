"""Pass 1 / pass 2 in the port: kernel A1's plain version against the JAX
``_refine_chunk_local``, ``refine_passes`` against the JAX package's, kernel
B1's plain passes against ``_pass1_batch``/``_pass2_batch`` (also on edge
lanes), the LCP passes against the refinement, bit for bit, and kernel
B1's rounds (csrc/lcp.cuh) against every LCP-tree and SA read of the
plain search."""

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
from cgx_tpu_torch.tools import edges, reads  # noqa: E402
from cgx_tpu_torch.utils.views import take  # noqa: E402


def _inputs(name, request):
    if name == "long":   # 70-token sentences: matches past 32 tokens
        return edges.long_corpus()
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


def _node_windows(L, R, pin, levels):
    """Per heap node of ``levels`` levels below the windows (L, R) [n]:
    its window and midpoint (csrc/lcp.cuh ``node_window``: the bits of j + 1
    after the leading one are the path, 1: L = M, 0: R = M; pass 2's pin
    ``(LL, MM, RR)`` replaces the midpoint of the window (LL, RR))."""
    def mid(lo, hi):
        m = (lo + hi) >> 1
        if pin is None:
            return m
        LL, MM, RR = pin
        return torch.where((lo == LL) & (hi == RR) & (MM >= 0), MM, m)
    nodes = []
    for j in range(2 ** levels - 1):
        n = j + 1
        lo, hi = L.clone(), R.clone()
        for k in range(n.bit_length() - 2, -1, -1):
            m = mid(lo, hi)
            if (n >> k) & 1:
                lo = m
            else:
                hi = m
        nodes.append((n.bit_length() - 1, lo, hi, mid(lo, hi)))
    return nodes


def _round_words(phase, L, R, pin, lcp_len, sa_len):
    """{array: [n, K] addresses} that kernel B1's round from the windows
    (L, R) loads, and [(level, L_j, R_j)] of its nodes: per search node its
    lcpleft and lcpright words at M and at the midpoint-tree slots of both
    bounds, and sa[M]; per walk node the walk's direct word at M and both
    tree words at the midpoint of M and the walk's other bound (R up, L
    down).  Addresses clamped as the kernel clamps them."""
    levels = (reads.SEARCH_LEVELS if phase == "search"
              else reads.WALK_LEVELS)
    nodes = _node_windows(L, R, pin if phase == "search" else None, levels)
    words = {"lcpl": [], "lcpr": [], "sa": []}
    for _, lo, hi, m in nodes:
        if phase == "search":
            for name in ("lcpl", "lcpr"):
                words[name] += [m, (lo + m) >> 1, (hi + m) >> 1]
            words["sa"].append(m)
        else:
            other = hi if phase == "walk_up" else lo
            direct = "lcpr" if phase == "walk_up" else "lcpl"
            words[direct].append(m)
            for name in ("lcpl", "lcpr"):
                words[name].append((other + m) >> 1)
    size = {"lcpl": lcp_len, "lcpr": lcp_len, "sa": sa_len}
    return ({k: torch.stack(v, 1).clamp(0, size[k] - 1)
             for k, v in words.items() if v},
            [(lv, lo, hi) for lv, lo, hi, _ in nodes])


def _check_rounds(need, log, pin, lcp_len, sa_len) -> dict:
    """Every traced LCP-tree and SA read of an active lane lies in the words
    of its step's round, and each step's window is a node of the round at
    the step's level -> reads checked per phase."""
    checked = {}
    for name, phase, it, idx in log:
        steps = need[phase]
        levels = (reads.SEARCH_LEVELS if phase == "search"
                  else reads.WALK_LEVELS)
        act, L, R = steps[it]
        _, L0, R0 = steps[it - it % levels]
        words, nodes = _round_words(phase, L0, R0, pin, lcp_len, sa_len)
        size = sa_len if name == "sa" else lcp_len
        got = idx.clamp(0, size - 1)
        inside = (got[:, None] == words[name]).any(dim=1)
        assert bool((inside | ~act).all()), (phase, it, name)
        at_node = torch.zeros_like(act)
        for lv, lo, hi in nodes:
            if lv == it % levels:
                at_node |= (lo == L) & (hi == R)
        assert bool((at_node | ~act).all()), (phase, it)
        checked[phase] = checked.get(phase, 0) + int(act.sum())
    return checked


@pytest.mark.parametrize("corpus", ["toy", "real", "hard", "adversarial"])
@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_b1_round_loads_cover_every_read(corpus, which, request,
                                         monkeypatch):
    """Kernel B1's warp body loads, per round, the LCP-tree and SA words of
    the next SEARCH_LEVELS levels' nodes (31, with pass 2's pin at the
    root) and per walk round those of WALK_LEVELS levels (15), from the
    round's first window; then it decides the levels in order.  That is
    exact only if every word the sequential search and walks read lies in
    its round's set: checked against a trace of every read of
    ``_lcp_search`` and ``_bound_walk``."""
    tidx, tqs = _torch_world(*_inputs(corpus, request))
    lcpl, lcpr = tidx.lcp_tables()
    qtok = tidx.query_tokens(tqs)
    p1 = tpasses.pass1_lcp(tidx, tqs)
    names = {id(lcpl): "lcpl", id(lcpr): "lcpr", id(tidx.sa): "sa"}
    need, log = {}, []

    def traced(arr, idx):
        name = names.get(id(arr))
        if name is not None:
            phase = next((p for p in ("walk_down", "walk_up")
                          if need.get(p)), "search")
            log.append((name, phase, len(need[phase]) - 1, idx.clone()))
        return take(arr, idx)
    if which == "pass1":
        n = tqs.totaltokens
        args = (torch.arange(n, dtype=torch.int32),
                torch.from_numpy(tpasses._suffix_lens(tqs)), tidx.reflen)
        pin = None
        monkeypatch.setattr(tpasses, "take", traced)
        tpasses.pass1_plain(tidx.refstr_padded, tidx.sa, lcpl, lcpr, qtok,
                            *args, need=need)
    else:
        # the real items, then the same with the pin off the midpoint (at
        # LL + 1 where the window allows it), so that the root's M is MM
        _, it_toks, it_match = tpasses.pass2_work_items(p1)
        LL, MM, RR = (f[it_toks] for f in (
            p1.firstfindhitL, p1.firstfindhit, p1.firstfindhitR))
        MM = np.concatenate([MM, np.where(RR - LL >= 2, LL + 1, MM)])
        cols = [torch.from_numpy(np.ascontiguousarray(c, np.int32)) for c in (
            np.tile(it_toks, 2), np.tile(it_match, 2), np.tile(LL, 2), MM,
            np.tile(RR, 2))]
        pin = (cols[2], cols[3], cols[4])
        monkeypatch.setattr(tpasses, "take", traced)
        tpasses.pass2_plain(tidx.refstr_padded, tidx.sa, lcpl, lcpr, qtok,
                            *cols, need=need)
    monkeypatch.undo()
    checked = _check_rounds(need, log, pin, lcpl.shape[0], tidx.sa.shape[0])
    # every phase ran, over more than one round
    assert set(checked) == {"search", "walk_up", "walk_down"}
    assert len(need["search"]) > reads.SEARCH_LEVELS
    assert max(len(need["walk_up"]), len(need["walk_down"])) \
        > reads.WALK_LEVELS


@pytest.mark.parametrize("corpus", ["toy", "long"])
def test_plain_b1_edge_lanes_equal_jax(corpus, request):
    """B1's plain passes against ``_pass1_batch`` / ``_pass2_batch`` on the
    hazard lanes of its warp body, the lanes and items that
    ``chip_smoke.py`` runs the kernel on: OOV tokens (a lane's first token,
    found before the first step, and inside the longest matches), suffixlen
    1, each query's last token before the -2 padding, tokens that match
    the SA's first and last rows, the sentinel and an id past it (no
    match), pass-2 pins at LL + 1 and RR - 1, windows with RR - LL == 2
    (where the skip is the direct word), and (``long``) matches longer
    than 32 tokens."""
    jidx, jqs, tidx, tqs = _worlds(*_inputs(corpus, request))
    rng = np.random.default_rng(len(corpus))
    lcpl, lcpr = tidx.lcp_tables()
    n = tqs.totaltokens
    real_t = np.arange(n, dtype=np.int32)
    real_sl = tpasses._suffix_lens(tqs)
    # the edge lanes and items (``tools.edges``, which chip_smoke.py's
    # ``lcp_edges`` runs the kernel on), then the queries' own lanes
    q, edge_t, edge_sl = edges.lcp_edge_lanes(
        rng, (tidx.refstr_padded, tidx.sa, lcpl, lcpr,
              tidx.query_tokens(tqs), tidx.reflen),
        torch.from_numpy(real_t), torch.from_numpy(real_sl))
    qtok = torch.from_numpy(q)
    toks = torch.from_numpy(np.concatenate([edge_t, real_t]))
    sls = torch.from_numpy(np.concatenate([edge_sl, real_sl]))
    jarr = (jidx.refstr_padded, jidx.sa, jidx.lcpleft, jidx.lcpright,
            jnp.asarray(q))
    want1 = jpasses._pass1_batch(*jarr, jnp.asarray(toks.numpy()),
                                 jnp.asarray(sls.numpy()),
                                 jnp.int32(jidx.reflen))
    got1 = tpasses.pass1_plain(tidx.refstr_padded, tidx.sa, lcpl, lcpr, qtok,
                               toks, sls, tidx.reflen)
    for g, w in zip(got1, want1):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lm = got1[0].numpy()
    assert (lm == 0).any() and (sls.numpy() == 1).any() and (lm > 0).any()
    assert (q[toks.numpy()] == -1).any()
    if corpus == "long":
        assert lm.max() > 32
    edge, real = edges.lcp_edge_items(
        rng, toks.numpy(), [g.numpy() for g in got1])
    cols = list(np.concatenate([edge, real]).T)
    assert (cols[3] != (cols[2] + cols[4]) >> 1).any()
    assert (cols[4] - cols[2] == 2).any()
    want2 = jpasses._pass2_batch(*jarr, *(jnp.asarray(c) for c in cols))
    got2 = tpasses.pass2_plain(tidx.refstr_padded, tidx.sa, lcpl, lcpr, qtok,
                               *(torch.from_numpy(np.ascontiguousarray(c))
                                 for c in cols))
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got2[0].numpy() >= 0).any() and (got2[0].numpy() == -1).any()
