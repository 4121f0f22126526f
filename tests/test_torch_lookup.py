"""lookup1 in the port: the item expansion, kernel A2's plain version (both
directions) against the JAX ``_scan_batch_exp`` with the fused gap check and
its candidate masks (``gap=False``) against ``do_gap=False``, the window
words that decide the candidates (what the scans' bounds count), kernel A3's
plain version against ``_pcs_batch_exp`` (also on the layouts of its warp's
item resolution: one pattern, runs of empty patterns, warps over more than
32 patterns), the model of that resolution (``tools/reads.py``
``pcs_rounds``), and ``one_gap_lookup`` against the JAX package's
``one_gap_lookup_tpu``, bit for bit.  lookup1's device route (kernel A2m's
plain versions, every row sorted by one packed key) against its host route
(A2, the hits expanded on the host) and the JAX package, on seeded subsets
of the patterns at several span limits, on empty inputs, ``scan_rows`` on
each part of its keys, the packed key against the lexsort, keys past 63
bits refused, and the engines that keep the host route."""

import copy
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
from cgx_tpu.search import enumerate_fast as jef  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu.utils.batching import bucket_size  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
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
from cgx_tpu_torch.tools import reads  # noqa: E402
from cgx_tpu_torch.utils.views import OffsetView, take  # noqa: E402


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], w["tcfg"])


class _HostRouteEngine(ReplicatedEngine):
    """The replicated engine with lookup1's scans on the host route (A2's
    ``scan_expanded``, the hits expanded on the host, ``sa_values``): the
    route of every engine but ``ReplicatedEngine`` without ``scan_cols``."""
    scan_rows_on_device = False


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
    """Both packages run one corpus up to lookup1's inputs, with one
    configuration (the default, precompute_count 100) on both sides."""
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
    _, jsearch = jef.fast_sort_and_dedup_onegap(
        jef.fast_one_gap_enumeration(jqs, jp1, jcfg), jqs)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tal = tcp.load_alignment_fast(a, tsrc, ttgt)
    tidx = tic.build_index(tsrc, ttgt, tsa, tal,
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    tqs = tcp.load_queries(q, tsrc.vocab)
    tp1, tp2 = tpasses.refine_passes(tidx, tqs)
    _, tsearch = tef.fast_sort_and_dedup_onegap(
        tef.fast_one_gap_enumeration(tqs, tp1, tcfg), tqs)
    return dict(
        jcfg=jcfg, tcfg=tcfg, jsa=jsa, jidx=jidx, jqs=jqs, jp=(jp1, jp2),
        jsearch=jsearch, jpc=jpcx.precompute_tpu(jidx, jsrc, jsa, jcfg),
        tidx=tidx, tqs=tqs, tp=(tp1, tp2), tsearch=tsearch,
        tpc=tpcx.precompute(ReplicatedEngine(tidx, tcfg), tsrc, tsa, tcfg),
        tsrc=tsrc, ttgt=ttgt, tsa=tsa, tal=tal)


def _layout(rng, D, max_count):
    """Per-pattern item counts with about a quarter of the patterns empty
    (first and last included) and the exclusive prefix."""
    counts = rng.integers(1, max_count, D)
    counts[rng.random(D) < 0.25] = 0
    counts[0] = counts[-1] = 0
    return counts, np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def _jax_tables(pattab, offs):
    """The JAX engine's pow2-padded per-pattern table and count prefix."""
    D = len(pattab)
    tab = np.zeros((bucket_size(D), 8), np.int32)
    tab[:D] = pattab
    offs_pad = np.full(len(tab) + 1, offs[-1], np.int64)
    offs_pad[:D + 1] = offs
    pat0 = max(int(np.searchsorted(offs, 0, side="right")) - 1, 0)
    return jnp.asarray(tab), jnp.asarray(offs_pad.astype(np.int32)), pat0


def test_expand_equals_cumsum_expand():
    """The kernels' binary search over the count prefix gives the pattern and
    offset of ``_cumsum_expand``, zero-count patterns (leading, inner and
    trailing) and the padding items past the end included."""
    rng = np.random.default_rng(5)
    for D in (1, 2, 7, 40):
        counts, offs = _layout(rng, D, 9)
        counts[D // 2] = 3                    # at least one item
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        N = int(offs[-1])
        pattab = np.zeros((D, 8), np.int32)
        pattab[:, 0] = np.arange(D)
        tab, offs_pad, pat0 = _jax_tables(pattab, offs)
        for n in (N, bucket_size(N) * 2):
            pat, tx = jlk._cumsum_expand(offs_pad, jnp.int32(0),
                                         jnp.int32(pat0), jnp.int32(D), n)
            f, ttx = tlk._expand(torch.from_numpy(pattab),
                                 torch.from_numpy(offs.astype(np.int32)), n)
            np.testing.assert_array_equal(f[:, 0].numpy(), np.asarray(pat))
            np.testing.assert_array_equal(ttx.numpy(), np.asarray(tx))


def _index_args(w):
    j, t = w["jidx"], w["tidx"]
    return ((j.refstr_padded, j.rlp, j.lr_tar, j.sa),
            (t.refstr_padded, t.rlp, t.lr_tar, t.sa))


@pytest.mark.parametrize("fwd,do_gap", [(True, True), (False, True),
                                        (True, False), (False, False)],
                         ids=["True", "False", "True-nogap", "False-nogap"])
def test_plain_a2_equals_scan_batch_exp(world, fwd, do_gap):
    """A random pattern layout over the SA, past its end included, with the
    compared query tokens read from the corpus next to each pattern's first
    occurrence, so that moves match and the gap check decides.  Without the
    gap check (``do_gap=False``) the plain version's candidate masks, which
    kernel A2 gap-checks alone, equal the JAX ones."""
    w = world
    cfg = w["jcfg"]
    mrs, mgs = cfg.max_rule_span, cfg.min_gap_size
    rng = np.random.default_rng(2 if fwd else 3)
    D = 300
    counts, offs = _layout(rng, D, 24)
    N = int(offs[-1])
    reflen = w["jidx"].reflen
    refstr = np.asarray(w["jidx"].refstr_padded)
    sa = np.asarray(w["jsa"].sa)
    lo = rng.integers(0, reflen, D)
    lo[:8] = reflen - rng.integers(1, 6, 8)       # ranges run past the SA
    sl = rng.integers(1, 4, D)
    el = rng.integers(1, 4, D)
    g = sa[np.minimum(lo, reflen - 1)].astype(np.int64)
    m = rng.integers(0, 4, D)
    if fwd:
        p0 = g + sl + mgs + m
        toks = [refstr[np.clip(p0 + k, 0, len(refstr) - 1)] for k in range(3)]
    else:
        p0 = g - 1 - mgs - m
        toks = [np.where(p0 - k < 0, -1, refstr[np.clip(p0 - k, 0, None)])
                for k in range(3)]
    pattab = np.stack([lo, sl, el] + toks + [np.zeros(D)] * 2,
                      axis=1).astype(np.int32)
    tab, offs_pad, pat0 = _jax_tables(pattab, offs)
    (jr, jrlp, jlr, jsa), targs = _index_args(w)
    (want,) = jlk._scan_batch_exp(
        jr, jrlp, jlr, jsa, tab, offs_pad, jnp.int32(0), jnp.int32(pat0),
        jnp.int32(D), w["jidx"].offs0, mrs, mgs, fwd, bucket_size(N),
        do_gap=do_gap)
    targs += (torch.from_numpy(pattab),
              torch.from_numpy(offs.astype(np.int32)), N, mrs, mgs, fwd)
    got = (tlk.scan(*targs) if do_gap
           else tlk.scan_plain(*targs, gap=False))
    assert got.dtype == torch.int32 and got.shape == (N,)
    want = np.asarray(want)[:N]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()
    if not do_gap:      # the gap check clears some candidates
        full = tlk.scan_plain(*targs).numpy()
        assert ((full & ~want) == 0).all() and (full != want).any()
        # the count the kernels' bounds use
        f, tx = tlk._expand(targs[4], targs[5], N)
        n_cand, n_read, n_gap, n_ok = reads.scan_reads(
            targs[0], targs[1], targs[2], take(targs[3], f[:, 0] + tx),
            f[:, 1], f[:, 2], f[:, 3:6], mrs, mgs, fwd)
        assert n_cand == int((want != 0).sum())
        assert 0 < n_read < N * (tlk.MMOV + 2)
        # the gap check's words, over the items with a candidate only
        assert n_cand <= n_gap < n_cand * (mrs + 2 + tlk.MMOV)
        assert 0 < n_ok <= n_cand


@pytest.mark.parametrize("fwd", [True, False])
def test_scan_reads_decide_candidates(fwd):
    """The window words that ``_scan_cand`` marks as read decide the
    candidate masks: redrawing every other word changes no mask, so the
    kernels' bounds, which count only the read words, count all the scan
    needs.  Tokens come from a small alphabet with sentence ends (< 2) so
    that moves match, verify and stop; some spans are too short for any
    move."""
    rng = np.random.default_rng(7 if fwd else 8)
    N, mgs = 2000, 1

    def draw(shape):
        return torch.from_numpy(rng.integers(0, 6, shape).astype(np.int32))
    for mrs in (2, 8, 15):
        win, want = draw((N, tlk.MMOV + 2)), draw((N, 3))
        gap0_bad = torch.from_numpy(rng.random(N) < 0.1)
        sl, el = draw(N) % 3 + 1, draw(N) % 3 + 1
        cand, read = tlk._scan_cand(win, gap0_bad, sl, el, want, mrs, mgs,
                                    fwd)
        for _ in range(5):
            other = torch.where(read, win, draw(win.shape))
            again, _ = tlk._scan_cand(other, gap0_bad, sl, el, want, mrs,
                                      mgs, fwd)
            assert torch.equal(again, cand)
        words = read.sum(dim=1)
        assert (words[gap0_bad] == 0).all()
        assert int(words.sum()) < read.numel() // 2
        if mrs > 2:
            assert cand.any()
        else:           # sl + mgs + el > mrs: no move, no word
            assert not read.any()


def test_plain_a3_equals_pcs_batch_exp(world):
    """A random layout over the precomputed occurrences (rows past the end
    included), with the compared tokens read around each pattern's first
    row."""
    w = world
    cfg = w["jcfg"]
    pc = w["jpc"]
    npc = pc.count
    rows = np.zeros((bucket_size(max(npc, 1)), 2), np.int32)
    rows[:npc, 0] = pc.onegap_start
    rows[:npc, 1] = pc.onegap_length
    rng = np.random.default_rng(4)
    D = 300
    counts, offs = _layout(rng, D, 24)
    N = int(offs[-1])
    refstr = np.asarray(w["jidx"].refstr_padded)
    base = rng.integers(0, npc, D)
    base[:8] = npc - rng.integers(1, 6, 8)
    sl = rng.integers(1, 4, D)
    el = rng.integers(1, 4, D)
    ps = rows[base, 0].astype(np.int64)
    pe = ps + rows[base, 1]
    last = len(refstr) - 1
    toks = [refstr[np.clip(ps - 1, 0, last)], refstr[np.clip(ps - 2, 0, last)],
            refstr[np.clip(pe + 1, 0, last)], refstr[np.clip(pe + 2, 0, last)]]
    flip = rng.random(D) < 0.2                    # some mismatching tokens
    toks[0] = np.where(flip, toks[0] + 1, toks[0])
    pattab = np.stack([base, sl, el] + toks + [np.zeros(D)],
                      axis=1).astype(np.int32)
    tab, offs_pad, pat0 = _jax_tables(pattab, offs)
    (want,) = jlk._pcs_batch_exp(
        w["jidx"].refstr_padded, jnp.asarray(rows), tab, offs_pad,
        jnp.int32(0), jnp.int32(pat0), jnp.int32(D), w["jidx"].offs0,
        cfg.max_rule_span, bucket_size(N))
    got = tlk.pcs(w["tidx"].refstr_padded, torch.from_numpy(rows),
                  torch.from_numpy(pattab),
                  torch.from_numpy(offs.astype(np.int32)), N,
                  cfg.max_rule_span)
    assert got.dtype == torch.int32 and got.shape == ((N + 31) // 32,)

    def bits(words):
        return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                             bitorder="little")[:N]
    wb = bits(np.asarray(want, np.uint32))
    np.testing.assert_array_equal(bits(got.numpy()), wb)
    assert wb.any() and not wb.all()


def _warp_layout(rng, kind, n):
    """Per-pattern item counts of n items for A3's warp resolution: one
    pattern (d1); a few patterns each after a run of 1-3 empty ones (runs);
    one item a pattern after 1-2 empty ones, so that a warp's 32 items span
    more than 32 patterns (wide); random counts (random)."""
    if kind == "d1":
        return np.array([n])
    if kind == "random":
        counts = rng.integers(0, 9, max(n // 3, 1))
        counts[-1] += n - counts.sum() if counts.sum() < n else 0
        while counts.sum() > n:
            counts[np.argmax(counts)] -= 1
        return counts
    if kind == "wide":
        sizes = [1] * n
    else:
        cuts = np.sort(rng.choice(np.arange(1, n), min(n - 1, 5),
                                  replace=False))
        sizes = np.diff(np.concatenate([[0], cuts, [n]]))
    counts = []
    for c in sizes:
        counts += [0] * int(rng.integers(1, 4 if kind == "runs" else 3))
        counts.append(int(c))
    return np.array(counts + [0])


@pytest.mark.parametrize("kind", ["d1", "runs", "wide", "random"])
def test_pcs_rounds_resolve_every_item(kind):
    """The model of kernel A3's item resolution (a 32-ary search for each
    warp's first item, then windows of 32 patterns) gives every item the
    pattern of ``_expand``: the last p with offs[p] <= j, clamped to
    D - 1, for 1-200 items (n not a multiple of 32 included) and for
    items past offs[D]."""
    rng = np.random.default_rng(["d1", "runs", "wide", "random"].index(kind))
    windows_seen = 0
    for n in (1, 15, 17, 31, 32, 33, 64, 95, 200):
        counts = _warp_layout(rng, kind, n)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        D = len(counts)
        rounds = 1                   # ceil(log32(D + 1))
        while 32 ** rounds < D + 1:
            rounds += 1
        for extra in (0, 2):         # two items past offs[D]
            pat, search, windows = reads.pcs_rounds(offs, n + extra)
            f, _ = tlk._expand(torch.arange(D, dtype=torch.int32)[:, None]
                               .expand(D, 8).contiguous(),
                               torch.from_numpy(offs), n + extra)
            np.testing.assert_array_equal(pat, f[:, 0].numpy())
            assert len(search) == len(windows) == -(-(n + extra) // 32)
            assert search.max() <= rounds
            windows_seen = max(windows_seen, int(windows.max()))
    if kind == "wide":               # a warp over more than 32 patterns
        assert windows_seen >= 2
    else:
        assert windows_seen >= 1


@pytest.mark.parametrize("kind", ["d1", "runs", "wide"])
def test_plain_a3_warp_layouts_equal_jax(world, kind):
    """A3's plain version against ``_pcs_batch_exp`` on the layouts of the
    kernel's warp resolution, n = 1, 15, 17, 31, 32 and 33 items, with
    occurrences at the corpus start and end, sl and el 1-3 and span budgets
    that just fit and just fail."""
    w = world
    cfg = w["jcfg"]
    mrs = cfg.max_rule_span
    refstr = np.asarray(w["jidx"].refstr_padded)
    last = len(refstr) - 1
    reflen = int(w["jidx"].reflen)
    rng = np.random.default_rng(40 + ["d1", "runs", "wide"].index(kind))
    got_any = False
    for n in (1, 15, 17, 31, 32, 33):
        counts = _warp_layout(rng, kind, n)
        D = len(counts)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        sl, el = rng.integers(1, 4, D), rng.integers(1, 4, D)
        j = np.arange(n)
        p = np.clip(np.searchsorted(offs, j, side="right") - 1, 0, D - 1)
        ps = np.concatenate([[0, 1, 2, reflen - 1, last],
                             rng.integers(0, reflen, n)])[:n]
        pl = np.maximum(mrs - sl[p] - el[p] + 1 + rng.choice([0, 1, -2], n),
                        1)
        rows = np.zeros((bucket_size(n), 2), np.int32)
        rows[:n, 0], rows[:n, 1] = ps, pl
        first = np.clip(offs[:D], 0, n - 1)
        a, e = ps[first], ps[first] + pl[first]
        toks = [refstr[np.clip(p, 0, last)]
                for p in (a - 1, a - 2, e + 1, e + 2)]
        pattab = np.stack([offs[:D], sl, el] + toks + [np.zeros(D)],
                          axis=1).astype(np.int32)
        tab, offs_pad, pat0 = _jax_tables(pattab, offs)
        (want,) = jlk._pcs_batch_exp(
            w["jidx"].refstr_padded, jnp.asarray(rows), tab, offs_pad,
            jnp.int32(0), jnp.int32(pat0), jnp.int32(D), w["jidx"].offs0,
            mrs, bucket_size(n))
        got = tlk.pcs(w["tidx"].refstr_padded, torch.from_numpy(rows),
                      torch.from_numpy(pattab),
                      torch.from_numpy(offs.astype(np.int32)), n, mrs)
        bits = np.unpackbits(np.asarray(want, np.uint32).view(np.uint8),
                             bitorder="little")[:n]
        np.testing.assert_array_equal(
            np.unpackbits(got.numpy().view(np.uint8), bitorder="little")[:n],
            bits)
        got_any |= bool(bits.any())
    assert got_any


def test_one_gap_lookup_equals_jax(world, monkeypatch):
    """The GapOnSA rows and the per-pattern row ranges; every route (precomp
    reference, precomp-seed verification, forward and backward scan) has
    members."""
    w = world
    items = {"fwd": 0, "bwd": 0, "pcs": 0}
    # A2 on the host route, A2m (its count pass) on the device route: both
    # take A2's arguments
    real = {name: getattr(tlk, name) for name in ("scan", "scan_count",
                                                 "pcs")}

    def counting(name):
        def call(*args):
            if name == "pcs":
                items["pcs"] += args[4]
            else:
                items["fwd" if args[9] else "bwd"] += args[6]
            return real[name](*args)
        return call
    for name in real:
        monkeypatch.setattr(tlk, name, counting(name))
    js, ts = copy.deepcopy(w["jsearch"]), copy.deepcopy(w["tsearch"])
    want = jlk.one_gap_lookup_tpu(w["jidx"], np.asarray(w["jsa"].sa),
                                  w["jqs"], *w["jp"], js, w["jpc"], w["jcfg"])
    got = tlk.one_gap_lookup(_engine(w), w["tqs"], *w["tp"], ts, w["tpc"],
                             w["tcfg"])
    for f in ("position", "str_position", "length", "length2"):
        assert getattr(got, f).dtype == np.int32, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(ts.start_on_salist, js.start_on_salist)
    np.testing.assert_array_equal(ts.end_on_salist, js.end_on_salist)
    assert (got.length == 0).sum() > 0          # precomp references
    assert items["pcs"] > 0 and items["fwd"] > 0 and items["bwd"] > 0, items
    assert (got.length > 0).sum() > 0


def _identity_views(args, at):
    """``args`` with the tensors at positions ``at`` wrapped in identity
    views (offset 0, global length = local length)."""
    return [OffsetView(a, 0, a.shape[0]) if i in at else a
            for i, a in enumerate(args)]


@pytest.mark.parametrize("kernel", ["A2f", "A2b", "A3", "A2m"])
def test_plain_identity_views_change_nothing(world, kernel, monkeypatch):
    """The plain versions of A2 (each direction, on the host route), A3 and
    A2m (its count and write passes, on the device route), on the inputs of
    the lookup's own calls, give the same words when the corpus arrays come
    as explicit identity views: the views the sharded index reads through
    change nothing at offset 0."""
    w = world
    calls = {}
    real = {name: getattr(tlk, name) for name in ("scan", "scan_count",
                                                 "pcs")}
    ids = {"scan": lambda a: "A2f" if a[-1] else "A2b",
           "scan_count": lambda a: "A2m", "pcs": lambda a: "A3"}

    def hooking(name):
        def call(*args):
            calls[ids[name](args)] = args
            return real[name](*args)
        return call
    for name in real:
        monkeypatch.setattr(tlk, name, hooking(name))
    eng = (ReplicatedEngine if kernel == "A2m" else _HostRouteEngine)(
        w["tidx"], w["tcfg"])
    tlk.one_gap_lookup(eng, w["tqs"], *w["tp"], copy.deepcopy(w["tsearch"]),
                       w["tpc"], w["tcfg"])
    args = calls[kernel]
    key = tlk.device_row_key(len(w["tsearch"].gap), w["tidx"].reflen,
                             w["tcfg"].max_rule_span,
                             np.empty((0, 3), np.int64))

    def a2m_plain(*a):
        return torch.cat([tlk.scan_count_plain(*a).long(),
                          tlk.scan_rows_plain(*a, key)])
    plain, at = {"A3": (tlk.pcs_plain, (0,)),
                 "A2m": (a2m_plain, (0, 1, 2))}.get(
                     kernel, (tlk.scan_plain, (0, 1, 2)))
    want = plain(*args)
    got = plain(*_identity_views(args, at))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != 0).any()


# ---------------------------------------------------------------------------
# lookup1's rows on the device (kernel A2m) against the host route
# ---------------------------------------------------------------------------

def _subset(search, keep):
    """The one-gap search of the patterns ``keep`` (indices), in order."""
    D = len(search.gap)
    return dataclasses.replace(search, **{
        f.name: getattr(search, f.name)[keep].copy()
        for f in dataclasses.fields(search)
        if isinstance(getattr(search, f.name), np.ndarray)
        and len(getattr(search, f.name)) == D})


def _cfgs(w, mrs):
    """Both packages' configurations at span limit ``mrs``."""
    return [dataclasses.replace(c, max_rule_span=mrs,
                                max_rule_span_pattern=min(
                                    c.max_rule_span_pattern, mrs))
            for c in (w["jcfg"], w["tcfg"])]


def _lookup1(w, eng, search, cfg):
    """``one_gap_lookup`` on a copy of ``search`` -> (GapOnSA, the copy,
    the counters ``lookup1.items`` and ``lookup1.device_items`` grew by)."""
    s = copy.deepcopy(search)
    before = [kb.COUNTS[k] for k in ("lookup1.items", "lookup1.device_items")]
    got = tlk.one_gap_lookup(eng, w["tqs"], *w["tp"], s, w["tpc"], cfg)
    grew = [kb.COUNTS[k] - b for k, b in
            zip(("lookup1.items", "lookup1.device_items"), before)]
    return got, s, grew


def _same_lookup(got, want, s_got, s_want):
    for f in ("position", "str_position", "length", "length2"):
        assert getattr(got, f).dtype == np.int32, f
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(s_got.start_on_salist,
                                  s_want.start_on_salist)
    np.testing.assert_array_equal(s_got.end_on_salist, s_want.end_on_salist)


@pytest.mark.parametrize("mrs", [15, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_a2m_route_equals_the_host_route(world, mrs, seed, monkeypatch):
    """On a seeded random two thirds of the world's patterns, at the
    default span limit and a narrower one: the replicated engine's device
    route (A2m's plain versions on the CPU, the host-built rows' keys
    uploaded, every key sorted by ``torch.sort``) gives the host route's
    GapOnSA and row ranges and the JAX package's ``one_gap_lookup_tpu``'s;
    forward and backward scans, precomputed references and A3's rows all
    take part; ``lookup1.items`` counts A2's items on both routes,
    ``lookup1.device_items`` only on the device route."""
    w = world
    jcfg, tcfg = _cfgs(w, mrs)
    D = len(w["tsearch"].gap)
    keep = np.sort(np.random.default_rng(seed).permutation(D)[:2 * D // 3])
    js, ts = _subset(w["jsearch"], keep), _subset(w["tsearch"], keep)
    want = jlk.one_gap_lookup_tpu(w["jidx"], np.asarray(w["jsa"].sa),
                                  w["jqs"], *w["jp"], js, w["jpc"], jcfg)
    dirs = set()
    real = tlk.scan_rows

    def scan_rows(*args, **kw):
        dirs.update(t[3] for t in args[4])
        return real(*args, **kw)
    monkeypatch.setattr(tlk, "scan_rows", scan_rows)
    got, s_dev, grew = _lookup1(w, ReplicatedEngine(w["tidx"], tcfg), ts,
                                tcfg)
    host, s_host, grew_host = _lookup1(
        w, _HostRouteEngine(w["tidx"], tcfg), ts, tcfg)
    _same_lookup(got, want, s_dev, js)
    _same_lookup(host, want, s_host, js)
    assert dirs == {True, False}
    assert grew[0] == grew[1] == grew_host[0] > 0 and grew_host[1] == 0
    assert (got.length == 0).any() and (got.length > 0).any()


def _pc_ref_patterns(w):
    """The patterns whose lookup1 rows are one precomputed reference."""
    got = tlk.one_gap_lookup(_engine(w), w["tqs"], *w["tp"],
                             copy.deepcopy(w["tsearch"]), w["tpc"], w["tcfg"])
    return np.unique(got.position[got.length == 0])


@pytest.mark.parametrize("case", ["no_patterns", "no_scan", "no_hits"])
def test_a2m_route_on_empty_inputs(world, case):
    """No pattern at all; only precomputed references (no scan); scans
    whose span limit (2) keeps no move: both routes give the same GapOnSA
    and row ranges, and the device route runs only where there is a
    scan."""
    w = world
    tcfg = _cfgs(w, 2 if case == "no_hits" else 15)[1]
    search = w["tsearch"]
    if case == "no_patterns":
        search = _subset(search, np.arange(0))
    elif case == "no_scan":
        search = _subset(search, _pc_ref_patterns(w))
    got, s_dev, grew = _lookup1(w, ReplicatedEngine(w["tidx"], tcfg), search,
                                tcfg)
    want, s_host, _ = _lookup1(w, _HostRouteEngine(w["tidx"], tcfg), search,
                               tcfg)
    _same_lookup(got, want, s_dev, s_host)
    assert (got.length > 0).sum() == 0
    if case == "no_hits":
        assert grew[0] == grew[1] > 0
    else:
        assert grew == [0, 0]
    if case == "no_scan":
        assert len(got.position) == len(search.gap) > 0


def _scan_rows_args(w):
    """``lookup.scan_rows``' arguments on the world's lookup1, as the
    replicated engine builds them."""
    args = []
    real = tlk.scan_rows
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlk, "scan_rows",
                   lambda *a, **kw: args.append(a) or real(*a, **kw))
        tlk.one_gap_lookup(_engine(w), w["tqs"], *w["tp"],
                           copy.deepcopy(w["tsearch"]), w["tpc"], w["tcfg"])
    return args[0]


@pytest.mark.parametrize("part", ["host_keys", "forward", "backward",
                                  "all"])
def test_scan_rows_sorts_every_key_once(world, part, monkeypatch):
    """``lookup.scan_rows`` on the world's scans, with only the host-built
    keys, only the forward or the backward scan, or all of them: each
    scan's write pass runs once over its whole count, every key goes
    through one sort, and the columns are the plain keys (the host keys
    and ``scan_rows_plain``'s) sorted and unpacked, as int32."""
    w = world
    args = list(_scan_rows_args(w))
    scans = args[4]
    assert {t[3] for t in scans} == {True, False} and len(args[5]) > 0
    if part != "all":
        args[4] = [t for t in scans if part != "host_keys"
                   and t[3] == (part == "forward")]
    key = args[6]
    want = np.concatenate([args[5]] + [
        tlk.scan_rows_plain(*args[:4], *t[:3], *args[7:9], t[3],
                            key).numpy() for t in args[4]])
    want = np.stack(key.unpack(np.sort(want)))
    calls = {"scan_keys": [], "sort_keys": []}
    for name in calls:
        real = getattr(tlk, name)
        monkeypatch.setattr(tlk, name, lambda *a, _n=name, _r=real: (
            calls[_n].append(a) or _r(*a)))
    got = tlk.scan_rows(*args)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert [a[-1].shape[0] for a in calls["scan_keys"]] == [
        int(tlk.scan_count_plain(*args[:4], *t[:3], *args[7:9],
                                 t[3]).sum()) for t in args[4]]
    assert len(calls["sort_keys"]) == 1
    assert calls["sort_keys"][0][0].shape[0] == got.shape[1]
    assert (got.shape[1] > len(args[5])) == (part != "host_keys")


def test_row_key_round_trip_order_and_widths():
    """``RowKey``: pack and unpack round-trip (numpy and torch), sorting the
    keys of unique rows gives the lexsort's order (negative starts and
    starts past the corpus included), on the host route too
    (``_sort_rows``), and a layout past 63 bits is refused, on either
    route."""
    rng = np.random.default_rng(9)
    rows = np.unique(np.stack([rng.integers(0, 5000, 20000),
                               rng.integers(-14, 1 << 30, 20000),
                               rng.integers(0, 15, 20000)], axis=1), axis=0)
    rows[:50, 1] = rng.integers(-14, 0, 50)
    rows = np.unique(rows, axis=0)[rng.permutation(len(rows))]
    key = tlk.RowKey.fit(5000, rows[:, 1].min(), rows[:, 1].max(), 14)
    assert key.sh_len == 4 and key.bias == 14
    keys = key.pack(rows[:, 0], rows[:, 1], rows[:, 2])
    for back in (key.unpack(keys),
                 [t.numpy() for t in key.unpack(torch.from_numpy(keys))]):
        np.testing.assert_array_equal(np.stack(back, axis=1), rows)
    order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
    np.testing.assert_array_equal(np.sort(keys), keys[order])
    np.testing.assert_array_equal(np.stack(tlk._sort_rows([rows], 5000)),
                                  rows[order].T)
    # widths: 31 + 32 + 4 bits do not fit, 20 + 32 + 4 do
    with pytest.raises(ValueError, match="bits"):
        tlk.RowKey.fit(2**31, -16, 2**31, 15)
    with pytest.raises(ValueError, match="bits"):
        tlk._sort_rows([rows], 2**31)
    assert tlk.RowKey.fit(2**20, -16, 2**31, 15).bits == 56
    with pytest.raises(ValueError, match="bits"):
        tlk.device_row_key(2**40, 1000, 15, rows)


@pytest.mark.parametrize("which", ["sharded", "localdp", "scan_cols"])
def test_other_engines_keep_the_host_route(world, which):
    """``ShardedEngine``, ``LocalDPEngine`` and ``scan_cols`` declare no
    device rows: lookup1 runs A2's route (``scan_expanded``, the hits
    expanded on the host) on them, never ``scan_rows``, counts their items
    in ``lookup1.items`` and none in ``lookup1.device_items``, and gives the
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
    assert not getattr(eng, "scan_rows_on_device", False)
    calls = []
    real = eng.scan_expanded
    eng.scan_expanded = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    eng.scan_rows = None          # any call would raise
    got, s, grew = _lookup1(w, eng, w["tsearch"], cfg)
    want, s_want, _ = _lookup1(w, _engine(w), w["tsearch"], cfg)
    assert calls and grew[0] > 0 and grew[1] == 0
    _same_lookup(got, want, s, s_want)
