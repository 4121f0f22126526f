"""lookup1 in the port: the item expansion, kernel A2's plain version (both
directions) against the JAX ``_scan_batch_exp`` with the fused gap check and
its candidate masks (``gap=False``) against ``do_gap=False``, the window
words that decide the candidates (what the scans' bounds count), kernel A3's
plain version against ``_pcs_batch_exp`` (also on the layouts of its warp's
item resolution: one pattern, runs of empty patterns, warps over more than
32 patterns), the model of that resolution (``tools/reads.py``
``pcs_rounds``), and ``one_gap_lookup`` against the JAX package's
``one_gap_lookup_tpu``, bit for bit."""

import copy
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
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
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
        tpc=tpcx.precompute(ReplicatedEngine(tidx, tcfg), tsrc, tsa, tcfg))


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
    real_scan, real_pcs = tlk.scan, tlk.pcs

    def scan(*args):
        items["fwd" if args[-1] else "bwd"] += args[6]
        return real_scan(*args)

    def pcs(*args):
        items["pcs"] += args[4]
        return real_pcs(*args)
    monkeypatch.setattr(tlk, "scan", scan)
    monkeypatch.setattr(tlk, "pcs", pcs)
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


@pytest.mark.parametrize("kernel", ["A2f", "A2b", "A3"])
def test_plain_identity_views_change_nothing(world, kernel, monkeypatch):
    """The plain versions of A2 (each direction) and A3, on the inputs of
    the lookup's own calls, give the same words when the corpus arrays come
    as explicit identity views: the views the sharded index reads through
    change nothing at offset 0."""
    w = world
    calls = {}
    real_scan, real_pcs = tlk.scan, tlk.pcs

    def scan(*args):
        calls["A2f" if args[-1] else "A2b"] = args
        return real_scan(*args)

    def pcs(*args):
        calls["A3"] = args
        return real_pcs(*args)
    monkeypatch.setattr(tlk, "scan", scan)
    monkeypatch.setattr(tlk, "pcs", pcs)
    tlk.one_gap_lookup(_engine(w), w["tqs"], *w["tp"],
                       copy.deepcopy(w["tsearch"]), w["tpc"], w["tcfg"])
    args = calls[kernel]
    plain, at = ((tlk.pcs_plain, (0,)) if kernel == "A3"
                 else (tlk.scan_plain, (0, 1, 2)))
    want = plain(*args)
    got = plain(*_identity_views(args, at))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != 0).any()
