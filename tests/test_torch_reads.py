"""The words the kernels' bounds count (``cgx_tpu_torch.tools.reads``): for the
fused gap check, A5's body, A6's, A7's and A8's bodies, A10's probes, the
refinement (A1, B2r) and the verification (A3, B3p, C1p), the words each
counter marks as needed decide the plain version's output (A2m's bound:
A2's words and one key a row kept). Redrawing every
other word of the index arrays (from the same array, so that the words stay
plausible) changes no output, so the bounds, which count only the needed
words, count all that the functions need; and the needed words are fewer
than the gathers.  The round form's count (B2s, B2t) equals a brute-force
count of the same words, lane by lane and node by node."""

import dataclasses
import pathlib
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.extract import device as xdev  # noqa: E402
from cgx_tpu_torch.features import maxlex as ml  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.parallel import sharded as shx  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import lookup, passes  # noqa: E402
from cgx_tpu_torch.tools import gather_probe as gp  # noqa: E402
from cgx_tpu_torch.tools import reads  # noqa: E402
from cgx_tpu_torch.utils.views import take  # noqa: E402


@pytest.fixture(scope="module", params=["real", "hard"])
def index(request):
    """The port's index over a fixture corpus, on the CPU."""
    if request.param == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        f, e = f.split("\n"), e.split("\n")
    else:
        d = request.getfixturevalue("real_fixture")
        f, e, a = (tcp.read_lines(str(d / n))
                   for n in ("corpus.f", "corpus.e", "corpus.a"))
        lex_t = tcp.read_tokens(str(d / "lex.txt"))
    src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    return tic.build_index(src, tgt, tsab.build_index(src.str_),
                           tcp.load_alignment_fast(a, src, tgt),
                           tcp.load_lex_table(lex_t, src.vocab, tgt.vocab),
                           ExtractorConfig(), "cpu")


def _arrays(ix):
    return {"refstr": ix.refstr_padded, "rlp": ix.rlp, "lr_tar": ix.lr_tar}


def _redrawn(rng, arrays, need, rows):
    """The arrays with every word that no item of ``rows`` needs redrawn
    from the same array."""
    out = {}
    for name, arr in arrays.items():
        a = arr.numpy()
        b = a[rng.integers(0, len(a), len(a))]
        if name in need:
            slots, keep = need[name]
            kept = slots[rows][keep[rows]].numpy()
            b[kept] = a[kept]
        out[name] = torch.from_numpy(b)
    return out


def _starts(rng, ix, n):
    """Corpus positions: both corpus ends and random ones."""
    r = int(ix.reflen)
    return torch.from_numpy(np.concatenate(
        [[0, 1, r - 2, r - 1], rng.integers(0, r, n - 4)]).astype(np.int32))


def _check(rng, arrays, need, n, fn, batch=4, rounds=8, pool=None):
    """``fn(arrays, rows)`` is unchanged on every batch of rows when the
    words no row of the batch needs are redrawn; half of each batch from
    ``pool`` (row indices) where one is given."""
    for _ in range(rounds):
        if pool is None or len(pool) < batch:
            rows = rng.choice(n, batch, replace=False)
        else:
            rows = np.unique(np.concatenate([
                rng.choice(pool, batch // 2, replace=False),
                rng.choice(n, batch - batch // 2, replace=False)]))
        rows = torch.from_numpy(rows)
        want = fn(arrays, rows)
        got = fn(_redrawn(rng, arrays, need, rows), rows)
        assert torch.equal(got, want)


@pytest.mark.parametrize("grow_right", [True, False])
def test_gap_need_decides_the_mask(index, grow_right):
    rng = np.random.default_rng(11 if grow_right else 12)
    arrays = _arrays(index)
    n = 400
    fixed = _starts(rng, index, n)
    for mrs, base_off in ((15, 0), (15, 1), (8, 0), (2, 0)):
        need = reads.gap_need(arrays["rlp"], arrays["lr_tar"], fixed,
                              base_off, mrs, grow_right)

        def fn(a, rows):
            return lookup.gap_check_grow(a["rlp"], a["lr_tar"], fixed[rows],
                                         base_off, mrs, grow_right)
        _check(rng, arrays, need, n, fn)
        mask = fn(arrays, torch.arange(n))
        assert (need["ok"] == False).any()                 # noqa: E712
        if mrs > 2:
            assert need["ok"].any() and mask.any()
        words, ok = reads.gap_reads(arrays["rlp"], arrays["lr_tar"], fixed,
                                    base_off, mrs, grow_right)
        assert ok == int(need["ok"].sum())
        # the per-thread form reads mrs + 2 RLP and 16 lr_tar words
        assert n <= words < n * (mrs + 2 + lookup.MMOV)


def test_two_need_decides_the_word(index):
    rng = np.random.default_rng(13)
    arrays = _arrays(index)
    n = 400
    pstart = _starts(rng, index, n)
    plen = torch.from_numpy(rng.integers(1, 6, n).astype(np.int32))
    for mrs in (15, 8, 2):
        need = reads.two_need(*arrays.values(), pstart, plen, mrs, 1)

        def fn(a, rows):
            return lookup.two_packed_plain(*a.values(), pstart[rows],
                                           plen[rows], mrs, 1)
        _check(rng, arrays, need, n, fn)
        words, ok = reads.two_reads(*arrays.values(), pstart, plen, mrs, 1)
        # the gap-0 token and the gap check's word 0 at least; the
        # per-thread form read 17 corpus and mrs + 18 gap-check words
        assert 2 * n <= words < n * (17 + mrs + 18)
        if mrs == 2:      # no move fits the span: no move word is needed
            assert not need["refstr"][1][:, 1:].any()
        else:
            assert need["refstr"][1][:, 1:].any() and ok > 0


@pytest.mark.parametrize("fwd", [True, False])
def test_scan_rows_reads_count_a2m_keys(index, fwd):
    """A2m's bound counts A2's words (``scan_reads``, unchanged) and one
    key for each move it keeps: as many as its write pass writes
    (``scan_rows_plain``) over the same items, which move the words of
    their corpus windows so that moves match."""
    rng = np.random.default_rng(21 if fwd else 22)
    arrays = list(_arrays(index).values())
    ref = index.refstr_padded.numpy()
    D, reflen, mgs = 200, int(index.reflen), 1
    counts = rng.integers(1, 12, D)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n = int(offs[-1])
    lo = rng.integers(0, reflen - 12, D)
    sl, el = rng.integers(1, 4, D), rng.integers(1, 4, D)
    g = index.sa.numpy()[lo].astype(np.int64)
    p0 = g + sl + mgs if fwd else g - 1 - mgs
    toks = [ref[np.clip(p0 + k if fwd else p0 - k, 0, len(ref) - 1)]
            for k in range(3)]
    pattab = torch.from_numpy(np.stack(
        [lo, sl, el] + toks + [np.arange(D), 0 * lo], axis=1).astype(np.int32))
    offs = torch.from_numpy(offs)
    f, tx = lookup._expand(pattab, offs, n)
    items = (take(index.sa, f[:, 0] + tx), f[:, 1], f[:, 2], f[:, 3:6])
    for mrs in (15, 8):
        key = lookup.device_row_key(D, reflen, mrs, np.empty((0, 3)))
        kept = lookup.scan_rows_plain(*arrays, index.sa, pattab, offs, n,
                                      mrs, mgs, fwd, key)
        got = reads.scan_rows_reads(*arrays, *items, mrs, mgs, fwd)
        assert got[:4] == reads.scan_reads(*arrays, *items, mrs, mgs, fwd)
        assert got[4] == kept.shape[0] > 0


@pytest.mark.parametrize("mrs,msym", [(15, 5), (8, 3), (2, 2)])
def test_contig_need_decides_the_output(index, mrs, msym):
    rng = np.random.default_rng(mrs)
    arrays = _arrays(index)
    n = 400
    cs = _starts(rng, index, n)
    lm = torch.from_numpy(rng.integers(1, mrs + 1, n).astype(np.int32))
    need = reads.contig_need(*arrays.values(), cs, lm, mrs, msym)

    def fn(a, rows):
        return xdev.contig_pos_plain(*a.values(), cs[rows], lm[rows], mrs,
                                     msym)
    _check(rng, arrays, need, n, fn, rounds=12)
    out = fn(arrays, torch.arange(n))
    assert (out[1] & 1).any()
    if mrs > 2:
        assert (out[3] & 1).any() or (out[5] & 1).any()
        assert int(need["steps"].sum()) > 0


def _gap_items(rng, ix, n, mrs):
    """aXb(Xc) occurrences at corpus positions (``_starts``): a and b (and
    c) 1-3 tokens, the span mostly within the span limit, so that the
    growth steps run."""
    cs = _starts(rng, ix, n)
    sl, el, cl = (rng.integers(1, 4, n) for _ in range(3))
    fe = sl + el + rng.integers(0, max(mrs - 2, 1), n) - 1
    se = fe + 1 + cl + rng.integers(0, 4, n)
    return [cs] + [torch.from_numpy(x.astype(np.int32))
                   for x in (fe, sl, el, se, cl)]


@pytest.mark.parametrize("mrs,msym", [(15, 5), (8, 5), (15, 3), (4, 4)])
def test_onegap_need_decides_the_output(index, mrs, msym):
    """Half of each batch from the items whose sides reach their X gap
    check (about 15% of random items at mrs 15), where the side windows
    and the whole-span checks decide the grown families."""
    rng = np.random.default_rng(20 + mrs + msym)
    arrays = _arrays(index)
    n = 2000
    cs, fe, sl, el, _, _ = _gap_items(rng, index, n, mrs)
    need = reads.onegap_need(*arrays.values(), cs, fe, sl, el, mrs, msym)

    def fn(a, rows):
        return xdev.onegap_plain(*a.values(), cs[rows], fe[rows], sl[rows],
                                 el[rows], mrs, msym)
    out = fn(arrays, torch.arange(n))
    body: dict = {}
    xdev._onegap_body(*arrays.values(), cs, fe, sl, el, mrs, msym, body)
    checked = sum(body[f"{s}_run"] & body[f"{s}_has"] & body[f"{s}_al"]
                  for s in "lr").any(dim=1)
    pool = torch.nonzero(checked).flatten().numpy()
    _check(rng, arrays, need, n, fn, rounds=16, pool=pool)
    assert (out[1] & 1).any()
    words, steps = reads.onegap_reads(*arrays.values(), cs, fe, sl, el, mrs,
                                      msym)
    # each item's own words: the spans' words at least; the body gathers
    # up to 16 + 16 + 2 + 56 RLP/refstr words and 16 + 6 x 15 lr_tar words
    # an item; the launch's words, each once, at most their sum
    per_item = _per_row(need, [a for a in _arrays(index) if a in need])
    assert 2 * n <= per_item < n * (90 + 106)
    assert 0 < words <= per_item
    if msym >= 4:
        assert (out[3] & 1).any() or (out[5] & 1).any()
        assert 0 < steps <= 2 * xdev.IMAX * n


@pytest.mark.parametrize("mrs", [15, 8, 2])
def test_twogap_need_decides_the_output(index, mrs):
    rng = np.random.default_rng(30 + mrs)
    arrays = _arrays(index)
    n = 400
    cs, fe, sl, el, se, cl = _gap_items(rng, index, n, mrs)
    need = reads.twogap_need(*arrays.values(), cs, fe, se, sl, el, cl, mrs)

    def fn(a, rows):
        return xdev.twogap_plain(*a.values(), cs[rows], fe[rows], se[rows],
                                 sl[rows], el[rows], cl[rows], mrs)
    _check(rng, arrays, need, n, fn, rounds=12)
    words, valid = reads.twogap_reads(*arrays.values(), cs, fe, se, sl, el,
                                      cl, mrs)
    assert valid == int((fn(arrays, torch.arange(n))[1] & 1).sum())
    # the whole span's word 0 and anchor at least; the body gathers three
    # 16-word spans, three anchors and 16 lr_tar words an item
    assert n <= words < n * (3 * 16 + 3 + 16)
    if mrs == 15:
        assert valid > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maxlex_need_decides_the_features(index, seed):
    """A10's probes over the index's own lexical table as row ranges, for
    synthetic rules: the source ids of its table (and NULL, unknown ids and
    pads), target spans over its target corpus.  Redrawing every lt, lnv1
    and lnv2 word that no rule of a batch needs changes no feature bit."""
    rng = np.random.default_rng(seed)
    lex = types.SimpleNamespace(lex_key=index.lex_key,
                                lex_val1_host=index.lex_val1_host,
                                lex_val2_host=index.lex_val2_host,
                                device=torch.device("cpu"),
                                maxlex_tables=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ml, "DEV_DENSE_LIMIT", 0)
        mode, (rs, re, lt, lnv1, lnv2, steps) = ml.lex_tables(lex)
    assert mode == "range"
    T = 300
    ns = rs.shape[0]
    nsrc = rng.integers(0, ml.SRCW + 1, T)
    # mostly sources with rows, some NULL (-1) and unknown ids
    sp = rng.integers(-1, ns + 2, (T, ml.SRCW))
    sp[np.arange(ml.SRCW)[None, :] >= nsrc[:, None]] = -99
    tgt_str = index.tgt_str
    t0 = rng.integers(0, tgt_str.shape[0] + 4, T)
    tend = rng.integers(0, ml.TPOSW, T)
    g1 = np.where(rng.random(T) < 0.5, -1, rng.integers(0, 8, T))
    g11 = np.where(g1 < 0, -1, g1 + rng.integers(0, 4, T))
    cols = [torch.from_numpy(np.ascontiguousarray(c, np.int32))
            for c in (sp, t0, tend, g1, g11, np.full(T, -1), np.full(T, -1))]
    arrays = {"lt": lt, "lnv1": lnv1, "lnv2": lnv2}
    need = reads.maxlex_need(rs, re, lt, lnv1, lnv2, tgt_str, *cols, steps)

    def fn(a, rows):
        out = ml.accum_range_plain(rs, re, a["lt"], a["lnv1"], a["lnv2"],
                                   tgt_str, 99.0, *(c[rows] for c in cols),
                                   steps)
        return torch.stack(out).view(torch.int32)
    _check(rng, arrays, need, T, fn, batch=8, rounds=12)
    words, searches, bisect = reads.maxlex_reads(rs, re, lt, lnv1, lnv2,
                                                 tgt_str, *cols, steps)
    # present pairs were found, and each search reads at most
    # ceil(log2(rows + 1)) path words and its found word
    assert bool(need["lnv1"][1].any()) and bool(need["lnv2"][1].any())
    assert 0 < searches <= T * 101
    assert bisect <= searches * steps
    assert words < 2 * (ml.SRCW + 1) * T + (bisect + searches) * 3


@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_lcp_need_decides_the_passes(index, which):
    """B1's passes over the index's SA and LCP tree, the padded corpus as the
    query tokens (a few made OOV): lanes at random corpus positions with the
    suffix to their sentence end, and pass 2's items from pass 1's windows.
    Redrawing every corpus, SA, LCP-tree and query word that no lane of a
    batch needs changes no output; the needed words are fewer than the
    plain version's gathers, and the warp body's chain of read rounds is
    shorter than the sequential one's dependent reads."""
    rng = np.random.default_rng(21 if which == "pass1" else 22)
    lcpl, lcpr = index.lcp_tables()
    ref = index.refstr_padded
    reflen = int(index.reflen)
    qtok = ref.clone()
    sep = torch.nonzero(ref[:reflen] <= 1).flatten()
    toks = torch.from_numpy(rng.integers(0, reflen - 1, 200).astype(np.int32))
    toks = toks[ref[toks.long()] > 1]
    nxt = sep[torch.searchsorted(sep, toks)]
    sls = (nxt - toks).to(torch.int32)
    qtok[torch.from_numpy(rng.choice(reflen, 20, replace=False))] = -1
    arrays = {"refstr": ref, "sa": index.sa, "lcpl": lcpl, "lcpr": lcpr,
              "qtok": qtok}
    p1 = passes.pass1_plain(ref, index.sa, lcpl, lcpr, qtok, toks, sls,
                            reflen)
    if which == "pass1":
        lanes = (toks, sls)
        n = len(toks)

        def fn(a, rows):
            return torch.stack(passes.pass1_plain(
                a["refstr"], a["sa"], a["lcpl"], a["lcpr"], a["qtok"],
                toks[rows], sls[rows], reflen))
        need = reads.lcp_need(ref, index.sa, lcpl, lcpr, qtok, *lanes,
                              reflen)
        args = (*lanes, reflen)
    else:
        lm = p1[0].numpy()
        hit = np.flatnonzero(lm > 1)
        tok_i = np.repeat(hit, lm[hit] - 1)
        match = np.concatenate([np.arange(2, m + 1) for m in lm[hit]])
        cols = [toks[tok_i], torch.from_numpy(match.astype(np.int32)),
                *(p1[k][tok_i] for k in (4, 3, 5))]
        n = len(tok_i)

        def fn(a, rows):
            return torch.stack(passes.pass2_plain(
                a["refstr"], a["sa"], a["lcpl"], a["lcpr"], a["qtok"],
                *(c[rows] for c in cols)))
        need = reads.lcp_need(ref, index.sa, lcpl, lcpr, qtok, *cols)
        args = cols
    assert n > 20
    _check(rng, arrays, need, n, fn, batch=6, rounds=10)
    words, steps, chain_max, chain_mean = reads.lcp_reads(
        ref, index.sa, lcpl, lcpr, qtok, *args)
    # each step needs at most 2 skip words, an SA word and the compare's
    assert steps > n and words < 6 * steps + n * 70
    # the warp body: one round a 5 search steps, one a compare, one a 4
    # steps of the longer walk; the one-thread body ~2 dependent reads a
    # step plus both walks one after the other
    assert 0 < chain_mean < 2 * float(need["steps"].double().mean())
    assert chain_max >= chain_mean


def _dense_rules(rng, index, T: int):
    """The index's lexical table as dense [ns, nt] tables (L1, L2) and T
    synthetic rules' columns over them: NULL, unknown and pad source ids,
    target spans over the index's target corpus."""
    lex = types.SimpleNamespace(lex_key=index.lex_key,
                                lex_val1_host=index.lex_val1_host,
                                lex_val2_host=index.lex_val2_host,
                                device=torch.device("cpu"),
                                maxlex_tables=None)
    mode, (L1, L2) = ml.lex_tables(lex)
    assert mode == "dense"
    ns = L1.shape[0]
    nsrc = rng.integers(0, ml.SRCW + 1, T)
    sp = rng.integers(-1, ns + 2, (T, ml.SRCW))
    sp[np.arange(ml.SRCW)[None, :] >= nsrc[:, None]] = -99
    t0 = rng.integers(0, index.tgt_str.shape[0] + 4, T)
    tend = rng.integers(0, ml.TPOSW, T)
    g1 = np.where(rng.random(T) < 0.5, -1, rng.integers(0, 8, T))
    g11 = np.where(g1 < 0, -1, g1 + rng.integers(0, 4, T))
    cols = [torch.from_numpy(np.ascontiguousarray(c, np.int32))
            for c in (sp, t0, tend, g1, g11, np.full(T, -1), np.full(T, -1))]
    return L1, L2, cols


@pytest.mark.parametrize("seed", [0, 1])
def test_maxlex_dense_need_decides_the_features(index, seed):
    """A9's probes over the index's own lexical table as dense [ns, nt]
    tables, for synthetic rules (NULL, unknown and pad source ids, target
    spans over the index's target corpus).  Redrawing every L1 and L2 word
    that no rule of a batch needs changes no feature bit."""
    rng = np.random.default_rng(seed)
    T = 300
    L1, L2, cols = _dense_rules(rng, index, T)
    ns, nt = L1.shape
    tgt_str = index.tgt_str
    arrays = {"L1": L1.reshape(-1), "L2": L2.reshape(-1)}
    need = reads.maxlex_dense_need(L1, L2, tgt_str, *cols)

    def fn(a, rows):
        out = ml.accum_dense_plain(a["L1"].view(ns, nt), a["L2"].view(ns, nt),
                                   tgt_str, 99.0, *(c[rows] for c in cols))
        return torch.stack(out).view(torch.int32)
    _check(rng, arrays, need, T, fn, batch=8, rounds=12)
    words = reads.maxlex_dense_reads(L1, L2, tgt_str, *cols)
    # at most 2 x 5 x 16 probes, 5 NULL columns and 16 NULL rows a rule
    assert 0 < words <= T * (2 * ml.SRCW * ml.TPOSW + ml.SRCW + ml.TPOSW)


def _per_row(need, arrays) -> int:
    """Each row's distinct kept slots, summed over the rows."""
    total = 0
    for a in arrays:
        slots, keep = need[a]
        for row, k in zip(slots, keep):
            total += len(set(row[k].tolist()))
    return total


@pytest.mark.parametrize("kind", ["A9", "B1"])
def test_count_moves_each_shared_word_once(index, kind):
    """The bounds count a word that several rules or lanes read once: A9's
    rules probe the same small tables, B1's lanes start at the same root
    and walk the same upper levels of the LCP tree.  The count is the
    distinct kept slots over the whole launch, at most every word of the
    arrays, and fewer than each row's own distinct slots summed."""
    rng = np.random.default_rng(31)
    if kind == "A9":
        L1, L2, cols = _dense_rules(rng, index, 3000)
        need = reads.maxlex_dense_need(L1, L2, index.tgt_str, *cols)
        words = reads.maxlex_dense_reads(L1, L2, index.tgt_str, *cols)
        arrays, size = ("L1", "L2"), L1.numel() + L2.numel()
    else:
        lcpl, lcpr = index.lcp_tables()
        ref, reflen = index.refstr_padded, int(index.reflen)
        toks = torch.arange(reflen - 1, dtype=torch.int32)
        toks = toks[ref[toks.long()] > 1]
        sep = torch.nonzero(ref[:reflen] <= 1).flatten()
        sls = (sep[torch.searchsorted(sep, toks)] - toks).to(torch.int32)
        args = (ref, index.sa, lcpl, lcpr, ref, toks, sls, reflen)
        need = reads.lcp_need(*args)
        words = reads.lcp_reads(*args)[0]
        arrays = [a for a in reads.LCP_ARRAYS if a in need]
        size = sum(x.shape[0] for x in (ref, index.sa, lcpl, lcpr, ref))
    union = sum(len(set(need[a][0][need[a][1]].tolist())) for a in arrays)
    assert 0 < words == union <= size
    assert words < _per_row(need, arrays)


def test_dp_reads_count_a_word_of_both_halves_once(index):
    """B4's words: B1's pass 1 on the lanes and A6's body on the items,
    each array's distinct slots over both halves: at least each half's own
    count, at most their sum, and the corpus words that both read once."""
    rng = np.random.default_rng(32)
    lcpl, lcpr = index.lcp_tables()
    ref, reflen = index.refstr_padded, int(index.reflen)
    toks = torch.from_numpy(rng.integers(0, reflen - 1, 300).astype(np.int32))
    toks = toks[ref[toks.long()] > 1]
    sep = torch.nonzero(ref[:reflen] <= 1).flatten()
    sls = (sep[torch.searchsorted(sep, toks)] - toks).to(torch.int32)
    cs = _starts(rng, index, 200)
    lm = torch.from_numpy(rng.integers(1, 8, 200).astype(np.int32))
    lane_args = (ref, index.sa, lcpl, lcpr, ref, toks, sls, reflen)
    words, lsteps, steps, inner, chain_max, chain_mean = reads.dp_reads(
        *lane_args, cs, lm, index.rlp, index.lr_tar, 15, 5)
    lw, ls, lmax, lmean = reads.lcp_reads(*lane_args)
    cw, cst, cin = reads.contig_reads(ref, index.rlp, index.lr_tar, cs, lm,
                                      15, 5)
    assert (lsteps, steps, inner, chain_max, chain_mean) == (
        ls, cst, cin, lmax, lmean)
    lanes = reads.lcp_need(*lane_args)
    items = reads.contig_need(ref, index.rlp, index.lr_tar, cs, lm, 15, 5)
    shared = (set(lanes["refstr"][0][lanes["refstr"][1]].tolist())
              & set(items["refstr"][0][items["refstr"][1]].tolist()))
    assert max(lw, cw) <= words == lw + cw - len(shared)


CSRC = pathlib.Path(__file__).parent.parent / "cgx_tpu_torch" / "csrc"


@pytest.mark.parametrize("source,name,value", [
    ("scan.cu", "kPcsPivots", reads.PCS_PIVOTS),
    ("scan.cu", "kPcsWindow", reads.PCS_WINDOW),
    ("lcp.cuh", "kSearchLevels", reads.SEARCH_LEVELS),
    ("lcp.cuh", "kWalkLevels", reads.WALK_LEVELS),
    ("sharded.cu", "kShardRowBytes", shx.B2R_SHARD_ROW_BYTES),
    ("sharded.cu", "kShardRowsLimit", shx.B2R_SHARED_BYTES),
    ("sharded.cu", "kTreeLevels", shx.TREE_LEVELS),
    ("sharded.cu", "kTreeNodes", shx.TREE_NODES),
    ("sort.cu", "kTile", lookup.SORT_TILE),
    ("probe.cu", "kWin", gp.W),
    ("probe.cu", "kWarps", gp.WARPS),
    ("probe.cu", "kInFlight", gp.IN_FLIGHT),
    ("probe.cu", "kBlocksPerSM", gp.BLOCKS_PER_SM)])
def test_models_use_the_kernels_constants(source, name, value):
    """The counters' models of the warp bodies (``pcs_rounds``, ``lcp_need``),
    B2r's shard-row check in its wrapper (``check_b2r_shards``), the round
    form's tree step (31 nodes over 5 levels, in B2s and B2t's plain
    versions and ``refine_round_reads``) and the
    probe's grid and walk (``gather_probe.grid``, and its model in
    ``tests/test_torch_probe.py``) use the kernels' own constants."""
    text = (CSRC / source).read_text(encoding="utf-8")
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert found == [str(value)]


def _lanes(rng, ix, n, d0):
    """Refinement lanes over the index: query tokens the padded corpus (a
    few replaced), each lane at a corpus position with the rest of its
    sentence as its query, the whole SA at d0 0 or its own interval at d0
    (from the plain version); some lanes empty."""
    ref = ix.refstr_padded
    reflen = int(ix.reflen)
    qtok = ref.clone()
    qtok[torch.from_numpy(rng.choice(reflen, 10, replace=False))] = 0
    toks = torch.from_numpy(rng.integers(0, reflen - 1, n).astype(np.int32))
    sep = torch.nonzero(ref[:reflen] <= 1).flatten()
    sls = (sep[torch.searchsorted(sep, toks)] - toks).to(torch.int32)
    lo = torch.zeros(n, dtype=torch.int32)
    hi = torch.full((n,), reflen, dtype=torch.int32)
    if d0:
        _, _, lo, hi = passes.refine_chunk_plain(ix.sa, ref, qtok, toks, sls,
                                                 lo, hi, 0, d0)
    lo[:5] = hi[:5] = torch.from_numpy(rng.integers(0, reflen, 5)
                                       .astype(np.int32))
    return qtok, toks, sls, lo, hi


@pytest.fixture(scope="module")
def sharded(index):
    """The index's corpus again as a sharded index of 3 shards."""
    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
    from tools.make_bigcorpus import make_hard_corpus
    f, e, a, _ = make_hard_corpus(400, vocab=200, seed=11)
    src, tgt = (tcp.load_source_corpus(f.split("\n")),
                tcp.load_target_corpus(e.split("\n")))
    sidx = shx.build_sharded_index(src, tgt, tsab.build_index(src.str_),
                                   tcp.load_alignment_fast(a, src, tgt),
                                   ExtractorConfig(), 3, "cpu")
    rep = tic.build_index(src, tgt, tsab.build_index(src.str_),
                          tcp.load_alignment_fast(a, src, tgt),
                          tcp.load_lex_table([], src.vocab, tgt.vocab),
                          ExtractorConfig(), "cpu")
    return sidx, rep


def _slices(sidx, name):
    return torch.stack(sidx.sa_l if name == "sa" else sidx.ref_l).reshape(-1)


@pytest.mark.parametrize("kernel", ["A1", "B2r"])
@pytest.mark.parametrize("d0", [0, 2])
def test_refine_need_decides_the_refinement(index, sharded, kernel, d0):
    """The refinement's binary lower bounds (A1 on the replicated index,
    B2r on 3 shards of the same kind of corpus): redrawing every SA,
    corpus and query word that no lane of a batch needs changes no output,
    and redrawing the needed ones changes some; the needed words are fewer
    than one SA word and one token a bisection step, and B2r's meta words
    are those of the shards it reads."""
    rng = np.random.default_rng(50 + d0 + (kernel == "B2r"))
    n, depths = 60, 4
    if kernel == "A1":
        ix = index
        qtok, toks, sls, lo, hi = _lanes(rng, ix, n, d0)
        arrays = {"sa": ix.sa, "refstr": ix.refstr_padded, "qtok": qtok}

        def fn(a, rows):
            return torch.stack(passes.refine_chunk_plain(
                a["sa"], a["refstr"], a["qtok"], toks[rows], sls[rows],
                lo[rows], hi[rows], d0, depths)[:2])
        args = (ix.sa, ix.refstr_padded, qtok, toks, sls, lo, hi, d0, depths)
    else:
        sidx, rep = sharded
        qtok, toks, sls, lo, hi = _lanes(rng, rep, n, d0)
        arrays = {"sa": _slices(sidx, "sa"), "refstr": _slices(sidx, "ref"),
                  "qtok": qtok}

        def fn(a, rows):
            S = sidx.S
            t = dataclasses.replace(
                sidx, sa_l=list(a["sa"].view(S, -1)),
                ref_l=list(a["refstr"].view(S, -1)), _tables=None)
            return torch.stack(shx.refine_sharded_plain(
                t, a["qtok"], toks[rows], sls[rows], lo[rows], hi[rows], d0,
                depths)[:2])
        args = (sidx, qtok, toks, sls, lo, hi, d0, depths)
    need = reads.refine_need(*args)
    _check(rng, arrays, need, n, fn, batch=6, rounds=8)
    rows = torch.arange(n)
    flipped = {}
    for name, arr in arrays.items():
        a = arr.clone()
        slots, keep = need[name]
        a[slots[keep]] += 1
        flipped[name] = a
    assert not torch.equal(fn(flipped, rows), fn(arrays, rows))
    words, steps = reads.refine_reads(*args)
    assert steps == int(need["steps"].sum()) > n
    assert 0 < words < 2 * steps + n * depths
    if kernel == "B2r":
        meta = reads.count(need, arrays=("rmeta", "smeta"))
        assert meta <= sidx.S * (reads.RMETA_WORDS + reads.SMETA_WORDS)
        assert meta >= reads.RMETA_WORDS + reads.SMETA_WORDS


def _pcs_items(rng, ix, n, mrs):
    """Precomputed occurrences over the index's corpus: at both corpus ends
    and random, sl and el 1-3, lengths that make the span budget just fit,
    just fail or leave room, the compared tokens read beside each occurrence
    (some shifted to mismatch)."""
    ref = ix.refstr_padded.numpy()
    last = len(ref) - 1
    ps = _starts(rng, ix, n).numpy()
    sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
    plen = np.maximum(mrs - sl - el + 1 + rng.choice([0, 1, -2], n), 1)
    pe = ps + plen
    toks = [ref[np.clip(ps - 1, 0, last)], ref[np.clip(ps - 2, 0, last)],
            ref[np.clip(pe + 1, 0, last)], ref[np.clip(pe + 2, 0, last)]]
    toks = [np.where(rng.random(n) < 0.15, t + 1, t) for t in toks]
    return [torch.from_numpy(np.asarray(c, np.int32))
            for c in (ps, plen, sl, el, *toks)]


@pytest.mark.parametrize("kernel", ["A3", "B3p", "C1p"])
def test_pcs_need_decides_the_verification(index, kernel):
    """The verification's words (``pcs_need``): redrawing every corpus word
    (and A3's table and row words, B3p's query tokens) that no item of the
    launch needs changes no ok bit, and redrawing the needed corpus words
    changes some; only the budget's items need corpus words, at most four
    each."""
    rng = np.random.default_rng(60 + ["A3", "B3p", "C1p"].index(kernel))
    n, mrs = 300, 8
    ps, plen, sl, el, pa1, pa2, pb2, pb3 = _pcs_items(rng, index, n, mrs)
    ref = index.refstr_padded
    if kernel == "A3":
        # each item its own row; patterns of 1-6 items (some empty) whose
        # sl, el and compared tokens are their first item's
        counts = rng.integers(0, 7, n)
        counts[np.cumsum(counts) > n] = 0
        counts[-1] += n - counts.sum()
        offs = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                                .astype(np.int32))
        first = offs[:-1].clamp(max=n - 1).long()
        pattab = torch.stack([offs[:-1], sl[first], el[first], pa1[first],
                              pa2[first], pb2[first], pb3[first],
                              torch.zeros_like(first, dtype=torch.int32)], 1)
        arrays = {"refstr": ref, "pcrows": torch.stack([ps, plen], 1)
                  .reshape(-1), "pattab": pattab.reshape(-1).clone()}

        def fn(a):
            return lookup.pcs_plain(a["refstr"], a["pcrows"].view(-1, 2),
                                    a["pattab"].view(-1, 8), offs, n, mrs)
        args = (ref, arrays["pcrows"].view(-1, 2), pattab, offs, n, mrs)
        # the items' sl and el are their pattern's
        p = (torch.searchsorted(offs, torch.arange(n, dtype=torch.int32),
                                right=True) - 1).clamp(0, len(first) - 1)
        sl, el = pattab[p, 1], pattab[p, 2]
    elif kernel == "B3p":
        # the padded corpus as the query tokens: tok, stok beside each
        # occurrence, some shifted
        qtok = ref.clone()
        tok = (ps - sl + 1 + torch.from_numpy(
            (rng.random(n) < 0.15).astype(np.int32))).clamp(min=0)
        stok = ps + plen
        arrays = {"refstr": ref, "qtok": qtok}

        def fn(a):
            return lookup.pcs_items_plain(a["refstr"], a["qtok"], ps, plen,
                                          sl, el, tok, stok, mrs)
        args = (ref, qtok, ps, plen, sl, el, tok, stok, mrs)
    else:
        arrays = {"refstr": ref}

        def fn(a):
            return lookup.pcs_cols_plain(a["refstr"], ps, plen, sl, el, pa1,
                                         pa2, pb2, pb3, mrs)
        args = (ref, ps, plen, sl, el, pa1, pa2, pb2, pb3, mrs)
    need = reads.pcs_need(kernel, *args)
    want = fn(arrays)
    for _ in range(4):
        redrawn = {}
        for name, arr in arrays.items():
            b = arr[torch.from_numpy(rng.integers(0, len(arr), len(arr)))]
            if name in need:
                slots, keep = need[name]
                kept = slots[keep]
                b[kept] = arr[kept]
            redrawn[name] = b
        assert torch.equal(fn(redrawn), want)
    flipped = dict(arrays)
    slots, keep = need["refstr"]
    flipped["refstr"] = ref.clone()
    flipped["refstr"][slots[keep]] += 1
    assert not torch.equal(fn(flipped), want)
    words = reads.pcs_reads(kernel, *args)
    budget = plen + sl + el - 1 <= mrs
    assert bool(keep[~budget].any()) is False
    corpus = reads.count({"refstr": need["refstr"]}, arrays=("refstr",))
    assert 0 < corpus <= 4 * int(budget.sum()) and words >= corpus


@pytest.mark.parametrize("length,n,seed", [
    (1, 40, 0),          # a one-word corpus: every read is word 0
    (20, 100, 1),        # a corpus shorter than a window
    (32, 64, 2), (33, 64, 3),
    (5000, 700, 4),      # windows clamped at the end, duplicates
    (100_000, 2048, 5)])
def test_probe_reads_count_the_windows_union(length, n, seed):
    """P1's and P2's corpus words (``probe_reads``) are the brute-force
    union of the clamped windows, and they decide the windows: redrawing
    every other word of the corpus changes no row."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-40, length + 40, n)
    pos[: min(n, 32)] = np.arange(length - 32, length)[: min(n, 32)]
    pos[-8:] = pos[:8]                              # duplicate positions
    slots = np.clip(pos[:, None] + np.arange(gp.W), 0, length - 1)
    need = np.unique(slots)
    tpos = torch.from_numpy(pos.astype(np.int32))
    assert reads.probe_reads(length, tpos) == len(need)
    ref = rng.integers(2, 1000, length).astype(np.int32)
    other = ref.copy()
    free = np.setdiff1d(np.arange(length), need)
    other[free] = rng.integers(1000, 2000, len(free))
    np.testing.assert_array_equal(
        gp.windows(torch.from_numpy(ref), tpos).numpy(),
        gp.windows(torch.from_numpy(other), tpos).numpy())
    if length > 1000:       # sparse windows: fewer words than gathers
        assert len(need) < n * gp.W


def _brute_round_words(kernel, args) -> int:
    """``refine_round_reads``'s words counted lane by lane and node by node
    in Python, from the definitions: each SA word, query token and corpus
    token once over the launch."""
    def node(j, l, h):              # node j of the tree over [l, h)
        path = j + 1
        for k in range(path.bit_length() - 2, -1, -1):
            M = (l + h) >> 1
            l, h = (M + 1, h) if (path >> k) & 1 else (l, M)
        return l, h

    def clamp(x, n):
        return min(max(x, 0), n - 1)
    if kernel == "B2t":
        ref, soff, olo, ohi, st, sa_sum, depth, count = args
        n, nodes = sa_sum.shape
        words, pos = 2 * n + n * nodes * count, set()
        for i in range(n):
            for j in range(nodes):
                l, h = node(j, int(st[2, i]), int(st[3, i]))
                if h > l:
                    words += 1
                    for c in range(count):
                        p = int(sa_sum[i, j]) + depth + c
                        if olo <= p < ohi:
                            pos.add(clamp(p - soff, ref.shape[0]))
        return words + len(pos)
    (sa, rstart, rcount, qtok, toks, sls, st, ups, downs, tok, g, R, d0,
     depths) = args
    n = toks.shape[0]
    ranks, qpos = set(), set()

    def sa_word(l, h):
        loc = ((l + h) >> 1) - rstart
        if h > l and 0 <= loc < rcount:
            ranks.add(loc)

    def key_of(i, depth):
        if depth < int(sls[i]):
            qpos.add(clamp(int(toks[i]) + depth, qtok.shape[0]))
            return int(qtok[clamp(int(toks[i]) + depth, qtok.shape[0])])
        return -1
    words = 0
    for i in range(n):
        lo, hi, l, h = (int(x) for x in st[:, i])
        if R == 0 and g == 0:
            words += 5
            sa_word(lo, hi)
        elif R == 0:
            words += 6 + 2 * depths
            for c in range(depths):
                if hi > lo:
                    words += 1
                key = key_of(i, d0 + c) if hi > lo else 0
                t = int(tok[i, c])
                nlo = lo + 1 if hi > lo and t < key else lo
                nhi = nlo + 1 if hi > nlo and t < key + 1 else nlo
                lo, hi = nlo, nhi
        else:
            words += 8
            if g > 0:
                b = (g - 1) // R
                if h > l:
                    words += 2
                    key = key_of(i, d0 + b // 2) + b % 2
                    j = 0
                    for _ in range(5):
                        if h <= l:
                            break
                        words += 1
                        M = (l + h) >> 1
                        if int(tok[i, j]) >= key:
                            h, j = M, 2 * j + 1
                        else:
                            l, j = M + 1, 2 * j + 2
                if g % R == 0:
                    words += 1 if b % 2 == 0 else 2
                    if b % 2:
                        lo, hi = int(ups[i, b // 2]), l
            if g < 2 * depths * R:
                if g % R == 0:
                    l, h = (l if (g // R) % 2 else lo), hi
                words += 31
                for j in range(31):
                    sa_word(*node(j, l, h))
    return words + len(ranks) + len(qpos)


@pytest.mark.parametrize("d0,depths,single", [(0, 4, False), (2, 4, False),
                                              (5, 4, True), (3, 16, True)])
def test_refine_round_reads_count_each_word_once(sharded, d0, depths, single,
                                                 monkeypatch):
    """``refine_round_reads`` on every B2s and B2t launch of a round-form
    dispatch over 3 shards (tree steps from the whole SA and from each
    lane's own interval; single-row dispatches) equals a brute-force count
    of the same words, lane by lane and node by node."""
    sidx, rep = sharded
    rng = np.random.default_rng(60 + d0 + depths)
    n = 24
    qtok, toks, sls, lo, hi = _lanes(rng, rep, n, d0)
    if single:
        hi = (lo + torch.from_numpy(rng.integers(0, 2, n).astype(
            np.int32))).to(torch.int32)
        lo[0], hi[0] = -1, 0
    listed = dataclasses.replace(sidx, devices=[torch.device("cpu")] * 3,
                                 listed=True)
    seen = []

    def spy(k, real):
        def run(*args):
            kept = tuple(a.clone() if torch.is_tensor(a) else a
                         for a in args)
            seen.append((k, kept, reads.refine_round_reads(k, *kept)))
            return real(*args)
        return run
    monkeypatch.setattr(shx, "refine_step", spy("B2s", shx.refine_step))
    monkeypatch.setattr(shx, "token_partial", spy("B2t",
                                                  shx.token_partial))
    shx.refine_round(listed, qtok, *(x.numpy() for x in (toks, sls, lo, hi)),
                     d0, depths)
    R, T = shx.round_plan(lo.numpy(), hi.numpy(), depths)
    assert (R == 0) == single
    assert len(seen) == 3 * (2 * T + 1)
    for k, args, (words, _) in seen:
        assert words == _brute_round_words(k, args), (k, args[10:12])


@pytest.mark.parametrize("d0,depths,single", [(0, 4, False), (2, 4, False),
                                              (5, 4, True), (3, 16, True)])
def test_round_form_launch_bytes_are_a_lower_bound(sharded, d0, depths,
                                                   single, monkeypatch):
    """The bytes counted for every B2s and B2t launch of a round-form
    dispatch over 3 shards (``step_bytes``, ``partial_bytes``, what
    ``kb.counted`` adds to ``BYTES``) are at most the words
    ``refine_round_reads`` counts for it, 4 bytes a word: a step counts
    none of the whole ``ups``/``downs`` tables, nor step 0 a token."""
    sidx, rep = sharded
    rng = np.random.default_rng(90 + d0 + depths)
    n = 24
    qtok, toks, sls, lo, hi = _lanes(rng, rep, n, d0)
    if single:
        hi = (lo + torch.from_numpy(rng.integers(0, 2, n).astype(
            np.int32))).to(torch.int32)
    listed = dataclasses.replace(sidx, devices=[torch.device("cpu")] * 3,
                                 listed=True)
    seen = []

    def spy(k, real):
        def run(*args):
            kept = tuple(a.clone() if torch.is_tensor(a) else a
                         for a in args)
            words = reads.refine_round_reads(k, *kept)[0]
            if k == "B2t":
                n_, nodes = kept[5].shape
                got = shx.partial_bytes(n_, nodes, kept[7])
            else:
                got = shx.step_bytes(kept[4].shape[0], *kept[10:12],
                                     kept[13])
            seen.append((k, kept[10:12] if k == "B2s" else None, got, words))
            return real(*args)
        return run
    monkeypatch.setattr(shx, "refine_step", spy("B2s", shx.refine_step))
    monkeypatch.setattr(shx, "token_partial", spy("B2t",
                                                  shx.token_partial))
    shx.refine_round(listed, qtok, *(x.numpy() for x in (toks, sls, lo, hi)),
                     d0, depths)
    R, T = shx.round_plan(lo.numpy(), hi.numpy(), depths)
    assert len(seen) == 3 * (2 * T + 1)
    for k, at, got, words in seen:
        assert 0 < got <= 4 * words, (k, at, got, words)
    # a dispatch's B2s bytes grow with its steps, not with T x the tables
    b2s = sum(got for k, _, got, _ in seen if k == "B2s")
    assert b2s < 3 * (T + 1) * 4 * n * (8 + 2 + shx.TREE_NODES)
