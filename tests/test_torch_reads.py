"""The words the kernels' bounds count (``cgx_tpu_torch.tools.reads``): for
the fused gap check, A5's body, A6's, A7's and A8's bodies and A10's
probes, the words each
counter marks as needed decide the plain version's output.  Redrawing every
other word of the index arrays (from the same array, so that the words stay
plausible) changes no output, so the bounds, which count only the needed
words, count all that the functions need; and the needed words are fewer
than the gathers."""

import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.extract import device as xdev  # noqa: E402
from cgx_tpu_torch.features import maxlex as ml  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import lookup, passes  # noqa: E402
from cgx_tpu_torch.tools import reads  # noqa: E402


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
