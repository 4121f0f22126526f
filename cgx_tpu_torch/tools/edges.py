"""Edge inputs of kernel B1 (the LCP passes): lanes and items that reach
every exit of its warp body, over an index and its queries, and a small
corpus whose matches run past 32 tokens.  ``chip_smoke.py`` runs the kernel
on them against its plain version; ``tests/test_torch_passes.py`` runs the
plain passes on them against the JAX package's."""

from __future__ import annotations

import numpy as np

from cgx_tpu_torch.search import passes


def long_corpus():
    """(f, e, a, lex_tokens, queries) of a small corpus of 70-token
    sentences over 6 words, repeated, and queries that match 38-70 tokens
    of them: matches past 32 tokens, the warp's compare round (europarl's
    sentences hold 3-12 tokens)."""
    rng = np.random.default_rng(5)
    words = [f"w{i}" for i in range(6)]
    base = list(rng.choice(words, 70))
    f = [" ".join(base)] * 3 + [" ".join(rng.choice(words, 40))
                                for _ in range(30)]
    f.append(" ".join(base[:45]))
    e = [" ".join(rng.choice(words, 20)) for _ in f]
    q = [" ".join(base), " ".join(base[:38] + ["zz-oov"] + base[:20]),
         " ".join(rng.choice(words, 45))]
    return f, e, ["0-0 1-1"] * len(f), "w0 w0 0.5 0.5".split(), q


def lcp_edge_lanes(rng, arrays, toks, sls):
    """B1's edge lanes over an index (``arrays``: refstr, sa, lcpleft,
    lcpright, qtok, reflen) and its queries' lanes (toks, sls) -> (query
    tokens, edge lanes (toks, suffixlens)): OOV tokens at two lanes' first
    tokens and inside the two longest matches, each query's last token
    and four other tokens with suffixlen 1, and, appended past the padding
    with -2 after each, the corpus suffixes of the SA's first two and last
    rows that start with a word, up to their sentence end, the sentinel and
    an id past it."""
    refstr, sa, lcpl, lcpr, qtok, reflen = arrays
    lm = passes.pass1_plain(refstr, sa, lcpl, lcpr, qtok, toks, sls,
                            reflen)[0].cpu().numpy()
    q, t, sl = (x.cpu().numpy() for x in (qtok, toks, sls))
    longest = np.argsort(lm)[-2:]
    q[t[longest] + np.maximum(lm[longest] - 1, 1)] = -1
    oov = rng.choice(len(t), 2, replace=False)
    q[t[oov]] = -1
    ends = np.unique(t + sl - 1)[:8]
    one = rng.choice(len(t), 4, replace=False)
    ref = refstr.cpu().numpy()
    head = sa[:reflen].cpu().numpy()
    word = np.flatnonzero(ref[head] > 1)
    seg_at, seg_len, parts = [], [], [q]
    at = len(q)
    top = ref[head[reflen - 1]]               # the sentinel, past every id
    segs = []
    for row in (word[0], word[1], reflen - 2):
        seg = ref[head[row]:head[row] + 20]
        stop = np.flatnonzero(seg <= 1)
        segs.append(seg[:stop[0] if len(stop) else len(seg)])
    for seg in segs + [np.array([top]), np.array([top + 1])]:
        parts += [seg, np.full(8, -2)]
        seg_at.append(at)
        seg_len.append(len(seg))
        at += len(seg) + 8
    edge_t = np.concatenate([t[oov], t[longest], ends, t[one], seg_at])
    edge_sl = np.concatenate([sl[oov], sl[longest], np.ones(len(ends) + 4),
                              seg_len])
    q = np.concatenate(parts).astype(np.int32)
    return q, edge_t.astype(np.int32), edge_sl.astype(np.int32)


def lcp_edge_items(rng, toks, p1):
    """B1p2's items, rows (tok, match, LL, MM, RR), from pass 1's output
    ``p1`` (six numpy columns) over the lanes ``toks`` -> (edge items, the
    lanes' own items): one per match length 2..longestmatch of each lane;
    the edges are some of them with the pin at LL + 1 and at RR - 1, on
    windows of width 2 around the hit, and those past 32 tokens."""
    lm, ffh, ffl, ffr = p1[0], p1[3], p1[4], p1[5]
    hit = np.flatnonzero(lm > 1)
    lane = np.repeat(hit, lm[hit] - 1)
    match = np.concatenate([np.arange(2, m + 1) for m in lm[hit]] + [[]])
    LL, MM, RR = ffl[lane], ffh[lane], ffr[lane]
    t = toks[lane]
    real = np.stack([t, match, LL, MM, RR], axis=1).astype(np.int32)
    wide = np.flatnonzero(RR - LL >= 2)
    k = rng.choice(wide, min(len(wide), 12), replace=False)
    edge = np.concatenate([
        np.stack([t[k], match[k], LL[k], LL[k] + 1, RR[k]], axis=1),
        np.stack([t[k], match[k], LL[k], RR[k] - 1, RR[k]], axis=1),
        np.stack([t[k], np.minimum(match[k], 2), MM[k] - 1, MM[k],
                  MM[k] + 1], axis=1),
        real[match > 32][:8]]).astype(np.int32)
    return edge, real
