"""Synthetic parallel corpora shaped like a deployment's training data.

One general generator, driven by a configuration's ``corpus`` block: sentence
lengths (a gamma law clipped to the cleaning limits), a Zipf vocabulary, and
word alignments with the mechanisms the block names: unaligned source words,
1:N fan-out, target insertions, local swaps and verb-final movement.
Everything is vectorised numpy, so two million sentences take seconds, and
deterministic per ``corpus_seed``.

The result is kept as arrays (``Corpus``).  ``render`` turns it into the
cdec input format that the program reads: source and target text, one
sentence a line, ``i-j`` alignment lines and a lexical table of
``src tgt P(s|t) P(t|s)`` records.  The reference reads the arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_TARGET_LEN = 250   # alignment positions are stored in 8 bits


@dataclasses.dataclass
class Corpus:
    src: np.ndarray       # int32 [n_src_tokens] source word ids
    src_len: np.ndarray   # int32 [n_sentences]
    tgt: np.ndarray       # int32 [n_tgt_tokens] target word ids
    tgt_len: np.ndarray   # int32 [n_sentences]
    link_s: np.ndarray    # int16 [n_links] source position in its sentence
    link_t: np.ndarray    # int16 [n_links] target position in its sentence
    link_len: np.ndarray  # int32 [n_sentences] links per sentence
    lex_src: np.ndarray   # int32 [n_lex] source word id, -1 = NULL
    lex_tgt: np.ndarray   # int32 [n_lex] target word id, -1 = NULL
    lex_p1: np.ndarray    # float64 [n_lex] P(s|t), rounded to 7 decimals
    lex_p2: np.ndarray    # float64 [n_lex] P(t|s), rounded to 7 decimals

    ARRAYS = ("src", "src_len", "tgt", "tgt_len", "link_s", "link_t",
              "link_len", "lex_src", "lex_tgt", "lex_p1", "lex_p2")

    def save(self, path: str) -> None:
        np.savez(path, **{k: getattr(self, k) for k in self.ARRAYS})

    @classmethod
    def load(cls, path: str) -> "Corpus":
        with np.load(path) as z:
            return cls(**{k: z[k] for k in cls.ARRAYS})

    @property
    def src_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.src_len, dtype=np.int64)])


def src_word(i) -> str:
    return f"f{i}"


def tgt_word(i) -> str:
    return f"e{i}"


def sentence_lengths(rng, n: int, spec: dict) -> np.ndarray:
    """``n`` lengths from a gamma law of the given mean and standard
    deviation, rounded and clipped to [min, max]."""
    mean, sd = float(spec["mean"]), float(spec["sd"])
    shape = (mean / sd) ** 2
    lens = np.rint(rng.gamma(shape, mean / shape, size=n))
    return np.clip(lens, spec["min"], spec["max"]).astype(np.int32)


def zipf_ids(rng, n: int, vocab: int, exponent: float) -> np.ndarray:
    """``n`` word ids, id r drawn with probability proportional to
    1 / (r + 1) ** exponent (id 0 is the most frequent)."""
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n)),
                      vocab - 1).astype(np.int32)


def _segment_ids(lens) -> np.ndarray:
    return np.repeat(np.arange(len(lens), dtype=np.int64), lens)


def _pos_in_segment(lens) -> np.ndarray:
    starts = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])[:-1]
    return (np.arange(int(np.sum(lens, dtype=np.int64)), dtype=np.int64)
            - np.repeat(starts, lens))


def make_corpus(spec: dict, seed: int) -> Corpus:
    """The corpus of a configuration's ``corpus`` block, fixed by ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(spec["sentences"])
    slen = sentence_lengths(rng, n, spec["source_length"])
    total = int(slen.sum(dtype=np.int64))
    sent = _segment_ids(slen)
    pos = _pos_in_segment(slen)
    src = zipf_ids(rng, total, int(spec["vocab"]), float(spec["zipf"]))

    al = spec["alignment"]
    aligned = rng.random(total) >= float(al["unaligned"])
    aligned[pos == 0] = True          # every sentence keeps a target word
    # 1:N fan-out: extra target words of one source word
    fan = np.where(aligned, 1, 0).astype(np.int64)
    extra = rng.random(total) < float(al["fanout"])
    fan += np.where(aligned & extra,
                    rng.integers(1, int(al["fanout_max"]), size=total,
                                 endpoint=True), 0)
    # target words aligned to nothing, inserted after a source word's own
    ins = (rng.random(total) < float(al["insert"])).astype(np.int64)
    emit = fan + ins
    tlen = np.bincount(sent, weights=emit, minlength=n).astype(np.int64)
    long_ = tlen > MAX_TARGET_LEN
    if long_.any():                   # keep 8-bit target positions
        cut = long_[sent]
        fan = np.where(cut & aligned, 1, fan)
        ins = np.where(cut, 0, ins)
        emit = fan + ins

    # target order: a key per source word, its position; local swaps of
    # neighbours, and verb-final movement of one word a sentence
    key = pos.astype(np.float64)
    swap = (rng.random(total) < float(al["swap"])) & (pos + 1 < slen[sent])
    swap &= ~np.concatenate([[False], swap[:-1]])
    si = np.flatnonzero(swap)
    key[si], key[si + 1] = key[si + 1].copy(), key[si].copy()
    vf = float(al.get("verb_final", 0.0))
    if vf > 0:
        starts = np.concatenate([[0], np.cumsum(slen, dtype=np.int64)])[:-1]
        pick = rng.random(n) < vf
        off = (rng.random(n) * slen).astype(np.int64)
        moved = starts[pick] + np.minimum(off[pick], slen[pick] - 1)
        key[moved] = 1000.0

    # one target word per emission, in (sentence, key, emission) order
    n_emit = int(emit.sum())
    e_src = np.repeat(np.arange(total, dtype=np.int64), emit)
    e_k = _pos_in_segment(emit)
    e_sent = sent[e_src]
    order = np.lexsort((e_k, key[e_src], e_sent))
    e_src, e_k, e_sent = e_src[order], e_k[order], e_sent[order]
    vt = int(spec["target_vocab"])
    w = src[e_src].astype(np.int64)
    # the first emission is the word's translation, sometimes a synonym;
    # further fan-out words are other words; insertions are function words
    syn = rng.random(n_emit) < float(al["synonym"])
    first = e_k == 0
    is_ins = e_k >= fan[e_src]
    tgt = np.where(first, (w + np.where(syn, 1 + (w % 3), 0)) % vt,
                   (w * 7919 + e_k * 104729) % vt)
    tgt = np.where(is_ins, rng.integers(0, 50, size=n_emit), tgt)
    tgt = tgt.astype(np.int32)
    tgt_len = np.bincount(e_sent, minlength=n).astype(np.int32)
    tpos = _pos_in_segment(tgt_len)

    # links: each non-inserted emission to its source word, in source order
    lk = np.flatnonzero(~is_ins)
    l_sent = e_sent[lk]
    l_s = pos[e_src[lk]]
    l_t = tpos[lk]
    lo = np.lexsort((l_t, l_s, l_sent))
    link_len = np.bincount(l_sent, minlength=n).astype(np.int32)

    lex = _lex_table(src[e_src[lk]], tgt[lk], src[~aligned], tgt[is_ins])
    return Corpus(src=src, src_len=slen, tgt=tgt, tgt_len=tgt_len,
                  link_s=l_s[lo].astype(np.int16),
                  link_t=l_t[lo].astype(np.int16), link_len=link_len, **lex)


def _lex_table(ps, pt, null_src, null_tgt) -> dict:
    """Relative frequencies of the aligned word pairs, with NULL rows for
    unaligned source words (s, NULL) and inserted target words (NULL, t)."""
    s = np.concatenate([ps, null_src, np.full(len(null_tgt), -1)])
    t = np.concatenate([pt, np.full(len(null_src), -1), null_tgt])
    key = (s.astype(np.int64) + 1) << 32 | (t.astype(np.int64) + 1)
    uk, cnt = np.unique(key, return_counts=True)
    us = (uk >> 32).astype(np.int64) - 1
    ut = (uk & 0xFFFFFFFF).astype(np.int64) - 1
    _, s_inv = np.unique(us, return_inverse=True)
    _, t_inv = np.unique(ut, return_inverse=True)
    s_tot = np.bincount(s_inv, weights=cnt)
    t_tot = np.bincount(t_inv, weights=cnt)
    p1 = np.round(cnt / t_tot[t_inv], 7)   # P(s|t)
    p2 = np.round(cnt / s_tot[s_inv], 7)   # P(t|s)
    return dict(lex_src=us.astype(np.int32), lex_tgt=ut.astype(np.int32),
                lex_p1=p1, lex_p2=p2)


def _render(ids: np.ndarray, seps: np.ndarray, words: list) -> bytes:
    """The bytes of ``words[ids[i]] + seps[i]`` for every i, vectorised."""
    wb = np.frombuffer("".join(words).encode("ascii"), np.uint8)
    wl = np.fromiter(map(len, words), np.int64, count=len(words))
    wo = np.concatenate([[0], np.cumsum(wl)])[:-1]
    out = []
    for c in range(0, len(ids), 1 << 22):
        i = ids[c:c + (1 << 22)].astype(np.int64)
        ln = wl[i]
        span = ln + 1
        ends = np.cumsum(span)
        buf = np.empty(int(ends[-1]) if len(ends) else 0, np.uint8)
        starts = ends - span
        k = np.arange(int(ln.sum()), dtype=np.int64)
        seg = np.repeat(np.arange(len(i)), ln)
        within = k - np.repeat(np.cumsum(ln) - ln, ln)
        buf[starts[seg] + within] = wb[wo[i][seg] + within]
        buf[ends - 1] = seps[c:c + (1 << 22)]
        out.append(buf.tobytes())
    return b"".join(out)


def _line_seps(lens, inner: int) -> np.ndarray:
    seps = np.full(int(np.sum(lens, dtype=np.int64)), inner, np.uint8)
    seps[np.cumsum(lens, dtype=np.int64)[lens > 0] - 1] = ord("\n")
    return seps


def _words(prefix: str, n: int) -> list:
    return [f"{prefix}{i}" for i in range(n)]


def render(c: Corpus) -> tuple:
    """(source text, target text, alignment lines, lex tokens) in the
    cdec format the program's loaders read.  Every line ends in a newline
    except that the texts are joined, so a text holds one line a
    sentence."""
    sp = ord(" ")
    nsv = int(c.src.max()) + 1
    ntv = int(c.tgt.max()) + 1
    f_text = _render(c.src, _line_seps(c.src_len, sp),
                     _words("f", nsv)).decode("ascii").rstrip("\n")
    e_text = _render(c.tgt, _line_seps(c.tgt_len, sp),
                     _words("e", ntv)).decode("ascii").rstrip("\n")
    nums = [str(i) for i in range(256)]
    pair = np.empty(2 * len(c.link_s), np.int64)
    pair[0::2] = c.link_s
    pair[1::2] = c.link_t
    seps = _line_seps(2 * c.link_len.astype(np.int64), sp)
    seps[0::2] = ord("-")
    a_lines = _render(pair, seps, nums).decode("ascii").split("\n")[:-1]
    lex_tokens = []
    for s, t, p1, p2 in zip(c.lex_src.tolist(), c.lex_tgt.tolist(),
                            c.lex_p1.tolist(), c.lex_p2.tolist()):
        lex_tokens += ["NULL" if s < 0 else f"f{s}",
                       "NULL" if t < 0 else f"e{t}", f"{p1:.7f}", f"{p2:.7f}"]
    return f_text, e_text, a_lines, lex_tokens
