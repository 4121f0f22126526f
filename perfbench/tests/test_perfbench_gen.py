"""The generators: deterministic per ``corpus_seed`` and ``--seed``, the
same test lengths for every seed, and text the program's loaders read."""

import numpy as np

from perfbench.gen import corpus as gc
from perfbench.gen import queries as gq
from perfbench.tests.tiny import TINY


def _arrays(c):
    return [getattr(c, k) for k in gc.Corpus.ARRAYS]


def test_corpus_is_fixed_by_its_seed():
    a = gc.make_corpus(TINY["corpus"], 7)
    b = gc.make_corpus(TINY["corpus"], 7)
    c = gc.make_corpus(TINY["corpus"], 8)
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    assert not np.array_equal(a.src[:1000], c.src[:1000])


def test_corpus_shape():
    c = gc.make_corpus(TINY["corpus"], 7)
    assert len(c.src_len) == TINY["corpus"]["sentences"]
    assert c.src_len.sum() == len(c.src) and c.tgt_len.sum() == len(c.tgt)
    assert c.src_len.min() >= 1 and c.src_len.max() <= 80
    assert c.tgt_len.min() >= 1 and c.tgt_len.max() <= gc.MAX_TARGET_LEN
    assert c.link_len.min() >= 1 and c.link_len.sum() == len(c.link_s)
    sent = np.repeat(np.arange(len(c.link_len)), c.link_len)
    assert (c.link_s < c.src_len[sent]).all()
    assert (c.link_t < c.tgt_len[sent]).all()
    # the mechanisms: unaligned words, swaps (a later source word before an
    # earlier one on the target side) and fan-out
    first_t = {}
    crossed = 0
    for s, si, ti in zip(sent[:5000], c.link_s[:5000], c.link_t[:5000]):
        if (s, si - 1) in first_t and first_t[(s, si - 1)] > ti:
            crossed += 1
        first_t.setdefault((s, si), ti)
    assert crossed > 0
    assert (c.lex_src == -1).any() and (c.lex_tgt == -1).any()


def test_rendered_text_reads_back():
    from cgx_tpu_torch.preproc import corpus as cp
    c = gc.make_corpus(TINY["corpus"], 7)
    f, e, a, lex = gc.render(c)
    src = cp.load_source_corpus_text(f)
    tgt = cp.load_target_corpus_text(e)
    assert src.sentence_count == len(c.src_len) == len(a)
    assert len(lex) == 4 * len(c.lex_src)
    words = f.split("\n")[5].split()
    assert words == [gc.src_word(w) for w in
                     c.src[c.src_starts[5]:c.src_starts[6]].tolist()]
    cp.load_alignment_fast(a, src, tgt)


def test_testset_lengths_fixed_content_from_seed():
    c = gc.make_corpus(TINY["corpus"], 7)
    a = gq.make_testset(c.src, TINY["testset"], 3, 2**31 + 5)
    b = gq.make_testset(c.src, TINY["testset"], 3, 2**31 + 5)
    d = gq.make_testset(c.src, TINY["testset"], 3, 11)
    assert a == b and a != d
    assert len(a) == TINY["testset"]["sentences"]
    k = TINY["testset"]["block"]
    for i in range(0, len(a) - k + 1, k):   # each whole block alike
        assert sorted(map(len, a[i:i + k])) == sorted(map(len, d[i:i + k]))
    assert [len(x) for x in a] != [len(x) for x in d]
