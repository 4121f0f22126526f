"""Corpus text through ``perfbench.reference``: a corpus given as lines of
words (the form the port's loaders read) turned into the arrays the
reference reads, and the reference's grammar of some of its queries with
the text's own words, line for line comparable with the port's.

``chip_smoke.py`` checks the port's unsampled run on the card against it,
and ``tests/test_torch_unsampled.py`` the same on the CPU.
"""

from __future__ import annotations

import numpy as np


def reference_corpus(f_lines, e_lines, a_lines, lex_tokens):
    """Corpus text (lists of lines, the lexical table's tokens) as the
    arrays ``perfbench.reference`` reads (``perfbench.gen.corpus.Corpus``,
    words numbered by first appearance) -> (corpus, source words, target
    words by number); lexical records of words outside the corpus, which
    no rule can hold, are left out."""
    from perfbench.gen.corpus import Corpus

    def number(lines):
        words, toks, lens = {}, [], []
        for ln in lines:
            ws = ln.split()
            lens.append(len(ws))
            toks.extend(words.setdefault(w, len(words)) for w in ws)
        return words, np.asarray(toks, np.int32), np.asarray(lens, np.int32)
    sw, src, slen = number(f_lines)
    tw, tgt, tlen = number(e_lines)
    ls, lt, ll = [], [], []
    for ln in a_lines:
        pairs = [p.split("-") for p in ln.split()]
        ll.append(len(pairs))
        ls.extend(int(i) for i, _ in pairs)
        lt.extend(int(j) for _, j in pairs)
    recs = [r for r in zip(*[iter(lex_tokens)] * 4)
            if (r[0] == "NULL" or r[0] in sw) and (r[1] == "NULL" or r[1] in tw)]

    def ids(col, words):
        return np.asarray([-1 if r[col] == "NULL" else words[r[col]]
                           for r in recs], np.int32)
    c = Corpus(src=src, src_len=slen, tgt=tgt, tgt_len=tlen,
               link_s=np.asarray(ls, np.int16),
               link_t=np.asarray(lt, np.int16),
               link_len=np.asarray(ll, np.int32),
               lex_src=ids(0, sw), lex_tgt=ids(1, tw),
               lex_p1=np.asarray([float(r[2]) for r in recs], np.float64),
               lex_p2=np.asarray([float(r[3]) for r in recs], np.float64))
    return c, list(sw), list(tw)


def reference_grammar(data, overrides: dict, picks) -> list:
    """``perfbench.reference``'s grammar of the queries ``picks`` of
    ``data`` ((f, e, a, lex, queries) as lists of lines) under the
    extractor ``overrides``, its words those of the text."""
    from perfbench.gen.corpus import src_word, tgt_word
    from perfbench.reference import config as rconf
    from perfbench.reference import index as rindex
    from perfbench.reference import pipeline as rpipe
    f, e, a, lex, queries = data
    corpus, sw, tw = reference_corpus(f, e, a, lex)
    cfg = rconf.from_overrides(overrides)
    ix = rindex.build(corpus, cfg)
    # the reference spells word n as the benchmark's generator renders it
    # (``src_word(n)``, ``tgt_word(n)``): give it the text's words instead
    for vocab, words, name in ((ix.source.vocab, sw, src_word),
                               (ix.target.vocab, tw, tgt_word)):
        text = {name(n): w for n, w in enumerate(words)}
        vocab.id_to_word[2:] = [text[w] for w in vocab.id_to_word[2:]]
        vocab.word_to_id.clear()
        vocab.word_to_id.update({w: i for i, w in enumerate(vocab.id_to_word)
                                 if i >= 2})
    return rpipe.grammar(ix, [queries[i].split() for i in picks], cfg)
