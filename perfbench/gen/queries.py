"""Test sentences spliced from corpus fragments.

A configuration's ``testset`` block fixes the test set's size and length
profile from ``corpus_seed``: one block of ``block`` lengths, drawn once
from the test set's length law, and every block of the test set a
permutation of it.  So every seed, and every window of whole blocks, gets
the same multiset of sentence lengths.  ``--seed`` draws the order and the
content: each sentence is cut into 2-4 fragments, each fragment copied from
a random place in the corpus (so long matches exist), and about ``oov`` of
the words are replaced by words the corpus never saw.
"""

from __future__ import annotations

import numpy as np

from perfbench.gen.corpus import sentence_lengths, src_word


def block_lengths(spec: dict, corpus_seed: int) -> np.ndarray:
    """The lengths of one block, fixed by ``corpus_seed``."""
    rng = np.random.default_rng([corpus_seed, 1])
    return sentence_lengths(rng, int(spec["block"]), spec["length"])


def make_testset(src: np.ndarray, spec: dict, corpus_seed: int,
                 seed: int) -> list:
    """The test set as lists of words, in the order of ``seed``."""
    block = block_lengths(spec, corpus_seed)
    rng = np.random.default_rng([seed, 2])
    n = int(spec["sentences"])
    lens = np.concatenate([block[rng.permutation(len(block))]
                           for _ in range(-(-n // len(block)))])[:n]
    out = []
    for i, n in enumerate(lens.tolist()):
        k = min(int(rng.integers(2, 5)), n)
        cuts = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False)) \
            if k > 1 else np.empty(0, np.int64)
        parts = np.diff(np.concatenate([[0], cuts, [n]]))
        words = []
        for p in parts.tolist():
            at = int(rng.integers(0, len(src) - p + 1))
            words += [src_word(w) for w in src[at:at + p].tolist()]
        oov = np.flatnonzero(rng.random(n) < float(spec["oov"]))
        for j in oov.tolist():
            words[j] = f"u{i}x{j}"
        out.append(words)
    return out
