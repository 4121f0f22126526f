"""The comparison that decides ``correct``: the grammar lines the program
wrote to disk against the reference's, sentence by sentence, exactly."""

from __future__ import annotations

import collections
import os

import numpy as np


def read_grammar(path: str):
    """The lines of one grammar file, or None when it is missing."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return fh.read().splitlines()


def lines_off(got, want) -> int:
    """How far one sentence's grammar is from the reference's: the lines
    in one and not the other (as multisets), or 1 when only the order
    differs; a missing file counts every reference line, and at least 1."""
    if got is None:
        return max(len(want), 1)
    if got == want:
        return 0
    c = collections.Counter(got)
    c.subtract(want)
    return sum(abs(v) for v in c.values()) or 1


def sample(served: dict, k: int, seed: int) -> list:
    """``k`` of the served sentences (test-set index -> words), drawn from
    the seed."""
    ids = sorted(served)
    if len(ids) <= k:
        return ids
    rng = np.random.default_rng([seed, 3])
    return sorted(ids[j] for j in rng.choice(len(ids), size=k,
                                             replace=False).tolist())
