"""precompute_s: the frequent-pair precompute (phase precompute, A4) per
build."""

from perfbench.metrics import _phases as ph


def read(rec):
    return ph.per_build_s(rec, ("precompute",))
