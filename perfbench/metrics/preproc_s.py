"""preproc_s: corpus loading and the suffix array (phases refsin,
suffixarray) per build."""

from perfbench.metrics import _phases as ph


def read(rec):
    return ph.per_build_s(rec, ("refsin", "suffixarray"))
