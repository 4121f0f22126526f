"""copy_mb: megabytes copied between host and card in the window, both
ways (``h2d_bytes`` + ``d2h_bytes``), per unit of the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    b = sp.counter(rec, "h2d_bytes", "d2h_bytes")
    return sp.per_unit(rec, None if b is None else b / 1e6)
