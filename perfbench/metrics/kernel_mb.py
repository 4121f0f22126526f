"""kernel_mb: megabytes the window's kernels moved by the per-launch
count (each launch's item columns, tables and outputs, from their shapes:
a lower bound that leaves out the corpus words), per unit of the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    b = sp.counter(rec, *sp.counter_names(rec, "bytes."))
    return sp.per_unit(rec, None if b is None else b / 1e6)
