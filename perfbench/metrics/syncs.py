"""syncs: the host's waits for the card in the window (each copy to the
host of a CUDA tensor and each phase's synchronise), per unit of the
mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    return sp.per_unit(rec, sp.counter(rec, "syncs"))
