"""upload_s: the index placed on the device (phase qrysin) per build."""

from perfbench.metrics import _phases as ph


def read(rec):
    return ph.per_build_s(rec, ("qrysin",))
