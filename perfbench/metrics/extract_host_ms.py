"""extract_host_ms: extractkernel less its engine calls (A6, A7 and A8's
columns up, launches and rows down): the occurrence lists, the rows'
unpacking, compaction and sort by rule id, per unit of the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    return sp.host_ms(rec, "extractkernel")
