"""extract_items: the occurrences the extraction handed its kernels (A6, A7
and A8, after sampling: ``extract.contig_items``, ``extract.onegap_items``,
``extract.twogap_items``) over the window, per unit of the mix."""

from perfbench.metrics import _spans as sp

COUNTERS = ("extract.contig_items", "extract.onegap_items",
            "extract.twogap_items")


def read(rec):
    return sp.per_unit(rec, sp.counter(rec, *COUNTERS))
