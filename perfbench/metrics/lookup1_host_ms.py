"""lookup1_host_ms: lookup1 less its engine calls (the host's routing,
A3's jobs and hits to rows, A2's hits to rows and the sort), per unit of
the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    return sp.host_ms(rec, "lookup1")
