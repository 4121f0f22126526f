"""lookup2_host_ms: lookup2 less its engine calls (A5's table, the
(pattern, c token) keys, the match of A5's hits and the sort), per unit of
the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    return sp.host_ms(rec, "lookup2")
