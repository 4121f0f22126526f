"""lookup2_yield: the rows lookup2 kept over the items kernel A5 scanned
(``lookup2.rows`` / ``lookup2.items``): the share of A5's work that is
not thrown away."""

from perfbench.metrics import _spans as sp


def read(rec):
    items = sp.counter(rec, "lookup2.items")
    rows = sp.counter(rec, "lookup2.rows")
    if not items or rows is None:
        return None
    return rows / items
