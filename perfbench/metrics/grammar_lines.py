"""grammar_lines: the grammar lines the program formatted for the window's
requests (``grammar.lines``), per unit of the mix."""

from perfbench.metrics import _spans as sp


def read(rec):
    return sp.per_unit(rec, sp.counter(rec, "grammar.lines"))
