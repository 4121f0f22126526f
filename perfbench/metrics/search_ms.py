"""search_ms: pass 1/2, the enumerations, lookup1 and lookup2 (the phases
kernel, kernel2, enumeration, lookup1, lookup2) per unit of the mix."""

from perfbench.metrics import _phases as ph


def read(rec):
    if rec["kind"] != "requests":
        return None
    return ph.per_unit_ms(rec, ph.phase_sum(rec["requests"], ph.SEARCH))
