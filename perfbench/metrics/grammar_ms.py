"""grammar_ms: rule formatting (phase printout) and the benchmark's span
around write_grammars, per unit of the mix."""

from perfbench.metrics import _phases as ph


def read(rec):
    if rec["kind"] != "requests":
        return None
    s = (ph.phase_sum(rec["requests"], ph.PRINTOUT)
         + sum(r["write_s"] for r in rec["requests"]))
    return ph.per_unit_ms(rec, s)
