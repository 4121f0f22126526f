"""features_ms: the lexicon and MaxLex (phases lexicon, maxlex) per unit
of the mix."""

from perfbench.metrics import _phases as ph


def read(rec):
    if rec["kind"] != "requests":
        return None
    return ph.per_unit_ms(rec, ph.phase_sum(rec["requests"], ph.FEATURES))
