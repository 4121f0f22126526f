"""pipeline_other_ms: request wall time less search, extract, features and
grammar (query loading, qrysload, and the orchestration between phases),
per unit of the mix."""

from perfbench.metrics import _phases as ph


def read(rec):
    if rec["kind"] != "requests":
        return None
    reqs = rec["requests"]
    named = ph.phase_sum(reqs, ph.SEARCH + ph.EXTRACT + ph.FEATURES
                         + ph.PRINTOUT)
    rest = sum(r["wall_s"] - r["write_s"] for r in reqs) - named
    return ph.per_unit_ms(rec, rest)
