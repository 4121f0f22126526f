"""Shared arithmetic of the per-layer readers: the program's phases summed
over a window's requests or builds, per unit of the mix (a sentence, a
request or a build)."""

SEARCH = ("kernel", "kernel2", "enumeration", "lookup1", "lookup2")
EXTRACT = ("extractin", "extractkernel")
FEATURES = ("lexicon", "maxlex")
PRINTOUT = ("printout",)


def phase_sum(items, names) -> float:
    return sum(it["phases"].get(n, 0.0) for it in items for n in names)


def per_unit_ms(rec, seconds: float):
    """``seconds`` over the window in milliseconds per unit of the mix;
    None where the record has no request."""
    if rec["kind"] != "requests" or not rec["per_count"]:
        return None
    return 1e3 * seconds / rec["per_count"]


def per_build_s(rec, names):
    """The phases ``names`` per completed build."""
    if rec["kind"] != "build" or not rec["per_count"]:
        return None
    return phase_sum(rec["builds"], names) / rec["per_count"]
