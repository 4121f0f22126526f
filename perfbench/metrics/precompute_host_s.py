"""precompute_host_s: the precompute less its engine calls (the host's
top tokens, partner scans, rows and sort around kernel A4), per completed
build."""

from perfbench.metrics import _spans as sp


def read(rec):
    if rec["kind"] != "build" or not rec["per_count"]:
        return None
    builds = [b for b in rec["builds"] if b["ok"]]
    if not sp.has_children(builds, "precompute"):
        return None
    return sp.host_seconds(builds, "precompute") / rec["per_count"]
