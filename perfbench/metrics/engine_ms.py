"""engine_ms: every engine call of the requests (the ``engine.*`` child
phases: host tables, upload, launch, the wait and the copy down), the
host's view of the device stages, per unit of the mix."""

from perfbench.metrics import _phases as ph
from perfbench.metrics import _spans as sp


def read(rec):
    if rec["kind"] != "requests" or not sp.has_children(rec["requests"]):
        return None
    return ph.per_unit_ms(rec, sum(sp.engine_seconds(r["phases"])
                                   for r in rec["requests"]))
