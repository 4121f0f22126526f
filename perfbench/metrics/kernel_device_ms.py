"""kernel_device_ms: the device's kernel time in the traced window
(torch.profiler), per unit of the mix."""

from perfbench.metrics import _phases as ph


def read(rec):
    d = rec.get("device")
    if d is None or rec["kind"] != "requests" or d["kernel_s"] <= 0:
        return None
    return ph.per_unit_ms(rec, d["kernel_s"])
