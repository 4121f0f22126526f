"""device_idle_pct: 100 x (1 - the union of the device's operation
intervals / the traced window), from torch.profiler."""


def read(rec):
    d = rec.get("device")
    if d is None or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
