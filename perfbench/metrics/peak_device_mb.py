"""peak_device_mb: torch.cuda.max_memory_allocated over set-up and window,
in 1e6 bytes."""


def read(rec):
    return rec["peak_bytes"] / 1e6 if rec["peak_bytes"] else None
