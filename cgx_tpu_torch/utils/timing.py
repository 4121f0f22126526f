"""Phase wall-clock and device-memory ledger (timing_t, ComTypes.h:80-91;
recordTime, Start.cu:392-469).  The JAX package's counterpart is
``cgx_tpu/utils/timing.py``; here the device high-water mark comes from
``torch.cuda.max_memory_allocated``."""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """``phase(name)`` accumulates wall time per bucket.  On a CUDA device it
    synchronises at the end of each phase (so a phase's time includes its
    kernels) and records the allocator's peak bytes since the timer began."""

    def __init__(self, device=None):
        self.buckets: dict = {}
        self.mem_after: dict = {}
        self.device = torch.device(device) if device is not None else None
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._cuda:
                torch.cuda.synchronize(self.device)
            self.buckets[name] = self.buckets.get(name, 0.0) + (
                time.perf_counter() - t0)
            if self._cuda:
                self.mem_after[name] = torch.cuda.max_memory_allocated(
                    self.device)

    def peak_memory(self) -> int:
        """Peak device bytes allocated during the timed phases; -1 on the CPU."""
        return max(self.mem_after.values(), default=-1)

    def report(self) -> str:
        total = sum(self.buckets.values())
        parts = [f"total: {total:.3f}s"]
        parts += [f"{k}: {v:.3f}s" for k, v in self.buckets.items()]
        if self.mem_after:
            parts.append(f"gpu_peak: {self.peak_memory() / 1e6:.1f}MB")
        return " , ".join(parts)

    def as_dict(self) -> dict:
        return dict(self.buckets)
