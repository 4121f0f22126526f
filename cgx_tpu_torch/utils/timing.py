"""Phase wall-clock and device-memory ledger (timing_t, ComTypes.h:80-91;
recordTime, Start.cu:392-469).  The JAX package's counterpart is
``cgx_tpu/utils/timing.py``; here the device high-water mark comes from
``torch.cuda.max_memory_allocated``."""

from __future__ import annotations

import contextlib
import threading
import time

import torch


class PhaseTimer:
    """``phase(name)`` accumulates wall time per bucket.  On a CUDA device it
    synchronises at the end of each phase (so a phase's time includes its
    kernels) and records the allocator's peak bytes since the timer began;
    ``phase(name, sync=False)`` does neither, for a phase that launches
    nothing (a host phase that another thread runs while the main thread's
    kernels are in flight must not wait for them).  Phases may run on
    several threads at once; each adds to its bucket under a lock."""

    def __init__(self, device=None):
        self.buckets: dict = {}
        self.mem_after: dict = {}
        self._lock = threading.Lock()
        self.device = torch.device(device) if device is not None else None
        # per phase, the maximum over the processes of a multi-process run
        # (``parallel.multihost``); None otherwise
        self.global_phase_max = None
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            on_card = self._cuda and sync
            if on_card:
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(self.device) if on_card
                    else None)
            with self._lock:
                self.buckets[name] = self.buckets.get(name, 0.0) + seconds
                if peak is not None:
                    self.mem_after[name] = peak

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
        with self._lock:
            return dict(self.buckets)
