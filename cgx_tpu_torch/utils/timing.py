"""Phase wall-clock and device-memory ledger (timing_t, ComTypes.h:80-91;
recordTime, Start.cu:392-469).  The JAX package's counterpart is
``cgx_tpu/utils/timing.py``; here the device high-water mark comes from
``torch.cuda.max_memory_allocated``."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from cgx_tpu_torch.kernels import build as kb


# the prefix of a counter's key in ``PhaseTimer.as_dict``
COUNT = "count:"


class PhaseTimer:
    """``phase(name)`` accumulates wall time per bucket.  On a CUDA device it
    synchronises at the end of each phase (so a phase's time includes its
    kernels) and records the allocator's peak bytes since the timer began;
    ``phase(name, sync=False)`` does neither, for a phase that launches
    nothing (a host phase that another thread runs while the main thread's
    kernels are in flight must not wait for them).  Phases may run on
    several threads at once; each adds to its bucket under a lock.

    Phases nest: each thread keeps a stack of its open phases, and a phase
    opened inside another is a child, kept under ``parent/child`` (say
    ``lookup2/match``) in ``children``.  A child never synchronises and
    reads no allocator: it costs two clock reads and a dict update.  Only
    the top-level buckets reach ``report``, ``peak_memory`` and the
    ``--timefile`` line; ``as_dict`` returns every key, and with them the
    counters of ``kernels.build`` that grew since the timer began, so that
    one record carries both.  While a
    ``torch.profiler`` records, each phase is also a profiler range
    ``phase:<key>`` on the device trace's clock."""

    def __init__(self, device=None):
        self.buckets: dict = {}
        self.children: dict = {}
        self.mem_after: dict = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self.device = torch.device(device) if device is not None else None
        # per phase, the maximum over the processes of a multi-process run
        # (``parallel.multihost``); None otherwise
        self.global_phase_max = None
        # the counter registry when the timer began (``as_dict``)
        self._counts0 = kb.snapshot()
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    @property
    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open_phase(self):
        """The key of the innermost phase open on this thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        stack = self._stack()
        nested = bool(stack)
        key = f"{stack[-1]}/{name}" if nested else name
        rec = (torch.profiler.record_function("phase:" + key)
               if torch.autograd._profiler_enabled() else None)
        stack.append(key)
        if rec is not None:
            rec.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            on_card = self._cuda and sync and not nested
            if on_card:
                torch.cuda.synchronize(self.device)
                kb.COUNTS["syncs"] += 1
            seconds = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(self.device) if on_card
                    else None)
            if rec is not None:
                rec.__exit__(None, None, None)
            stack.pop()
            with self._lock:
                into = self.children if nested else self.buckets
                into[key] = into.get(key, 0.0) + seconds
                if peak is not None:
                    self.mem_after[key] = peak

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

    def as_dict(self, children: bool = True) -> dict:
        """Seconds per phase: the top-level buckets, then (unless
        ``children`` is False) every child under its ``parent/child``
        key and, under ``count:<name>``, each counter of
        ``kernels.build.snapshot()`` that grew since the timer began (the
        registry is the process's: it counts every thread's copies and
        launches, timed or not)."""
        with self._lock:
            out = dict(self.buckets)
            if children:
                out.update(self.children)
        if children:
            out.update({COUNT + k: v
                        for k, v in kb.grown(self._counts0).items()})
        return out


def child(timer, name: str):
    """``timer.phase(name, sync=False)`` under the phase open on this
    thread; nothing without a timer or an open phase, so a child never
    becomes a top-level bucket."""
    if timer is None or timer.open_phase() is None:
        return contextlib.nullcontext()
    return timer.phase(name, sync=False)
