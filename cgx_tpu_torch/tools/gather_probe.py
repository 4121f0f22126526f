"""Gather probe: 32-word corpus windows read at scattered positions.

Port of ``tools/pallas_probe.py``, which measured on the TPU how fast the
device gathers the (MMOV + 2)-wide windows that the gappy lookups and the
extraction read at data-dependent corpus positions.  Its two Pallas kernels
become kernels P1 and P2 (``csrc/probe.cu``):

* ``gather_sum`` (P1, ``pallas_gather_fn``): the sum over items of the
  window ``ref[p:p+32]``, one int32 checksum (wrapping);
* ``gather_rows`` (P2, ``pallas_pipelined_fn``): each item's window copied
  into its output row, int32 [n, 32]; ``checksum`` sums the rows.

Both follow the probe's ``xla_gather`` (the definition it asserts the
Pallas checksums against): the window of the whole array with every read
clamped into it, as a JAX gather clamps.  As the probe's 512-item grid
does, both require ``n % 512 == 0`` (``launch``, the kernels' own entry,
takes any n and a grid).  The probe's ``xla_gather`` and
``xla_scalar_gather`` are plain gathers, not kernels: their counterparts
are the plain versions here, ``gather_sum_plain`` and ``scalar_sum_plain``.

    python -m cgx_tpu_torch.tools.gather_probe [--n 131072]
        [--corpus 1000000] [--reps 10] [--device cuda|cpu]

prints, per function, its milliseconds per call, gathered words per second
and checksum, and exits non-zero if a checksum differs from the plain
gather's.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.utils.views import take

W = 32        # window width per item (MMOV + 2, rounded up)
BLK = 512     # items per grid step of the TPU probe; n must be a multiple
# csrc/probe.cu: a block's warps (kWarps), each walking chunks of W items;
# the windows a warp loads before it uses one (kInFlight); the blocks an
# SM holds at once, which the kernels' launch bound guarantees
# (kBlocksPerSM)
WARPS = 8
IN_FLIGHT = 8
BLOCKS_PER_SM = 8


def _check(kernel, ref, pos, multiple: int = BLK):
    if ref.dim() != 1 or pos.dim() != 1 or ref.shape[0] < 1:
        raise ValueError(f"{kernel}: ref and pos must be int32 [L >= 1], [n]")
    if pos.shape[0] % multiple:
        raise ValueError(f"{kernel}: n = {pos.shape[0]} items is not a "
                         f"multiple of {multiple}")
    kb.check_count(kernel, pos.shape[0])


def checksum(x: torch.Tensor) -> torch.Tensor:
    """The int32 sum of ``x`` with wrap (``jnp.sum(..., dtype=int32)``), a
    0-dim int32 tensor: the probe's checksum of P2's rows."""
    s = x.long().sum() & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def windows(ref, pos):
    """Each item's window ``ref[pos[i] + 0 .. pos[i] + 31]``, reads clamped,
    for any n -> int32 [n, 32]."""
    return take(ref, pos[:, None] + torch.arange(W, dtype=pos.dtype,
                                                 device=pos.device))


def gather_rows_plain(ref, pos):
    """Plain PyTorch version of kernel P2 -> int32 [n, 32]."""
    _check("P2", ref, pos)
    return windows(ref, pos)


def gather_sum_plain(ref, pos):
    """Plain PyTorch version of kernel P1 (the probe's ``xla_gather``) ->
    0-dim int32 checksum."""
    return checksum(gather_rows_plain(ref, pos))


def scalar_sum_plain(ref, pos):
    """The probe's ``xla_scalar_gather``: the wrapped sum of ``ref[pos]``,
    one word per item."""
    return checksum(take(ref, pos))


def resident_blocks(device: torch.device) -> int:
    """The blocks of P1 or P2 that the card runs at once: every SM's
    ``BLOCKS_PER_SM``."""
    return torch.cuda.get_device_properties(
        device).multi_processor_count * BLOCKS_PER_SM


def grid(n: int, blocks: int) -> int:
    """The blocks that P1 and P2 launch for ``n >= 1`` items: ``blocks``,
    capped by the blocks whose warps have a chunk of 32 items."""
    return max(1, min(blocks, -(-n // (W * WARPS))))


def launch(kernel: str, ref, pos, blocks=None):
    """Kernel P1 (``kernel="P1"``: the checksum, 0-dim int32) or P2 (the
    rows, int32 [n, 32]) on CUDA tensors, for any ``n >= 0`` (the probe's
    functions take multiples of 512), on ``grid(n, blocks)`` blocks
    (default: ``resident_blocks``)."""
    _check(kernel, ref, pos, 1)
    device = pos.device
    if not kb.route(kernel, device):
        raise ValueError(f"{kernel}: launch takes CUDA tensors")
    kb.check_inputs(kernel, device, torch.int32, ref=ref, pos=pos)
    n = pos.shape[0]
    if not n:
        return (torch.zeros((), dtype=torch.int32, device=device)
                if kernel == "P1" else
                torch.empty((0, W), dtype=torch.int32, device=device))
    g = grid(n, resident_blocks(device) if blocks is None else blocks)
    if kernel == "P1":
        out = torch.empty(g + 1, dtype=torch.int32, device=device)
        res = out[g]
    else:
        res = out = torch.empty((n, W), dtype=torch.int32, device=device)
    kb.launch("probe", "cgx_probe_sum" if kernel == "P1" else
              "cgx_probe_rows", device, kb.ptr(ref), ref.shape[0],
              kb.ptr(pos), n, g, kb.ptr(out))
    kb.counted(kernel, n, kb.nbytes(pos, out))
    return res


def gather_sum(ref, pos):
    """Kernel P1 (``csrc/probe.cu``, ``cgx_probe_sum``): the wrapped int32
    sum over items of ``ref[pos[i] + 0 .. pos[i] + 31]`` (reads clamped
    into ``ref``) -> 0-dim int32.

    Replaces ``pallas_gather_fn`` (tools/pallas_probe.py:51).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``gather_sum_plain``."""
    _check("P1", ref, pos)
    if not kb.route("P1", pos.device):
        return gather_sum_plain(ref, pos)
    return launch("P1", ref, pos)


def gather_rows(ref, pos):
    """Kernel P2 (``csrc/probe.cu``, ``cgx_probe_rows``): row i holds
    ``ref[pos[i] + 0 .. pos[i] + 31]`` (reads clamped) -> int32 [n, 32].

    Replaces ``pallas_pipelined_fn`` (tools/pallas_probe.py:97).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``gather_rows_plain``."""
    _check("P2", ref, pos)
    if not kb.route("P2", pos.device):
        return gather_rows_plain(ref, pos)
    return launch("P2", ref, pos)


def library_rows(ref, pos):
    """One PyTorch call for P2's rows, a yardstick only: ``unfold`` views
    every window of ``ref`` and indexing copies the rows (needs ``pos`` <=
    len(ref) - 32; no clamping)."""
    return ref.unfold(0, W, 1)[pos]


def probe_data(n: int, corpus: int, seed: int = 0):
    """The probe's inputs (host numpy): tokens in [2, 1000) and positions in
    [0, corpus - 32)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(2, 1000, size=corpus).astype(np.int32)
    pos = rng.integers(0, corpus - W, size=n).astype(np.int32)
    return ref, pos


def time_ms(fn, device, reps: int) -> tuple:
    """(mean milliseconds per call after one warm-up call, its last
    result): CUDA events on the card, the host clock on the CPU."""
    out = fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / reps, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def run_probe(ref, pos, reps: int) -> dict:
    """Every function of the probe on (ref, pos) -> name -> (ms, words per
    second, checksum)."""
    device = pos.device
    n = pos.shape[0]
    fns = {
        "plain_gather": (lambda: gather_sum_plain(ref, pos), n * W),
        "plain_scalar": (lambda: scalar_sum_plain(ref, pos), n),
        "library_unfold": (lambda: library_rows(ref, pos).sum(
            dtype=torch.int32), n * W),
        "P1": (lambda: gather_sum(ref, pos), n * W),
        "P2": (lambda: checksum(gather_rows(ref, pos)), n * W),
    }
    out = {}
    for name, (fn, words) in fns.items():
        ms, r = time_ms(fn, device, reps)
        out[name] = (ms, words / (ms * 1e-3) if ms > 0 else float("inf"),
                     int(r))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--corpus", type=int, default=1000000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (use --device cpu "
                           "for the plain versions)")
    ref, pos = (torch.from_numpy(a).to(args.device)
                for a in probe_data(args.n, args.corpus))
    res = run_probe(ref, pos, args.reps)
    for name, (ms, rate, ck) in res.items():
        print(f"{name:15s} {ms:9.4f} ms  {rate / 1e6:10.0f}M words/s  "
              f"checksum {ck}")
    want = res["plain_gather"][2]
    bad = [k for k in ("library_unfold", "P1", "P2") if res[k][2] != want]
    if bad:
        print(f"checksum mismatch: {bad} against plain_gather {want}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
