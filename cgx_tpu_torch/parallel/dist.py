"""Query-data-parallel search: pass 1 and contiguous extraction over shards
of the work-item axes, with global counts.

Port of ``cgx_tpu/parallel/dist.py``.  The JAX package places a replicated
index on every device of a ``Mesh``, shards the item arrays over its "dp"
axis and runs one ``shard_map`` step: pass 1 over the query-token lanes,
the contiguous extraction over the sampled occurrences, and a ``psum`` of
the match and rule counts.  Here a "mesh" is a list of ``torch.device``s,
one per shard (``make_mesh(n)``: ``cuda:0`` .. ``cuda:n-1``), and may
repeat a device: shard s runs as one launch of kernel B4 (``csrc/dist.cu``,
``cgx_dp_step``) on its device, with that device current
(``kernels.build.launch``), on its slice of the items, so S shards on one
card run as S launches there.  The ``psum`` is the sum of the S per-shard
counters, copied to the first device and added there in int32 with wrap:
no collective, and so no NCCL, is needed.

Results for real (non-padding) items equal the single-device path; the
padding items take part in the counts exactly as in the JAX step.
"""

from __future__ import annotations

import numpy as np
import torch

from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.extract.blocks import occurrence_lists
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.search import passes


def make_mesh(n_devices: int = None, devices=None) -> list:
    """The shards' devices: ``devices`` as given (a device may repeat), or
    the first ``n_devices`` CUDA devices (default all of them)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                               f"{count} present")
        devices = [torch.device("cuda", i) for i in range(n)]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return devices


def pad_to_multiple(a: np.ndarray, m: int, fill) -> np.ndarray:
    r = (-len(a)) % m
    if r == 0:
        return a
    return np.concatenate([a, np.full((r,) + a.shape[1:], fill, a.dtype)])


def shard_items(devices, a, fill=0) -> list:
    """The item axis padded with ``fill`` to a multiple of the shard count
    and cut into equal contiguous slices, slice s on ``devices[s]`` (the
    JAX ``P("dp")`` placement)."""
    a = pad_to_multiple(np.asarray(a), len(devices), fill)
    chunk = len(a) // len(devices)
    return [kb.to_device(a[s * chunk:(s + 1) * chunk], d)
            for s, d in enumerate(devices)]


def replicate(devices, a) -> list:
    """``a`` on every shard's device, uploaded once per distinct device."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = kb.to_device(torch.as_tensor(a), d)
    return [copies[d] for d in devices]


def wrap32(x: int) -> int:
    """An integer reduced mod 2**32 to int32, as a JAX int32 sum wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def dp_step_plain(refstr, sa, lcpleft, lcpright, rlp, lr_tar, qtok, toks,
                  suffixlens, sa_pos, lms, reflen: int, mrs: int, msym: int):
    """Plain PyTorch version of kernel B4 -> (p1 int32 [6, n], ex int32 [8,
    m], counts int32 [2])."""
    p1 = torch.stack(passes.pass1_plain(refstr, sa, lcpleft, lcpright, qtok,
                                        toks, suffixlens, reflen))
    ex = xdev.contig_plain(refstr, sa, rlp, lr_tar, sa_pos, lms, mrs, msym)
    n_match = (p1[0] > 0).sum()
    n_rules = (ex[1::2] & 1).sum()
    counts = torch.tensor([wrap32(n_match), wrap32(n_rules)],
                          dtype=torch.int32, device=toks.device)
    return p1, ex, counts


def dp_step(refstr, sa, lcpleft, lcpright, rlp, lr_tar, qtok, toks,
            suffixlens, sa_pos, lms, reflen: int, mrs: int, msym: int):
    """Kernel B4 (``csrc/dist.cu``, ``cgx_dp_step``) on one shard: B1's pass
    1 over the lanes (``toks[i]``, ``suffixlens[i]``), A6's contiguous
    extraction over the items (``sa[sa_pos[j]]``, ``lms[j]``), and the
    shard's counts (lanes with longestmatch > 0; valid family bits).
    Returns (p1 int32 [6, n], ex int32 [8, m], counts int32 [2]).

    Replaces the per-shard ``step`` of ``make_sharded_search_step``
    (cgx_tpu/parallel/dist.py:56).  On CUDA tensors it launches the kernel;
    on CPU tensors it runs ``dp_step_plain``."""
    device = toks.device
    if not kb.route("B4", device):
        return dp_step_plain(refstr, sa, lcpleft, lcpright, rlp, lr_tar,
                             qtok, toks, suffixlens, sa_pos, lms, reflen, mrs,
                             msym)
    kb.check_inputs("B4", device, torch.int32, refstr=refstr, sa=sa,
                    lcpleft=lcpleft, lcpright=lcpright, rlp=rlp,
                    lr_tar=lr_tar, qtok=qtok, toks=toks,
                    suffixlens=suffixlens, sa_pos=sa_pos, lms=lms)
    n, m = toks.shape[0], sa_pos.shape[0]
    if suffixlens.shape != (n,) or lms.shape != (m,):
        raise ValueError("B4: lane or item arrays differ in length")
    kb.check_count("B4", n)
    kb.check_count("B4", m)
    p1 = torch.empty((6, n), dtype=torch.int32, device=device)
    ex = torch.empty((8, m), dtype=torch.int32, device=device)
    counts = torch.zeros(2, dtype=torch.int32, device=device)
    if n or m:
        kb.launch(
            "dist", "cgx_dp_step", device, kb.ptr(refstr), refstr.shape[0],
            kb.ptr(sa), sa.shape[0], kb.ptr(lcpleft), kb.ptr(lcpright),
            lcpleft.shape[0], kb.ptr(qtok), qtok.shape[0], kb.ptr(rlp),
            rlp.shape[0], kb.ptr(lr_tar), lr_tar.shape[0], kb.ptr(toks),
            kb.ptr(suffixlens), n, reflen, kb.ptr(sa_pos), kb.ptr(lms), m, mrs,
            msym, kb.ptr(p1), kb.ptr(ex), kb.ptr(counts))
        kb.counted("B4", n + m, kb.nbytes(toks, suffixlens, sa_pos, lms,
                                          p1, ex, counts))
    return p1, ex, counts


def make_sharded_search_step(devices, reflen: int, mrs: int, msym: int):
    """(replicated index arrays, per-shard item slices) -> (p1: six int32
    [S * n_s], ex: eight int32 [S * m_s], n_match, n_rules).  Each argument
    is a list with one entry per shard (``replicate``, ``shard_items``);
    the outputs are concatenated in shard order on ``devices[0]``, and the
    counts are the wrapped int32 sums of the shards' counters."""
    devices = list(devices)

    def step(refstr, refsa, lcpleft, lcpright, rlp, lr_tar, qtokens, toks,
             suffixlens, sa_pos, lms):
        outs = [dp_step(*args, reflen, mrs, msym) for args in zip(
            refstr, refsa, lcpleft, lcpright, rlp, lr_tar, qtokens, toks,
            suffixlens, sa_pos, lms)]
        home = devices[0]
        p1 = torch.cat([o[0].to(home) for o in outs], dim=1)
        ex = torch.cat([o[1].to(home) for o in outs], dim=1)
        total = torch.stack([o[2].to(home) for o in outs]).long().sum(dim=0)
        n_match, n_rules = (wrap32(v) for v in kb.to_host(total).tolist())
        return tuple(p1), tuple(ex), n_match, n_rules
    return step


def contig_occurrences(blocks, cfg):
    """Sampled occurrence work list for the contiguous extraction: (block
    numbers int64, SA positions int32, block lengths int32), block by block
    and in SA order within a block, blocks with matchlen < 1 skipped (the
    JAX package's ``contig_occurrences``)."""
    lo = np.where(blocks.matchlen >= 1, blocks.start, 0)
    hi = np.where(blocks.matchlen >= 1, blocks.end, -1)
    bnums, tx = occurrence_lists(lo, hi, cfg.sampler, cfg.is_sample)
    bnums = np.asarray(bnums, np.int64)
    sa_pos = np.asarray(blocks.start, np.int64)[bnums] + tx
    return (bnums, sa_pos.astype(np.int32),
            np.asarray(blocks.matchlen)[bnums].astype(np.int32))


def run_sharded_search(devices, index, queries, blocks, cfg):
    """Query-DP pass 1 and contiguous extraction over the shards' devices on
    a ``TorchGrammarIndex``; returns the pass-1 longestmatch array (host)
    and the global counts (n_match, n_rules).  Each shard's B4 takes all its
    occurrences in one launch: unlike ``extract.device``'s calls of at most
    ``CALL_ITEMS``, its device memory grows with the request's
    occurrences."""
    n = queries.totaltokens
    toks = np.arange(n, dtype=np.int32)
    suffixlens = passes._suffix_lens(queries)
    _, sa_pos, lms = contig_occurrences(blocks, cfg)
    lcpleft, lcpright = index.lcp_tables()
    step = make_sharded_search_step(devices, index.reflen, cfg.max_rule_span,
                                    cfg.max_rule_symbols)
    p1, _, n_match, n_rules = step(
        *(replicate(devices, a) for a in (
            index.refstr_padded, index.sa, lcpleft, lcpright, index.rlp,
            index.lr_tar, index.query_tokens(queries))),
        shard_items(devices, toks), shard_items(devices, suffixlens),
        shard_items(devices, sa_pos), shard_items(devices, lms))
    return kb.to_host(p1[0][:n]).numpy(), n_match, n_rules
