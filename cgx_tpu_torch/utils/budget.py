"""Device-memory budgeting: size the corpus index against the device before
any placement.

Port of ``cgx_tpu/utils/budget.py``.  The reference sizes itself to the
device up front: a hardcoded 2000 MB working budget (Start.cu:496) with
9.3/10 of it reserved for the reference index (REF_DEV_BUF_RATIO,
ComTypes.h:23), from which it derives the longest corpus that fits
(suffixArrayGetEquivalentMaxRefLen, SuffixArray.c:244-260).  Here the same
decision is made from real numbers: the replicated index's footprint is
computed from the corpus dimensions and compared against the device's
memory before placement, with a one-line message instead of an allocation
failure in the middle of the build.

The footprint counts exactly the tensors ``index.container.build_index``
places (``refstr_padded``, ``sa``, ``rlp``, ``lr_tar``, ``tgt_str``, int32,
bucket padding included).  It leaves to the remaining share
(1 - ``REF_INDEX_RATIO``) what the run places later: the interval-LCP tree
that only the LCP passes upload (``TorchGrammarIndex.lcp_tables``), kernel
A9's dense MaxLex tables (up to ``features.maxlex.DEV_DENSE_LIMIT``), the
precomputed occurrence rows, the query tokens and each launch's item
columns and outputs.

The JAX package spreads S shards over S devices and so picks, under
``auto``, the smallest S whose slice fits one device.  The port keeps every
shard on one device (shards across devices are ROADMAP queue A item 10b),
so a sharded layout fits only where its whole, halos included, does: here
``auto`` is the replicated index or a refusal, and an explicit shard count
is held whole to the device's budget by ``build_sharded_index``.

Budget discovery: the ``CGX_DEVICE_MEM_MB`` override first (also how tests
mock the budget), then on a CUDA device its total memory.  The CPU has no
device budget: the check is skipped there unless the override is set.
"""

from __future__ import annotations

import os

import torch

from cgx_tpu_torch.utils.batching import bucket_size

# ComTypes.h:23 REF_DEV_BUF_RATIO: the index's share of the device budget;
# the rest is working memory for kernel temporaries, query columns, results
REF_INDEX_RATIO = 9.3 / 10.0


def replicated_footprint_bytes(src_toklen: int, tgt_toklen: int,
                               qry_max_length: int = 1024,
                               max_rule_span: int = 15) -> int:
    """Bytes of the tensors ``index.container.build_index`` places: the
    padded corpus, the SA, the RLP words and the packed target spans, each
    bucket-padded to a power of two, and the target string unpadded."""
    ref_pad = bucket_size(src_toklen + qry_max_length + 16)
    sa = bucket_size(src_toklen)
    rlp = bucket_size(src_toklen + max_rule_span + 2)
    lr_tar = bucket_size(tgt_toklen + max_rule_span + 2)
    return 4 * (ref_pad + sa + rlp + lr_tar + tgt_toklen)


def device_budget_bytes(device="cuda") -> int | None:
    """Usable bytes on one device, or None on the CPU.
    ``CGX_DEVICE_MEM_MB`` overrides everything."""
    env = os.environ.get("CGX_DEVICE_MEM_MB")
    if env:
        return int(float(env) * 1024**2)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


class BudgetError(RuntimeError):
    """The requested layout cannot fit the device budget; the message is the
    one-line diagnosis."""


def check_fits(need: int, device, layout: str) -> None:
    """Raises BudgetError when ``need`` bytes of index (``layout`` names
    it) exceed the usable share of ``device``'s budget; no check where the
    device has no budget."""
    budget = device_budget_bytes(device)
    if budget is None:
        return
    usable = int(budget * REF_INDEX_RATIO)
    if need > usable:
        raise BudgetError(
            f"{layout} corpus index needs ~{need / 1e6:.0f} MB on one device "
            f"but the device budget is {budget / 1e6:.0f} MB "
            f"({usable / 1e6:.0f} MB usable at the {REF_INDEX_RATIO:.0%} "
            f"index ratio), and the port keeps every index shard on that "
            f"one device (shards across devices: ROADMAP queue A item 10b)")


def resolve_shards(sa_shards, src_toklen: int, tgt_toklen: int,
                   cfg=None, device="cuda") -> int:
    """Decide the index layout before any device placement.

    The port places all S shards of a sharded index on the one ``device``
    (``parallel.sharded``), so no layout spreads the index over devices:
    ``sa_shards`` 0 and "auto" both resolve to 0, the replicated index,
    and raise BudgetError when it cannot fit the device; N > 0 is honoured
    here and its whole layout, halos included, is held to the same budget
    where ``parallel.sharded.build_sharded_index`` has sized it.  Returns
    the resolved int."""
    if isinstance(sa_shards, str) and sa_shards != "auto":
        raise ValueError(f"sa_shards must be an int or 'auto', "
                         f"got {sa_shards!r}")
    shards = 0 if sa_shards == "auto" else int(sa_shards)
    if not shards:
        check_fits(replicated_footprint_bytes(
            src_toklen, tgt_toklen, getattr(cfg, "qry_max_length", 1024),
            getattr(cfg, "max_rule_span", 15)), device, "replicated")
    return shards
