"""The sharded index: every O(corpus) array split into shards.

Port of ``cgx_tpu/parallel/sharded.py``, the JAX package's layout for
corpora beyond one device's memory (``run_pipeline(..., sa_shards=S)``,
``--sa-shards S``).  Layout, word for word the JAX package's:

* ``sa``             -- RANK-sharded: contiguous chunks of BR global ranks;
* ``refstr``/``rlp`` -- TOKEN-sharded: contiguous chunks of B corpus
  positions plus bounded halos (back: one sentence plus a rule span, for the
  sentence-anchor walk; front: a rule span plus the scan moves);
* ``lr_tar``         -- TARGET-sharded: the target range of the sentences
  overlapping each source slice;
* no interval-LCP tree: the sharded search below never reads one.

Pass 1/2 is the interval refinement (``passes.drive_refinement`` with the
host seed tables) whose probes read the rank-sharded SA and the
token-sharded corpus; SA values at global ranks come from the same gather
(kernel B2g).  The scans and extractions are owner-computes: each work item
goes to the shard that owns the corpus position it reads around and runs
there, on the shard's device, over the shard's slices through
``OffsetView``s (kernels B3f, B3b, B3p, B3t, B3c, and A4, A7, A8 on views).

Placement (``placement``): shard s lies on ``devices[s]`` of a device list,
as the JAX package's ``NamedSharding(mesh, P("sa"))`` puts it on the
mesh's s-th device; a device may repeat (``["cuda:0"] * 4`` checks the
layout on one card, ``["cpu"] * S`` on the CPU).  Given one device, every
shard lies on it, except that a bare ``"cuda"`` with k >= 2 visible cards
places shard s on ``cuda:(s mod k)``.  The layout decides the refinement's
form: over shards given one device, one launch of kernel B2r reaches them
all through a pointer table; over a device list, the JAX form: every
shard's device steps the same lockstep bisection over its own copy of the
lanes (kernel B2s) and only the reads of each step are summed across the
shards (B2s's SA words, then kernel B2t's tokens), on the lanes' home
device (``ShardedGrammarIndex.device``, the first local shard's).  A step
reads five bisection levels ahead, or every depth of a dispatch whose
intervals are at most one row (``round_plan``).

With several processes (``parallel.multihost``, torch.distributed joined)
the global shard list runs process-major, process p holding the contiguous
block of shards ``local_shards()``; each process places only its own and
runs the whole (deterministic) item list: it fills the outputs its shards
own, and every output and every step's partial sum is then summed across
the processes with one gloo ``all_reduce`` of host int32 (each row is
owned by exactly one shard, the others give 0), as the JAX package sums
with one allgather per output.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import numpy as np
import torch
import torch.distributed as tdist

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.engine import (host, materialize_items, on, traced,
                                  two_gap_occurrences)
from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.search import lookup, passes
from cgx_tpu_torch.search import precompute as pcx
from cgx_tpu_torch.utils import budget
from cgx_tpu_torch.utils.views import OffsetView, take

MMOV = 16          # scan move width (search.lookup.MMOV)

# the JAX ShardedGrammarIndex fields ``from_jax_sharded`` reads
SHARDED_FIELDS = ("S", "reflen", "ref_glen", "rlp_glen", "tgt_glen", "B",
                  "BR", "BH", "sa_l", "ref_l", "rlp_l", "lrt_l", "src_off",
                  "tgt_off", "rmeta", "smeta", "seed_lo1", "seed_hi1",
                  "seed_pk", "seed_pk3")


@dataclasses.dataclass
class ShardedGrammarIndex:
    S: int
    reflen: int          # global rank count (= corpus token count)
    ref_glen: int        # padded refstr global length
    rlp_glen: int
    tgt_glen: int
    B: int               # owned source tokens per shard
    BR: int              # owned ranks per shard
    BH: int              # source back halo
    device: torch.device  # the lanes' home: the first local shard's device
    sa_l: list           # S x int32 [BR]: rank slices of the global SA
    ref_l: list          # S x int32 [tlen]: token slices of refstr_padded
    rlp_l: list          # S x int32 [tlen]: the uint32 RLP words' bits
    lrt_l: list          # S x int32 [ttlen]: target slices of lr_tar
    src_off: np.ndarray  # int64 [S] global index of ref_l[s][0]
    tgt_off: np.ndarray  # int64 [S] global index of lrt_l[s][0]
    rmeta: np.ndarray    # int32 [S, 2] (rank_start, rank_count)
    smeta: np.ndarray    # int32 [S, 3] (src_off, own_lo, own_hi)
    # host seed tables answering refinement depths 0-2 (passes)
    seed_lo1: np.ndarray = None
    seed_hi1: np.ndarray = None
    seed_pk: np.ndarray = None
    seed_pk3: np.ndarray = None
    # shard s's device (None, with its slices, for another process's
    # shard); ``listed``: placed on a device list (B2s/B2t and B2g per
    # owner), else every shard was given one device (B2r, B2g at once)
    devices: list = None
    listed: bool = False
    n_processes: int = 1
    _tables: tuple = dataclasses.field(default=None, repr=False)
    _shard_tables: dict = dataclasses.field(default_factory=dict,
                                            repr=False)
    _qtok: tuple = dataclasses.field(default=None, repr=False)

    def owner_of(self, pos: np.ndarray) -> np.ndarray:
        """Owning shard of a corpus position (uniform chunks)."""
        return np.clip(np.asarray(pos, np.int64) // self.B, 0, self.S - 1)

    def local_shards(self) -> list:
        """The shards this process holds: all of them in one process, its
        contiguous block of the process-major list in several."""
        return [s for s in range(self.S) if self.devices[s] is not None]

    def device_of(self, s: int) -> torch.device:
        """The device of shard ``s`` (a shard this process holds)."""
        if self.devices[s] is None:
            raise KeyError(f"shard {s} is held by another process")
        return self.devices[s]

    def shard_arrays(self, s: int) -> tuple:
        """(refstr, rlp, lr_tar) of shard ``s`` as ``OffsetView``s that take
        global indices."""
        off, toff = int(self.src_off[s]), int(self.tgt_off[s])
        return (OffsetView(self.ref_l[s], off, self.ref_glen),
                OffsetView(self.rlp_l[s], off, self.rlp_glen),
                OffsetView(self.lrt_l[s], toff, self.tgt_glen))

    def _slice_words(self) -> dict:
        s = self.local_shards()[0]
        return {"sa": self.sa_l[s].shape[0], "refstr": self.ref_l[s].shape[0],
                "rlp": self.rlp_l[s].shape[0], "lr_tar": self.lrt_l[s].shape[0]}

    def memory_per_device(self) -> dict:
        """Bytes of index state per shard, and of the replicated index's
        O(corpus) arrays for comparison (the JAX package's accounting)."""
        per = {k: 4 * v for k, v in self._slice_words().items()}
        per["total"] = sum(per.values())
        per["replicated_equiv"] = 4 * (
            self.ref_glen + self.reflen * 3 + self.rlp_glen + self.tgt_glen)
        return per

    def bytes_per_device(self) -> dict:
        """Bytes of this process's shard slices on each of its devices (a
        device that repeats holds all of its shards)."""
        total = self.memory_per_device()["total"]
        return {str(d): total * c for d, c in collections.Counter(
            self.devices[s] for s in self.local_shards()).items()}

    def device_tables(self) -> tuple:
        """(sa_ptrs, ref_ptrs, rmeta, smeta) on the shards' one device,
        built once: kernels B2r and B2g reach the shards through arrays of
        their slice pointers and the int32 meta tables."""
        if self._tables is None:
            dev = self.device
            self._tables = (
                torch.tensor([t.data_ptr() for t in self.sa_l],
                             dtype=torch.int64, device=dev),
                torch.tensor([t.data_ptr() for t in self.ref_l],
                             dtype=torch.int64, device=dev),
                kb.to_device(self.rmeta, dev), kb.to_device(self.smeta, dev))
        return self._tables

    def shard_table(self, s: int) -> tuple:
        """(sa_ptrs [1], rmeta [1, 2]) of shard ``s`` alone on its device,
        built once: kernel B2g over the one shard."""
        if s not in self._shard_tables:
            dev = self.device_of(s)
            self._shard_tables[s] = (
                torch.tensor([self.sa_l[s].data_ptr()], dtype=torch.int64,
                             device=dev),
                kb.to_device(self.rmeta[s:s + 1], dev))
        return self._shard_tables[s]

    def qtok_on(self, s: int, queries) -> torch.Tensor:
        """``queries.padded_tokens()`` on shard ``s``'s device, one copy a
        device, cached for the most recent query set (held weakly)."""
        return self._tokens_on(self.device_of(s), queries)

    def query_tokens(self, queries) -> torch.Tensor:
        """``queries.padded_tokens()`` on the home device."""
        return self._tokens_on(self.device, queries)

    def _tokens_on(self, device, queries) -> torch.Tensor:
        if self._qtok is None or self._qtok[0]() is not queries:
            self._qtok = (weakref.ref(queries), {})
        copies = self._qtok[1]
        if device not in copies:
            copies[device] = kb.to_device(queries.padded_tokens(), device)
        return copies[device]


def process_group() -> tuple:
    """(this process's rank, the process count) of the joined
    torch.distributed group, or (0, 1)."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def _normal(device) -> torch.device:
    """``device`` with its index (a bare "cuda" is the current card); a
    card that is not there, and a device with no kernels, are refused."""
    d = torch.device(device)
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"sharded index: no kernels for device {d}")
    if d.type == "cuda":
        count = torch.cuda.device_count()
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if not 0 <= d.index < count:
            raise ValueError(f"sharded index: {d} named, but {count} CUDA "
                             f"devices are visible")
    return d


def placement(S: int, device) -> tuple:
    """Where an ``S``-shard index lies -> (devices: shard s's device, None
    for another process's shard; listed: whether it lies on a device
    list).

    ``device`` is a list of S devices (shard s on the s-th; a device may
    repeat), or one device: every shard on it, except that a bare "cuda"
    with k >= 2 visible cards places shard s on ``cuda:(s mod k)``.  With
    several processes the shards split process-major into contiguous
    blocks (``ceil(S / P)`` a process); a process places its own shards
    only (from a list, at their entries; from one device, its j-th own
    shard as the j-th above), and the index counts as placed on a list."""
    rank, P = process_group()
    if S < P:
        raise ValueError(f"sharded index: {S} shards over {P} processes "
                         f"leave a process without a shard")
    per = -(-S // P)
    own = range(rank * per, min((rank + 1) * per, S))
    if isinstance(device, (list, tuple)):
        if len(device) != S:
            raise ValueError(f"sharded index: {len(device)} devices for {S} "
                             f"shards")
        devs = [_normal(device[s]) for s in own]
        listed = True
    else:
        d = torch.device(device)
        k = torch.cuda.device_count() if d.type == "cuda" else 1
        if d.type == "cuda" and d.index is None and k >= 2:
            devs = [torch.device("cuda", j % k) for j in range(len(own))]
            listed = True
        else:
            devs = [_normal(d)] * len(own)
            listed = P > 1
    devices = [None] * S
    for s, d in zip(own, devs):
        devices[s] = d
    return devices, listed


def rank_token_slices(refstr_padded: np.ndarray, sa: np.ndarray,
                      reflen: int, S: int, BH: int, FH: int) -> dict:
    """The rank-sharded SA and the token-sharded corpus of an ``S``-shard
    index: shard s owns the ranks [s BR, s BR + BR) and the positions
    [s B, s B + B) of the padded corpus, its token slice reaching ``BH``
    tokens back and ``FH`` on (0 outside the corpus), its rank slice padded
    with the last SA word -> {B, BR, sa_l [S, BR], ref_l [S, B + BH + FH],
    src_off [S], rmeta [S, 2] (rank_start, rank_count), smeta [S, 3]
    (src_off, own_lo, own_hi)}."""
    ref_glen = len(refstr_padded)
    B = -(-ref_glen // S)
    own_lo = np.arange(S, dtype=np.int64) * B
    own_hi = np.minimum(own_lo + B, ref_glen)
    src_off = own_lo - BH
    cols = src_off[:, None] + np.arange(B + BH + FH)[None, :]
    inb = (cols >= 0) & (cols < ref_glen)
    ref_l = np.where(inb, refstr_padded[np.clip(cols, 0, ref_glen - 1)],
                     0).astype(np.int32)
    BR = -(-reflen // S)
    rstart = np.arange(S, dtype=np.int64) * BR
    rcount = np.minimum(rstart + BR, reflen) - rstart
    rcols = rstart[:, None] + np.arange(BR)[None, :]
    sa_l = np.asarray(sa, np.int32)[np.clip(rcols, 0, reflen - 1)]
    return dict(B=B, BR=BR, sa_l=sa_l, ref_l=ref_l, src_off=src_off,
                rmeta=np.stack([rstart, rcount], axis=1),
                smeta=np.stack([src_off, own_lo, own_hi], axis=1))


def build_sharded_index(source, target, sa, align, cfg: ExtractorConfig,
                        n_shards: int, device="cuda") -> ShardedGrammarIndex:
    """Slice the corpus index into ``n_shards`` shards, word for word as
    ``cgx_tpu.parallel.sharded.build_sharded_index`` does, placed on
    ``device`` (one device or a list, ``placement``)."""
    S = int(n_shards)
    if S < 1:
        raise ValueError(f"sharded index: {S} shards")
    devices, listed = placement(S, device)
    mrs = cfg.max_rule_span
    refstr_padded = passes.pad_refstr(np.asarray(source.str_),
                                      cfg.qry_max_length)
    rlp_padded = np.concatenate([
        np.asarray(align.RLP, dtype=np.uint32),
        np.full(mrs + 2, 0xFFFF0000, dtype=np.uint32)])
    tgt_pad = np.full(mrs + 2, 255, dtype=np.int32)
    l_tar = np.concatenate([align.L_tar.astype(np.int32), tgt_pad])
    r_tar = np.concatenate([align.R_tar.astype(np.int32), tgt_pad])
    lr_tar = (l_tar << 8) | r_tar

    reflen = source.toklen
    ref_glen = len(refstr_padded)
    rlp_glen = len(rlp_padded)
    tgt_glen = len(lr_tar)

    # ---- rank-sharded SA, token-sharded source slices (bounded halos)
    BH = 256 + mrs + 16                 # sentence-anchor walk + span + slack
    FH = mrs + MMOV + 2 * mrs + 32      # scans + growth windows + slack
    sa_np = np.asarray(sa.sa, dtype=np.int32)
    sl = rank_token_slices(refstr_padded, sa_np, reflen, S, BH, FH)
    src_off = sl["src_off"]
    own_lo, own_hi = sl["smeta"][:, 1], sl["smeta"][:, 2]
    cols = src_off[:, None] + np.arange(sl["ref_l"].shape[1])[None, :]
    inb_r = (cols >= 0) & (cols < rlp_glen)
    rlp_l = np.where(inb_r, rlp_padded[np.clip(cols, 0, rlp_glen - 1)],
                     np.uint32(0xFFFF0000)).astype(np.uint32)

    # ---- target slices: sentences overlapping each source slice (+slack)
    src_sent = np.asarray(source.sentenceind, dtype=np.int64)
    tgt_sent = np.asarray(target.sentenceind, dtype=np.int64)
    n_sent = len(src_sent) - 1

    def sent_of(pos):
        return np.clip(np.searchsorted(src_sent, pos, side="right") - 1,
                       0, n_sent - 1)
    s_first = sent_of(np.maximum(own_lo - BH, 0))
    s_last = sent_of(np.minimum(own_hi + FH, reflen - 1))
    TH = MMOV + 2
    tgt_lo = np.maximum(tgt_sent[s_first] - TH, 0)
    tgt_hi = np.minimum(tgt_sent[np.minimum(s_last + 1, n_sent)] + TH,
                        tgt_glen)
    tgt_hi[-1] = tgt_glen              # last shard sees the global pad rows
    ttlen = int((tgt_hi - tgt_lo).max())
    tcols = tgt_lo[:, None] + np.arange(ttlen)[None, :]
    tinb = (tcols >= 0) & (tcols < tgt_glen)
    lrt_l = np.where(tinb, lr_tar[np.clip(tcols, 0, tgt_glen - 1)],
                     (255 << 8) | 255).astype(np.int32)

    # each device's shards, halos included, are held to its budget before
    # anything is placed: a device that repeats holds all of its shards (the
    # shards' pointer and meta tables, a few words each, are left to the
    # remaining share)
    shard_bytes = sum(a[0].nbytes for a in (sl["sa_l"], sl["ref_l"], rlp_l,
                                            lrt_l))
    for dev, count in collections.Counter(
            d for d in devices if d is not None).items():
        budget.check_fits(count * shard_bytes, dev, f"{S}-shard")
    seed = passes.build_seed_tables(refstr_padded, sa_np.astype(np.int64))
    return _make(dict(
        S=S, reflen=reflen, ref_glen=ref_glen, rlp_glen=rlp_glen,
        tgt_glen=tgt_glen, BH=BH, **sl, rlp_l=rlp_l, lrt_l=lrt_l,
        tgt_off=tgt_lo, seed_lo1=seed[0], seed_hi1=seed[1], seed_pk=seed[2],
        seed_pk3=seed[3]), devices, listed)


def _make(a: dict, devices: list, listed: bool) -> ShardedGrammarIndex:
    S = int(a["S"])

    def put(x, dtype=np.int32):   # writable int32 copies of the own shards
        x = np.asarray(x, dtype)
        if dtype == np.uint32:
            x = x.view(np.int32)
        return [None if d is None else
                kb.to_device(np.array(x[s], np.int32), d)
                for s, d in enumerate(devices)]

    seed_pk3 = a["seed_pk3"]
    return ShardedGrammarIndex(
        S=S, reflen=int(a["reflen"]), ref_glen=int(a["ref_glen"]),
        rlp_glen=int(a["rlp_glen"]), tgt_glen=int(a["tgt_glen"]),
        B=int(a["B"]), BR=int(a["BR"]), BH=int(a["BH"]),
        device=next(d for d in devices if d is not None),
        sa_l=put(a["sa_l"]), ref_l=put(a["ref_l"]),
        rlp_l=put(a["rlp_l"], np.uint32), lrt_l=put(a["lrt_l"]),
        src_off=np.asarray(a["src_off"], np.int64),
        tgt_off=np.asarray(a["tgt_off"], np.int64),
        rmeta=np.asarray(a["rmeta"], np.int32).reshape(S, 2),
        smeta=np.asarray(a["smeta"], np.int32).reshape(S, 3),
        seed_lo1=np.asarray(a["seed_lo1"], np.int64),
        seed_hi1=np.asarray(a["seed_hi1"], np.int64),
        seed_pk=np.asarray(a["seed_pk"], np.int64),
        seed_pk3=None if seed_pk3 is None else np.asarray(seed_pk3,
                                                          np.int64),
        devices=devices, listed=listed, n_processes=process_group()[1])


def from_jax_sharded(sidx_arrays: dict, device) -> ShardedGrammarIndex:
    """A ShardedGrammarIndex from the numpy arrays and scalars of a JAX
    ``ShardedGrammarIndex`` (``SHARDED_FIELDS``; ``rmeta``/``smeta`` in its
    [S, 1, k] shape or flat), placed on ``device`` (one device or a list,
    ``placement``)."""
    return _make(sidx_arrays, *placement(int(sidx_arrays["S"]), device))


# ---------------------------------------------------------------------------
# Kernel B2: the distributed single-token gathers and the refinement search
# ---------------------------------------------------------------------------

def _g_sa(sidx, r, shards=None):
    """The SA value at global rank ``r`` as the JAX ``psum`` gives it: the
    sum over shards (default all) of the owner's word, 0 from every other
    shard."""
    v = torch.zeros_like(r)
    for s in range(sidx.S) if shards is None else shards:
        rstart, rcount = (int(x) for x in sidx.rmeta[s])
        loc = r - rstart
        ok = (loc >= 0) & (loc < rcount)
        v = v + torch.where(ok, take(sidx.sa_l[s], loc), 0)
    return v


def _g_ref(sidx, p):
    """The corpus token at global position ``p``, summed over shards like
    ``_g_sa``."""
    v = torch.zeros_like(p)
    for s in range(sidx.S):
        soff, olo, ohi = (int(x) for x in sidx.smeta[s])
        ok = (p >= olo) & (p < ohi)
        v = v + torch.where(ok, take(sidx.ref_l[s], p - soff), 0)
    return v


def refine_sharded_plain(sidx, qtok, toks, sls, lo, hi, d0: int,
                         depths: int, need: dict = None):
    """Plain PyTorch version of kernel B2r: ``passes.refine_chunk_plain``
    with every probe read through the shard gathers.  Given a ``need``
    dict, it records each bisection step's global ranks (``sa``) and key
    positions (``refstr``) and each depth's query token (``qtok``), as
    ``refine_chunk_plain`` does (``tools/reads.py`` ``refine_need``)."""
    def lower_bound(l, h, key, depth):
        while True:
            act = h > l
            if not bool(act.any()):
                return l
            M = (l + h) >> 1
            pos = _g_sa(sidx, M) + depth
            if need is not None:
                need.setdefault("sa", []).append((M, act))
                need.setdefault("refstr", []).append((pos, act))
            t = _g_ref(sidx, pos)
            ge = t >= key
            l = torch.where(act & ~ge, M + 1, l)
            h = torch.where(act & ge, M, h)

    ups, downs = [], []
    for c in range(depths):
        depth = d0 + c
        qt = torch.where(depth < sls, take(qtok, toks + depth),
                         torch.full_like(toks, -1))
        if need is not None:
            need.setdefault("qtok", []).append((toks + depth,
                                                (depth < sls) & (hi > lo)))
        nlo = lower_bound(lo, hi, qt, depth)
        nhi = lower_bound(nlo, hi, qt + 1, depth)
        ups.append(nlo)
        downs.append(nhi - 1)
        lo, hi = nlo, nhi
    return (torch.stack(ups, dim=1), torch.stack(downs, dim=1), lo, hi)


# Kernel B2r copies each shard's row into a block's shared memory: its two
# slice pointers, rmeta's 2 words and smeta's 3 (csrc/sharded.cu
# kShardRowBytes), 48 KiB at most without an opt-in.
B2R_SHARD_ROW_BYTES = 2 * 8 + 5 * 4
B2R_SHARED_BYTES = 48 * 1024


def check_b2r_shards(S: int) -> None:
    """Refuses a shard count whose rows do not fit in kernel B2r's shared
    memory (over a thousand shards)."""
    if S * B2R_SHARD_ROW_BYTES > B2R_SHARED_BYTES:
        raise ValueError(
            f"B2r: the rows of {S} shards ({S * B2R_SHARD_ROW_BYTES} bytes) "
            f"do not fit in the kernel's {B2R_SHARED_BYTES} bytes of shared "
            f"memory (at most "
            f"{B2R_SHARED_BYTES // B2R_SHARD_ROW_BYTES} shards)")


def refine_sharded(sidx, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """Kernel B2r (``csrc/sharded.cu``, ``cgx_refine_sharded``): ``depths``
    refinement levels from depth ``d0`` for every lane over the sharded
    index ``sidx``, on kernel A1's warp body (``csrc/refine.cuh``) with the
    shards' rows in shared memory (``check_b2r_shards``).  Returns (ups,
    downs) int32 [n, depths] and the final (lo, hi) int32 [n].

    Replaces ``_refine_chunk`` (cgx_tpu/parallel/sharded.py:261).  On CUDA
    tensors it launches the kernel; on CPU tensors it runs
    ``refine_sharded_plain``."""
    device = toks.device
    if not kb.route("B2r", device):
        return refine_sharded_plain(sidx, qtok, toks, sls, lo, hi, d0,
                                    depths)
    check_b2r_shards(sidx.S)
    sa_ptrs, ref_ptrs, rmeta, smeta = sidx.device_tables()
    kb.check_inputs("B2r", device, torch.int32, rmeta=rmeta, smeta=smeta,
                    qtok=qtok, toks=toks, sls=sls, lo=lo, hi=hi,
                    **{f"sa_l{s}": t for s, t in enumerate(sidx.sa_l)},
                    **{f"ref_l{s}": t for s, t in enumerate(sidx.ref_l)})
    n = toks.shape[0]
    if not (sls.shape[0] == lo.shape[0] == hi.shape[0] == n):
        raise ValueError("B2r: lane arrays differ in length")
    kb.check_count("B2r", n)
    ups = torch.empty((n, depths), dtype=torch.int32, device=device)
    downs = torch.empty_like(ups)
    lo_out = torch.empty(n, dtype=torch.int32, device=device)
    hi_out = torch.empty_like(lo_out)
    if n:
        kb.launch(
            "sharded", "cgx_refine_sharded", device, kb.ptr(sa_ptrs),
            kb.ptr(ref_ptrs), kb.ptr(rmeta), kb.ptr(smeta), sidx.S, sidx.BR,
            sidx.sa_l[0].shape[0], sidx.B, sidx.ref_l[0].shape[0],
            kb.ptr(qtok), qtok.shape[0], kb.ptr(toks), kb.ptr(sls), kb.ptr(lo),
            kb.ptr(hi), n, d0, depths, kb.ptr(ups), kb.ptr(downs),
            kb.ptr(lo_out), kb.ptr(hi_out))
        kb.counted("B2r", n, kb.nbytes(toks, sls, lo, hi, ups, downs,
                                       lo_out, hi_out))
    return ups, downs, lo_out, hi_out


def gather_sa_sharded_plain(sidx, rows, shard: int = None):
    """Plain PyTorch version of kernel B2g (over shard ``shard`` alone when
    given)."""
    return _g_sa(sidx, rows, None if shard is None else [shard])


def gather_sa_sharded(sidx, rows, shard: int = None):
    """Kernel B2g (``csrc/sharded.cu``, ``cgx_gather_sa_sharded``): the SA
    value at each global rank ``rows[i]`` from the rank-sharded SA (0 where
    no shard owns the rank) -> int32 [n]; with ``shard``, from that shard
    alone, on its device (a one-shard table), 0 for every rank it does not
    own.

    Replaces ``_gather_sa_chunk`` (cgx_tpu/parallel/sharded.py:324).  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``gather_sa_sharded_plain``."""
    device = rows.device
    if not kb.route("B2g", device):
        return gather_sa_sharded_plain(sidx, rows, shard)
    if shard is None:
        sa_ptrs, _, rmeta, _ = sidx.device_tables()
        slices = sidx.sa_l
    else:
        sa_ptrs, rmeta = sidx.shard_table(shard)
        slices = [sidx.sa_l[shard]]
    kb.check_inputs("B2g", device, torch.int32, rmeta=rmeta, rows=rows,
                    **{f"sa_l{s}": t for s, t in enumerate(slices)})
    n = rows.shape[0]
    kb.check_count("B2g", n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        kb.launch(
            "sharded", "cgx_gather_sa_sharded", device, kb.ptr(sa_ptrs),
            kb.ptr(rmeta), len(slices), sidx.BR, slices[0].shape[0],
            kb.ptr(rows), n, kb.ptr(out))
        kb.counted("B2g", n, kb.nbytes(rows, out))
    return out


def _process_sum(sidx, a: np.ndarray) -> np.ndarray:
    """``a`` (host int32) summed over the processes of a composed run, in
    place; as it is in one process."""
    if sidx.n_processes > 1:
        tdist.all_reduce(torch.from_numpy(a))
    return a


def gather_sa(sidx: ShardedGrammarIndex, rows) -> np.ndarray:
    """SA values at global ranks from the rank-sharded storage, in the
    order of ``rows`` -> int32 numpy.  On a device list each owning shard
    gathers its rows on its device (B2g over its one-shard table) and the
    rows scatter back in order: the JAX one-hot ``psum`` exactly, since one
    shard owns each rank."""
    rows = np.asarray(rows, np.int64)
    if len(rows) == 0:
        return np.empty(0, np.int32)
    if not sidx.listed:
        (r,) = on(sidx.device, rows)
        return host(gather_sa_sharded(sidx, r))
    owner = np.clip(rows // sidx.BR, 0, sidx.S - 1)
    launched = []
    for s in sidx.local_shards():
        sel = np.flatnonzero(owner == s)
        if len(sel):
            (r,) = on(sidx.device_of(s), rows[sel])
            launched.append((sel, gather_sa_sharded(sidx, r, s)))
    out = np.zeros(len(rows), np.int32)
    for sel, res in launched:
        out[sel] = host(res)
    return _process_sum(sidx, out)


# ---------------------------------------------------------------------------
# Kernels B2s and B2t: the refinement's round form on a device list
# ---------------------------------------------------------------------------

# A tree step reads the keys of the next TREE_LEVELS levels of each lane's
# bisection tree at once: its TREE_NODES nodes (csrc/sharded.cu kTreeLevels,
# kTreeNodes).
TREE_LEVELS = 5
TREE_NODES = 2 ** TREE_LEVELS - 1


def round_steps(lo, hi) -> int:
    """K, the bisection steps of every lower bound in a dispatch of
    intervals [lo, hi) (host arrays): those of the widest, ceil(log2(w +
    1)), at least 1.  An interval only narrows over a dispatch's levels."""
    w = int(np.max(np.asarray(hi, np.int64) - np.asarray(lo, np.int64),
                   initial=0))
    return max(1, w.bit_length())


def round_plan(lo, hi, depths: int) -> tuple:
    """(R, T) of a dispatch of ``depths`` levels over intervals [lo, hi):
    R tree steps a lower bound, ceil(K / TREE_LEVELS) with K =
    ``round_steps``, and T = 2 depths R steps in all; or, where no interval
    is wider than one row (K = 1), the single-row plan (0, 1): every level
    reads the same row, so one step reads every depth's token."""
    K = round_steps(lo, hi)
    if K == 1:
        return 0, 1
    R = -(-K // TREE_LEVELS)
    return R, 2 * depths * R


def _tree_nodes(l, h, nodes: int) -> tuple:
    """The intervals of the first ``nodes`` nodes of each lane's bisection
    tree over [l, h) (int32 [n]) -> (l, h) int32 [n, nodes].  Node 0 is [l,
    h); node j's children are 2j + 1, [l, M) (the key at M was >= the
    bound's), and 2j + 2, [M + 1, h), with M = (l + h) >> 1.  A child of an
    empty node is empty, so a node is live (h > l) only where every node on
    its path was."""
    path = torch.arange(1, nodes + 1, dtype=torch.int64, device=l.device)
    level = torch.tensor([j.bit_length() - 1 for j in range(1, nodes + 1)],
                         device=l.device)
    nl = l[:, None].repeat(1, nodes)
    nh = h[:, None].repeat(1, nodes)
    for k in range(int(level.max())):       # the k-th step from the root
        on = level > k
        right = ((path >> (level - 1 - k).clamp(min=0)) & 1).bool()
        M = (nl + nh) >> 1
        nl = torch.where(on & right, M + 1, nl)
        nh = torch.where(on & ~right, M, nh)
    return nl, nh


def _round_key(qtok, toks, sls, depth: int):
    """The query token at ``depth`` of each lane, -1 past its suffix."""
    return torch.where(depth < sls, take(qtok, toks + depth),
                       torch.full_like(toks, -1))


def _row_bound(l, h, t, key):
    """A lower bound over [l, h) at most one row wide, whose row's key is
    ``t``: ``lb``'s one step, l where the interval is empty."""
    M = (l + h) >> 1
    return torch.where((h > l) & (t < key), M + 1, l)


def _sa_parts(sa, rstart: int, rcount: int, l, h, nodes: int):
    """One shard's parts of the SA words at the midpoints of the first
    ``nodes`` tree nodes over [l, h): sa[M] where the node is live and the
    shard owns rank M, else 0 -> int32 [n, nodes]."""
    nl, nh = _tree_nodes(l, h, nodes)
    loc = ((nl + nh) >> 1) - rstart
    return torch.where((nh > nl) & (loc >= 0) & (loc < rcount),
                       take(sa, loc), 0)


def refine_step_plain(sa, rstart: int, rcount: int, qtok, toks, sls, st,
                      ups, downs, tok, g: int, R: int, d0: int, depths: int):
    """Plain PyTorch version of kernel B2s: step ``g`` of a dispatch's round
    form (``round_plan``'s R; R = 0, the single-row plan) on one shard's
    rank slice ``sa`` (its ranks [rstart, rstart + rcount)), updating the
    lanes' ``st`` (int32 [4, n]: lo, hi, l, h), ``ups`` and ``downs``
    (int32 [n, depths]) in place from step g - 1's summed tokens ``tok``
    -> the shard's parts of the SA words this step reads (None at the last
    step, g = T).

    A tree step (R >= 1) walks lower bound (g - 1) // R down the
    TREE_LEVELS levels whose TREE_NODES keys ``tok`` holds ([n,
    TREE_NODES]), as ``lb`` steps them, closes it where g is a multiple of
    R (its l is ups[c], or downs[c] + 1 and level c's new hi), opens bound
    g // R there, and gives the part of the SA word at each node's midpoint
    ([n, TREE_NODES]: sa[M] where the shard owns rank M and the node is
    live, else 0).  The single-row plan's step 0 gives the part at each
    lane's one row l ([n, 1]), its step 1 resolves every level from the
    tokens at that row ([n, depths]) as ``lb`` would."""
    lo, hi, l, h = (x.clone() for x in st)
    out = None
    if R == 0:
        if g == 0:
            l, h = lo, hi
            out = _sa_parts(sa, rstart, rcount, l, h, 1)
        else:
            for c in range(depths):
                key = _round_key(qtok, toks, sls, d0 + c)
                nlo = _row_bound(lo, hi, tok[:, c], key)
                nhi = _row_bound(nlo, hi, tok[:, c], key + 1)
                ups[:, c], downs[:, c] = nlo, nhi - 1
                lo, hi = nlo, nhi
        st.copy_(torch.stack([lo, hi, l, h]))
        return out
    if g > 0:
        b = (g - 1) // R
        key = _round_key(qtok, toks, sls, d0 + b // 2) + (b & 1)
        node = torch.zeros_like(l, dtype=torch.int64)
        for _ in range(TREE_LEVELS):
            live = h > l
            M = (l + h) >> 1
            ge = tok.gather(1, node[:, None])[:, 0] >= key
            l = torch.where(live & ~ge, M + 1, l)
            h = torch.where(live & ge, M, h)
            node = torch.where(ge, 2 * node + 1, 2 * node + 2).clamp(
                max=TREE_NODES - 1)
        if g % R == 0:
            if b % 2 == 0:
                ups[:, b // 2] = l
            else:
                downs[:, b // 2] = l - 1
                lo, hi = ups[:, b // 2].clone(), l
    if g < 2 * depths * R:
        # bound g // R opens: the first of a level at its lo, the second
        # at the first's result, the l this step just closed it with
        if g % R == 0:
            if (g // R) % 2 == 0:
                l = lo
            h = hi
        out = _sa_parts(sa, rstart, rcount, l, h, TREE_NODES)
    st.copy_(torch.stack([lo, hi, l, h]))
    return out


def step_bytes(n: int, g: int, R: int, depths: int) -> int:
    """The bytes step ``g`` of B2s moves over ``n`` lanes whatever they
    hold: each lane's state read and written (the single-row plan's step 0
    reads lo and hi, writes l, h and its part; its step 1 reads ``toks`` and
    ``sls`` and writes every level's ``ups`` and ``downs``), the ``ups`` /
    ``downs`` column a closing tree bound writes (and reads), and the parts
    a step that reads writes.  The tokens, query tokens and SA words that
    only a live lane reads are left out (``tools/reads.py``
    ``refine_round_reads`` counts them), so this is a lower bound."""
    if R == 0:
        return 4 * n * (5 if g == 0 else 6 + 2 * depths)
    words = 8 * n
    if g > 0 and g % R == 0:
        words += n * (1 + (g - 1) // R % 2)
    if g < 2 * depths * R:
        words += TREE_NODES * n
    return 4 * words


def partial_bytes(n: int, nodes: int, count: int) -> int:
    """The bytes a B2t launch over ``n`` lanes moves whatever they hold:
    each lane's l and h read and its parts written; the summed SA words of
    the live nodes and the corpus words are left out (a lower bound)."""
    return 4 * n * (2 + nodes * count)


def refine_step(sa, rstart: int, rcount: int, qtok, toks, sls, st, ups,
                downs, tok, g: int, R: int, d0: int, depths: int):
    """Kernel B2s (``csrc/sharded.cu``, ``cgx_refine_step``): step ``g`` of
    the round form on one shard's device, as ``refine_step_plain``.

    With B2t it replaces ``_refine_chunk`` (cgx_tpu/parallel/sharded.py:261)
    on an index placed on a device list.  On CUDA tensors it launches the
    kernel; on CPU tensors it runs ``refine_step_plain``."""
    device = st.device
    if not kb.route("B2s", device):
        return refine_step_plain(sa, rstart, rcount, qtok, toks, sls, st,
                                 ups, downs, tok, g, R, d0, depths)
    kb.check_inputs("B2s", device, torch.int32, sa=sa, qtok=qtok, toks=toks,
                    sls=sls, st=st, ups=ups, downs=downs, tok=tok)
    n = toks.shape[0]
    if not (R >= 0 and depths >= 1):
        raise ValueError(f"B2s: a plan of {R} steps a bound, {depths} "
                         f"levels")
    T = 2 * depths * R if R else 1
    if not (sls.shape == (n,) and st.shape == (4, n)
            and tok.shape == (n, TREE_NODES if R else depths)
            and ups.shape == downs.shape == (n, depths)):
        raise ValueError("B2s: lane arrays differ in shape")
    if not 0 <= g <= T:
        raise ValueError(f"B2s: step {g} of a {T}-step dispatch")
    kb.check_count("B2s", n)
    out = torch.empty((n, TREE_NODES if R else 1), dtype=torch.int32,
                      device=device)
    if n:
        kb.launch(
            "sharded", "cgx_refine_step", device, kb.ptr(sa), sa.shape[0],
            rstart, rcount, kb.ptr(qtok), qtok.shape[0], kb.ptr(toks),
            kb.ptr(sls), kb.ptr(st), kb.ptr(ups), kb.ptr(downs), kb.ptr(tok),
            n, g, R, d0, depths, kb.ptr(out))
        kb.counted("B2s", n, step_bytes(n, g, R, depths))
    return None if g == T else out


def token_partial_plain(ref, soff: int, olo: int, ohi: int, st, sa_sum,
                        depth: int, count: int):
    """Plain PyTorch version of kernel B2t: one shard's parts of the tokens
    at ``sa_sum[:, j] + depth + c`` (c < ``count``) of each live node j of
    the lanes' trees over st's [l, h) (``sa_sum``: int32 [n, nodes], the
    summed SA words of B2s's step) from its token slice ``ref`` (global
    position ``soff`` first; it owns [olo, ohi)), else 0 -> int32 [n, nodes
    count]: a tree step's node tokens (count 1), or the single-row plan's
    tokens of every depth at the one row (one node, count ``depths``)."""
    n, nodes = sa_sum.shape
    nl, nh = _tree_nodes(st[2], st[3], nodes)
    p = (sa_sum + depth)[:, :, None] + torch.arange(
        count, dtype=sa_sum.dtype, device=sa_sum.device)
    ok = (nh > nl)[:, :, None] & (p >= olo) & (p < ohi)
    return torch.where(ok, take(ref, p - soff), 0).reshape(n, nodes * count)


def token_partial(ref, soff: int, olo: int, ohi: int, st, sa_sum,
                  depth: int, count: int):
    """Kernel B2t (``csrc/sharded.cu``, ``cgx_token_partial``): as
    ``token_partial_plain``, on the shard's device.  On CUDA tensors it
    launches the kernel; on CPU tensors it runs the plain version."""
    device = st.device
    if not kb.route("B2t", device):
        return token_partial_plain(ref, soff, olo, ohi, st, sa_sum, depth,
                                   count)
    kb.check_inputs("B2t", device, torch.int32, ref=ref, st=st,
                    sa_sum=sa_sum)
    n, nodes = sa_sum.shape
    if st.shape != (4, n):
        raise ValueError("B2t: lane arrays differ in shape")
    if nodes not in (1, TREE_NODES) or count < 1:
        raise ValueError(f"B2t: {nodes} nodes, {count} tokens a node")
    kb.check_count("B2t", n * nodes * count)
    out = torch.empty((n, nodes * count), dtype=torch.int32, device=device)
    if n:
        kb.launch(
            "sharded", "cgx_token_partial", device, kb.ptr(ref), ref.shape[0],
            soff, olo, ohi, kb.ptr(st), kb.ptr(sa_sum), n, nodes, count,
            depth, kb.ptr(out))
        kb.counted("B2t", n, partial_bytes(n, nodes, count))
    return out


def _sum_parts(sidx, parts: list) -> dict:
    """The shards' parts (int32, one shape, each on its device) summed on
    the home device, and across the processes of a composed run -> the sum
    on each local device."""
    total = None
    for p in parts:
        p = p.to(sidx.device)
        total = p if total is None else total + p
    if sidx.n_processes > 1:
        summed = kb.to_host(total)
        tdist.all_reduce(summed)
        total = kb.to_device(summed, sidx.device)
    return {d: total.to(d) for d in {sidx.device_of(s)
                                     for s in sidx.local_shards()}}


def refine_round(sidx, qtok, toks, sls, lo, hi, d0: int, depths: int):
    """``depths`` refinement levels from depth ``d0`` for every lane (host
    int32 arrays ``toks``, ``sls``, ``lo``, ``hi``) over an index placed on
    a device list: each local shard steps its own copy of the lanes on its
    device (kernel B2s, then B2t, ``round_plan``'s T steps) and the parts
    of each step are summed (``_sum_parts``).  ``qtok``: the padded query
    tokens, or a function of the shard giving them on its device.  Returns
    (ups, downs) int32 [n, depths] and the final (lo, hi) int32 [n] on the
    home device, bit-equal to ``refine_sharded``."""
    n = len(toks)
    R, T = round_plan(lo, hi, depths)
    lanes, shared = {}, {}
    for s in sidx.local_shards():
        dev = sidx.device_of(s)
        if dev not in shared:
            shared[dev] = on(dev, toks, sls)
        st = torch.from_numpy(np.stack([lo, hi, lo, hi]).astype(np.int32))
        lanes[s] = dict(
            qtok=qtok(s) if callable(qtok) else qtok.to(dev),
            st=kb.to_device(st, dev),
            ups=torch.zeros((n, depths), dtype=torch.int32, device=dev),
            downs=torch.zeros((n, depths), dtype=torch.int32, device=dev))
    # step 0 reads no token
    tok = {d: torch.zeros((n, TREE_NODES if R else depths),
                          dtype=torch.int32, device=d) for d in shared}
    for g in range(T + 1 if n else 0):
        parts = []
        for s, ln in lanes.items():
            dev = sidx.device_of(s)
            rstart, rcount = (int(x) for x in sidx.rmeta[s])
            parts.append(refine_step(
                sidx.sa_l[s], rstart, rcount, ln["qtok"], *shared[dev],
                ln["st"], ln["ups"], ln["downs"], tok[dev], g, R, d0,
                depths))
        if g == T:
            break
        sa_sum = _sum_parts(sidx, parts)
        depth, count = (d0 + g // R // 2, 1) if R else (d0, depths)
        parts = []
        for s, ln in lanes.items():
            soff, olo, ohi = (int(x) for x in sidx.smeta[s])
            parts.append(token_partial(sidx.ref_l[s], soff, olo, ohi,
                                       ln["st"], sa_sum[sidx.device_of(s)],
                                       depth, count))
        tok = _sum_parts(sidx, parts)
    home = lanes[sidx.local_shards()[0]]
    return home["ups"], home["downs"], home["st"][0], home["st"][1]


def sharded_passes(sidx: ShardedGrammarIndex, queries):
    """Pass 1 + pass 2 by interval refinement over the sharded arrays
    (kernel B2r, or on a device list its round form, B2s and B2t);
    bit-equal to ``passes.refine_passes`` on the replicated index
    (``firstfindhit*`` are reported as -1, as there)."""
    if sidx.listed:
        def dispatch(toks, sls, lo, hi, depth, dchunk):
            out = refine_round(sidx, lambda s: sidx.qtok_on(s, queries),
                               toks, sls, lo, hi, depth, dchunk)
            return tuple(host(t) for t in out)
    else:
        qtok = sidx.query_tokens(queries)

        def dispatch(toks, sls, lo, hi, depth, dchunk):
            out = refine_sharded(sidx, qtok,
                                 *on(sidx.device, toks, sls, lo, hi), depth,
                                 dchunk)
            return tuple(host(t) for t in out)

    return passes.drive_refinement(
        queries, sidx.reflen,
        (sidx.seed_lo1, sidx.seed_hi1, sidx.seed_pk, sidx.seed_pk3),
        dispatch)


# ---------------------------------------------------------------------------
# Owner-computes dispatch of the scan and extraction kernels
# ---------------------------------------------------------------------------

class ShardedEngine:
    """The engine protocol (``cgx_tpu_torch.engine``) over a
    ``ShardedGrammarIndex``: every stage's items are partitioned by the
    shard that owns the corpus position they read around, run there, on the
    shard's device and views, and come back in their original order.  The
    kernel methods take ``fetch`` as ``ReplicatedEngine``'s do."""

    timer = None

    def __init__(self, sidx: ShardedGrammarIndex, cfg: ExtractorConfig):
        self.sidx = sidx
        self.cfg = cfg

    @traced
    def sa_values(self, rows) -> np.ndarray:
        return gather_sa(self.sidx, rows).astype(np.int64)

    def _partitioned(self, pos_key, items, run_one, n_out: int, then,
                     fetch: bool = True):
        """Run ``run_one(s, views, *item tensors)`` on each local shard's
        items, on the shard's device, every shard launched before any
        result is read back -> ``then`` of the numpy int32 [n_out, N]
        result in the original item order (with ``fetch=False``, a function
        that copies and returns it).  In a composed run each process fills
        the rows its shards own and the result is summed across the
        processes (``_process_sum``), in the same order on every
        process."""
        sidx = self.sidx
        N = len(pos_key)
        out = np.zeros((n_out, N), np.int32)
        launched = []
        if N:
            owner = sidx.owner_of(pos_key)
            for s in sidx.local_shards():
                sel = np.flatnonzero(owner == s)
                if len(sel):
                    res = run_one(s, sidx.shard_arrays(s),
                                  *on(sidx.device_of(s),
                                      *(a[sel] for a in items)))
                    launched.append((sel, res))

        def get():
            for sel, res in launched:
                out[:, sel] = host(res.reshape(n_out, -1))
            return then(_process_sum(sidx, out) if N else out)
        return get() if fetch else get

    @traced
    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok,
                     fetch=True):
        item_pat, tx = materialize_items(counts)
        row = np.asarray(base, np.int64)[item_pat] + tx
        cols = [pc.onegap_start[row], pc.onegap_length[row]] + [
            np.asarray(c, np.int64)[item_pat] for c in (sl, el, tok, stok)]
        mrs = self.cfg.max_rule_span

        def run_one(s, views, *x):
            return lookup.pcs_items(views[0], self.sidx.qtok_on(s, queries),
                                    *x, mrs)
        return self._partitioned(cols[0], cols, run_one, 1,
                                 lambda o: o[0].astype(bool), fetch)

    @traced
    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side,
                      fetch=True):
        item_pat, tx = materialize_items(counts)
        gostart = self.sa_values(np.asarray(lo, np.int64)[item_pat] + tx)
        cols = [gostart] + [np.asarray(c, np.int64)[item_pat]
                            for c in (sl, el, side)]
        cfg = self.cfg
        kernel = lookup.fwd_items if fwd else lookup.bwd_items

        def run_one(s, views, *x):
            return kernel(*views, self.sidx.qtok_on(s, queries), *x,
                          cfg.max_rule_span, cfg.min_gap_size)
        return self._partitioned(gostart, cols, run_one, 1,
                                 lambda o: o[0], fetch)

    @traced
    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode, fetch=True):
        css, fes = two_gap_occurrences(onegap_sa, pc, lo, counts, pcmode)
        cfg = self.cfg

        def run_one(s, views, *x):
            return lookup.two_items(*views, *x, cfg.max_rule_span,
                                    cfg.min_gap_size)
        return self._partitioned(css, [css, fes], run_one, 2, tuple, fetch)

    @traced
    def gap_check(self, gostart, fwd, fetch=True):
        """Owner-computes precompute gap checks (kernel A4 on each shard's
        views): the build never places a replicated O(corpus) array."""
        gostart = np.asarray(gostart, np.int64)
        cfg = self.cfg

        def run_one(s, views, g):
            return pcx.gap_check(views[1], views[2], g, cfg.max_rule_span,
                                 cfg.min_gap_size, fwd)
        return self._partitioned(gostart, [gostart], run_one, 1,
                                 lambda o: o[0], fetch)

    @traced
    def contig(self, sa_pos, lm, fetch=True):
        cs = self.sa_values(sa_pos)
        cfg = self.cfg

        def run_one(s, views, *x):
            return xdev.contig_pos(*views, *x, cfg.max_rule_span,
                                   cfg.max_rule_symbols)
        return self._partitioned(cs, [cs, np.asarray(lm)], run_one, 8, tuple,
                                 fetch)

    @traced
    def onegap(self, css, fes, sls, els, fetch=True):
        cfg = self.cfg
        cols = [np.asarray(c) for c in (css, fes, sls, els)]

        def run_one(s, views, *x):
            return xdev.onegap(*views, *x, cfg.max_rule_span,
                               cfg.max_rule_symbols)
        return self._partitioned(cols[0], cols, run_one, 6, tuple, fetch)

    @traced
    def twogap(self, css, fes, ses, sls, els, cls, fetch=True):
        cfg = self.cfg
        cols = [np.asarray(c) for c in (css, fes, ses, sls, els, cls)]

        def run_one(s, views, *x):
            return xdev.twogap(*views, *x, cfg.max_rule_span)
        return self._partitioned(cols[0], cols, run_one, 2, tuple, fetch)
