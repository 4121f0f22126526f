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
token-sharded corpus (kernel B2r); SA values at global ranks come from the
same gather (kernel B2g).  The scans and extractions are owner-computes:
each work item goes to the shard that owns the corpus position it reads
around and runs there over the shard's slices through ``OffsetView``s
(kernels B3f, B3b, B3p, B3t, B3c, and A4, A7, A8 on views).

Placement: every shard's tensors lie on the one device the caller names.
That proves the layout, the halos, the views and the distributed gathers on
one card, and saves no memory there: the shards together hold more than the
replicated index.  Shards on several devices are not ported (ROADMAP queue
A item 10b).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.engine import on, materialize_items, two_gap_occurrences
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
    device: torch.device
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
    _tables: tuple = dataclasses.field(default=None, repr=False)
    _qtok: tuple = dataclasses.field(default=None, repr=False)

    def owner_of(self, pos: np.ndarray) -> np.ndarray:
        """Owning shard of a corpus position (uniform chunks)."""
        return np.clip(np.asarray(pos, np.int64) // self.B, 0, self.S - 1)

    def shard_arrays(self, s: int) -> tuple:
        """(refstr, rlp, lr_tar) of shard ``s`` as ``OffsetView``s that take
        global indices."""
        off, toff = int(self.src_off[s]), int(self.tgt_off[s])
        return (OffsetView(self.ref_l[s], off, self.ref_glen),
                OffsetView(self.rlp_l[s], off, self.rlp_glen),
                OffsetView(self.lrt_l[s], toff, self.tgt_glen))

    def memory_per_device(self) -> dict:
        """Bytes of index state per shard, and of the replicated index's
        O(corpus) arrays for comparison (the JAX package's accounting)."""
        per = {
            "sa": 4 * self.sa_l[0].shape[0],
            "refstr": 4 * self.ref_l[0].shape[0],
            "rlp": 4 * self.rlp_l[0].shape[0],
            "lr_tar": 4 * self.lrt_l[0].shape[0],
        }
        per["total"] = sum(per.values())
        per["replicated_equiv"] = 4 * (
            self.ref_glen + self.reflen * 3 + self.rlp_glen + self.tgt_glen)
        return per

    def device_tables(self) -> tuple:
        """(sa_ptrs, ref_ptrs, rmeta, smeta) on the shards' device, built
        once: the B2 kernels reach the shards through arrays of their slice
        pointers and the int32 meta tables."""
        if self._tables is None:
            dev = self.device
            self._tables = (
                torch.tensor([t.data_ptr() for t in self.sa_l],
                             dtype=torch.int64, device=dev),
                torch.tensor([t.data_ptr() for t in self.ref_l],
                             dtype=torch.int64, device=dev),
                torch.from_numpy(np.ascontiguousarray(self.rmeta)).to(dev),
                torch.from_numpy(np.ascontiguousarray(self.smeta)).to(dev))
        return self._tables

    def query_tokens(self, queries) -> torch.Tensor:
        """``queries.padded_tokens()`` on the shards' device, cached for the
        most recent query set (held weakly)."""
        if self._qtok is not None and self._qtok[0]() is queries:
            return self._qtok[1]
        t = torch.from_numpy(queries.padded_tokens()).to(self.device)
        self._qtok = (weakref.ref(queries), t)
        return t


def _one_device(device) -> torch.device:
    """The shards' device; shards on several devices are refused."""
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        if len(devs) != 1:
            raise ValueError(
                "sharded index: shards on more than one device are not "
                "ported yet (ROADMAP queue A item 10b); give one device")
        (device,) = devs
    return torch.device(device)


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
    """Slice the corpus index into ``n_shards`` shards on ``device``, word
    for word as ``cgx_tpu.parallel.sharded.build_sharded_index`` does."""
    device = _one_device(device)
    S = int(n_shards)
    if S < 1:
        raise ValueError(f"sharded index: {S} shards")
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

    # every shard lies on the one device: the whole layout, halos included,
    # is held to its budget before anything is placed (the shards' pointer
    # and meta tables, a few words each, are left to the remaining share)
    budget.check_fits(sum(a.nbytes for a in (sl["sa_l"], sl["ref_l"], rlp_l,
                                             lrt_l)), device, f"{S}-shard")
    seed = passes.build_seed_tables(refstr_padded, sa_np.astype(np.int64))
    return _make(dict(
        S=S, reflen=reflen, ref_glen=ref_glen, rlp_glen=rlp_glen,
        tgt_glen=tgt_glen, BH=BH, **sl, rlp_l=rlp_l, lrt_l=lrt_l,
        tgt_off=tgt_lo, seed_lo1=seed[0], seed_hi1=seed[1], seed_pk=seed[2],
        seed_pk3=seed[3]), device)


def _make(a: dict, device) -> ShardedGrammarIndex:
    device = _one_device(device)
    S = int(a["S"])

    def put(x, dtype=np.int32):   # writable int32 copies, one per shard
        x = np.asarray(x, dtype)
        if dtype == np.uint32:
            x = x.view(np.int32)
        return [torch.from_numpy(np.array(x[s], np.int32)).to(device)
                for s in range(S)]

    seed_pk3 = a["seed_pk3"]
    return ShardedGrammarIndex(
        S=S, reflen=int(a["reflen"]), ref_glen=int(a["ref_glen"]),
        rlp_glen=int(a["rlp_glen"]), tgt_glen=int(a["tgt_glen"]),
        B=int(a["B"]), BR=int(a["BR"]), BH=int(a["BH"]), device=device,
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
                                                          np.int64))


def from_jax_sharded(sidx_arrays: dict, device) -> ShardedGrammarIndex:
    """A ShardedGrammarIndex from the numpy arrays and scalars of a JAX
    ``ShardedGrammarIndex`` (``SHARDED_FIELDS``; ``rmeta``/``smeta`` in its
    [S, 1, k] shape or flat)."""
    return _make(sidx_arrays, device)


# ---------------------------------------------------------------------------
# Kernel B2: the distributed single-token gathers and the refinement search
# ---------------------------------------------------------------------------

def _g_sa(sidx, r):
    """The SA value at global rank ``r`` as the JAX ``psum`` gives it: the
    sum over shards of the owner's word, 0 from every other shard."""
    v = torch.zeros_like(r)
    for s in range(sidx.S):
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
        lib = kb.library("sharded")
        kb.check("sharded", lib.cgx_refine_sharded(
            kb.ptr(sa_ptrs), kb.ptr(ref_ptrs), kb.ptr(rmeta), kb.ptr(smeta),
            sidx.S, sidx.BR, sidx.sa_l[0].shape[0], sidx.B,
            sidx.ref_l[0].shape[0], kb.ptr(qtok), qtok.shape[0],
            kb.ptr(toks), kb.ptr(sls), kb.ptr(lo), kb.ptr(hi), n, d0, depths,
            kb.ptr(ups), kb.ptr(downs), kb.ptr(lo_out), kb.ptr(hi_out),
            kb.stream(device)))
        kb.LAUNCHES["B2r"] += 1
    return ups, downs, lo_out, hi_out


def gather_sa_sharded_plain(sidx, rows):
    """Plain PyTorch version of kernel B2g."""
    return _g_sa(sidx, rows)


def gather_sa_sharded(sidx, rows):
    """Kernel B2g (``csrc/sharded.cu``, ``cgx_gather_sa_sharded``): the SA
    value at each global rank ``rows[i]`` from the rank-sharded SA (0 where
    no shard owns the rank) -> int32 [n].

    Replaces ``_gather_sa_chunk`` (cgx_tpu/parallel/sharded.py:324).  On
    CUDA tensors it launches the kernel; on CPU tensors it runs
    ``gather_sa_sharded_plain``."""
    device = rows.device
    if not kb.route("B2g", device):
        return gather_sa_sharded_plain(sidx, rows)
    sa_ptrs, _, rmeta, _ = sidx.device_tables()
    kb.check_inputs("B2g", device, torch.int32, rmeta=rmeta, rows=rows,
                    **{f"sa_l{s}": t for s, t in enumerate(sidx.sa_l)})
    n = rows.shape[0]
    kb.check_count("B2g", n)
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        lib = kb.library("sharded")
        kb.check("sharded", lib.cgx_gather_sa_sharded(
            kb.ptr(sa_ptrs), kb.ptr(rmeta), sidx.S, sidx.BR,
            sidx.sa_l[0].shape[0], kb.ptr(rows), n, kb.ptr(out),
            kb.stream(device)))
        kb.LAUNCHES["B2g"] += 1
    return out


def gather_sa(sidx: ShardedGrammarIndex, rows) -> np.ndarray:
    """SA values at global ranks from the rank-sharded storage, in the
    order of ``rows`` -> int32 numpy."""
    rows = np.asarray(rows, np.int64)
    if len(rows) == 0:
        return np.empty(0, np.int32)
    (r,) = on(sidx.device, rows)
    return gather_sa_sharded(sidx, r).cpu().numpy()


def sharded_passes(sidx: ShardedGrammarIndex, queries):
    """Pass 1 + pass 2 by interval refinement over the sharded arrays (kernel
    B2r); bit-equal to ``passes.refine_passes`` on the replicated index
    (``firstfindhit*`` are reported as -1, as there)."""
    qtok = sidx.query_tokens(queries)

    def dispatch(toks, sls, lo, hi, depth, dchunk):
        out = refine_sharded(sidx, qtok, *on(sidx.device, toks, sls, lo, hi),
                             depth, dchunk)
        return tuple(t.cpu().numpy() for t in out)

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
    shard that owns the corpus position they read around, run there on the
    shard's views, and come back in their original order."""

    def __init__(self, sidx: ShardedGrammarIndex, cfg: ExtractorConfig):
        self.sidx = sidx
        self.cfg = cfg

    def sa_values(self, rows) -> np.ndarray:
        return gather_sa(self.sidx, rows).astype(np.int64)

    def _partitioned(self, pos_key, items, run_one, n_out: int):
        """Run ``run_one(s, views, *item tensors)`` on each shard's items
        (every shard launched before any result is read back) -> numpy
        int32 [n_out, N] in the original item order."""
        sidx = self.sidx
        N = len(pos_key)
        out = np.zeros((n_out, N), np.int32)
        if not N:
            return out
        owner = sidx.owner_of(pos_key)
        launched = []
        for s in range(sidx.S):
            sel = np.flatnonzero(owner == s)
            if len(sel):
                res = run_one(s, sidx.shard_arrays(s),
                              *on(sidx.device, *(a[sel] for a in items)))
                launched.append((sel, res))
        for sel, res in launched:
            out[:, sel] = res.reshape(n_out, -1).cpu().numpy()
        return out

    def pcs_expanded(self, queries, pc, base, counts, sl, el, tok, stok):
        item_pat, tx = materialize_items(counts)
        row = np.asarray(base, np.int64)[item_pat] + tx
        cols = [pc.onegap_start[row], pc.onegap_length[row]] + [
            np.asarray(c, np.int64)[item_pat] for c in (sl, el, tok, stok)]
        qtok = self.sidx.query_tokens(queries)
        mrs = self.cfg.max_rule_span

        def run_one(s, views, *x):
            return lookup.pcs_items(views[0], qtok, *x, mrs)
        return self._partitioned(cols[0], cols, run_one, 1)[0].astype(bool)

    def scan_expanded(self, queries, fwd, lo, counts, sl, el, side):
        item_pat, tx = materialize_items(counts)
        gostart = self.sa_values(np.asarray(lo, np.int64)[item_pat] + tx)
        cols = [gostart] + [np.asarray(c, np.int64)[item_pat]
                            for c in (sl, el, side)]
        qtok = self.sidx.query_tokens(queries)
        cfg = self.cfg
        kernel = lookup.fwd_items if fwd else lookup.bwd_items

        def run_one(s, views, *x):
            return kernel(*views, qtok, *x, cfg.max_rule_span,
                          cfg.min_gap_size)
        return self._partitioned(gostart, cols, run_one, 1)[0]

    def two_expanded(self, onegap_sa, pc, lo, counts, pcmode):
        css, fes = two_gap_occurrences(onegap_sa, pc, lo, counts, pcmode)
        cfg = self.cfg

        def run_one(s, views, *x):
            return lookup.two_items(*views, *x, cfg.max_rule_span,
                                    cfg.min_gap_size)
        return tuple(self._partitioned(css, [css, fes], run_one, 2))

    def gap_check(self, gostart, fwd):
        """Owner-computes precompute gap checks (kernel A4 on each shard's
        views): the build never places a replicated O(corpus) array."""
        gostart = np.asarray(gostart, np.int64)
        cfg = self.cfg

        def run_one(s, views, g):
            return pcx.gap_check(views[1], views[2], g, cfg.max_rule_span,
                                 cfg.min_gap_size, fwd)
        return self._partitioned(gostart, [gostart], run_one, 1)[0]

    def contig(self, sa_pos, lm):
        cs = self.sa_values(sa_pos)
        cfg = self.cfg

        def run_one(s, views, *x):
            return xdev.contig_pos(*views, *x, cfg.max_rule_span,
                                   cfg.max_rule_symbols)
        return tuple(self._partitioned(cs, [cs, np.asarray(lm)], run_one, 8))

    def onegap(self, css, fes, sls, els):
        cfg = self.cfg
        cols = [np.asarray(c) for c in (css, fes, sls, els)]

        def run_one(s, views, *x):
            return xdev.onegap(*views, *x, cfg.max_rule_span,
                               cfg.max_rule_symbols)
        return tuple(self._partitioned(cols[0], cols, run_one, 6))

    def twogap(self, css, fes, ses, sls, els, cls):
        cfg = self.cfg
        cols = [np.asarray(c) for c in (css, fes, ses, sls, els, cls)]

        def run_one(s, views, *x):
            return xdev.twogap(*views, *x, cfg.max_rule_span)
        return tuple(self._partitioned(cols[0], cols, run_one, 2))
