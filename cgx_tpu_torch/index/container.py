"""TorchGrammarIndex: the device-resident corpus index.

Port of ``GrammarIndex`` (cgx_tpu/index/container.py:25-147).  The arrays the
kernels read (token string, suffix array, RLP words, packed target alignment
spans, target string) are int32 tensors placed once on one device and reused
by every stage; the interval-LCP tree, which only the LCP passes read, goes
to the device at their first call.  The padding is the JAX package's, word
for word: the kernels
clamp every read to ``len - 1`` of these arrays exactly as the JAX gathers
do, so a different padding would change what a clamped read returns.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import (Alignment, LexTable, QuerySet,
                                          SourceCorpus, TargetCorpus)
from cgx_tpu_torch.preproc.suffix_array import SAIndex
from cgx_tpu_torch.search import passes
from cgx_tpu_torch.utils.batching import pad_tokens

# the GrammarIndex fields a TorchGrammarIndex is made from (``from_jax_arrays``)
ARRAY_FIELDS = ("refstr_padded", "sa", "lcpleft", "lcpright", "rlp", "lr_tar",
                "tgt_str", "lex_key", "lex_val1", "lex_val2")


@dataclasses.dataclass
class TorchGrammarIndex:
    reflen: int                    # logical corpus token length
    device: torch.device
    refstr_padded: torch.Tensor    # int32 [pow2 >= reflen + qry_max + 16]
    sa: torch.Tensor               # int32 [pow2 >= reflen]
    rlp: torch.Tensor              # int32 bits of the uint32 RLP words, padded
    lr_tar: torch.Tensor           # int32 (L << 8) | R per target token, padded
    tgt_str: torch.Tensor          # int32 [target toklen]
    lex_key: np.ndarray            # int64 (src << 32) | (tgt + 2**31), host
    lex_val1_host: np.ndarray      # float32 P(s|t), host
    lex_val2_host: np.ndarray      # float32 P(t|s), host
    seed_host: tuple               # passes.build_seed_tables: depths 0-2
    # the interval-LCP tree, int32 [pow2 >= reflen] padded with 0, kept on
    # the host: only the LCP passes read it (``lcp_tables``)
    lcpleft_host: np.ndarray = dataclasses.field(default=None, repr=False)
    lcpright_host: np.ndarray = dataclasses.field(default=None, repr=False)
    # device MaxLex probe tables, built on first use (features.maxlex)
    maxlex_tables: tuple = dataclasses.field(default=None, repr=False)
    _qtok: tuple = dataclasses.field(default=None, repr=False)
    _pcrows: tuple = dataclasses.field(default=None, repr=False)
    _lcp: tuple = dataclasses.field(default=None, repr=False)

    def query_tokens(self, queries: QuerySet) -> torch.Tensor:
        """``queries.padded_tokens()`` on this index's device, cached for the
        most recent query set (held weakly, so the cache never outlives it
        and a new set at a reused address is never served stale data)."""
        if self._qtok is not None and self._qtok[0]() is queries:
            return self._qtok[1]
        t = torch.from_numpy(queries.padded_tokens()).to(self.device)
        self._qtok = (weakref.ref(queries), t)
        return t

    def precomp_rows(self, pc) -> torch.Tensor:
        """int32 [max(n, 1), 2] (start, len) of a Precomp's ``n`` occurrence
        rows on this index's device (kernel A3 reads them), cached for the
        most recent Precomp like ``query_tokens``."""
        if self._pcrows is not None and self._pcrows[0]() is pc:
            return self._pcrows[1]
        n = len(pc.onegap_start)
        host = np.zeros((max(n, 1), 2), np.int32)
        host[:n, 0] = pc.onegap_start
        host[:n, 1] = pc.onegap_length
        t = torch.from_numpy(host).to(self.device)
        self._pcrows = (weakref.ref(pc), t)
        return t

    def lcp_tables(self) -> tuple:
        """(lcpleft, lcpright) on this index's device, uploaded on the first
        call and kept: the default pass-1/2 path never places them."""
        if self._lcp is None:
            self._lcp = tuple(torch.from_numpy(a).to(self.device)
                              for a in (self.lcpleft_host, self.lcpright_host))
        return self._lcp


@dataclasses.dataclass
class HostLexIndex:
    """The host-side slice of the index that MaxLex reads on its host
    backend (JAX ``cgx_tpu/index/container.py:72-91``): the sharded index
    scores there, so that no O(corpus) array is replicated on the device."""

    tgt_str_host: np.ndarray
    lex_key: np.ndarray
    lex_val1_host: np.ndarray
    lex_val2_host: np.ndarray


def build_host_lex_index(target: TargetCorpus, lex: LexTable) -> HostLexIndex:
    return HostLexIndex(
        tgt_str_host=np.asarray(target.str_),
        lex_key=pack_lex_key(lex.keys_src, lex.keys_tgt),
        lex_val1_host=np.asarray(lex.val1, dtype=np.float32),
        lex_val2_host=np.asarray(lex.val2, dtype=np.float32))


def pack_lex_key(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Order-preserving packing of (src, tgt) int32 pairs into sortable int64
    (lexFileCompare, ExtractPair.cu:28-35); the +2**31 bias keeps the -1 NULL
    target id before every real id."""
    return (np.asarray(src).astype(np.int64) << 32) | (
        np.asarray(tgt).astype(np.int64) + 2**31)


def build_index(source: SourceCorpus, target: TargetCorpus, sa: SAIndex,
                align: Alignment, lex: LexTable, cfg: ExtractorConfig,
                device) -> TorchGrammarIndex:
    """Pads the host arrays exactly as GrammarIndex does (under its field
    names and dtypes, ``rlp`` uint32) and places them on ``device``."""
    # the final token is the unique maximum (the corpus sentinel); the seed
    # tables and the searches rely on it
    if int(source.str_[sa.sa[-1]]) != int(source.str_.max()):
        raise ValueError("corpus must end in the unique sentinel token")
    refstr_padded = passes.pad_refstr(source.str_, cfg.qry_max_length)
    # pad RLP with unaligned words so right-growth reads past the end are safe
    rlp_padded = np.concatenate([
        align.RLP.astype(np.uint32),
        np.full(cfg.max_rule_span + 2, 0xFFFF0000, dtype=np.uint32)])
    tgt_pad = np.full(cfg.max_rule_span + 2, 255, dtype=np.int32)
    l_tar = np.concatenate([align.L_tar.astype(np.int32), tgt_pad])
    r_tar = np.concatenate([align.R_tar.astype(np.int32), tgt_pad])
    l_tar = pad_tokens(l_tar, np.int32(255))
    r_tar = pad_tokens(r_tar, np.int32(255))
    return from_jax_arrays(dict(
        reflen=np.int64(source.toklen),
        refstr_padded=pad_tokens(refstr_padded, np.int32(0)),
        sa=pad_tokens(np.asarray(sa.sa, np.int32), np.int32(0)),
        lcpleft=pad_tokens(np.asarray(sa.lcpleft, np.int32), np.int32(0)),
        lcpright=pad_tokens(np.asarray(sa.lcpright, np.int32), np.int32(0)),
        rlp=pad_tokens(rlp_padded, np.uint32(0xFFFF0000)),
        lr_tar=(l_tar << 8) | r_tar,
        tgt_str=np.asarray(target.str_, np.int32),
        lex_key=pack_lex_key(lex.keys_src, lex.keys_tgt),
        lex_val1=np.asarray(lex.val1, np.float32),
        lex_val2=np.asarray(lex.val2, np.float32)), device)


def from_jax_arrays(arrays: dict, device) -> TorchGrammarIndex:
    """A TorchGrammarIndex from host arrays named like GrammarIndex's fields
    (``ARRAY_FIELDS`` plus ``reflen``): the numpy arrays of a JAX-package
    index, or ``build_index``'s.  RLP words keep their bits as int32."""
    device = torch.device(device)
    reflen = int(arrays["reflen"])
    refstr = np.ascontiguousarray(arrays["refstr_padded"], np.int32)
    sa = np.ascontiguousarray(arrays["sa"], np.int32)

    def put(a):   # a writable int32 copy (the JAX package's arrays are read-only)
        return torch.from_numpy(np.array(a, np.int32)).to(device)

    return TorchGrammarIndex(
        reflen=reflen, device=device,
        refstr_padded=put(refstr), sa=put(sa),
        rlp=put(np.asarray(arrays["rlp"], np.uint32).view(np.int32)),
        lr_tar=put(arrays["lr_tar"]), tgt_str=put(arrays["tgt_str"]),
        lex_key=np.asarray(arrays["lex_key"], np.int64),
        lex_val1_host=np.asarray(arrays["lex_val1"], np.float32),
        lex_val2_host=np.asarray(arrays["lex_val2"], np.float32),
        seed_host=passes.build_seed_tables(refstr,
                                           sa[:reflen].astype(np.int64)),
        lcpleft_host=np.array(arrays["lcpleft"], np.int32),
        lcpright_host=np.array(arrays["lcpright"], np.int32))

