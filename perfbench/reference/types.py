"""The stages' data, as the reference CUDA extractor's structs (ComTypes.h)
in NumPy arrays; see each class docstring for the struct provenance.  A
frozen copy, so the reference shares no code with the program it judges.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEP = 1  # sentence separator token id


@dataclasses.dataclass
class Pass1Result:
    """result_t_two per query token (ComTypes.h:98-106)."""

    up: np.ndarray            # int32 [ntok] first SA index with >=1-token match
    down: np.ndarray          # int32 [ntok] last SA index
    firstfindhit: np.ndarray  # int32 [ntok]
    firstfindhitL: np.ndarray
    firstfindhitR: np.ndarray
    longestmatch: np.ndarray  # int32 [ntok]


@dataclasses.dataclass
class Pass2Result:
    """result_connect ranges for match lengths 2..longest (SuffixArray.cu:109-400)."""

    connectoffset: np.ndarray  # int32 [ntok]; -1 when longestmatch <= 1
    up: np.ndarray             # int32 [totalconnect]
    down: np.ndarray           # int32 [totalconnect]


@dataclasses.dataclass
class OneGapEnum:
    # raw enumerated instances, canonical order then stably sorted by pattern
    qrystart: np.ndarray       # int32
    qrystart_len: np.ndarray   # int32
    qryend_len: np.ndarray     # int32
    gap: np.ndarray            # int32
    pattern: np.ndarray        # int32 [n, max_rule_symbols], -1 = gap, -2 = pad
    number: np.ndarray         # int32


@dataclasses.dataclass
class OneGapSearch:
    """Distinct 1-gap patterns (gappy_search, ComTypes.h:168-177)."""

    qrystart: np.ndarray
    qrystart_len: np.ndarray
    qryend_len: np.ndarray
    gap: np.ndarray
    position: np.ndarray        # first index in the sorted enum arrays
    start_on_salist: np.ndarray
    end_on_salist: np.ndarray
    query_with_id: list         # per-query list of distinct-pattern ids


@dataclasses.dataclass
class Precomp:
    frequent_list: np.ndarray        # int32 [P] top tokens, ascending ids
    tok_start: np.ndarray            # int32 [P] first SA index of each token's run
    tok_len: np.ndarray              # int32 [P] run length
    index_start: np.ndarray          # int32 [P*P] cell -> first row in onegap arrays
    index_end: np.ndarray            # int32 [P*P] inclusive; start=1,end=0 when empty
    onegap_start: np.ndarray         # int32 [n] corpus position of a
    onegap_length: np.ndarray        # int32 [n] offset of b from a
    feature_missing: np.ndarray      # int32 [P*P] gap-check-failed match count
    count: int = 0

    @property
    def P(self) -> int:
        return int(self.frequent_list.shape[0])

    def cell_of(self, tok_a: int, tok_b: int) -> int:
        """existPrecomputation (GappyLook.cu:5-40): -1 unless both tokens frequent."""
        ia = int(np.searchsorted(self.frequent_list, tok_a))
        if ia >= self.P or self.frequent_list[ia] != tok_a:
            return -1
        ib = int(np.searchsorted(self.frequent_list, tok_b))
        if ib >= self.P or self.frequent_list[ib] != tok_b:
            return -1
        return ia * self.P + ib


@dataclasses.dataclass
class GapOnSA:
    position: np.ndarray      # int32 pattern/block id
    str_position: np.ndarray  # int32 corpus position (or precomp cell when length==0)
    length: np.ndarray        # int32 offset of b's end (aXb); 0 = precomp reference
    length2: np.ndarray       # int32 (two-gap only) offset of c's end


@dataclasses.dataclass
class TwoGapEnum:
    blockid: np.ndarray      # int32 distinct 1-gap pattern id
    gap2: np.ndarray         # int32 absolute query token index of c
    qryend_len: np.ndarray   # int32 length of c (always 1, see config)
    pattern: np.ndarray      # int32 [n, 1] the c token(s)
    number: np.ndarray       # int32


@dataclasses.dataclass
class TwoGapSearch:
    blockid: np.ndarray          # int32 [D2] owning distinct 1-gap pattern
    position: np.ndarray         # int32 [D2] first row in sorted enum arrays
    qryend_len: np.ndarray       # int32 [D2]
    gap2: np.ndarray             # int32 [D2] representative c position
    start_on_salist: np.ndarray  # int32 [D2]
    end_on_salist: np.ndarray    # int32 [D2]
    query_with_id: list


@dataclasses.dataclass
class Blocks:
    """Deduped contiguous-match blocks (saind_t, ComTypes.h:342-347)."""

    start: np.ndarray         # int32 [G] SA range start (up)
    end: np.ndarray           # int32 [G] SA range end (down)
    matchlen: np.ndarray      # int32 [G]
    string_start: np.ndarray  # int32 [G] corpus position of first occurrence
    qry_global: list          # per-query ordered list of block ids


@dataclasses.dataclass
class ContigRules:
    """res_phrase_t rows (ab), sorted by blocknumber (canonical)."""

    tar_start: np.ndarray
    tar_end: np.ndarray      # length-1 offset (max_R - min_L)
    blocknumber: np.ndarray


@dataclasses.dataclass
class GapRules:
    """rule_onegap / rule_twogap rows; gap offsets relative to ref_str_start."""

    ref_str_start: np.ndarray
    end: np.ndarray
    gap1: np.ndarray
    gap1_1: np.ndarray
    gap2: np.ndarray        # zeros for one-gap rules
    gap2_1: np.ndarray
    gappy_index: np.ndarray


@dataclasses.dataclass
class FastSpeed:
    """One scored distinct rule (red_dup_t, ComTypes.h:244-255)."""

    blocknumber: int
    lexical: str
    fsample: int              # all_suffix_fsample (clamped)
    fsample_score: np.float32
    f: int                    # pre-dedup instance count for this id
    paircount: int
    aa: np.float32 = np.float32(0)
    bb: np.float32 = np.float32(0)
    max_lex_fge: np.float32 = np.float32(0)
    max_lex_egf: np.float32 = np.float32(0)


@dataclasses.dataclass
class LexTask:
    """lexicalTask (ComTypes.h:376-389): MaxLex work item for one distinct rule."""

    fast_speed_id: int
    source_pattern: list      # real source token ids (no gaps)
    target_start: int
    end: int                  # offset of last target token
    gap1: int = -1            # offsets relative to target_start; -1 = none
    gap1_1: int = -1
    gap2: int = -1
    gap2_1: int = -1
    kind: str = "contig"      # "onegap" | "twogap" | "contig"


