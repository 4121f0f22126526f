"""Extractor configuration.

Every compile-time knob of the reference (``ComTypes.h:42-65`` and the
kernel-local ``#define``s in ``ExtractPair.cu:9-26``) becomes a field here, defaulting to
the reference's value.  ``minmatchlen``/``fingerlen`` mirror the reference CLI flags
(``Main.c:40-41``) even though the gappy pipeline ignores them, so the CLI contract is
identical.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    # Rule-shape constraints (ComTypes.h:42-48).
    max_rule_span: int = 15
    max_rule_span_pattern: int = 15
    max_rule_symbols: int = 5
    min_gap_size: int = 1
    max_nonterminals: int = 2

    # Lexical feature fallback score (ComTypes.h:51).
    max_score: float = 99.0

    # Sampling (ComTypes.h:62-65).
    is_sample: bool = True
    sampler: int = 300           # contiguous blocks (extractConsistentPairs_Gappy)
    sampler_onegap: int = 65     # aXb seeds (extractConsistentPairs_OneGap)
    sampler_twogap: int = 70     # aXbXc seeds (extractConsistentPairs_TwoGap)

    # Frequent-pair precomputation (ComTypes.h:55).
    precompute_count: int = 100

    # Query bounds (ComTypes.h:31).
    qry_max_length: int = 1024

    # CLI flags kept for contract parity (Main.c:40-41).
    minmatchlen: int = 1
    fingerlen: int = 10

    # Work-set capacities (replace the reference's hardcoded preallocations,
    # ComTypes.h:54-60) of the gappy stages.  The pipeline builds exact-sized
    # work arrays, so these are not buffer sizes; they are sanity ceilings
    # (the reference overflowed preallocations silently).
    cap_onegap_enum: int = 20_000_000
    cap_twogap_enum: int = 35_000_000
    cap_onegap_sa: int = 60_000_000
    cap_twogap_sa: int = 60_000_000
    cap_precomp: int = 60_000_000

    def __post_init__(self):
        # The device kernels' static widths (move axis MMOV=16, growth depth
        # IMAX=14, span windows CWID=16, 4-bit packed emission offsets) are
        # sized for the reference's MAX_rule_span=15 (ComTypes.h:42).  Larger
        # spans would silently truncate — refuse instead.
        if not (1 <= self.max_rule_span <= 15):
            raise ValueError(
                f"max_rule_span={self.max_rule_span} unsupported: the static "
                "kernel widths are sized for the reference's bound (<= 15)")
        if self.max_rule_span_pattern > self.max_rule_span:
            raise ValueError("max_rule_span_pattern must be <= max_rule_span")


class CapacityError(RuntimeError):
    """A stage's work set exceeded its configured capacity ceiling."""


def check_capacity(stage: str, count: int, cap: int) -> None:
    """Validates a stage's exact work count against its ``cap_*`` field (the
    reference overran its preallocations silently, ComTypes.h:54-60)."""
    if count > cap:
        raise CapacityError(
            f"stage '{stage}' produced {count} work items, exceeding the "
            f"configured capacity {cap}; raise the matching cap_* field in "
            f"ExtractorConfig if this corpus/query load is intended")


DEFAULT_CONFIG = ExtractorConfig()
