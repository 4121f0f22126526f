"""The extractor's settings as the specification states them (the
reference CUDA extractor's ``ComTypes.h`` defaults)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    max_rule_span: int = 15
    max_rule_span_pattern: int = 15
    max_rule_symbols: int = 5
    min_gap_size: int = 1
    max_nonterminals: int = 2
    max_score: float = 99.0
    is_sample: bool = True
    sampler: int = 300
    sampler_onegap: int = 65
    sampler_twogap: int = 70
    precompute_count: int = 100


def from_overrides(overrides: dict) -> ExtractorConfig:
    """The settings with a configuration file's overrides; keys the
    reference does not model (the program's capacity ceilings) are
    ignored."""
    names = {f.name for f in dataclasses.fields(ExtractorConfig)}
    return ExtractorConfig(**{k: v for k, v in overrides.items() if k in names})
