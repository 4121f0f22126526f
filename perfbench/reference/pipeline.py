"""The reference's grammar for a list of query sentences: the sequential
specification's nine phases (Start.cu:489-629) over a ``RefIndex``.

``precision="bfloat16"`` is the control: every feature rounded to
bfloat16, the precision below the float32 the extractor states.  It has to
fail the comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import extract as ex
from perfbench.reference import lexicon as lx
from perfbench.reference import maxlex as mx
from perfbench.reference import search as se
from perfbench.reference import writer as wr
from perfbench.reference.config import ExtractorConfig
from perfbench.reference.corpus import load_queries
from perfbench.reference.index import RefIndex

_FEATURES = ("aa", "fsample_score", "bb", "max_lex_fge", "max_lex_egf")


def _concat(a: ex.GapRules, b: ex.GapRules) -> ex.GapRules:
    return ex.GapRules(*[np.concatenate([getattr(a, f.name), getattr(b, f.name)])
                         for f in dataclasses.fields(ex.GapRules)])


def _round_bf16(rules) -> None:
    for name in _FEATURES:
        v = torch.tensor([getattr(r, name) for r in rules], dtype=torch.float32)
        v = v.to(torch.bfloat16).to(torch.float32).numpy()
        for r, x in zip(rules, v):
            setattr(r, name, np.float32(x))


def grammar(ix: RefIndex, sentences, cfg: ExtractorConfig,
            precision: str = "float32") -> list:
    """Each sentence's grammar lines, in the order the writer prints them."""
    source, target, align, sa, pc = (ix.source, ix.target, ix.align, ix.sa,
                                     ix.pc)
    queries = load_queries(sentences, source.vocab)
    p1 = se.pass1(source, sa, queries)
    p2 = se.pass2(source, sa, queries, p1)
    enum1, search1 = se.sort_and_dedup_onegap(
        se.one_gap_enumeration(queries, p1, cfg), queries)
    onegap_sa = se.one_gap_lookup(source, sa, align, queries, p1, p2,
                                  search1, pc, cfg)
    enum2, search2 = se.sort_and_dedup_twogap(
        se.two_gap_enumeration(queries, p1, enum1, search1, cfg), queries)
    twogap_sa = se.two_gap_lookup(source, align, queries, search1, onegap_sa,
                                  search2, pc, cfg)

    blocks = ex.generate_blocks(sa, queries, p1, p2)
    contig, og_blocks, tg_blocks = ex.extract_contiguous(source, sa, align,
                                                         blocks, cfg)
    tg_seeds = ex.extract_twogap(source, align, search1, search2, twogap_sa,
                                 cfg)
    og_seeds, tg_onegap = ex.extract_onegap(source, align, search1,
                                            onegap_sa, pc, cfg)
    sep_onegap = len(og_blocks.gappy_index)
    rules1 = _concat(og_blocks, og_seeds)
    sep1 = len(tg_blocks.gappy_index)
    sep2 = sep1 + len(tg_seeds.gappy_index)
    rules2 = _concat(_concat(tg_blocks, tg_seeds), tg_onegap)

    tasks: list = []
    rules_one = lx.create_lexicon_onegap(rules1, source, target, blocks,
                                         search1, enum1, onegap_sa, pc,
                                         sep_onegap, cfg, tasks)
    rules_two = lx.create_lexicon_twogap(rules2, source, target, blocks,
                                         search1, enum1, search2, enum2,
                                         onegap_sa, pc, sep1, sep2, cfg, tasks)
    rules_contig = lx.create_lexicon_contig(contig, source, target, blocks,
                                            cfg, tasks)
    mx.compute_maxlex(tasks, target, ix.lex, rules_one, rules_two,
                      rules_contig, cfg)
    if precision == "bfloat16":
        for rules in (rules_one, rules_two, rules_contig):
            _round_bf16(rules)
    elif precision != "float32":
        raise ValueError(f"precision {precision!r}")

    G = len(blocks.start)
    D1 = len(search1.qrystart)
    D2 = len(search2.blockid)
    ud_contig = lx.updown_index(rules_contig, G)
    ud_one = lx.updown_index(rules_one, 2 * G + D1)
    ud_two = lx.updown_index(rules_two, G + D2 + 2 * D1)
    fmt_contig = wr.format_lines(rules_contig)
    fmt_one = wr.format_lines(rules_one)
    fmt_two = wr.format_lines(rules_two)
    return [wr.grammar_lines_for_query(
        q, blocks.qry_global, search1.query_with_id, search2.query_with_id,
        ud_contig, ud_one, ud_two, fmt_contig, fmt_one, fmt_two, G, D1, D2)
        for q in range(queries.qryscount)]
