"""The extractor's main path on one PyTorch device.

Port of ``cgx_tpu/pipeline.py`` (``build_artifact``, ``run_pipeline``,
``run_pipeline_files`` and the front/back stage split), for the block-derived
half of the grammar: pass 1/2 (kernel A1), contiguous blocks, contiguous
extraction (kernel A6: the ab, Xab, abX and XabX families), the lexicon,
MaxLex (kernel A9 or A10) and the writer.  The gappy families (aXb, XaXb,
aXbX, aXbXc) are not extracted yet: their rule sets are empty, and every
query's lines are exactly the JAX package's lines for the four block-derived
families, in the same order.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from cgx_tpu_torch.config import DEFAULT_CONFIG, ExtractorConfig
from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.extract.blocks import generate_blocks
from cgx_tpu_torch.features import lexicon as lx
from cgx_tpu_torch.features import maxlex as ml
from cgx_tpu_torch.grammar import writer as gw
from cgx_tpu_torch.index import container as ic
from cgx_tpu_torch.preproc import corpus as cp
from cgx_tpu_torch.preproc import suffix_array as sab
from cgx_tpu_torch.search import passes
from cgx_tpu_torch.types import (GapOnSA, OneGapEnum, OneGapSearch, Precomp,
                                 TwoGapEnum, TwoGapSearch)
from cgx_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class Artifact:
    """One-time corpus preprocessing (host side)."""
    source: cp.SourceCorpus
    target: cp.TargetCorpus
    align: cp.Alignment
    lex: cp.LexTable
    sa: sab.SAIndex


@dataclasses.dataclass
class PipelineResult:
    queries: cp.QuerySet
    per_query_lines: list
    counters: dict
    timing: PhaseTimer


def build_artifact(f_lines, e_lines, a_lines, lex_tokens,
                   cfg: ExtractorConfig = DEFAULT_CONFIG,
                   timing: PhaseTimer = None, device="cuda"):
    """Corpus preprocessing -> (Artifact, TorchGrammarIndex on ``device``,
    timing).  Texts given as one string take the native tokenizer."""
    device = torch.device(device)
    t = timing or PhaseTimer(device)
    with t.phase("refsin"):
        source = (cp.load_source_corpus_text(f_lines) if isinstance(f_lines, str)
                  else cp.load_source_corpus(f_lines))
        target = (cp.load_target_corpus_text(e_lines) if isinstance(e_lines, str)
                  else cp.load_target_corpus(e_lines))
        align = cp.load_alignment_fast(a_lines, source, target)
        lex = cp.load_lex_table(lex_tokens, source.vocab, target.vocab)
    with t.phase("suffixarray"):
        sa = sab.build_index(source.str_)
    with t.phase("qrysin"):
        index = ic.build_index(source, target, sa, align, lex, cfg, device)
    return Artifact(source, target, align, lex, sa), index, t


def run_pipeline(f_lines, e_lines, a_lines, lex_tokens, q_lines,
                 cfg: ExtractorConfig = DEFAULT_CONFIG,
                 timing: PhaseTimer = None, device="cuda") -> PipelineResult:
    """Runs the block-derived half of the main path with every device stage
    on ``device`` ("cuda": the hand-written kernels; "cpu": their plain
    PyTorch versions)."""
    art, index, t = build_artifact(f_lines, e_lines, a_lines, lex_tokens, cfg,
                                   timing, device)
    ctx = dict(index=index, source=art.source, target=art.target, sa=art.sa)
    with t.phase("qrysload"):
        queries = cp.load_queries(q_lines, art.source.vocab)
    front = _front_stages(ctx, queries, cfg, t)
    per_query_lines, counters = _back_stages(ctx, queries, front, cfg, t)
    return PipelineResult(queries=queries, per_query_lines=per_query_lines,
                          counters=counters, timing=t)


def _front_stages(ctx, queries, cfg, t):
    """Device-driven half: pass 1/2, blocks, contiguous extraction."""
    index = ctx["index"]
    with t.phase("kernel"):
        p1, p2 = passes.refine_passes(index, queries)
    with t.phase("extractin"):
        blocks = generate_blocks(ctx["sa"], queries, p1, p2)
    with t.phase("extractkernel"):
        contig, og_blocks, tg_blocks = xdev.extract_contiguous(index, blocks,
                                                               cfg)
    # the gappy families are empty, so the one-gap rules are Xab/abX alone and
    # the two-gap rules XabX alone
    return dict(p1=p1, p2=p2, blocks=blocks, contig=contig, rules1=og_blocks,
                rules2=tg_blocks, sep_onegap=len(og_blocks.gappy_index),
                sep1=len(tg_blocks.gappy_index),
                sep2=len(tg_blocks.gappy_index))


def _empty_search_structures():
    """The gappy half's search results with no patterns: (search1, enum1,
    onegap_sa, pc, search2, enum2)."""
    z = np.empty(0, np.int32)
    search1 = OneGapSearch(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                           position=z, start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum1 = OneGapEnum(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                       pattern=np.empty((0, 5), np.int32), number=z)
    onegap_sa = GapOnSA(position=z, str_position=z, length=z, length2=z)
    pc = Precomp(frequent_list=z, tok_start=z, tok_len=z, index_start=z,
                 index_end=z, onegap_start=z, onegap_length=z,
                 feature_missing=z)
    search2 = TwoGapSearch(blockid=z, position=z, qryend_len=z, gap2=z,
                           start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum2 = TwoGapEnum(blockid=z, gap2=z, qryend_len=z,
                       pattern=np.empty((0, 1), np.int32), number=z)
    return search1, enum1, onegap_sa, pc, search2, enum2


def _back_stages(ctx, queries, fr, cfg, t):
    """Host half plus MaxLex: lexicon build, MaxLex, rule formatting."""
    source, target, index = ctx["source"], ctx["target"], ctx["index"]
    blocks = fr["blocks"]
    search1, enum1, onegap_sa, pc, search2, enum2 = _empty_search_structures()
    with t.phase("lexicon"):
        rules_one, tasks_one = lx.fast_create_lexicon_onegap(
            fr["rules1"], source, target, blocks, search1, enum1, onegap_sa,
            pc, fr["sep_onegap"], cfg)
        rules_two, tasks_two = lx.fast_create_lexicon_twogap(
            fr["rules2"], source, target, blocks, search1, enum1, search2,
            enum2, onegap_sa, pc, fr["sep1"], fr["sep2"], cfg)
        rules_contig, tasks_contig = lx.fast_create_lexicon_contig(
            fr["contig"], source, target, blocks, cfg)
    with t.phase("maxlex"):
        ml.compute_maxlex(
            {"onegap": tasks_one, "twogap": tasks_two, "contig": tasks_contig},
            index, rules_one, rules_two, rules_contig, cfg)
    with t.phase("printout"):
        G = len(blocks.start)
        D1 = D2 = 0
        ud_contig = lx.updown_index(rules_contig, G)
        ud_one = lx.updown_index(rules_one, 2 * G + D1)
        ud_two = lx.updown_index(rules_two, G + D2 + 2 * D1)
        fmt_contig = gw.format_lines(rules_contig)
        fmt_one = gw.format_lines(rules_one)
        fmt_two = gw.format_lines(rules_two)
        no_gappy = [[] for _ in range(queries.qryscount)]
        per_query_lines = [
            gw.grammar_lines_for_query(
                q, blocks.qry_global, no_gappy, no_gappy, ud_contig, ud_one,
                ud_two, fmt_contig, fmt_one, fmt_two, G, D1, D2)
            for q in range(queries.qryscount)
        ]
    counters = dict(
        blocks=G, pass1_tokens=queries.totaltokens,
        pass2_items=len(fr["p2"].up),
        contig_pairs=len(fr["contig"].blocknumber),
        onegap_rules=len(fr["rules1"].gappy_index),
        twogap_rules=len(fr["rules2"].gappy_index),
        distinct_rules=len(rules_one) + len(rules_two) + len(rules_contig),
        total_lines=sum(len(x) for x in per_query_lines))
    return per_query_lines, counters


def run_pipeline_files(reffile, qryfile, tarfile, alignfile, lexfile, dest_dir,
                       cfg: ExtractorConfig = DEFAULT_CONFIG, device="cuda"):
    with open(reffile, encoding="utf-8") as fh:
        f_text = fh.read()
    with open(tarfile, encoding="utf-8") as fh:
        e_text = fh.read()
    res = run_pipeline(f_text, e_text, cp.read_lines(alignfile),
                       cp.read_tokens(lexfile), cp.read_lines(qryfile), cfg,
                       device=device)
    gw.write_grammars(dest_dir, res.queries.qryscount, cfg.is_sample,
                      res.per_query_lines)
    print(res.timing.report(), file=sys.stderr)
    print("counters:", res.counters, file=sys.stderr)
    return res
