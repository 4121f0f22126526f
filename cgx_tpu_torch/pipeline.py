"""The extractor's main path on one PyTorch device.

Port of ``cgx_tpu/pipeline.py`` (``build_artifact`` with its persisted
index, ``run_pipeline``, ``run_pipeline_overlap``, ``run_pipeline_files``,
``_make_context`` and the front/back stage split) for every rule family:

* build: corpus loading and the suffix array (host), the index on the
  device, the frequent-pair precompute (kernel A4);
* pass 1/2: the interval refinement (kernel A1), or with
  ``lcp_passes=True`` the LCP-accelerated search (kernel B1, in two passes);
* the one-gap enumeration (host) and lookup1 (kernels A2 and A3);
* the two-gap enumeration (host) and lookup2 (kernel A5); with
  ``scan_cols=True`` (the JAX package's ``CGX_SCAN_COLS``) the scans of
  lookup1 and lookup2 run on items materialised on the host and uploaded
  as columns (kernels C1f, C1b and C1t in place of A2 and A5);
* contiguous blocks and extraction (kernel A6: ab, Xab, abX, XabX), one-gap
  extraction (kernel A7: aXb, XaXb, aXbX) and two-gap extraction (kernel
  A8: aXbXc);
* the lexicon (host), MaxLex (kernel A9 or A10) and the writer (host).

With ``sa_shards=S > 0`` the index is the sharded one
(``parallel.sharded``: the rank-sharded SA, the token-sharded corpus and
the target slices; S shards on ``device``, or on ``cuda:(s mod k)`` for a
bare "cuda" with k >= 2 cards; ``sa_shards`` may also be a list of
devices, one a shard): pass 1/2 runs on kernel B2r (on a device list its
round form, B2s and B2t), SA values come from B2g, the scans and
extractions run owner-computes on kernels B3f, B3b, B3p, B3t, B3c and A4,
A7, A8 on the shards' views, each on its shard's device, and MaxLex scores
on the host (a ``HostLexIndex``), as the JAX package's sharded path does.
``sa_shards="auto"`` sizes the index against the device's memory first
(``utils.budget``): replicated when it fits, else as many shards as the
visible cards need, or a one-line refusal.

With ``dp_devices`` the index is replicated on several devices and every
device stage's items split across them (``parallel.localdp``); MaxLex runs
on the first replica.

Every query's lines equal the JAX package's, byte for byte and in order.
"""

from __future__ import annotations

import dataclasses
import operator
import os
import sys

import numpy as np
import torch

from cgx_tpu_torch.config import (DEFAULT_CONFIG, ExtractorConfig,
                                  check_capacity)
from cgx_tpu_torch.engine import ReplicatedEngine
from cgx_tpu_torch.extract import device as xdev
from cgx_tpu_torch.extract.blocks import generate_blocks
from cgx_tpu_torch.features import lexicon as lx
from cgx_tpu_torch.features import maxlex as ml
from cgx_tpu_torch.grammar import writer as gw
from cgx_tpu_torch.index import container as ic
from cgx_tpu_torch.kernels import build as kb
from cgx_tpu_torch.parallel import localdp
from cgx_tpu_torch.parallel import sharded as shx
from cgx_tpu_torch.preproc import corpus as cp
from cgx_tpu_torch.preproc import index_io
from cgx_tpu_torch.preproc import suffix_array as sab
from cgx_tpu_torch.search import enumerate_fast as ef
from cgx_tpu_torch.search import lookup, passes
from cgx_tpu_torch.search import precompute as pcx
from cgx_tpu_torch.types import GapRules
from cgx_tpu_torch.utils.budget import resolve_shards
from cgx_tpu_torch.utils.timing import PhaseTimer, child


# the one-time corpus preprocessing (host side), as index_io persists it
Artifact = index_io.CorpusIndexArtifact


@dataclasses.dataclass
class PipelineResult:
    queries: cp.QuerySet
    per_query_lines: list
    counters: dict
    timing: PhaseTimer
    # the device index the run searched: a TorchGrammarIndex, or the
    # ShardedGrammarIndex with sa_shards > 0
    index: object = None
    # the contiguous blocks of the run's queries (extract.blocks)
    blocks: object = None


def make_engine(index, cfg: ExtractorConfig, scan_cols: bool = False,
                sa_host=None):
    """The dispatch engine of an index layout (``cgx_tpu_torch.engine``);
    ``scan_cols`` and ``sa_host`` as ``ReplicatedEngine`` takes them."""
    if isinstance(index, shx.ShardedGrammarIndex):
        return shx.ShardedEngine(index, cfg)
    return ReplicatedEngine(index, cfg, scan_cols, sa_host)


def _check_shards(sa_shards, lcp_passes=False, scan_cols=False):
    """``sa_shards`` checked: an int >= 0, "auto" (resolved by
    ``build_artifact``, and then checked again), or a non-empty list of
    devices, shard s on the s-th."""
    if isinstance(sa_shards, (list, tuple)):
        if not sa_shards:
            raise ValueError("sa_shards: an empty device list")
        sa_shards = list(sa_shards)
    elif sa_shards == "auto":
        return sa_shards
    else:
        sa_shards = operator.index(sa_shards)
        if sa_shards < 0:
            raise ValueError(f"sa_shards must be >= 0, not {sa_shards}")
    if lcp_passes and sa_shards:
        raise ValueError("lcp_passes needs the replicated index: the sharded "
                         "index keeps no LCP tree on the device")
    if scan_cols and sa_shards:
        raise ValueError("scan_cols needs the replicated index: the sharded "
                         "index has no column-upload path")
    return sa_shards


def _dp_devices(dp_devices, device, sa_shards) -> list:
    """The replicas' devices of a run: None for one device (``dp_devices``
    0 or 1), the first N of ``device``'s type for an int N
    (``localdp.dp_device_list``), or the given list of devices.  Refused
    with ``sa_shards``: the two layouts exclude each other."""
    if isinstance(dp_devices, int) and dp_devices <= 1:
        return None
    if sa_shards:
        raise ValueError("sa_shards and dp_devices are mutually exclusive "
                         "layouts (sharded index vs replicated-per-device "
                         "index)")
    if isinstance(dp_devices, int):
        return localdp.dp_device_list(dp_devices, device)
    return list(dp_devices)


def build_artifact(f_lines, e_lines, a_lines, lex_tokens,
                   cfg: ExtractorConfig = DEFAULT_CONFIG,
                   timing: PhaseTimer = None, device="cuda",
                   sa_shards=0, index_dir: str = None,
                   save_index: bool = True):
    """Corpus preprocessing -> (Artifact, index on ``device``, timing, the
    resolved shard count or device list).  Texts given as one string take
    the native tokenizer.  ``sa_shards`` ("auto" or a count) is resolved
    against the device's memory before anything is placed (``utils.budget.
    resolve_shards``: a one-line BudgetError when the index cannot fit).
    The index is a TorchGrammarIndex, or with a count > 0 (or a device
    list) a ShardedGrammarIndex of that many shards, whose build places no
    replicated O(corpus) array on any device: its precompute gap checks run
    owner-computes.

    With ``index_dir`` (build once, query many; ``preproc.index_io``): a
    directory that holds a ``meta.json`` is loaded (phase ``indexload``) and
    only the device index is built from it, so no corpus is parsed, no
    suffix array built and no precompute run; its persisted precompute is
    used whatever config it was built with, as in the JAX package.  Any
    other directory receives the fresh build (phase ``indexsave``) unless
    ``save_index`` is False (the processes of ``parallel.multihost`` other
    than process 0)."""
    sa_shards = _check_shards(sa_shards)
    device = torch.device(device)
    t = timing or PhaseTimer(device)
    if index_dir and os.path.exists(os.path.join(index_dir, "meta.json")):
        with t.phase("indexload"):
            art, _built_cfg = index_io.load(index_dir)
        sa_shards = _resolve(sa_shards, art.source.toklen,
                             art.target.toklen, cfg, device)
        with t.phase("qrysin"):
            index = _device_index(art.source, art.target, art.sa, art.align,
                                  art.lex, cfg, sa_shards, device)
        return art, index, t, sa_shards
    with t.phase("refsin"):
        with child(t, "source"):
            source = (cp.load_source_corpus_text(f_lines)
                      if isinstance(f_lines, str)
                      else cp.load_source_corpus(f_lines))
        with child(t, "target"):
            target = (cp.load_target_corpus_text(e_lines)
                      if isinstance(e_lines, str)
                      else cp.load_target_corpus(e_lines))
        with child(t, "align"):
            align = cp.load_alignment_fast(a_lines, source, target)
        with child(t, "lex"):
            lex = cp.load_lex_table(lex_tokens, source.vocab, target.vocab)
    sa_shards = _resolve(sa_shards, source.toklen, target.toklen, cfg,
                         device)
    with t.phase("suffixarray"):
        sa = sab.build_index(source.str_)
    with t.phase("qrysin"):
        index = _device_index(source, target, sa, align, lex, cfg, sa_shards,
                              device)
    with t.phase("precompute"):
        engine = make_engine(index, cfg)
        engine.timer = t
        pc = pcx.precompute(engine, source, sa, cfg)
    art = Artifact(source, target, align, lex, sa, pc)
    if index_dir and save_index:
        with t.phase("indexsave"):
            index_io.save(index_dir, art, cfg)
    return art, index, t, sa_shards


def _resolve(sa_shards, src_toklen, tgt_toklen, cfg, device):
    """A shard count or "auto" resolved (``utils.budget``); a device list
    as it is."""
    if isinstance(sa_shards, list):
        return sa_shards
    return resolve_shards(sa_shards, src_toklen, tgt_toklen, cfg, device)


def _device_index(source, target, sa, align, lex, cfg, sa_shards, device):
    if isinstance(sa_shards, list):
        return shx.build_sharded_index(source, target, sa, align, cfg,
                                       len(sa_shards), sa_shards)
    if sa_shards:
        return shx.build_sharded_index(source, target, sa, align, cfg,
                                       sa_shards, device)
    return ic.build_index(source, target, sa, align, lex, cfg, device)


def run_pipeline(f_lines, e_lines, a_lines, lex_tokens, q_lines,
                 cfg: ExtractorConfig = DEFAULT_CONFIG,
                 timing: PhaseTimer = None, device="cuda",
                 lcp_passes: bool = False, sa_shards=0,
                 scan_cols: bool = False, index_dir: str = None,
                 dp_devices=0) -> PipelineResult:
    """Runs the main path with every device stage on ``device`` ("cuda": the
    hand-written kernels; "cpu": their plain PyTorch versions).
    ``lcp_passes`` runs pass 1/2 as the LCP-accelerated search (kernel B1)
    instead of the interval refinement (kernel A1); ``sa_shards > 0`` runs
    the sharded index of that many shards (``parallel.sharded.placement``
    from ``device``; a list of devices places shard s on the s-th; "auto":
    as the device budget decides); ``scan_cols`` runs lookup1's and lookup2's
    scans on host-materialised item columns (kernels C1f, C1b, C1t);
    ``index_dir`` loads or persists the corpus index (``build_artifact``);
    ``dp_devices`` (a count N > 1, or a list of devices) replicates the
    index on N devices and splits every device stage's items across them
    (``parallel.localdp``).  The grammar is the same in every case;
    ``lcp_passes`` or ``scan_cols`` with ``sa_shards``, and ``dp_devices``
    with ``sa_shards``, are refused."""
    return run_queries(prepare(
        f_lines, e_lines, a_lines, lex_tokens, cfg, timing, device,
        lcp_passes, sa_shards, scan_cols, index_dir, dp_devices), q_lines,
        cfg, lcp_passes)


def run_queries(prepared, q_lines, cfg: ExtractorConfig,
                lcp_passes: bool = False) -> PipelineResult:
    """The queries ``q_lines`` through every stage, against an index that
    ``prepare`` returned."""
    art, index, t, _, ctx = prepared
    with t.phase("qrysload"):
        queries = cp.load_queries(q_lines, art.source.vocab)
    front = _front_stages(ctx, queries, cfg, t, lcp_passes)
    per_query_lines, counters = _back_stages(ctx, queries, front, cfg, t)
    return PipelineResult(queries=queries, per_query_lines=per_query_lines,
                          counters=counters, timing=t, index=index,
                          blocks=front["blocks"])


def prepare(f_lines, e_lines, a_lines, lex_tokens, cfg, timing, device,
            lcp_passes=False, sa_shards=0, scan_cols=False, index_dir=None,
            dp_devices=0, save_index=True):
    """What every query batch of one index shares (``run_pipeline``,
    ``run_pipeline_overlap``, ``serve``): the options checked, the
    artifact and the device index (``build_artifact``) and the engine
    context (``_make_context``) -> (artifact, index, timing, the resolved
    shard count, context).  A refused combination raises before the
    build; ``save_index`` as ``build_artifact`` takes it."""
    sa_shards = _check_shards(sa_shards, lcp_passes, scan_cols)
    dp = _dp_devices(dp_devices, device, sa_shards)
    art, index, t, sa_shards = build_artifact(
        f_lines, e_lines, a_lines, lex_tokens, cfg, timing, device, sa_shards,
        index_dir, save_index)
    _check_shards(sa_shards, lcp_passes, scan_cols)   # "auto" resolved
    return art, index, t, sa_shards, _make_context(
        art, index, t, cfg, sa_shards, scan_cols, dp)


def _make_context(art, index, t, cfg, sa_shards, scan_cols=False,
                  dp_devices=None) -> dict:
    """The engine and index handles that every query batch of one index
    shares (``run_pipeline``, ``run_pipeline_overlap``, ``serve``);
    ``dp_devices``: the replicas' devices of a ``LocalDPEngine``."""
    ctx = dict(index=index, source=art.source, target=art.target,
               sa=art.sa, pc=art.precomp, lex_index=index, sa_values=None)
    if dp_devices:
        with t.phase("qrysin"):
            ctx["engine"] = localdp.LocalDPEngine(
                index, art.sa.sa, cfg, devices=dp_devices,
                scan_cols=scan_cols)
        ctx["lex_index"] = ctx["engine"].index
    else:
        ctx["engine"] = make_engine(index, cfg, scan_cols, art.sa.sa)
        if sa_shards:
            with t.phase("qrysin"):
                ctx["lex_index"] = ic.build_host_lex_index(art.target,
                                                           art.lex)
            ctx["sa_values"] = ctx["engine"].sa_values
    ctx["engine"].timer = t
    return ctx


def _concat_gaprules(a: GapRules, b: GapRules) -> GapRules:
    return GapRules(*[np.concatenate([getattr(a, f.name), getattr(b, f.name)])
                      for f in dataclasses.fields(GapRules)])


def _front_stages(ctx, queries, cfg, t, lcp_passes=False):
    """Device-driven half: pass 1/2, the enumerations, lookup1 and lookup2,
    blocks and the extraction of every family."""
    index, pc, source = ctx["index"], ctx["pc"], ctx["source"]
    engine = ctx["engine"]
    if isinstance(index, shx.ShardedGrammarIndex):
        with t.phase("kernel"):
            p1, p2 = shx.sharded_passes(index, queries)
    elif hasattr(engine, "refine_passes"):   # LocalDPEngine: the passes fan
        if lcp_passes:
            with t.phase("kernel"):
                p1 = engine.pass1(queries)
            with t.phase("kernel2"):
                p2 = engine.pass2(queries, p1)
        else:
            with t.phase("kernel"):
                p1, p2 = engine.refine_passes(queries)
    elif lcp_passes:
        with t.phase("kernel"):
            p1 = passes.pass1_lcp(index, queries)
        with t.phase("kernel2"):
            p2 = passes.pass2_lcp(index, queries, p1)
    else:
        with t.phase("kernel"):
            p1, p2 = passes.refine_passes(index, queries)
    with t.phase("enumeration"):
        enum1, search1 = ef.fast_sort_and_dedup_onegap(
            ef.fast_one_gap_enumeration(queries, p1, cfg), queries)
        check_capacity("onegap_enum", len(enum1.number), cfg.cap_onegap_enum)
    with t.phase("lookup1"):
        onegap_sa = lookup.one_gap_lookup(engine, queries, p1, p2, search1,
                                          pc, cfg)
        check_capacity("onegap_sa", len(onegap_sa.position),
                       cfg.cap_onegap_sa)
    with t.phase("enumeration"):
        enum2, search2 = ef.fast_sort_and_dedup_twogap(
            ef.fast_two_gap_enumeration(queries, p1, enum1, search1, cfg),
            queries)
        check_capacity("twogap_enum", len(enum2.number), cfg.cap_twogap_enum)
    with t.phase("lookup2"):
        twogap_sa = lookup.two_gap_lookup(engine, queries, search1, onegap_sa,
                                          search2, pc, cfg,
                                          np.asarray(source.str_))
        check_capacity("twogap_sa", len(twogap_sa.position),
                       cfg.cap_twogap_sa)
    with t.phase("extractin"):
        blocks = generate_blocks(ctx["sa"], queries, p1, p2,
                                 sa_values=ctx["sa_values"])
    with t.phase("extractkernel"):
        contig, og_blocks, tg_blocks = xdev.extract_contiguous(
            engine, blocks, cfg)
        tg_seeds = xdev.extract_twogap(engine, search1, search2, twogap_sa,
                                       cfg)
        og_seeds, tg_onegap = xdev.extract_onegap(engine, search1, onegap_sa,
                                                  pc, cfg)
    # the two-gap rules are XabX, then aXbXc, then XaXb/aXbX
    sep1 = len(tg_blocks.gappy_index)
    return dict(p1=p1, p2=p2, enum1=enum1, search1=search1,
                onegap_sa=onegap_sa, enum2=enum2, search2=search2,
                twogap_sa=twogap_sa, blocks=blocks, contig=contig,
                rules1=_concat_gaprules(og_blocks, og_seeds),
                rules2=_concat_gaprules(_concat_gaprules(tg_blocks, tg_seeds),
                                        tg_onegap),
                sep_onegap=len(og_blocks.gappy_index),
                sep1=sep1, sep2=sep1 + len(tg_seeds.gappy_index))


def _back_stages(ctx, queries, fr, cfg, t):
    """Host half plus MaxLex: lexicon build, MaxLex, rule formatting.  With
    a ``HostLexIndex`` in ``ctx`` it launches nothing and touches no device
    tensor, so ``run_pipeline_overlap`` runs it on a worker thread; its host
    phases then do not wait for the main thread's kernels."""
    source, target, pc = ctx["source"], ctx["target"], ctx["pc"]
    blocks, search1, enum1 = fr["blocks"], fr["search1"], fr["enum1"]
    search2, enum2 = fr["search2"], fr["enum2"]
    onegap_sa = fr["onegap_sa"]
    with t.phase("lexicon", sync=False):
        with child(t, "onegap"):
            rules_one, tasks_one = lx.fast_create_lexicon_onegap(
                fr["rules1"], source, target, blocks, search1, enum1,
                onegap_sa, pc, fr["sep_onegap"], cfg)
        with child(t, "twogap"):
            rules_two, tasks_two = lx.fast_create_lexicon_twogap(
                fr["rules2"], source, target, blocks, search1, enum1,
                search2, enum2, onegap_sa, pc, fr["sep1"], fr["sep2"], cfg)
        with child(t, "contig"):
            rules_contig, tasks_contig = lx.fast_create_lexicon_contig(
                fr["contig"], source, target, blocks, cfg)
    lex_index = ctx["lex_index"]
    with t.phase("maxlex",
                 sync=not isinstance(lex_index, ic.HostLexIndex)):
        ml.compute_maxlex(
            {"onegap": tasks_one, "twogap": tasks_two, "contig": tasks_contig},
            lex_index, rules_one, rules_two, rules_contig, cfg)
    with t.phase("printout", sync=False):
        G = len(blocks.start)
        D1 = len(search1.qrystart)
        D2 = len(search2.blockid)
        with child(t, "updown"):
            ud_contig = lx.updown_index(rules_contig, G)
            ud_one = lx.updown_index(rules_one, 2 * G + D1)
            ud_two = lx.updown_index(rules_two, G + D2 + 2 * D1)
        with child(t, "format"):
            fmt_contig = gw.format_lines(rules_contig)
            fmt_one = gw.format_lines(rules_one)
            fmt_two = gw.format_lines(rules_two)
        with child(t, "lines"):
            per_query_lines = [
                gw.grammar_lines_for_query(
                    q, blocks.qry_global, search1.query_with_id,
                    search2.query_with_id, ud_contig, ud_one, ud_two,
                    fmt_contig, fmt_one, fmt_two, G, D1, D2)
                for q in range(queries.qryscount)
            ]
    total_lines = sum(len(x) for x in per_query_lines)
    kb.COUNTS["grammar.lines"] += total_lines
    counters = dict(
        blocks=G, distinct_onegap=D1, distinct_twogap=D2,
        precomp_rows=pc.count, pass1_tokens=queries.totaltokens,
        pass2_items=len(fr["p2"].up),
        onegap_sa=len(onegap_sa.position),
        twogap_sa=len(fr["twogap_sa"].position),
        contig_pairs=len(fr["contig"].blocknumber),
        onegap_rules=len(fr["rules1"].gappy_index),
        twogap_rules=len(fr["rules2"].gappy_index),
        distinct_rules=len(rules_one) + len(rules_two) + len(rules_contig),
        total_lines=total_lines)
    return per_query_lines, counters


def run_pipeline_overlap(f_lines, e_lines, a_lines, lex_tokens, q_lines,
                         cfg: ExtractorConfig = DEFAULT_CONFIG,
                         timing: PhaseTimer = None, device="cuda",
                         lcp_passes: bool = False, sa_shards=0,
                         scan_cols: bool = False, index_dir: str = None,
                         query_batches: int = 2,
                         dp_devices=0) -> PipelineResult:
    """``--query-batches``: the queries split into contiguous batches; batch
    i's host half (lexicon, MaxLex, formatting) runs on one worker thread
    while the main thread runs batch i+1's device half.  MaxLex scores on
    its host backend (a ``HostLexIndex``, as the JAX package's
    ``maxlex_use_device = False``), so the worker launches no kernel and
    touches no device tensor: this run launches no A9 or A10.  Each query's
    lines equal the single-batch run's (a rule's features are intrinsic to
    its pattern).  Counters are summed over the batches (the pattern-scoped
    ones, such as ``blocks`` and ``distinct_*``, count a pattern once per
    batch that holds it; ``precomp_rows`` belongs to the index and is not
    summed), with the per-batch dicts in ``per_batch``."""
    from concurrent.futures import ThreadPoolExecutor
    art, index, t, sa_shards, ctx = prepare(
        f_lines, e_lines, a_lines, lex_tokens, cfg, timing, device,
        lcp_passes, sa_shards, scan_cols, index_dir, dp_devices)
    if not sa_shards:
        with t.phase("qrysin"):
            ctx["lex_index"] = ic.build_host_lex_index(art.target, art.lex)
    with t.phase("qrysload"):
        all_q = list(q_lines)
    n = max(1, min(query_batches, len(all_q)))
    per = max(1, -(-len(all_q) // n))
    chunks = [all_q[i:i + per] for i in range(0, len(all_q), per)]
    futs = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        for chunk in chunks:
            with t.phase("qrysload"):
                qb = cp.load_queries(chunk, art.source.vocab)
            front = _front_stages(ctx, qb, cfg, t, lcp_passes)
            futs.append(pool.submit(_back_stages, ctx, qb, front, cfg, t))
        outs = [f.result() for f in futs]
    per_query_lines = []
    counters: dict = {}
    for lines, cnt in outs:
        per_query_lines.extend(lines)
        for k, v in cnt.items():
            counters[k] = counters.get(k, 0) + v
    counters["precomp_rows"] = art.precomp.count
    counters["query_batches"] = len(outs)
    counters["per_batch"] = [cnt for _, cnt in outs]
    queries = cp.load_queries(all_q, art.source.vocab)
    return PipelineResult(queries=queries, per_query_lines=per_query_lines,
                          counters=counters, timing=t, index=index)


def run_pipeline_files(reffile, qryfile, tarfile, alignfile, lexfile, dest_dir,
                       cfg: ExtractorConfig = DEFAULT_CONFIG, device="cuda",
                       lcp_passes: bool = False, sa_shards=0,
                       scan_cols: bool = False, index_dir: str = None,
                       query_batches: int = 0, dp_devices=0):
    """The CLI's run over files; ``query_batches > 1`` runs
    ``run_pipeline_overlap``."""
    with open(reffile, encoding="utf-8") as fh:
        f_text = fh.read()
    with open(tarfile, encoding="utf-8") as fh:
        e_text = fh.read()
    args = (f_text, e_text, cp.read_lines(alignfile), cp.read_tokens(lexfile),
            cp.read_lines(qryfile), cfg)
    kw = dict(device=device, lcp_passes=lcp_passes, sa_shards=sa_shards,
              scan_cols=scan_cols, index_dir=index_dir, dp_devices=dp_devices)
    if query_batches > 1:
        res = run_pipeline_overlap(*args, query_batches=query_batches, **kw)
    else:
        res = run_pipeline(*args, **kw)
    gw.write_grammars(dest_dir, res.queries.qryscount, cfg.is_sample,
                      res.per_query_lines)
    print(res.timing.report(), file=sys.stderr)
    print("counters:", res.counters, file=sys.stderr)
    return res
