"""Oracle MaxLex scoring (sequential), mirroring lexicalTaskMaxEF
(ExtractPair.cu:2144-2432).  Lexicon building and the up/down index are shared host
code in cgx_tpu_torch.features.lexicon; re-exported here for the oracle pipeline."""

from __future__ import annotations

import numpy as np

from cgx_tpu_torch.config import ExtractorConfig
from cgx_tpu_torch.preproc.corpus import LexTable, TargetCorpus
from cgx_tpu_torch.features.lexicon import (  # noqa: F401
    X1, X2, create_lexicon_contig, create_lexicon_onegap, create_lexicon_twogap,
    updown_index)
from cgx_tpu_torch.types import FastSpeed, LexTask  # noqa: F401

def _lex_dict(lex: LexTable):
    return {(int(s), int(t)): (np.float32(v1), np.float32(v2))
            for s, t, v1, v2 in zip(lex.keys_src, lex.keys_tgt, lex.val1, lex.val2)}


def compute_maxlex(tasks, target: TargetCorpus, lex: LexTable,
                   rules_one, rules_two, rules_contig, cfg: ExtractorConfig):
    """Scores every LexTask and scatters MaxLexFgivenE/EgivenF into the rule lists.
    Task order: one-gap tasks, two-gap tasks, contiguous tasks (the shared
    lexicalTaskCounter across the three createLexicon calls)."""
    table = _lex_dict(lex)
    tstr = target.str_
    maxscore = np.float32(cfg.max_score)

    def val(s, t, which):
        v = table.get((s, t))
        if v is None:
            return np.float32(0)
        return v[0] if which == 1 else v[1]

    for task in tasks:
        t0 = task.target_start
        t1 = t0 + task.end
        if task.kind == "contig":
            tpos = list(range(t0, t1 + 1))
        elif task.kind == "onegap":
            g1s, g1e = t0 + task.gap1, t0 + task.gap1_1
            tpos = [j for j in range(t0, t1 + 1) if j < g1s or j > g1e]
        else:
            g1s, g1e = t0 + task.gap1, t0 + task.gap1_1
            g2s, g2e = t0 + task.gap2, t0 + task.gap2_1
            tpos = [j for j in range(t0, t1 + 1)
                    if (j < g1s or j > g1e) and (j < g2s or j > g2e)]
        fge = np.float32(0)
        for s in task.source_pattern:
            best = np.float32(0)
            first = True
            for j in tpos:
                if first:
                    best = max(best, val(s, -1, 2))
                    first = False
                best = max(best, val(s, int(tstr[j]), 2))
            if best > 0:
                fge = np.float32(fge + np.float32(-np.log10(best)))
            else:
                fge = np.float32(fge + maxscore)
        egf = np.float32(0)
        for j in tpos:
            tj = int(tstr[j])
            best = np.float32(0)
            first = True
            for s in task.source_pattern:
                if first:
                    best = max(best, val(-1, tj, 1))
                    first = False
                best = max(best, val(s, tj, 1))
            if best > 0:
                egf = np.float32(egf + np.float32(-np.log10(best)))
            else:
                egf = np.float32(egf + maxscore)
        if task.kind == "onegap":
            r = rules_one[task.fast_speed_id]
        elif task.kind == "twogap":
            r = rules_two[task.fast_speed_id]
        else:
            r = rules_contig[task.fast_speed_id]
        r.max_lex_fge = fge
        r.max_lex_egf = egf


