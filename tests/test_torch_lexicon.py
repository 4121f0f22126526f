"""The port's lexicon calls with EMPTY one-gap/two-gap search structures (the
block half alone) build exactly the rules and MaxLex tasks the JAX package
builds for the same block-derived rows next to its real gappy structures."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.features import lexicon as jlx  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.types import GapRules  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.features import lexicon as tlx  # noqa: E402
from cgx_tpu_torch.types import (Blocks, GapOnSA, OneGapEnum,  # noqa: E402
                                 OneGapSearch, Precomp, TwoGapEnum,
                                 TwoGapSearch)


def _no_gappy_structures():
    """The gappy search structures of a query set with no gappy patterns:
    (search1, enum1, onegap_sa, pc, search2, enum2)."""
    z = np.empty(0, np.int32)
    search1 = OneGapSearch(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                           position=z, start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum1 = OneGapEnum(qrystart=z, qrystart_len=z, qryend_len=z, gap=z,
                       pattern=np.empty((0, 5), np.int32), number=z)
    pc = Precomp(frequent_list=z, tok_start=z, tok_len=z, index_start=z,
                 index_end=z, onegap_start=z, onegap_length=z,
                 feature_missing=z)
    search2 = TwoGapSearch(blockid=z, position=z, qryend_len=z, gap2=z,
                           start_on_salist=z, end_on_salist=z,
                           query_with_id=[])
    enum2 = TwoGapEnum(blockid=z, gap2=z, qryend_len=z,
                       pattern=np.empty((0, 1), np.int32), number=z)
    return (search1, enum1, GapOnSA(z, z, z, z), pc, search2, enum2)


def _head(rules: GapRules, n: int) -> GapRules:
    return GapRules(*(getattr(rules, f.name)[:n]
                      for f in dataclasses.fields(GapRules)))


def _assert_tables_equal(got, want):
    (gr, gt), (wr, wt) = got, want
    assert len(gr) == len(wr) > 0
    assert gr.lexical == wr.lexical
    for f in dataclasses.fields(wr):
        if f.name != "lexical":
            a, b = getattr(gr, f.name), getattr(wr, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                          b.view(np.int32) if b.dtype == np.float32 else b,
                                          err_msg=f.name)
    for f in dataclasses.fields(wt):
        np.testing.assert_array_equal(getattr(gt, f.name), getattr(wt, f.name),
                                      err_msg=f.name)


def test_lexicon_with_empty_gappy_structures(toy_fixture):
    d = toy_fixture
    args = (jcp.read_lines(str(d / "corpus.f")), jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")), jcp.read_tokens(str(d / "lex.txt")))
    jcfg = JaxConfig(precompute_count=20)
    art, index, t, shc, shards = jpl.build_artifact(*args, jcfg)
    ctx = jpl._make_context(art, index, t, jcfg, shards, sharded_ctx=shc)
    qs = jcp.load_queries(jcp.read_lines(str(d / "query.f")), art.source.vocab)
    fr = jpl._front_stages(ctx, qs, jcfg, t)
    assert len(fr["search1"].qrystart) > 0 and len(fr["search2"].blockid) > 0
    # the block-derived rows lead each family: Xab/abX before the aXb seeds,
    # XabX before the aXbXc and XaXb/aXbX rows
    r1 = _head(fr["rules1"], fr["sep_onegap"])
    r2 = _head(fr["rules2"], fr["sep1"])
    src, tgt, blocks = art.source, art.target, fr["blocks"]
    cfg = ExtractorConfig()
    s1, e1, og, pc, s2, e2 = _no_gappy_structures()

    want1 = jlx.fast_create_lexicon_onegap(
        r1, src, tgt, blocks, fr["search1"], fr["enum1"], fr["onegap_sa"],
        art.precomp, len(r1.gappy_index), jcfg)
    got1 = tlx.fast_create_lexicon_onegap(r1, src, tgt, blocks, s1, e1, og, pc,
                                          len(r1.gappy_index), cfg)
    _assert_tables_equal(got1, want1)

    n2 = len(r2.gappy_index)
    want2 = jlx.fast_create_lexicon_twogap(
        r2, src, tgt, blocks, fr["search1"], fr["enum1"], fr["search2"],
        fr["enum2"], fr["onegap_sa"], art.precomp, n2, n2, jcfg)
    got2 = tlx.fast_create_lexicon_twogap(r2, src, tgt, blocks, s1, e1, s2, e2,
                                          og, pc, n2, n2, cfg)
    _assert_tables_equal(got2, want2)


def test_empty_families_give_empty_tables():
    s1, e1, og, pc, s2, e2 = _no_gappy_structures()
    z = GapRules(*(np.empty(0, np.int32) for _ in range(7)))
    e = np.empty(0, np.int32)
    blocks = Blocks(start=e, end=e, matchlen=e, string_start=e, qry_global=[])
    rules, tasks = tlx.fast_create_lexicon_onegap(z, None, None, blocks, s1,
                                                  e1, og, pc, 0,
                                                  ExtractorConfig())
    assert len(rules) == 0 and len(tasks.t0) == 0
    assert tlx.updown_index(rules, 4).tolist() == [[-1, -1]] * 4
