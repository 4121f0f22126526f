"""Query-DP in the port (``cgx_tpu_torch.parallel.dist``) against the JAX
package's (``cgx_tpu.parallel.dist``) on the toy corpus: kernel B4's plain
version, shard by shard, against ``make_sharded_search_step`` on the 8
virtual CPU devices of tests/conftest.py (every output column of the real
items and both psum'd counts, with item counts that are not multiples of
the shard count, so that padding lanes take part), ``run_sharded_search``
against the JAX one and the oracle's pass 1, three shards on one device
against a 3-device JAX sub-mesh, and the placement helpers."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract.blocks import generate_blocks as jgenerate  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.oracle import search as ose  # noqa: E402
from cgx_tpu.parallel import dist as jdist  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.extract.blocks import generate_blocks  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.parallel import dist  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def world(toy_fixture):
    """Both packages' indexes, queries and blocks on the toy corpus."""
    d = toy_fixture
    f, e, a = (jcp.read_lines(str(d / n))
               for n in ("corpus.f", "corpus.e", "corpus.a"))
    lex, q = jcp.read_tokens(str(d / "lex.txt")), jcp.read_lines(
        str(d / "query.f"))
    jcfg, tcfg = JaxConfig(precompute_count=30), ExtractorConfig(
        precompute_count=30)
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa,
                           jcp.load_alignment(a, jsrc, jtgt),
                           jcp.load_lex_table(lex, jsrc.vocab, jtgt.vocab),
                           jcfg)
    jqs = jcp.load_queries(q, jsrc.vocab)
    jp1, jp2 = jpasses.refine_passes(jidx, jqs)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    tqs = tcp.load_queries(q, tsrc.vocab)
    return dict(jcfg=jcfg, tcfg=tcfg, jsrc=jsrc, jsa=jsa, jidx=jidx, jqs=jqs,
                jblocks=jgenerate(jsa, jqs, jp1, jp2), tidx=tidx, tqs=tqs,
                tblocks=generate_blocks(
                    tsa, tqs, *tpasses.refine_passes(tidx, tqs)))


def _lanes(w, n_cut, m_cut):
    """The first ``n_cut`` pass-1 lanes and ``m_cut`` sampled occurrences."""
    qs = w["jqs"]
    n = qs.totaltokens
    ends = np.array([qs.query_end(int(t)) for t in qs.tok_to_qry], np.int32)
    toks = np.arange(n, dtype=np.int32)
    _, sa_pos, lms = jdist.contig_occurrences(w["jblocks"], w["jcfg"])
    assert n >= n_cut and len(sa_pos) >= m_cut
    return (toks[:n_cut], (ends - toks)[:n_cut], sa_pos[:m_cut],
            lms[:m_cut])


def _jax_step(w, mesh, lanes):
    j, cfg = w["jidx"], w["jcfg"]
    step = jdist.make_sharded_search_step(mesh, j.reflen, cfg.max_rule_span,
                                          cfg.max_rule_symbols)
    rep = [jdist.replicate(mesh, x) for x in (
        j.refstr_padded, j.sa, j.lcpleft, j.lcpright, j.rlp, j.lr_tar,
        j.device_query_tokens(w["jqs"]))]
    return step(*rep, *(jdist.shard_items(mesh, x) for x in lanes))


def _port_step(w, devices, lanes):
    t, cfg = w["tidx"], w["tcfg"]
    step = dist.make_sharded_search_step(devices, t.reflen,
                                         cfg.max_rule_span,
                                         cfg.max_rule_symbols)
    rep = [dist.replicate(devices, x) for x in (
        t.refstr_padded, t.sa, *t.lcp_tables(), t.rlp, t.lr_tar,
        t.query_tokens(w["tqs"]))]
    return step(*rep, *(dist.shard_items(devices, x) for x in lanes))


@pytest.mark.parametrize("n_cut,m_cut", [(61, 203), (37, 100), (9, 17)])
def test_plain_b4_step_equals_jax_on_8_devices(world, n_cut, m_cut):
    """Every pass-1 and extraction column of the real lanes, and the
    global counts, which also count the padding lanes (neither cut is a
    multiple of 8)."""
    assert len(jax.devices()) >= 8
    w = world
    lanes = _lanes(w, n_cut, m_cut)
    jp1, jex, jn_match, jn_rules = _jax_step(w, jdist.make_mesh(8), lanes)
    p1, ex, n_match, n_rules = _port_step(w, [CPU] * 8, lanes)
    assert len(p1) == 6 and len(ex) == 8
    for k in range(6):
        assert p1[k].dtype == torch.int32 and p1[k].shape[0] % 8 == 0
        np.testing.assert_array_equal(p1[k][:n_cut].numpy(),
                                      np.asarray(jp1[k])[:n_cut], err_msg=k)
    for k in range(8):
        np.testing.assert_array_equal(ex[k][:m_cut].numpy(),
                                      np.asarray(jex[k])[:m_cut], err_msg=k)
    assert (n_match, n_rules) == (int(jn_match), int(jn_rules))
    assert n_match > 0 and n_rules > 0


def test_run_sharded_search_equals_jax_and_oracle(world):
    """The toy run on 8 shards: longestmatch equals the oracle's pass 1,
    and both counts equal the JAX run's on the 8 virtual devices."""
    w = world
    lm, n_match, n_rules = dist.run_sharded_search(
        [CPU] * 8, w["tidx"], w["tqs"], w["tblocks"], w["tcfg"])
    jlm, jn_match, jn_rules = jdist.run_sharded_search(
        jdist.make_mesh(8), w["jidx"], w["jqs"], w["jblocks"], w["jcfg"])
    want = ose.pass1(w["jsrc"], w["jsa"], w["jqs"]).longestmatch
    assert lm.dtype == np.int32
    np.testing.assert_array_equal(lm, want)
    np.testing.assert_array_equal(lm, jlm)
    assert n_match == int((want > 0).sum()) == jn_match
    assert n_rules == jn_rules > 0


def test_three_shards_on_one_device_equal_jax_sub_mesh(world):
    """S = 3 shards, all on one device, against a 3-device JAX mesh."""
    w = world
    devices = dist.make_mesh(devices=["cpu"] * 3)
    assert devices == [CPU] * 3
    got = dist.run_sharded_search(devices, w["tidx"], w["tqs"], w["tblocks"],
                                  w["tcfg"])
    want = jdist.run_sharded_search(
        jdist.make_mesh(devices=jax.devices()[:3]), w["jidx"], w["jqs"],
        w["jblocks"], w["jcfg"])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(int(x) for x in want[1:])


@pytest.mark.parametrize("is_sample", [True, False])
def test_contig_occurrences_equals_jax(world, is_sample):
    """The sampled work list, block by block, from the same blocks."""
    w = world
    got = dist.contig_occurrences(
        w["jblocks"], ExtractorConfig(is_sample=is_sample, sampler=3))
    want = jdist.contig_occurrences(
        w["jblocks"], JaxConfig(is_sample=is_sample, sampler=3))
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert len(got[0]) > 0


def test_placement_helpers():
    """Padding to the shard count, contiguous slices in shard order, and
    one copy per distinct device."""
    a = np.arange(10, dtype=np.int32)
    np.testing.assert_array_equal(dist.pad_to_multiple(a, 4, -1),
                                  jdist.pad_to_multiple(a, 4, -1))
    assert dist.pad_to_multiple(a, 5, 0) is a
    parts = dist.shard_items([CPU] * 4, a, fill=7)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8],
                                           [9, 7, 7]]
    reps = dist.replicate([CPU] * 3, torch.arange(5))
    assert reps[0] is reps[1] is reps[2]
    assert dist.wrap32(2**31) == -2**31 and dist.wrap32(2**32 + 5) == 5


def test_make_mesh_without_a_card_raises(monkeypatch):
    """The default mesh is the CUDA devices; there is no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dist.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dist.make_mesh()


def test_plain_b4_edge_lanes_equal_jax(world):
    """B4's pass-1 lanes (kernel B1's warp body in csrc/dist.cu) on the
    hazard lanes of that body, against ``make_sharded_search_step`` on the
    8 virtual devices: OOV tokens (found before the first step), suffixlen
    1, each query's last token, and a lane count that leaves shards with a
    partial warp; the hit count covers the OOV lanes too."""
    w = world
    qs = w["jqs"]
    n = qs.totaltokens
    ends = np.array([qs.query_end(int(t)) for t in qs.tok_to_qry], np.int32)
    sls = ends - np.arange(n, dtype=np.int32)
    last = np.unique(ends - 1)
    toks = np.concatenate([np.arange(n), last, np.arange(n)])[:2 * n - 3]
    suff = np.concatenate([sls, np.ones(len(last) + n)])[:2 * n - 3]
    qtok = np.asarray(w["jidx"].device_query_tokens(qs)).copy()
    qtok[[0, 5, n // 2]] = -1
    _, sa_pos, lms = jdist.contig_occurrences(w["jblocks"], w["jcfg"])
    lanes = (toks.astype(np.int32), suff.astype(np.int32), sa_pos[:17],
             lms[:17])
    j, t, cfg = w["jidx"], w["tidx"], w["tcfg"]
    mesh = jdist.make_mesh(8)
    step = jdist.make_sharded_search_step(mesh, j.reflen, cfg.max_rule_span,
                                          cfg.max_rule_symbols)
    jp1, _, jn_match, _ = step(
        *[jdist.replicate(mesh, x) for x in (
            j.refstr_padded, j.sa, j.lcpleft, j.lcpright, j.rlp, j.lr_tar,
            qtok)], *(jdist.shard_items(mesh, x) for x in lanes))
    devices = [CPU] * 8
    pstep = dist.make_sharded_search_step(devices, t.reflen,
                                          cfg.max_rule_span,
                                          cfg.max_rule_symbols)
    p1, _, n_match, _ = pstep(
        *[dist.replicate(devices, x) for x in (
            t.refstr_padded, t.sa, *t.lcp_tables(), t.rlp, t.lr_tar,
            torch.from_numpy(qtok))],
        *(dist.shard_items(devices, x) for x in lanes))
    m = len(toks)
    for k in range(6):
        np.testing.assert_array_equal(p1[k][:m].numpy(),
                                      np.asarray(jp1[k])[:m], err_msg=k)
    assert n_match == int(jn_match)
    lm = p1[0][:m].numpy()
    assert (lm == 0).any() and (lm[suff == 1] <= 1).all() and (lm > 1).any()
