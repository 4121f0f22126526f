"""Contiguous extraction in the port: kernel A6's plain version against the JAX
``_contig_batch`` on all eight output columns, and ``extract_contiguous``
against the JAX package's ``extract_contiguous_tpu`` and the sequential
oracle."""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract import device as jdev  # noqa: E402
from cgx_tpu.extract.blocks import generate_blocks as jgenerate  # noqa: E402
from cgx_tpu.extract.blocks import occurrence_lists  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.oracle import extract as oex  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.extract.blocks import generate_blocks  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.utils.views import OffsetView  # noqa: E402


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], ExtractorConfig())


def _inputs(name, request):
    if name == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 6, seed=3))
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")), jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")), jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module", params=["toy", "real", "hard"])
def world(request):
    f, e, a, lex_t, q = _inputs(request.param, request)
    cfg = JaxConfig()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jsa = jsab.build_index(jsrc.str_)
    jal = jcp.load_alignment_fast(a, jsrc, jtgt)
    jidx = jic.build_index(jsrc, jtgt, jsa, jal,
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           cfg)
    jqs = jcp.load_queries(q, jsrc.vocab)
    jblocks = jgenerate(jsa, jqs, *jpasses.refine_passes(jidx, jqs))
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           ExtractorConfig(), "cpu")
    tqs = tcp.load_queries(q, tsrc.vocab)
    tblocks = generate_blocks(tsa, tqs, *tpasses.refine_passes(tidx, tqs))
    return dict(cfg=cfg, src=jsrc, sa=jsa, al=jal, jidx=jidx, jblocks=jblocks,
                tidx=tidx, tblocks=tblocks)


def test_plain_a6_equals_contig_batch(world):
    """Every sampled occurrence of the corpus's blocks, plus random
    (position, length) lanes that run into corpus and sentence edges."""
    w = world
    b = w["jblocks"]
    lo = np.where(b.matchlen >= 1, b.start, 0)
    hi = np.where(b.matchlen >= 1, b.end, -1)
    bnums, tx = occurrence_lists(lo, hi, 300, True)
    rng = np.random.default_rng(0)
    extra = 200
    sa_pos = np.concatenate([b.start[bnums] + tx, rng.integers(
        0, w["jidx"].reflen, extra)]).astype(np.int32)
    lm = np.concatenate([b.matchlen[bnums], rng.integers(1, 6, extra)]
                        ).astype(np.int32)
    ix = w["jidx"]
    want = jdev._contig_batch(ix.refstr_padded, ix.sa, ix.rlp, ix.lr_tar,
                              jnp.asarray(sa_pos), jnp.asarray(lm), ix.offs0,
                              15, 5)
    t = w["tidx"]
    got = tdev.contig(t.refstr_padded, t.sa, t.rlp, t.lr_tar,
                      torch.from_numpy(sa_pos), torch.from_numpy(lm), 15, 5)
    assert got.shape == (8, len(sa_pos)) and got.dtype == torch.int32
    for col, wcol in enumerate(want):
        np.testing.assert_array_equal(got[col].numpy(), np.asarray(wcol),
                                      err_msg=f"column {col}")
    assert (got[1].numpy() & 1).any() and (got[7].numpy() & 1).any()


def _eq(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                      err_msg=f.name)


@pytest.mark.parametrize("sample", [True, False])
def test_extract_contiguous_equals_jax_and_oracle(world, sample):
    w = world
    for f in dataclasses.fields(w["jblocks"]):
        assert np.array_equal(np.asarray(getattr(w["tblocks"], f.name),
                                         dtype=object),
                              np.asarray(getattr(w["jblocks"], f.name),
                                         dtype=object)), f.name
    jcfg = dataclasses.replace(w["cfg"], is_sample=sample)
    tcfg = ExtractorConfig(is_sample=sample)
    got = tdev.extract_contiguous(_engine(w), w["tblocks"], tcfg)
    want = jdev.extract_contiguous_tpu(w["jidx"], w["jblocks"], jcfg)
    oracle = oex.extract_contiguous(w["src"], w["sa"], w["al"], w["jblocks"],
                                    jcfg)
    for g, j, o in zip(got, want, oracle):
        _eq(g, j)
        _eq(g, o)
    assert len(got[0].blocknumber) > 0 and len(got[1].gappy_index) > 0


@pytest.mark.parametrize("sample", [True, False])
def test_plain_identity_views_change_nothing(world, sample, monkeypatch):
    """A6's plain version, on the inputs of the contiguous extraction's own
    call (sampled or not), gives the same words when refstr, rlp and lr_tar
    come as explicit identity views (offset 0, global length = local
    length)."""
    w = world
    calls = []
    real = tdev.contig

    def hook(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(tdev, "contig", hook)
    tdev.extract_contiguous(_engine(w), w["tblocks"],
                            ExtractorConfig(is_sample=sample))
    (args,) = calls
    want = tdev.contig_plain(*args)
    got = tdev.contig_plain(*[OffsetView(a, 0, a.shape[0])
                              if i in (0, 2, 3) else a
                              for i, a in enumerate(args)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want[1] & 1).any()
