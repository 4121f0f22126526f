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
from cgx_tpu_torch.tools import reads  # noqa: E402
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


@pytest.mark.parametrize("mrs,msym", [(15, 5), (1, 5), (2, 2), (8, 3)])
def test_plain_a6_equals_contig_batch(world, mrs, msym):
    """Every sampled occurrence of the corpus's blocks, random (position,
    length) lanes that run into corpus and sentence edges, and the
    occurrences at corpus positions 0, 1, reflen - 2 and reflen - 1 (SA
    positions from the inverse SA) with every block length 1..mrs, under
    the default span limits and narrower ones."""
    w = world
    b = w["jblocks"]
    lo = np.where(b.matchlen >= 1, b.start, 0)
    hi = np.where(b.matchlen >= 1, b.end, -1)
    bnums, tx = occurrence_lists(lo, hi, 300, True)
    rng = np.random.default_rng(0)
    extra = 200
    ix = w["jidx"]
    reflen = int(ix.reflen)
    inv = np.empty(reflen, np.int64)
    inv[np.asarray(ix.sa)[:reflen]] = np.arange(reflen)
    ends = inv[[0, 1, reflen - 2, reflen - 1]]
    lms = np.arange(1, mrs + 1)
    sa_pos = np.concatenate([b.start[bnums] + tx, rng.integers(
        0, reflen, extra), np.repeat(ends, mrs)]).astype(np.int32)
    lm = np.concatenate([b.matchlen[bnums], rng.integers(1, 6, extra),
                         np.tile(lms, len(ends))]).astype(np.int32)
    want = jdev._contig_batch(ix.refstr_padded, ix.sa, ix.rlp, ix.lr_tar,
                              jnp.asarray(sa_pos), jnp.asarray(lm), ix.offs0,
                              mrs, msym)
    t = w["tidx"]
    got = tdev.contig(t.refstr_padded, t.sa, t.rlp, t.lr_tar,
                      torch.from_numpy(sa_pos), torch.from_numpy(lm), mrs,
                      msym)
    assert got.shape == (8, len(sa_pos)) and got.dtype == torch.int32
    for col, wcol in enumerate(want):
        np.testing.assert_array_equal(got[col].numpy(), np.asarray(wcol),
                                      err_msg=f"column {col}")
    # ab always; XabX wherever lm + 2 <= min(mrs, msym) admits it
    assert (got[1].numpy() & 1).any()
    assert (got[7].numpy() & 1).any() == (min(mrs, msym) >= 3)


def test_contig_reads_counts_distinct_words(world):
    """``tools.reads.contig_reads`` (the words the bound of A6, B3c and B4
    counts) is the distinct needed slots per array over all the items (a
    word that several items read is moved once): it equals a walk over
    ``contig_need``'s slots, lies under the sum of each item's own distinct
    slots, and each item's lie under a word-by-word walk of everything
    ``_extract_contig_item`` gathers (the base span, its sentence anchor,
    each side's 14 steps, three whole target windows), on random
    occurrences and the corpus ends.  ``tests/test_torch_reads.py``
    shows that the needed words decide the output."""
    t = world["tidx"]
    rlp = t.rlp.numpy().view(np.uint32).astype(np.int64)
    n_ref, n_tar = t.refstr_padded.shape[0], t.lr_tar.shape[0]
    rng = np.random.default_rng(5)
    cs = np.concatenate([[0, 1, t.reflen - 2, t.reflen - 1],
                         rng.integers(0, t.reflen, 200)])
    lm = rng.integers(1, 16, len(cs))
    mrs, msym = 15, 5

    def clamp(p, n):
        return min(max(p, 0), n - 1)

    def L_al(p):
        if p < 0:
            return 255, False
        x = rlp[clamp(p, len(rlp))]
        L, R = (x >> 24) & 0xFF, (x >> 16) & 0xFF
        return L, L != 255 and R != 255
    gathered = []
    for c, m in zip(cs.tolist(), lm.tolist()):
        tempind = c - ((rlp[clamp(c, len(rlp))] >> 8) & 0xFF) - 1
        stb = 0 if tempind == -1 else rlp[clamp(tempind, len(rlp))]
        stb = stb - 2**32 if stb >= 2**31 else stb
        span = [c + k for k in range(16)]
        min_L = min([L for L, al in map(L_al, span[:m]) if al] + [256])
        sides = [[c - i for i in range(1, 15)],
                 [c + m - 1 + i for i in range(1, 15)]]
        anchors = [stb + min(min_L, 255)]
        for pos in sides:
            steps = [L_al(p) for p in pos]
            first = next((L for L, al in steps if al), steps[0][0])
            anchors.append(stb + first)
        read = [p for s in sides for p in s if p >= 0]
        rl = span + read + ([tempind] if tempind != -1 else [])
        gathered.append(len({clamp(p, len(rlp)) for p in rl})
                        + len({clamp(p, n_ref) for p in read})
                        + len({clamp(a + d, n_tar) for a in anchors
                               for d in range(-mrs + 1, mrs)}))
    args = (t.refstr_padded, t.rlp, t.lr_tar,
            torch.from_numpy(cs.astype(np.int32)),
            torch.from_numpy(lm.astype(np.int32)), mrs, msym)
    need = reads.contig_need(*args)
    needed = []
    for i in range(len(cs)):
        needed.append(sum(len(set(slots[i][keep[i]].tolist()))
                          for slots, keep in (need["refstr"], need["rlp"],
                                              need["lr_tar"])))
    words, steps, inner = reads.contig_reads(*args)
    assert words == sum(len(set(slots[keep].tolist()))
                        for slots, keep in (need["refstr"], need["rlp"],
                                            need["lr_tar"]))
    assert words <= sum(needed)
    assert all(0 < w <= g for w, g in zip(needed, gathered))
    assert words < sum(gathered)
    assert 0 < steps <= 14 * len(cs) and 0 <= inner <= 14 * steps


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
