"""The sharded index in the port (``cgx_tpu_torch.parallel.sharded``) against
the JAX package's (``cgx_tpu.parallel.sharded``) on the toy corpus, exactly:
the per-shard arrays, kernel B2's plain versions (refinement, SA gather),
kernel B3's (per-item scans, verification, second-gap scan, contiguous
extraction) and A4, A7, A8 on shard views, the passes, the pipeline and the
CLI with ``sa_shards``, the build that never places a replicated index,
the per-shard memory accounting and the host MaxLex backend, the premise
of kernel B2r's search read through the shards, and B2r's limit on the
shard count; the index placed on a device list (``["cpu"] * S``): its
placement, the round form of the refinement (kernels B2s and B2t, driven
to completion) against ``_refine_chunk`` and the replicated passes, its
tree step (five bisection levels a step) and single-row plan against
JAX's bisection on arbitrary key columns and its step and launch counts,
B2g by owner, and the pipeline against the JAX package's sharded run and
the bench's golden hash.  The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py; the port side on the CPU, that is, on the kernels'
plain versions."""

import copy
import dataclasses
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import cli as jcli  # noqa: E402
from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract import device as jdev  # noqa: E402
from cgx_tpu.features import maxlex as jml  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.parallel import sharded as jshx  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.extract.blocks import generate_blocks  # noqa: E402
from cgx_tpu_torch.features import lexicon as tlx  # noqa: E402
from cgx_tpu_torch.features import maxlex as tml  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.parallel import sharded as tshx  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import lookup as tlk  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402
from cgx_tpu_torch.utils.views import take  # noqa: E402

SHARDS = (3, 8)          # 3: uneven shards; 8: the whole virtual mesh
MRS, MGS, MSYM = 15, 1, 5


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], w["tcfg"])


def _cfgs():
    return JaxConfig(precompute_count=30), ExtractorConfig(precompute_count=30)


@pytest.fixture(scope="module")
def data(toy_fixture):
    d = toy_fixture
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module")
def world(data):
    """Both packages' corpora, the JAX sharded index for each S, and the
    port's replicated index on the CPU."""
    f, e, a, lex, q = data
    jcfg, tcfg = _cfgs()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jal = jcp.load_alignment(a, jsrc, jtgt)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa, jal,
                           jcp.load_lex_table(lex, jsrc.vocab, jtgt.vocab),
                           jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tal = tcp.load_alignment_fast(a, tsrc, ttgt)
    tlex = tcp.load_lex_table(lex, tsrc.vocab, ttgt.vocab)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa, tal, tlex, tcfg, "cpu")
    return dict(
        jcfg=jcfg, tcfg=tcfg, jsrc=jsrc, jtgt=jtgt, jal=jal, jsa=jsa,
        jidx=jidx,
        jqs=jcp.load_queries(q, jsrc.vocab),
        jsidx={S: jshx.build_sharded_index(jsrc, jtgt, jsa, jal, jcfg,
                                           n_devices=S) for S in SHARDS},
        tsrc=tsrc, ttgt=ttgt, tal=tal, tlex=tlex, tsa=tsa, tidx=tidx,
        tqs=tcp.load_queries(q, tsrc.vocab))


def _jsidx(w, S):
    """The JAX sharded index of S shards (over the first S virtual
    devices)."""
    if S not in w["jsidx"]:
        w["jsidx"][S] = jshx.build_sharded_index(
            w["jsrc"], w["jtgt"], w["jsa"], w["jal"], w["jcfg"],
            n_devices=S)
    return w["jsidx"][S]


def _carried(w, S, device="cpu"):
    """The JAX sharded index of S shards carried across to ``device`` (one
    device or a list)."""
    j = _jsidx(w, S)
    return tshx.from_jax_sharded(
        {f: (np.asarray(getattr(j, f)) if getattr(j, f) is not None
             else None) for f in tshx.SHARDED_FIELDS}, device)


@pytest.mark.parametrize("S", SHARDS)
def test_build_sharded_index_equals_jax(world, S):
    """Every array and scalar field, word for word."""
    w = world
    j = w["jsidx"][S]
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    for f in ("S", "reflen", "ref_glen", "rlp_glen", "tgt_glen", "B", "BR",
              "BH"):
        assert getattr(t, f) == int(getattr(j, f)), f
    for f in ("sa_l", "ref_l", "lrt_l"):
        got = torch.stack(getattr(t, f)).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(j, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(
        torch.stack(t.rlp_l).numpy().view(np.uint32), np.asarray(j.rlp_l))
    for f in ("src_off", "tgt_off", "seed_lo1", "seed_hi1", "seed_pk",
              "seed_pk3"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)
    np.testing.assert_array_equal(t.rmeta, np.asarray(j.rmeta)[:, 0, :])
    np.testing.assert_array_equal(t.smeta, np.asarray(j.smeta)[:, 0, :])
    assert len(t.sa_l) == S and all(x.device.type == "cpu" for x in t.ref_l)


@pytest.mark.parametrize("S", (1, 3, 4, 8))
def test_rank_token_slices_of_the_replicated_index(world, S):
    """``rank_token_slices`` over the replicated index's SA and padded
    corpus (cut to the sharded index's ``ref_glen``) gives the sharded
    index's rank and token slices and meta rows, as ``chip_smoke.py`` uses
    it to lay out B2r's and B2g's edge inputs on other shard counts."""
    w = world
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    tidx, reflen = w["tidx"], int(w["tidx"].reflen)
    FH = t.ref_l[0].shape[0] - t.B - t.BH
    sl = tshx.rank_token_slices(tidx.refstr_padded[:t.ref_glen].numpy(),
                                tidx.sa[:reflen].numpy(), reflen, S, t.BH,
                                FH)
    assert (sl["B"], sl["BR"]) == (t.B, t.BR)
    for f in ("sa_l", "ref_l"):
        np.testing.assert_array_equal(
            sl[f], torch.stack(getattr(t, f)).numpy(), err_msg=f)
    np.testing.assert_array_equal(sl["src_off"], t.src_off)
    np.testing.assert_array_equal(sl["rmeta"], t.rmeta)
    np.testing.assert_array_equal(sl["smeta"], t.smeta)


def test_shards_on_several_devices_are_refused(world, monkeypatch):
    """Shards on a device list are placed, shard s on the s-th device, as
    JAX's ``P("sa")`` places them on its mesh (the same slices as the
    one-device layout, the round form chosen); what is refused is a device
    with no kernels, a card that is not there, and a list of the wrong
    length."""
    w = world
    args = (w["tsrc"], w["ttgt"], w["tsa"], w["tal"], w["tcfg"])
    one = tshx.build_sharded_index(*args, 3, "cpu")
    listed = tshx.build_sharded_index(*args, 3, ["cpu"] * 3)
    assert not one.listed and listed.listed
    assert listed.local_shards() == [0, 1, 2]
    assert [listed.device_of(s) for s in range(3)] == [torch.device("cpu")] * 3
    for part in ("sa_l", "ref_l", "rlp_l", "lrt_l"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(one, part),
                                                     getattr(listed, part)))
    with pytest.raises(ValueError, match="no kernels for device meta"):
        tshx.build_sharded_index(*args, 2, ["cpu", "meta"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="cuda:2 named, but 2 CUDA"):
        tshx.build_sharded_index(*args, 3, ["cuda:0", "cuda:1", "cuda:2"])
    with pytest.raises(ValueError, match="2 devices for 3 shards"):
        tshx.build_sharded_index(*args, 3, ["cpu"] * 2)


def test_bare_cuda_spreads_over_the_visible_cards(monkeypatch):
    """A bare "cuda" places shard s on ``cuda:(s mod k)`` over k >= 2
    visible cards (a device list: the round form), and every shard on the
    one card otherwise (B2r's layout)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    devices, listed = tshx.placement(5, "cuda")
    assert listed and devices == [torch.device("cuda", s % 3)
                                  for s in range(5)]
    assert tshx.placement(2, "cuda:1") == ([torch.device("cuda:1")] * 2,
                                           False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tshx.placement(4, "cuda") == ([torch.device("cuda:0")] * 4,
                                         False)
    assert tshx.placement(4, "cpu") == ([torch.device("cpu")] * 4, False)


def test_processes_place_their_own_blocks(monkeypatch):
    """With several processes the global shard list runs process-major:
    each process places its contiguous block only, and the layout counts
    as a device list; fewer shards than processes are refused."""
    for rank, P, S, own in ((0, 2, 2, [0]), (1, 2, 2, [1]),
                            (0, 2, 3, [0, 1]), (1, 2, 3, [2]),
                            (2, 3, 8, [6, 7])):
        monkeypatch.setattr(tshx, "process_group", lambda: (rank, P))
        devices, listed = tshx.placement(S, "cpu")
        assert listed and [s for s, d in enumerate(devices)
                           if d is not None] == own
    monkeypatch.setattr(tshx, "process_group", lambda: (0, 3))
    with pytest.raises(ValueError, match="2 shards over 3 processes"):
        tshx.placement(2, "cpu")


def _lanes(rng, w, reflen, n=120):
    """Refinement lanes with intervals that run off both ends of the SA
    (unowned ranks read 0), and two that span the whole SA."""
    qtok = np.asarray(w["jqs"].padded_tokens())
    toks = rng.integers(0, w["jqs"].totaltokens, n).astype(np.int32)
    sls = rng.integers(1, 8, n).astype(np.int32)
    lo = rng.integers(0, reflen, n).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, n), reflen).astype(np.int32)
    lo[:6], hi[:6] = -7, rng.integers(0, 30, 6)          # off the front
    lo[6:12] = reflen - 5
    hi[6:12] = reflen + rng.integers(1, 40, 6)           # off the back
    lo[12:14], hi[12:14] = 0, reflen                     # the whole SA
    return qtok, toks, sls, lo, hi


@pytest.mark.parametrize("S", (1, 3, 8))
def test_plain_round_form_equals_refine_chunk(world, S):
    """B2s and B2t's plain versions driven to completion over the index on
    ``["cpu"] * S`` (``refine_round``) against ``_refine_chunk`` on the JAX
    mesh of S devices: (ups, downs, lo, hi), and B2r's plain version."""
    w = world
    j = _jsidx(w, S)
    t = _carried(w, S, ["cpu"] * S)
    rng = np.random.default_rng(40 + S)
    qtok, toks, sls, lo, hi = _lanes(rng, w, t.reflen)
    for d0, depths in ((0, 4), (3, 16), (1, 1)):
        want = jshx._refine_chunk(
            j.sa_l, j.ref_l, j.rmeta, j.smeta, jnp.asarray(qtok),
            jnp.asarray(toks), jnp.asarray(sls), jnp.asarray(lo),
            jnp.asarray(hi), jnp.int32(d0), mesh=j.mesh, depths=depths)
        got = tshx.refine_round(t, torch.from_numpy(qtok), toks, sls, lo, hi,
                                d0, depths)
        b2r = tshx.refine_sharded(_carried(w, S), *(torch.from_numpy(x)
                                  for x in (qtok, toks, sls, lo, hi)), d0,
                                  depths)
        for g, r, wv in zip(got, b2r, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
            assert torch.equal(g, r)


@pytest.mark.parametrize("width", [0, 1, 2, 3, 4, 7, 8, 255, 256])
def test_round_steps_end_every_bisection(width):
    """``round_steps`` gives each lower bound as many steps as the widest
    interval's bisection takes, ceil(log2(w + 1)), at least 1: a lower
    bound run for that many steps (B2s's update, on the host) ends every
    search of that width, whatever the key, and one step fewer does
    not for some key."""
    K = tshx.round_steps(np.array([0, 5]), np.array([width, 5]))
    assert K == max(1, int(np.ceil(np.log2(width + 1))))

    def steps(key):
        l, h, n = 0, width, 0
        while h > l:
            M = (l + h) >> 1
            l, h = (l, M) if M >= key else (M + 1, h)
            n += 1
        return n
    need = max(steps(k) for k in range(-1, width + 2))
    assert need <= K and (need == K or width == 0)


def _column_index(column, sa, S):
    """An index on ``["cpu"] * S`` over an arbitrary key column: rank M's
    SA word ``sa[M]``, position p's token ``column[p]``, so that the keys
    need not be sorted over any interval."""
    sl = tshx.rank_token_slices(np.asarray(column, np.int32),
                                np.asarray(sa, np.int32), len(sa), S, 5, 7)

    def put(rows):
        return [torch.from_numpy(np.array(r, np.int32)) for r in rows]
    cpu = torch.device("cpu")
    return tshx.ShardedGrammarIndex(
        S=S, reflen=len(sa), ref_glen=len(column), rlp_glen=0, tgt_glen=0,
        B=sl["B"], BR=sl["BR"], BH=5, device=cpu, sa_l=put(sl["sa_l"]),
        ref_l=put(sl["ref_l"]), rlp_l=None, lrt_l=None,
        src_off=sl["src_off"], tgt_off=None,
        rmeta=sl["rmeta"].astype(np.int32),
        smeta=sl["smeta"].astype(np.int32), devices=[cpu] * S, listed=True)


def _lb(column, sa, l, h, key, depth, steps=None):
    """JAX's ``lb`` on one lane, its reads summed over the shards as the
    psum gives them (0 at a rank or position no shard owns): ``steps``
    bisection steps, or to its end -> (l, h)."""
    n = 0
    while h > l and (steps is None or n < steps):
        M = (l + h) >> 1
        p = (int(sa[M]) if 0 <= M < len(sa) else 0) + depth
        t = int(column[p]) if 0 <= p < len(column) else 0
        l, h = (l, M) if t >= key else (M + 1, h)
        n += 1
    return l, h


def _column(rng, N):
    """An N-rank index's arbitrary key column (values in [-50, 50), not
    sorted) and SA words (positions in and past the column)."""
    return rng.integers(-50, 50, N + 40), rng.integers(0, N + 60, N)


def _column_lanes(rng, N, n, widths):
    """Lanes over an N-rank column: intervals of the given widths anywhere,
    a few off each end of the SA and one inverted; query keys below,
    inside and above the column's values, and lanes past their query's
    end (key -1)."""
    w = rng.choice(widths, n)
    lo = rng.integers(-3, N + 3, n)
    lo[:2], lo[2:4] = -(int(w.max()) // 2) - 2, N - 2
    hi = lo + w
    hi[4] = lo[4] - 2
    qtok = np.concatenate([rng.choice([-60, 60], 40),
                           rng.integers(-50, 50, 40)]).astype(np.int32)
    toks = rng.integers(0, 60, n).astype(np.int32)
    sls = rng.integers(0, 20, n).astype(np.int32)
    sls[:n // 8] = 0
    return qtok, toks, sls, lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("S", (1, 3))
@pytest.mark.parametrize("widths", [tuple(range(8)), tuple(range(8, 64)),
                                    tuple(range(64, 601, 3))])
def test_tree_step_is_five_lb_steps(S, widths):
    """On an arbitrary (non-monotone) int32 key column, every tree step of
    B2s and B2t's plain versions over S shards (their parts summed) moves
    each lane's [l, h) exactly as ``TREE_LEVELS`` steps of ``lb`` do: a
    level's first lower bound (key qt) over two steps, then its second (key
    qt + 1) from the first's result; ups, downs and the new [lo, hi) are
    ``lb``'s, and every shard's copy of the lanes agrees."""
    rng = np.random.default_rng(10 * S + widths[0])
    N, n, d0, R = 700, 64, 2, 2          # two steps a bound: K <= 10
    column, sa = _column(rng, N)
    t = _column_index(column, sa, S)
    qtok, toks, sls, lo, hi = _column_lanes(rng, N, n, widths)
    assert tshx.round_steps(lo, hi) <= R * tshx.TREE_LEVELS
    key = np.where(d0 < sls, qtok[toks + d0], -1)
    want = {g: [] for g in range(1, 5)}
    for i in range(n):
        first = _lb(column, sa, lo[i], hi[i], key[i], d0, 5)
        up = _lb(column, sa, lo[i], hi[i], key[i], d0)[0]
        assert _lb(column, sa, lo[i], hi[i], key[i], d0, 10)[0] == up
        second = _lb(column, sa, up, hi[i], key[i] + 1, d0, 5)
        down = _lb(column, sa, up, hi[i], key[i] + 1, d0)[0]
        want[1].append((lo[i], hi[i]) + first)
        want[2].append((lo[i], hi[i], up, hi[i]))
        want[3].append((lo[i], hi[i]) + second)
        want[4].append((up, down))
    q, tk, sl = (torch.from_numpy(x) for x in (qtok, toks, sls))
    st = [torch.from_numpy(np.stack([lo, hi, lo, hi])) for _ in range(S)]
    ups = [torch.zeros((n, 1), dtype=torch.int32) for _ in range(S)]
    downs = [torch.zeros((n, 1), dtype=torch.int32) for _ in range(S)]
    tok = torch.zeros((n, tshx.TREE_NODES), dtype=torch.int32)
    for g in range(5):
        parts = [tshx.refine_step_plain(
            t.sa_l[s], *(int(x) for x in t.rmeta[s]), q, tk, sl, st[s],
            ups[s], downs[s], tok, g, R, d0, 1) for s in range(S)]
        for s in range(S):
            assert torch.equal(st[s], st[0])
            assert torch.equal(ups[s], ups[0])
            assert torch.equal(downs[s], downs[0])
        if g == 4:
            up, down = np.array(want[4]).T
            np.testing.assert_array_equal(ups[0][:, 0].numpy(), up)
            np.testing.assert_array_equal(downs[0][:, 0].numpy(), down - 1)
            np.testing.assert_array_equal(st[0][:2].numpy(), [up, down])
            assert parts[0] is None
            break
        if g:
            np.testing.assert_array_equal(st[0].numpy().T, want[g])
        if g == 2:
            np.testing.assert_array_equal(ups[0][:, 0].numpy(),
                                          np.array(want[2])[:, 2])
        tok = sum(tshx.token_partial_plain(
            t.ref_l[s], *(int(x) for x in t.smeta[s]), st[s], sum(parts),
            d0, 1) for s in range(S))


@pytest.mark.parametrize("S", (1, 3))
@pytest.mark.parametrize("d0,depths", [(0, 1), (3, 4), (7, 16)])
def test_single_row_resolve_is_lb(S, d0, depths):
    """A dispatch of intervals at most one row wide (empty ones, inverted
    ones and rows off both ends of the SA among them) over an arbitrary key
    column takes the single-row plan, and its ups and downs equal ``lb``'s
    depth by depth, lanes past their query's end included."""
    rng = np.random.default_rng(100 * S + 10 * d0 + depths)
    N, n = 300, 96
    column, sa = _column(rng, N)
    qtok, toks, sls, lo, hi = _column_lanes(rng, N, n, (0, 1))
    lo[0], hi[0], lo[1], hi[1] = -1, 0, N, N + 1
    assert tshx.round_plan(lo, hi, depths) == (0, 1)
    got = tshx.refine_round(_column_index(column, sa, S),
                            torch.from_numpy(qtok), toks, sls, lo, hi, d0,
                            depths)
    for i in range(n):
        l, h = int(lo[i]), int(hi[i])
        for c in range(depths):
            d = d0 + c
            key = int(qtok[toks[i] + d]) if d < sls[i] else -1
            nlo = _lb(column, sa, l, h, key, d)[0]
            nhi = _lb(column, sa, nlo, h, key + 1, d)[0]
            assert (int(got[0][i, c]), int(got[1][i, c])) == (nlo, nhi - 1)
            l, h = nlo, nhi
        assert (int(got[2][i]), int(got[3][i])) == (l, h)


@pytest.mark.parametrize("width", [0, 1, 2, 3, 31, 32, 33, 600, 1024])
@pytest.mark.parametrize("depths", [1, 4, 16])
def test_round_plan_steps_and_launches(width, depths, monkeypatch):
    """A dispatch takes T = 2 depths ceil(K / TREE_LEVELS) steps (K =
    ``round_steps``), or one where its widest interval is at most one row;
    ``refine_round`` calls B2s T + 1 times on each shard and B2t T
    times."""
    lo = np.array([0, 5, 9], np.int32)
    hi = lo + np.array([width, min(width, 1), 0], np.int32)
    R, T = tshx.round_plan(lo, hi, depths)
    K = tshx.round_steps(lo, hi)
    if width <= 1:
        assert (R, T) == (0, 1)
    else:
        assert R == -(-K // tshx.TREE_LEVELS) and T == 2 * depths * R
    calls = {"B2s": [], "B2t": []}

    def spy(k, real, shard_of):
        def run(*args):
            calls[k].append(shard_of(args))
            return real(*args)
        return run
    column, sa = _column(np.random.default_rng(width), 1100)
    t = _column_index(column, sa, 3)
    monkeypatch.setattr(tshx, "refine_step", spy(
        "B2s", tshx.refine_step, lambda a: int(a[1])))
    monkeypatch.setattr(tshx, "token_partial", spy(
        "B2t", tshx.token_partial, lambda a: int(a[1])))
    tshx.refine_round(t, torch.zeros(64, dtype=torch.int32),
                      np.zeros(3, np.int32), np.full(3, 20, np.int32), lo,
                      hi, 0, depths)
    starts = [int(x) for x in t.rmeta[:, 0]]
    soffs = [int(x) for x in t.smeta[:, 0]]
    assert calls["B2s"] == starts * (T + 1)
    assert calls["B2t"] == soffs * T


@pytest.mark.parametrize("S", (1, 3, 8))
def test_single_row_round_equals_refine_chunk(world, S):
    """A (d0, depths) = (7, 16) dispatch whose every interval is at most one
    row, a rank off each end of the SA and empty lanes among them: the
    single-row plan of B2s and B2t's plain versions over ``["cpu"] * S``
    against ``_refine_chunk`` on the JAX mesh of S devices."""
    w = world
    j = _jsidx(w, S)
    t = _carried(w, S, ["cpu"] * S)
    reflen = t.reflen
    rng = np.random.default_rng(70 + S)
    n = 80
    qtok = np.asarray(w["jqs"].padded_tokens())
    toks = rng.integers(0, w["jqs"].totaltokens, n).astype(np.int32)
    sls = rng.integers(1, 24, n).astype(np.int32)
    lo = rng.integers(0, reflen, n).astype(np.int32)
    hi = (lo + rng.integers(0, 2, n)).astype(np.int32)
    lo[:4] = [-1, reflen, -3, reflen - 1]
    hi[:4] = [0, reflen + 1, -3, reflen]
    assert tshx.round_plan(lo, hi, 16) == (0, 1)
    want = jshx._refine_chunk(
        j.sa_l, j.ref_l, j.rmeta, j.smeta, jnp.asarray(qtok),
        jnp.asarray(toks), jnp.asarray(sls), jnp.asarray(lo),
        jnp.asarray(hi), jnp.int32(7), mesh=j.mesh, depths=16)
    got = tshx.refine_round(t, torch.from_numpy(qtok), toks, sls, lo, hi, 7,
                            16)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("S", (1, 3, 8))
def test_round_form_passes_equal_refine_passes(world, S):
    """The sharded passes over the index on ``["cpu"] * S`` (the round
    form) against the replicated refinement and the JAX sharded passes;
    B2g by owner against the host SA."""
    w = world
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, ["cpu"] * S)
    assert t.listed
    p1, p2 = tshx.sharded_passes(t, w["tqs"])
    r1, r2 = tpasses.refine_passes(w["tidx"], w["tqs"])
    jp1, jp2 = jshx.sharded_passes(_jsidx(w, S), w["jqs"])
    for ref1, ref2 in ((r1, r2), (jp1, jp2)):
        for f in ("up", "down", "longestmatch"):
            np.testing.assert_array_equal(getattr(p1, f), getattr(ref1, f))
        for f in ("connectoffset", "up", "down"):
            np.testing.assert_array_equal(getattr(p2, f), getattr(ref2, f))
    rows = np.concatenate([np.arange(t.reflen), [-3, t.reflen,
                                                 t.BR * S + 5]])
    got = tshx.gather_sa(t, rows)
    np.testing.assert_array_equal(got[:t.reflen], np.asarray(w["tsa"].sa))
    np.testing.assert_array_equal(got[t.reflen:], 0)


@pytest.mark.parametrize("S", SHARDS)
def test_plain_b2r_equals_refine_chunk(world, S):
    """B2r's plain version against ``_refine_chunk``, with intervals
    that run off both ends of the SA (unowned ranks read 0)."""
    w = world
    j = w["jsidx"][S]
    t = _carried(w, S)
    reflen = t.reflen
    rng = np.random.default_rng(S)
    n = 120
    qtok = np.asarray(w["jqs"].padded_tokens())
    toks = rng.integers(0, w["jqs"].totaltokens, n).astype(np.int32)
    sls = rng.integers(1, 8, n).astype(np.int32)
    lo = rng.integers(0, reflen, n).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, n), reflen).astype(np.int32)
    lo[:6], hi[:6] = -7, rng.integers(0, 30, 6)          # off the front
    lo[6:12] = reflen - 5
    hi[6:12] = reflen + rng.integers(1, 40, 6)           # off the back
    for d0, depths in ((0, 4), (3, 16)):
        want = jshx._refine_chunk(
            j.sa_l, j.ref_l, j.rmeta, j.smeta, jnp.asarray(qtok),
            jnp.asarray(toks), jnp.asarray(sls), jnp.asarray(lo),
            jnp.asarray(hi), jnp.int32(d0), mesh=j.mesh, depths=depths)
        got = tshx.refine_sharded(t, *(torch.from_numpy(x) for x in (
            qtok, toks, sls, lo, hi)), d0, depths)
        for g, wv in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("S", SHARDS)
def test_plain_b2g_equals_gather_sa_chunk(world, S):
    """B2g's plain version against ``_gather_sa_chunk``; ranks no shard
    owns (before 0, at and past reflen) give 0."""
    w = world
    j = w["jsidx"][S]
    t = _carried(w, S)
    rng = np.random.default_rng(10 + S)
    rows = np.concatenate([rng.integers(0, t.reflen, 300),
                           [-3, -1, t.reflen, t.reflen + 1,
                            t.BR * S + 5]]).astype(np.int32)
    want = np.asarray(jshx._gather_sa_chunk(j.sa_l, j.rmeta,
                                            jnp.asarray(rows), mesh=j.mesh))
    got = tshx.gather_sa_sharded(t, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-5:], 0)
    np.testing.assert_array_equal(got[:300],
                                  np.asarray(w["tsa"].sa)[rows[:300]])


def _shard_positions(rng, t, s, n):
    """Corpus positions owned by shard s: random ones and the first and last
    MRS of its range, next to the halo edges."""
    lo, hi = int(t.smeta[s, 1]), int(min(t.smeta[s, 2], t.reflen))
    edge = np.concatenate([np.arange(lo, min(lo + MRS, hi)),
                           np.arange(max(hi - MRS, lo), hi)])
    return np.concatenate([edge, rng.integers(lo, hi, n)]).astype(np.int32)


KERNELS = ("B3f", "B3b", "B3p", "B3t", "B3c", "A4f", "A4b", "A7", "A8",
           "B3f-nogap", "B3b-nogap")


@pytest.mark.parametrize("shard", ["first", "middle", "last"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_shard_view_kernels_equal_jax(world, kernel, shard):
    """Each per-item kernel on one shard's views against its JAX
    function on ``shard_arrays(s)`` of the 8-shard index.  The scans and the
    verification compare against query tokens read from the corpus itself
    (``qtok`` = the padded corpus), so that moves match and the gap check
    and the halos decide; some verification tokens are shifted to mismatch.
    Query positions are >= 0, as the engines give them (a negative index
    would wrap in JAX).  B3f and B3b also without the gap check (``nogap``:
    the plain version's candidate masks against ``do_gap=False``)."""
    w = world
    S = 8
    j = w["jsidx"][S]
    t = _carried(w, S)
    # the last shard that owns corpus tokens (on the toy corpus the 8th
    # owns only the padding past the corpus end)
    last = int(np.flatnonzero(t.smeta[:, 1] < t.reflen)[-1])
    s = {"first": 0, "middle": last // 2, "last": last}[shard]
    jref, jrlp, jlrt, offs = j.shard_arrays(s)
    views = t.shard_arrays(s)
    rng = np.random.default_rng(3 * KERNELS.index(kernel) + s)
    pos = _shard_positions(rng, t, s, 300)
    n = len(pos)
    qtok = np.array(w["jidx"].refstr_padded)
    tq = torch.from_numpy(qtok)

    def T(*cols):
        return [torch.from_numpy(np.asarray(c, np.int32)) for c in cols]

    def J(*cols):
        return [jnp.asarray(np.asarray(c, np.int32)) for c in cols]

    sl = rng.integers(1, 4, n)
    el = rng.integers(1, 4, n)
    m = rng.integers(0, 4, n)
    if kernel.startswith(("B3f", "B3b")):
        fwd = kernel.startswith("B3f")
        gap = not kernel.endswith("nogap")
        qpos = pos + sl + MGS + m if fwd \
            else np.maximum(pos - MGS - m - sl, 0)   # query positions >= 0
        (want,) = (jlk._fwd_batch if fwd else jlk._bwd_batch)(
            jref, jrlp, jlrt, jnp.asarray(qtok), *J(pos, sl, el, qpos), offs,
            MRS, MGS, do_gap=gap)
        if gap:
            got = [(tlk.fwd_items if fwd else tlk.bwd_items)(
                *views, tq, *T(pos, sl, el, qpos), MRS, MGS)]
        else:
            got = [tlk.scan_items_plain(*views, tq, *T(pos, sl, el, qpos),
                                        MRS, MGS, fwd, gap=False)]
        want = [want]
    elif kernel == "B3p":
        plen = rng.integers(1, 9, n)
        tok = np.maximum(pos + 1 - sl + (rng.random(n) < 0.2), 0)
        stok = pos + plen
        (want,) = jlk._pcs_batch(jref, jnp.asarray(qtok),
                                 *J(pos, plen, sl, el, tok, stok), offs, MRS)
        got = [tlk.pcs_items(views[0], tq, *T(pos, plen, sl, el, tok, stok),
                             MRS)]
        want = [np.asarray(want).astype(np.int32)]
    elif kernel == "B3t":
        plen = rng.integers(1, 9, n)
        want = jlk._two_batch(jref, jrlp, jlrt, *J(pos, plen), offs, MRS,
                              MGS)
        got = list(tlk.two_items(*views, *T(pos, plen), MRS, MGS))
    elif kernel == "B3c":
        lm = rng.integers(1, 6, n)
        want = jdev._contig_batch_pos(jref, jrlp, jlrt, *J(pos, lm), offs,
                                      MRS, MSYM)
        got = list(tdev.contig_pos(*views, *T(pos, lm), MRS, MSYM))
    elif kernel in ("A4f", "A4b"):
        fwd = kernel == "A4f"
        want = [np.asarray(jpcx._gc_batch(jrlp, jlrt, *J(pos), offs, MRS,
                                          MGS, fwd)).view(np.int32)]
        got = [tpcx.gap_check(views[1], views[2], *T(pos), MRS, MGS, fwd)]
    elif kernel == "A7":
        fe = sl + el + MGS + m
        want = jdev._onegap_batch(jref, jrlp, jlrt, *J(pos, fe, sl, el), offs,
                                  MRS, MSYM)
        got = list(tdev.onegap(*views, *T(pos, fe, sl, el), MRS, MSYM))
    else:
        cl = rng.integers(1, 3, n)
        fe = sl + el + MGS + m
        se = fe + 1 + MGS + cl + rng.integers(0, 3, n)
        want = jdev._twogap_batch(jref, jrlp, jlrt, *J(pos, fe, se, sl, el, cl),
                                  offs, MRS)
        got = list(tdev.twogap(*views, *T(pos, fe, se, sl, el, cl), MRS))
    assert len(got) == len(want)
    nonzero = False
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
        nonzero |= bool((g != 0).any())
    assert nonzero


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_passes_equal_jax_and_refine_passes(world, S):
    """The sharded passes against the JAX package's and against the
    port's refinement on the replicated index."""
    w = world
    jp1, jp2 = jshx.sharded_passes(w["jsidx"][S], w["jqs"])
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    p1, p2 = tshx.sharded_passes(t, w["tqs"])
    r1, r2 = tpasses.refine_passes(w["tidx"], w["tqs"])
    for ref1, ref2 in ((jp1, jp2), (r1, r2)):
        for f in ("up", "down", "longestmatch"):
            np.testing.assert_array_equal(getattr(p1, f), getattr(ref1, f))
        for f in ("connectoffset", "up", "down"):
            np.testing.assert_array_equal(getattr(p2, f), getattr(ref2, f))
    assert p1.longestmatch.max() > 1


def _premise_world(corpus, world, S):
    """(the port's sharded index of S shards, its replicated index, its
    queries) over the toy corpus or a small-vocabulary one with deep
    intervals."""
    if corpus == "toy":
        w = world
        src, tgt, sa, al = w["tsrc"], w["ttgt"], w["tsa"], w["tal"]
        tidx, tqs, cfg = w["tidx"], w["tqs"], w["tcfg"]
    else:
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=3, seed=11)
        q = make_big_queries(f, 6, seed=3)
        f, e = f.split("\n"), e.split("\n")
        q += f[:2]
        cfg = _cfgs()[1]
        src, tgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
        sa, al = tsab.build_index(src.str_), tcp.load_alignment_fast(a, src,
                                                                      tgt)
        tidx = tic.build_index(src, tgt, sa, al,
                               tcp.load_lex_table(lex_t, src.vocab,
                                                  tgt.vocab), cfg, "cpu")
        tqs = tcp.load_queries(q, src.vocab)
    return (tshx.build_sharded_index(src, tgt, sa, al, cfg, S, "cpu"), tidx,
            tqs)


@pytest.mark.parametrize("corpus", ["toy", "deep"])
@pytest.mark.parametrize("S", [1, 3, 4])
def test_shard_reads_keep_the_keys_sorted(world, corpus, S):
    """The premise of kernel B2r's 16-ary search (csrc/refine.cuh): over
    every interval that ``sharded_passes`` searches, at every depth, the key
    column read through the shards, ``_g_ref(_g_sa(M) + depth)``, is
    non-decreasing and equals the replicated key ``refstr[sa[M] + depth]``
    (every row and position read lies inside the SA and the corpus, so one
    shard owns it).  The lanes run one depth at a time through
    ``refine_sharded`` (the plain version here), and the passes must come
    out as the replicated refinement's."""
    t, tidx, tqs = _premise_world(corpus, world, S)
    qtok = t.query_tokens(tqs)
    seen = {"intervals": 0, "rows": 0, "rows_straddle": 0}

    def dispatch(toks, sls, lo, hi, depth, dchunk):
        toks, sls, l, h = (torch.from_numpy(x) for x in (toks, sls, lo, hi))
        ups, downs = [], []
        for c in range(dchunk):
            d = depth + c
            live = h > l
            lens = (h - l)[live].long()
            lane = torch.repeat_interleave(torch.arange(len(lens)), lens)
            first = torch.cumsum(lens, 0) - lens
            M = (l[live].long()[lane] + torch.arange(int(lens.sum()))
                 - first[lane]).int()
            keys = tshx._g_ref(t, tshx._g_sa(t, M) + d)
            assert torch.equal(keys, take(tidx.refstr_padded,
                                          take(tidx.sa, M) + d)), (S, d)
            same = lane[1:] == lane[:-1]
            assert bool((keys[1:] >= keys[:-1])[same].all()), (S, d)
            seen["intervals"] += int(live.sum())
            seen["rows"] += int(lens.sum())
            for b in range(1, S):
                seen["rows_straddle"] += int(
                    (live & (l < b * t.BR) & (h > b * t.BR)).sum())
            u, dn, l, h = tshx.refine_sharded(t, qtok, toks, sls, l, h, d, 1)
            ups.append(u)
            downs.append(dn)
        return (torch.cat(ups, 1).numpy(), torch.cat(downs, 1).numpy(),
                l.numpy(), h.numpy())
    got = tpasses.drive_refinement(
        tqs, t.reflen, (t.seed_lo1, t.seed_hi1, t.seed_pk, t.seed_pk3),
        dispatch)
    want = tpasses.refine_passes(tidx, tqs)
    for g, wv in zip(got, want):
        for f in dataclasses.fields(wv):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(wv, f.name), err_msg=f.name)
    assert seen["intervals"] > 0 and seen["rows"] > seen["intervals"]
    if corpus == "deep" and S > 1:   # intervals across a rank-shard boundary
        assert seen["rows_straddle"] > 0


def _div_magic(d):
    """csrc/sharded.cu ``div_magic``: (m, l) with l = ceil(log2 d), m =
    floor(2^32 (2^l - d) / d) + 1, as unsigned 32-bit."""
    l = (d - 1).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


@pytest.mark.parametrize("seed", [0, 1])
def test_b2r_owner_division_is_exact(seed):
    """Kernel B2r finds a read's owner shard as x / BR (ranks) and x / B
    (positions) by a multiply and a shift, ``(umulhi(m, x) + x) >> l``: it
    must equal x // d for 0 <= x < 2^31 and 1 <= d < 2^31 (m fits 32 bits,
    and t + x, with t < x, does not overflow them).  This checks the
    formula, through a Python copy of ``div_magic`` (``_div_magic``); the
    compiled one is held to the plain versions on the card by
    ``chip_smoke.py`` (B2r and B2g, on 1, 3 and 4 shards)."""
    rng = np.random.default_rng(seed)
    ds = np.concatenate([np.arange(1, 2049), [2**31 - 1, 2**30, 2**30 + 1],
                         rng.integers(1, 2**31, 3000)])
    for d in ds.tolist():
        m, l = _div_magic(d)
        assert 0 < m < 2**32
        x = np.concatenate([[0, 1, d - 1, d, 2**31 - 1],
                            rng.integers(0, 2**31, 64),
                            np.arange(1, 5) * d - 1, np.arange(1, 5) * d])
        x = x[(x >= 0) & (x < 2**31)].astype(np.uint64)
        t = (x * np.uint64(m)) >> np.uint64(32)
        np.testing.assert_array_equal((t + x) >> np.uint64(l),
                                      x // np.uint64(d))


@pytest.mark.parametrize("S,fits", [(1, True), (4, True), (1365, True),
                                    (1366, False), (5000, False)])
def test_b2r_refuses_shard_rows_past_shared_memory(S, fits):
    """Kernel B2r holds every shard's row (two slice pointers, rmeta's 2
    words and smeta's 3: 36 bytes) in a block's 48 KiB of shared memory; the
    wrapper refuses a shard count whose rows do not fit, naming B2r."""
    assert tshx.B2R_SHARD_ROW_BYTES == 36
    if fits:
        tshx.check_b2r_shards(S)
    else:
        with pytest.raises(ValueError, match="B2r"):
            tshx.check_b2r_shards(S)


_JAX_RUNS = {}


def _jax_run(data, S):
    """The JAX package's pipeline, replicated (S = 0) or sharded, once per S
    in this module."""
    if S not in _JAX_RUNS:
        _JAX_RUNS[S] = jpl.run_pipeline(*data, _cfgs()[0], sa_shards=S)
    return _JAX_RUNS[S]


@pytest.fixture(scope="module")
def port_replicated(data):
    return tpl.run_pipeline(*data, _cfgs()[1], device="cpu")


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_pipeline_equals_jax_and_replicated(data, port_replicated,
                                                    S):
    """Lines and counters against the JAX sharded run and the port's
    replicated run."""
    got = tpl.run_pipeline(*data, _cfgs()[1], device="cpu", sa_shards=S)
    want = _jax_run(data, S)
    assert isinstance(got.index, tshx.ShardedGrammarIndex)
    assert got.index.S == S
    assert got.per_query_lines == want.per_query_lines
    assert got.per_query_lines == port_replicated.per_query_lines
    assert {k: got.counters[k] for k in want.counters} == want.counters
    assert got.counters == port_replicated.counters
    assert got.counters["total_lines"] > 100
    assert got.counters["twogap_sa"] > 0 and got.counters["onegap_sa"] > 0


@pytest.mark.parametrize("S", SHARDS)
def test_pipeline_on_a_device_list_equals_jax(data, port_replicated, S):
    """``run_pipeline(sa_shards=["cpu"] * S)``, the index on a device list
    (the counterpart of ``__graft_entry__.dryrun_multichip(8)``): lines and
    counters against the JAX sharded run over S devices and the port's
    replicated run."""
    got = tpl.run_pipeline(*data, _cfgs()[1], device="cpu",
                           sa_shards=["cpu"] * S)
    want = _jax_run(data, S)
    assert got.index.listed and got.index.S == S
    assert got.per_query_lines == want.per_query_lines
    assert got.per_query_lines == port_replicated.per_query_lines
    assert {k: got.counters[k] for k in want.counters} == want.counters


def test_device_list_pipeline_gives_the_bench_golden():
    """The bench's ``small`` corpus over ``["cpu"] * 3`` hashes to
    tests/golden_bench_hashes.json's ``bench_small``."""
    root = pathlib.Path(__file__).parent.parent
    sys.path.insert(0, str(root))
    import bench
    golden = json.loads((root / "tests" /
                         "golden_bench_hashes.json").read_text())
    res = tpl.run_pipeline(*bench.build_corpus("small",
                                               *bench.SIZES["small"]),
                           ExtractorConfig(), device="cpu",
                           sa_shards=["cpu"] * 3)
    assert res.index.listed
    assert bench.grammar_hash(res.per_query_lines) == golden["bench_small"]


def test_sharded_build_never_replicates(data, world, monkeypatch):
    """With the replicated index build made to fail, the sharded build and
    pipeline run, and the precompute equals the replicated one."""
    def boom(*args, **kwargs):
        raise AssertionError("replicated device index built in sharded mode")
    monkeypatch.setattr(tic, "build_index", boom)
    monkeypatch.setattr(tpl.ic, "build_index", boom)
    f, e, a, lex, _ = data
    art, index, _, _ = tpl.build_artifact(f, e, a, lex, _cfgs()[1],
                                          device="cpu", sa_shards=8)
    assert isinstance(index, tshx.ShardedGrammarIndex)
    w = world
    want = tpcx.precompute(_engine(w), w["tsrc"], w["tsa"], w["tcfg"])
    for fld in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(art.precomp, fld.name),
                                      getattr(want, fld.name),
                                      err_msg=fld.name)
    assert want.count > 0
    res = tpl.run_pipeline(*data, _cfgs()[1], device="cpu", sa_shards=8)
    assert res.counters["total_lines"] > 0


@pytest.mark.parametrize("S", SHARDS)
def test_memory_per_device_equals_jax(world, S):
    """The per-shard byte accounting of both packages."""
    w = world
    t = tshx.build_sharded_index(w["tsrc"], w["ttgt"], w["tsa"], w["tal"],
                                 w["tcfg"], S, "cpu")
    want = w["jsidx"][S].memory_per_device()
    assert t.memory_per_device() == {k: int(v) for k, v in want.items()}


@pytest.mark.parametrize("jax_tables", ["dense", "sorted"])
def test_host_maxlex_equals_jax_host_backend(world, monkeypatch, jax_tables):
    """The host backend on a HostLexIndex (one path: ``np.searchsorted``
    over the packed keys) against the JAX package's
    ``compute_maxlex_tpu(..., use_device=False)``, float32 bit for bit, with
    the JAX side on its dense tables and (its limit forced to 0) on its
    sorted-key search."""
    if jax_tables == "sorted":
        monkeypatch.setattr(jml, "DENSE_LIMIT", 0)
    w = world
    blocks = generate_blocks(w["tsa"], w["tqs"],
                             *tpasses.refine_passes(w["tidx"], w["tqs"]))
    contig, _, _ = tdev.extract_contiguous(_engine(w), blocks, w["tcfg"])
    rules, tasks = tlx.fast_create_lexicon_contig(contig, w["tsrc"],
                                                  w["ttgt"], blocks,
                                                  w["tcfg"])
    empty = type(tasks)(**{f.name: getattr(tasks, f.name)[:0]
                           for f in dataclasses.fields(tasks)})
    all_tasks = {"onegap": empty, "twogap": empty, "contig": tasks}
    got_rules, want_rules = copy.deepcopy(rules), copy.deepcopy(rules)
    tml.compute_maxlex(all_tasks, tic.build_host_lex_index(w["ttgt"],
                                                          w["tlex"]),
                       None, None, got_rules, w["tcfg"])
    jml.compute_maxlex_tpu(all_tasks, w["jidx"], None, None, want_rules,
                           w["jcfg"], use_device=False)
    assert len(got_rules) > 100
    for f in ("max_lex_fge", "max_lex_egf"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got_rules, f), np.float32).view(np.int32),
            np.asarray(getattr(want_rules, f), np.float32).view(np.int32))


def _cli_args(d, out, extra):
    return extra + [str(d / "corpus.f"), str(d / "query.f"),
                    str(d / "corpus.e"), str(d / "corpus.a"),
                    str(d / "lex.txt"), str(out)]


def test_cli_sa_shards(toy_fixture, data, tmp_path, monkeypatch):
    """``--sa-shards 8`` and ``--sa-shards auto`` write the files of the
    JAX CLI with the same flag and of the port's run without it; ``auto``
    runs replicated where the device has no budget (the CPU without
    ``CGX_DEVICE_MEM_MB``)."""
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    assert cli.main(_cli_args(toy_fixture, tmp_path / "r",
                              ["--device", "cpu"])) == 0
    rep = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert len(rep) == 8
    for out, extra in (("s", ["--sa-shards", "8"]),
                       ("a", ["--sa-shards", "auto"])):
        assert cli.main(_cli_args(toy_fixture, tmp_path / out,
                                  ["--device", "cpu"] + extra)) == 0
        assert jcli.main(_cli_args(toy_fixture, tmp_path / f"j{out}",
                                   extra)) == 0
        for got in (out, f"j{out}"):
            assert rep == sorted(p.name for p in (tmp_path / got).iterdir())
            for name in rep:
                assert (tmp_path / "r" / name).read_bytes() == \
                    (tmp_path / got / name).read_bytes(), (got, name)
    res = tpl.run_pipeline(*data, _cfgs()[1], device="cpu",
                           sa_shards="auto")
    assert not isinstance(res.index, tshx.ShardedGrammarIndex)


def test_lcp_passes_with_sa_shards_raises(data):
    """The sharded index keeps no LCP tree on the device."""
    with pytest.raises(ValueError, match="lcp_passes"):
        tpl.run_pipeline(*data, _cfgs()[1], device="cpu", lcp_passes=True,
                         sa_shards=4)
