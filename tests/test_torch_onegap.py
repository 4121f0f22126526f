"""One-gap patterns in the port: the enumeration and distinct scan, kernel A7's
plain version against the JAX ``_onegap_batch`` on all six output columns
over several span and symbol limits, the premise of A7's kernel (each growth
side decided by its first event, the two sides independently), and
``extract_onegap`` against the JAX package's ``extract_onegap_tpu``, bit
for bit."""

import dataclasses
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.extract import device as jdev  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.oracle import search as ose  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import enumerate_fast as jef  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.extract import device as tdev  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import enumerate_fast as tef  # noqa: E402
from cgx_tpu_torch.search import lookup as tlk  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402
from cgx_tpu_torch.types import Pass1Result  # noqa: E402
from cgx_tpu_torch.utils.views import OffsetView  # noqa: E402


def _engine(w):
    """The replicated dispatch engine over the world's port index."""
    return ReplicatedEngine(w["tidx"], w["tcfg"])


def _inputs(name, request):
    if name == "hard":
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 6, seed=3))
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module", params=["toy", "real", "hard"])
def world(request):
    """Both packages run one corpus through lookup1, with one configuration
    (the default) on both sides."""
    f, e, a, lex_t, q = _inputs(request.param, request)
    jcfg, tcfg = JaxConfig(), ExtractorConfig()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jsa = jsab.build_index(jsrc.str_)
    jidx = jic.build_index(jsrc, jtgt, jsa,
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           jcfg)
    jqs = jcp.load_queries(q, jsrc.vocab)
    jp1, jp2 = jpasses.refine_passes(jidx, jqs)
    jenum, jsearch = jef.fast_sort_and_dedup_onegap(
        jef.fast_one_gap_enumeration(jqs, jp1, jcfg), jqs)
    jpc = jpcx.precompute_tpu(jidx, jsrc, jsa, jcfg)
    jog = jlk.one_gap_lookup_tpu(jidx, np.asarray(jsa.sa), jqs, jp1, jp2,
                                 jsearch, jpc, jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tsa = tsab.build_index(tsrc.str_)
    tidx = tic.build_index(tsrc, ttgt, tsa,
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    tqs = tcp.load_queries(q, tsrc.vocab)
    tp1, tp2 = tpasses.refine_passes(tidx, tqs)
    tenum, tsearch = tef.fast_sort_and_dedup_onegap(
        tef.fast_one_gap_enumeration(tqs, tp1, tcfg), tqs)
    teng = ReplicatedEngine(tidx, tcfg)
    tpc = tpcx.precompute(teng, tsrc, tsa, tcfg)
    tog = tlk.one_gap_lookup(teng, tqs, tp1, tp2, tsearch, tpc, tcfg)
    return dict(jcfg=jcfg, jidx=jidx, jqs=jqs, jenum=jenum, jsearch=jsearch,
                jpc=jpc, jog=jog, tcfg=tcfg, tidx=tidx, tqs=tqs, tp1=tp1,
                tenum=tenum, tsearch=tsearch, tpc=tpc, tog=tog)


def _eq(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_onegap_enumeration_equals_jax(world):
    w = world
    _eq(w["tenum"], w["jenum"])
    _eq(w["tsearch"], w["jsearch"])
    assert len(w["tsearch"].qrystart) > 0


def test_empty_onegap_enumeration_equals_oracle(world):
    """No token matches: the enumeration is empty, and the distinct table
    equals the sequential oracle's, with no import of the oracle."""
    w = world
    p1 = dataclasses.replace(
        w["tp1"], longestmatch=np.zeros_like(w["tp1"].longestmatch))
    enum = tef.fast_one_gap_enumeration(w["tqs"], p1, w["tcfg"])
    assert len(enum.qrystart) == 0
    got_enum, got = tef.fast_sort_and_dedup_onegap(enum, w["tqs"])
    want_enum, want = ose.sort_and_dedup_onegap(
        jef.fast_one_gap_enumeration(w["jqs"], p1, w["jcfg"]), w["jqs"])
    _eq(got_enum, want_enum)
    _eq(got, want)


# (mrs, msym): the default (15, 5) first; mrs 2 leaves no growth step for
# an aXb of 2 or more tokens, msym 2 and 3 no room for a grown X
SETTINGS = [(15, 5), (15, 3), (15, 2), (8, 5), (8, 3), (8, 2), (2, 5),
            (2, 3), (2, 2)]


def _a7_cols(w):
    """Every (unsampled) aXb occurrence of lookup1's result, plus random
    lanes that run into corpus and sentence edges -> (cs, first_end, sl,
    el), int32."""
    s, og, pc = w["tsearch"], w["tog"], w["tpc"]
    ids, css, fes = tdev._onegap_occurrences(s, og, pc, 0, False)
    sls = s.qrystart_len[ids].astype(np.int64)
    els = s.qryend_len[ids].astype(np.int64)
    rng = np.random.default_rng(6)
    extra = 300
    reflen = w["tidx"].reflen
    r_sl = rng.integers(1, 4, extra)
    r_el = rng.integers(1, 4, extra)
    r_fe = r_sl + r_el + rng.integers(0, 10, extra)
    r_cs = np.concatenate([rng.integers(0, 4, 20),
                           rng.integers(reflen - 20, reflen, 20),
                           rng.integers(0, reflen, extra - 40)])
    return [np.concatenate([x, y]).astype(np.int32)
            for x, y in ((css, r_cs), (fes, r_fe), (sls, r_sl), (els, r_el))]


def _a7_jax(w, mrs, msym):
    """The JAX ``_onegap_batch`` on ``_a7_cols``, six numpy columns (kept
    per world and setting)."""
    memo = w.setdefault("a7_jax", {})
    if (mrs, msym) not in memo:
        ix = w["jidx"]
        memo[(mrs, msym)] = [np.asarray(c) for c in jdev._onegap_batch(
            ix.refstr_padded, ix.rlp, ix.lr_tar,
            *(jnp.asarray(c) for c in _a7_cols(w)), ix.offs0, mrs, msym)]
    return memo[(mrs, msym)]


@pytest.mark.parametrize("mrs,msym", SETTINGS)
def test_plain_a7_equals_onegap_batch(world, mrs, msym):
    """Every (unsampled) aXb occurrence of lookup1's result, plus random
    lanes that run into corpus and sentence edges."""
    w = world
    cols = _a7_cols(w)
    want = _a7_jax(w, mrs, msym)
    t = w["tidx"]
    got = tdev.onegap(t.refstr_padded, t.rlp, t.lr_tar,
                      *(torch.from_numpy(c) for c in cols), mrs, msym)
    assert got.shape == (6, len(cols[0])) and got.dtype == torch.int32
    for col, wcol in enumerate(want):
        np.testing.assert_array_equal(got[col].numpy(), wcol,
                                      err_msg=f"column {col}")
    if mrs > 2:                           # aXb, and with msym 5 every
        for col in (1, 3, 5) if msym == 5 else (1,):      # family, emits
            assert (got[col].numpy() & 1).any(), col


def _side_tables(need, s, mrs):
    """One side's [N, IMAX] step tables from ``_onegap_body``'s record:
    has, al, spank, nxt (past the X gap check), wkill, w_ok and the
    values an emission carries (w_ts, w_te, pmin, pmax)."""
    t = {f: need[f"{s}_{f}"].numpy() for f in
         ("has", "al", "pmin", "pmax", "gap", "wts", "wte", "wok")}
    t["spank"] = t["pmax"] - t["pmin"] >= mrs
    t["nxt"] = t["has"] & t["al"] & ~t["spank"] & t["gap"]
    t["wkill"] = t["wte"] - t["wts"] >= mrs
    return t


def _coupled_loop(tabs, left, right, first_end, mrs):
    """A transcription of the JAX outer loop (cgx_tpu/extract/device.py
    :556-605) on the step tables, both sides under one ``active`` ->
    {side: (emitted, step of the emission)}."""
    n = len(first_end)
    flag = {"l": left.copy(), "r": right.copy()}
    res = {s: (np.zeros(n, bool), np.zeros(n, np.int64)) for s in "lr"}
    for i in range(1, tdev.IMAX + 1):
        i0 = i - 1
        active = (first_end + 1 + i <= mrs) & (flag["l"] | flag["r"])
        for s in "lr":
            t = tabs[s]
            proc = active & flag[s] & t["has"][:, i0]
            dead = (active & ~t["has"][:, i0]) \
                | (proc & ~t["al"][:, i0] & (i == 1)) \
                | (proc & t["spank"][:, i0])
            nxt = proc & t["nxt"][:, i0]
            wkill = nxt & t["wkill"][:, i0]
            emit = nxt & ~wkill & t["wok"][:, i0]
            res[s][0][emit] = True
            res[s][1][emit] = i0
            flag[s] = flag[s] & ~dead & ~wkill & ~emit
    return res


@pytest.mark.parametrize("mrs,msym", SETTINGS)
def test_a7_first_event_decides_each_side(world, mrs, msym):
    """Kernel A7's premise (csrc/onegap.cu): each growth side's family
    emits exactly when its first event (death or emission) among the steps
    within the span limit is an emission, with that step's values; and the
    two sides decide independently, though the JAX loop runs them under
    one ``active = ... & (left | right)``.  Held against the JAX function
    on every aXb occurrence and the random edge lanes of
    ``test_plain_a7_equals_onegap_batch``."""
    w = world
    cols = _a7_cols(w)
    want = _a7_jax(w, mrs, msym)
    t = w["tidx"]
    need: dict = {}
    tdev._onegap_body(t.refstr_padded, t.rlp, t.lr_tar,
                      *(torch.from_numpy(c) for c in cols), mrs, msym, need)
    fe = cols[1].astype(np.int64)
    n = len(fe)
    rows = np.arange(n)
    k = np.arange(tdev.IMAX)
    lim = np.minimum(mrs - fe - 1, tdev.IMAX)
    stb = need["stb"].numpy()
    tabs = {s: _side_tables(need, s, mrs) for s in "lr"}
    alive = {s: need[f"{s}_alive"].numpy() for s in "lr"}
    coupled = _coupled_loop(tabs, alive["l"], alive["r"], fe, mrs)
    for s, col in (("l", 2), ("r", 4)):
        tb = tabs[s]
        emit = tb["nxt"] & ~tb["wkill"] & tb["wok"]
        event = (k < lim[:, None]) & (
            ~tb["has"] | ((k == 0) & ~tb["al"]) | tb["spank"]
            | (tb["nxt"] & (tb["wkill"] | tb["wok"])))
        first = event.argmax(axis=1)
        v = alive[s] & event.any(axis=1) & emit[rows, first]
        got = tdev.unpack_family(want[col], want[col + 1], two_gaps=True)
        np.testing.assert_array_equal(got[0], v, err_msg=f"{s}: emits")
        assert not want[col][~v].any() and not want[col + 1][~v].any()
        x0, x1 = (got[3], got[4]) if s == "l" else (got[5], got[6])
        for name, g, e in (("ts", got[1], tb["wts"][rows, first]),
                           ("te", got[2], tb["wte"][rows, first]),
                           ("X start", x0, stb + tb["pmin"][rows, first]),
                           ("X end", x1, stb + tb["pmax"][rows, first])):
            np.testing.assert_array_equal(g[v], e[v], err_msg=f"{s}: {name}")
        # the transcription of the coupled loop gives the JAX function's
        # emissions at the first event's step
        np.testing.assert_array_equal(coupled[s][0], v)
        np.testing.assert_array_equal(coupled[s][1][v], first[v])
    # each side alone: the other side's flag false from the start changes
    # nothing on this side
    none = np.zeros(n, bool)
    alone_l = _coupled_loop(tabs, alive["l"], none, fe, mrs)["l"]
    alone_r = _coupled_loop(tabs, none, alive["r"], fe, mrs)["r"]
    for s, alone in (("l", alone_l), ("r", alone_r)):
        np.testing.assert_array_equal(alone[0], coupled[s][0])
        np.testing.assert_array_equal(alone[1], coupled[s][1])
    if mrs > 2 and msym == 5:
        assert coupled["l"][0].any() and coupled["r"][0].any()


@pytest.mark.parametrize("sample", [True, False])
def test_extract_onegap_equals_jax(world, sample):
    w = world
    jcfg = dataclasses.replace(w["jcfg"], is_sample=sample)
    tcfg = dataclasses.replace(w["tcfg"], is_sample=sample)
    want = jdev.extract_onegap_tpu(w["jidx"], w["jsearch"], w["jog"],
                                   w["jpc"], jcfg)
    got = tdev.extract_onegap(_engine(w), w["tsearch"], w["tog"], w["tpc"],
                              tcfg)
    for g, j in zip(got, want):
        _eq(g, j)
    assert len(got[0].gappy_index) > 0 and len(got[1].gappy_index) > 0


@pytest.mark.parametrize("sample", [True, False])
def test_plain_identity_views_change_nothing(world, sample, monkeypatch):
    """A7's plain version, on the inputs of the one-gap extraction's own
    call (sampled or not), gives the same words when the corpus arrays come
    as explicit identity views (offset 0, global length = local length)."""
    w = world
    calls = []
    real = tdev.onegap

    def hook(*args):
        calls.append(args)
        return real(*args)
    monkeypatch.setattr(tdev, "onegap", hook)
    tdev.extract_onegap(_engine(w), w["tsearch"], w["tog"], w["tpc"],
                        dataclasses.replace(w["tcfg"], is_sample=sample))
    (args,) = calls
    want = tdev.onegap_plain(*args)
    got = tdev.onegap_plain(*[OffsetView(a, 0, a.shape[0]) if i < 3 else a
                              for i, a in enumerate(args)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want[1] & 1).any()
