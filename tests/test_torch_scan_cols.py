"""The column-upload lookups in the port (``scan_cols``): kernels C1f/C1b,
C1p and C1t's plain versions against the JAX ``_scan_batch_cols``,
``_pcs_batch_cols`` and ``_two_batch_packed`` on random lanes that run off
both ends of the corpus, lookup1 and lookup2 through
``ReplicatedEngine(scan_cols=True)`` against the JAX engine under
``CGX_SCAN_COLS=1``, and the pipeline with ``scan_cols=True`` against the
golden grammars, bit for bit."""

import dataclasses
import hashlib
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.index import container as jic  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu.preproc import suffix_array as jsab  # noqa: E402
from cgx_tpu.search import enumerate_fast as jef  # noqa: E402
from cgx_tpu.search import lookup as jlk  # noqa: E402
from cgx_tpu.search import passes as jpasses  # noqa: E402
from cgx_tpu.search import precompute as jpcx  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.engine import ReplicatedEngine  # noqa: E402
from cgx_tpu_torch.index import container as tic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as tcp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as tsab  # noqa: E402
from cgx_tpu_torch.search import enumerate_fast as tef  # noqa: E402
from cgx_tpu_torch.search import lookup as tlk  # noqa: E402
from cgx_tpu_torch.search import passes as tpasses  # noqa: E402
from cgx_tpu_torch.search import precompute as tpcx  # noqa: E402

TESTS = pathlib.Path(__file__).parent


def _inputs(name, request):
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")),
            jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")),
            jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module", params=["toy", "real"])
def arrays(request):
    """Both packages' index arrays of one corpus."""
    f, e, a, lex_t, _ = _inputs(request.param, request)
    jcfg, tcfg = JaxConfig(), ExtractorConfig()
    jsrc, jtgt = jcp.load_source_corpus(f), jcp.load_target_corpus(e)
    jidx = jic.build_index(jsrc, jtgt, jsab.build_index(jsrc.str_),
                           jcp.load_alignment_fast(a, jsrc, jtgt),
                           jcp.load_lex_table(lex_t, jsrc.vocab, jtgt.vocab),
                           jcfg)
    tsrc, ttgt = tcp.load_source_corpus(f), tcp.load_target_corpus(e)
    tidx = tic.build_index(tsrc, ttgt, tsab.build_index(tsrc.str_),
                           tcp.load_alignment_fast(a, tsrc, ttgt),
                           tcp.load_lex_table(lex_t, tsrc.vocab, ttgt.vocab),
                           tcfg, "cpu")
    return dict(cfg=jcfg, jidx=jidx, tidx=tidx,
                refstr=np.asarray(jidx.refstr_padded))


def _positions(rng, reflen, n):
    """Corpus positions: most inside, some at and just past both ends."""
    p = rng.integers(0, reflen, n)
    p[:6] = np.arange(6)
    p[6:14] = reflen - 8 + np.arange(8)
    p[14:18] = reflen + np.arange(4) * 50
    return p


def _jax_cols(*cols):
    return [jnp.asarray(np.asarray(c, np.int32)) for c in cols]


def _torch_cols(*cols):
    return [torch.from_numpy(np.asarray(c, np.int32)) for c in cols]


@pytest.mark.parametrize(
    "fwd,mrs,do_gap",
    [(True, 15, True), (False, 15, True), (True, 8, True), (False, 8, True),
     (True, 2, True), (False, 2, True), (True, 15, False),
     (False, 15, False)],
    ids=["True", "False", "True-mrs8", "False-mrs8", "True-mrs2",
         "False-mrs2", "True-nogap", "False-nogap"])
def test_plain_c1_scan_equals_scan_batch_cols(arrays, fwd, mrs, do_gap):
    """Compared tokens read from the corpus beside each occurrence (some
    altered), so that moves match and the gap check decides; under the
    default span limit and narrower ones (at 2 no move fits a gap), and
    without the gap check (``do_gap=False``: the candidate masks, which the
    kernels gap-check alone)."""
    w, cfg = arrays, arrays["cfg"]
    mgs = cfg.min_gap_size
    assert mrs <= cfg.max_rule_span
    rng = np.random.default_rng(12 if fwd else 13)
    n = 3000
    ref = w["refstr"]
    last = len(ref) - 1
    g = _positions(rng, w["jidx"].reflen, n)
    sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
    m = rng.integers(0, 4, n)
    if fwd:
        p0 = g + sl + mgs + m
        toks = [ref[np.clip(p0 + k, 0, last)] for k in range(3)]
    else:
        p0 = g - 1 - mgs - m
        toks = [np.where(p0 - k < 0, -1, ref[np.clip(p0 - k, 0, last)])
                for k in range(3)]
    toks[1] = np.where(rng.random(n) < 0.1, toks[1] + 1, toks[1])
    cols = (g, sl, el, *toks)
    j, t = w["jidx"], w["tidx"]
    (want,) = jlk._scan_batch_cols(j.refstr_padded, j.rlp, j.lr_tar,
                                   *_jax_cols(*cols), j.offs0, mrs, mgs, fwd,
                                   do_gap=do_gap)
    if do_gap:
        got = tlk.scan_cols(t.refstr_padded, t.rlp, t.lr_tar,
                            *_torch_cols(*cols), mrs, mgs, fwd)
    else:
        got = tlk.scan_cols_plain(t.refstr_padded, t.rlp, t.lr_tar,
                                  *_torch_cols(*cols), mrs, mgs, fwd,
                                  gap=False)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a move needs sl + mgs + m + el <= mrs, so none fits under mrs 2
    assert (np.asarray(want) != 0).any() == (mrs > 2)


def _bits(words, n):
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")[:n]


def test_plain_c1p_equals_pcs_batch_cols(arrays):
    """A multiple of 32 items for the JAX function (it reshapes by 32); the
    port also takes any count, the last word's tail bits 0."""
    w, cfg = arrays, arrays["cfg"]
    rng = np.random.default_rng(14)
    n = 2048
    ref = w["refstr"]
    last = len(ref) - 1
    ps = _positions(rng, w["jidx"].reflen, n)
    plen = rng.integers(1, 8, n)
    pe = ps + plen
    sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
    toks = [ref[np.clip(ps - 1, 0, last)], ref[np.clip(ps - 2, 0, last)],
            ref[np.clip(pe + 1, 0, last)], ref[np.clip(pe + 2, 0, last)]]
    toks[0] = np.where(rng.random(n) < 0.2, toks[0] + 1, toks[0])
    cols = (ps, plen, sl, el, *toks)
    (want,) = jlk._pcs_batch_cols(w["jidx"].refstr_padded, *_jax_cols(*cols),
                                  w["jidx"].offs0, cfg.max_rule_span)
    wb = _bits(np.asarray(want, np.uint32), n)
    assert wb.any() and not wb.all()
    for k in (n, n - 5):
        got = tlk.pcs_cols(w["tidx"].refstr_padded,
                           *_torch_cols(*(c[:k] for c in cols)),
                           cfg.max_rule_span)
        assert got.dtype == torch.int32 and got.shape == ((k + 31) // 32,)
        np.testing.assert_array_equal(_bits(got.numpy(), k), wb[:k])
        assert not _bits(got.numpy(), len(got) * 32)[k:].any()


@pytest.mark.parametrize("mrs", [2, 5, 15])
def test_plain_c1p_edges_equal_pcs_batch_cols(arrays, mrs):
    """The exits of the kernels' verification body (csrc/scan.cu
    ``pcs_warp``): occurrences at the corpus start (the prefix words before
    it fail unread) and end, sl and el 1-3 (each prefix and suffix word
    needed or not), occurrence lengths that make the span budget just fit,
    just fail or leave room; against ``_pcs_batch_cols`` on 64 items."""
    w = arrays
    rng = np.random.default_rng(16 + mrs)
    n = 64
    ref = w["refstr"]
    last = len(ref) - 1
    reflen = int(w["jidx"].reflen)
    ps = _positions(rng, reflen, n)
    ps[:3] = [0, 1, 2]
    sl, el = rng.integers(1, 4, n), rng.integers(1, 4, n)
    sl[:3] = 3
    plen = np.maximum(mrs - sl - el + 1 + rng.choice([0, 0, 1, -2], n), 1)
    pe = ps + plen
    toks = [ref[np.clip(ps - 1, 0, last)], ref[np.clip(ps - 2, 0, last)],
            ref[np.clip(pe + 1, 0, last)], ref[np.clip(pe + 2, 0, last)]]
    toks[3] = np.where(rng.random(n) < 0.2, toks[3] + 1, toks[3])
    cols = (ps, plen, sl, el, *toks)
    (want,) = jlk._pcs_batch_cols(w["jidx"].refstr_padded, *_jax_cols(*cols),
                                  w["jidx"].offs0, mrs)
    wb = _bits(np.asarray(want, np.uint32), n)
    got = tlk.pcs_cols(w["tidx"].refstr_padded, *_torch_cols(*cols), mrs)
    np.testing.assert_array_equal(_bits(got.numpy(), n), wb)
    budget = plen + sl + el - 1 <= mrs
    assert (~budget).any() and (plen + sl + el - 1 == mrs).any()
    assert not wb[~budget].any() and not wb[:2].any()   # before 0
    if mrs > 2:
        assert wb.any()


def test_plain_c1t_equals_two_batch_packed(arrays):
    w, cfg = arrays, arrays["cfg"]
    rng = np.random.default_rng(15)
    n = 3000
    cols = (_positions(rng, w["jidx"].reflen, n), rng.integers(1, 9, n))
    j, t = w["jidx"], w["tidx"]
    (want,) = jlk._two_batch_packed(j.refstr_padded, j.rlp, j.lr_tar,
                                    *_jax_cols(*cols), j.offs0,
                                    cfg.max_rule_span, cfg.min_gap_size,
                                    do_gap=True)
    got = tlk.two_packed(t.refstr_padded, t.rlp, t.lr_tar,
                         *_torch_cols(*cols), cfg.max_rule_span,
                         cfg.min_gap_size)
    assert got.dtype == torch.int32 and got.shape == (n,)
    want = np.asarray(want, np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert (want & 0xFFFF).any() and (want >> 16).any()


def _eq(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_lookups_equal_jax_column_path(toy_fixture, request, monkeypatch):
    """lookup1 and lookup2 on the toy corpus through the port's column
    engine and through the JAX engine's (``CGX_SCAN_COLS=1``): the rows and
    the per-pattern row ranges; only the column kernels scan."""
    monkeypatch.setenv("CGX_SCAN_COLS", "1")
    f, e, a, lex_t, q = _inputs("toy", request)
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
    _, jsearch2 = jef.fast_sort_and_dedup_twogap(
        jef.fast_two_gap_enumeration(jqs, jp1, jenum, jsearch, jcfg), jqs)
    jtg = jlk.two_gap_lookup_tpu(jidx, jqs, jsearch, jog, jsearch2, jpc, jcfg,
                                 refstr_host=np.asarray(jsrc.str_))

    items = {"C1f": 0, "C1b": 0, "C1t": 0}
    real_scan, real_two = tlk.scan_cols, tlk.two_packed

    def scan_cols(*args):
        items["C1f" if args[-1] else "C1b"] += args[3].shape[0]
        return real_scan(*args)

    def two_packed(*args):
        items["C1t"] += args[3].shape[0]
        return real_two(*args)

    def refused(*args):
        raise AssertionError("an expanding kernel ran under scan_cols")
    monkeypatch.setattr(tlk, "scan_cols", scan_cols)
    monkeypatch.setattr(tlk, "two_packed", two_packed)
    monkeypatch.setattr(tlk, "scan", refused)
    monkeypatch.setattr(tlk, "two", refused)
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
    eng = ReplicatedEngine(tidx, tcfg, scan_cols=True, sa_host=tsa.sa)
    tpc = tpcx.precompute(eng, tsrc, tsa, tcfg)
    tog = tlk.one_gap_lookup(eng, tqs, tp1, tp2, tsearch, tpc, tcfg)
    _, tsearch2 = tef.fast_sort_and_dedup_twogap(
        tef.fast_two_gap_enumeration(tqs, tp1, tenum, tsearch, tcfg), tqs)
    ttg = tlk.two_gap_lookup(eng, tqs, tsearch, tog, tsearch2, tpc, tcfg,
                             np.asarray(tsrc.str_))
    _eq(tog, jog)
    _eq(ttg, jtg)
    _eq(tsearch, jsearch)
    _eq(tsearch2, jsearch2)
    assert len(tog.position) > 0 and len(ttg.position) > 0
    assert min(items.values()) > 0, items


@pytest.mark.parametrize("name", ["toy", "real"])
def test_pipeline_scan_cols_equals_goldens(name, request):
    """Every query's grammar hash equals tests/golden_<name>_hashes.json
    (the JAX package's grammars), and every counter the run without
    ``scan_cols``."""
    golden = json.loads((TESTS / f"golden_{name}_hashes.json").read_text())
    cfg = ExtractorConfig(precompute_count=golden["precompute_count"])
    args = _inputs(name, request)
    got = tpl.run_pipeline(*args, cfg, device="cpu", scan_cols=True)
    assert len(got.per_query_lines) == len(golden["sha256"])
    for q, lines in enumerate(got.per_query_lines):
        h = hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()
        assert h == golden["sha256"][str(q)], f"query {q}"
    want = tpl.run_pipeline(*args, cfg, device="cpu")
    assert got.counters == want.counters
    assert got.counters["onegap_sa"] > 0 and got.counters["twogap_sa"] > 0


def test_scan_cols_with_sa_shards_is_refused(toy_fixture, request):
    """The sharded index has no column path (nor has the JAX one)."""
    with pytest.raises(ValueError, match="scan_cols"):
        tpl.run_pipeline(*_inputs("toy", request), ExtractorConfig(),
                         device="cpu", scan_cols=True, sa_shards=4)


def test_column_engine_needs_the_host_sa(arrays):
    with pytest.raises(ValueError, match="sa_host"):
        ReplicatedEngine(arrays["tidx"], ExtractorConfig(), scan_cols=True)


def test_run_pipeline_files_scan_cols(toy_fixture, tmp_path, monkeypatch):
    """``run_pipeline_files(..., scan_cols=True)`` writes the files the run
    without it writes, through the column kernels."""
    calls = []
    real = tlk.scan_cols

    def scan_cols(*args):
        calls.append(args[3].shape[0])
        return real(*args)
    d = toy_fixture
    files = [str(d / n) for n in ("corpus.f", "query.f", "corpus.e",
                                  "corpus.a", "lex.txt")]
    cfg = ExtractorConfig(precompute_count=30)
    tpl.run_pipeline_files(*files, str(tmp_path / "rows"), cfg,
                           device="cpu")
    monkeypatch.setattr(tlk, "scan_cols", scan_cols)
    tpl.run_pipeline_files(*files, str(tmp_path / "cols"), cfg,
                           device="cpu", scan_cols=True)
    assert calls and sum(calls) > 0
    names = sorted(p.name for p in (tmp_path / "rows").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "cols").iterdir())
    for n in names:
        assert (tmp_path / "rows" / n).read_bytes() == \
            (tmp_path / "cols" / n).read_bytes(), n
