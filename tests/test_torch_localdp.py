"""Local data parallelism in the port (``cgx_tpu_torch/parallel/localdp.py``)
on the CPU: tests/test_localdp.py on the port, with N CPU placements in
place of the JAX tests' virtual devices.  The replica clone, the passes
(A1's refinement and B1's two passes) across replicas bit-equal to one
device, the pipeline at dp = 2 and 3 byte-identical to the one-device run
and to the JAX package's ``run_pipeline(..., dp_devices=n)`` under every
path, every fan launching on all its replicas before the first host copy,
batches with fewer items than replicas, the degenerate batches against the
oracle, the refusal past the visible cards, the CLI flag and serve."""

import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.oracle import pipeline as opl  # noqa: E402
from cgx_tpu_torch import cli, serve  # noqa: E402
from cgx_tpu_torch import engine as teng  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.features import maxlex as ml  # noqa: E402
from cgx_tpu_torch.index import container as ic  # noqa: E402
from cgx_tpu_torch.parallel import localdp  # noqa: E402
from cgx_tpu_torch.parallel.localdp import LocalDPEngine, clone_index  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as sab  # noqa: E402
from cgx_tpu_torch.search import passes  # noqa: E402
from test_torch_edge import _degenerate  # noqa: E402

CFG = dict(precompute_count=30)
# the engine methods a LocalDPEngine fans, and the kernels behind them
FANNED = ("pcs_expanded", "scan_expanded", "two_expanded", "contig",
          "onegap", "twogap", "pass1_items", "pass2_items")


def _inputs(d):
    return (cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))


@pytest.fixture(scope="module")
def world(toy_fixture):
    cfg = ExtractorConfig(**CFG)
    f, e, a, lex, q = _inputs(toy_fixture)
    src = cp.load_source_corpus(f)
    tgt = cp.load_target_corpus(e)
    al = cp.load_alignment(a, src, tgt)
    lext = cp.load_lex_table(lex, src.vocab, tgt.vocab)
    qs = cp.load_queries(q, src.vocab)
    sa = sab.build_index(src.str_)
    index = ic.build_index(src, tgt, sa, al, lext, cfg, "cpu")
    return dict(cfg=cfg, data=(f, e, a, lex, q), qs=qs, sa=sa, index=index)


@pytest.fixture(scope="module")
def one_device(world):
    return tpl.run_pipeline(*world["data"], world["cfg"], device="cpu")


_JAX = {}


def _jax_dp(world, n):
    """The JAX package's run over n of the 8 virtual devices (cached)."""
    if n not in _JAX:
        _JAX[n] = jpl.run_pipeline(*world["data"], JaxConfig(**CFG),
                                   dp_devices=n)
    return _JAX[n]


def test_clone_index_shares_host_fields_and_resets_caches(world):
    ix = clone_index(world["index"], "cpu")    # a copy this test may fill
    qs = world["qs"]
    ix.query_tokens(qs)
    ix.lcp_tables()
    ix.maxlex_tables = ("device tables",)
    rep = clone_index(ix, "cpu")
    assert rep.device == torch.device("cpu")
    # the same device: the same tensors, no copy
    for name in ("refstr_padded", "sa", "rlp", "lr_tar", "tgt_str"):
        assert getattr(rep, name) is getattr(ix, name)
    # host fields shared by reference
    for name in ("lex_key", "lex_val1_host", "lex_val2_host", "seed_host",
                 "lcpleft_host", "lcpright_host"):
        assert getattr(rep, name) is getattr(ix, name)
    # the per-device caches start empty, and fill on the replica alone
    assert (rep.maxlex_tables, rep._qtok, rep._pcrows, rep._lcp) == \
        (None, None, None, None)
    assert rep.query_tokens(qs) is not ix.query_tokens(qs)
    assert torch.equal(rep.query_tokens(qs), ix.query_tokens(qs))


@pytest.mark.parametrize("n", [2, 3])
def test_passes_bit_equal_across_dp(world, n, monkeypatch):
    qs, index, cfg = world["qs"], world["index"], world["cfg"]
    p1_r, p2_r = passes.refine_passes(index, qs)
    l1_r = passes.pass1_lcp(index, qs)
    l2_r = passes.pass2_lcp(index, qs, l1_r)
    eng = LocalDPEngine(index, world["sa"].sa, cfg, n_devices=n)
    assert len(eng.engines) == n
    lanes = []
    real = passes.refine_chunk
    monkeypatch.setattr(passes, "refine_chunk",
                        lambda *a: lanes.append(a[3].shape[0]) or real(*a))
    p1_d, p2_d = eng.refine_passes(qs)
    l1_d = eng.pass1(qs)
    l2_d = eng.pass2(qs, l1_d)
    for got, want in ((p1_d, p1_r), (p2_d, p2_r), (l1_d, l1_r),
                      (l2_d, l2_r)):
        for f in vars(want):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    assert l1_d.longestmatch.max() > 1   # the fixture exercises pass 2
    # the first ladder step's lanes split n ways
    assert len(lanes) > n and max(lanes) < qs.totaltokens


@pytest.mark.parametrize("mode", ["default", "lcp_passes", "scan_cols"])
@pytest.mark.parametrize("n", [2, 3])
def test_localdp_pipeline_byte_identical(world, one_device, n, mode):
    """dp=2 (even) and dp=3 (uneven spans) reproduce the one-device port
    run and the JAX package's dp run exactly, under each pass-1/2 search
    and the column-upload lookups."""
    kw = {} if mode == "default" else {mode: True}
    dp = tpl.run_pipeline(*world["data"], world["cfg"], device="cpu",
                          dp_devices=n, **kw)
    assert dp.counters == one_device.counters
    assert dp.per_query_lines == one_device.per_query_lines
    want = _jax_dp(world, n)
    assert dp.per_query_lines == want.per_query_lines
    assert {k: dp.counters[k] for k in want.counters} == want.counters


def test_localdp_overlap_and_device_list(world, one_device):
    """run_pipeline_overlap fans too; an explicit device list may repeat a
    device."""
    ov = tpl.run_pipeline_overlap(*world["data"], world["cfg"], device="cpu",
                                  dp_devices=2, query_batches=3)
    assert ov.per_query_lines == one_device.per_query_lines
    listed = tpl.run_pipeline(*world["data"], world["cfg"], device="cpu",
                              dp_devices=["cpu"] * 4)
    assert listed.per_query_lines == one_device.per_query_lines


def test_every_fan_launches_before_it_fetches(world, one_device,
                                              monkeypatch):
    """In a dp=3 run every fanned method runs on more than one replica, and
    within each fan every replica launches before the first host copy."""
    calls, events = [], []
    for meth in FANNED:
        real = getattr(teng.ReplicatedEngine, meth)

        def spy(self, *a, _real=real, _m=meth, **kw):
            got = _real(self, *a, **kw)
            calls.append((_m, id(self)))
            if kw.get("fetch", True):
                return got
            events.append(("launch", id(self)))

            def fetch():
                events.append(("fetch", id(self)))
                return got()
            return fetch
        monkeypatch.setattr(teng.ReplicatedEngine, meth, spy)
    res = tpl.run_pipeline(*world["data"], world["cfg"], device="cpu",
                           dp_devices=3, lcp_passes=True)
    assert res.per_query_lines == one_device.per_query_lines
    replicas = {}
    for meth, who in calls:
        replicas.setdefault(meth, set()).add(who)
    assert all(len(replicas.get(m, ())) > 1 for m in FANNED), replicas
    # each fan: its launches, then its fetches in the same replica order
    fans, i = 0, 0
    while i < len(events):
        j = i
        while j < len(events) and events[j][0] == "launch":
            j += 1
        k = j
        while k < len(events) and events[k][0] == "fetch":
            k += 1
        assert j - i > 1 and [e[1] for e in events[i:j]] == \
            [e[1] for e in events[j:k]]
        fans += 1
        i = k
    assert fans >= len(FANNED)


def test_maxlex_on_the_first_replica(world, monkeypatch):
    seen = []
    real = ml.compute_maxlex
    monkeypatch.setattr(ml, "compute_maxlex",
                        lambda tasks, lex_index, *a: seen.append(lex_index)
                        or real(tasks, lex_index, *a))
    ctx = {}
    real_ctx = tpl._make_context

    def keep(*a, **kw):
        ctx.update(real_ctx(*a, **kw))
        return ctx
    monkeypatch.setattr(tpl, "_make_context", keep)
    tpl.run_pipeline(*world["data"], world["cfg"], device="cpu",
                     dp_devices=2)
    assert seen == [ctx["engine"].indices[0]]


def test_fewer_items_than_replicas(world):
    """Eight replicas, a batch of one query of two tokens: most replicas
    get no item, and the grammar is the one-device run's."""
    f, e, a, lex, q = world["data"]
    short = [" ".join(q[0].split()[:2])]
    one = tpl.run_pipeline(f, e, a, lex, short, world["cfg"], device="cpu")
    for kw in ({}, {"lcp_passes": True}):
        dp = tpl.run_pipeline(f, e, a, lex, short, world["cfg"],
                              device="cpu", dp_devices=8, **kw)
        assert dp.per_query_lines == one.per_query_lines
        assert sum(map(len, dp.per_query_lines)) > 0


@pytest.mark.parametrize("kind", ["empty_or_oov", "no_onegap_pattern"])
def test_degenerate_batch_equals_oracle(kind):
    """Where the JAX pipeline fails (ROADMAP §C), the port's dp run equals
    the oracle."""
    args = _degenerate(kind)
    want = opl.run_oracle(*args, JaxConfig(precompute_count=10))
    got = tpl.run_pipeline(*args, ExtractorConfig(precompute_count=10),
                           device="cpu", dp_devices=3)
    assert got.per_query_lines == want.per_query_lines


def test_localdp_rejects_too_many_devices(monkeypatch):
    """On CUDA the first N cards, refused past the visible ones (the
    device count stood in)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert localdp.dp_device_list(2, "cuda") == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    assert localdp.dp_device_list(0, "cuda") == [torch.device("cuda", 0),
                                                 torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="exceeds"):
        localdp.dp_device_list(3, "cuda")
    with pytest.raises(ValueError, match="exceeds"):
        tpl.run_pipeline([], [], [], [], [], device="cuda", dp_devices=3)
    assert localdp.dp_device_list(5, "cpu") == [torch.device("cpu")] * 5


def _cli_files(d):
    d = pathlib.Path(d)
    return [str(d / "corpus.f"), str(d / "query.f"), str(d / "corpus.e"),
            str(d / "corpus.a"), str(d / "lex.txt")]


def test_localdp_cli_flag(toy_fixture, tmp_path, monkeypatch, capsys):
    base = ["--device", "cpu"] + _cli_files(toy_fixture)
    assert cli.main(base + [str(tmp_path / "g1")]) == 0
    assert cli.main(["--dp-devices", "2"] + base
                    + [str(tmp_path / "g2")]) == 0
    a = sorted((tmp_path / "g1").glob("grammar.*"))
    b = sorted((tmp_path / "g2").glob("grammar.*"))
    assert len(a) > 0 and [p.name for p in a] == [p.name for p in b]
    assert [p.read_bytes() for p in a] == [p.read_bytes() for p in b]
    # the two layout flags are mutually exclusive
    for shards in ("2", "auto"):
        assert cli.main(["--dp-devices", "2", "--sa-shards", shards] + base
                        + [str(tmp_path / "g3")]) == 1
    assert not (tmp_path / "g3").exists()
    # past the visible cards: one error line, before any work
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    capsys.readouterr()
    assert cli.main(["--dp-devices", "2"] + _cli_files(toy_fixture)
                    + [str(tmp_path / "g4")]) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "exceeds" in err[0]


def test_serve_with_dp_devices(toy_fixture, tmp_path):
    """``serve --dp-devices 2 --device cpu``: each answer equals the
    one-shot run."""
    d = pathlib.Path(toy_fixture)
    assert cli.main(["--device", "cpu"] + _cli_files(d)
                    + [str(tmp_path / "one")]) == 0
    q_small = tmp_path / "q3.f"
    q_small.write_text("\n".join((d / "query.f").read_text()
                                 .splitlines()[:3]) + "\n")
    req = io.StringIO(f"{d / 'query.f'} {tmp_path / 's_all'}\n"
                      f"{q_small} {tmp_path / 's_small'}\n")
    out = io.StringIO()
    served = serve.serve_loop(
        str(d / "corpus.f"), str(d / "corpus.e"), str(d / "corpus.a"),
        str(d / "lex.txt"), inp=req, out=out, prewarm=None, device="cpu",
        dp_devices=2)
    assert served == 2
    replies = out.getvalue().splitlines()
    assert replies[0].startswith("ready ")
    assert [r.split()[:2] for r in replies[1:]] == [["ok", "8"], ["ok", "3"]]

    def files(p):
        return [f.read_bytes() for f in sorted(
            p.glob("grammar.*"), key=lambda f: int(f.name.split(".")[1]))]
    ref = files(tmp_path / "one")
    assert files(tmp_path / "s_all") == ref
    assert files(tmp_path / "s_small") == ref[:3]
