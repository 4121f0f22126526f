"""The one current-device guard on the port's launch path
(``cgx_tpu_torch/kernels/build.py`` ``launch``), on the CPU.

A CUDA launch into the stream of a device that is not current is refused,
so every kernel must run with its tensors' device current.  These tests
force ``kb.route`` to launch, swap in a kernel library that records the
current device at each call and a recording ``torch.cuda.device``, and
make tensors present themselves as lying on ``cuda:k`` (``FakeCards``: a
copy ``.to("cuda:k")``, or made by a factory with that device, reads
``cuda:k`` as its ``device``).  Then each launch of B4 in
``make_sharded_search_step`` over three cards, of the sharded engine and of
B2g, B2s and B2t over an index on a device list, and of ``LocalDPEngine``
over two cards must see its own device current, and each shard's items
must reach its device (the spy on ``ShardedEngine._partitioned``).  No
module launches a kernel other than through ``launch``."""

import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.index import container as ic  # noqa: E402
from cgx_tpu_torch.kernels import build as kb  # noqa: E402
from cgx_tpu_torch.parallel import dist  # noqa: E402
from cgx_tpu_torch.parallel import sharded as shx  # noqa: E402
from cgx_tpu_torch.parallel.localdp import LocalDPEngine  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as sab  # noqa: E402

REPO = pathlib.Path(__file__).parent.parent
CARDS = [torch.device("cuda", k) for k in range(3)]


class FakeCards:
    """Tensors that read as lying on a card, on a machine without one:
    ``t.to("cuda:k")`` returns a CPU copy whose ``device`` reads
    ``cuda:k``, as do ``torch.empty``, ``torch.zeros`` and ``torch.tensor``
    given such a device (zero-filled).  The tagged tensors are kept alive,
    so no other tensor reuses their ``id``."""

    def __init__(self, monkeypatch, count: int):
        self.tags = {}
        base = torch._C.TensorBase.device
        real_to = torch.Tensor.to

        def device(t):
            tag = self.tags.get(id(t))
            return tag[1] if tag is not None and tag[0] is t \
                else base.__get__(t)

        def to(t, *args, **kw):
            dev = args[0] if args and isinstance(args[0], (str,
                                                           torch.device)) \
                else None
            if dev is not None and torch.device(dev).type == "cuda":
                dev = torch.device(dev)
                return t if device(t) == dev else self.tag(t.clone(), dev)
            if dev is not None and device(t).type == "cuda":
                return t.clone()
            return real_to(t, *args, **kw)

        def factory(real, fill_zeros=False):
            def make(*args, device=None, **kw):
                if device is not None and torch.device(device).type == "cuda":
                    if fill_zeros:
                        return self.tag(torch.zeros(*args, **kw),
                                        torch.device(device))
                    return self.tag(real(*args, **kw), torch.device(device))
                return real(*args, device=device, **kw)
            return make

        monkeypatch.setattr(torch.Tensor, "device", property(device))
        monkeypatch.setattr(torch.Tensor, "to", to)
        monkeypatch.setattr(torch, "empty", factory(torch.empty, True))
        monkeypatch.setattr(torch, "zeros", factory(torch.zeros))
        monkeypatch.setattr(torch, "tensor", factory(torch.tensor))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def tag(self, t, dev):
        self.tags[id(t)] = (t, dev)
        return t


class Launches:
    """The current device (``torch.cuda.device``, recorded) at each call of
    a C entry point of a fake kernel library -> ``calls``: (entry,
    device)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.stack = []
        spy = self

        class Current:
            def __init__(self, device):
                self.device = torch.device(device)

            def __enter__(self):
                spy.stack.append(self.device)

            def __exit__(self, *exc):
                spy.stack.pop()

        class Library:
            def __getattr__(self, fn):
                def entry(*args):
                    spy.calls.append((fn, spy.stack[-1] if spy.stack
                                      else None))
                    return 0
                return entry

        monkeypatch.setattr(torch.cuda, "device", Current)
        monkeypatch.setattr(kb, "library", lambda name: Library())
        monkeypatch.setattr(kb, "stream", lambda d: ctypes.c_void_p(0))
        monkeypatch.setattr(kb, "route", lambda kernel, device: True)
        monkeypatch.setattr(kb, "check_inputs", lambda *a, **k: None)

    def of(self, fn) -> list:
        return [d for f, d in self.calls if f == fn]


@pytest.fixture(scope="module")
def toy(toy_fixture):
    d = toy_fixture
    cfg = ExtractorConfig(precompute_count=30)
    src = cp.load_source_corpus(cp.read_lines(str(d / "corpus.f")))
    tgt = cp.load_target_corpus(cp.read_lines(str(d / "corpus.e")))
    al = cp.load_alignment_fast(cp.read_lines(str(d / "corpus.a")), src, tgt)
    lex = cp.load_lex_table(cp.read_tokens(str(d / "lex.txt")), src.vocab,
                            tgt.vocab)
    sa = sab.build_index(src.str_)
    idx = ic.build_index(src, tgt, sa, al, lex, cfg, "cpu")
    qs = cp.load_queries(cp.read_lines(str(d / "query.f")), src.vocab)
    return dict(cfg=cfg, src=src, tgt=tgt, al=al, sa=sa, idx=idx, qs=qs,
                lcp=idx.lcp_tables())


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", "100000")
    FakeCards(monkeypatch, len(CARDS))
    return Launches(monkeypatch)


def test_fake_cards_read_as_cards(fake):
    t = torch.arange(4, dtype=torch.int32).to("cuda:2")
    assert t.device == torch.device("cuda:2")
    assert torch.empty(3, dtype=torch.int32, device=CARDS[1]).device \
        == CARDS[1]
    assert (t + 1).device.type == "cpu"
    with kb.current(CARDS[2]):
        kb.launch("dist", "cgx_dp_step", CARDS[1], 0)
    assert fake.calls == [("cgx_dp_step", CARDS[1])]


def test_b4_launches_on_each_shard_device(toy, fake):
    """Each of the three shards of the query-DP step launches B4 with its
    own card current, and ``make_mesh(3)`` names cuda:0..2."""
    ix, cfg = toy["idx"], toy["cfg"]
    devices = dist.make_mesh(3)
    assert devices == CARDS
    step = dist.make_sharded_search_step(devices, ix.reflen,
                                         cfg.max_rule_span,
                                         cfg.max_rule_symbols)
    n = toy["qs"].totaltokens
    toks = np.arange(n, dtype=np.int32)
    step(*(dist.replicate(devices, a) for a in (
        ix.refstr_padded, ix.sa, *toy["lcp"], ix.rlp, ix.lr_tar,
        torch.from_numpy(toy["qs"].padded_tokens()))),
        dist.shard_items(devices, toks), dist.shard_items(devices, toks % 5),
        dist.shard_items(devices, toks), dist.shard_items(devices, toks % 3))
    assert fake.of("cgx_dp_step") == CARDS
    assert kb.LAUNCHES["B4"] >= 3


def _sharded(toy):
    return shx.build_sharded_index(toy["src"], toy["tgt"], toy["sa"],
                                   toy["al"], toy["cfg"], 3, CARDS)


def test_sharded_engine_launches_on_each_owner(toy, fake, monkeypatch):
    """Over an index on ``cuda:0..2`` each shard's items reach its device
    and its kernels launch with that card current: A7 on views through
    ``_partitioned`` (spied: items and views on ``device_of(s)``), and B2g
    by owner."""
    sidx = _sharded(toy)
    assert sidx.listed and [sidx.device_of(s) for s in range(3)] == CARDS
    assert all(sidx.ref_l[s].device == CARDS[s] for s in range(3))
    seen = []
    real = shx.xdev.onegap

    def spy(ref, rlp, lrt, css, *rest):
        seen.append((int(sidx.owner_of(css.numpy())[0]), css.device,
                     ref.arr.device, set(sidx.owner_of(css.numpy()))))
        return real(ref, rlp, lrt, css, *rest)
    monkeypatch.setattr(shx.xdev, "onegap", spy)
    reflen = sidx.reflen
    css = np.linspace(0, reflen - 20, 30).astype(np.int64)
    cols = [css, np.full(30, 4), np.ones(30, np.int64), np.ones(30, np.int64)]
    shx.ShardedEngine(sidx, toy["cfg"]).onegap(*cols)
    assert [(s, d, v) for s, d, v, _ in seen] == [
        (s, CARDS[s], CARDS[s]) for s in range(3)]
    assert all(owners == {s} for s, _, _, owners in seen)
    assert fake.of("cgx_onegap") == CARDS
    rows = np.linspace(0, reflen - 1, 40).astype(np.int64)
    shx.gather_sa(sidx, rows)
    assert fake.of("cgx_gather_sa_sharded") == CARDS


def test_round_form_launches_on_each_shard_device(toy, fake):
    """Every step of the round form launches B2s and then B2t on each
    shard's card, with that card current."""
    sidx = _sharded(toy)
    qtok = torch.from_numpy(toy["qs"].padded_tokens())
    n = 7
    lo = np.zeros(n, np.int32)
    hi = np.full(n, 5, np.int32)
    shx.refine_round(sidx, qtok, np.arange(n, dtype=np.int32),
                     np.full(n, 9, np.int32), lo, hi, 3, 2)
    _, T = shx.round_plan(lo, hi, 2)
    steps = fake.of("cgx_refine_step")
    assert steps == CARDS * (T + 1)
    assert fake.of("cgx_token_partial") == CARDS * T


def test_localdp_launches_on_each_replica_device(toy, fake):
    """``LocalDPEngine`` over two cards: each replica's A7 launches with its
    own card current (the fan's ``kb.current`` encloses it, and the launch
    makes the card current again)."""
    eng = LocalDPEngine(toy["idx"], np.asarray(toy["sa"].sa), toy["cfg"],
                        devices=["cuda:0", "cuda:1"])
    assert [ix.refstr_padded.device for ix in eng.indices] == CARDS[:2]
    n = 10
    css = np.arange(n, dtype=np.int64) * 7
    eng.onegap(css, np.full(n, 4), np.ones(n, np.int64),
               np.ones(n, np.int64))
    assert fake.of("cgx_onegap") == CARDS[:2]


def test_every_launch_goes_through_the_guard():
    """No module of the port calls a kernel library's entry point but
    ``kernels/build.py`` ``launch``: no stream is passed and no return code
    checked anywhere else."""
    pkg = REPO / "cgx_tpu_torch"
    offenders = []
    for path in pkg.rglob("*.py"):
        if path.name == "build.py" and path.parent.name == "kernels":
            continue
        text = path.read_text()
        for pat in (r"kb\.stream\(", r"kb\.check\(", r"\.cuda_stream"):
            if re.search(pat, text):
                offenders.append((path.relative_to(REPO), pat))
    assert offenders == []
    launches = sum(len(re.findall(r"kb\.launch\(", p.read_text()))
                   for p in pkg.rglob("*.py"))
    assert launches >= 25
