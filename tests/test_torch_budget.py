"""The device-memory budget of the port (``cgx_tpu_torch/utils/budget.py``):
every case of tests/test_budget.py on the port, ``resolve_shards``'s
decisions against the JAX package's with one visible device over a grid,
the footprint against the tensors the port's ``build_index`` places, the
sharded layout held whole to the one device it lies on, the CUDA budget,
and the CLI's one-line errors and ``--sa-shards auto`` against the JAX
CLI.  The budget is mocked through ``CGX_DEVICE_MEM_MB``."""

import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cgx_tpu import cli as jcli  # noqa: E402
from cgx_tpu.utils import budget as jbd  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from cgx_tpu_torch.index import container as ic  # noqa: E402
from cgx_tpu_torch.parallel import sharded as shx  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.preproc import suffix_array as sab  # noqa: E402
from cgx_tpu_torch.utils import budget as bd  # noqa: E402


@pytest.fixture
def mock_budget(monkeypatch):
    def set_mb(mb):
        monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(mb))
    return set_mb


def _corpus(F):
    """(source, target, sa, align, lex) of a fixture dir."""
    src = cp.load_source_corpus(cp.read_lines(str(F / "corpus.f")))
    tgt = cp.load_target_corpus(cp.read_lines(str(F / "corpus.e")))
    al = cp.load_alignment(cp.read_lines(str(F / "corpus.a")), src, tgt)
    lex = cp.load_lex_table(cp.read_tokens(str(F / "lex.txt")),
                            src.vocab, tgt.vocab)
    return src, tgt, sab.build_index(src.str_), al, lex


def _mb(usable: float) -> float:
    """The ``CGX_DEVICE_MEM_MB`` whose usable share is ``usable`` bytes."""
    return usable / bd.REF_INDEX_RATIO / 1024**2


@pytest.mark.parametrize("fixture", ["toy_fixture", "real_fixture"])
def test_footprint_matches_real_index(fixture, request):
    """The footprint equals the bytes of the tensors build_index places
    (bucket padding included)."""
    F = request.getfixturevalue(fixture)
    cfg = DEFAULT_CONFIG
    src, tgt, sa, al, lex = _corpus(F)
    ix = ic.build_index(src, tgt, sa, al, lex, cfg, "cpu")
    placed = [v for v in vars(ix).values() if isinstance(v, torch.Tensor)]
    assert len(placed) == 5    # refstr_padded, sa, rlp, lr_tar, tgt_str
    est = bd.replicated_footprint_bytes(src.toklen, tgt.toklen,
                                        cfg.qry_max_length,
                                        cfg.max_rule_span)
    assert est == sum(t.numel() * t.element_size() for t in placed)


def test_resolve_fits_replicated(mock_budget):
    mock_budget(1000)           # 1 GB: a 100k-token corpus trivially fits
    assert bd.resolve_shards(0, 100_000, 100_000) == 0
    assert bd.resolve_shards("auto", 100_000, 100_000) == 0
    assert bd.resolve_shards(4, 100_000, 100_000) == 4   # explicit honoured


def test_resolve_raises_one_liner_when_too_big(mock_budget):
    mock_budget(2)              # 2 MB: nothing fits
    for request_ in (0, "auto"):
        with pytest.raises(bd.BudgetError, match="item 10b") as exc:
            bd.resolve_shards(request_, 10_000_000, 10_000_000)
        assert "\n" not in str(exc.value)
        assert str(exc.value).startswith("replicated corpus index needs")
    # an explicit count passes here: its whole layout is held to the
    # budget where build_sharded_index has sized it
    assert bd.resolve_shards(2, 100_000_000, 100_000_000) == 2
    with pytest.raises(ValueError, match="'auto'"):
        bd.resolve_shards("all", 10, 10)


def test_resolve_auto_picks_smallest_fit(mock_budget):
    """``auto`` picks the smallest layout that fits the one device: the
    replicated index.  A budget that holds a third of it, where the JAX
    package spreads its shards over 3 or more of its 8 devices, is
    refused, since the port's shards would all share the one device."""
    src = tgt = 10_000_000
    need = bd.replicated_footprint_bytes(src, tgt)
    mock_budget(_mb(need + 64))
    assert bd.resolve_shards("auto", src, tgt) == 0
    mock_budget(_mb(need / 3 * 1.05))
    assert 3 <= jbd.resolve_shards("auto", src, tgt) <= 8   # 8 JAX devices
    with pytest.raises(bd.BudgetError, match="item 10b"):
        bd.resolve_shards("auto", src, tgt)


@pytest.mark.parametrize("cards", [1, 8])
def test_auto_refuses_whatever_the_visible_cards(cards, mock_budget,
                                                 monkeypatch):
    """On CUDA, ``auto`` is the replicated index or a refusal however many
    cards the host shows: the sharded index lies on one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mock_budget(1000)
    assert bd.resolve_shards("auto", 100_000, 100_000, device="cuda") == 0
    mock_budget(2)
    with pytest.raises(bd.BudgetError, match="item 10b"):
        bd.resolve_shards("auto", 10_000_000, 10_000_000, device="cuda")


def test_no_budget_means_no_check(monkeypatch):
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    # the CPU has no device budget: explicit requests pass through
    assert bd.device_budget_bytes("cpu") is None
    assert bd.resolve_shards(0, 10**9, 10**9, device="cpu") == 0
    assert bd.resolve_shards("auto", 10**9, 10**9, device="cpu") == 0


def test_cuda_budget(monkeypatch):
    """On CUDA the budget is the card's total memory, the override still
    first."""
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)

    class Props:
        total_memory = 80 * 10**9
    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: seen.append(d) or Props)
    assert bd.device_budget_bytes("cuda:1") == 80 * 10**9
    assert seen == [torch.device("cuda:1")]
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", "16")
    assert bd.device_budget_bytes("cuda") == 16 * 1024**2


def _outcome(resolve, *args):
    try:
        return ("int", resolve(*args))
    except bd.BudgetError as exc:
        return ("BudgetError", str(exc))
    except jbd.BudgetError as exc:
        return ("BudgetError", str(exc))


@pytest.mark.parametrize("request_", [0, "auto"])
def test_resolve_shards_decides_as_jax_on_one_device(request_, monkeypatch):
    """Over token lengths and budgets, the port decides as the JAX package
    with one visible device (the device every shard of the port lies on):
    the same shard count, or a refusal in both.  The port is fed the JAX
    footprint, so the logic is compared and not the layout."""
    monkeypatch.setattr(bd, "replicated_footprint_bytes",
                        jbd.replicated_footprint_bytes)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    seen = set()
    for src, tgt in ((1_000, 900), (100_000, 120_000),
                     (10_000_000, 9_000_000), (300_000_000, 280_000_000)):
        for mb in (None, 0.05, 2, 50, 1000, 16_000):
            if mb is None:
                monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
            else:
                monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(mb))
            got = _outcome(bd.resolve_shards, request_, src, tgt,
                           DEFAULT_CONFIG, "cpu")
            want = _outcome(jbd.resolve_shards, request_, src, tgt,
                            DEFAULT_CONFIG)
            assert got[0] == want[0], (request_, src, tgt, mb, got, want)
            if got[0] == "int":
                assert got == want
            else:
                assert "item 10b" in got[1]
            seen.add(got[0])
    # the grid reaches both an answer and a refusal
    assert seen == {"int", "BudgetError"}


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_layout_held_whole_to_one_device(shards, toy_fixture,
                                                 mock_budget, monkeypatch):
    """build_sharded_index holds the bytes of every shard it places, halos
    included, to the one device's budget: a budget that holds them builds
    the same index, one 64 bytes short refuses it in one line."""
    src, tgt, sa, al, _ = _corpus(toy_fixture)
    cfg = DEFAULT_CONFIG
    monkeypatch.delenv("CGX_DEVICE_MEM_MB", raising=False)
    ref = shx.build_sharded_index(src, tgt, sa, al, cfg, shards, "cpu")
    placed = sum(t.numel() * t.element_size()
                 for part in (ref.sa_l, ref.ref_l, ref.rlp_l, ref.lrt_l)
                 for t in part)
    mock_budget(_mb(placed + 64))
    got = shx.build_sharded_index(src, tgt, sa, al, cfg, shards, "cpu")
    assert all(torch.equal(a, b) for part in ("sa_l", "ref_l", "rlp_l",
                                              "lrt_l")
               for a, b in zip(getattr(ref, part), getattr(got, part)))
    mock_budget(_mb(placed - 64))
    with pytest.raises(bd.BudgetError, match="item 10b") as exc:
        shx.build_sharded_index(src, tgt, sa, al, cfg, shards, "cpu")
    assert str(exc.value).startswith(
        f"{shards}-shard corpus index needs ~{placed / 1e6:.0f} MB")


def _cli_files(d):
    d = pathlib.Path(d)
    return [str(d / "corpus.f"), str(d / "query.f"), str(d / "corpus.e"),
            str(d / "corpus.a"), str(d / "lex.txt")]


def test_cli_budget_error_is_one_line(toy_fixture, tmp_path, monkeypatch,
                                      capsys):
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", "0.05")   # 50 KB: toy can't fit
    rc = cli.main(["--device", "cpu"] + _cli_files(toy_fixture)
                  + [str(tmp_path / "g")])
    assert rc == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("error: replicated corpus")
    assert "item 10b" in err[0]
    assert not (tmp_path / "g").exists()


def test_cli_sharded_budget_error_is_one_line(toy_fixture, tmp_path,
                                              monkeypatch, capsys):
    """A budget that holds the toy's replicated index but not its 8-shard
    layout (on a corpus this small the halos outweigh the bucket padding):
    the replicated run goes through, ``--sa-shards 8`` ends in one error
    line."""
    src, tgt, _, _, _ = _corpus(toy_fixture)
    cfg = DEFAULT_CONFIG
    need = bd.replicated_footprint_bytes(src.toklen, tgt.toklen,
                                         cfg.qry_max_length,
                                         cfg.max_rule_span)
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(_mb(need + 64)))
    files = ["--device", "cpu"] + _cli_files(toy_fixture)
    assert cli.main(files + [str(tmp_path / "rep")]) == 0
    capsys.readouterr()
    assert cli.main(["--sa-shards", "8"] + files
                    + [str(tmp_path / "g")]) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("error: 8-shard corpus")
    assert "item 10b" in err[0]
    assert not (tmp_path / "g").exists()


def test_cli_auto_equals_jax(toy_fixture, tmp_path, monkeypatch, capsys):
    """``--sa-shards auto`` under a budget between the port's footprint and
    the JAX package's: the JAX CLI shards over its 8 devices, the port runs
    replicated, and both write the files of the port's run without the
    flag; under a budget below the port's footprint, one error line."""
    src, tgt, _, _, _ = _corpus(toy_fixture)
    cfg = DEFAULT_CONFIG
    args = (src.toklen, tgt.toklen, cfg.qry_max_length, cfg.max_rule_span)
    need, jax_need = (bd.replicated_footprint_bytes(*args),
                      jbd.replicated_footprint_bytes(*args))
    assert need < jax_need
    files = _cli_files(toy_fixture)
    assert cli.main(["--device", "cpu"] + files + [str(tmp_path / "one")]) \
        == 0
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(_mb((need + jax_need) / 2)))
    assert jbd.resolve_shards("auto", *args[:2], cfg) >= 2
    assert jcli.main(["--sa-shards", "auto"] + files
                     + [str(tmp_path / "jax")]) == 0
    built = []
    monkeypatch.setattr(shx, "build_sharded_index",
                        lambda *a: built.append(a))
    assert cli.main(["--device", "cpu", "--sa-shards", "auto"] + files
                    + [str(tmp_path / "auto")]) == 0
    assert built == []
    names = sorted(p.name for p in (tmp_path / "one").iterdir())
    assert len(names) == 8
    for out in ("jax", "auto"):
        assert sorted(p.name for p in (tmp_path / out).iterdir()) == names
        for name in names:
            assert (tmp_path / out / name).read_bytes() == \
                (tmp_path / "one" / name).read_bytes(), (out, name)
    monkeypatch.setenv("CGX_DEVICE_MEM_MB", str(_mb(need - 64)))
    capsys.readouterr()
    assert cli.main(["--device", "cpu", "--sa-shards", "auto"] + files
                    + [str(tmp_path / "refused")]) == 1
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "item 10b" in err[0]
    assert not (tmp_path / "refused").exists()
