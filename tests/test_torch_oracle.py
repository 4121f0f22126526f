"""The port's copy of the sequential oracle (``cgx_tpu_torch/oracle/``)
against ``cgx_tpu.oracle`` on the toy and the edge world: every stage's
arrays, the scored rule lists and the lines; the degenerate batches where
the JAX pipeline fails; and ``--engine oracle`` against ``--engine tpu
--device cpu`` on the toy (the verify recipe's ``diff -r``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.oracle import pipeline as jopl  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.oracle import pipeline as opl  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from test_edge_cases import _world  # noqa: E402
from test_torch_edge import _degenerate  # noqa: E402

STAGES = ("p1", "p2", "enum1", "search1", "onegap_sa", "enum2", "search2",
          "twogap_sa", "precomp", "blocks", "contig", "align", "sa")
RULES = ("rules_one", "rules_two", "rules_contig")


def _toy(d):
    return (cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))


def _same(a, b, what):
    """Field by field, arrays by dtype and value."""
    assert type(a).__name__ == type(b).__name__, what
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f"{what}.{f.name}"
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f.name}")
        else:
            assert x == y, f"{what}.{f.name}"


def _rule_rows(rules):
    return [tuple(np.asarray(v).tobytes() if isinstance(v, np.floating)
                  else v for v in dataclasses.astuple(r)) for r in rules]


def _assert_oracles_equal(args, cfg):
    want = jopl.run_oracle(*args, JaxConfig(**cfg))
    got = opl.run_oracle(*args, ExtractorConfig(**cfg))
    for name in STAGES:
        _same(getattr(got, name), getattr(want, name), name)
    for name in RULES:
        g, w = getattr(got, name), getattr(want, name)
        assert _rule_rows(g) == _rule_rows(w), name   # float32 bit for bit
    for name in ("ud_contig", "ud_one", "ud_two"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.sep_onegap, got.sep_twogap) == (want.sep_onegap,
                                                want.sep_twogap)
    assert got.per_query_lines == want.per_query_lines
    return got


def test_oracle_equals_jax_oracle_on_the_toy(toy_fixture):
    got = _assert_oracles_equal(_toy(toy_fixture), dict(precompute_count=30))
    assert len(got.twogap_sa.position) > 0
    assert sum(map(len, got.per_query_lines)) > 100


def test_oracle_equals_jax_oracle_on_the_edge_world():
    got = _assert_oracles_equal(_world(), dict(precompute_count=10))
    assert got.per_query_lines[1] == [] and got.per_query_lines[2] == []
    assert len(got.per_query_lines[0]) > 0


@pytest.mark.parametrize("kind", ["empty_or_oov", "no_onegap_pattern"])
def test_oracle_keeps_the_degenerate_batches(kind):
    """Where the JAX pipeline fails, both oracles and the port's pipeline
    write the same grammars."""
    args = _degenerate(kind)
    got = _assert_oracles_equal(args, dict(precompute_count=10))
    assert got.per_query_lines == tpl.run_pipeline(
        *args, ExtractorConfig(precompute_count=10),
        device="cpu").per_query_lines


def test_oracle_equals_the_pipeline_on_the_toy(toy_fixture):
    args = _toy(toy_fixture)
    cfg = ExtractorConfig(precompute_count=30, is_sample=False)
    assert opl.run_oracle(*args, cfg).per_query_lines == tpl.run_pipeline(
        *args, cfg, device="cpu").per_query_lines


def _cli_args(d, out, extra):
    return list(extra) + [str(d / "corpus.f"), str(d / "query.f"),
                          str(d / "corpus.e"), str(d / "corpus.a"),
                          str(d / "lex.txt"), str(out)]


def test_engine_oracle_writes_the_files_of_engine_tpu(toy_fixture, tmp_path,
                                                      monkeypatch):
    """``--engine oracle`` runs on the host whatever --device says (here
    the default, cuda, on a machine without a card) and writes the same
    files as ``--engine tpu --device cpu``; ``-s`` writes ``wall:`` alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    timefile = tmp_path / "times"
    assert cli.main(_cli_args(toy_fixture, tmp_path / "o",
                              ["--engine", "oracle", "-s",
                               str(timefile)])) == 0
    assert cli.main(_cli_args(toy_fixture, tmp_path / "t",
                              ["--engine", "tpu", "--device", "cpu"])) == 0
    o = sorted(p.name for p in (tmp_path / "o").iterdir())
    t = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert o == t and len(o) == 8
    for name in o:
        assert (tmp_path / "o" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    assert timefile.read_text().startswith("wall: ")
    assert "," not in timefile.read_text()
    with pytest.raises(SystemExit):
        cli.main(_cli_args(toy_fixture, tmp_path / "x", ["--engine", "gpu"]))
