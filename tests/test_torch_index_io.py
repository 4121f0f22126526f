"""The persisted corpus index (``cgx_tpu_torch/preproc/index_io.py``): the
round trip, directories that either package writes and the other loads,
loaded runs under every path of the port, and the CLI's ``--index-dir`` and
``--build-index-only`` (tests/test_cli.py:37-68 on the port).  Grammars are
held to the toy golden (tests/golden_toy_hashes.json) byte for byte."""

import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.preproc import index_io  # noqa: E402

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_toy_hashes.json").read_text())
CFG = dict(precompute_count=GOLDEN["precompute_count"])


def _inputs(d):
    return (cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))


def _assert_golden(per_query_lines):
    assert len(per_query_lines) == len(GOLDEN["sha256"])
    for q, lines in enumerate(per_query_lines):
        h = hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()
        assert h == GOLDEN["sha256"][str(q)], f"query {q}"


@pytest.fixture(scope="module")
def port_dir(toy_fixture, tmp_path_factory):
    """A toy index dir written by the port's build_artifact (CPU)."""
    d = tmp_path_factory.mktemp("port_idx")
    res = tpl.run_pipeline(*_inputs(toy_fixture), ExtractorConfig(**CFG),
                           device="cpu", index_dir=str(d))
    assert "indexsave" in res.timing.as_dict()
    _assert_golden(res.per_query_lines)
    return d


def _arrays_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), \
                f"{what}.{f.name}"
        elif dataclasses.is_dataclass(x):      # a Vocab
            assert dataclasses.asdict(x) == dataclasses.asdict(y), \
                f"{what}.{f.name}"
        else:
            assert x == y, f"{what}.{f.name}"


def test_round_trip_keeps_every_array_and_the_meta(toy_fixture, tmp_path):
    cfg = ExtractorConfig(**CFG)
    art, _, t = tpl.build_artifact(*_inputs(toy_fixture)[:4], cfg,
                                   device="cpu", index_dir=str(tmp_path))
    assert isinstance(art, index_io.CorpusIndexArtifact)
    assert tpl.Artifact is index_io.CorpusIndexArtifact
    assert {"refsin", "precompute", "indexsave"} <= set(t.as_dict())
    got, built_cfg = index_io.load(str(tmp_path))
    assert built_cfg == cfg
    for name in ("source", "target", "align", "lex", "sa", "precomp"):
        _arrays_equal(getattr(art, name), getattr(got, name), name)
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["format_version"] == index_io.FORMAT_VERSION == 1
    assert meta["precomp_count"] == art.precomp.count > 0
    # a second save of the loaded artifact writes the same meta and arrays
    index_io.save(str(tmp_path / "again"), got, built_cfg)
    assert json.loads((tmp_path / "again" / "meta.json").read_text()) == meta
    z0 = np.load(tmp_path / "arrays.npz")
    z1 = np.load(tmp_path / "again" / "arrays.npz")
    assert sorted(z0.files) == sorted(z1.files)
    for k in z0.files:
        assert np.array_equal(z0[k], z1[k]), k


def test_jax_index_dir_loads_in_the_port(toy_fixture, tmp_path):
    """A dir written by the JAX package's build_artifact gives the port the
    toy golden, with no corpus parsed and no precompute run."""
    jpl.build_artifact(*_inputs(toy_fixture)[:4], JaxConfig(**CFG),
                       index_dir=str(tmp_path))
    res = tpl.run_pipeline(*_inputs(toy_fixture), ExtractorConfig(**CFG),
                           device="cpu", index_dir=str(tmp_path))
    phases = res.timing.as_dict()
    assert "indexload" in phases
    assert not {"refsin", "suffixarray", "precompute"} & set(phases)
    _assert_golden(res.per_query_lines)


def test_port_index_dir_loads_in_jax(toy_fixture, port_dir):
    res = jpl.run_pipeline(*_inputs(toy_fixture), JaxConfig(**CFG),
                           index_dir=str(port_dir))
    assert "indexload" in res.timing.buckets
    _assert_golden(res.per_query_lines)


@pytest.mark.parametrize("kw", [{}, {"lcp_passes": True}, {"scan_cols": True},
                                {"sa_shards": 3}],
                         ids=["default", "lcp_passes", "scan_cols",
                              "sa_shards=3"])
def test_loaded_runs_give_the_golden(toy_fixture, port_dir, kw):
    res = tpl.run_pipeline(*_inputs(toy_fixture), ExtractorConfig(**CFG),
                           device="cpu", index_dir=str(port_dir), **kw)
    phases = res.timing.as_dict()
    assert "indexload" in phases and "precompute" not in phases
    _assert_golden(res.per_query_lines)
    if kw.get("sa_shards"):
        assert res.index.S == 3


def test_loaded_run_uses_the_persisted_precompute(toy_fixture, port_dir):
    """As in the JAX package, the persisted precompute is used whatever
    config the query run asks for."""
    res = tpl.run_pipeline(*_inputs(toy_fixture),
                           ExtractorConfig(precompute_count=5), device="cpu",
                           index_dir=str(port_dir))
    assert res.counters["precomp_rows"] == json.loads(
        (port_dir / "meta.json").read_text())["precomp_count"]
    _assert_golden(res.per_query_lines)


def _cli_args(d, out, extra=(), qry=None):
    return list(extra) + [str(d / "corpus.f"), qry or str(d / "query.f"),
                          str(d / "corpus.e"), str(d / "corpus.a"),
                          str(d / "lex.txt"), str(out)]


def test_cli_build_index_only_then_query(toy_fixture, tmp_path):
    """--build-index-only persists a loadable artifact (no query file
    needed, ``wall:`` alone in the timefile); a later query run loads it
    and writes the fresh build's grammars."""
    idx = tmp_path / "idx"
    timefile = tmp_path / "times"
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "unused",
                            ["--device", "cpu", "--build-index-only",
                             "--index-dir", str(idx), "-s", str(timefile)],
                            qry="IGNORED_QUERY_FILE"))
    assert rc == 0
    assert (idx / "meta.json").exists() and (idx / "arrays.npz").exists()
    assert not (tmp_path / "unused").exists()
    line = timefile.read_text()
    assert line.startswith("wall: ") and line.count(",") == 0
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "g1",
                            ["--device", "cpu", "--index-dir", str(idx),
                             "-s", str(timefile)]))
    assert rc == 0
    assert "indexload" in timefile.read_text().splitlines()[1]
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "g2", ["--device", "cpu"]))
    assert rc == 0
    a = sorted((tmp_path / "g1").glob("grammar.*"))
    b = sorted((tmp_path / "g2").glob("grammar.*"))
    assert len(a) == 8
    assert [p.read_bytes() for p in a] == [p.read_bytes() for p in b]


def test_cli_build_index_only_requires_index_dir(toy_fixture, tmp_path):
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "g",
                            ["--device", "cpu", "--build-index-only"],
                            qry="q"))
    assert rc == 1
    # the query file is checked unless the run is build-only
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "g", ["--device", "cpu"],
                            qry=str(tmp_path / "missing.q")))
    assert rc == 1
