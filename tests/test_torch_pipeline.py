"""End to end: the port's grammars equal the JAX package's grammars without the
two-gap family aXbXc, byte for byte and in order; the CLI writes them; the
port imports without JAX."""

import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.preproc import corpus as jcp  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402

ROOT = pathlib.Path(__file__).parent.parent


def not_axbxc(line: str) -> bool:
    """False for the two-gap family aXbXc: a source side with exactly two
    [X,k] tokens whose first and last tokens are terminals."""
    src = line.split(" ||| ")[1].split()
    nts = [w.startswith("[X,") for w in src]
    return not (sum(nts) == 2 and not nts[0] and not nts[-1])


def _inputs(name, request):
    if name == "hard":
        sys.path.insert(0, str(ROOT))
        from tools.make_bigcorpus import make_big_queries, make_hard_corpus
        f, e, a, lex_t = make_hard_corpus(400, vocab=200, seed=11)
        return (f.split("\n"), e.split("\n"), a, lex_t,
                make_big_queries(f, 6, seed=3))
    d = request.getfixturevalue(f"{name}_fixture")
    return (jcp.read_lines(str(d / "corpus.f")), jcp.read_lines(str(d / "corpus.e")),
            jcp.read_lines(str(d / "corpus.a")), jcp.read_tokens(str(d / "lex.txt")),
            jcp.read_lines(str(d / "query.f")))


_JAX_LINES = {}


def jax_lines(name, sample, request):
    """The JAX package's per-query lines without aXbXc (cached per module)."""
    key = (name, sample)
    if key not in _JAX_LINES:
        res = jpl.run_pipeline(*_inputs(name, request),
                               JaxConfig(is_sample=sample))
        _JAX_LINES[key] = [[ln for ln in q if not_axbxc(ln)]
                           for q in res.per_query_lines]
    return _JAX_LINES[key]


@pytest.mark.parametrize("name,sample", [("toy", True), ("toy", False),
                                         ("real", True), ("hard", True)])
def test_pipeline_equals_jax_block_lines(name, sample, request):
    """The name is kept from when the port wrote the block-derived families
    alone; it now covers every family but aXbXc."""
    want = jax_lines(name, sample, request)
    got = tpl.run_pipeline(*_inputs(name, request),
                           ExtractorConfig(is_sample=sample), device="cpu")
    assert len(got.per_query_lines) == len(want)
    for q, (g, w) in enumerate(zip(got.per_query_lines, want)):
        assert g == w, f"query {q}: first diff at line " + str(next(
            (i for i, (a, b) in enumerate(zip(g, w)) if a != b),
            min(len(g), len(w))))
    assert got.counters["total_lines"] == sum(map(len, want)) > 100
    assert got.timing.peak_memory() == -1     # no device ledger on the CPU


def _cli_args(d, out, extra=()):
    return list(extra) + [str(d / "corpus.f"), str(d / "query.f"),
                          str(d / "corpus.e"), str(d / "corpus.a"),
                          str(d / "lex.txt"), str(out)]


@pytest.mark.parametrize("sample", [True, False])
def test_cli_writes_block_grammars(toy_fixture, tmp_path, request, sample):
    extra = ["--device", "cpu"] + ([] if sample else ["--no-sample"])
    timefile = tmp_path / "times"
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "g",
                            extra + ["-s", str(timefile)]))
    assert rc == 0
    want = jax_lines("toy", sample, request)
    suffix = "s" if sample else "n"
    files = sorted((tmp_path / "g").glob("grammar.*"))
    assert len(files) == len(want)
    for q, lines in enumerate(want):
        body = (tmp_path / "g" / f"grammar.{q}.{suffix}").read_bytes()
        assert body == ("\n".join(lines) + "\n" if lines else "").encode()
    assert timefile.read_text().startswith("wall: ")


def test_cli_rejects_bad_arguments(toy_fixture, tmp_path):
    assert cli.main(_cli_args(toy_fixture, tmp_path / "g",
                              ["-t", "0", "--device", "cpu"])) == 1
    assert cli.main(["/nonexistent.f", "/nonexistent.q", "/nonexistent.e",
                     "/nonexistent.a", "/nonexistent.l",
                     str(tmp_path / "g")]) == 1
    with pytest.raises(SystemExit):
        cli.main(_cli_args(toy_fixture, tmp_path / "g", ["--device", "tpu"]))


def test_cli_cuda_without_a_card_raises(toy_fixture, tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_cli_args(toy_fixture, tmp_path / "g"))
    assert not (tmp_path / "g").exists()


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import cgx_tpu_torch.pipeline, cgx_tpu_torch.cli, "
            "cgx_tpu_torch.search.precompute, cgx_tpu_torch.search.lookup; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'cgx_tpu') "
            "and sys.modules[m] is not None); "
            "print('LEAK' if bad else 'CLEAN', bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CLEAN"), out.stdout
