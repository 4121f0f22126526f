"""End to end: the port's grammars equal the JAX package's grammars byte for
byte and in order, with either pass-1/2 search; the CLI writes them; the port
imports without JAX and builds nothing from the JAX package's files.

    python tests/test_torch_pipeline.py --goldens

rewrites tests/golden_torch_hashes.json from the JAX package's runs on the
CPU (medium, large and europarl; several minutes).
"""

import json
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


def jax_run(name, sample, request):
    """The JAX package's run on the CPU (cached per module)."""
    key = (name, sample)
    if key not in _JAX_LINES:
        _JAX_LINES[key] = jpl.run_pipeline(*_inputs(name, request),
                                           JaxConfig(is_sample=sample))
    return _JAX_LINES[key]


def jax_lines(name, sample, request):
    """The JAX package's per-query lines, every family."""
    return jax_run(name, sample, request).per_query_lines


def _assert_same_grammar(got, want):
    assert len(got.per_query_lines) == len(want)
    for q, (g, w) in enumerate(zip(got.per_query_lines, want)):
        assert g == w, f"query {q}: first diff at line " + str(next(
            (i for i, (a, b) in enumerate(zip(g, w)) if a != b),
            min(len(g), len(w))))
    assert got.counters["total_lines"] == sum(map(len, want)) > 100


@pytest.mark.parametrize("name,sample", [("toy", True), ("toy", False),
                                         ("real", True), ("hard", True)])
def test_pipeline_equals_jax_block_lines(name, sample, request):
    """The name is kept from when the port wrote the block-derived families
    alone; it now covers every family, aXbXc included, and every JAX
    counter."""
    jres = jax_run(name, sample, request)
    got = tpl.run_pipeline(*_inputs(name, request),
                           ExtractorConfig(is_sample=sample), device="cpu")
    _assert_same_grammar(got, jres.per_query_lines)
    for k, v in jres.counters.items():
        assert got.counters[k] == v, k
    assert got.counters["twogap_sa"] > 0
    assert any(len([w for w in ln.split(" ||| ")[1].split()
                    if w.startswith("[X,")]) == 2
               for q in got.per_query_lines for ln in q)
    assert got.timing.peak_memory() == -1     # no device ledger on the CPU


@pytest.mark.parametrize("name", ["toy", "real", "hard"])
def test_pipeline_lcp_passes_equals_jax(name, request):
    """The LCP pass-1/2 search gives the same grammar as the refinement."""
    want = jax_lines(name, True, request)
    got = tpl.run_pipeline(*_inputs(name, request), ExtractorConfig(),
                           device="cpu", lcp_passes=True)
    _assert_same_grammar(got, want)
    assert "kernel2" in got.timing.as_dict()


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


def test_native_source_lies_in_the_port():
    from cgx_tpu_torch.preproc import native_build
    src = pathlib.Path(native_build._SRC).resolve()
    assert src.is_file()
    assert src.is_relative_to((ROOT / "cgx_tpu_torch").resolve())
    assert pathlib.Path(native_build.BUILD_DIR).resolve().is_relative_to(
        (ROOT / "build").resolve())


def test_goldens_are_the_bench_hashes():
    """The full grammars the smoke run holds the port to are the JAX
    package's benchmark hashes."""
    with open(ROOT / "tests" / "golden_torch_hashes.json") as fh:
        golden = json.load(fh)
    with open(ROOT / "tests" / "golden_bench_hashes.json") as fh:
        bench = json.load(fh)
    for size in ("medium", "large", "europarl"):
        assert golden[size]["sha256"] == bench[f"bench_{size}"], size


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import cgx_tpu_torch.pipeline, cgx_tpu_torch.cli, "
            "cgx_tpu_torch.search.precompute, cgx_tpu_torch.search.lookup, "
            "cgx_tpu_torch.parallel.sharded, cgx_tpu_torch.engine, "
            "cgx_tpu_torch.parallel.dist, "
            "cgx_tpu_torch.tools.gather_probe, cgx_tpu_torch.serve, "
            "cgx_tpu_torch.oracle.pipeline, "
            "cgx_tpu_torch.preproc.index_io, cgx_tpu_torch.parallel.localdp, "
            "cgx_tpu_torch.parallel.multihost, cgx_tpu_torch.utils.budget; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'cgx_tpu') "
            "and sys.modules[m] is not None); "
            "print('LEAK' if bad else 'CLEAN', bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("CLEAN"), out.stdout


def write_goldens(path=ROOT / "tests" / "golden_torch_hashes.json"):
    """The JAX package's grammar hash, line count and counters per size."""
    sys.path.insert(0, str(ROOT))
    import bench
    from cgx_tpu.config import DEFAULT_CONFIG
    golden = {"recipe": (
        "bench.grammar_hash over the per-query lines of the JAX package's "
        "run_pipeline on the CPU; corpora from bench.build_corpus with "
        "DEFAULT_CONFIG; the other keys are that run's counters and line "
        "count (python tests/test_torch_pipeline.py --goldens)")}
    for size in ("medium", "large", "europarl"):
        res = jpl.run_pipeline(*bench.build_corpus(size, *bench.SIZES[size]),
                               DEFAULT_CONFIG)
        c = res.counters
        golden[size] = dict(
            sha256=bench.grammar_hash(res.per_query_lines),
            lines=c["total_lines"],
            **{k: c[k] for k in ("blocks", "contig_pairs", "distinct_onegap",
                                 "onegap_sa", "distinct_twogap", "twogap_sa",
                                 "twogap_rules")})
        print(size, golden[size], flush=True)
    with open(path, "w") as fh:
        json.dump(golden, fh, indent=1, sort_keys=True)


if __name__ == "__main__" and sys.argv[1:] == ["--goldens"]:
    write_goldens()
