"""``run_pipeline_overlap`` (``--query-batches``) on the CPU: each query's
lines equal the single-batch run's (tests/test_edge_cases.py:65-74 on the
port), its per-batch counters equal the JAX package's, its back half scores
MaxLex on the host, the phase timer takes phases from two threads, and the
CLI's ``--query-batches`` and ``--profile``."""

import hashlib
import json
import pathlib
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu_torch import cli  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import ExtractorConfig  # noqa: E402
from cgx_tpu_torch.index import container as ic  # noqa: E402
from cgx_tpu_torch.preproc import corpus as cp  # noqa: E402
from cgx_tpu_torch.utils.timing import PhaseTimer  # noqa: E402
from test_edge_cases import _world  # noqa: E402

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_toy_hashes.json").read_text())


def test_overlap_on_the_edge_world_equals_one_batch_and_jax():
    cfg = dict(precompute_count=10)
    args = _world()
    base = tpl.run_pipeline(*args, ExtractorConfig(**cfg), device="cpu")
    ov = tpl.run_pipeline_overlap(*args, ExtractorConfig(**cfg), device="cpu",
                                  query_batches=3)
    assert ov.per_query_lines == base.per_query_lines
    assert ov.counters["total_lines"] == base.counters["total_lines"] > 0
    assert ov.counters["query_batches"] == 3
    assert ov.counters["precomp_rows"] == base.counters["precomp_rows"]
    want = jpl.run_pipeline_overlap(*args, JaxConfig(**cfg), query_batches=3)
    assert ov.per_query_lines == want.per_query_lines
    assert len(ov.counters["per_batch"]) == len(want.counters["per_batch"])
    for got, exp in zip(ov.counters["per_batch"], want.counters["per_batch"]):
        assert {k: got[k] for k in exp} == exp
    for k, v in want.counters.items():
        if k != "per_batch":
            assert ov.counters[k] == v, k


@pytest.mark.parametrize("batches,kw", [(2, {}), (3, {"sa_shards": 3}),
                                        (8, {"lcp_passes": True}),
                                        (50, {"scan_cols": True})],
                         ids=["2", "3,sa_shards=3", "8,lcp_passes",
                              "50,scan_cols"])
def test_overlap_on_the_toy_gives_the_golden(toy_fixture, batches, kw):
    d = toy_fixture
    args = (cp.read_lines(str(d / "corpus.f")), cp.read_lines(str(d / "corpus.e")),
            cp.read_lines(str(d / "corpus.a")), cp.read_tokens(str(d / "lex.txt")),
            cp.read_lines(str(d / "query.f")))
    res = tpl.run_pipeline_overlap(
        *args, ExtractorConfig(precompute_count=GOLDEN["precompute_count"]),
        device="cpu", query_batches=batches, **kw)
    for q, lines in enumerate(res.per_query_lines):
        h = hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()
        assert h == GOLDEN["sha256"][str(q)], f"query {q}"
    assert res.counters["query_batches"] == min(batches, 8)
    assert res.counters["total_lines"] == sum(
        c["total_lines"] for c in res.counters["per_batch"])


def test_overlap_back_half_scores_on_the_host(monkeypatch):
    """The worker thread's MaxLex gets a HostLexIndex (no A9 or A10 on the
    card) and its host phases ask the timer for no device synchronise."""
    seen = []
    real_back = tpl._back_stages

    def spy(ctx, *a):
        seen.append((threading.current_thread() is threading.main_thread(),
                     type(ctx["lex_index"])))
        return real_back(ctx, *a)
    monkeypatch.setattr(tpl, "_back_stages", spy)
    synced = []
    real_phase = PhaseTimer.phase

    def phase(self, name, sync=True):
        synced.append((name, sync))
        return real_phase(self, name, sync)
    monkeypatch.setattr(PhaseTimer, "phase", phase)
    tpl.run_pipeline_overlap(*_world(), ExtractorConfig(precompute_count=10),
                             device="cpu", query_batches=2)
    assert seen == [(False, ic.HostLexIndex)] * 2
    host = {n for n, s in synced if not s}
    assert host == {"lexicon", "maxlex", "printout"}
    assert all(s for n, s in synced if n not in host)


def test_phase_timer_counts_every_addition(monkeypatch):
    """Phases timed from more threads than cores lose no update: with each
    thread's clock stubbed to advance 1 s a read, every phase adds exactly
    1 s to its bucket."""
    local = threading.local()

    def tick():
        local.now = getattr(local, "now", 0.0) + 1.0
        return local.now
    monkeypatch.setattr("cgx_tpu_torch.utils.timing.time.perf_counter", tick)
    t = PhaseTimer("cpu")
    n_threads, n_phases = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_phases):
                with t.phase("host", sync=False):
                    pass
                with t.phase("device"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert t.as_dict() == {"host": n_threads * n_phases,
                           "device": n_threads * n_phases}
    assert t.peak_memory() == -1


def _cli_args(d, out, extra=()):
    return list(extra) + [str(d / "corpus.f"), str(d / "query.f"),
                          str(d / "corpus.e"), str(d / "corpus.a"),
                          str(d / "lex.txt"), str(out)]


def test_cli_query_batches_and_profile(toy_fixture, tmp_path):
    """--query-batches writes the one-batch grammars; --profile writes a
    torch.profiler trace (CPU activity here) under its dir."""
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "one", ["--device", "cpu"]))
    assert rc == 0
    prof = tmp_path / "prof"
    rc = cli.main(_cli_args(toy_fixture, tmp_path / "four",
                            ["--device", "cpu", "--query-batches", "4",
                             "--profile", str(prof)]))
    assert rc == 0
    a = sorted((tmp_path / "one").glob("grammar.*"))
    b = sorted((tmp_path / "four").glob("grammar.*"))
    assert len(a) == 8
    assert [p.read_bytes() for p in a] == [p.read_bytes() for p in b]
    trace = json.loads((prof / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_overlap_without_queries():
    """An empty query list gives no batch and no lines (the JAX copy's
    batch split fails there on a zero range step)."""
    f, e, a, lex, _ = _world()
    res = tpl.run_pipeline_overlap(f, e, a, lex, [],
                                   ExtractorConfig(precompute_count=10),
                                   device="cpu", query_batches=3)
    assert res.per_query_lines == [] and res.queries.qryscount == 0
    assert res.counters["query_batches"] == 0
    assert res.counters["per_batch"] == []
