"""Edge cases of the port on the CPU (plain versions): the edge world of
test_edge_cases.py (an empty query, an all-OOV query, a 250-token sentence,
an exact corpus sentence) against the JAX package under every path the port
runs, the degenerate batches against the oracle, and a capacity overflow.

The JAX ``run_pipeline`` fails on a batch where no query yields a
contiguous rule (all empty or OOV) and on one with no one-gap pattern, so the
oracle (``cgx_tpu.oracle``, also a reference) is held against the port
there."""

import pytest

torch = pytest.importorskip("torch")

from cgx_tpu import pipeline as jpl  # noqa: E402
from cgx_tpu.config import ExtractorConfig as JaxConfig  # noqa: E402
from cgx_tpu.oracle import pipeline as opl  # noqa: E402
from cgx_tpu_torch import pipeline as tpl  # noqa: E402
from cgx_tpu_torch.config import CapacityError, ExtractorConfig  # noqa: E402
from test_edge_cases import _world  # noqa: E402

# mode -> (the JAX package's environment knob, its sa_shards; the port's
# run_pipeline keywords)
MODES = {
    "default": (None, 0, {}),
    "lcp_passes": ("CGX_LCP_PASSES", 0, {"lcp_passes": True}),
    "scan_cols": ("CGX_SCAN_COLS", 0, {"scan_cols": True}),
    "sa_shards=1": (None, 1, {"sa_shards": 1}),
    "sa_shards=3": (None, 3, {"sa_shards": 3}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_edge_world_equals_jax(mode, monkeypatch):
    """Every query's lines and every JAX counter, the empty and all-OOV
    queries with empty grammars."""
    knob, shards, kw = MODES[mode]
    if knob:
        monkeypatch.setenv(knob, "1")
    args = _world()
    want = jpl.run_pipeline(*args, JaxConfig(precompute_count=10),
                            sa_shards=shards)
    got = tpl.run_pipeline(*args, ExtractorConfig(precompute_count=10),
                           device="cpu", **kw)
    assert got.per_query_lines == want.per_query_lines
    assert {k: got.counters[k] for k in want.counters} == want.counters
    assert got.per_query_lines[1] == [] and got.per_query_lines[2] == []
    assert len(got.per_query_lines[0]) > 0


def _degenerate(kind):
    """The edge world's corpus with a batch of only empty and OOV queries,
    or of queries too short for a one-gap pattern (1 and 2 tokens)."""
    f, e, a, lex, _ = _world()
    if kind == "empty_or_oov":
        q = ["", "zz1 zz2 zz3", ""]
    else:
        q = [f[0].split()[0], " ".join(f[1].split()[:2]),
             " ".join(f[7].split()[:2])]
    return f, e, a, lex, q


@pytest.mark.parametrize("kind", ["empty_or_oov", "no_onegap_pattern"])
def test_degenerate_batch_equals_oracle(kind):
    args = _degenerate(kind)
    want = opl.run_oracle(*args, JaxConfig(precompute_count=10))
    got = tpl.run_pipeline(*args, ExtractorConfig(precompute_count=10),
                           device="cpu")
    assert got.per_query_lines == want.per_query_lines
    if kind == "empty_or_oov":
        assert all(q == [] for q in got.per_query_lines)
    else:
        assert got.counters["onegap_sa"] == 0
        assert sum(map(len, got.per_query_lines)) > 0


def test_capacity_overflow_names_the_stage():
    """A cap that is exceeded raises, naming its stage; nothing is cut."""
    with pytest.raises(CapacityError, match="onegap_enum"):
        tpl.run_pipeline(*_world(), ExtractorConfig(precompute_count=10,
                                                    cap_onegap_enum=1),
                         device="cpu")
