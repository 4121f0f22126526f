"""The gather probe in the port (``cgx_tpu_torch.tools.gather_probe``):
kernels P1's and P2's plain versions against ``tools/pallas_probe.py``, its
``xla_gather`` and its two Pallas kernels run in interpret mode, on the
probe's own data (``default_rng(0)``), a sum that wraps int32, and the
512-item multiple the probe's grid needs."""

import functools
import pathlib
import sys

import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
from tools import pallas_probe as pp  # noqa: E402
from cgx_tpu_torch.tools import gather_probe as gp  # noqa: E402


def _interpret(monkeypatch):
    """Run every ``pl.pallas_call`` in interpret mode on the CPU."""
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        functools.partial(orig, interpret=True))


def _data(n, corpus, seed=0):
    ref, pos = gp.probe_data(n, corpus, seed)
    return ref, pos, torch.from_numpy(ref), torch.from_numpy(pos)


@pytest.mark.parametrize("n,corpus,seed", [(512, 2048, 0), (1024, 4096, 0),
                                           (2048, 100_000, 7)])
def test_plain_p1_equals_xla_gather(n, corpus, seed):
    ref, pos, tref, tpos = _data(n, corpus, seed)
    want = int(pp.xla_gather(jnp.asarray(ref), jnp.asarray(pos)))
    got = gp.gather_sum(tref, tpos)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    assert int(gp.scalar_sum_plain(tref, tpos)) == int(
        pp.xla_scalar_gather(jnp.asarray(ref), jnp.asarray(pos)))


def test_plain_p2_rows_are_the_windows():
    """Row i is ref[pos[i]:pos[i] + 32]; the rows' checksum and the
    one-call library form agree with ``xla_gather``."""
    ref, pos, tref, tpos = _data(1536, 50_000, 3)
    rows = gp.gather_rows(tref, tpos)
    assert rows.dtype == torch.int32 and rows.shape == (1536, 32)
    want = np.stack([ref[p:p + 32] for p in pos])
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(gp.library_rows(tref, tpos).numpy(), want)
    assert int(gp.checksum(rows)) == int(pp.xla_gather(jnp.asarray(ref),
                                                       jnp.asarray(pos)))


def test_plain_p1_equals_pallas_gather_fn(monkeypatch):
    """P1 against the Pallas kernel itself, on positions below its last
    128-word row (beyond it the TPU kernel's 2-row block runs out of
    bounds)."""
    _interpret(monkeypatch)
    n, corpus = 1024, 4096
    ref, pos, tref, _ = _data(n, corpus)
    pos = pos % ((corpus // 128 - 1) * 128 - 32)
    want = int(pp.pallas_gather_fn(n, corpus)(jnp.asarray(ref),
                                              jnp.asarray(pos)))
    got = gp.gather_sum(tref, torch.from_numpy(pos))
    assert int(got) == want == int(pp.xla_gather(jnp.asarray(ref),
                                                 jnp.asarray(pos)))


def test_plain_p2_equals_pallas_pipelined_fn(monkeypatch):
    """P2's rows summed against the pipelined Pallas kernel's checksum, on
    the probe's data."""
    _interpret(monkeypatch)
    n, corpus = 1024, 4096
    ref, pos, tref, tpos = _data(n, corpus)
    want = int(pp.pallas_pipelined_fn(n, corpus, k_slots=4)(
        jnp.asarray(ref), jnp.asarray(pos)))
    assert int(gp.checksum(gp.gather_rows(tref, tpos))) == want


def test_sums_wrap_as_int32():
    """Words near 2**27: the exact sum exceeds 2**31 many times over, and
    both the JAX sum and the port's wrap to the same int32."""
    rng = np.random.default_rng(5)
    ref = rng.integers(2**27, 2**28, size=4096).astype(np.int32)
    pos = rng.integers(0, 4096 - 32, size=512).astype(np.int32)
    exact = int(sum(int(ref[p:p + 32].astype(np.int64).sum()) for p in pos))
    assert exact > 2**33
    want = int(pp.xla_gather(jnp.asarray(ref), jnp.asarray(pos)))
    assert want == (exact + 2**31) % 2**32 - 2**31
    tref, tpos = torch.from_numpy(ref), torch.from_numpy(pos)
    assert int(gp.gather_sum(tref, tpos)) == want
    assert int(gp.checksum(gp.gather_rows(tref, tpos))) == want


@pytest.mark.parametrize("fn", [gp.gather_sum, gp.gather_rows])
def test_item_count_must_be_a_multiple_of_512(fn):
    ref = torch.arange(4096, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 512"):
        fn(ref, torch.zeros(700, dtype=torch.int32))
    assert fn(ref, torch.zeros(0, dtype=torch.int32)).numel() in (0, 1)


def test_main_on_the_cpu(capsys):
    """The probe's command line on the plain versions: every checksum equal,
    exit code 0."""
    assert gp.main(["--device", "cpu", "--n", "1024", "--corpus", "4096",
                    "--reps", "1"]) == 0
    out = capsys.readouterr().out
    ref, pos = gp.probe_data(1024, 4096)
    want = int(pp.xla_gather(jnp.asarray(ref), jnp.asarray(pos)))
    lines = [ln for ln in out.splitlines() if "checksum" in ln]
    assert len(lines) == 5
    for ln in lines:
        if not ln.startswith("plain_scalar"):
            assert ln.endswith(f"checksum {want}"), ln


def test_main_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gp.main(["--n", "512", "--corpus", "4096"])
