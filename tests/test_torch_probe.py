"""The gather probe in the port (``cgx_tpu_torch.tools.gather_probe``):
kernels P1's and P2's plain versions against ``tools/pallas_probe.py``, its
``xla_gather`` and its two Pallas kernels run in interpret mode, on the
probe's own data (``default_rng(0)``), a sum that wraps int32, and the
512-item multiple the probe's grid needs; and a Python copy of the
kernels' persistent walk (``csrc/probe.cu``), which takes every item once
on every grid and whose blocks' partials give the checksum in any
order."""

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


def _walk(n, blocks):
    """A copy of the walk of ``csrc/probe.cu`` (``walk``) on ``blocks``
    blocks -> (block, the items of one round of a warp) in the kernels'
    order: warp w of block b takes chunks b * WARPS + w, + blocks * WARPS,
    ... of 32 items, and each chunk IN_FLIGHT items a round (the windows it
    loads before it uses one), the last chunk cut at n."""
    chunks = -(-n // gp.W)
    for b in range(blocks):
        for w in range(gp.WARPS):
            for c in range(b * gp.WARPS + w, chunks, blocks * gp.WARPS):
                base = c * gp.W
                for k0 in range(0, min(gp.W, n - base), gp.IN_FLIGHT):
                    yield b, range(base + k0,
                                   min(base + k0 + gp.IN_FLIGHT, n))


# the H100's 132 SMs' resident blocks, and grids below and above the items
GRIDS = (1, 2, 3, 7, 132 * gp.BLOCKS_PER_SM)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 257, 512, 700, 1536, 4113])
def test_walk_visits_every_item_once(n):
    """On every grid the kernels launch (``grid``: capped by the blocks
    whose warps have a chunk), the walk takes each item exactly once, in
    rounds of at most IN_FLIGHT items of one chunk."""
    for blocks in GRIDS:
        g = gp.grid(n, blocks)
        assert 1 <= g <= blocks and (g - 1) * gp.WARPS * gp.W < n
        seen = []
        for _, items in _walk(n, g):
            assert 1 <= len(items) <= gp.IN_FLIGHT
            assert items[0] // gp.W == items[-1] // gp.W
            seen.extend(items)
        assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("seed", [0, 1])
def test_walk_partials_in_any_order_equal_the_checksum(seed):
    """P1's blocks' partials (unsigned sums of their warps' windows, mod
    2^32), added in any order, give ``gather_sum_plain``'s and
    ``xla_gather``'s checksum, on every grid; the words wrap int32, and
    windows run past the corpus end (not before its start: a JAX gather
    wraps a negative index, ROADMAP C)."""
    rng = np.random.default_rng(seed)
    n, corpus = 1536, 3000
    ref = rng.integers(2**30, 2**31 - 1, corpus).astype(np.int32)
    pos = rng.integers(0, corpus + 8, n).astype(np.int32)
    pos[:32] = np.arange(corpus - 32, corpus)
    rows = np.clip(pos[:, None].astype(np.int64) + np.arange(gp.W), 0,
                   corpus - 1)
    win = ref[rows].astype(np.uint32)
    want = int(gp.gather_sum_plain(torch.from_numpy(ref),
                                   torch.from_numpy(pos)))
    assert want == int(pp.xla_gather(jnp.asarray(ref), jnp.asarray(pos)))
    for blocks in GRIDS:
        g = gp.grid(n, blocks)
        part = np.zeros(g, np.uint32)
        for b, items in _walk(n, g):
            part[b] += win[list(items)].sum(dtype=np.uint32)
        total = rng.permutation(part).sum(dtype=np.uint32)
        assert int(total.astype(np.int32)) == want


def test_grid_caps_the_blocks_at_the_items():
    assert gp.grid(1, 1056) == gp.grid(256, 1056) == 1
    assert gp.grid(257, 1056) == 2
    assert gp.grid(1536, 1056) == 1536 // (gp.W * gp.WARPS)
    assert gp.grid(961_536, 1056) == 1056
    assert gp.grid(1536, 4) == 4 and gp.grid(1536, 0) == 1


def test_launch_refuses_cpu_tensors():
    """``launch`` is the kernels' entry: on CPU tensors it raises (the
    public wrappers take the plain versions there)."""
    ref = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gp.launch("P1", ref, torch.zeros(33, dtype=torch.int32))
