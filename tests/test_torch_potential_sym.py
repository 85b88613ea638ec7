"""The schedule of `pair_potential`'s kernels on the CPU (csrc/direct.cu:
each unordered pair once, the half ring in bands, a join in a fixed
order): `energy.potential_bands` against the kernel's rule for the offset
B/2 (`tests/potential_sym.py: band_tiles`), every unordered block pair
exactly once and no slot written twice in a launch; a CPU call launching
no kernel; the schedule emulated in PyTorch (`potential_sym.emulate`)
against `pair_potential_plain` and,
in float64, `spacetpu.ops.energy.potential_energy`, at eps = 0 with a
coincident pair and a pair at d^2 = 1e-40; two wrong versions of it that
the float32 hold must refuse; and the instance whose SASS chip_smoke.py
reads. The kernels themselves run only on the card
(tests/test_torch_gpu.py)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu.ops import energy as jenergy
from spacetpu_torch.ops import energy
from tests import potential_sym
from tests.parity import one_torch_thread  # noqa: F401

DIRECT_CU = (pathlib.Path(energy.__file__).resolve().parents[1] / "csrc"
             / "direct.cu").read_text()

#: each body's sum against the plain version's, relative to itself (every
#: term is >= 0): chip_smoke.POTENTIAL_TOL
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}

#: the emulation's blocks: 64 rows, bands of at most 3 offsets
ROWS, SLOTS = 64, 3


def _pairs(nblk, bands):
    """Every tile pair of the bands, as sorted (I, J) codes, and the
    (launch, slot, J) codes of the column partials."""
    tiles, writes = [], []
    for launch, (lo, hi) in enumerate(bands):
        i, j, slot = potential_sym.band_tiles(nblk, lo, hi)
        tiles.append(np.minimum(i, j) * nblk + np.maximum(i, j))
        writes.append((launch * nblk + slot) * nblk + j)
        assert (i != j).all() and (slot < hi - lo + 1).all()
    if not tiles:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(tiles), np.concatenate(writes)


@pytest.mark.parametrize("slots", [1, 3, 16])
@pytest.mark.parametrize("nblk", [1, 2, 3, 4, 5, 10, 1954])
def test_bands_take_every_block_pair_once(nblk, slots):
    """N = 512 B - 7 bodies: the bands cover the offsets 1 .. B // 2 in
    order, at most `slots` wide, and their tile pairs are every unordered
    pair of distinct blocks exactly once."""
    n = 512 * nblk - 7
    bands = energy.potential_bands(n, 512, slots)
    offsets = [d for lo, hi in bands for d in range(lo, hi + 1)]
    assert offsets == list(range(1, nblk // 2 + 1))
    assert all(1 <= hi - lo + 1 <= slots for lo, hi in bands)
    tiles, _ = _pairs(nblk, bands)
    assert len(tiles) == nblk * (nblk - 1) // 2
    assert len(np.unique(tiles)) == len(tiles)
    assert potential_sym.launches_per_call(n, 512, slots) == (
        1 if nblk == 1 else len(bands) + 2)


@pytest.mark.parametrize("nblk", [2, 3, 4, 5, 10, 1954])
def test_no_slot_is_written_twice_in_a_launch(nblk):
    """Within one launch, column block J of slot s has one writer (block
    J - d), and block I's rows one (block I)."""
    bands = energy.potential_bands(512 * nblk - 7, 512, 16)
    _, writes = _pairs(nblk, bands)
    assert len(np.unique(writes)) == len(writes)
    for lo, hi in bands:
        i, _, slot = potential_sym.band_tiles(nblk, lo, hi)
        # a block's tile pairs in a launch: one a slot
        assert len(np.unique(i * 16 + slot)) == len(i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_cpu_call_launches_no_kernel(dtype):
    """A CPU tensor takes the plain version: one call of the wrapper counts
    neither a call nor a kernel launch."""
    pos, mass = _case(50, dtype, None)
    calls = energy.LAUNCHES["pair_potential"]
    kernels = energy.KERNEL_LAUNCHES["pair_potential_kernels"]
    got = energy.pair_potential(pos, mass, eps=1e-2)
    assert torch.equal(got, energy.pair_potential_plain(pos, mass, eps=1e-2))
    assert energy.LAUNCHES["pair_potential"] == calls
    assert energy.KERNEL_LAUNCHES["pair_potential_kernels"] == kernels


def _case(n, dtype, close):
    if close:
        return potential_sym.close_pairs_case(n, ROWS, dtype, "cpu",
                                              seed=n, across=close == "across")
    rng = np.random.default_rng(n)
    return (torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=dtype),
            torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=dtype))


CASES = [("plummer", 1e-2, 1000, None), ("plummer", 0.0, 1000, "across"),
         ("plummer", 0.0, 900, "inside"), ("ref", 0.0, 1000, "across"),
         ("ref", 1e-2, 50, None), ("plummer", 1e-2, 900, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("softening,eps,n,close", CASES)
def test_emulated_schedule_matches_plain(softening, eps, n, close, dtype):
    """N = 1000 (16 blocks of 64: the offset B/2 = 8 taken once), 900 (15
    blocks, odd) and 50 (one block): each body's sum within the hold of
    the plain version's; at eps = 0 a coincident pair adds 0 and a d^2 of
    1e-40 takes the clamp, in two blocks or in one."""
    pos, mass = _case(n, dtype, close)
    got = potential_sym.emulate(pos, mass, softening=softening, eps=eps,
                                rows=ROWS, slots=SLOTS)
    want = energy.pair_potential_plain(pos, mass, softening=softening,
                                       eps=eps)
    assert bool(torch.isfinite(got).all())
    assert float(((got - want).abs() / want.abs()).max()) <= TOL[dtype]
    if close:
        # the pair 1e-20 apart: each sees the other at rsqrt(1e-38)
        assert float(got[3]) > 1e18


@pytest.mark.parametrize("softening,eps,n,close", CASES[:4])
def test_emulated_schedule_matches_jax_in_float64(softening, eps, n, close):
    """-G/2 sum_i m_i (the per-body sums) against the JAX package's
    potential energy, rtol 1e-12."""
    pos, mass = _case(n, torch.float64, close)
    got = potential_sym.emulate(pos, mass, softening=softening, eps=eps,
                                rows=ROWS, slots=SLOTS)
    want = jenergy.potential_energy(jnp.asarray(pos.numpy()),
                                    jnp.asarray(mass.numpy()),
                                    softening=softening, eps=eps, g=1.0)
    np.testing.assert_allclose(-0.5 * float(torch.sum(mass * got)),
                               float(want), rtol=1e-12)


@pytest.mark.parametrize("wrong", ["no_columns", "half_twice"])
def test_wrong_schedules_fail_the_float32_hold(wrong):
    """Dropping the column halves, or taking the offset B/2 for every block
    of an even B (16 blocks), leaves the hold by far."""
    pos, mass = _case(1000, torch.float32, None)
    kw = dict(softening="plummer", eps=1e-2)
    want = energy.pair_potential_plain(pos, mass, **kw)
    got = potential_sym.emulate(pos, mass, rows=ROWS, slots=SLOTS,
                                wrong=wrong, **kw)
    assert float(((got - want).abs() / want.abs()).max()) > 100 * TOL[
        torch.float32]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         DIRECT_CU).group(1))


def test_smoke_reads_the_band_kernel():
    """chip_smoke.py reads the SASS of the band kernel the headless path
    runs (float32, eps = 0: the MUFU rsqrt alone with a chunk's check, no
    eps^2 to add), whose loop takes POT_UNROLL columns a trip against a
    lane's POT_P rows, one MUFU a pair; its sweep again with the guard
    takes one column a trip, so `sass_loops` looks for a trip of P U MUFU
    (`LOOP_MUFU`)."""
    p, w, u = (_constant(k) for k in ("POT_P", "POT_WARPS", "POT_UNROLL"))
    assert p % w == 0 and u > 1
    assert chip_smoke.MAIN_INSTANCES["pair_potential"] == (
        f"potential_band_kernelIfLi{p}ELi{w}ELi{_constant('POT_CHECKED')}"
        f"ELb0EE")
    assert chip_smoke.PAIRS_PER_LOOP["pair_potential"] == p * u
    assert chip_smoke.LOOP_MUFU["pair_potential"] == p * u
