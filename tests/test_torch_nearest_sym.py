"""`nearest_neighbor`'s kernels take each unordered pair once
(`spacetpu_torch/csrc/encounter.cu`). This holds the two facts that keep
their bits the plain version's, on the CPU: r^2 of (i, j) and of (j, i) are
the same bits (`encounters._r2`), and the least (r^2, index) does not depend
on the order the candidates are met in, given the kernels' joins. The
kernels' schedule is emulated in PyTorch (`tests/nearest_sym.py`: the
diagonal tiles, the half ring's bands, row and column candidates, the
join) and held bit for bit against `nearest_neighbor_plain`, and against
the JAX package's `nearest_neighbor` (indices equal, distances to 1e-12),
with masks, coincident live pairs, exact
ties on a lattice and N ragged around a block; three wrong schedules fail
on the lattice. The kernels themselves are held against the plain version
on the card (tests/test_torch_gpu.py)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import encounters as jenc
from spacetpu_torch import _build
from spacetpu_torch.ops import encounters
from tests import nearest_sym
from tests.parity import one_torch_thread  # noqa: F401

#: (rows a lane, warps a block, slots) of the emulated layouts: the
#: kernels' float32 and float64 layouts, and two small ones that give many
#: blocks and bands at small N (the second with two chunks a warp)
LAYOUTS = {"f32": (16, 16, 16), "f64": (8, 8, 16), "small": (2, 2, 2),
           "chunks": (4, 2, 3)}


def _case(case, n, seed=0):
    """Positions and a mask (or None): "random"; "mask" (every third body
    dead); "coincident" (live bodies 0 and n - 1 at one point, the dead
    body n // 2 on them); "lattice" (an integer grid: exact ties and exact
    zeros)."""
    rng = np.random.default_rng(seed + n)
    pos = rng.uniform(-1, 1, size=(n, 3))
    mask = None
    if case == "mask":
        mask = np.arange(n) % 3 != 1
    elif case == "coincident" and n > 2:
        pos[n - 1] = pos[0]
        pos[n // 2] = pos[0]
        mask = np.ones(n, bool)
        mask[n // 2] = False
    elif case == "lattice":
        pos = rng.integers(-2, 3, size=(n, 3)).astype(np.float64)
    return pos, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_r2_is_symmetric_bit_for_bit(dtype):
    """r^2(i, j) == r^2(j, i) exactly: the rounded difference only changes
    sign and the squares drop it; over positions of mixed scales, ties of
    a lattice and coincident points."""
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(300, 3)) * 10.0 ** rng.integers(-6, 6, (300, 1))
    pos[:50] = rng.integers(-2, 3, size=(50, 3))
    pos[60] = pos[61]
    p = torch.as_tensor(pos, dtype=dtype)
    r2 = encounters._r2(p, p)
    assert torch.equal(r2, r2.T)
    assert bool((r2.diagonal() == 0).all())


#: (N, case, layout) of the schedule's cases: N ragged around the small
#: layouts' blocks and the kernels' (512 rows in float32, 256 in float64);
#: N = 1000 (many blocks and bands) on the small layout only, with
#: random positions under the mask, and the coincident pair on the float32
#: layout and (at N = 1000) the small one
SCHEDULE_CASES = [(n, case, layout)
                  for n in (1, 2, 255, 257, 1000)
                  for case in ("random", "mask", "coincident", "lattice")
                  for layout in LAYOUTS
                  if (layout == "small" and case != "random" if n == 1000
                      else case != "coincident" or layout == "f32")]


@pytest.mark.parametrize("n,case,layout", SCHEDULE_CASES)
def test_schedule_matches_plain_bit_for_bit(n, case, layout):
    """The kernels' schedule, emulated, against `nearest_neighbor_plain`
    (dense and chunked), in float32 and float64: every least r^2 and index
    the same bits; a masked row keeps its nearest live body; a coincident
    live pair each other's neighbour at 0."""
    pos, mask = _case(case, n)
    tm = None if mask is None else torch.as_tensor(mask)
    p_rows, warps, slots = LAYOUTS[layout]
    for dtype in (torch.float32, torch.float64):
        p = torch.as_tensor(pos, dtype=dtype)
        got = nearest_sym.emulate(p, tm, p=p_rows, warps=warps, slots=slots)
        for chunk in (4096, 96):
            want = encounters.nearest_neighbor_plain(p, tm, chunk=chunk)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
    if case == "coincident" and n > 2:
        assert (int(got[1][0]), int(got[1][n - 1])) == (n - 1, 0)
        assert float(got[0][0]) == 0.0 and int(got[1][n // 2]) == 0


@pytest.mark.parametrize("case", ["mask", "coincident", "lattice"])
@pytest.mark.parametrize("n", [2, 257, 1000])
def test_schedule_matches_jax(n, case):
    """The emulated schedule (the small layout: the most blocks and bands;
    every layout is held against the plain version above) against the JAX
    package's `nearest_neighbor` in float64: indices
    equal, distances within 1e-12 relative (+inf on the masked rows): XLA
    rounds r^2's sum in another order (about 1 value in 7 a unit in the
    last place off), so only the indices can be held bit for bit."""
    pos, mask = _case(case, n)
    tm = None if mask is None else torch.as_tensor(mask)
    jd, ji = jenc.nearest_neighbor(
        jnp.asarray(pos), mask=None if mask is None else jnp.asarray(mask),
        chunk=4096)
    jd, ji = np.asarray(jd), np.asarray(ji)
    p_rows, warps, slots = LAYOUTS["small"]
    best, idx = nearest_sym.emulate(torch.as_tensor(pos), tm, p=p_rows,
                                    warps=warps, slots=slots)
    dist = torch.sqrt(best)
    if tm is not None:
        dist = torch.where(tm, dist, torch.inf)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(np.isinf(dist.numpy()), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(dist.numpy()[fin], jd[fin], rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("wrong", ["no_columns", "visit_order",
                                   "strict_join"])
def test_wrong_schedules_fail_on_the_lattice(wrong):
    """Each wrong schedule gives another table on the lattice's exact ties
    (N = 1000, the small layout): without the column candidates, with a
    band's wrapped tiles visited last, and joined by r^2 alone."""
    pos, _ = _case("lattice", 1000)
    p = torch.as_tensor(pos, dtype=torch.float32)
    want = encounters.nearest_neighbor_plain(p, chunk=4096)
    got = nearest_sym.emulate(p, p=2, warps=2, slots=2, wrong=wrong)
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1]))


def _constant(name):
    text = (_build.CSRC / "encounter.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_emulated_layouts_are_the_kernels():
    """The float32 and float64 layouts emulated here are encounter.cu's
    (NN_P, NN_WARPS; NN_P64, NN_WARPS64) and the slots the wrapper's
    (chip_smoke's names for the kernels are held in
    tests/test_torch_encounters.py)."""
    assert LAYOUTS["f32"] == (_constant("NN_P"), _constant("NN_WARPS"),
                              encounters.NEAREST_SLOTS)
    assert LAYOUTS["f64"] == (_constant("NN_P64"), _constant("NN_WARPS64"),
                              encounters.NEAREST_SLOTS)


def test_a_cpu_call_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions and count no
    launch."""
    before = dict(encounters.LAUNCHES)
    pos = torch.as_tensor(_case("random", 100)[0])
    best, idx = encounters.nearest_table(pos)
    rows, count = encounters.nearest_update(pos, None, best.clone(),
                                            idx.clone(), torch.tensor(0),
                                            torch.tensor(1))
    encounters.nearest_rows(pos, None, rows, best.clone(), idx.clone())
    assert encounters.LAUNCHES == before and int(count) == rows.numel() >= 2
