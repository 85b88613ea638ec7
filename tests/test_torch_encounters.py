"""The port's encounter telemetry (`spacetpu_torch/ops/encounters.py`)
against `spacetpu.ops.encounters` on the CPU, where the port runs the plain
version of its `nearest_neighbor` kernel: the dense path (N <= chunk) and
the source-chunked one, masks, a row with no live source, coincident live
bodies and planted exact ties, in float64 from seeded numpy inputs; and
the headless `--report-encounters` lines of both packages. The kernel is
held against this plain version on the card (tests/test_torch_gpu.py)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import encounters as jenc
from spacetpu_torch.ops import encounters
from tests.parity import one_torch_thread  # noqa: F401


def _case(case, n=150, seed=7):
    """Positions and a mask (or None): "random"; "mask" (every third body
    dead); "lonely" (two live bodies: every other row's only source is one
    of them, and each other's); "none_live" (one live body: its row has no
    source); "coincident" (live bodies 5 and 77 at one point, a dead one on
    them); "ties" (an integer grid: exact ties and exact zeros); "tie"
    (body 0 at the origin, 40 and 90 at distance 1 on either side, the
    rest far: 0's neighbour must be 40)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10
    mask = None
    if case == "mask":
        mask = np.arange(n) % 3 != 1
    elif case == "lonely":
        mask = np.zeros(n, bool)
        mask[[3, 100]] = True
    elif case == "none_live":
        mask = np.zeros(n, bool)
        mask[60] = True
    elif case == "coincident":
        pos[77] = pos[5]
        pos[30] = pos[5]
        mask = np.ones(n, bool)
        mask[30] = False
    elif case == "ties":
        pos = rng.integers(-2, 3, size=(n, 3)).astype(np.float64)
    elif case == "tie":
        pos = rng.uniform(50, 60, size=(n, 3))
        pos[0] = 0.0
        pos[40] = [1.0, 0.0, 0.0]
        pos[90] = [-1.0, 0.0, 0.0]
    return pos, mask


CASES = ["random", "mask", "lonely", "none_live", "coincident", "ties",
         "tie"]


@pytest.mark.parametrize("chunk", [4096, 32])
@pytest.mark.parametrize("case", CASES)
def test_nearest_neighbor_matches_jax(case, chunk):
    """Distances to 1e-12 relative (+inf where JAX has +inf), indices equal,
    both on the dense path (chunk 4096 > N = 150) and the chunked one
    (chunk 32: the tie and the coincident pair across chunks)."""
    pos, mask = _case(case)
    tm = None if mask is None else torch.as_tensor(mask)
    dist, idx = encounters.nearest_neighbor(torch.as_tensor(pos), mask=tm,
                                            chunk=chunk)
    jd, ji = jenc.nearest_neighbor(
        jnp.asarray(pos), mask=None if mask is None else jnp.asarray(mask),
        chunk=chunk)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(np.isinf(dist.numpy()), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(dist.numpy()[fin], jd[fin], rtol=1e-12,
                               atol=0)
    if case == "coincident":
        assert (int(idx[5]), int(idx[77])) == (77, 5)
        assert float(dist[5]) == 0.0 and np.isinf(float(dist[30]))
    if case == "none_live":
        assert np.isinf(float(dist[60])) and int(idx[60]) == 0
        assert int(idx[0]) == 60 and np.isinf(float(dist[0]))
    if case == "tie":
        assert int(idx[0]) == 40


@pytest.mark.parametrize("case", CASES)
def test_min_separation_matches_jax(case):
    """(distance, i, j) of the closest live pair, chunk 32."""
    pos, mask = _case(case, n=120, seed=9)
    tm = None if mask is None else torch.as_tensor(mask)
    d, i, j = encounters.min_separation(torch.as_tensor(pos), mask=tm,
                                        chunk=32)
    jd, ji, jj = jenc.min_separation(
        jnp.asarray(pos), mask=None if mask is None else jnp.asarray(mask),
        chunk=32)
    assert (int(i), int(j)) == (int(ji), int(jj))
    if np.isfinite(float(jd)):
        assert float(d) == pytest.approx(float(jd), rel=1e-12, abs=0)
    else:
        assert np.isinf(float(d))


def test_plain_version_takes_target_rows():
    """`rows` (the card's hold of 4,096 targets) gives those rows of the
    whole answer, bit for bit."""
    pos, mask = _case("mask", n=200, seed=3)
    pos, mask = torch.as_tensor(pos), torch.as_tensor(mask)
    best, idx = encounters.nearest_neighbor_plain(pos, mask)
    rows = torch.as_tensor([199, 0, 57, 58, 3])
    b, i = encounters.nearest_neighbor_plain(pos, mask, chunk=64, rows=rows)
    assert torch.equal(b, best[rows]) and torch.equal(i, idx[rows])


def test_the_kernel_runs_only_on_the_card():
    with pytest.raises(ValueError, match="card"):
        encounters.nearest_neighbor_kernel(torch.zeros(4, 3))


def _lines(out, pattern):
    return [m.group(0) for m in re.finditer(pattern, out)]


def test_cli_report_encounters_matches_jax(capsys):
    """`--report-encounters` prints the same two lines in both packages."""
    from spacetpu.main import main as jmain
    from spacetpu_torch.main import main

    argv = ["--platform", "cpu", "--preset", "fixed_cloud", "--n", "200",
            "--frontend", "none", "--steps", "2", "--dt", "1",
            "--dtype", "float64", "--report-encounters"]
    main(argv)
    mine = _lines(capsys.readouterr().out, r"min separation \(\w+\): .*")
    jmain(argv)
    theirs = _lines(capsys.readouterr().out, r"min separation \(\w+\): .*")
    assert len(mine) == 2 and mine == theirs


def test_kernel_instance_is_a_template_of_encounter_cu():
    """chip_smoke reads the SASS of nearest_neighbor's float32 instance: a
    __global__ template of csrc/encounter.cu, the band kernel with the
    NN_P rows a lane and NN_WARPS warps the source defines, NN_UNROLL
    columns a trip against a lane's NN_P rows (unordered pairs)."""
    import pathlib

    import chip_smoke

    src = (pathlib.Path(encounters.__file__).parents[1] / "csrc"
           / "encounter.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    p, warps = constant("NN_P"), constant("NN_WARPS")
    assert chip_smoke.MAIN_INSTANCES["nearest_neighbor"] == (
        f"nn_band_kernelIfLi{p}ELi{warps}EE")
    assert chip_smoke.PAIRS_PER_LOOP["nearest_neighbor"] == \
        constant("NN_UNROLL") * p
    assert "encounter" in chip_smoke.LIBRARIES
