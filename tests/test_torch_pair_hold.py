"""The float32 limit that the card tests and chip_smoke.py hold the body pair
kernels to (`tests/pair_hold.py`), checked on the CPU with the kernels'
plain versions: an honest float32 sum in another order stays well inside
it, and deliberately wrong versions (zeros, the other split, the hybrid
sums without their subtraction) fail it by orders of magnitude, unsoftened
as well as softened."""

import math

import pytest
import torch

from spacetpu_torch.ops import cuda_tree
from tests import pair_hold
from tests.parity import one_torch_thread  # noqa: F401

_CASES = [("pairs_hybrid", "plummer", 0.0, None),
          ("pairs_hybrid", "ref", 1e-2, None),
          ("pairs_short", "plummer", 0.0, "poly"),
          ("pairs_short", "plummer", 1e-2, "gauss"),
          ("pairs_short", "ref", 0.0, "gauss"),
          ("pairs_short_hybrid", "plummer", 0.0, "poly"),
          ("pairs_short_hybrid", "ref", 1e-2, "gauss")]


@pytest.fixture(scope="module")
def inputs():
    return pair_hold.short_inputs(600, 15, 0.3, torch.float32,
                                  torch.device("cpu"))


@pytest.mark.parametrize("name,softening,eps,split", _CASES)
def test_hold_passes_float32_sums_and_fails_wrong_ones(inputs, name,
                                                       softening, eps, split):
    prep, srows = inputs
    short = pair_hold.KERNELS[name][0]
    args = (prep["pos_g"], srows[not short], prep["near_flat"],
            prep["near_tile_tgt"])
    kw = dict(softening=softening, eps=eps)
    if split:
        kw.update(rs=0.3 / 4.5, rcut=0.3, split=split)
    exact = pair_hold.exact_sums(name, args, kw)
    got = getattr(cuda_tree, f"near_{name}_plain")(*args, **kw)
    held = pair_hold.hold(got, exact)
    assert held["hold_ratio"] < 0.1 * pair_hold.F32_TOL, held
    for mutant, ratio in pair_hold.mutant_ratios(name, args, kw,
                                                 exact).items():
        assert ratio > 100 * pair_hold.F32_TOL, (mutant, ratio)


def test_hold_fails_nan_and_error_without_terms():
    exact = torch.zeros((2, 3, 6), dtype=torch.float64)
    exact[0, :, 3:] = 1.0
    got = torch.zeros((2, 3, 3))
    assert pair_hold.hold(got, exact)["ok"]
    got[0, 0, 0] = math.nan
    assert not pair_hold.hold(got, exact)["ok"]
    got[0, 0, 0] = 0.0
    got[1, 2, 1] = 1e-30  # a target with no terms must come out exactly 0
    assert pair_hold.hold(got, exact)["hold_ratio"] == math.inf
