"""The far field's dense kernels on the CPU: `quad_dense` and `quad_masked`
(spacetpu_torch/csrc/tree.cu: quad_two_kernel, one template for both).

The kernel runs only on the card (tests/test_torch_gpu.py holds it against
the plain versions on `pair_hold`'s ragged cases). Here: the instances
whose SASS `chip_smoke.py` reads and the pairs a trip of their pair loop
takes; the ragged cases themselves (a mask across the 256-column tile
boundary, a whole tile masked, a row of nulls, a target on a centre of
mass); and the plain versions on those cases against the JAX package's XLA
path (`pallas_direct.acc_cross_quad_xla`, `tree._superfar_dense_masked`
with backend="xla") on the same numpy inputs, in float64 within 1e-12 of
max|a| (the same arithmetic, sums in another order)."""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu.ops import pallas_direct as jdirect
from spacetpu.ops import tree as jtree
from spacetpu_torch.ops import cuda_tree
from tests import pair_hold, parity
from tests.parity import one_torch_thread  # noqa: F401

CSRC = pathlib.Path(cuda_tree.__file__).resolve().parents[1] / "csrc"
TREE_CU = (CSRC / "tree.cu").read_text()


def _kernel_source(kernel: str) -> str:
    """The text of a __global__ template of tree.cu, up to the next
    top-level closing brace."""
    m = re.search(r"template <[^>]*>\s*__global__ void\s+"
                  rf"(?:__launch_bounds__\(\w+\)\s+)?{kernel}\(", TREE_CU)
    assert m, kernel
    return TREE_CU[m.start():TREE_CU.index("\n}\n", m.end())]


@pytest.mark.parametrize("name,masked", [("quad_dense", 0),
                                         ("quad_masked", 1)])
def test_quad_instances_are_the_quad_two_kernel_of_tree_cu(name, masked):
    """chip_smoke reads the SASS of quad_two_kernel<float, MASKED,
    QUAD_TARGETS>, the one template of both, whose pair loop is unrolled
    8 / NT times over NT targets: 8 pairs a trip."""
    tag = chip_smoke.MAIN_INSTANCES[name]
    nt = int(re.search(r"constexpr int QUAD_TARGETS = (\d+);",
                       TREE_CU).group(1))
    assert nt >= 2 and 8 % nt == 0
    assert tag == f"quad_two_kernelIfLb{masked}ELi{nt}EE"
    body = _kernel_source("quad_two_kernel")
    assert "#pragma unroll (8 / NT)" in body and "quad_term(" in body
    assert "quad_two_kernel<T, MASKED, QUAD_TARGETS>" in TREE_CU
    assert chip_smoke.PAIRS_PER_LOOP[name] == 8
    assert name not in chip_smoke.LOOP_MUFU


def test_pairs_quad_instance_reads_its_four_pair_loop():
    """pairs_quad runs quad_list_kernel<float, QL_TARGETS>, quad_strip's
    template too, whose pair loop is unrolled 16 / NT times over NT
    targets: 16 pairs and 16 MUFU instructions a trip (at least 8, so
    `sass_loops` needs no `LOOP_MUFU`); tree.cu holds no pairs_quad_kernel."""
    nt = int(re.search(r"constexpr int QL_TARGETS = (\d+);",
                       TREE_CU).group(1))
    assert chip_smoke.MAIN_INSTANCES["pairs_quad"] == (
        f"quad_list_kernelIfLi{nt}EE")
    body = _kernel_source("quad_list_kernel")
    assert body.count("#pragma unroll (16 / NT)") == 1
    assert "quad_term(" in body
    assert "pairs_quad_kernel" not in TREE_CU
    assert chip_smoke.PAIRS_PER_LOOP["pairs_quad"] == 16
    assert "pairs_quad" not in chip_smoke.LOOP_MUFU


def test_quad_masked_wide_case_covers_the_tile_edges():
    """The wide case masks columns on both sides of the 256-column tile
    boundary, the whole second tile of one super, nothing of another, and
    puts a target on a kept and on a masked centre of mass at eps = 0."""
    tgt, summ, idx2 = pair_hold.quad_masked_case(0.0, torch.float64, "cpu")
    g2 = summ.shape[1]
    assert g2 == pair_hold.QUAD_MASKED_G2 > 256 and summ.stride(0) > g2
    keep = cuda_tree._keep_mask(idx2, g2)
    assert not keep[0, 255] and not keep[0, 256] and keep[0, 239]
    assert not keep[2, 256:].any() and keep[2, :256].all()
    assert keep[3].all() and bool((idx2[3] == g2).all())
    assert (idx2[1] == g2).any() and 0 < int((~keep[1]).sum()) < g2
    assert torch.equal(tgt[0], summ[:3, 5]) and keep[0, 5]
    assert torch.equal(tgt[1], summ[:3, 250]) and not keep[0, 250]
    assert tgt.shape[0] == (pair_hold.QUAD_MASKED_N2
                            * pair_hold.QUAD_MASKED_ROWS)


def _close(got, want, tol=1e-12):
    want = torch.as_tensor(np.array(want))
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("eps", [1e-2, 0.0])
@pytest.mark.parametrize("m,s", pair_hold.QUAD_SIZES)
def test_quad_dense_ragged_plain_matches_jax(m, s, eps):
    tgt, summ = pair_hold.quad_dense_case(m, s, eps, torch.float64, "cpu")
    want = parity.call(jdirect.acc_cross_quad_xla, tgt.numpy(),
                       summ.contiguous().numpy(), eps=eps)
    _close(cuda_tree.acc_cross_quad(tgt, summ, eps=eps), want)


@pytest.mark.parametrize("eps", [1e-2, 0.0])
def test_quad_masked_wide_plain_matches_jax(eps):
    tgt, summ, idx2 = pair_hold.quad_masked_case(eps, torch.float64, "cpu")
    want = parity.call(jtree._superfar_dense_masked, tgt.numpy(),
                       summ.contiguous().numpy(), idx2.numpy(), eps=eps,
                       backend="xla", interpret=True)
    _close(cuda_tree.acc_cross_quad_masked(tgt, summ, idx2, eps=eps), want)
