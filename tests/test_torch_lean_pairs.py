"""The host's side of the two-target kernels `near_strip` and `pairs_hybrid`
(spacetpu_torch/csrc/tree.cu), on the CPU: the choice of the MUFU rsqrt
alone (`cuda_tree.lean_rsqrt`), the thread layout
(`cuda_tree.two_target_threads`), and the instances whose SASS
`chip_smoke.py` reads. The kernels themselves run only on the card
(tests/test_torch_gpu.py). Imports neither JAX nor `spacetpu`."""

import math
import pathlib
import re

import pytest
import torch

import chip_smoke
from spacetpu_torch.ops import cuda_tree

CSRC = pathlib.Path(cuda_tree.__file__).resolve().parents[1] / "csrc"

#: the least normal float32, 2^-126, and the largest subnormal below it
TINY = torch.finfo(torch.float32).tiny
SUB = TINY - 2.0 ** -149


@pytest.mark.parametrize("dtype,softening,eps,want", [
    (torch.float32, "plummer", 1e-3, True),
    (torch.float32, "plummer", -1e-3, True),
    # eps = 0 takes the masked weight, whose self pair adds 0
    (torch.float32, "plummer", 0.0, False),
    # eps^2 = 2^-126 exactly: normal
    (torch.float32, "plummer", 2.0 ** -63, True),
    # just above
    (torch.float32, "plummer", math.sqrt(TINY + 2.0 ** -149), True),
    # below 2^-126 in float64 but 2^-126 once rounded to float32, as the
    # kernel takes it
    (torch.float32, "plummer", math.sqrt(TINY * (1 - 2.0 ** -40)), True),
    # the largest subnormal float32 square, and one far below
    (torch.float32, "plummer", math.sqrt(SUB), False),
    (torch.float32, "plummer", 1e-20, False),
    (torch.float64, "plummer", 1e-3, False),
    (torch.float32, "ref", 1e-3, False),
    (torch.float64, "ref", 0.0, False),
])
def test_lean_rsqrt_only_where_eps_squared_is_a_normal_float32(
        dtype, softening, eps, want):
    assert cuda_tree.lean_rsqrt(dtype, softening, eps) is want


def test_lean_rsqrt_edges_round_as_the_kernel_rounds():
    """The edge cases above hit what they name: eps^2 rounded to float32
    (the kernel's static_cast<float>(eps * eps)) is normal or subnormal as
    claimed."""
    def f32(x):
        return float(torch.tensor(x * x, dtype=torch.float32))

    assert f32(2.0 ** -63) == TINY
    assert f32(math.sqrt(TINY * (1 - 2.0 ** -40))) == TINY
    assert math.sqrt(TINY * (1 - 2.0 ** -40)) ** 2 < TINY
    assert 0.0 < f32(math.sqrt(SUB)) < TINY
    assert f32(math.sqrt(TINY + 2.0 ** -149)) > TINY


def test_two_target_threads_partition_the_live_targets():
    """For every cluster size the kernels take (1-1023): whole warps, no
    warp more than ceil(leaf / 2) needs, and thread t's targets t and
    t + threads cover each live target exactly once."""
    for leaf in range(1, 1024):
        threads = cuda_tree.two_target_threads(leaf)
        assert threads % 32 == 0 and 32 <= threads <= 1024, leaf
        assert threads - 32 < (leaf + 1) // 2, leaf
        owned = [j for t in range(threads) for j in (t, t + threads)
                 if j < leaf]
        assert sorted(owned) == list(range(leaf)), leaf
    assert cuda_tree.two_target_threads(255) == 128


def _template_names(tag: str):
    """The kernel template of a part of a mangled name, and the classes of
    the source's anonymous namespace (S_<length><name>) in its template
    arguments."""
    kernel = re.match(r"[a-z_0-9]+(?=I)", tag).group(0)
    rest = tag[len(kernel):]
    return kernel, [rest[m.end():m.end() + int(m.group(1))]
                    for m in re.finditer(r"S_(\d+)", rest)]


@pytest.mark.parametrize("name,weight", [("near_strip", "DirectLean"),
                                         ("pairs_hybrid", "DirectLean")])
def test_main_instances_are_kernel_templates_of_tree_cu(name, weight):
    """chip_smoke reads the SASS of the instance its paths run: the tag
    names a __global__ template of csrc/tree.cu and the weight class of
    csrc/pair.cuh that the MUFU route launches."""
    tree = (CSRC / "tree.cu").read_text()
    pair = (CSRC / "pair.cuh").read_text()
    kernel, names = _template_names(chip_smoke.MAIN_INSTANCES[name])
    assert kernel == f"{name}_kernel"
    assert re.search(r"template <[^>]*>\s*__global__ void\s+"
                     rf"(?:__launch_bounds__\(\w+\)\s+)?{kernel}\(", tree)
    assert names == [weight]
    assert re.search(rf"struct {weight} \{{", pair)
    assert chip_smoke.PAIRS_PER_LOOP[name] == 16


def test_heavy_first_orders_every_cluster_once_heaviest_first():
    """The block order of the two-target kernels: a permutation of the
    target clusters, their work descending (ties in any order)."""
    work = torch.as_tensor([3, 0, 7, 7, 1, 496, 0, 2])
    order = cuda_tree.heavy_first(work)
    assert sorted(order.tolist()) == list(range(work.numel()))
    assert torch.all(work[order][:-1] >= work[order][1:])
    assert int(order[0]) == 5
