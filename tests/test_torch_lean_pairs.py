"""The host's side of the direct law's kernels with several targets a
thread, on the CPU: `direct_vpu` (spacetpu_torch/csrc/direct.cu) and the
two-target kernels `near_strip`, `pairs_direct` and `pairs_hybrid`
(csrc/tree.cu): the choice of the MUFU rsqrt alone
(`cuda_tree.lean_rsqrt`), of a subnormal float32 eps^2 taken as 0
(`direct.plummer_eps2`), the two-target thread layout
(`cuda_tree.two_target_threads`), and the instances whose SASS
`chip_smoke.py` reads. `direct_vpu`'s C entry makes its own choice and
layout; the kernels themselves run only on the card
(tests/test_torch_gpu.py). Imports neither JAX nor `spacetpu`."""

import math
import pathlib
import re

import pytest
import torch

import chip_smoke
from spacetpu_torch.ops import cuda_tree, direct

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


#: the kernel template of each two-target kernel's instance, and its
#: HYBRID argument (the centred sums) where it has one
TWO_TARGET_TEMPLATES = {"near_strip": ("near_strip_kernel", None),
                        "pairs_direct": ("pairs_two_kernel", "Lb0EE"),
                        "pairs_hybrid": ("pairs_two_kernel", "Lb1EE")}


def _is_global_template(kernel: str, source: str) -> bool:
    return re.search(r"template <[^>]*>\s*__global__ void\s+"
                     rf"(?:__launch_bounds__\(\w+\)\s+)?{kernel}\(",
                     source) is not None


@pytest.mark.parametrize("name,weight", [("near_strip", "DirectLean"),
                                         ("pairs_hybrid", "DirectLean"),
                                         ("pairs_direct", "DirectLean")])
def test_main_instances_are_kernel_templates_of_tree_cu(name, weight):
    """chip_smoke reads the SASS of the instance its paths run: the tag
    names a __global__ template of csrc/tree.cu (pairs_direct and
    pairs_hybrid: pairs_two_kernel, without and with the centred sums) and
    the weight class of csrc/pair.cuh that the MUFU route launches."""
    tree = (CSRC / "tree.cu").read_text()
    pair = (CSRC / "pair.cuh").read_text()
    tag = chip_smoke.MAIN_INSTANCES[name]
    kernel, names = _template_names(tag)
    want, hybrid = TWO_TARGET_TEMPLATES[name]
    assert kernel == want
    assert hybrid is None or tag.endswith(hybrid)
    assert _is_global_template(kernel, tree)
    assert names == [weight]
    assert re.search(rf"struct {weight} \{{", pair)
    assert chip_smoke.PAIRS_PER_LOOP[name] == 16


def test_direct_vpu_instance_is_a_kernel_template_of_direct_cu():
    """The main path's `direct_vpu` instance: the lean kernel of
    csrc/direct.cu with DirectLean and the LEAN_TARGETS targets a thread
    that direct.cu defines; a trip of its pair loop takes 16 / LEAN_TARGETS
    sources for each target, 16 pairs."""
    src = (CSRC / "direct.cu").read_text()
    tag = chip_smoke.MAIN_INSTANCES["direct_vpu"]
    kernel, names = _template_names(tag)
    assert kernel == "direct_vpu_lean_kernel"
    assert _is_global_template(kernel, src)
    assert names == ["DirectLean"]
    nt = int(re.search(r"constexpr int LEAN_TARGETS = (\d+);", src).group(1))
    assert nt >= 2 and tag.endswith(f"Li{nt}EE")
    assert re.search(r"#pragma unroll \(16 / NT\)", src)
    assert chip_smoke.PAIRS_PER_LOOP["direct_vpu"] == 16


@pytest.mark.parametrize("eps", [1e-20, math.sqrt(SUB), 1e-30, 1e-3,
                                 2.0 ** -63, 0.0])
def test_a_subnormal_float32_eps_squared_counts_as_zero(eps):
    """`direct.plummer_eps2`: in float32, 0 where eps^2 rounds below the
    least normal float32 (1e-30: to 0 itself), eps * eps elsewhere; float64
    keeps eps * eps. For float32 plummer with eps > 0 exactly one of the
    MUFU route and the flush holds."""
    f32 = direct.plummer_eps2(eps, torch.float32)
    flushed = float(torch.tensor(eps * eps, dtype=torch.float32)) < TINY
    assert f32 == (0.0 if flushed else eps * eps)
    assert direct.plummer_eps2(eps, torch.float64) == eps * eps
    if eps > 0.0:
        assert flushed != cuda_tree.lean_rsqrt(torch.float32, "plummer", eps)


def test_heavy_first_orders_every_cluster_once_heaviest_first():
    """The block order of the two-target kernels: a permutation of the
    target clusters, their work descending (ties in any order)."""
    work = torch.as_tensor([3, 0, 7, 7, 1, 496, 0, 2])
    order = cuda_tree.heavy_first(work)
    assert sorted(order.tolist()) == list(range(work.numel()))
    assert torch.all(work[order][:-1] >= work[order][1:])
    assert int(order[0]) == 5
