"""Card-only tests of the port's CUDA kernels. Each skips where there is no
CUDA card. This file imports neither JAX nor `spacetpu`, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

import spacetpu_torch
from spacetpu_torch import _build
from spacetpu_torch.models import presets
from spacetpu_torch.ops import cuda_direct

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bodies(n, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    return pos, mass


@pytest.mark.parametrize("method", ["vpu", "mxu"])
def test_kernel_matches_plain_in_float64(card, method):
    """float64, so only the order of the sums differs (1e-9 of max|a|);
    each call launches its kernel once."""
    pos, mass = _bodies(1000, seed=10, dtype=torch.float64, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    before = cuda_direct.LAUNCHES[f"direct_{method}"]
    got = cuda_direct.acc_cross_kernel(pos, pos, mass, method=method, **kw)
    assert cuda_direct.LAUNCHES[f"direct_{method}"] == before + 1
    if method == "mxu":
        want = cuda_direct.acc_cross_mxu_plain(pos, pos, mass, eps=1e-2,
                                               g=1.0)
    else:
        want = cuda_direct.acc_cross_plain(pos, pos, mass, **kw)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-9


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2), ("ref", 1e-2),
                                           ("plummer", 0.0), ("ref", 0.0)])
def test_vpu_float32_cross_ragged(card, softening, eps):
    """Ragged cross shapes in float32: within 1e-4 of max|a| of the plain
    version where softened, finite where not."""
    pos_i, _ = _bodies(333, seed=11, dtype=torch.float32, dev=card)
    pos_j, mass_j = _bodies(1001, seed=12, dtype=torch.float32, dev=card)
    kw = dict(softening=softening, eps=eps, g=1.0)
    got = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
    want = cuda_direct.acc_cross_plain(pos_i, pos_j, mass_j, **kw)
    assert got.shape == (333, 3)
    assert bool(torch.isfinite(got).all())
    if eps > 0:
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_mxu_float32_within_band_of_vpu(card):
    """The band of tests/test_pallas.py:66-79 on the card."""
    pos, mass = _bodies(4099, seed=4099, dtype=torch.float32, dev=card)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    a_v = cuda_direct.acc_cross_kernel(pos, pos, mass, **kw)
    a_m = cuda_direct.acc_cross_kernel(pos, pos, mass, method="mxu", **kw)
    band = torch.linalg.norm(a_m - a_v, dim=1).max() / torch.linalg.norm(
        a_v, dim=1).max()
    assert float(band) < 2e-3


def test_cuda_tensors_never_take_the_plain_version(card):
    pos = torch.zeros(8, 3, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        cuda_direct.acc_cross_kernel(pos, pos, pos[:, 0])


def test_build_is_cached(card):
    lib = _build.library("direct")
    assert _build.library("direct") is lib
    assert _build.BUILD_INFO["direct"]["path"].endswith(".so")


def test_main_path_launches_kernel(card):
    n = 2048
    sim = spacetpu_torch.make_simulation(n, algorithm="direct",
                                         softening="plummer", eps=1e-2, g=1.0)
    assert sim.backend == "cuda"
    state = presets.random_cluster(n, seed=0).state()
    cuda_direct.LAUNCHES["direct_vpu"] = 0
    state = sim.run(sim.prime(state), 1e-3, 3)
    torch.cuda.synchronize()
    assert cuda_direct.LAUNCHES["direct_vpu"] == 4
    assert state.pos.is_cuda and bool(torch.isfinite(state.pos).all())
