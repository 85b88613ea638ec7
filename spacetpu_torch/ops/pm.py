"""Particle-mesh (PM) force solver: CIC deposit -> FFT Poisson -> gather
(PyTorch).

The counterpart of `spacetpu/ops/pm.py`. Isolated boundaries by Hockney &
Eastwood grid doubling: mass is CIC-deposited onto the corner of a
``(2*grid)^3`` zero-padded mesh, the potential is the circular convolution
with the open-space Green's function sampled at the minimum-image node
distance,

    K[d] = -G / sqrt((h*|d|_min)^2 + eps_eff^2),  eps_eff = max(eps, h),

and the acceleration is the central-difference gradient of the potential,
gathered back with the same CIC weights (antisymmetric pair forces, zero
self-force).

The JAX package computes the Poisson solve outside any Pallas kernel
(`jnp.fft`, or the DFT matmuls of `ops/fftmm.py` on a TPU), so here it is
`torch.fft.rfftn`/`irfftn` (cuFFT on the card). ``fft_method`` still
accepts "fft", "matmul" and "auto"; both resolve to the same `torch.fft`
transform, since the matmul DFT is a TPU workaround.

Kernel spectra: every table is built from its (G+1)^3 min-image corner by
`kernel_hat_from_corner`, in float64 on the device the caller names (the
card by default), then cast: the JAX package builds them on the host in
numpy float64, or for large grids on the device from the same corner.

Deposit and gather take index tensors of int64 (a (G+1)^3 linear index).
`measure_box` reads the extent back to the host; nothing else here does.
"""

from __future__ import annotations

import numpy as np
import torch

from spacetpu_torch import constants
from spacetpu_torch.state import resolve_device

#: kernel softening floor, in cells: the mesh resolution limit
PM_SOFT_CELLS = 1.0

#: default auto-grid bounds
PM_GRID_MIN = 32
PM_GRID_MAX = 128

#: Poisson-transform implementation: "fft", "matmul" or "auto" (accepted
#: for the JAX package's callers; all three run `torch.fft`)
PM_FFT_METHOD = "auto"


def fft_method(method: str | None = None) -> str:
    """Resolve the Poisson-transform name ("fft" | "matmul"): "auto" is
    "fft" off a TPU, as in the JAX package. Both names compute the same
    transform here."""
    m = method or PM_FFT_METHOD
    if m == "auto":
        m = "fft"
    if m not in ("fft", "matmul"):
        raise ValueError(f"unknown PM FFT method {m!r}")
    return m


def default_grid(n: int) -> int:
    """Power-of-two mesh size for N bodies: ~1 body a cell (grid ~ N^(1/3)),
    clamped to [PM_GRID_MIN, PM_GRID_MAX]."""
    g = 1
    while g < round(n ** (1.0 / 3.0)):
        g *= 2
    return max(PM_GRID_MIN, min(PM_GRID_MAX, g))


def measure_box(pos, *, grid: int, margin: float = 2.0):
    """(box_min (3,) float64 numpy, h float): the position extent scaled by
    `margin` about its centre, mapped so grid coordinates span
    [0, grid - 1], with cubic cells. The extent is taken on the device
    (exact) and the rest on the host in float64. Waits for the device."""
    if isinstance(pos, torch.Tensor):
        lo = pos.amin(dim=0).double().cpu().numpy()
        hi = pos.amax(dim=0).double().cpu().numpy()
    else:
        p = np.asarray(pos, np.float64)
        lo, hi = p.min(axis=0), p.max(axis=0)
    return box_from_extent(lo, hi, grid=grid, margin=margin)


def box_from_extent(lo, hi, *, grid: int, margin: float = 2.0):
    """`measure_box` from the extent: lo and hi (3,) float64 numpy, the
    least and greatest coordinate on each axis (the sharded PM passes the
    MIN and MAX over its ranks)."""
    center = 0.5 * (lo + hi)
    half = 0.5 * float((hi - lo).max()) * margin
    half = max(half, 1e-30)  # degenerate single-point scene
    h = 2.0 * half / (grid - 1)
    return center - half, h


def corner_distances(grid: int, h: float, *, device=None):
    """(G+1, G+1, G+1) float64 node distances h*|d| of the min-image corner
    d in [0, G]^3 of the doubled mesh."""
    d = torch.arange(grid + 1, dtype=torch.float64, device=device)
    return float(h) * torch.sqrt(d[:, None, None] ** 2 + d[None, :, None] ** 2
                                 + d[None, None, :] ** 2)


def kernel_hat_from_corner(corner, grid: int, dtype=torch.float32):
    """rFFT spectrum (2G, 2G, G+1), real, of an even doubled-mesh kernel
    from its corner (G+1, G+1, G+1) of samples at the min-image node
    distances d in [0, G]^3 (the counterpart of
    `spacetpu.ops.fftmm.kernel_hat_from_corner`).

    The corner is mirrored to the (2G)^3 mesh (node i takes the sample at
    min(i, 2G - i) on each axis, which is the mesh `pm.pm_kernel_hat`
    samples) and transformed in float64 on the corner's device; the kernel
    is even, so its spectrum is real up to roundoff, which is dropped."""
    g2 = 2 * grid
    idx = torch.arange(g2, device=corner.device)
    mirror = torch.minimum(idx, g2 - idx)
    full = corner.double()[mirror][:, mirror][:, :, mirror]
    k_hat = torch.fft.rfftn(full).real
    del full
    return k_hat.to(dtype)


def pm_kernel_hat(grid: int, h: float, *, eps: float = 0.0, g: float = None,
                  dtype=torch.float32, device=None):
    """rFFT of the open-BC Green's function on the doubled mesh: a real
    (2G, 2G, G+1) table, built in float64 on `device` (the card unless the
    caller names another) and cast to `dtype`."""
    if g is None:
        g = constants.G
    r = corner_distances(grid, h, device=resolve_device(device))
    eps_eff = max(float(eps), PM_SOFT_CELLS * h)
    corner = -float(g) / torch.sqrt(r * r + eps_eff * eps_eff)
    return kernel_hat_from_corner(corner, grid, dtype)


def _cic(pos, box_min, inv_h, grid: int):
    """CIC base corner (int64) and per-axis fractional weights, with the
    out-of-box clamp: u = (x - box_min) / h in [0, grid - 1], so the 8
    corners land in [0, grid]."""
    u = torch.clamp((pos - box_min) * inv_h, 0.0, grid - 1.0)
    i0 = torch.clamp_max(torch.floor(u).to(torch.int64), grid - 1)
    return i0, u - i0


def count_out_of_box(pos, box_min, h, grid: int):
    """0-d int64 tensor: bodies outside the calibrated box (their deposit is
    face-clamped; counted, never silent)."""
    u = (pos - torch.as_tensor(box_min, dtype=pos.dtype,
                               device=pos.device)) / h
    bad = torch.any((u < 0.0) | (u > grid - 1.0), dim=-1)
    return torch.sum(bad)


def _corner_weights(f):
    """[((dx, dy, dz), (N,) weight)] for the 8 CIC corners."""
    out = []
    for dx in (0, 1):
        wx = f[:, 0] if dx else 1.0 - f[:, 0]
        for dy in (0, 1):
            wy = f[:, 1] if dy else 1.0 - f[:, 1]
            for dz in (0, 1):
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                out.append(((dx, dy, dz), wx * wy * wz))
    return out


def _corners(i0, f, side: int):
    """(8, N) int64 linear indices into a side^3 mesh and (8, N) weights of
    the CIC corners."""
    lin, w = [], []
    for (dx, dy, dz), wc in _corner_weights(f):
        lin.append(((i0[:, 0] + dx) * side + (i0[:, 1] + dy)) * side
                   + (i0[:, 2] + dz))
        w.append(wc)
    return torch.stack(lin), torch.stack(w)


def _deposit(pos, mass, box_min, inv_h, grid: int, side: int):
    i0, f = _cic(pos, box_min, inv_h, grid)
    lin, w = _corners(i0, f, side)
    mesh = mass.new_zeros(side ** 3)
    mesh.index_add_(0, lin.reshape(-1), (w * mass[None, :]).reshape(-1))
    return mesh.reshape(side, side, side)


def deposit_cic(pos, mass, *, box_min, inv_h, grid: int):
    """Scatter-add masses onto the zero-padded doubled mesh -> (2G)^3. The
    mesh holds raw mass: the density normalisation and 4 pi G live in the
    kernel. One `index_add_` of the 8N corner weights."""
    return _deposit(pos, mass, box_min, inv_h, grid, 2 * grid)


def deposit_cic_compact(pos, mass, *, box_min, inv_h, grid: int):
    """Scatter-add masses onto the COMPACT occupied corner (G+1)^3 of the
    doubled mesh (CIC corners land in [0, grid] per axis; the rest of the
    doubled mesh is structural zero)."""
    return _deposit(pos, mass, box_min, inv_h, grid, grid + 1)


def ext_rows(grid: int) -> np.ndarray:
    """Doubled-mesh node indices of the extended potential window
    [-1 .. G+1] (min-image wrapped: -1 == 2G-1)."""
    return np.concatenate(([2 * grid - 1], np.arange(grid + 2)))


def _window(phi, grid: int):
    """phi at ext_rows(grid) on each axis, the indices made on phi's device
    (no copy from the host)."""
    r = torch.arange(-1, grid + 2, device=phi.device) % (2 * grid)
    return phi.index_select(0, r).index_select(1, r).index_select(2, r)


def potential_mesh(mass_mesh, kernel_hat, grid: int, *, method: str = None):
    """phi = F^-1(F(mass) * K_hat) on the doubled mesh (circular convolution
    == open convolution under the min-image kernel)."""
    fft_method(method)
    g2 = 2 * grid
    return torch.fft.irfftn(torch.fft.rfftn(mass_mesh) * kernel_hat,
                            s=(g2, g2, g2))


def potential_ext(mesh_c, kernel_hat, grid: int, *, method: str = None):
    """Poisson solve of a COMPACT (G+1)^3 mass mesh, returning phi on the
    extended window ext_rows^3 -> (G+3)^3. The transform zero-pads the
    compact mesh to the doubled mesh itself (`rfftn`'s `s`)."""
    fft_method(method)
    g2 = 2 * grid
    phi = torch.fft.irfftn(torch.fft.rfftn(mesh_c, s=(g2, g2, g2))
                           * kernel_hat, s=(g2, g2, g2))
    return _window(phi, grid)


def _gather(pos, grads, box_min, inv_h, grid: int, side: int):
    """sum over the 8 CIC corners of weight * grads[corner] -> (N, C)."""
    i0, f = _cic(pos, box_min, inv_h, grid)
    lin, w = _corners(i0, f, side)
    acc = None
    for c in range(8):
        term = w[c][:, None] * grads[lin[c]]
        acc = term if acc is None else acc + term
    return acc


def acc_from_mesh_compact(pos, mesh_c, *, kernel_hat, box_min, inv_h,
                          grid: int):
    """Solve + gather from a COMPACT (G+1)^3 mass mesh (the production path;
    `acc_from_mesh` is the full-mesh oracle)."""
    return acc_from_potential_ext(pos, potential_ext(mesh_c, kernel_hat, grid),
                                  box_min=box_min, inv_h=inv_h, grid=grid)


def acc_from_potential_ext(pos, phi_e, *, box_min, inv_h, grid: int):
    """Central-difference gradient and CIC gather from the extended
    potential window phi_e (G+3)^3 (origin at node -1): the gradient is
    built only at the gatherable cells [0 .. G]^3."""
    half_inv = 0.5 * inv_h
    gc = grid + 1
    lo, mid, hi = slice(0, gc), slice(1, gc + 1), slice(2, gc + 2)
    # a = -grad phi; central difference: a[i] = (phi[i-1] - phi[i+1])/(2h)
    grads = torch.stack(
        [(phi_e[lo, mid, mid] - phi_e[hi, mid, mid]) * half_inv,
         (phi_e[mid, lo, mid] - phi_e[mid, hi, mid]) * half_inv,
         (phi_e[mid, mid, lo] - phi_e[mid, mid, hi]) * half_inv],
        dim=-1).reshape(-1, 3)
    return _gather(pos, grads, box_min, inv_h, grid, gc)


def acc_from_mesh(pos, mass_mesh, *, kernel_hat, box_min, inv_h, grid: int):
    """Solve + gather on the full doubled mesh (the oracle form): FFT
    Poisson, central differences by rolls of the doubled mesh (under the
    min-image kernel the wrapped neighbour is the right open-space sample),
    CIC gather."""
    phi = potential_mesh(mass_mesh, kernel_hat, grid)
    half_inv = 0.5 * inv_h
    grads = torch.stack(
        [(torch.roll(phi, 1, ax) - torch.roll(phi, -1, ax)) * half_inv
         for ax in range(3)], dim=-1).reshape(-1, 3)
    return _gather(pos, grads, box_min, inv_h, grid, 2 * grid)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _scalars(pos, box_min, h):
    """box_min as a tensor of the positions' dtype on their device (no copy
    where it is one already), and 1/h as the Python float of the reciprocal
    taken in that dtype, as the JAX package forms it: a CUDA scalar made
    from the host would wait for the device at every call."""
    box = torch.as_tensor(box_min, dtype=pos.dtype, device=pos.device)
    one = _NP_DTYPES[pos.dtype](1.0)
    return box, float(one / _NP_DTYPES[pos.dtype](h))


def acc_pm(pos, mass, *, kernel_hat, box_min, h, grid: int):
    """PM acceleration (N, 3): deposit -> FFT solve -> central-difference
    gradient -> CIC gather."""
    box, inv_h = _scalars(pos, box_min, h)
    mesh = deposit_cic_compact(pos, mass.to(pos.dtype), box_min=box,
                               inv_h=inv_h, grid=grid)
    return acc_from_mesh_compact(pos, mesh, kernel_hat=kernel_hat,
                                 box_min=box, inv_h=inv_h, grid=grid)


def pm_self_kernel(h: float, *, eps: float = 0.0, g: float = None) -> float:
    """K[0] = -G/eps_eff, the kernel's self-potential a unit mass."""
    if g is None:
        g = constants.G
    return -float(g) / max(float(eps), PM_SOFT_CELLS * float(h))


def potential_energy_pm(pos, mass, *, kernel_hat, box_min, h, grid: int,
                        k0: float):
    """Mesh potential energy 0.5 * sum_i m_i phi(x_i) with the softened
    kernel's self-energy 0.5 * k0 * sum m^2 taken out (0-d tensor)."""
    box, inv_h = _scalars(pos, box_min, h)
    mass = mass.to(pos.dtype)
    mesh = deposit_cic_compact(pos, mass, box_min=box, inv_h=inv_h,
                               grid=grid)
    gc = grid + 1
    phi = potential_ext(mesh, kernel_hat, grid)[1:gc + 1, 1:gc + 1,
                                                1:gc + 1].reshape(-1, 1)
    phi_i = _gather(pos, phi, box, inv_h, grid, gc)[:, 0]
    return 0.5 * (torch.sum(mass * phi_i) - k0 * torch.sum(mass * mass))

