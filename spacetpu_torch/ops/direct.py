"""All-pairs gravitational acceleration in plain PyTorch.

The counterpart of `spacetpu/ops/direct.py`, and the plain version that the
CUDA kernels of `ops/cuda_direct.py` are held against. Two softening laws:

- ``"ref"``: the reference's additive epsilon on r^3,
  ``a += rel * m * G / (|rel|^3 + eps)``;
- ``"plummer"``: ``a += rel * m * G / (r^2 + eps^2)^(3/2)``.

With ``eps == 0`` the i == j term would be 0/0; it is masked to zero, as it
is in float32 where eps^2 is subnormal (`plummer_eps2`).
"""

from __future__ import annotations

import torch

from spacetpu_torch import constants

SOFTENINGS = ("ref", "plummer")


def _defaults(softening: str, eps, g) -> tuple[float, float]:
    if eps is None:
        eps = constants.COLLISION_EPSILON if softening == "ref" else 0.0
    if g is None:
        g = constants.G
    return float(eps), float(g)


def plummer_eps2(eps: float, dtype) -> float:
    """eps^2 as the plummer law takes it in `dtype`: in float32, 0 where
    eps^2 rounds below the least normal float32 (to a subnormal, or to 0),
    as in `spacetpu`'s XLA path, which flushes subnormals; the d2 > 0 mask
    then drops the self pair, whose weight would otherwise be
    rsqrt(eps^2)^3 = inf times a zero difference. Every other eps, and
    float64, keeps eps * eps. The kernels take the same choice
    (csrc/pair.cuh: flushed_eps2)."""
    eps2 = eps * eps
    if (dtype == torch.float32 and float(torch.tensor(
            eps2, dtype=torch.float32)) < torch.finfo(torch.float32).tiny):
        return 0.0
    return eps2


def _pair_weight(r2, softening: str, eps: float):
    """Return w with a_i = sum_j w_ij * rel_ij * m_j; rel = pos_j - pos_i."""
    if softening == "ref":
        denom = r2 * torch.sqrt(r2) + eps
        return torch.where(denom > 0, 1.0 / denom, 0.0)
    if softening == "plummer":
        d2 = r2 + plummer_eps2(eps, r2.dtype)
        inv = torch.rsqrt(d2)
        return torch.where(d2 > 0, inv * inv * inv, 0.0)
    raise ValueError(
        f"unknown softening {softening!r} (want one of {SOFTENINGS})")


def acc_cross(pos_i, pos_j, mass_j, *, softening: str = "ref", eps=None,
              g=None):
    """Acceleration of targets `pos_i` (M, 3) due to sources `pos_j` (K, 3)
    of mass `mass_j` (K,) -> (M, 3). Dense: memory is O(M * K)."""
    eps, g = _defaults(softening, eps, g)
    rel = pos_j[None, :, :] - pos_i[:, None, :]  # (M, K, 3)
    r2 = torch.sum(rel * rel, dim=-1)
    w = _pair_weight(r2, softening, eps) * mass_j[None, :] * g
    return torch.einsum("ij,ijk->ik", w, rel)


def acc_direct(pos, mass, *, softening: str = "ref", eps=None, g=None):
    """Dense all-pairs acceleration (N, 3), (N,) -> (N, 3)."""
    return acc_cross(pos, pos, mass, softening=softening, eps=eps, g=g)


def acc_cross_chunked(pos_i, pos_j, mass_j, *, softening: str = "ref",
                      eps=None, g=None, chunk: int = 8192):
    """`acc_cross` over blocks of at most `chunk` targets and `chunk`
    sources, so peak memory is O(chunk^2) whatever M and K are. The sources
    of a target block are summed block by block, in order."""
    m, k = pos_i.shape[0], pos_j.shape[0]
    kw = dict(softening=softening, eps=eps, g=g)
    if m <= chunk and k <= chunk:
        return acc_cross(pos_i, pos_j, mass_j, **kw)
    blocks = []
    for i0 in range(0, m, chunk):
        tgt = pos_i[i0:i0 + chunk]
        acc = torch.zeros_like(tgt)
        for j0 in range(0, k, chunk):
            acc = acc + acc_cross(tgt, pos_j[j0:j0 + chunk],
                                  mass_j[j0:j0 + chunk], **kw)
        blocks.append(acc)
    return torch.cat(blocks)


def acc_direct_chunked(pos, mass, *, softening: str = "ref", eps=None,
                       g=None, chunk: int = 1024):
    """All-pairs acceleration with the target axis cut into chunks: memory
    is O(chunk * N). Requires N % chunk == 0, as in `spacetpu` (pad with
    `make_state(pad_to=...)`)."""
    n = pos.shape[0]
    if n % chunk != 0:
        raise ValueError(f"N={n} not divisible by chunk={chunk}")
    return torch.cat([
        acc_cross(pos[i0:i0 + chunk], pos, mass, softening=softening,
                  eps=eps, g=g)
        for i0 in range(0, n, chunk)
    ])
