"""Close-encounter telemetry: nearest neighbours and the least separation.

The counterpart of `spacetpu/ops/encounters.py`: each body's nearest
neighbour and the global minimum separation, the O(N^2) pass that
``--report-encounters`` and every collision check (`ops/collisions.py`)
run. Semantics, as the JAX package has them:

- the self pair is dropped by index, not by r^2 = 0: two live bodies at
  one point are each other's neighbour at distance 0;
- ``mask`` (N,) bool drops rows: a masked row is never a source, and as a
  target gets distance +inf, but still the index of its nearest live
  source; a row with no live source gets (+inf, 0);
- ties go to the lowest source index;
- bodies are compared by position only (a massless tracer is a neighbour
  like any other).

A CUDA tensor runs the hand-written kernel ``nearest_neighbor``
(``csrc/encounter.cu``): a thread keeps two targets' least r^2 and its
index in registers while its block stages 256 bodies at a time in shared
memory. It replaces no TPU kernel (the JAX package leaves this pass to
XLA); no PyTorch call computes it either (`torch.cdist` materialises
N x N). A CPU tensor takes the plain version, the JAX package's two code
paths: dense where N <= chunk, sources in chunks above. Both round r^2 as
``(dx dx + dy dy) + dz dz``, one step at a time, so that they find the same
neighbours. Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build

#: Kernel launches since the last reset. The wrapper adds one where it
#: launches its kernel, and nowhere else.
LAUNCHES = {"nearest_neighbor": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.library("encounter")
    if lib.spacetpu_nearest_neighbor.argtypes is None:
        lib.spacetpu_nearest_neighbor.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong, _P]
        lib.spacetpu_nearest_neighbor.restype = ctypes.c_int
    return lib


def _r2(pos_i, pos_j):
    """(M, K) squared distances of sources `pos_j` from targets `pos_i`,
    d = p_j - p_i, as (dx dx + dy dy) + dz dz with every step rounded."""
    d = [pos_j[None, :, c] - pos_i[:, c, None] for c in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def nearest_neighbor_plain(pos, mask=None, *, chunk: int = 4096,
                           rows=None):
    """The plain version: (best_r2, idx) of the targets `rows` (int64
    indices; None = every body), the least r^2 over the live sources other
    than the target and the first source that reaches it. Dense where every
    body is a target and N <= chunk; otherwise the sources go in chunks of
    `chunk` (and the targets too, so that memory is O(chunk^2)), a later
    chunk taking over only where its least r^2 is strictly smaller."""
    n = pos.shape[0]
    inf = torch.tensor(torch.inf, dtype=pos.dtype, device=pos.device)
    if rows is None and n <= chunk:
        r2 = _r2(pos, pos)
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        r2 = torch.where(eye, inf, r2)
        if mask is not None:
            r2 = torch.where(mask[None, :], r2, inf)
        best, idx = torch.min(r2, dim=1)
        return best, idx
    if rows is None:
        rows = torch.arange(n, device=pos.device)
    live = (torch.ones(n, dtype=torch.bool, device=pos.device)
            if mask is None else mask)
    best, arg = [], []
    for t0 in range(0, rows.numel(), chunk):
        ti = rows[t0:t0 + chunk]
        pi = pos[ti]
        b2 = torch.full((ti.numel(),), torch.inf, dtype=pos.dtype,
                        device=pos.device)
        bj = torch.zeros(ti.numel(), dtype=torch.int64, device=pos.device)
        for j0 in range(0, n, chunk):
            jidx = torch.arange(j0, min(j0 + chunk, n), device=pos.device)
            r2 = _r2(pi, pos[j0:j0 + chunk])
            drop = (ti[:, None] == jidx[None, :]) | ~live[None, j0:j0 + chunk]
            r2 = torch.where(drop, inf, r2)
            m, a = torch.min(r2, dim=1)
            take = m < b2
            b2 = torch.where(take, m, b2)
            bj = torch.where(take, jidx[a], bj)
        best.append(b2)
        arg.append(bj)
    return torch.cat(best), torch.cat(arg)


def nearest_neighbor_kernel(pos, mask=None):
    """(best_r2, idx) of every body through the ``nearest_neighbor``
    kernel; `pos` (N, 3) float32 or float64 on the card, `mask` (N,) bool
    or None."""
    n = pos.shape[0]
    if pos.shape != (n, 3) or pos.dtype not in _DTYPES:
        raise ValueError(f"bad positions {tuple(pos.shape)} {pos.dtype}")
    if pos.device.type != "cuda":
        raise ValueError(f"nearest_neighbor_kernel runs on the card, not "
                         f"{pos.device}")
    if mask is not None and (mask.shape != (n,)
                             or mask.device != pos.device):
        raise ValueError(f"bad mask {tuple(mask.shape)} on {mask.device}")
    best = pos.new_empty(n)
    idx = torch.empty(n, dtype=torch.int64, device=pos.device)
    if n == 0:
        return best, idx
    p = pos.contiguous()
    alive = None if mask is None else mask.to(torch.uint8).contiguous()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().spacetpu_nearest_neighbor(
            _DTYPES[pos.dtype], p.data_ptr(),
            None if alive is None else alive.data_ptr(), best.data_ptr(),
            idx.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"nearest_neighbor launch failed: CUDA error {rc}")
    LAUNCHES["nearest_neighbor"] += 1
    return best, idx


def nearest_neighbor(pos, *, mask=None, chunk: int = 4096):
    """Per-body nearest neighbour: (dist, idx), each (N,), idx int64. On
    the card the kernel (`chunk` unused), on the CPU the plain version."""
    if pos.device.type == "cuda":
        best, idx = nearest_neighbor_kernel(pos, mask)
    else:
        best, idx = nearest_neighbor_plain(pos, mask, chunk=chunk)
    dist = torch.sqrt(best)
    if mask is not None:
        dist = torch.where(mask, dist, torch.inf)
    return dist, idx


def min_separation(pos, *, mask=None, chunk: int = 4096):
    """Global minimum separation among unmasked rows: (distance, i, j) as
    0-dim tensors, i the body whose nearest neighbour j is closest (the
    first such i); distance +inf where fewer than two rows are live."""
    dist, idx = nearest_neighbor(pos, mask=mask, chunk=chunk)
    i = torch.argmin(dist)
    return dist[i], i, idx[i]
