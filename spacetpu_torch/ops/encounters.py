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

So each row's (least r^2, index) is the least candidate (r^2, j) in
lexicographic order, starting from (+inf, 0), whatever the order in which
the candidates are met; and r^2 of (i, j) and of (j, i) have the same bits.
A CUDA tensor runs the hand-written kernels of ``csrc/encounter.cu``:
``nearest_neighbor`` takes each unordered pair once, on
``pair_potential``'s half ring (the diagonal tiles, bands of
``energy.potential_bands``, the join), with a row's and a column's least in
registers; ``nearest_rows`` searches some rows again against every body,
and ``nearest_update`` compares every row with one moved body (the table
that ``collisions.merge_all_overlapping`` keeps across its merges). They
replace no TPU kernel (the JAX package leaves this pass to XLA); no PyTorch
call computes them either (`torch.cdist` materialises N x N). A CPU tensor
takes the plain versions: the JAX package's two code paths, dense where N
<= chunk, sources in chunks above. All round r^2 as ``(dx dx + dy dy) + dz
dz``, one step at a time, so that they find the same neighbours. Nothing
falls back from the card to a plain version.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build
from spacetpu_torch.ops import energy

#: Calls since the last reset, by kernel. A wrapper adds one where it
#: launches its kernels, and nowhere else: a ``nearest_neighbor`` call on
#: the card counts one, though it launches the diagonal kernel, a kernel a
#: band and the join (``KERNEL_LAUNCHES``).
LAUNCHES = {"nearest_neighbor": 0, "nearest_rows": 0, "nearest_update": 0}

#: Kernels launched since the last reset, as the C entries report them.
KERNEL_LAUNCHES = {"nearest_neighbor_kernels": 0, "nearest_rows_kernels": 0}

#: Offsets of the half ring a band launch of ``nearest_neighbor`` takes:
#: the scratch of the column candidates is NEAREST_SLOTS * N (r^2, int32)
#: pairs (128 MB at 1M float32 bodies).
NEAREST_SLOTS = 16

_DTYPES = {torch.float32: 0, torch.float64: 1}
_P = ctypes.c_void_p
_LL = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.library("encounter")
    if lib.spacetpu_nearest_neighbor.argtypes is None:
        lib.spacetpu_nearest_neighbor.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _LL, _P, _P, ctypes.c_int,
            ctypes.POINTER(_LL), ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            _P]
        lib.spacetpu_nearest_neighbor.restype = ctypes.c_int
        lib.spacetpu_nearest_neighbor_rows.argtypes = [ctypes.c_int]
        lib.spacetpu_nearest_neighbor_rows.restype = ctypes.c_int
        lib.spacetpu_nearest_rows_slices.argtypes = [_LL]
        lib.spacetpu_nearest_rows_slices.restype = _LL
        lib.spacetpu_nearest_rows.argtypes = [
            ctypes.c_int, _P, _P, _P, _LL, _P, _P, _LL, _P, _P,
            ctypes.POINTER(ctypes.c_int), _P]
        lib.spacetpu_nearest_rows.restype = ctypes.c_int
        lib.spacetpu_nearest_update.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _LL, _P, _P, _P, _P, _P]
        lib.spacetpu_nearest_update.restype = ctypes.c_int
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
    if not best:
        return pos.new_empty(0), torch.zeros(0, dtype=torch.int64,
                                             device=pos.device)
    return torch.cat(best), torch.cat(arg)


def _check(pos, mask, name):
    n = pos.shape[0]
    if pos.shape != (n, 3) or pos.dtype not in _DTYPES:
        raise ValueError(f"bad positions {tuple(pos.shape)} {pos.dtype}")
    if pos.device.type != "cuda":
        raise ValueError(f"{name} runs on the card, not {pos.device}")
    if mask is not None and (mask.shape != (n,)
                             or mask.device != pos.device):
        raise ValueError(f"bad mask {tuple(mask.shape)} on {mask.device}")
    alive = None if mask is None else mask.to(torch.uint8).contiguous()
    return pos.contiguous(), alive


def _ptr(t):
    return None if t is None else t.data_ptr()


def nearest_neighbor_rows(dtype) -> int:
    """The rows a block of the ``nearest_neighbor`` kernels takes in
    `dtype` (the built library's constant)."""
    return int(_lib().spacetpu_nearest_neighbor_rows(_DTYPES[dtype]))


def nearest_neighbor_kernel(pos, mask=None):
    """(best_r2, idx) of every body through the ``nearest_neighbor``
    kernels; `pos` (N, 3) float32 or float64 on the card, `mask` (N,) bool
    or None."""
    p, alive = _check(pos, mask, "nearest_neighbor_kernel")
    n = pos.shape[0]
    best = pos.new_empty(n)
    idx = torch.empty(n, dtype=torch.int64, device=pos.device)
    if n == 0:
        return best, idx
    bands = energy.potential_bands(n, nearest_neighbor_rows(pos.dtype),
                                   NEAREST_SLOTS)
    slots = max((hi - lo + 1 for lo, hi in bands), default=0)
    work_v = pos.new_empty((slots, n))
    work_i = torch.empty((slots, n), dtype=torch.int32, device=pos.device)
    flat = (_LL * (2 * len(bands)))(*(d for band in bands for d in band))
    launched = ctypes.c_int(0)
    with torch.cuda.device(pos.device):
        rc = _lib().spacetpu_nearest_neighbor(
            _DTYPES[pos.dtype], p.data_ptr(), _ptr(alive), best.data_ptr(),
            idx.data_ptr(), n, work_v.data_ptr(), work_i.data_ptr(), slots,
            flat, len(bands), ctypes.byref(launched),
            torch.cuda.current_stream().cuda_stream)
    KERNEL_LAUNCHES["nearest_neighbor_kernels"] += launched.value
    if rc != 0:
        raise RuntimeError(f"nearest_neighbor launch failed: CUDA error {rc}")
    LAUNCHES["nearest_neighbor"] += 1
    return best, idx


def nearest_table(pos, mask=None, *, chunk: int = 4096):
    """(best_r2, idx) of every body: the kernels on the card (`chunk`
    unused), the plain version on the CPU."""
    if pos.device.type == "cuda":
        return nearest_neighbor_kernel(pos, mask)
    return nearest_neighbor_plain(pos, mask, chunk=chunk)


def nearest_rows_plain(pos, mask, rows, best, idx, *, chunk: int = 4096):
    """The plain version of ``nearest_rows``: the table's `rows` (int64)
    searched again against every live body, in place."""
    b, a = nearest_neighbor_plain(pos, mask, chunk=chunk, rows=rows)
    best[rows] = b
    idx[rows] = a


def nearest_rows(pos, mask, rows, best, idx, *, chunk: int = 4096):
    """Search the rows `rows` ((R,) int64, distinct) of the table (best,
    idx) again against every live body, in place: the ``nearest_rows``
    kernels on the card (each block a slice of the sources, the slices
    joined), the plain version on the CPU."""
    if pos.device.type != "cuda":
        nearest_rows_plain(pos, mask, rows, best, idx, chunk=chunk)
        return
    p, alive = _check(pos, mask, "nearest_rows")
    n, r = pos.shape[0], rows.numel()
    if (rows.dtype != torch.int64 or rows.device != pos.device
            or best.shape != (n,) or best.dtype != pos.dtype
            or idx.shape != (n,) or idx.dtype != torch.int64
            or not (best.is_contiguous() and idx.is_contiguous())):
        raise ValueError("nearest_rows: bad rows or table")
    if r == 0:
        return
    rows = rows.contiguous()
    slices = int(_lib().spacetpu_nearest_rows_slices(n))
    work_v = pos.new_empty((slices, r))
    work_i = torch.empty((slices, r), dtype=torch.int32, device=pos.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(pos.device):
        rc = _lib().spacetpu_nearest_rows(
            _DTYPES[pos.dtype], p.data_ptr(), _ptr(alive), rows.data_ptr(),
            r, best.data_ptr(), idx.data_ptr(), n, work_v.data_ptr(),
            work_i.data_ptr(), ctypes.byref(launched),
            torch.cuda.current_stream().cuda_stream)
    KERNEL_LAUNCHES["nearest_rows_kernels"] += launched.value
    if rc != 0:
        raise RuntimeError(f"nearest_rows launch failed: CUDA error {rc}")
    LAUNCHES["nearest_rows"] += 1


def nearest_update_plain(pos, mask, best, idx, i, j):
    """The plain version of ``nearest_update``: body i moved and body j
    died (0-dim int64 tensors; `pos` and `mask` as they are after the
    merge). The rows to search again, {i, j} and those whose neighbour was
    i or j, are returned as (rows, count); every other row takes (r^2 to i,
    i) where that is lexicographically less than its own and i is live. The
    table (best, idx) is updated in place."""
    n = pos.shape[0]
    k = torch.arange(n, device=pos.device)
    again = (k == i) | (k == j) | (idx == i) | (idx == j)
    r2 = _r2(pos, pos[i.reshape(1)])[:, 0]
    take = ~again & ((r2 < best) | ((r2 == best) & (i < idx)))
    if mask is not None:
        take &= mask[i]
    best.copy_(torch.where(take, r2, best))
    idx.copy_(torch.where(take, i, idx))
    rows = torch.nonzero(again).flatten()
    return rows, torch.tensor(rows.numel(), dtype=torch.int32,
                              device=pos.device)


def nearest_update(pos, mask, best, idx, i, j):
    """Update the table (best, idx) for a merge of (i, j), in place, and
    list the rows it leaves to ``nearest_rows``: (rows, count), the first
    `count` entries of `rows` (count a 0-dim int32 tensor, so that the
    caller reads it back with what it reads anyway). On the card the
    ``nearest_update`` kernel (its list in no fixed order), on the CPU the
    plain version."""
    if pos.device.type != "cuda":
        return nearest_update_plain(pos, mask, best, idx, i, j)
    p, alive = _check(pos, mask, "nearest_update")
    n = pos.shape[0]
    if (best.shape != (n,) or best.dtype != pos.dtype or idx.shape != (n,)
            or idx.dtype != torch.int64
            or not (best.is_contiguous() and idx.is_contiguous())):
        raise ValueError("nearest_update: bad table")
    i = torch.as_tensor(i, dtype=torch.int64, device=pos.device).reshape(())
    j = torch.as_tensor(j, dtype=torch.int64, device=pos.device).reshape(())
    rows = torch.empty(n, dtype=torch.int64, device=pos.device)
    count = torch.empty((), dtype=torch.int32, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = _lib().spacetpu_nearest_update(
            _DTYPES[pos.dtype], p.data_ptr(), _ptr(alive), best.data_ptr(),
            idx.data_ptr(), n, i.contiguous().data_ptr(),
            j.contiguous().data_ptr(), rows.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nearest_update launch failed: CUDA error {rc}")
    LAUNCHES["nearest_update"] += 1
    return rows, count


def closest(best, idx, mask=None):
    """The closest pair of a table (best, idx): (distance, i, j) as 0-dim
    tensors, i the first row of least distance among the unmasked rows, j
    its neighbour; distance +inf where fewer than two rows are live."""
    dist = torch.sqrt(best)
    if mask is not None:
        dist = torch.where(mask, dist, torch.inf)
    i = torch.argmin(dist)
    return dist[i], i, idx[i]


def nearest_neighbor(pos, *, mask=None, chunk: int = 4096):
    """Per-body nearest neighbour: (dist, idx), each (N,), idx int64. On
    the card the kernels (`chunk` unused), on the CPU the plain version."""
    best, idx = nearest_table(pos, mask, chunk=chunk)
    dist = torch.sqrt(best)
    if mask is not None:
        dist = torch.where(mask, dist, torch.inf)
    return dist, idx


def min_separation(pos, *, mask=None, chunk: int = 4096):
    """Global minimum separation among unmasked rows: (distance, i, j) as
    0-dim tensors, i the body whose nearest neighbour j is closest (the
    first such i); distance +inf where fewer than two rows are live."""
    best, idx = nearest_table(pos, mask, chunk=chunk)
    return closest(best, idx, mask)
