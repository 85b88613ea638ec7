"""All-pairs gravity through hand-written CUDA kernels (``csrc/direct.cu``).

The counterpart of `spacetpu/ops/pallas_direct.py`:

- ``direct_vpu`` replaces ``pallas_direct._kernel`` (launched by
  ``_acc_packed``): exact pairwise differences, plummer or ref law, with the
  ``eps == 0`` diagonal mask.
- ``direct_mxu`` replaces ``pallas_direct._kernel_mxu`` (launched by
  ``_acc_packed_mxu``): the expanded-form distance
  ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j``, accumulating ``[sum w x_j, sum w]``;
  the wrapper applies the rank-1 correction ``- (sum w) x_i``. Plummer with
  ``eps > 0`` only.

What bounds them on an H100: arithmetic; the bytes in and out are
O(M + K). ``direct_vpu`` (and ``direct_mxu`` in float64) run on the CUDA
cores, each thread holding its targets' sums in registers while the block
stages 256-source tiles in shared memory that every thread reads by
broadcast; a pair costs 22 flops under the plummer law and 23 under the ref
law (the JAX package's own count, ``pallas_direct.py:348``) and one
reciprocal square root. In float32 plummer where eps^2 is a normal float32
(the main path's eps 1e-2; the C entry's choice, the predicate of
`cuda_tree.lean_rsqrt`) ``direct_vpu`` takes two targets a thread, each
staged source read once for both, and the MUFU rsqrt alone, to the bits of
the one-target kernel that every other case runs. A float32 eps^2 below
the least normal float32 counts as 0, with the eps == 0 mask, as in the
JAX package's XLA path (`direct.plummer_eps2`). ``direct_mxu`` in float32
runs the TPU kernel's two matrix-unit products on the tensor cores in TF32
with a three-term split, the counterpart of ``Precision.HIGHEST`` (a
one-pass TF32 product would wreck the expanded distance of close pairs):
the first product gives d2,
and the weights pass from its accumulator registers into the second
product's operand without touching memory. Where the caller names its
targets' place among the sources (``self_offset``: ``acc_direct_kernel``
gives 0, a shard of the targets its start), the self pairs, whose exact
term is 0, are dropped by index rather than cancelled by the rank-1
correction; the result never depends on whether the tensors share memory. Left on the CUDA cores are
a max, a rsqrt, two multiplies and the split of each weight; the rsqrt unit
(16 a clock an SM) and the first product's mma, on which each step's
arithmetic waits, bound it (the header of ``csrc/direct.cu`` has the
budget). Its float32 results
are not bit-identical to the plain version, which runs in float32 step by
step: they are held to 1e-4 of the sums that the expanded form subtracts.
No single PyTorch call computes this function. Where M targets fill fewer
blocks than the card has SMs (the multirate fast set), ``direct_vpu``
splits the source axis as well (the C entry's choice, `vpu_slices`) and
joins the slices in a fixed order; its bits then differ from the plain
grid's by the order of the sums, and two calls still agree bit for bit.

A CPU tensor takes the plain PyTorch version beside each kernel. A CUDA
tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spacetpu_torch import _build
from spacetpu_torch.ops import direct

#: Tile sizes of the TPU kernel; accepted for signature parity and ignored.
TILE_I = 512
TILE_J = 2048

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else. A ``direct_vpu``
#: launch on the source-split grid (its kernel and the join) counts one
#: under "direct_vpu" and one under "direct_vpu_split".
LAUNCHES = {"direct_vpu": 0, "direct_vpu_split": 0, "direct_mxu": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_LAWS = {"plummer": 0, "ref": 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.library("direct")
    if lib.spacetpu_direct_vpu.argtypes is None:
        lib.spacetpu_direct_vpu.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, _P, _I64, _I64,
            ctypes.c_double, _P, _I64, _P]
        lib.spacetpu_direct_vpu.restype = ctypes.c_int
        lib.spacetpu_direct_vpu_slices.argtypes = [
            ctypes.c_int, ctypes.c_int, _I64, _I64, ctypes.c_double]
        lib.spacetpu_direct_vpu_slices.restype = ctypes.c_longlong
        lib.spacetpu_direct_mxu.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _I64, _I64, ctypes.c_double,
            _I64, _P]
        lib.spacetpu_direct_mxu.restype = ctypes.c_int
    return lib


def _check_inputs(pos_i, pos_j, mass_j):
    m, k = pos_i.shape[0], pos_j.shape[0]
    if pos_i.shape != (m, 3) or pos_j.shape != (k, 3) or mass_j.shape != (k,):
        raise ValueError(
            f"bad shapes pos_i={tuple(pos_i.shape)} pos_j={tuple(pos_j.shape)}"
            f" mass_j={tuple(mass_j.shape)}")
    if pos_i.dtype not in _DTYPES:
        raise TypeError(f"dtype {pos_i.dtype} is not supported "
                        "(want float32 or float64)")
    if pos_j.dtype != pos_i.dtype or mass_j.dtype != pos_i.dtype:
        raise TypeError("pos_i, pos_j and mass_j must share one dtype")
    if pos_j.device != pos_i.device or mass_j.device != pos_i.device:
        raise ValueError("pos_i, pos_j and mass_j must be on one device")
    if pos_i.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pos_i.device}")


def _check_mxu(softening: str, eps: float):
    if softening != "plummer":
        raise ValueError("method='mxu' supports softening='plummer' only")
    if eps <= 0.0:
        # The expanded-form d2 of a self pair is cancellation noise, not 0,
        # so no mask can find it: the softening floor is the guard.
        raise ValueError("method='mxu' requires eps > 0")


def _resolve(softening: str, eps, g) -> tuple[float, float]:
    if softening not in _LAWS:
        raise ValueError(f"unknown softening {softening!r}")
    return direct._defaults(softening, eps, g)


def _pack_sources(pos_j, mass_j, g: float):
    """(K, 4) rows (x, y, z, g*m); g is folded into the mass here, as the
    TPU wrapper does."""
    return torch.cat([pos_j, (mass_j * g)[:, None]], dim=1).contiguous()


def _sq(pos):
    return torch.sum(pos * pos, dim=-1)


def _rank1(out4, pos_i):
    """acc_i = [sum_j w x_j] - [sum_j w] * x_i."""
    return out4[:, :3] - out4[:, 3:4] * pos_i


def acc_cross_plain(pos_i, pos_j, mass_j, *, softening: str = "plummer",
                    eps=None, g=None):
    """The plain version of ``direct_vpu``."""
    eps, g = _resolve(softening, eps, g)
    return direct.acc_cross_chunked(pos_i, pos_j, mass_j, softening=softening,
                                    eps=eps, g=g)


def acc_cross_mxu_plain(pos_i, pos_j, mass_j, *, eps, g=None,
                        chunk: int = 8192):
    """The plain version of ``direct_mxu``: the expanded form, step by step
    in the kernel's order, over blocks of at most `chunk` targets and
    sources."""
    eps, g = _resolve("plummer", eps, g)
    _check_mxu("plummer", eps)
    eps2 = eps * eps
    sqi = _sq(pos_i) + eps2
    sqj = _sq(pos_j)
    gm = mass_j * g
    out = []
    for i0 in range(0, pos_i.shape[0], chunk):
        xi = pos_i[i0:i0 + chunk]
        si = sqi[i0:i0 + chunk, None]
        acc4 = xi.new_zeros((xi.shape[0], 4))
        for j0 in range(0, pos_j.shape[0], chunk):
            xj = pos_j[j0:j0 + chunk]
            p = xi[:, 0:1] * xj[None, :, 0]
            p = p + xi[:, 1:2] * xj[None, :, 1]
            p = p + xi[:, 2:3] * xj[None, :, 2]
            d2 = si + (sqj[None, j0:j0 + chunk] - 2.0 * p)
            d2 = torch.clamp_min(d2, eps2)
            inv = torch.rsqrt(d2)
            w = gm[None, j0:j0 + chunk] * (inv * inv * inv)
            acc4 = acc4 + torch.cat([w @ xj, w.sum(dim=1, keepdim=True)], 1)
        out.append(_rank1(acc4, xi))
    return torch.cat(out)


def vpu_slices(pos_i, pos_j, softening: str, eps) -> int:
    """The source slices of a ``direct_vpu`` launch on these inputs (on the
    card): 1 where the targets fill the card (the plain grid), else the
    slices of the source-split grid, which the C entry chooses from the
    device's SM count (csrc/direct.cu: vpu_grid)."""
    eps, _ = _resolve(softening, eps, None)
    return _slices(pos_i.device.index, _DTYPES[pos_i.dtype], _LAWS[softening],
                   pos_i.shape[0], pos_j.shape[0], eps)


@functools.lru_cache(maxsize=256)
def _slices(device: int, dtype: int, law: int, m: int, k: int,
            eps: float) -> int:
    """`vpu_slices`, asked of the C entry once a device, dtype, law, shape
    and eps: a multirate step launches the same shape m - 1 times."""
    with torch.cuda.device(device):
        slices = _lib().spacetpu_direct_vpu_slices(dtype, law, m, k, eps)
    if slices < 1:
        raise ValueError(f"direct_vpu takes no launch of {m} targets against "
                         f"{k} sources")
    return slices


def _launch_vpu(pos_i, pos_j, mass_j, softening: str, eps: float, g: float):
    m, k = pos_i.shape[0], pos_j.shape[0]
    out = pos_i.new_empty((m, 3))
    if m == 0:
        return out
    tgt = pos_i.contiguous()
    src = _pack_sources(pos_j, mass_j, g)
    slices = vpu_slices(pos_i, pos_j, softening, eps)
    work = pos_i.new_empty((slices, m, 3)) if slices > 1 else None
    with torch.cuda.device(pos_i.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().spacetpu_direct_vpu(
            _DTYPES[pos_i.dtype], _LAWS[softening], tgt.data_ptr(),
            src.data_ptr(), out.data_ptr(), m, k, eps,
            None if work is None else work.data_ptr(), slices, stream)
    if rc != 0:
        raise RuntimeError(f"direct_vpu launch failed: CUDA error {rc}")
    LAUNCHES["direct_vpu"] += 1
    LAUNCHES["direct_vpu_split"] += slices > 1
    return out


def _launch_mxu(pos_i, pos_j, mass_j, eps: float, g: float,
                self_offset):
    m, k = pos_i.shape[0], pos_j.shape[0]
    if m == 0:
        return pos_i.new_empty((0, 3))
    tgt = torch.cat([pos_i, _sq(pos_i)[:, None]], dim=1).contiguous()
    src = _pack_sources(pos_j, mass_j, g)
    sq = _sq(pos_j).contiguous()
    out4 = pos_i.new_empty((m, 4))
    with torch.cuda.device(pos_i.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().spacetpu_direct_mxu(
            _DTYPES[pos_i.dtype], tgt.data_ptr(), src.data_ptr(),
            sq.data_ptr(), out4.data_ptr(), m, k, eps,
            -1 if self_offset is None else self_offset, stream)
    if rc != 0:
        raise RuntimeError(f"direct_mxu launch failed: CUDA error {rc}")
    LAUNCHES["direct_mxu"] += 1
    return _rank1(out4, pos_i)


def acc_cross_kernel(pos_i, pos_j, mass_j, *, softening: str = "plummer",
                     eps=None, g=None, tile_i: int = TILE_I,
                     tile_j: int = TILE_J, interpret=None,
                     method: str = "vpu", self_offset: int | None = None):
    """Acceleration of `pos_i` targets due to `pos_j`/`mass_j` sources,
    (M, 3), (K, 3), (K,) -> (M, 3), with the signature of
    `spacetpu.ops.pallas_direct.acc_cross_pallas` (the tile and interpret
    arguments are accepted and ignored).

    method="vpu": exact pairwise differences (default). method="mxu": the
    expanded form; plummer softening with eps > 0 only.

    self_offset: target i is source i + self_offset (the caller's promise;
    0 <= self_offset <= K - M), or None. The float32 mxu kernel drops those
    pairs, whose exact term is 0, by index; every other form sums them as
    it sums any pair (the plain versions included)."""
    del tile_i, tile_j, interpret
    eps, g = _resolve(softening, eps, g)
    if method not in ("vpu", "mxu"):
        raise ValueError(f"unknown method {method!r} (want 'vpu' or 'mxu')")
    if method == "mxu":
        _check_mxu(softening, eps)
    _check_inputs(pos_i, pos_j, mass_j)
    if self_offset is not None and not (
            0 <= self_offset <= pos_j.shape[0] - pos_i.shape[0]):
        raise ValueError(f"self_offset {self_offset} puts the targets "
                         "outside the sources")
    if pos_i.device.type == "cpu":
        if method == "mxu":
            return acc_cross_mxu_plain(pos_i, pos_j, mass_j, eps=eps, g=g)
        return acc_cross_plain(pos_i, pos_j, mass_j, softening=softening,
                               eps=eps, g=g)
    if method == "mxu":
        return _launch_mxu(pos_i, pos_j, mass_j, eps, g, self_offset)
    return _launch_vpu(pos_i, pos_j, mass_j, softening, eps, g)


def acc_direct_kernel(pos, mass, **kw):
    """All-pairs acceleration (N, 3), (N,) -> (N, 3) via the kernels."""
    return acc_cross_kernel(pos, pos, mass, self_offset=0, **kw)
