"""The TF32 products of the float32 `direct_mxu` kernel
(`spacetpu_torch/csrc/direct.cu`, `direct_mxu_tc_kernel`), emulated in
PyTorch on the plain version's expanded form, and their one-pass wrong
version.

The kernel runs both products of the expanded form on the tensor cores in
TF32 (13 of float32's 24 significant bits dropped, leaving 11): the
distance product

    d2_ij = [x_i, y_i, z_i, |x_i|^2 + eps^2] . [-2x_j, -2y_j, -2z_j, 1] + |x_j|^2

(the last term exact, the accumulator's initial value) and the
accumulation W @ [g m x_j, g m y_j, g m z_j, g m_j] with
W = max(d2, eps^2)^-3/2. Each product takes three terms,
a_hi b_hi + a_lo b_hi + a_hi b_lo, with hi = a rounded to TF32 (to
nearest, ties away: the 13 low mantissa bits rounded off) and lo = a - hi,
itself rounded to TF32 where the kernel stages it (the operands of both
products) and truncated by the tensor core where it does not (W's, split
in registers a pair at a time). The emulation is the expanded form with
those products and nothing else: the kernel's own handling of close and
coincident pairs, which only makes it more exact, is left out, so what it
shows is what the split itself keeps. A one-pass TF32 product (a_hi b_hi
alone) is the wrong version: the expanded d2 of a close pair, a difference
of terms of size |x|^2, loses what matters, and the self pair's weight
(g m / eps^3) times x_i rounded to TF32 no longer cancels against the
rank-1 correction's float32 x_i.

Shared by tests/test_torch_redesign.py, tests/test_torch_gpu.py and
chip_smoke.py. Imports neither JAX nor `spacetpu`.
"""

import torch

#: the hold of direct_mxu in float32: max |kernel - plain| over the term
#: scale (chip_smoke.mxu_term_scale)
F32_TOL = 1e-4

_LOW = 0x1FFF  # the 13 mantissa bits that TF32 drops


def round_tf32(a):
    """float32 -> the nearest TF32 value (ties away from zero), as float32:
    the bit pattern plus half of the dropped part, then the dropped bits
    cleared (cvt.rna.tf32.f32)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~_LOW).view(torch.float32)


def trunc_tf32(a):
    """float32 -> TF32 by dropping the 13 low mantissa bits, as the tensor
    core reads a float32 operand."""
    return (a.contiguous().view(torch.int32) & ~_LOW).view(torch.float32)


def split(a, staged: bool = True):
    """(hi, lo): hi = round_tf32(a) and lo = a - hi (exact in float32),
    rounded to TF32 where the kernel stages it (`staged`), else truncated
    as the tensor core reads a float32 operand."""
    hi = round_tf32(a)
    return hi, (round_tf32 if staged else trunc_tf32)(a - hi)


def product(a, b, terms: int, a_staged: bool = True, c=None):
    """a @ b (+ c) in TF32 on float32 operands: terms=3 the kernel's split,
    terms=1 the one-pass wrong version."""
    a_hi, a_lo = split(a, a_staged)
    b_hi, b_lo = split(b)
    out = a_hi @ b_hi if c is None else c + a_hi @ b_hi
    if terms == 1:
        return out
    if terms != 3:
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return out + (a_lo @ b_hi + a_hi @ b_lo)


def acc_mxu_tf32(pos_i, pos_j, mass_j, *, eps: float, g: float = 1.0,
                 terms: int = 3, chunk: int = 4096):
    """The float32 kernel's function with its TF32 products emulated:
    (M, 3), (K, 3), (K,) float32 -> (M, 3). terms=3 is the kernel's split,
    terms=1 the one-pass wrong version."""
    if pos_i.dtype != torch.float32:
        raise TypeError("the TF32 emulation takes float32 inputs")
    eps2 = eps * eps
    s_i = torch.sum(pos_i * pos_i, -1) + eps2
    a1 = torch.cat([pos_i, s_i[:, None]], 1)
    q_j = torch.sum(pos_j * pos_j, -1)
    b1 = torch.cat([-2.0 * pos_j, torch.ones_like(pos_j[:, :1])], 1)
    k = pos_j.shape[0]
    gm = (mass_j * g)[:, None]
    b2 = torch.cat([gm * pos_j, gm], 1)
    out = []
    for i0 in range(0, pos_i.shape[0], chunk):
        a, xi = a1[i0:i0 + chunk], pos_i[i0:i0 + chunk]
        acc4 = pos_i.new_zeros((a.shape[0], 4))
        for j0 in range(0, k, chunk):
            sl = slice(j0, j0 + chunk)
            d2 = product(a, b1[sl].T, terms, c=q_j[None, sl])
            inv = torch.rsqrt(torch.clamp_min(d2, eps2))
            w = inv * inv * inv
            acc4 = acc4 + product(w, b2[sl], terms, a_staged=False)
        out.append(acc4[:, :3] - acc4[:, 3:4] * xi)
    return torch.cat(out)
