"""Space-filling-curve keys for spatial sorting (PyTorch).

The counterpart of `spacetpu/ops/morton.py`: bodies are keyed by the
interleaved bits of their quantized coordinates (Morton) or by their
position along the Hilbert curve, and sorted, after which spatially
adjacent bodies are adjacent in memory and fixed-size runs of the sorted
order play the role of tree cells.

Keys are 30-bit values held in int64 tensors: every shift, mask and xor
below stays inside the low 30 bits, so the signed type never shows. The
adaptive clustering sorts by two-word deep keys (`hilbert_keys_2w`,
`sfc_sort_2w`): two 30-bit words, each in its own int64.
"""

from __future__ import annotations

import torch

#: bits per axis (3*10 = 30-bit keys)
BITS = 10


def _spread_bits_10(x):
    """Spread the low 10 bits of x so there are two zero bits between each
    original bit (the classic magic-number dilation)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _quantize(pos, lo, hi, bits: int = BITS):
    """Cell index per axis on a 2^bits grid over [lo, hi], (N, 3) int64.
    The operations and their order are the JAX package's, so float64
    positions give the same cells bit for bit."""
    if lo is None:
        lo = torch.min(pos, dim=0).values
    if hi is None:
        hi = torch.max(pos, dim=0).values
    extent = torch.clamp_min(hi - lo, 1e-30)
    cells = float(1 << bits)
    q = ((pos - lo) / extent * cells).to(torch.int64)  # truncates; q >= 0
    return torch.clamp(q, 0, (1 << bits) - 1)


def _hilbert_axes(q, bits: int):
    """Skilling's AxesToTranspose on (N, 3) cell indices of `bits` bits:
    the three transposed axes, whose interleaved bits are the Hilbert
    index."""
    x = [q[:, 0], q[:, 1], q[:, 2]]

    # Inverse undo excess work (Skilling 2004, AxesToTranspose).
    q_py = 1 << (bits - 1)
    while q_py > 1:
        p = q_py - 1
        for i in range(3):
            cond = (x[i] & q_py) > 0
            # bit set: invert the low bits of x[0]; else swap the low bits
            # of x[0] and x[i]
            t = (x[0] ^ x[i]) & p
            x0_if = x[0] ^ p
            x0_else = x[0] ^ t
            xi_else = x[i] ^ t
            x[0] = torch.where(cond, x0_if, x0_else)
            if i != 0:
                x[i] = torch.where(cond, x[i], xi_else)
        q_py >>= 1

    # Gray encode.
    for i in range(1, 3):
        x[i] = x[i] ^ x[i - 1]
    t = torch.zeros_like(x[0])
    q_py = 1 << (bits - 1)
    while q_py > 1:
        t = torch.where((x[2] & q_py) > 0, t ^ (q_py - 1), t)
        q_py >>= 1
    return [xi ^ t for xi in x]


def _interleave(x, shift: int = 0):
    """The 30-bit Morton interleave of bits [shift, shift + 10) of the three
    transposed axes; x[0] carries the most significant bit of each 3-bit
    digit."""
    return (
        (_spread_bits_10(x[0] >> shift) << 2)
        | (_spread_bits_10(x[1] >> shift) << 1)
        | _spread_bits_10(x[2] >> shift)
    )


def morton_keys(pos, lo=None, hi=None):
    """Quantize positions to a 2^BITS^3 grid over [lo, hi] and interleave.

    pos: (N, 3) -> int64 keys (N,). The bounding box defaults to the data's
    own min/max per axis."""
    q = _quantize(pos, lo, hi)
    x = _spread_bits_10(q[:, 0])
    y = _spread_bits_10(q[:, 1])
    z = _spread_bits_10(q[:, 2])
    return x | (y << 1) | (z << 2)


def hilbert_keys(pos, lo=None, hi=None):
    """Hilbert-curve keys via Skilling's AxesToTranspose transform: ten
    static iterations of vectorized bit operations, then the Morton
    interleave of the transposed axes. The Hilbert curve has no long jumps,
    so equal-count runs of the sorted order are much rounder clusters than
    Z-order runs."""
    return _interleave(_hilbert_axes(_quantize(pos, lo, hi), BITS))


#: bits per axis of the two-word deep keys (3*20 = 60 bits in two 30-bit
#: words): 10-bit keys put the dense core of a high-density-contrast scene
#: (a Plummer sphere spans about 1000x its core radius) inside a handful of
#: finest cells, which defeats the adaptive clustering.
BITS2 = 20


def hilbert_keys_2w(pos, lo=None, hi=None):
    """Deep Hilbert keys as two 30-bit words (hi_word, lo_word), int64.

    The transform of `hilbert_keys` on 20-bit axes; the transposed axes are
    split into their top and bottom 10 bits and interleaved per word, so
    (hi_word, lo_word) compares lexicographically exactly like the 60-bit
    key."""
    x = _hilbert_axes(_quantize(pos, lo, hi, BITS2), BITS2)
    return _interleave(x, 10), _interleave(x, 0)


def _inverse(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def sfc_sort_2w(pos):
    """Sort bodies along the deep (two-word) Hilbert curve.

    Returns (perm, inv, hi_sorted, lo_sorted), all int64: the sorted key
    words are returned because the adaptive clustering reads them. One
    stable sort of the 60-bit key hi << 30 | lo gives the JAX package's
    two-key lexicographic order, ties in body order."""
    hi, lo = hilbert_keys_2w(pos)
    key, perm = torch.sort((hi << 30) | lo, stable=True)
    return perm, _inverse(perm), key >> 30, key & ((1 << 30) - 1)


def morton_order(pos, *, curve: str = "hilbert"):
    """Permutation that sorts bodies along a space-filling curve, and its
    inverse, both int64 (N,). curve: "hilbert" (default; tighter clusters)
    or "morton". The sort is stable, so bodies in one cell keep their
    order, as in the JAX package."""
    keys = hilbert_keys(pos) if curve == "hilbert" else morton_keys(pos)
    perm = torch.argsort(keys, stable=True)
    return perm, _inverse(perm)
