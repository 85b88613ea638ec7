"""The schedule of `pair_potential`'s kernels (`csrc/direct.cu`), emulated
in PyTorch on the CPU for the tests: the diagonal tiles, the bands of the
half ring (`energy.potential_bands`), each unordered tile pair evaluated
once with its row and column halves, and the join in slot order. Not on the
port's path.

`band_tiles` gives the tile pairs of one band launch by the kernel's rule;
`launches_per_call` the kernels that one call of the C entry launches, which
the card tests hold against the count that the entry reports;
`emulate` sums them as the kernels do, a band's row sums added to the
diagonal's in band order and each column partial into its slot, the slots
then added in slot order. `wrong="no_columns"` drops the column halves and
`wrong="half_twice"` takes the d = B/2 offset for every block of an even B,
so that the holds can be shown to tell.
"""

from __future__ import annotations

import numpy as np
import torch

from spacetpu_torch.ops import energy


def band_tiles(nblk: int, d_lo: int, d_hi: int, *, wrong=None):
    """(I, J, slot) arrays of the tile pairs of one band launch: block I
    takes J = (I + d) mod nblk, slot d - d_lo, for d_lo <= d <= d_hi, and
    for an even nblk the offset d = nblk / 2 only for I < nblk / 2
    (`potential_band_kernel`'s `2 * d == nblk && blk >= d`)."""
    blocks, cols, slots = [], [], []
    i = np.arange(nblk)
    for d in range(d_lo, d_hi + 1):
        keep = (~((2 * d == nblk) & (i >= d)) if wrong != "half_twice"
                else np.ones(nblk, dtype=bool))
        blocks.append(i[keep])
        cols.append((i[keep] + d) % nblk)
        slots.append(np.full(int(keep.sum()), d - d_lo))
    if not blocks:
        return (np.zeros(0, dtype=np.int64),) * 3
    return tuple(np.concatenate(a) for a in (blocks, cols, slots))


def launches_per_call(n: int, rows: int, slots: int) -> int:
    """Kernel launches of one ``pair_potential`` call on the card: the
    diagonal tiles, one a band, and the join where there is a band."""
    bands = len(energy.potential_bands(n, rows, slots))
    return 1 + bands + (1 if bands else 0)


def _inv_d(d2):
    # spacetpu/ops/energy.py:58-63: 0 where d^2 = 0, the 1e-38 clamp
    return torch.where(d2 > 0, torch.rsqrt(torch.clamp_min(d2, 1e-38)),
                       torch.zeros_like(d2))


def emulate(pos, mass, *, softening="plummer", eps=0.0, rows, slots,
            wrong=None):
    """(N,) per-body sums sum_{j != i} m_j / d_ij by the kernels' schedule
    with blocks of `rows` rows and bands of at most `slots` offsets."""
    n = pos.shape[0]
    nblk = -(-n // rows)
    pad = nblk * rows - n
    # rows and columns past N: zero bodies at the origin, as the kernels
    # load them
    pos = torch.cat([pos, pos.new_zeros((pad, 3))]).reshape(nblk, rows, 3)
    mass = torch.cat([mass, mass.new_zeros(pad)]).reshape(nblk, rows)
    eps2 = float(eps) ** 2 if softening == "plummer" else 0.0

    def terms(a, b):
        rel = pos[b][None, :, :] - pos[a][:, None, :]
        return _inv_d(torch.sum(rel * rel, dim=-1) + eps2)

    out = torch.zeros_like(mass)
    for blk in range(nblk):
        t = terms(blk, blk)
        t.fill_diagonal_(0.0)  # the self pair, by index
        out[blk] = t @ mass[blk]
    bands = energy.potential_bands(n, rows, slots)
    width = max((hi - lo + 1 for lo, hi in bands), default=0)
    work = mass.new_zeros((width, nblk, rows))
    for lo, hi in bands:
        row_sum = torch.zeros_like(mass)
        for blk, col, slot in zip(*band_tiles(nblk, lo, hi, wrong=wrong)):
            t = terms(blk, col)
            row_sum[blk] += t @ mass[col]
            if wrong != "no_columns":
                work[slot, col] += mass[blk] @ t
        out = out + row_sum
    for slot in range(width):
        out = out + work[slot]
    return out.reshape(-1)[:n]


def close_pairs_case(n, rows, dtype, dev, *, seed, across=True):
    """Seeded bodies (positions uniform in [-1, 1]^3, masses in [0.1, 1])
    with a coincident pair and a pair 1e-20 apart, whose d^2 = 1e-40 is
    subnormal in float32 at eps = 0: in different blocks of `rows` rows
    (`across`, for n > 2 rows + 11) or both inside the first block."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=(n, 3))
    mass = rng.uniform(0.1, 1.0, size=n)
    near = (3, rows + 5) if across else (3, 9)
    same = (10, 2 * rows + 11) if across else (10, 20)
    pos[near[0]] = 0.0
    pos[near[1]] = (1e-20, 0.0, 0.0)
    pos[same[1]] = pos[same[0]]
    return (torch.as_tensor(pos, dtype=dtype, device=dev),
            torch.as_tensor(mass, dtype=dtype, device=dev))
