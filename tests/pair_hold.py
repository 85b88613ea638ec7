"""How closely the body pair kernels of `spacetpu_torch.ops.cuda_tree`
(`pairs_hybrid`, `pairs_short`, `pairs_short_hybrid`) must match exact sums
in float32, and the inputs they are held on.

Without softening, close pairs make a target's force a small difference of
large terms; the short-range law is itself a difference, the softened
weight minus the long-range one; and in the hybrid form every pair rides
two sums at about a cluster's radius. A share of max|a| bounds none of
these. So a float32 result is held target by target and axis by axis
against the same sum taken in float64 on the same inputs, over the size of
what its arithmetic rounds: sum_j W_j |x_j - x_i|, plus in the centred
rank-1 form sum_j W_j (|x_j - c| + |x_i - c|), where W_j is |w_j| for the
direct law and |w_pair| + |w_long| (both times g m_j) for the short-range
law. A kernel that is right up to float32 rounding stays far below
`F32_TOL` of that size; one that drops a term, the subtraction or the
split does not (`mutant_ratios`).

Shared by tests/test_torch_gpu.py, tests/test_torch_pair_hold.py and
chip_smoke.py. Imports neither JAX nor `spacetpu`.
"""

import math

import numpy as np
import torch

from spacetpu_torch.ops import cuda_tree, direct
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.ops import treepm as treepm_ops

#: float32: |result - float64 sum| <= F32_TOL * term size, every target, axis
F32_TOL = 1e-5

#: (short-range law, hybrid sums) of each body kernel
KERNELS = {"pairs_hybrid": (False, True), "pairs_short": (True, False),
           "pairs_short_hybrid": (True, True)}


def short_inputs(n, leaf, rcut, dtype, dev):
    """A TreePM cutoff tile list of a uniform cloud built by the port's own
    treepm_prep (every cluster's list uncapped), with the tree's source
    table (a -M pseudo-body a cluster) under True and TreePM's (a massless
    pseudo slot) under False."""
    rng = np.random.default_rng(n)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    gg = -(-n // leaf)
    prep = treepm_ops.treepm_prep(pos, mass, rcut=rcut, k_near=gg, gg=gg,
                                  leaf=leaf)
    stats = (prep["pos_g"], prep["mass_g"], prep["com"], prep["m_tot"])
    return prep, {p: tree_ops._pack_augmented(*stats, 1.0, monopole_pseudo=p)
                  for p in (True, False)}


def _weight(softening, eps, rs=None, rcut=None, split=None):
    if split is None:
        return lambda r2: direct._pair_weight(r2, softening, float(eps))
    return cuda_tree._short_weight(softening, eps, rs, rcut, split)


def _walk(pos_g, srows, flat_src, tile_tgt, contrib, channels):
    """Sum contrib(targets (C, leaf, 3), sources (4, C, cols), the three
    differences, r^2) over the tile list into (G, leaf, channels), as
    `cuda_tree._pairs_plain` walks it."""
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    table = srows[:4].reshape(4, -1, block)
    srcs = flat_src.reshape(tile_tgt.shape[0], -1)
    pos_ext = torch.cat([pos_g, pos_g.new_zeros((1, leaf, 3))])
    out = pos_g.new_zeros((gg + 1, leaf, channels))
    chunk = max(1, cuda_tree._PLAIN_ELEMS // (leaf * srcs.shape[1] * block))
    for t0 in range(0, tile_tgt.shape[0], chunk):
        ids, tgt_ids = srcs[t0:t0 + chunk], tile_tgt[t0:t0 + chunk]
        tgt = pos_ext[tgt_ids]
        src = table[:, ids].reshape(4, ids.shape[0], -1)
        d = [src[k, :, None, :] - tgt[:, :, k:k + 1] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        out.index_add_(0, tgt_ids, contrib(tgt, src, d, r2))
    return out[:gg]


def _masked_weights(weight, src, r2):
    return torch.where(r2 > 0.0, weight(r2) * src[3, :, None, :], 0.0)


def exact_sums(name, args, kw):
    """The float64 sums of kernel `name` on `args` (pos_g, srows, flat_src,
    tile_tgt, in any dtype) with weight parameters `kw`: (G, leaf, 6), the
    sum sum_j w_j (x_j - x_i) in [..., :3] and the size of what the
    kernel's float32 arithmetic rounds (the module's docstring) in
    [..., 3:]."""
    short, hybrid = KERNELS[name]
    weight = _weight(**kw)
    pair = _weight(kw["softening"], kw["eps"])
    pos_g, srows, flat_src, tile_tgt = args

    def contrib(tgt, src, d, r2):
        w = _masked_weights(weight, src, r2)
        if short:
            wp = _masked_weights(pair, src, r2)
            size_w = torch.where(w != 0.0, wp.abs() + (wp - w).abs(), 0.0)
        else:
            size_w = w.abs()
        sums = [torch.sum(w * dk, dim=-1) for dk in d]
        size = [torch.sum(size_w * dk.abs(), dim=-1) for dk in d]
        if hybrid:
            c = tgt[:, 0:1, :]
            sw = torch.sum(size_w, dim=-1)
            size = [size[k] + torch.sum(size_w * torch.abs(
                src[k, :, None, :] - c[:, :, k:k + 1]), dim=-1)
                + sw * torch.abs(tgt[:, :, k] - c[:, :, k]) for k in range(3)]
        return torch.stack(sums + size, dim=-1)

    return _walk(pos_g.double(), srows.double(), flat_src, tile_tgt, contrib,
                 6)


def hold(got, exact) -> dict:
    """`got` against `exact_sums`: `ratio` is the worst |got - sum| over
    the term size (an error where the size is 0 counts as infinite; a NaN
    stays NaN, so `ok` is False), `term_over_a` the largest term size over
    max|a|."""
    err = (got.double() - exact[..., :3]).abs()
    size = exact[..., 3:]
    ratio = torch.where(size > 0.0, err / size,
                        torch.where(err > 0.0, math.inf, 0.0))
    worst = float(ratio.max())
    return {"hold_ratio": worst, "hold_tol": F32_TOL, "ok": worst <= F32_TOL,
            "term_over_a": float(size.max() / exact[..., :3].abs().max())}


def mutant_ratios(name, args, kw, exact) -> dict:
    """`hold`'s ratio of deliberately wrong float32 versions of kernel
    `name`, to show that the limit fails them: a result of zeros; for the
    short-range law the other split; for the hybrid sums the rank-1 form
    without its subtraction of (sum_j w_j)(x_i - c)."""
    short, hybrid = KERNELS[name]
    out = {"zeros": hold(torch.zeros_like(args[0]), exact)["hold_ratio"]}
    if short:
        other = dict(kw, split={"poly": "gauss", "gauss": "poly"}[kw["split"]])
        got = getattr(cuda_tree, f"near_{name}_plain")(*args, **other)
        out["other_split"] = hold(got, exact)["hold_ratio"]
    if hybrid:
        weight = _weight(**kw)

        def no_subtraction(tgt, src, d, r2):
            w = _masked_weights(weight, src, r2)
            c = tgt[:, 0:1, :]
            return torch.stack([
                torch.sum(w * (src[k, :, None, :] - c[:, :, k:k + 1]), dim=-1)
                for k in range(3)], dim=-1)

        got = _walk(*args, no_subtraction, 3)
        out["no_subtraction"] = hold(got, exact)["hold_ratio"]
    return out
