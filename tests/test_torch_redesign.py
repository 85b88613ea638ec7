"""The parts of the redesigned kernels that run on the CPU, against the JAX
package where it has a counterpart.

- `splat_tiles` cuts each tile's entries into segments of at most
  `cuda_splat.SEG` and sums a hot tile's partial windows in segment order:
  the segment table (built from CPU tensors as the wrapper builds it on
  the card) and, in float64, the merge against `splat_tiles_plain`
  (1e-12: only the order of the sums differs).
- `direct_mxu` in float32 runs its two products in TF32 with a three-term
  split: emulated in PyTorch (tests/tf32_split.py) at N = 4099, where the
  split stays within the kernel's hold (1e-4 of chip_smoke.mxu_term_scale)
  and the one-pass TF32 product fails it.
- `potential_energy` on a CPU tensor takes the plain version of
  `pair_potential` and matches `spacetpu.ops.energy.potential_energy`
  (rtol 1e-12 in float64), launching nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spacetpu.models import presets as jpresets
from spacetpu.ops import energy as jenergy
from spacetpu_torch.models import presets as tpresets
from spacetpu_torch.ops import cuda_direct
from spacetpu_torch.ops import energy as tenergy
from spacetpu_torch.render import cuda_splat
from spacetpu_torch.render import fastsplat as fs
from tests import splat_hold, tf32_split
from tests.parity import one_torch_thread  # noqa: F401

SEG = cuda_splat.SEG


def _keys(counts, sentinel=5):
    """Sorted int32 keys: counts[t] entries of tile t, then `sentinel`
    entries of the sentinel tile T."""
    t = len(counts)
    keys = np.repeat(np.arange(t + 1), list(counts) + [sentinel])
    return torch.as_tensor(keys, dtype=torch.int32), t


def _check_table(keys, n_tiles):
    starts = fs.tile_starts(keys, n_tiles)
    table = cuda_splat.segment_table(starts, n_tiles, keys.shape[0])
    tile, lo, hi, slot = (table[k].tolist()
                          for k in ("tile", "lo", "hi", "slot"))
    starts = starts.tolist()
    assert len(tile) == cuda_splat.max_segments(keys.shape[0], n_tiles)
    live = [b for b, t in enumerate(tile) if t < n_tiles]
    # the live segments come first, in tile order, and cover each tile's
    # range exactly once, in order, none longer than SEG
    assert live == list(range(len(live)))
    for t in range(n_tiles):
        mine = [b for b in live if tile[b] == t]
        assert mine == sorted(mine)
        cover = [(lo[b], hi[b]) for b in mine]
        if starts[t] == starts[t + 1]:
            assert cover == []  # an empty tile makes no segment
            continue
        assert cover[0][0] == starts[t] and cover[-1][1] == starts[t + 1]
        assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
        assert all(0 < h - l <= SEG for l, h in cover)
        assert table["nseg"][t] == len(mine)
        # a tile of one segment writes in place; a hotter one's partials
        # are consecutive slots, in segment order
        slots = [slot[b] for b in mine]
        if len(mine) == 1:
            assert slots == [-1]
        else:
            first = int(table["pfirst"][t])
            assert slots == list(range(first, first + len(mine)))
    # the sentinel entries (from starts[T]) are in no segment
    assert all(hi[b] <= starts[n_tiles] for b in live)
    assert all(lo[b] == hi[b] == 0 for b in range(len(tile)) if b not in live)
    n_partials = sum(s >= 0 for s in slot)
    assert n_partials <= cuda_splat.max_partials(keys.shape[0], n_tiles)
    return table


@pytest.mark.parametrize("count", [0, 1, SEG, SEG + 1, "hot"])
def test_segment_table_covers_one_tile(count):
    """One tile between two empty ones: 0, 1, SEG and SEG + 1 entries, and
    splat_hold.hot_entries()' hot tile (5,000 entries, three segments)."""
    if count == "hot":
        keys, _, _, n_tiles = splat_hold.sorted_entries(
            splat_hold.hot_entries(), 256, 96, "cpu")
        count = int((keys < n_tiles).sum())
        assert count == 5000
    else:
        keys, n_tiles = _keys([0, count, 0])
    table = _check_table(keys, n_tiles)
    assert int(table["nseg"].sum()) == -(-count // SEG)


def test_segment_table_many_tiles():
    """Tiles of every size class side by side, with empty tiles between."""
    keys, n_tiles = _keys([3, 0, SEG, 0, 0, 5 * SEG + 3, SEG + 1, 1, 0],
                          sentinel=SEG + 7)
    table = _check_table(keys, n_tiles)
    assert table["nseg"].tolist() == [1, 0, 1, 0, 0, 6, 2, 1, 0]


def _segment_windows(keys, pay1, pay2, n_tiles, dtype):
    """Each live segment's window by the plain version over its entries
    alone, summed into its tile in segment order."""
    table = cuda_splat.segment_table(fs.tile_starts(keys, n_tiles), n_tiles,
                                     keys.shape[0])
    out = torch.zeros((n_tiles, fs.WIN_H * 3, fs.WIN_W), dtype=dtype)
    for t, lo, hi in zip(*(table[k].tolist() for k in ("tile", "lo", "hi"))):
        if t >= n_tiles:
            continue
        out[t] += cuda_splat.splat_tiles_plain(
            keys[lo:hi] - t, pay1[lo:hi], pay2[lo:hi], n_tiles=1,
            dtype=dtype)[0]
    return out


@pytest.mark.parametrize("case", ["rand", "hot"])
def test_segment_merge_matches_plain_in_float64(case):
    """The segments' windows summed in segment order are the tile windows
    (float64: only the order of the sums differs, 1e-12 of the largest)."""
    entries = (splat_hold.rand_entries(3000, 256, 96) if case == "rand"
               else splat_hold.hot_entries())
    keys, pay1, pay2, n_tiles = splat_hold.sorted_entries(entries, 256, 96,
                                                          "cpu")
    got = _segment_windows(keys, pay1, pay2, n_tiles, torch.float64)
    want = cuda_splat.splat_tiles_plain(keys, pay1, pay2, n_tiles=n_tiles,
                                        dtype=torch.float64)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_round_tf32_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 0.1],
                     dtype=torch.float32)
    got = tf32_split.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 0.0999755859375])
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    hi, lo = tf32_split.split(x)
    # exact where x has at most 22 significant bits; 0.1 keeps 22 of its 24
    assert torch.equal((hi + lo)[:5], x[:5])
    assert float((hi + lo - x).abs()[5]) <= 2.0 ** -22 * 0.1


def test_tf32_split_holds_and_one_pass_fails():
    """At the card tests' N = 4099: the three-term split within 1e-4 of the
    term scale of the plain version (and in the 2e-3 band of the exact
    form, tests/test_pallas.py:66-79); one TF32 pass outside it."""
    rng = np.random.default_rng(4099)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(4099, 3)),
                          dtype=torch.float32)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=4099),
                           dtype=torch.float32)
    kw = dict(eps=1e-2, g=1.0)
    plain = cuda_direct.acc_cross_mxu_plain(pos, pos, mass, **kw)
    scale = chip_smoke.mxu_term_scale(pos, pos, mass, 1e-2, 1.0)
    split = tf32_split.acc_mxu_tf32(pos, pos, mass, terms=3, **kw)
    one = tf32_split.acc_mxu_tf32(pos, pos, mass, terms=1, **kw)
    assert float((split - plain).abs().max()) / scale <= tf32_split.F32_TOL
    assert float((one - plain).abs().max()) / scale > tf32_split.F32_TOL
    exact = cuda_direct.acc_cross_plain(pos, pos, mass, softening="plummer",
                                        **kw)
    band = (torch.linalg.norm(split - exact, dim=1).max()
            / torch.linalg.norm(exact, dim=1).max())
    assert float(band) < 2e-3


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2),
                                           ("plummer", 0.0), ("ref", 0.0)])
def test_potential_energy_on_cpu_matches_jax_and_launches_nothing(
        softening, eps):
    """1100 bodies: more than one chunk of the plain sum, with a ragged
    end."""
    scene = jpresets.plummer_sphere(1100, seed=6)
    want = jenergy.potential_energy(jnp.asarray(scene.pos),
                                    jnp.asarray(scene.mass),
                                    softening=softening, eps=eps, g=1.0)
    state = tpresets.plummer_sphere(1100, seed=6).state(dtype=torch.float64,
                                                       device="cpu")
    before = dict(tenergy.LAUNCHES)
    got = tenergy.potential_energy(state.pos, state.mass,
                                   softening=softening, eps=eps, g=1.0)
    assert tenergy.LAUNCHES == before
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    per_body = tenergy.pair_potential(state.pos, state.mass,
                                      softening=softening, eps=eps)
    assert per_body.shape == (1100,) and bool((per_body > 0).all())


def test_pair_potential_refuses_what_it_does_not_take():
    pos = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="softening"):
        tenergy.pair_potential(pos, torch.ones(8), softening="newton")
    with pytest.raises(TypeError, match="dtype"):
        tenergy.pair_potential(pos.half(), torch.ones(8).half())
    with pytest.raises(ValueError, match="bad shapes"):
        tenergy.pair_potential(pos, torch.ones(7))


def test_self_offset_names_targets_among_the_sources():
    """`self_offset` says where the targets sit among the sources; a value
    that puts them outside is refused. The plain versions sum the named
    pairs as any pair, so on CPU tensors the result is the same with and
    without it, and acc_direct_kernel names the targets at 0."""
    rng = np.random.default_rng(12)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(40, 3)),
                          dtype=torch.float32)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=40),
                           dtype=torch.float32)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    for method in ("vpu", "mxu"):
        for bad in (-1, 31):
            with pytest.raises(ValueError, match="self_offset"):
                cuda_direct.acc_cross_kernel(pos[5:15], pos, mass,
                                             method=method, self_offset=bad,
                                             **kw)
        named = cuda_direct.acc_cross_kernel(pos[5:15].clone(), pos, mass,
                                             method=method, self_offset=5,
                                             **kw)
        plain = cuda_direct.acc_cross_kernel(pos[5:15], pos, mass,
                                             method=method, **kw)
        assert torch.equal(named, plain)
        assert torch.equal(
            cuda_direct.acc_direct_kernel(pos, mass, method=method, **kw),
            cuda_direct.acc_cross_kernel(pos, pos.clone(), mass,
                                         method=method, **kw))
