"""TreePM in the port (`spacetpu_torch/ops/treepm.py`, the short-range and
hybrid pair kernels' plain versions in `ops/cuda_tree.py`, the TreePM half of
`Simulation`) against `spacetpu`'s, on the CPU: the long-range kernel
spectra, the split weights, the cutoff near lists and caps, the tile lists,
the short-range pair pass, the whole force with and without a carried
structure, the façade (prime, caps, mesh_params, health, run with and
without a cached structure, the saturation warning), and the hybrid rank-1
accumulation of the tree and of TreePM (`pallas_method="mxu"`). float64
unless a case says float32. JAX runs jitted (`tests/parity.py`); its Pallas
hybrid kernels run in interpret mode."""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import pm as jpm
from spacetpu.ops import tree as jtree
from spacetpu.ops import treepm as jtreepm
from spacetpu.state import make_state as jmake_state
from spacetpu_torch.models import presets as tpresets
from spacetpu_torch.ops import cuda_tree
from spacetpu_torch.ops import tree as ttree
from spacetpu_torch.ops import treepm as ttreepm
from spacetpu_torch.state import make_state as tmake_state
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

#: a uniform cloud of 1000 bodies in 67 clusters of 15 on a 64^3 mesh:
#: the cutoff lists hold part of the clusters
N, LEAF, GRID = 1000, 15, 64
GG = -(-N // LEAF)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_helpers():
    with pytest.MonkeyPatch.context() as mp:
        parity.jit_treepm_helpers(mp)
        yield


def _cloud(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3)), rng.uniform(0.5, 1.0, n)


def _t(x, dtype=torch.float64):
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        return torch.as_tensor(x, dtype=torch.int64)
    return torch.as_tensor(x, dtype=dtype)


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = (got.double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def world():
    """The cloud, its calibration (margin 1.1, as tests/test_treepm.py) and
    JAX's prep at the measured caps."""
    pos, mass = _cloud()
    box_min, h = jpm.measure_box(pos, grid=GRID, margin=1.1)
    rs, rcut = jtreepm.split_params(h)
    m = jtreepm.measure_near_rcut(jnp.asarray(pos), jnp.asarray(mass),
                                  rcut=rcut, gg=GG, leaf=LEAF)
    jprep = parity.call(jtreepm.treepm_prep, pos, mass, rcut=rcut,
                        k_near=m["k_near"], gg=GG, leaf=LEAF,
                        near_tiles=m["near_tiles"])
    return dict(pos=pos, mass=mass, box_min=box_min, h=h, rs=rs, rcut=rcut,
                m=m, jprep=jprep)


def test_kernel_spectra_match_jax(world):
    """The long-range spectra (gauss, poly) built on the device against the
    JAX package's host builds, 1e-12 of the largest entry, through each
    builder and `make_kernel_hat` (the JAX package's device build of the
    poly spectrum is the same build here)."""
    h, rs, rcut = 0.13, 0.2275, 1.02375
    _close(ttreepm.pm_kernel_hat_long(16, h, rs, g=1.3, dtype=torch.float64,
                                      device="cpu"),
           jtreepm.pm_kernel_hat_long(16, h, rs, g=1.3, dtype=jnp.float64),
           1e-12)
    want = jtreepm.pm_kernel_hat_poly(16, h, rcut, g=1.3, dtype=jnp.float64)
    _close(ttreepm.pm_kernel_hat_poly(16, h, rcut, g=1.3,
                                      dtype=torch.float64, device="cpu"),
           want, 1e-12)
    for got in (ttreepm.make_kernel_hat("poly", 16, h, rs, rcut, g=1.3,
                                        dtype=torch.float64, device="cpu"),
                ttreepm.pm_kernel_hat_poly_device(16, h, rcut, g=1.3,
                                                  dtype=torch.float64,
                                                  device="cpu")):
        _close(got, want, 1e-12)
    with pytest.raises(ValueError, match="split"):
        ttreepm.make_kernel_hat("erfc", 16, h, rs, rcut, device="cpu")


def test_device_kernel_forces_match_host_kernel(world):
    """tests/test_treepm.py:382-397 on the port: float32 TreePM forces with
    the device-built poly spectrum against those with the JAX package's
    host-built table, within 5e-6 of the largest force."""
    w = world
    pos, mass = _t(w["pos"], torch.float32), _t(w["mass"], torch.float32)
    k_dev = ttreepm.make_kernel_hat("poly", GRID, w["h"], w["rs"], w["rcut"],
                                    g=1.0, device="cpu")
    k_host = _t(jtreepm.pm_kernel_hat_poly(GRID, w["h"], w["rcut"], g=1.0,
                                           dtype=jnp.float32), torch.float32)
    kw = dict(box_min=w["box_min"], h=w["h"], grid=GRID)
    a_h = ttreepm.acc_treepm(pos, mass, kernel_hat=k_host, rs=w["rs"],
                             rcut=w["rcut"], split="poly",
                             softening="plummer", eps=1e-2, g=1.0,
                             k_near=w["m"]["k_near"], gg=GG, leaf=LEAF,
                             near_tiles=w["m"]["near_tiles"], **kw).double()
    # the two forces share their short-range pass, so they differ by the
    # difference of their PM passes
    diff = (ttreepm.pm_ops.acc_pm(pos, mass, kernel_hat=k_dev, **kw)
            - ttreepm.pm_ops.acc_pm(pos, mass, kernel_hat=k_host, **kw))
    err = torch.linalg.norm(diff.double(), dim=1) / torch.linalg.norm(
        a_h, dim=1).max()
    assert float(err.max()) < 5e-6


@pytest.mark.parametrize("split,fast", [("poly", True), ("gauss", True),
                                        ("gauss", False)])
@pytest.mark.parametrize("softening,eps", [("plummer", 0.0),
                                           ("plummer", 0.05), ("ref", 0.0),
                                           ("ref", 1e-3)])
def test_w_short_matches_jax(split, fast, softening, eps):
    """w_short against JAX's, from r = 0 through the cutoff and past the
    Chebyshev range, to 1e-12 of the larger of the pair weight and the short
    weight at each r (the short weight is a difference of two weights that
    nearly cancel at large r)."""
    r2 = np.concatenate([[0.0], np.geomspace(1e-6, 1e2, 200)])
    rs, rcut = 0.3, 1.35
    want = np.asarray(parity.call(
        lambda x: jtreepm.w_short(x, jnp.float64, softening,
                                  jnp.float64(eps), jnp.float64(rs),
                                  rcut=jnp.float64(rcut), split=split,
                                  fast=fast), r2))
    got = ttreepm.w_short(_t(r2), softening, eps, rs, rcut=rcut, split=split,
                          fast=fast).numpy()
    w_pair = np.asarray(parity.call(
        lambda x: jtreepm.direct._pair_weight(x, jnp.float64, softening,
                                              jnp.float64(eps)), r2))
    scale = np.maximum(np.abs(w_pair), np.abs(want))
    assert np.all(np.abs(got - want) <= 1e-12 * scale)
    if split == "poly":
        assert np.all(got[r2 >= rcut * rcut] == 0.0)


def test_chebyshev_coefficients_agree():
    """The gauss split's Chebyshev series: the port's, the JAX package's and
    the literals of csrc/pair.cuh are the same numbers."""
    assert ttreepm._HLONG_CHEB == jtreepm._HLONG_CHEB
    assert ttreepm._HLONG_VMAX == jtreepm._HLONG_VMAX
    src = (ttreepm.cuda_tree._build.CSRC / "pair.cuh").read_text()
    lits = [float(x) for x in re.findall(r"SPACETPU_CLENSHAW\(([-0-9.e]+)\)",
                                         src)]
    last = float(re.search(r"return x \* b1 - b2 \+ T\(([-0-9.e]+)\)",
                           src).group(1))
    assert tuple([last] + lits[::-1]) == cuda_tree.HLONG_CHEB
    assert float(re.search(r"HLONG_VMAX = ([0-9.]+);", src).group(1)) == \
        cuda_tree.HLONG_VMAX


def test_cutoff_lists_caps_and_tiles_match_jax(world):
    """near_lists_rcut as sets per row with the same overflow (at a cap of 8
    that overflows; at the measured cap through treepm_prep), the caps of
    measure_near_rcut equal, and treepm_prep's permutation, live tiles and
    overflow equal (also with a tile cap that drops entries). Equal
    distances would order differently than jax.lax.top_k; the cloud has
    none."""
    w = world
    pos, mass = _t(w["pos"]), _t(w["mass"])
    m = ttreepm.measure_near_rcut(pos, mass, rcut=w["rcut"], gg=GG,
                                  leaf=LEAF)
    assert m == pytest.approx(w["m"], rel=1e-12)
    assert 8 < m["k_near"] < GG
    jp = w["jprep"]
    jidx, jover = parity.call(jtreepm.near_lists_rcut, jp["com"],
                              jp["m_tot"], jp["r_tgt"], rcut=w["rcut"],
                              k_near=8)
    idx, over = ttreepm.near_lists_rcut(_t(jp["com"]), _t(jp["m_tot"]),
                                        _t(jp["r_tgt"]), w["rcut"], 8)
    assert int(over) == int(jover) > 0
    for row, jrow in zip(idx.numpy(), np.asarray(jidx)):
        assert set(row.tolist()) == set(jrow.tolist())
    for cap in (m["near_tiles"], 40):
        kw = dict(rcut=w["rcut"], k_near=m["k_near"], gg=GG, leaf=LEAF,
                  near_tiles=cap)
        want = parity.call(jtreepm.treepm_prep, w["pos"], w["mass"], **kw)
        got = ttreepm.treepm_prep(pos, mass, **kw)
        assert int(got["near_ntiles"]) == int(want["near_ntiles"])
        assert int(got["near_overflow"]) == int(want["near_overflow"])
        assert (cap == 40) == (int(got["near_overflow"]) > 0)
        np.testing.assert_array_equal(got["perm"].numpy(),
                                      np.asarray(want["perm"]))
    with pytest.raises(ValueError, match="leaf"):
        ttreepm.treepm_prep(pos, mass, rcut=w["rcut"], k_near=8, gg=100,
                            leaf=20)


def _jax_tables(jp, g=1.0, pseudo=False):
    """JAX's source table and the port's, from one JAX prep."""
    args = (jp["pos_g"], jp["mass_g"], jp["com"], jp["m_tot"])
    jrows = jtree._pack_augmented(*args, jnp.asarray(g),
                                  monopole_pseudo=pseudo)
    trows = ttree._pack_augmented(*(_t(a) for a in args), g,
                                  monopole_pseudo=pseudo)
    return jrows, trows


@pytest.mark.parametrize("split,softening,eps", [("poly", "plummer", 0.0),
                                                  ("gauss", "ref", 1e-2)])
def test_short_pairs_plain_matches_jax(world, split, softening, eps):
    """The plain version of pairs_short (through its wrapper, on CPU
    tensors) against `_near_pairs_short_xla` on JAX's own tile list, to
    1e-12 of max|a|. The massless pseudo slot adds nothing."""
    w, jp = world, world["jprep"]
    jpos_g = jnp.asarray(jp["pos_g"])
    aug_pos = jnp.concatenate([jpos_g, jnp.asarray(jp["com"])[:, None]], 1)
    aug_gm = jnp.concatenate([jnp.asarray(jp["mass_g"]),
                              jnp.zeros((GG, 1))], 1)
    kw = dict(softening=softening, eps=eps, rs=w["rs"], split=split,
              rcut=w["rcut"] if split == "poly" else None)
    want = parity.call(jtreepm._near_pairs_short_xla, jpos_g, aug_pos,
                       aug_gm, jp["near_flat"], jp["near_tile_tgt"], **kw)
    _, trows = _jax_tables(jp)
    kw["rcut"] = kw["rcut"] or 0.0
    before = dict(cuda_tree.LAUNCHES)
    got = cuda_tree.near_pairs_short(_t(jp["pos_g"]), trows,
                                     _t(jp["near_flat"]),
                                     _t(jp["near_tile_tgt"]), **kw)
    assert cuda_tree.LAUNCHES == before
    _close(got, want, 1e-12)


def test_acc_treepm_matches_jax(world):
    """The whole TreePM force (gauss split) against JAX's, 1e-10 of max|a|:
    `acc_treepm` on the cloud, and `acc_treepm_cached` on a moved cloud
    with JAX's structure of the first carried across. JAX's cached form on
    its own structure of the cloud is its `acc_treepm` there, so one JAX
    program serves both; the poly split's `acc_treepm` is held through the
    simulation test below."""
    w = world
    kw = dict(box_min=w["box_min"], h=w["h"], grid=GRID, rs=w["rs"],
              rcut=w["rcut"], softening="plummer", eps=1e-3, g=1.0,
              split="gauss")
    jk = jtreepm.make_kernel_hat("gauss", GRID, w["h"], w["rs"], w["rcut"],
                                 g=1.0, dtype=jnp.float64)
    struct = {k: w["jprep"][k] for k in jtreepm.STRUCTURE_KEYS}
    moved = w["pos"] + 1e-3 * np.random.default_rng(1).normal(size=(N, 3))
    jax_cached = jax.jit(lambda p, m_, s: jtreepm.acc_treepm_cached(
        p, m_, s, kernel_hat=jk, backend="xla", **kw))
    tk, mass = _t(jk), _t(w["mass"])
    got = ttreepm.acc_treepm(_t(w["pos"]), mass, kernel_hat=tk,
                             k_near=w["m"]["k_near"], gg=GG, leaf=LEAF,
                             near_tiles=w["m"]["near_tiles"], **kw)
    _close(got, jax_cached(w["pos"], w["mass"], struct), 1e-10)
    tstruct = ttreepm.structure_from_numpy(
        {**struct, "clusters": tuple(np.asarray(x) for x in
                                     struct["clusters"])}, device="cpu")
    assert set(tstruct) == set(ttreepm.STRUCTURE_KEYS)
    got = ttreepm.acc_treepm_cached(_t(moved), mass, tstruct, kernel_hat=tk,
                                    **kw)
    _close(got, jax_cached(moved, w["mass"], struct), 1e-10)


def _sim_pair(n, pos, mass, vel, **kw):
    sim = spacetpu_torch.make_simulation(n, device="cpu", **kw)
    jsim = spacetpu.make_simulation(n, backend="xla", **kw)
    ts = tmake_state(pos, vel, mass, dtype=torch.float64, device="cpu")
    js = jmake_state(pos, vel, mass, dtype=jnp.float64)
    return sim, jsim, ts, js


@pytest.mark.parametrize("refresh", [1, 4])
def test_treepm_simulation_matches_jax(refresh):
    """make_simulation(algorithm="treepm"): prime calibrates the same mesh
    and caps as JAX's; a 4-step run (the structure rebuilt every step, or
    cached for four) agrees to 1e-9; health answers the same. A step before
    prime raises; the cached structure comes from build_structure."""
    n = 300
    pos, mass = _cloud(n, seed=4)
    vel = np.random.default_rng(5).normal(0, 0.05, (n, 3))
    kw = dict(algorithm="treepm", leaf=LEAF, eps=1e-2, g=1.0, pm_grid=16,
              tree_refresh_every=refresh)
    sim, jsim, ts, js = _sim_pair(n, pos, mass, vel, **kw)
    with pytest.raises(RuntimeError, match="uncalibrated"):
        sim.step(ts, 1e-3)
    with pytest.raises(RuntimeError, match="uncalibrated"):
        sim.build_structure(ts)
    ts, js = sim.prime(ts), jsim.prime(js)
    assert sim.caps == jsim.caps
    assert sim.degenerate == jsim.degenerate
    mp, jmp = sim.mesh_params, jsim.mesh_params
    for k in ("h", "grid", "rs", "rcut", "split"):
        assert mp[k] == jmp[k]
    _close(mp["kernel_hat"], jmp["kernel_hat"], 1e-12)
    assert set(sim.jit_consts) == set(jsim.jit_consts)
    ts, js = sim.run(ts, 1e-3, 4), jsim.run(js, 1e-3, 4)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=1e-9,
                               atol=1e-12)
    _close(ts.acc, js.acc, 1e-9)
    assert sim.health(ts) == jsim.health(js)
    assert sim.health(ts)["near_overflow"] == 0
    assert not sim.maybe_recalibrate(ts)
    if refresh > 1:
        s1 = sim.step_cached(ts, sim.build_structure(ts), 1e-3)
        _close(s1.acc, sim.step(ts, 1e-3).acc.numpy(), 1e-12)


def test_treepm_saturation_warns_and_escape_recalibrates():
    """A Plummer core in an outlier-stretched box saturates the cutoff lists
    at 64 clusters (tests/test_treepm.py:348 on the port, at leaf 15): prime
    warns and flags "treepm-saturated". A state teleported out of the box
    recalibrates (tests/test_treepm.py:329)."""
    scene = tpresets.plummer_sphere(64 * LEAF, seed=1)
    sim = spacetpu_torch.make_simulation(scene.n, algorithm="treepm",
                                         leaf=LEAF, eps=1e-2, g=1.0,
                                         pm_grid=32, device="cpu")
    with pytest.warns(UserWarning, match="saturates"):
        st = sim.prime(scene.state(dtype=torch.float32, device="cpu"))
    assert sim.degenerate == "treepm-saturated"
    assert sim.caps["k_near"] >= sim.caps["gg"] // 2
    moved = st._replace(pos=st.pos * 10.0)
    assert sim.health(moved)["out_of_box"] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert sim.maybe_recalibrate(moved) is True
    assert sim.health(moved)["out_of_box"] == 0
    with pytest.raises(NotImplementedError, match="Queue A 9|item 9"):
        spacetpu_torch.make_simulation(64, algorithm="treepm", substeps=2,
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        ttreepm.near_pairs_short()
    with pytest.raises(NotImplementedError, match="item 11"):
        ttreepm.measure_near_rcut(st.pos, st.mass, rcut=1.0, gg=64,
                                  leaf=LEAF, n_shards=2)


@pytest.mark.parametrize("kw", [
    dict(algorithm="pm"),
    dict(algorithm="treepm", leaf=15),
    dict(n=1000, cluster_mode="adaptive", pallas_method="mxu", leaf=15,
         near_mode="pairs"),
    dict(n=600, algorithm="tree", pallas_method="mxu", backend="cuda"),
])
def test_formerly_unported_paths_run(kw):
    """The mesh families and the tree's hybrid accumulation, which raised
    NotImplementedError before their port: each primes and steps on the CPU
    with finite forces; the mesh families refuse a step before prime."""
    kw = dict(kw)
    scene = tpresets.fixed_cloud(kw.pop("n", 300))
    sim = spacetpu_torch.make_simulation(scene.n, device="cpu", **kw)
    state = scene.state(dtype=torch.float64, device="cpu")
    if sim.algorithm in ("pm", "treepm"):
        with pytest.raises(RuntimeError, match="uncalibrated"):
            sim.step(state, 1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state = sim.step(sim.prime(state), 1e-3)
    assert bool(torch.isfinite(state.acc).all())
    assert float(state.acc.abs().max()) > 0.0


# --- the hybrid accumulation -------------------------------------------------


def test_hybrid_plain_matches_jax_interpret_float32(world, monkeypatch):
    """The plain versions of pairs_hybrid and pairs_short_hybrid against the
    JAX package's hybrid Pallas kernels (interpret mode) on JAX's tiles, in
    float32: 2e-5 of max|a|, the band of tests/test_treepm.py:365-379. The
    JAX kernels sum on the matrix unit in float32; the port sums on the
    CUDA cores in the input dtype (ROADMAP Queue C)."""
    monkeypatch.setattr(jtree, "NEAR_PAIRS_CHUNK", 16)
    jp = {k: (np.asarray(v, np.float32)
              if np.asarray(v).dtype == np.float64 else v)
          for k, v in world["jprep"].items() if k != "clusters"}
    jpos_g = jnp.asarray(jp["pos_g"])
    tiles = (jp["near_flat"], jp["near_tile_tgt"])
    ttiles = tuple(_t(x) for x in tiles)
    tpos_g = _t(jp["pos_g"], torch.float32)
    for pseudo in (True, False):
        jrows, _ = _jax_tables(jp, pseudo=pseudo)
        trows = _t(np.asarray(jrows)[:4], torch.float32)
        if pseudo:
            want = jtree._near_pairs_direct_pallas(
                jpos_g, jrows, *tiles, softening="plummer", eps=1e-2,
                interpret=True, accum="mxu")
            got = cuda_tree.near_pairs_hybrid_plain(
                tpos_g, trows, *ttiles, softening="plummer", eps=1e-2)
        else:
            want = jtreepm._near_pairs_short_pallas(
                jpos_g, jrows, *tiles, softening="plummer", eps=1e-2,
                rs=world["rs"], rcut=world["rcut"], split="poly",
                interpret=True, accum="mxu")
            got = cuda_tree.near_pairs_short_hybrid_plain(
                tpos_g, trows, *ttiles, softening="plummer", eps=1e-2,
                rs=world["rs"], rcut=world["rcut"], split="poly")
        _close(got, want, 2e-5)


@pytest.mark.parametrize("softening,eps,split", [("plummer", 1e-3, "poly"),
                                                  ("ref", 0.0, "poly")])
def test_hybrid_float64_matches_direct_sums(world, softening, eps, split):
    """In float64 the hybrid sums and the direct sums are the same sum up to
    the rank-1 algebra: 1e-10 of max|a|, pairs_hybrid's plain version on the
    tree's table (a -M pseudo-body a cluster) and pairs_short_hybrid's on
    TreePM's (a massless pseudo slot), self pairs masked."""
    jp = world["jprep"]
    pos_g, tiles = _t(jp["pos_g"]), (_t(jp["near_flat"]),
                                      _t(jp["near_tile_tgt"]))
    kw = dict(softening=softening, eps=eps)
    rows = _jax_tables(jp, pseudo=True)[1]
    _close(cuda_tree.near_pairs_hybrid(pos_g, rows, *tiles, **kw),
           cuda_tree.near_pairs_direct(pos_g, rows, *tiles, **kw).numpy(),
           1e-10)
    kw.update(rs=world["rs"], rcut=world["rcut"], split=split)
    rows = _jax_tables(jp, pseudo=False)[1]
    _close(cuda_tree.near_pairs_short_hybrid(pos_g, rows, *tiles, **kw),
           cuda_tree.near_pairs_short(pos_g, rows, *tiles, **kw).numpy(),
           1e-10)


@pytest.mark.parametrize("algorithm", ["tree", "treepm"])
def test_mxu_simulations_step_on_the_cpu(algorithm):
    """make_simulation(pallas_method="mxu") for the tree (pair list) and for
    TreePM: prime and two steps on the CPU through the hybrid plain
    versions, 1e-10 of max|a| from the "vpu" simulation."""
    scene = tpresets.fixed_cloud(600)
    kw = dict(algorithm=algorithm, leaf=LEAF, eps=1e-3, device="cpu")
    if algorithm == "tree":
        kw.update(near_mode="pairs", theta=0.5, k_near="auto")
    else:
        kw.update(pm_grid=32)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for method in ("vpu", "mxu"):
            sim = spacetpu_torch.make_simulation(scene.n,
                                                 pallas_method=method, **kw)
            st = sim.prime(scene.state(dtype=torch.float64, device="cpu"))
            out[method] = sim.run(st, 1e-3, 2)
    _close(out["mxu"].acc, out["vpu"].acc.numpy(), 1e-10)
    np.testing.assert_allclose(out["mxu"].pos.numpy(),
                               out["vpu"].pos.numpy(), rtol=1e-12)
