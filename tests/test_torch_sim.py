"""The port's Simulation façade against `spacetpu`'s and the native oracle,
plus the port's import and device contracts."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu import native
from spacetpu.constants import COLLISION_EPSILON, DELTA, G
from spacetpu.models import presets as jpresets
from spacetpu_torch.models import presets as tpresets
from spacetpu_torch.ops import cuda_direct
from spacetpu_torch.ops import tree as tree_ops
from spacetpu_torch.state import state_from_numpy
from tests.parity import one_torch_thread  # noqa: F401

PKG = pathlib.Path(spacetpu_torch.__file__).parent


def test_direct_simulation_matches_jax():
    """The bench configuration at N=256 in float64 through both façades
    (yoshida4 and the chunked force are held in test_torch_integrators.py
    and test_torch_direct.py)."""
    kw = dict(algorithm="direct", integrator="leapfrog", softening="plummer",
              eps=1e-2, g=1.0)
    sim = spacetpu_torch.make_simulation(256, device="cpu", **kw)
    state = sim.prime(tpresets.random_cluster(256, seed=2).state(
        dtype=torch.float64, device="cpu"))
    state = sim.run(state, 1e-3, 20)
    jsim = spacetpu.make_simulation(256, backend="xla", **kw)
    jstate = jsim.run(jsim.prime(
        jpresets.random_cluster(256, seed=2).state(dtype=jnp.float64)),
        1e-3, 20)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(jstate.pos),
                               rtol=1e-9)
    np.testing.assert_allclose(state.vel.numpy(), np.asarray(jstate.vel),
                               rtol=1e-9)
    assert float(state.time) == pytest.approx(float(jstate.time), rel=1e-12)


def test_auto_backend_on_cpu_is_plain_torch():
    sim = spacetpu_torch.make_simulation(64, algorithm="direct",
                                         device="cpu")
    assert sim.backend == "torch"
    assert sim.config.resolved_backend("cuda") == "cuda"
    pos = torch.rand(64, 3, dtype=torch.float64)
    before = dict(cuda_direct.LAUNCHES)
    sim.acc_fn(pos, torch.ones(64, dtype=torch.float64))
    assert cuda_direct.LAUNCHES == before


@pytest.mark.parametrize("alias,backend", [("pallas", "cuda"),
                                           ("xla", "torch")])
def test_backend_aliases(alias, backend):
    sim = spacetpu_torch.make_simulation(64, algorithm="direct",
                                         backend=alias, device="cpu")
    assert sim.backend == backend


def test_cuda_backend_on_cpu_tensors_takes_plain_kernel_path():
    """backend="cuda" binds the kernel wrapper; CPU tensors take its plain
    version, which matches the plain solver."""
    kw = dict(algorithm="direct", softening="plummer", eps=1e-2, g=1.0,
              device="cpu")
    pos = torch.rand(100, 3, dtype=torch.float64)
    mass = torch.rand(100, dtype=torch.float64)
    a_k = spacetpu_torch.make_simulation(100, backend="cuda", **kw).acc_fn(
        pos, mass)
    a_t = spacetpu_torch.make_simulation(100, backend="torch", **kw).acc_fn(
        pos, mass)
    torch.testing.assert_close(a_k, a_t, rtol=1e-12, atol=1e-14)


def test_reference_compatible_matches_native_rollout():
    """tests/test_parity.py:37 on the port: fixed_cloud(600), reference
    force law and Euler, against the C++ oracle."""
    scene = tpresets.fixed_cloud(600)
    sim = spacetpu_torch.reference_compatible(scene.n, device="cpu")
    assert sim.config.integrator == "euler"
    assert sim.config.softening == "ref"
    state = sim.run(scene.state(dtype=torch.float64, device="cpu"), DELTA, 50)
    p_ref, _ = native.rollout(
        scene.pos, scene.vel, scene.mass, dt=DELTA, steps=50,
        g=G, eps=COLLISION_EPSILON, softening="ref", algorithm="direct",
    )
    np.testing.assert_allclose(state.pos.numpy(), p_ref, rtol=1e-10,
                               atol=1e-13)


def test_step_equals_run_and_progress():
    sim = spacetpu_torch.reference_compatible(31, device="cpu")
    s1 = tpresets.fixed_cloud(30).state(dtype=torch.float64, device="cpu")
    s2 = tpresets.fixed_cloud(30).state(dtype=torch.float64, device="cpu")
    for _ in range(5):
        s1 = sim.step(s1, DELTA)
    done = []
    s2 = sim.run(s2, DELTA, 5, progress=done.append)
    assert done == [5]
    torch.testing.assert_close(s1.pos, s2.pos, rtol=0, atol=0)
    s3 = sim.traced_step(s1, DELTA, sim.jit_consts)
    assert sim.jit_consts == {} and sim.jit_epoch == 1
    assert set(sim.caps) == set(spacetpu.reference_compatible(31).caps)
    torch.testing.assert_close(s3.pos, sim.step(s1, DELTA).pos)


def test_state_from_numpy_round_trips_jax_state():
    js = jpresets.random_cluster(40, seed=1).state(dtype=jnp.float32,
                                                   compensated=True,
                                                   pad_to=48)
    d = {k: np.asarray(v) for k, v in js._asdict().items() if v is not None}
    ts = state_from_numpy(d, device="cpu")
    for k, v in d.items():
        got = getattr(ts, k)
        assert str(got.dtype) == f"torch.{v.dtype}", k
        np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    as64 = state_from_numpy(d, device="cpu", dtype=torch.float64)
    assert as64.pos.dtype == torch.float64
    assert as64.n_active.dtype == torch.int32
    del d["pos_c"]
    assert state_from_numpy(d, device="cpu").pos_c is None


@pytest.mark.parametrize("entry", ["make_simulation", "make_state",
                                   "scene_state", "state_from_numpy",
                                   "structure_from_numpy",
                                   "equal_clusters", "adaptive_clusters"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Without a card, an entry point that was not asked for the CPU
    raises; it never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tpresets.random_cluster(8, seed=0)
    calls = {
        "make_simulation": lambda: spacetpu_torch.make_simulation(
            8, algorithm="direct"),
        "make_state": lambda: spacetpu_torch.make_state(
            scene.pos, scene.vel, scene.mass),
        "scene_state": lambda: scene.state(),
        "state_from_numpy": lambda: state_from_numpy({"pos": scene.pos}),
        "structure_from_numpy": lambda: tree_ops.structure_from_numpy(
            {"idx": np.zeros((1, 1), np.int32),
             "clusters": (np.zeros((1, 8), np.int32),) * 5}),
        "equal_clusters": lambda: tree_ops.cluster_ops.equal_clusters(
            8, 8, 1),
        "adaptive_clusters": lambda: tree_ops.cluster_ops.adaptive_clusters(
            torch.zeros(8, dtype=torch.int64),
            torch.zeros(8, dtype=torch.int64), 8, 8, 3),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_sim_rejects_state_on_another_device():
    sim = spacetpu_torch.make_simulation(8, algorithm="direct", device="cpu")
    state = tpresets.random_cluster(8).state(device="cpu")
    with pytest.raises(ValueError, match="bodies"):
        sim.step(tpresets.random_cluster(9).state(device="cpu"), 1e-3)
    meta = state._replace(pos=state.pos.to("meta"))
    with pytest.raises(ValueError, match="runs on"):
        sim.step(meta, 1e-3)


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="tree", far_levels=3, backend="cuda",
          near_mode="strip"), "Queue B item 10"),
    (dict(algorithm="direct", substeps=4), "Queue A item 9"),
    (dict(algorithm="treepm", substeps=4), "Queue A item 9"),
])
def test_unported_paths_raise(kw, match):
    kw = {"n": 64, **kw}
    with pytest.raises(NotImplementedError, match=match):
        spacetpu_torch.make_simulation(kw.pop("n"), device="cpu", **kw)


@pytest.mark.parametrize("method", ["calibrate", "maybe_recalibrate",
                                    "health"])
def test_tree_only_methods_raise(method):
    """The tree's methods on a direct simulation: since the tree's port they
    raise nothing there and answer as `spacetpu` does (nothing to calibrate,
    no telemetry). The tree's own answers are in test_torch_tree_sim.py."""
    sim = spacetpu_torch.make_simulation(8, algorithm="direct", device="cpu")
    state = tpresets.random_cluster(8).state(device="cpu")
    want = {"calibrate": None, "maybe_recalibrate": False,
            "health": {"algorithm": "direct"}}
    assert getattr(sim, method)(state) == want[method]
    assert set(sim.caps.values()) == {None} and sim.degenerate is None
    jsim = spacetpu.make_simulation(8, algorithm="direct", backend="xla")
    if method != "calibrate":
        jstate = jpresets.random_cluster(8).state()
        assert getattr(jsim, method)(jstate) == want[method]


def test_config_validation():
    kw = dict(algorithm="direct", device="cpu")
    with pytest.raises(ValueError, match="pallas_method"):
        spacetpu_torch.make_simulation(8, pallas_method="tensor", **kw)
    with pytest.raises(ValueError, match="mxu"):
        spacetpu_torch.make_simulation(8, backend="cuda", softening="ref",
                                       pallas_method="mxu", **kw)
    with pytest.raises(ValueError, match="mxu"):
        spacetpu_torch.make_simulation(8, backend="cuda", eps=0.0,
                                       pallas_method="mxu", **kw)
    with pytest.raises(ValueError, match="backend"):
        spacetpu_torch.make_simulation(8, backend="tpu", **kw)
    with pytest.raises(ValueError, match="softening"):
        spacetpu_torch.make_simulation(8, softening="newton", **kw)
    with pytest.raises(ValueError, match="integrator"):
        spacetpu_torch.make_simulation(8, integrator="rk4", **kw)


def test_simconfig_has_every_jax_field():
    import dataclasses

    from spacetpu.sim import SimConfig as JConfig
    from spacetpu_torch.sim import SimConfig as TConfig

    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert jf == tf


def test_import_leaves_out_jax_and_spacetpu():
    """Every module of the package, walked from its files, and
    `chip_smoke.py` import neither JAX nor `spacetpu`."""
    mods = sorted(".".join(p.relative_to(PKG.parent).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    assert {"spacetpu_torch.ops.tree", "spacetpu_torch.ops.cluster",
            "spacetpu_torch.ops.morton", "spacetpu_torch.sim"} <= set(mods)
    code = (f"import sys, {', '.join(mods)}, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'spacetpu' "
            "or m.startswith('spacetpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=PKG.parent, timeout=120)
    assert out.stdout.strip() == "[]"


def test_no_jax_or_spacetpu_imports_in_package():
    pattern = re.compile(
        r"^\s*(import\s+jax|from\s+jax|import\s+spacetpu\b(?!_torch)"
        r"|from\s+spacetpu(\.|\s)(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) >= 17
    for path in files:
        assert not pattern.search(path.read_text()), path
