"""The port's two-level multirate leapfrog (`spacetpu_torch/ops/multirate.py`,
`Simulation(substeps=m)`, `suggest_substeps`) against `spacetpu`'s XLA path
on the CPU, from the seeded binary-in-cloud scene of tests/test_multirate.py
(a tight binary in a slow shell, 32 bodies), float64 unless named. The fast
set is compared as a set (`top_k`'s tie order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import direct as jdirect
from spacetpu.ops import multirate as jmr
from spacetpu_torch.ops import cuda_direct, multirate
from spacetpu_torch.state import make_state
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401
from tests.test_multirate import _binary_in_cloud

LAW = dict(softening="plummer", eps=1e-3, g=1.0)


def _pair(n_cloud=30, *, dtype=torch.float64, compensated=False, **kw):
    """The same primed scene and configuration in both packages: (port
    simulation, its state, JAX simulation, its state)."""
    pos, vel, mass = _binary_in_cloud(n_cloud)
    n = len(mass)
    kw = dict(dict(algorithm="direct", integrator="leapfrog", **LAW), **kw)
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    sim = spacetpu_torch.make_simulation(n, backend="torch", device="cpu",
                                         **kw)
    jsim = spacetpu.make_simulation(n, backend="xla", **kw)
    st = sim.prime(make_state(pos, vel, mass, dtype=dtype,
                              compensated=compensated, device="cpu"))
    jst = jsim.prime(spacetpu.make_state(pos, vel, mass, dtype=jdtype,
                                         compensated=compensated))
    return sim, st, jsim, jst


def _close(st, jst, rtol, atol):
    for f in ("pos", "vel", "acc"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=rtol,
                                   atol=atol, err_msg=f)
    assert float(st.time) == pytest.approx(float(jst.time), rel=1e-12)


#: (name, simulation kwargs, dt, steps, rtol, atol): fast_cap = N (every
#: body substeps), F < N at m = 16, and fast_cap "auto" (here N)
CASES = [
    ("fast_cap_n", dict(substeps=4, fast_cap=32), 2e-3, 5, 1e-10, 1e-12),
    ("fast_set_8", dict(substeps=16, fast_cap=8), 2e-3, 5, 1e-10, 1e-12),
    ("auto_cap", dict(substeps=2), 1e-3, 3, 1e-10, 1e-12),
]


@pytest.mark.parametrize("name,kw,dt,steps,rtol,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_multirate_steps_match_jax(name, kw, dt, steps, rtol, atol):
    """`run` of a multirate direct simulation: positions, velocities and
    the acc cache against the JAX package's (float64: 1e-10)."""
    sim, st, jsim, jst = _pair(**kw)
    assert sim.config.resolved_fast_cap() == jsim.config.resolved_fast_cap()
    _close(sim.run(st, dt, steps), jsim.run(jst, dt, steps), rtol, atol)


def test_compensated_float32_matches_jax():
    """Kahan rows through the slow step and the substeps, float32: 1e-5 of
    the positions' scale over 5 steps, the compensation rows carried."""
    sim, st, jsim, jst = _pair(dtype=torch.float32, compensated=True,
                               substeps=4, fast_cap=8)
    st, jst = sim.run(st, 1e-3, 5), jsim.run(jst, 1e-3, 5)
    assert st.pos_c is not None and st.vel_c is not None
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.vel.numpy(), np.asarray(jst.vel),
                               rtol=1e-4, atol=1e-4)
    assert float(st.time) == pytest.approx(5e-3, rel=1e-6)


@pytest.mark.parametrize("m", [1, 3])
def test_step_multirate_matches_jax(m):
    """`step_multirate` called directly, m = 1 (plain leapfrog at dt, with
    the fast rows gathered and put back) and m = 3: two steps, 1e-12."""
    sim, st, _, jst = _pair()
    kw = dict(substeps=m, fast_cap=8, **LAW)
    for _ in range(2):
        st = multirate.step_multirate(st, 1e-3, sim.acc_fn, backend="torch",
                                      **kw)
        jst = parity.call(
            lambda s: jmr.step_multirate(
                s, 1e-3, lambda p, w: jdirect.acc_direct(p, w, **LAW),
                backend="xla", **kw), jst)
    _close(st, jst, 1e-12, 1e-14)


@pytest.mark.parametrize("cap", [2, 8])
def test_select_fast_matches_jax_as_a_set(cap):
    """The fast set as a set, the binary's two bodies first; with n_active
    = 1 the binary's second body, as fast as the first, is padding and
    never fast."""
    _, st, _, jst = _pair()
    got = set(multirate.select_fast(st, cap).tolist())
    assert got == set(np.asarray(jmr.select_fast(jst, cap)).tolist())
    assert {0, 1} <= got
    st = st._replace(n_active=torch.tensor(1, dtype=torch.int32))
    jst = jst._replace(n_active=jnp.asarray(1, jnp.int32))
    assert multirate.select_fast(st, 1).tolist() == [0]
    assert np.asarray(jmr.select_fast(jst, 1)).tolist() == [0]


@pytest.mark.parametrize("dt", [2e-3, 1e-7, 10.0])
def test_suggest_substeps_regimes_match_jax(dt):
    """The three regimes on the 98-body scene: multirate at a dt only the
    binary outgrows, uniform at a tiny dt, lower-dt where the whole scene
    is under-resolved; (m, F, reason) equal to the JAX package's."""
    sim, st, jsim, jst = _pair(n_cloud=96)
    got = sim.suggest_substeps(st, dt)
    assert got == jsim.suggest_substeps(jst, dt)
    assert got[2] == {2e-3: "multirate", 1e-7: "uniform",
                      10.0: "lower-dt"}[dt]


def test_kernel_backend_on_cpu_tensors_is_the_plain_pass():
    """backend="cuda" binds the fast pass to `direct_vpu`'s wrapper; on CPU
    tensors it takes the plain version and launches nothing: the same
    states as backend="torch" to 1e-12."""
    kw = dict(substeps=4, fast_cap=8, **LAW)
    pos, vel, mass = _binary_in_cloud(30)
    out = []
    before = dict(cuda_direct.LAUNCHES)
    for backend in ("cuda", "torch"):
        sim = spacetpu_torch.make_simulation(32, algorithm="direct",
                                             backend=backend, device="cpu",
                                             **kw)
        st = sim.prime(make_state(pos, vel, mass, dtype=torch.float64,
                                  device="cpu"))
        out.append(sim.run(st, 2e-3, 3))
    assert cuda_direct.LAUNCHES == before
    torch.testing.assert_close(out[0].pos, out[1].pos, rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="direct", integrator="euler", substeps=2), "leapfrog"),
    (dict(algorithm="direct", integrator="yoshida4", substeps=2),
     "leapfrog"),
    (dict(algorithm="pm", substeps=2), "pm"),
    (dict(algorithm="pm", integrator="euler", substeps=2), "leapfrog"),
])
def test_multirate_refusals_match_jax(kw, match):
    """A non-leapfrog integrator and the PM solver refuse substeps > 1 in
    both packages; where both apply, the integrator's refusal comes
    first in both."""
    with pytest.raises(ValueError, match=match):
        spacetpu_torch.make_simulation(64, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        spacetpu.make_simulation(64, **kw)


def test_fast_pass_chunk_rule(monkeypatch):
    """The plain pass's source chunk: about 2^28 / (3 F) sources, at least
    1024, as the JAX package's XLA path takes it."""
    calls = []

    def fake(pos_t, pos_s, mass_s, **kw):
        calls.append(kw["chunk"])
        return torch.zeros_like(pos_t)

    monkeypatch.setattr(multirate.direct, "acc_cross_chunked", fake)
    for cap in (1, 128, 32_768, 10 ** 6):
        multirate.cross_fn("torch", cap, **LAW)(
            torch.zeros(1, 3), torch.zeros(2, 3), torch.zeros(2))
    assert calls == [max(1024, (1 << 28) // (3 * c))
                     for c in (1, 128, 32_768, 10 ** 6)]


def test_split_kernel_instance_is_a_template_of_direct_cu():
    """chip_smoke reads the SASS of the fast pass's instance: the lean
    kernel that the plain grid launches, with its SPLIT argument (the
    first) set, and its 16 pairs a trip."""
    import chip_smoke

    plain = chip_smoke.MAIN_INSTANCES["direct_vpu"]
    assert plain.startswith("direct_vpu_lean_kernelILb0E")
    assert (chip_smoke.MAIN_INSTANCES["direct_vpu_split"]
            == plain.replace("ILb0E", "ILb1E", 1))
    assert (chip_smoke.PAIRS_PER_LOOP["direct_vpu_split"]
            == chip_smoke.PAIRS_PER_LOOP["direct_vpu"] == 16)
