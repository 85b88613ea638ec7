#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spacetpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # same phases on the CPU, tiny N

Phases, each printing one JSON line; the first that fails ends the run with
a nonzero exit code:

  device          card name, SM count, nvidia-smi name and power limit
  build           nvcc build of spacetpu_torch/csrc/*.cu: time, registers,
                  spills
  kernels         every kernel against its plain PyTorch version, both laws,
                  eps in {1e-2, 0}, ragged and cross shapes, float32/float64
  main_path       the benchmark configuration (random_cluster(262144), f32,
                  direct, leapfrog, plummer eps=1e-2) through the port's entry
                  points, with pallas_method "vpu" and then "mxu"
  reference_path  reference_compatible on fixed_cloud(10000) in float64:
                  kernel against the plain path over 50 Euler steps
  energy          random_cluster(65536), 100 leapfrog steps, |dE/E| < 1e-4

Then, each on a line of its own: the kernels at the main path's shapes
(time, bound, plain time, launches on the main path), the card's name and
power limit, and a last line {"ok": true, "device": {...}}. The rehearsal
runs the plain versions and never prints that last line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

#: the card's published float32 rate outside the tensor cores and its
#: memory rate (H100 SXM data sheet), for the bound of each kernel
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: flops a pair: the JAX package's count for _kernel (pallas_direct.py:348),
#: and the same count for the CUDA-core expanded form (dot 5, d2 4, max 1,
#: rsqrt 1, cube 2, mass 1, sums 7)
FLOPS_PER_PAIR = {"direct_vpu": 22, "direct_mxu": 21}
REPLACES = {
    "direct_vpu": "spacetpu/ops/pallas_direct.py:49 (_kernel)",
    "direct_mxu": "spacetpu/ops/pallas_direct.py:261 (_kernel_mxu)",
}
SOURCE = "spacetpu_torch/csrc/direct.cu"
MAIN = dict(algorithm="direct", integrator="leapfrog", softening="plummer",
            eps=1e-2, g=1.0)
DT = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn() between CUDA events, after one call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bodies(n, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    return pos, mass


def mxu_term_scale(pos_i, pos_j, mass_j, eps, g, chunk=4096):
    """max over targets and axes of sum_j w_ij (|x_j| + |x_i|): the size of
    the two sums that the expanded form subtracts. Summing them in another
    order moves the result by a multiple of the rounding unit of THIS, not
    of |a|, which it can exceed by orders of magnitude."""
    scale = 0.0
    sqj = torch.sum(pos_j * pos_j, dim=-1)
    for i0 in range(0, pos_i.shape[0], chunk):
        xi = pos_i[i0:i0 + chunk]
        sqi = torch.sum(xi * xi, dim=-1) + eps * eps
        for j0 in range(0, pos_j.shape[0], chunk):
            xj = pos_j[j0:j0 + chunk]
            d2 = sqi[:, None] + (sqj[None, j0:j0 + chunk] - 2.0 * (xi @ xj.T))
            inv = torch.rsqrt(torch.clamp_min(d2, eps * eps))
            w = (mass_j[j0:j0 + chunk] * g)[None, :] * inv ** 3
            s = w @ xj.abs() + w.sum(1, keepdim=True) * xi.abs()
            scale = max(scale, float(s.max()))
    return scale


def phase_device(dev, rehearsal):
    if rehearsal:
        emit({"phase": "device", "rehearsal": True, "device": "cpu"})
        return {"smi": None}
    if not torch.cuda.is_available():
        fail("no CUDA device")
    props = torch.cuda.get_device_properties(0)
    card = {"smi": nvidia_smi(), "sm_count": props.multi_processor_count,
            "max_sm_mhz": float(nvidia_smi("clocks.max.sm").split()[0])}
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "memory_gb": props.total_memory / 1e9, "nvidia_smi": card["smi"],
          "sm_count": card["sm_count"], "max_sm_mhz": card["max_sm_mhz"],
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def ptxas_summary(log: str) -> list[dict]:
    """Registers and spills of each kernel, from nvcc -Xptxas -v."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def sass_loops(cuobjdump: str, library: str) -> dict:
    """Each kernel's innermost loop (the shortest backward branch), from
    cuobjdump -sass: its machine instruction count and opcode histogram.
    The source unrolls the pair loop 8 times, so a pair costs a loop's
    count / 8 issue slots."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                      r"(?:\s+(?:`\()?0x([0-9a-f]+))?")
    loops = {}
    for body in out.split("Function : ")[1:]:
        name, _, code = body.partition("\n")
        code = [(int(m.group(1), 16), m.group(2), m.group(3))
                for m in insn.finditer(code)]
        spans = [(at - int(tgt, 16), int(tgt, 16), at)
                 for at, op, tgt in code
                 if op == "BRA" and tgt and int(tgt, 16) < at]
        if not spans:
            loops[name.strip()] = None
            continue
        _, lo, hi = min(spans)
        ops: dict[str, int] = {}
        for at, op, _ in code:
            if lo <= at <= hi:
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        loops[name.strip()] = {"instructions": sum(ops.values()),
                               "ops": dict(sorted(ops.items()))}
    return loops


def phase_build(rehearsal):
    """Build the kernels; returns the inner-loop instruction count of the
    instance of each kernel that the main path runs."""
    from spacetpu_torch import _build

    if rehearsal:
        emit({"phase": "build", "skipped": "cpu rehearsal: no nvcc"})
        return {}
    t0 = time.perf_counter()
    _build.build("direct")
    info = _build.BUILD_INFO["direct"]
    kernels = ptxas_summary(info["log"])
    if not kernels:
        fail("no ptxas report in the build log:\n" + info["log"])
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    loops = (sass_loops(cuobjdump, info["path"])
             if os.path.exists(cuobjdump) else {})
    for k in kernels:
        k["inner_loop"] = loops.get(k["function"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info["seconds"], "library": info["path"],
          "kernels": kernels})
    if any(k.get("spill_stores", 0) for k in kernels):
        print("chip_smoke: note: a kernel spills registers", file=sys.stderr)
    # the instances the main path runs: float32, plummer, eps > 0
    main_instances = {"direct_vpu": "direct_vpu_kernelIfLi0ELb0E",
                      "direct_mxu": "direct_mxu_kernelIfE"}
    return {name: next((v["instructions"] for f, v in loops.items()
                        if tag in f and v), None)
            for name, tag in main_instances.items()}


def kernel_cases(rehearsal):
    from spacetpu_torch import constants

    sizes = (100, 300, 700) if rehearsal else (100, 4099, 16384)
    small = sizes[1]
    cases = []
    for dtype in (torch.float32, torch.float64):
        for law, eps in (("plummer", 1e-2), ("plummer", 0.0), ("ref", 1e-2),
                         ("ref", 0.0), ("ref", constants.COLLISION_EPSILON)):
            for n in sizes:
                if eps == 0.0 and n > small:
                    continue  # unsoftened: only where terms stay sane
                cases.append(("vpu", dtype, law, eps, n, n))
            if eps > 0.0:
                cases.append(("vpu", dtype, law, eps, small, sizes[2]))
        for n in sizes:
            cases.append(("mxu", dtype, "plummer", 1e-2, n, n))
        cases.append(("mxu", dtype, "plummer", 1e-2, small, sizes[2]))
    return cases


def phase_kernels(dev, rehearsal):
    from spacetpu_torch.ops import cuda_direct

    results = []
    worst = {"direct_vpu": 0.0, "direct_mxu": 0.0}
    for method, dtype, law, eps, m, k in kernel_cases(rehearsal):
        pos_j, mass_j = bodies(k, seed=k, dtype=dtype, dev=dev)
        pos_i = pos_j if m == k else bodies(m, seed=m + 1, dtype=dtype,
                                            dev=dev)[0]
        kw = dict(softening=law, eps=eps, g=1.0)
        a_k = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j,
                                           method=method, **kw)
        if method == "mxu":
            a_p = cuda_direct.acc_cross_mxu_plain(pos_i, pos_j, mass_j,
                                                  eps=eps, g=1.0)
        else:
            a_p = cuda_direct.acc_cross_plain(pos_i, pos_j, mass_j, **kw)
        sync(dev)
        f64 = dtype == torch.float64
        err = float((a_k - a_p).abs().max())
        amax = float(a_p.abs().max())
        row = {"kernel": f"direct_{method}", "dtype": str(dtype)[6:],
               "law": law, "eps": eps, "m": m, "k": k,
               "finite": bool(torch.isfinite(a_k).all()),
               "max_abs_err": err, "max_rel_err": err / amax}
        if not row["finite"]:
            fail(f"non-finite kernel output: {row}")
        if method == "mxu":
            # the expanded form subtracts two sums that can exceed |a| by
            # orders of magnitude: hold the reordering error to their size
            row["term_scale"] = mxu_term_scale(pos_i, pos_j, mass_j, eps,
                                               1.0)
            row["rel_to_terms"] = err / row["term_scale"]
            tol = 1e-11 if f64 else 1e-4
            ok = row["rel_to_terms"] <= tol
            if not f64 and m == k:
                a_v = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
                band = float(torch.linalg.norm(a_k - a_v, dim=1).max()
                             / torch.linalg.norm(a_v, dim=1).max())
                row["vs_vpu"] = band
                # the band of tests/test_pallas.py:66-79; at N=100 a single
                # close pair can carry the force, where the expanded form's
                # d2 error is largest
                ok = ok and (m < 4000 or band < 2e-3)
        elif eps > 0.0:
            tol = 1e-11 if f64 else 1e-4
            ok = row["max_rel_err"] <= tol
        else:
            # unsoftened close pairs dwarf the net force: finite everywhere,
            # and in float64 the same sum up to reordering
            tol = 1e-9 if f64 else None
            ok = tol is None or row["max_rel_err"] <= tol
        row["tol"] = tol
        results.append(row)
        if not ok:
            emit({"phase": "kernels", "cases": results})
            fail(f"kernel disagrees with its plain version: {row}")
        name = f"direct_{method}"
        worst[name] = max(worst[name], row["max_rel_err"])
    # the band of tests/test_pallas.py:66-79, on its own inputs
    pos, mass = bodies(256, seed=7, dtype=torch.float32, dev=dev)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    a_v = cuda_direct.acc_cross_kernel(pos, pos, mass, **kw)
    a_m = cuda_direct.acc_cross_kernel(pos, pos, mass, method="mxu", **kw)
    band = float(torch.linalg.norm(a_m - a_v, dim=1).max()
                 / torch.linalg.norm(a_v, dim=1).max())
    emit({"phase": "kernels", "cases": results, "worst_rel_err": worst,
          "mxu_vs_vpu_test_pallas_case": band})
    if not band < 2e-3:
        fail(f"mxu vs vpu band {band} >= 2e-3 on the test_pallas case")


def run_main_path(scene, method, dev, rehearsal, card):
    import spacetpu_torch as st
    from spacetpu_torch.ops import cuda_direct, direct

    n = scene.n
    name = f"direct_{method}"
    state = scene.state(dtype=torch.float32, device=dev)
    sim = st.make_simulation(n, pallas_method=method, device=dev, **MAIN)
    for key in cuda_direct.LAUNCHES:
        cuda_direct.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    state = sim.prime(state)
    state = sim.step(state, DT)
    sync(dev)
    warm_s = time.perf_counter() - t0
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        state = sim.step(state, DT)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(cuda_direct.LAUNCHES)
    want = 0 if rehearsal else steps + 2
    if launches[name] != want:
        fail(f"{name} launched {launches[name]} times on the main path, "
             f"want {want} (prime + {steps + 1} steps)")
    for field in ("pos", "vel", "acc"):
        if not bool(torch.isfinite(getattr(state, field)).all()):
            fail(f"non-finite state.{field} after the main path ({method})")
    # the final cached force against a float64 plain force on sampled
    # targets (sources chunked: a dense 4096 x N x 3 f64 temporary is 25 GB)
    idx = torch.as_tensor(np.random.default_rng(0).choice(
        n, size=min(4096, n), replace=False), device=dev)
    pos64 = state.pos.double()
    a_ref = direct.acc_cross_chunked(pos64[idx], pos64, state.mass.double(),
                                     softening="plummer", eps=1e-2, g=1.0,
                                     chunk=8192)
    err = float((state.acc[idx].double() - a_ref).abs().max()
                / a_ref.abs().max())
    row = {"phase": "main_path", "method": method, "n": n, "steps": steps,
           "prime_and_warmup_s": warm_s, "ms_per_step": 1e3 * wall / steps,
           "pairs_per_s": steps * float(n) * n / wall, "launches": launches,
           "max_rel_err_vs_f64": err}
    if not rehearsal:
        kernel_ms = cuda_ms(lambda: sim.acc_fn(state.pos, state.mass), 5)
        row.update(kernel_ms=kernel_ms,
                   bound_ms=1e3 * FLOPS_PER_PAIR[name] * n * n
                   / PEAK_F32_FLOPS, nvidia_smi=card["smi"])
    emit(row)
    if not err <= 1e-3:
        fail(f"main path force off the float64 plain force by {err} "
             "of max|a| (want <= 1e-3)")
    return launches[name]


def phase_main_path(dev, rehearsal, card):
    from spacetpu_torch.models import presets

    n = 2048 if rehearsal else 262_144
    scene = presets.random_cluster(n, seed=0, g=1.0)
    return scene, {f"direct_{m}": run_main_path(scene, m, dev, rehearsal,
                                                card)
                   for m in ("vpu", "mxu")}


def phase_reference_path(dev, rehearsal):
    import spacetpu_torch as st
    from spacetpu_torch.constants import DELTA
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(300 if rehearsal else 10_000)
    out = {}
    for backend in ("auto", "torch"):
        sim = st.reference_compatible(scene.n, backend=backend, device=dev)
        state = sim.run(scene.state(dtype=torch.float64, device=dev), DELTA,
                        50)
        out[backend] = state.pos.cpu().numpy()
    diff = np.abs(out["auto"] - out["torch"])
    rel = float((diff / np.maximum(np.abs(out["torch"]), 1e-300)).max())
    emit({"phase": "reference_path", "n": scene.n, "steps": 50,
          "max_abs_diff": float(diff.max()), "max_rel_diff": rel})
    np.testing.assert_allclose(out["auto"], out["torch"], rtol=1e-10,
                               atol=1e-13)


def phase_energy(dev, rehearsal):
    import spacetpu_torch as st
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import energy

    n = 1024 if rehearsal else 65_536
    scene = presets.random_cluster(n, seed=0, g=1.0)
    sim = st.make_simulation(n, device=dev, **MAIN)

    def e_of(s):
        return float(energy.total_energy(
            s.pos.double(), s.vel.double(), s.mass.double(),
            softening="plummer", eps=1e-2, g=1.0))

    state = sim.prime(scene.state(dtype=torch.float32, device=dev))
    e0 = e_of(state)
    state = sim.run(state, DT, 100)
    e1 = e_of(state)
    drift = abs(e1 - e0) / abs(e0)
    emit({"phase": "energy", "n": n, "steps": 100, "dt": DT, "e0": e0,
          "e1": e1, "rel_drift": drift})
    if not drift < 1e-4:
        fail(f"energy drift {drift} >= 1e-4")


def phase_kernel_table(scene, launches, loops, card, dev):
    """Each kernel at the main path's shapes: against its plain version,
    timed beside its bound and the plain version's time. `issue_bound_ms`
    is the time to issue the inner loop's machine instructions (8 pairs a
    loop) at one warp instruction a clock on each of the SM's 4
    sub-partitions, at the card's maximum SM clock."""
    from spacetpu_torch.ops import cuda_direct

    state = scene.state(dtype=torch.float32, device=dev)
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    table = []
    for method in ("vpu", "mxu"):
        name = f"direct_{method}"
        if method == "mxu":
            plain = lambda: cuda_direct.acc_cross_mxu_plain(  # noqa: E731
                pos, pos, mass, eps=1e-2, g=1.0)
        else:
            plain = lambda: cuda_direct.acc_cross_plain(  # noqa: E731
                pos, pos, mass, **kw)
        a_k = cuda_direct.acc_cross_kernel(pos, pos, mass, method=method,
                                           **kw)
        a_p = plain()
        err = float((a_k - a_p).abs().max())
        rel = err / float(a_p.abs().max())
        if method == "mxu":
            scale = mxu_term_scale(pos, pos, mass, 1e-2, 1.0)
            ok = err / scale <= 1e-4
        else:
            scale = None
            ok = rel <= 1e-4
        if not ok:
            fail(f"{name} off its plain version at the main path's shapes: "
                 f"max_abs_err={err} rel={rel} term_scale={scale}")
        ms = cuda_ms(lambda: cuda_direct.acc_cross_kernel(
            pos, pos, mass, method=method, **kw), 5)
        plain_ms = cuda_ms(plain, 1)
        flops = FLOPS_PER_PAIR[name] * float(n) * n
        nbytes = (3 * n + 4 * n + 3 * n) * pos.element_size()
        per_pair = loops[name] / 8 if loops.get(name) else None
        issue_ms = (None if per_pair is None else 1e3 * per_pair * n * n
                    / (card["sm_count"] * 4 * 32 * card["max_sm_mhz"] * 1e6))
        table.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "max_rel_err": rel,
            "rel_to_terms": None if scale is None else err / scale,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS,
                                  nbytes / PEAK_BYTES),
            "bound_by": ("operations" if flops / PEAK_F32_FLOPS
                         >= nbytes / PEAK_BYTES else "bytes"),
            "library_ms": None, "sass_per_pair": per_pair,
            "issue_bound_ms": issue_ms, "shape": [n, n],
            "dtype": "float32"})
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases on the CPU with the plain versions "
                         "at tiny N (prints no result)")
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if rehearsal else "cuda")

    card = phase_device(dev, rehearsal)
    loops = phase_build(rehearsal)
    phase_kernels(dev, rehearsal)
    scene, launches = phase_main_path(dev, rehearsal, card)
    phase_reference_path(dev, rehearsal)
    phase_energy(dev, rehearsal)
    if rehearsal:
        print("chip_smoke: cpu rehearsal finished; no result is printed",
              file=sys.stderr)
        return 0
    emit({"kernels": phase_kernel_table(scene, launches, loops, card, dev)})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
