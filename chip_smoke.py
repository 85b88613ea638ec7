#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spacetpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # same phases on the CPU, tiny N
    python3 chip_smoke.py --count-ops      # also count the card's kernels and
                                           # busy time a step (torch.profiler)

Phases, each printing one JSON line; the first that fails ends the run with
a nonzero exit code:

  device          card name, SM count, nvidia-smi name and power limit
  build           nvcc build of spacetpu_torch/csrc/*.cu (direct, tree,
                  splat), one process a source, together: time, registers,
                  spills
  kernels         every direct kernel against its plain PyTorch version, both
                  laws, eps in {1e-2, 0}, ragged and cross shapes,
                  float32/float64; direct_mxu's float32 TF32 wrong version
                  (one-pass products, tests/tf32_split.py) must fail the
                  hold that the kernel passes; pair_potential against its
                  plain version in both dtypes and laws, eps 1e-2 and 0,
                  one block, an odd and an even count of blocks, and
                  coincident and subnormal-d^2 pairs (POTENTIAL_CASES), two
                  calls bit for bit
  tree_kernels    quad_dense, pairs_direct (both laws, eps in {1e-2, 0}) and
                  pairs_quad against their plain versions, float32/float64,
                  on tile lists built by the port's tree_prep at N=4099
                  (leaf 31, ragged) and N=65536 (leaf 255); quad_masked and
                  pairs_quad_shared on the port's far3 prep at N=3833 (leaf
                  15, 256 clusters = 4 supers), M1 rows with interior nulls
                  and strips shared through tile_src, and on a hand-made
                  list whose paired clusters do not share their tiles, at
                  an odd G (tests/pair_hold.py: unpaired_shared_case)
  main_path       the benchmark configuration (random_cluster(262144), f32,
                  direct, leapfrog, plummer eps=1e-2) through the port's entry
                  points, with pallas_method "vpu" and then "mxu"
  tree_path       fixed_cloud(1000000), f32, algorithm="tree", theta 0.5,
                  plummer eps=1e-3, k_near="auto": prime (calibrates), a
                  warm-up step, five timed steps; prep/eval split, caps, tile
                  counts, overflow, launches, force error on 4096 targets
                  against the direct kernel
  far3_path       fixed_cloud(4000000), the tree_path settings and every other
                  default: far_levels "auto" resolves to 3 (15,744 clusters),
                  cluster_mode to "equal"; the same report, with the live
                  M1/M2 tile counts
  plummer_path    plummer_sphere(1000000), theta 0.5, plummer eps=1e-2,
                  k_near="auto", cluster_mode and far_levels "auto": the
                  calibration picks the adaptive partition and three levels;
                  three steps timed
  strip_kernels   near_strip, quad_strip and quad_refine against their plain
                  versions on strip preps built by the port's tree_prep
                  (N=4099 at leaf 31 and N=65536 at leaf 255 with null
                  slots, an emptied list and K = 0, both laws; a far3 prep
                  of 15,353 bodies with two 512-column strip tiles):
                  float64 within 1e-9 of max|a|, float32 target by target
                  against the float64 sums (tests/pair_hold.py), where wrong
                  versions must fail the same limit; quad_refine on one
                  column a super gives quad_strip's terms of the negated
                  column negated, bit for bit
  strip_path      tree_path's configuration with near_mode="strip": the
                  same report, then the kernels held on four target
                  clusters, the live and the TPU's padded work, and the
                  strip tree at N=20001 in float64 against the native
                  oracle's direct sum (spacetpu_torch.native)
  far3_strip_path far3_path's scene (4,000,001 bodies) in strip mode: three
                  far-field levels through quad_masked and quad_refine;
                  three steps timed; the kernels held on four clusters
  treepm_kernels  pairs_hybrid, pairs_short and pairs_short_hybrid against
                  their plain versions on cutoff tile lists built by the
                  port's treepm_prep: N=4099 (leaf 31) every law, eps in
                  {1e-2, 0} and both splits, N=65536 (leaf 255) the paths'
                  settings, N=1500 (leaf 15) pairs_short's poly walk,
                  float32/float64; float32 also target by target against
                  the float64 sums (tests/pair_hold.py), where wrong
                  versions must fail the same limit; the poly walk of
                  pairs_short and pairs_short_hybrid: two calls bit for
                  bit, its pair counts, its skip moved inside r_cut failing
                  the holds, and two pairs one ulp inside r_cut evaluated
  treepm_path     fixed_cloud(1000000), f32, algorithm="treepm" and every
                  other default (grid 256, poly split, plummer eps 0):
                  prime, a warm-up step, five timed steps; prep, short-range
                  and PM (deposit, solve, gather) times, caps, mesh,
                  out_of_box and near_overflow (must be 0), launches, peak
                  memory, force error on 4096 targets against the direct
                  kernel (median 1.5e-2, p99 6e-2)
  pm_path         the same with algorithm="pm" (grid 128; no pair kernel):
                  median error 5e-2 against the direct kernel at the PM's
                  own softening
  mxu_paths       tree_path's configuration and treepm_path's with
                  pallas_method="mxu", three timed steps each, beside the
                  vpu runs
  default_workload  fixed_cloud(10000), make_simulation(n) with every default
                  ("auto" picks the tree, theta 0.3), 100 leapfrog steps,
                  |dE/E| < 1e-4
  reference_path  reference_compatible on fixed_cloud(10000) in float64:
                  kernel against the plain path over 50 Euler steps
  energy          random_cluster(65536), 100 leapfrog steps, |dE/E| < 1e-4
  splat_kernels   splat_tiles against its float64 plain version pixel by
                  pixel (tests/splat_hold.py: 1e-5 of the value plus 1e-7
                  of the window's maximum) on tests/test_fastsplat.py's
                  3,000 entries and hot tile, the default app's first and
                  tenth frame, and single tiles of SEG, SEG + 1, 5 SEG + 3
                  and 82,332 entries (one to 41 segments); four wrong
                  versions must fail the limit, and two calls must agree
                  bit for bit
  app_path        python -m spacetpu_torch's main() on fixed_cloud(1000000)
                  at 1920x1080, 30 offline frames, every other default: the
                  solver the auto tier picks (PM) and its grid, frames/s,
                  ticks/s, the render's pieces by CUDA events, PNG ms,
                  entries a frame, the fullest tile, peak memory, one
                  splat_tiles launch a frame, lit frames; splat_tiles held
                  on the last frame's 3 fullest and 3 seeded tiles
  default_app     main() at every default (fixed_cloud(10000), 960x540, the
                  tree), 60 offline frames; and earth_sun_mars, whose
                  blend="auto" takes render_ordered
  headless_path   main() with --frontend none --n 1000000 --steps 20: the
                  seconds of its two energy sums (one pair_potential launch
                  each)
  headless_strip  main() with --frontend none --algorithm tree --near-mode
                  strip --n 200000 --steps 10: steps/s and the drift
  engine          a SimEngine at N=1000000 (PM): ticks/s without and with a
                  consumer sampling at 20 Hz, the snapshot's latency,
                  current_ticks never going back; a TreePM engine whose
                  forced mid-run fallback swaps to the tree

Then, each on a line of its own: the fifteen kernels at their main
path's shapes, the fourteen ports of TPU kernels and pair_potential (time,
bound, plain time, launches on the main path, and for every kernel but
splat_tiles the SASS instructions a pair and the issue bound;
pair_potential's kernel launches a call; pairs_short and
pairs_short_hybrid bounded over the pairs inside r_cut, with the listed
and the evaluated pairs beside (one walk: the same chunks skipped);
pairs_hybrid with the share of its cluster pairs whose
boxes are disjoint (swept without the r^2 = 0 mask); direct_* on main_path,
quad_dense/pairs_direct/pairs_quad on tree_path, quad_masked and
pairs_quad_shared on far3_path, pairs_short on treepm_path, pairs_hybrid
and pairs_short_hybrid on mxu_paths, splat_tiles on app_path, near_strip
and quad_strip on strip_path, quad_refine on far3_strip_path,
pair_potential on headless_path), the card's name and power limit, and a
last line {"ok": true, "device": {...}}. The rehearsal runs the plain
versions at tiny N (the far3 phases with far_levels=3 and leaf 15 asked for,
since "auto" never picks it there; the mesh paths at N=3001) and never
prints that last line.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

#: the card's published float32 rate outside the tensor cores, its dense
#: TF32 tensor-core rate and its memory rate (H100 SXM data sheet), for the
#: bound of each kernel
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
#: reciprocal square roots an SM retires a clock (the MUFU unit: 4 lanes on
#: each of the 4 sub-partitions)
MUFU_PER_SM_CLOCK = 16
#: direct_mxu in float32 (csrc/direct.cu: direct_mxu_tc_kernel), a pair:
#: tensor-core flops (3,584 FMA per m16n8 tile of 128 pairs: product 1's
#: m16n8k8 and m16n8k4, product 2's two m16n8k8) and float32 instructions
#: on the CUDA cores (max, two multiplies, the subtract of the split of w)
MXU_TC_FLOPS = 56
MXU_TC_F32_OPS = 4
#: pair_potential, an unordered pair (1/d_ij = 1/d_ji, so N (N - 1) / 2 of
#: them give every body's sum): 3 differences, 5 for r^2, 1 for eps^2 and 2
#: for the mass product and sum; the guards and the self select are the
#: design's, not the function's
POTENTIAL_FLOPS = 11
#: flops a pair: the JAX package's count for _kernel (pallas_direct.py:348),
#: and the same count for the CUDA-core expanded form (dot 5, d2 4, max 1,
#: rsqrt 1, cube 2, mass 1, sums 7)
#: the tree's kernels: 22 a (target, body) pair under the plummer law as for
#: _kernel, and 58 a (target, summary) pair, counted step by step in
#: spacetpu_torch/csrc/pair.cuh (quad_term)
#: the hybrid sums, counted step by step in spacetpu_torch/csrc/tree.cu:
#: 21 a pair in pairs_hybrid (plummer, eps > 0); the short-range law's
#: count depends on the law and eps (`short_flops`)
FLOPS_PER_PAIR = {"direct_vpu": 22, "direct_mxu": 21, "quad_dense": 58,
                  "pairs_direct": 22, "pairs_quad": 58, "quad_masked": 58,
                  "pairs_quad_shared": 58, "pairs_hybrid": 21,
                  "near_strip": 22, "quad_strip": 58, "quad_refine": 58}


def short_flops(name, kw) -> int:
    """Flops a pair of the short-range law's function (pairs_short, and
    pairs_short_hybrid with its 2 more for the hybrid sums), counted step by
    step in spacetpu_torch/csrc/tree.cu and pair.cuh: differences 3, r^2 5,
    sums 6, and the weight: with the poly split at plummer eps 0 (the
    paths' default) g m (1 - G(y)) / r^3, 13 (PolyLean), else ShortWeight's
    23 (poly) or 67 (gauss)."""
    if kw["split"] != "poly":
        weight = 67
    elif kw["softening"] == "plummer" and kw["eps"] == 0:
        weight = 13
    else:
        weight = 23
    return 3 + 5 + weight + 6 + 2 * (name == "pairs_short_hybrid")
REPLACES = {
    "direct_vpu": "spacetpu/ops/pallas_direct.py:49 (_kernel)",
    "direct_mxu": "spacetpu/ops/pallas_direct.py:261 (_kernel_mxu)",
    "quad_dense": "spacetpu/ops/pallas_direct.py:94 (_kernel_quad)",
    "pairs_direct": "spacetpu/ops/tree.py:1362 (_kernel_pairs)",
    "pairs_quad": "spacetpu/ops/tree.py:1474 (_kernel_quad_pairs)",
    "quad_masked": "spacetpu/ops/pallas_direct.py:94 (_kernel_quad, as "
                   "tree.py:662 _superfar_dense_masked launches it)",
    "pairs_quad_shared": "spacetpu/ops/tree.py:1474 (_kernel_quad_pairs, "
                         "as tree.py:1319-1326 mid_far_eval launches it "
                         "with tile_src)",
    "pairs_hybrid": "spacetpu/ops/tree.py:1402 (_kernel_pairs_hybrid)",
    "pairs_short": "spacetpu/ops/treepm.py:405 (_kernel_pairs_short)",
    "pairs_short_hybrid": "spacetpu/ops/treepm.py:477 "
                          "(_kernel_pairs_short_hybrid)",
    "splat_tiles": "spacetpu/render/fastsplat.py:172 (_splat_kernel, "
                   "launched by _splat_tiles_pallas 222 -> 248)",
    "near_strip": "spacetpu/ops/tree.py:799 (_near_correction_chunk: "
                  "pallas_direct._kernel launched at 829, through "
                  "_near_correction_pallas 772)",
    "quad_strip": "spacetpu/ops/tree.py:850 (_near_multipole_sub_pallas: "
                  "pallas_direct._kernel_quad launched at 868)",
    "quad_refine": "spacetpu/ops/tree.py:673 (_superfar_refine_pallas: "
                   "pallas_direct._kernel_quad launched at 688)",
}
#: the tree's kernels, and each one's launches a force pass on the two-level
#: and the three-level pair path
TREE_KERNELS = ("quad_dense", "pairs_direct", "pairs_quad", "quad_masked",
                "pairs_quad_shared", "pairs_hybrid", "pairs_short",
                "pairs_short_hybrid", "near_strip", "quad_strip",
                "quad_refine")
_MESH_OR_HYBRID = {"pairs_hybrid": 0, "pairs_short": 0,
                   "pairs_short_hybrid": 0, "near_strip": 0, "quad_strip": 0,
                   "quad_refine": 0}
FAR2_PASS = {"quad_dense": 1, "pairs_direct": 1, "pairs_quad": 1,
             "quad_masked": 0, "pairs_quad_shared": 0, **_MESH_OR_HYBRID}
FAR3_PASS = {"quad_dense": 0, "pairs_direct": 1, "pairs_quad": 1,
             "quad_masked": 1, "pairs_quad_shared": 2, **_MESH_OR_HYBRID}
#: the tree path with pallas_method="mxu": the hybrid sums in place of
#: pairs_direct
FAR2_MXU_PASS = dict(FAR2_PASS, pairs_direct=0, pairs_hybrid=1)
#: strip mode (near_mode="strip") on two and on three far-field levels
STRIP2_PASS = dict(FAR2_PASS, pairs_direct=0, pairs_quad=0, near_strip=1,
                   quad_strip=1)
STRIP3_PASS = dict(FAR3_PASS, pairs_direct=0, pairs_quad=0,
                   pairs_quad_shared=0, near_strip=1, quad_strip=1,
                   quad_refine=1)
#: the strip kernels, by the path whose shapes their kernels-line rows take
STRIP_KERNELS = {"near_strip": "strip_path", "quad_strip": "strip_path",
                 "quad_refine": "far3_strip_path"}
#: TreePM's kernel a force pass (its mesh half is cuFFT and torch ops)
TREEPM_PASS = dict.fromkeys(TREE_KERNELS, 0)
TREEPM_PASS["pairs_short"] = 1
TREEPM_MXU_PASS = dict(TREEPM_PASS, pairs_short=0, pairs_short_hybrid=1)
PM_PASS = dict.fromkeys(TREE_KERNELS, 0)
#: the force error limits of the mesh paths: the JAX package's own tests of
#: its TreePM (tests/test_treepm.py:142-143) and PM (tests/test_pm.py:83,
#: against the direct force at the PM's own softening)
TREEPM_ERR = {"median": 1.5e-2, "p99": 6e-2}
PM_ERR = {"median": 5e-2}
SOURCE = "spacetpu_torch/csrc/direct.cu"
TREE_SOURCE = "spacetpu_torch/csrc/tree.cu"
SPLAT_SOURCE = "spacetpu_torch/csrc/splat.cu"
#: the tile counts the split-tile cases of splat_kernels hold: one segment
#: exactly full, one entry over, five and a bit, and the fullest tile of
#: app_path's 30th frame
SPLAT_SPLIT_COUNTS = ("seg", "seg+1", "5seg+3", 82_332)
#: the app path: `python -m spacetpu_torch` at 1M bodies and 1080p
APP_ARGS = ["--preset", "fixed_cloud", "--n", "1000000", "--frontend",
            "offline", "--frames", "30", "--width", "1920", "--height",
            "1080"]
#: the tree path: the configuration of benches/prof_tree_hier.py
TREE = dict(algorithm="tree", theta=0.5, softening="plummer", eps=1e-3,
            k_near="auto")
MAIN = dict(algorithm="direct", integrator="leapfrog", softening="plummer",
            eps=1e-2, g=1.0)
DT = 1e-3


#: each path phase's printed line, by phase name (the mxu_paths phase reads
#: the vpu runs beside its own)
RESULTS: dict = {}


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


def device_ops(fn) -> dict:
    """What the card ran for one call of fn(), from a `torch.profiler`
    trace: the number of kernels and copies, the time they kept the card
    busy, and the host's wall time for the call under the profiler (which
    slows the host). Null counts where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        return {"device_ops": None, "device_busy_ms": None,
                "profiled_wall_ms": 1e3 * wall}
    return {"device_ops": len(on_card),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in on_card) / 1e3,
            "profiled_wall_ms": 1e3 * wall}


def bodies(n, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    pos = torch.as_tensor(rng.uniform(-1, 1, size=(n, 3)), dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(rng.uniform(0.1, 1.0, size=n), dtype=dtype,
                           device=dev)
    return pos, mass


def far3_bodies(n, seed, dtype, dev):
    """A dense core, a wide halo and a distant blob: some superclusters are
    near each other and some are not, so the far3 lists have work and
    holes in them."""
    rng = np.random.default_rng(seed)
    k = n // 3
    pos = np.concatenate([rng.normal(size=(k, 3)) * 0.3,
                          rng.normal(size=(k, 3)) * 2.0,
                          rng.normal(size=(n - 2 * k, 3)) * 0.5
                          + [25.0, 0.0, 0.0]])
    return (torch.as_tensor(pos, dtype=dtype, device=dev),
            torch.as_tensor(rng.uniform(0.1, 1.0, n), dtype=dtype,
                            device=dev))


def mufu_ms(rsqrts, card) -> float:
    """The time the card's MUFU units take for `rsqrts` reciprocal square
    roots, at its maximum SM clock."""
    return 1e3 * rsqrts / (card["sm_count"] * MUFU_PER_SM_CLOCK
                           * card["max_sm_mhz"] * 1e6)


def mxu_bound(pairs, card) -> dict:
    """The floor of direct_mxu in float32 for `pairs` pairs: the largest of
    its three pipes' times. MUFU: one rsqrt a pair; tensor cores:
    MXU_TC_FLOPS a pair at the TF32 rate; CUDA cores: MXU_TC_F32_OPS
    instructions a pair at half the float32 flop rate (which counts an FMA
    as two)."""
    floors = {"mufu_ms": mufu_ms(pairs, card),
              "tensor_ms": 1e3 * MXU_TC_FLOPS * pairs / PEAK_TF32_FLOPS,
              "f32_ms": 1e3 * MXU_TC_F32_OPS * pairs
              / (PEAK_F32_FLOPS / 2)}
    return {"bound_ms": max(floors.values()), "bound_by": "operations",
            "pipe_floors_ms": floors}


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
    """Each kernel's pair loop, from cuobjdump -sass: its machine
    instruction count and opcode histogram. The sources unroll their pair
    loops 8 times or more (`PAIRS_PER_LOOP`), so the pair loop is the
    shortest backward branch that holds at least 8 MUFU instructions (a
    rsqrt or more a pair; the staging loops and the remainder loop hold
    fewer; `LOOP_MUFU` where a trip holds another count), or the shortest
    backward branch where none does; a pair costs a loop's count / `PAIRS_PER_LOOP`
    issue slots. `pair_loops` lists the
    instruction counts of every such loop that holds no other (two in
    pairs_hybrid: the sweep of a source cluster apart from the warp's
    targets, then the masked one)."""
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
        least = next((LOOP_MUFU[k] for k, tag in MAIN_INSTANCES.items()
                      if k in LOOP_MUFU and tag in name), 8)
        hists = []
        for span, lo, hi in spans:
            ops: dict[str, int] = {}
            for at, op, _ in code:
                if lo <= at <= hi:
                    ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
            hists.append((ops.get("MUFU", 0) < least, span, ops, lo, hi))
        ops = min(hists, key=lambda h: h[:2])[2]
        pair = [h for h in hists if not h[0]]
        inner = [h for h in pair
                 if not any(o is not h and h[3] <= o[3] and o[4] <= h[4]
                            for o in pair)]
        loops[name.strip()] = {"instructions": sum(ops.values()),
                               "ops": dict(sorted(ops.items())),
                               "pair_loops": sorted(sum(h[2].values())
                                                    for h in inner)}
    return loops


#: the sources of csrc/ the paths run, built together
LIBRARIES = ("direct", "tree", "splat")

#: the instance of each kernel that the paths run (a part of its mangled
#: name): float32, plummer, the direct paths and the tree with eps > 0 (the
#: direct law's kernels with DirectLean, the MUFU rsqrt alone: direct_vpu
#: with two targets a thread, and the two-target kernels near_strip and
#: pairs_two_kernel, pairs_direct without and pairs_hybrid with the centred
#: sums; quad_dense and quad_masked: quad_two_kernel without and with the
#: keep mask, QUAD_TARGETS targets a thread), TreePM with eps = 0 and the
#: poly split; pair_potential's band kernel at the headless path's eps = 0
#: (POT_P = 16 rows a lane, POT_WARPS = 16, the MUFU rsqrt with a chunk's
#: check, no eps^2 to add)
MAIN_INSTANCES = {
    "direct_vpu": "direct_vpu_lean_kernelINS_10DirectLeanIfEELi2EE",
    "direct_mxu": "direct_mxu_tc_kernel",
    "pairs_direct": "pairs_two_kernelIfNS_10DirectLeanIfEELb0EE",
    "pairs_hybrid": "pairs_two_kernelIfNS_10DirectLeanIfEELb1EE",
    "pairs_short": "pairs_cut_kernelIfNS_8PolyLeanIfEELb0EE",
    "pairs_short_hybrid": "pairs_cut_kernelIfNS_8PolyLeanIfEELb1EE",
    "pairs_quad_shared": "pairs_quad_shared_kernelIfLi2EE",
    "near_strip": "near_strip_kernelIfNS_10DirectLeanIfEELb0EE",
    "quad_strip": "quad_strip_kernelIfE",
    "quad_refine": "quad_refine_kernelIfE",
    "quad_dense": "quad_two_kernelIfLb0ELi2EE",
    "quad_masked": "quad_two_kernelIfLb1ELi2EE",
    "pairs_quad": "pairs_quad_kernelIfE",
    "pair_potential": "potential_band_kernelIfLi16ELi16ELi0ELb0EE"}

#: MUFU instructions in a trip of a kernel's pair loop where not 8:
#: pairs_quad unrolls its one-target loop 4 times; pair_potential's band
#: kernel takes POT_UNROLL (4) columns a trip against POT_P (16) rows, 64
#: (its sweep again with the guard, one column a trip, holds 16)
LOOP_MUFU = {"pairs_quad": 4, "pair_potential": 64}


def phase_build(rehearsal):
    """Build the kernels; returns the inner-loop instruction count of the
    instance of each kernel that the main path runs."""
    from spacetpu_torch import _build

    if rehearsal:
        emit({"phase": "build", "skipped": "cpu rehearsal: no nvcc"})
        return {}
    t0 = time.perf_counter()
    _build.build(*LIBRARIES)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    kernels, loops = [], {}
    for name in LIBRARIES:
        info = _build.BUILD_INFO[name]
        found = ptxas_summary(info["log"])
        if not found:
            fail(f"no ptxas report in the build log of {name}.cu:\n"
                 + info["log"])
        if os.path.exists(cuobjdump):
            loops.update(sass_loops(cuobjdump, info["path"]))
        kernels += found
    for k in kernels:
        k["inner_loop"] = loops.get(k["function"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {n: _build.BUILD_INFO[n]["seconds"]
                           for n in LIBRARIES},
          "libraries": [_build.BUILD_INFO[n]["path"] for n in LIBRARIES],
          "kernels": kernels})
    if any(k.get("spill_stores", 0) for k in kernels):
        print("chip_smoke: note: a kernel spills registers", file=sys.stderr)
    return {name: next((v["instructions"] for f, v in loops.items()
                        if tag in f and v), None)
            for name, tag in MAIN_INSTANCES.items()}


#: an eps whose float32 square is subnormal: float32 plummer takes eps^2
#: as 0 there, with the eps == 0 mask, as the JAX package's XLA path does
SUBNORMAL_EPS = 1e-20


def softened(eps) -> bool:
    """Whether eps softens the float32 terms (eps^2 not taken as 0:
    `direct.plummer_eps2`); otherwise close pairs dwarf the net force."""
    from spacetpu_torch.ops import direct

    return direct.plummer_eps2(float(eps), torch.float32) > 0.0


def kernel_cases(rehearsal):
    from spacetpu_torch import constants

    sizes = (100, 300, 700) if rehearsal else (100, 4099, 16384)
    small = sizes[1]
    cases = []
    for dtype in (torch.float32, torch.float64):
        for law, eps in (("plummer", 1e-2), ("plummer", 0.0),
                         ("plummer", SUBNORMAL_EPS), ("ref", 1e-2),
                         ("ref", 0.0), ("ref", constants.COLLISION_EPSILON)):
            for n in sizes:
                if not softened(eps) and n > small:
                    continue  # unsoftened: only where terms stay sane
                cases.append(("vpu", dtype, law, eps, n, n))
            if softened(eps):
                cases.append(("vpu", dtype, law, eps, small, sizes[2]))
        for n in sizes:
            cases.append(("mxu", dtype, "plummer", 1e-2, n, n))
        cases.append(("mxu", dtype, "plummer", 1e-2, small, sizes[2]))
    return cases


def phase_kernels(dev, rehearsal):
    from spacetpu_torch.ops import cuda_direct

    tf32 = load_tests_module("tf32_split")
    results = []
    worst = {"direct_vpu": 0.0, "direct_mxu": 0.0}
    for method, dtype, law, eps, m, k in kernel_cases(rehearsal):
        pos_j, mass_j = bodies(k, seed=k, dtype=dtype, dev=dev)
        pos_i = pos_j if m == k else bodies(m, seed=m + 1, dtype=dtype,
                                            dev=dev)[0]
        kw = dict(softening=law, eps=eps, g=1.0)
        # m == k: all pairs, the targets named as the sources
        a_k = cuda_direct.acc_cross_kernel(
            pos_i, pos_j, mass_j, method=method,
            self_offset=0 if m == k else None, **kw)
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
            tol = 1e-11 if f64 else tf32.F32_TOL
            ok = row["rel_to_terms"] <= tol
            if not f64 and max(m, k) >= (300 if rehearsal else 4000):
                # the wrong version: both products in one TF32 pass
                wrong = tf32.acc_mxu_tf32(pos_i, pos_j, mass_j, eps=eps,
                                          g=1.0, terms=1)
                row["one_pass_tf32_rel_to_terms"] = float(
                    (wrong - a_p).abs().max()) / row["term_scale"]
                ok = ok and row["one_pass_tf32_rel_to_terms"] > tol
            if not f64 and m == k:
                a_v = cuda_direct.acc_cross_kernel(pos_i, pos_j, mass_j, **kw)
                band = float(torch.linalg.norm(a_k - a_v, dim=1).max()
                             / torch.linalg.norm(a_v, dim=1).max())
                row["vs_vpu"] = band
                # the band of tests/test_pallas.py:66-79; at N=100 a single
                # close pair can carry the force, where the expanded form's
                # d2 error is largest
                ok = ok and (m < 4000 or band < 2e-3)
        elif softened(eps):
            tol = 1e-11 if f64 else 1e-4
            ok = row["max_rel_err"] <= tol
        else:
            # unsoftened close pairs dwarf the net force: finite everywhere,
            # and in float64 the same sum up to reordering; float32 at the
            # subnormal eps^2 takes eps = 0's arithmetic, so its bits
            tol = 1e-9 if f64 else None
            ok = tol is None or row["max_rel_err"] <= tol
            if eps > 0.0 and not f64:
                row["equal_to_eps_0"] = bool(torch.equal(
                    a_k, cuda_direct.acc_cross_kernel(
                        pos_i, pos_j, mass_j, softening=law, eps=0.0,
                        g=1.0)))
                ok = ok and row["equal_to_eps_0"]
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
    a_v = cuda_direct.acc_direct_kernel(pos, mass, **kw)
    a_m = cuda_direct.acc_direct_kernel(pos, mass, method="mxu", **kw)
    band = float(torch.linalg.norm(a_m - a_v, dim=1).max()
                 / torch.linalg.norm(a_v, dim=1).max())
    shards = mxu_shard_cases(dev, rehearsal, tf32.F32_TOL)
    potential = potential_cases(dev, rehearsal)
    emit({"phase": "kernels", "cases": results, "worst_rel_err": worst,
          "mxu_vs_vpu_test_pallas_case": band, "mxu_shards": shards,
          "pair_potential": potential})
    if not band < 2e-3:
        fail(f"mxu vs vpu band {band} >= 2e-3 on the test_pallas case")


def mxu_shard_cases(dev, rehearsal, tol) -> list:
    """direct_mxu in float32 on targets that are a copy or a shard of the
    sources, named by `self_offset`: bit for bit the rows of the all-pairs
    call on the same sources where the targets are a copy, within the term
    scale's hold and the 2e-3 band against direct_vpu where they are a
    shard (its rows sit at other places in the kernel's row tiles), and
    with no offset the self pairs summed in the expanded form and held to
    the term scale alone (the band is the dropped pairs' gain)."""
    from spacetpu_torch.ops import cuda_direct

    n = 700 if rehearsal else 4099
    pos, mass = bodies(n, seed=n, dtype=torch.float32, dev=dev)
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    full = cuda_direct.acc_direct_kernel(pos, mass, method="mxu", **kw)
    a_v = cuda_direct.acc_direct_kernel(pos, mass, **kw)
    # a shard that starts inside a 256-source tile, so a warp's rows meet
    # their sources in two tiles
    lo, hi = n // 4 + 7, n // 4 + 7 + n // 3
    rows = []
    for name, start, stop, offset in (("clone", 0, n, 0),
                                      ("shard", lo, hi, lo),
                                      ("unnamed", lo, hi, None)):
        tgt = pos[start:stop].clone()
        got = cuda_direct.acc_cross_kernel(tgt, pos, mass, method="mxu",
                                           self_offset=offset, **kw)
        want = cuda_direct.acc_cross_mxu_plain(tgt, pos, mass, eps=1e-2,
                                               g=1.0)
        scale = mxu_term_scale(tgt, pos, mass, 1e-2, 1.0)
        ref = a_v[start:stop]
        row = {"case": name, "m": stop - start, "k": n,
               "self_offset": offset,
               "rel_to_terms": float((got - want).abs().max()) / scale,
               "vs_vpu": float(torch.linalg.norm(got - ref, dim=1).max()
                               / torch.linalg.norm(ref, dim=1).max())}
        ok = row["rel_to_terms"] <= tol
        if name == "clone":
            row["equal_to_all_pairs"] = bool(torch.equal(got, full))
            ok = ok and row["equal_to_all_pairs"]
        elif offset is not None and not rehearsal:
            # the plain versions, which the rehearsal runs, keep self pairs
            ok = ok and row["vs_vpu"] < 2e-3
        rows.append(row)
        if not ok:
            fail(f"direct_mxu on named targets: {row}")
    return rows


#: pair_potential's holds, each body's sum against the plain version's
#: relative to itself (every term is >= 0, so the sum is the size of what
#: rounds): float64 1e-12 (only the order of the sums differs); float32
#: 1e-5 (a lane's running sums over a band's columns, joined over warps,
#: bands and slots in a fixed order, against torch's reduction: a few
#: roundings of 2^-24 at each of a handful of levels)
POTENTIAL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def potential_size(rows: int, blocks: str) -> int:
    """N of a pair_potential case by the blocks of `rows` rows it makes:
    "one" (N < rows: the diagonal tile alone), "odd" (7) or "even" (10,
    whose last offset, B / 2, goes to half the blocks); none a multiple of
    `rows`."""
    return {"one": rows - 17, "odd": 7 * rows - 9,
            "even": 10 * rows - 17}[blocks]


#: pair_potential's cases: (dtype, law, eps, blocks, close), close naming
#: where tests/potential_sym.py: close_pairs_case puts a coincident pair
#: and a pair whose float32 d^2 is subnormal (eps = 0), or None
POTENTIAL_CASES = [
    (dtype, law, eps, blocks, None)
    for dtype in (torch.float64, torch.float32)
    for law, eps in (("plummer", 1e-2), ("plummer", 0.0), ("ref", 0.0),
                     ("ref", 1e-2))
    for blocks in ("one", "odd", "even")] + [
    (dtype, law, 0.0, blocks, close)
    for dtype in (torch.float64, torch.float32)
    for law in ("plummer", "ref")
    for blocks, close in (("even", "across"), ("odd", "inside"),
                          ("one", "inside"))]


def potential_cases(dev, rehearsal) -> list:
    """pair_potential against its plain version (`POTENTIAL_CASES`): both
    laws and dtypes, eps 1e-2 and 0, one block, an odd and an even count,
    and at eps = 0 a coincident pair and a subnormal-d^2 pair across blocks
    and inside one; two calls give the same bits, each counted once."""
    from spacetpu_torch.ops import energy

    potential_sym = load_tests_module("potential_sym")
    rows = []
    for dtype, law, eps, blocks, close in POTENTIAL_CASES:
        r = 64 if rehearsal else energy.potential_rows(dtype)
        n = potential_size(r, blocks)
        if close:
            pos, mass = potential_sym.close_pairs_case(
                n, r, dtype, dev, seed=n, across=close == "across")
        else:
            pos, mass = bodies(n, seed=n + 3, dtype=dtype, dev=dev)
        before = energy.LAUNCHES["pair_potential"]
        got = energy.pair_potential(pos, mass, softening=law, eps=eps)
        again = energy.pair_potential(pos, mass, softening=law, eps=eps)
        launched = energy.LAUNCHES["pair_potential"] - before
        want = energy.pair_potential_plain(pos, mass, softening=law,
                                           eps=eps)
        rel = float(((got - want).abs() / want.abs()).max())
        row = {"dtype": str(dtype)[6:], "law": law, "eps": eps, "n": n,
               "blocks": -(-n // r), "close": close, "max_rel_err": rel,
               "tol": POTENTIAL_TOL[dtype], "launches": launched,
               "same_bits": bool(torch.equal(got, again))}
        rows.append(row)
        if not (rel <= POTENTIAL_TOL[dtype] and row["same_bits"]
                and launched == (0 if rehearsal else 2)):
            fail(f"pair_potential off its plain version: {row}")
    return rows


def tree_inputs(prep, g=1.0):
    """What the tree's three kernels take, from a pair-list prep."""
    from spacetpu_torch.ops import tree as tree_ops

    stats = (prep["pos_g"], prep["mass_g"], prep["com"], prep["m_tot"])
    summ = tree_ops._cluster_summaries(*stats, g)
    return {
        "targets": prep["pos_g"].reshape(-1, 3),
        "summaries": summ[:, :prep["pos_g"].shape[0]],
        "neg": tree_ops._negated(summ),
        "srows": {pseudo: tree_ops._pack_augmented(*stats, g,
                                                   monopole_pseudo=pseudo)
                  for pseudo in (True, False)},
    }


def far3_inputs(prep, g=1.0):
    """What the 3-level far field's two kernels take, from a far3 pair-list
    prep: the targets, the SUPER summaries, and the M1 (MID) and M2
    (cluster) summary tables with their null columns."""
    from spacetpu_torch.ops import tree as tree_ops

    gg = prep["pos_g"].shape[0]
    summ = tree_ops._cluster_summaries(prep["pos_g"], prep["mass_g"],
                                       prep["com"], prep["m_tot"], g)
    mid = tree_ops._super_multipoles(summ[:, :gg], group=tree_ops.MID)
    return {"targets": prep["pos_g"].reshape(-1, 3),
            "supers": tree_ops._super_multipoles(summ[:, :gg]),
            "m1": torch.cat([mid, mid.new_zeros((16, 1))], dim=1),
            "m2": summ}


def m1_source_rows(prep, theta):
    """The M1 source rows (one a super, null = G/MID) that tree_prep packed,
    rebuilt from the prep's statistics at the default k_mid."""
    from spacetpu_torch.ops import tree as tree_ops

    gg = prep["pos_g"].shape[0]
    st = (prep["com"], prep["m_tot"], prep["r_src"], prep["r_tgt"])
    com_m, spread_m, rs_max_m, _ = tree_ops._super_stats(
        *st, group=tree_ops.MID)
    idx_mid2, _ = tree_ops._mid_near_lists(
        *st, com_m, spread_m, rs_max_m,
        prep["m_tot"].reshape(-1, tree_ops.MID).sum(1), prep["idx2"], theta,
        tree_ops.default_k_mid(theta, gg // tree_ops.MID))
    return tree_ops._m1_lists(prep["idx2"], idx_mid2, gg)


def phase_tree_kernels(dev, rehearsal):
    """The tree's kernels against their plain versions on tile lists built
    by the port's own tree_prep. Tolerances, as a share of max|a|: float64
    1e-9 (the same arithmetic, sums in another order); float32 2e-5 (the
    JAX tests' band, tests/test_pallas.py:26) where softened; unsoftened
    float32 is held to be finite, as for the direct kernels."""
    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops

    sizes = ((600, 15), (2000, 31)) if rehearsal else ((4099, 31),
                                                       (65_536, 255))
    theta, rows = 0.5, []

    def hold(name, got, want, tol, **what):
        err = float((got - want).abs().max())
        row = {"kernel": name, "finite": bool(torch.isfinite(got).all()),
               "max_abs_err": err, "max_rel_err": err / float(want.abs().max()),
               "tol": tol, **what}
        rows.append(row)
        if not row["finite"] or (tol is not None
                                 and not row["max_rel_err"] <= tol):
            emit({"phase": "tree_kernels", "cases": rows})
            fail(f"kernel disagrees with its plain version: {row}")

    for n, leaf in sizes:
        for dtype in (torch.float32, torch.float64):
            f64 = dtype == torch.float64
            tol = 1e-9 if f64 else 2e-5
            pos, mass = bodies(n, seed=n, dtype=dtype, dev=dev)
            gg = -(-n // leaf)
            prep = tree_ops.tree_prep(
                pos, mass, theta=theta, gg=gg, leaf=leaf, near_mode="pairs",
                k_near=tree_ops.default_k_near(theta, gg))
            x = tree_inputs(prep)
            what = dict(dtype=str(dtype)[6:], n=n, leaf=leaf, clusters=gg,
                        tiles=int(prep["near_ntiles"]),
                        tiles_q=int(prep["nearq_ntiles"]))
            hold("quad_dense",
                 cuda_tree.acc_cross_quad(x["targets"], x["summaries"],
                                          eps=1e-2),
                 cuda_tree.acc_cross_quad_plain(x["targets"], x["summaries"],
                                                eps=1e-2), tol, **what)
            for law, eps, pseudo in (("plummer", 1e-2, False),
                                     ("plummer", 0.0, True),
                                     ("plummer", SUBNORMAL_EPS, True),
                                     ("ref", 1e-2, True), ("ref", 0.0, True)):
                args = (prep["pos_g"], x["srows"][pseudo], prep["near_flat"],
                        prep["near_tile_tgt"])
                kw = dict(softening=law, eps=eps)
                got = cuda_tree.near_pairs_direct(*args, **kw)
                hold("pairs_direct", got,
                     cuda_tree.near_pairs_direct_plain(*args, **kw),
                     tol if (f64 or softened(eps)) else None, law=law,
                     eps=eps, monopole_pseudo=pseudo, **what)
                if eps == SUBNORMAL_EPS and not f64 and not torch.equal(
                        got, cuda_tree.near_pairs_direct(
                            *args, softening=law, eps=0.0)):
                    fail("pairs_direct at a subnormal float32 eps^2 is not "
                         f"its eps = 0 result: {what}")
            args = (prep["pos_g"], x["neg"], prep["nearq_flat"],
                    prep["nearq_tile_tgt"])
            hold("pairs_quad", cuda_tree.near_pairs_quad(*args, eps=1e-2),
                 cuda_tree.near_pairs_quad_plain(*args, eps=1e-2), tol,
                 **what)
            sync(dev)
    # The 3-level far field's kernels on the port's own far3 prep: 256
    # clusters of 15 (4 supers of 64, 32 MIDs). M1's source rows hold
    # interior nulls (the near mids cut out of the near supers' mids), and
    # the 64 clusters of a super share its strips through tile_src.
    n3, gg3 = 3833, 256
    for dtype in (torch.float32, torch.float64):
        tol = 1e-9 if dtype == torch.float64 else 2e-5
        pos, mass = far3_bodies(n3, seed=0, dtype=dtype, dev=dev)
        prep = tree_ops.tree_prep(pos, mass, theta=theta, k_near=64, gg=gg3,
                                  leaf=15, far_levels=3, near_mode="pairs")
        x = far3_inputs(prep)
        ids = m1_source_rows(prep, theta)
        holes = int(((ids[:, :-1] == gg3 // tree_ops.MID)
                     & (ids[:, 1:] < gg3 // tree_ops.MID)).any(1).sum())
        what = dict(dtype=str(dtype)[6:], n=n3, leaf=15, clusters=gg3,
                    supers=gg3 // tree_ops.SUPER,
                    m1_rows_with_interior_nulls=holes)
        if holes == 0:
            fail(f"the far3 case has no M1 row with interior nulls: {what}")
        args = (x["targets"], x["supers"], prep["idx2"])
        hold("quad_masked", cuda_tree.acc_cross_quad_masked(*args, eps=1e-2),
             cuda_tree.acc_cross_quad_masked_plain(*args, eps=1e-2), tol,
             **what)
        for m in ("m1", "m2"):
            args = (prep["pos_g"], x[m], prep[f"{m}_flat"], prep[f"{m}_tgt"],
                    prep[f"{m}_src"])
            live = int(prep[f"{m}_ntiles"])
            shared = live - int(torch.unique(prep[f"{m}_src"][:live]).numel())
            if shared <= 0:
                fail(f"{m}: no pair tile shares a source strip: {what}")
            kw = dict(eps=1e-2)
            hold("pairs_quad_shared",
                 cuda_tree.near_pairs_quad_shared(*args, **kw),
                 cuda_tree.near_pairs_quad_shared_plain(*args, **kw), tol,
                 **what, list=m, tiles=live, tiles_sharing_a_strip=shared)
        sync(dev)
    # pairs_quad_shared on a list whose block partners do not share their
    # tiles, at an odd G (`pair_hold.unpaired_shared_case`): at leaf 15 a
    # tile takes four passes of the block's 32 threads, at leaf 255 one;
    # the cluster with no tiles must get exactly 0
    pair_hold = load_tests_module("pair_hold")
    for leaf in (15, 255):
        for dtype in (torch.float32, torch.float64):
            case = pair_hold.unpaired_shared_case(dtype, dev, leaf)
            got = cuda_tree.near_pairs_quad_shared(*case["args"],
                                                   **case["kw"])
            hold("pairs_quad_shared", got,
                 cuda_tree.near_pairs_quad_shared_plain(*case["args"],
                                                        **case["kw"]),
                 1e-9 if dtype == torch.float64 else 2e-5,
                 dtype=str(dtype)[6:], leaf=leaf, list="unpaired",
                 clusters=len(pair_hold.UNPAIRED_TILES))
            if float(got.reshape(-1, leaf, 3)[4].abs().max()) != 0.0:
                fail("pairs_quad_shared gave a cluster with no tiles a "
                     "nonzero force")
    worst = {}
    for row in rows:
        if row["tol"] is not None:
            worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0),
                                       row["max_rel_err"])
    emit({"phase": "tree_kernels", "cases": rows, "worst_rel_err": worst})


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
        bound = (mxu_bound(float(n) * n, card)["bound_ms"]
                 if method == "mxu" else
                 1e3 * FLOPS_PER_PAIR[name] * n * n / PEAK_F32_FLOPS)
        row.update(kernel_ms=kernel_ms, bound_ms=bound,
                   nvidia_smi=card["smi"])
    emit(row)
    if not err <= 1e-3:
        fail(f"main path force off the float64 plain force by {err} "
             "of max|a| (want <= 1e-3)")
    return launches[name], state


def phase_main_path(dev, rehearsal, card):
    from spacetpu_torch.models import presets

    n = 2048 if rehearsal else 262_144
    scene = presets.random_cluster(n, seed=0, g=1.0)
    return scene, {f"direct_{m}": run_main_path(scene, m, dev, rehearsal,
                                                card)[0]
                   for m in ("vpu", "mxu")}


def _launch_counters():
    from spacetpu_torch.ops import cuda_direct, cuda_tree, energy
    from spacetpu_torch.render import cuda_splat

    return (cuda_direct.LAUNCHES, cuda_tree.LAUNCHES, cuda_splat.LAUNCHES,
            energy.LAUNCHES, energy.KERNEL_LAUNCHES)


def reset_launches():
    for counts in _launch_counters():
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    return {k: v for counts in _launch_counters() for k, v in counts.items()}


def strip_inputs(prep, g=1.0):
    """What the strip kernels take, from a strip-mode prep: near_strip's
    arguments (the pool is every cluster), quad_strip's and, with three
    far-field levels, quad_refine's (the refinement strips)."""
    from spacetpu_torch.ops import tree as tree_ops

    pool = (prep["pos_g"], prep["mass_g"], prep["com"], prep["m_tot"])
    gg = prep["pos_g"].shape[0]
    summ = tree_ops._cluster_summaries(*pool, g)
    out = {"near": (prep["pos_g"], prep["idx"], *pool),
           "quad": (prep["pos_g"], tree_ops._negated(summ), prep["idx"])}
    if gg % tree_ops.SUPER == 0 and prep["idx2"].shape[0] == (
            gg // tree_ops.SUPER):
        out["refine"] = (prep["pos_g"], tree_ops._superfar_refine_table(
            summ[:, :gg], None, prep["idx2"]))
    return out


def strip_calls(prep, g, eps, softening="plummer", pseudo=False) -> dict:
    """The strip kernels' wrappers and plain versions on a strip prep, as
    {name: (run, plain)}."""
    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops

    x = strip_inputs(prep, g)
    nkw = dict(softening=softening, eps=eps, g=g, monopole_pseudo=pseudo)
    calls = {
        "near_strip": (
            lambda: cuda_tree.near_strip(*x["near"], **nkw),
            lambda: cuda_tree.near_strip_plain(*x["near"], **nkw)),
        "quad_strip": (
            lambda: cuda_tree.quad_strip(*x["quad"], eps=eps),
            lambda: cuda_tree.quad_strip_plain(*x["quad"], eps=eps))}
    if "refine" in x:
        rkw = dict(eps=eps, group=tree_ops.SUPER)
        calls["quad_refine"] = (
            lambda: cuda_tree.quad_refine(*x["refine"], **rkw),
            lambda: cuda_tree.quad_refine_plain(*x["refine"], **rkw))
    return calls


def path_kernel_ms(prep, g, eps, names) -> dict:
    """CUDA-event ms of one call of each named tree kernel at the shapes of
    a path's final prep (pairs_quad_shared: its two launches of a force
    pass, M1 and M2, together): where a force pass's time goes."""
    from spacetpu_torch.ops import cuda_tree

    if "near_strip" in names:
        calls = {k: v[0] for k, v in strip_calls(prep, g, eps).items()}
        if "quad_dense" in names:
            x = tree_inputs(prep, g)
            calls["quad_dense"] = lambda: cuda_tree.acc_cross_quad(
                x["targets"], x["summaries"], eps=eps)
        if "quad_masked" in names:
            y = far3_inputs(prep, g)
            calls["quad_masked"] = lambda: cuda_tree.acc_cross_quad_masked(
                y["targets"], y["supers"], prep["idx2"], eps=eps)
        return {k: cuda_ms(calls[k], 3) for k in names}
    x = tree_inputs(prep, g)
    calls = {
        "quad_dense": lambda: cuda_tree.acc_cross_quad(
            x["targets"], x["summaries"], eps=eps),
        "pairs_direct": lambda: cuda_tree.near_pairs_direct(
            prep["pos_g"], x["srows"][False], prep["near_flat"],
            prep["near_tile_tgt"], softening="plummer", eps=eps),
        "pairs_quad": lambda: cuda_tree.near_pairs_quad(
            prep["pos_g"], x["neg"], prep["nearq_flat"],
            prep["nearq_tile_tgt"], eps=eps),
        "pairs_hybrid": lambda: cuda_tree.near_pairs_hybrid(
            prep["pos_g"], x["srows"][False], prep["near_flat"],
            prep["near_tile_tgt"], softening="plummer", eps=eps)}
    if "m1_flat" in prep:
        y = far3_inputs(prep, g)
        calls["quad_masked"] = lambda: cuda_tree.acc_cross_quad_masked(
            y["targets"], y["supers"], prep["idx2"], eps=eps)
        calls["pairs_quad_shared"] = lambda: [
            cuda_tree.near_pairs_quad_shared(
                prep["pos_g"], y[m], prep[f"{m}_flat"], prep[f"{m}_tgt"],
                prep[f"{m}_src"], eps=eps)
            for m in ("m1", "m2")]
    return {k: cuda_ms(calls[k], 3) for k in names}


def drive_tree(phase, scene, dev, rehearsal, card, *, sim_kw, steps,
               per_pass, far_levels, cluster_mode, count_ops=False):
    """The tree at full size through the port's entry points: prime (which
    calibrates), a warm-up step and `steps` timed steps, each force pass
    launching the kernels of `per_pass`; then the caps, the live tile
    counts, the overflow (must be 0), prep and eval times, and the force
    error on 4096 sampled targets against the direct kernel over all
    sources (median must be <= 1e-3). On the card the calibration must
    resolve to `far_levels` and `cluster_mode`. Returns the final state's
    prep (the shapes the kernels line times), the scene's g and the
    launches of the run."""
    import spacetpu_torch as st
    from spacetpu_torch.ops import cuda_direct
    from spacetpu_torch.ops import tree as tree_ops

    n = scene.n
    state = scene.state(dtype=torch.float32, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = st.make_simulation(n, g=scene.g, device=dev, **sim_kw)
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = sim.prime(state)
        sync(dev)
        prime_s = time.perf_counter() - t0
        state = sim.step(state, DT)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state = sim.step(state, DT)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else None)
    passes = steps + 2
    if rehearsal:
        if any(launches.values()):
            fail(f"the rehearsal launched a kernel: {launches}")
    else:
        for name, k in per_pass.items():
            if launches[name] != k * passes:
                fail(f"{name} launched {launches[name]} times on {phase}, "
                     f"want {k * passes} ({k} a force pass, prime + "
                     f"{steps + 1} steps)")
    for field in ("pos", "vel", "acc"):
        if not bool(torch.isfinite(getattr(state, field)).all()):
            fail(f"non-finite state.{field} after {phase}")
    health = sim.health(state)
    caps = sim.caps
    params = sim._tree_params()
    prep_kw = sim._prep_kw()
    eval_kw = dict(softening="plummer", eps=sim_kw["eps"], g=scene.g,
                   backend="cuda", multipole_order=2,
                   far_levels=params["far_levels"], near_mode=params["nmode"],
                   pairs_accum=sim_kw.get("pallas_method", "vpu"))
    prep = tree_ops.tree_prep(state.pos, state.mass, **prep_kw)
    idx = torch.as_tensor(np.random.default_rng(0).choice(
        n, size=min(4096, n), replace=False), device=dev)
    a_ref = cuda_direct.acc_cross_kernel(
        state.pos[idx], state.pos, state.mass, softening="plummer",
        eps=sim_kw["eps"], g=scene.g)
    rel = (torch.linalg.norm(state.acc[idx] - a_ref, dim=1)
           / torch.linalg.norm(a_ref, dim=1)).double()
    row = {"phase": phase, "n": n, "steps": steps, "leaf": params["leaf"],
           "far_levels": params["far_levels"],
           "cluster_mode": params["cmode"], "near_mode": params["nmode"],
           "clusters": params["gg"], "prime_s": prime_s,
           "ms_per_step": 1e3 * wall / steps, "peak_gb": peak_gb,
           "caps": caps, "degenerate": sim.degenerate, "health": health,
           **{k: int(prep[k]) for k in ("near_ntiles", "nearq_ntiles",
                                        "m1_ntiles", "m2_ntiles")
              if k in prep},
           "launches": launches,
           "launches_per_pass": {k: launches[k] / passes
                                 for k in TREE_KERNELS},
           "force_rel_err_median": float(rel.median()),
           "force_rel_err_p99": float(torch.quantile(rel, 0.99)),
           "warnings": [str(w.message) for w in caught]}
    if not rehearsal:
        row.update(
            prep_ms=cuda_ms(lambda: tree_ops.tree_prep(
                state.pos, state.mass, **prep_kw), 3),
            eval_ms=cuda_ms(lambda: tree_ops.tree_eval(
                prep, 0, prep_kw["gg"], **eval_kw), 3),
            kernel_ms=path_kernel_ms(prep, scene.g, sim_kw["eps"],
                                     [k for k, v in per_pass.items() if v]),
            nvidia_smi=card["smi"])
        if count_ops:
            row["ops"] = {
                "tree_prep": device_ops(lambda: tree_ops.tree_prep(
                    state.pos, state.mass, **prep_kw)),
                "tree_eval": device_ops(lambda: tree_ops.tree_eval(
                    prep, 0, prep_kw["gg"], **eval_kw)),
                "step": device_ops(lambda: sim.step(state, DT))}
    emit(row)
    RESULTS[phase] = row
    if not rehearsal and (params["far_levels"], params["cmode"]) != (
            far_levels, cluster_mode):
        fail(f"{phase} resolved to far_levels={params['far_levels']}, "
             f"cluster_mode={params['cmode']!r}; want {far_levels}, "
             f"{cluster_mode!r}")
    if far_levels == 3 and params["nmode"] == "pairs" and None in (
            caps["k_mid"], caps["m1_src_tiles"], caps["m2_src_tiles"]):
        fail(f"{phase}: the MID far field's caps were not measured: {caps}")
    if health["near_overflow"] != 0:
        fail(f"near_overflow={health['near_overflow']} on {phase}")
    if not row["force_rel_err_median"] <= 1e-3:
        fail(f"{phase} force off the direct kernel's by a median of "
             f"{row['force_rel_err_median']} (want <= 1e-3)")
    return prep, scene.g, launches


def phase_tree_path(dev, rehearsal, card, count_ops=False):
    """fixed_cloud(1M): two far-field levels (3922 clusters), the equal
    partition. The rehearsal has no kernels: backend="cuda" on CPU tensors
    walks the same pair-list path through the plain versions, at a small
    leaf."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 1_000_000)
    extra = dict(backend="cuda", leaf=31) if rehearsal else {}
    return drive_tree("tree_path", scene, dev, rehearsal, card,
                      sim_kw=dict(TREE, **extra), steps=5, per_pass=FAR2_PASS,
                      far_levels=2, cluster_mode="equal",
                      count_ops=count_ops)


def phase_far3_path(dev, rehearsal, card, count_ops=False):
    """fixed_cloud(4M) with every default but the tree_path settings:
    "auto" picks three far-field levels at 15,744 clusters."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 4_000_000)
    extra = (dict(backend="cuda", leaf=15, far_levels=3) if rehearsal
             else {})
    return drive_tree("far3_path", scene, dev, rehearsal, card,
                      sim_kw=dict(TREE, **extra), steps=5, per_pass=FAR3_PASS,
                      far_levels=3, cluster_mode="equal",
                      count_ops=count_ops)


def phase_plummer_path(dev, rehearsal, card, count_ops=False):
    """plummer_sphere(1M), plummer eps=1e-2, cluster_mode and far_levels
    left at "auto": the calibration measures the adaptive partition, takes
    it, and its cluster count picks three levels."""
    from spacetpu_torch.models import presets

    scene = presets.plummer_sphere(3000 if rehearsal else 1_000_000)
    extra = (dict(backend="cuda", leaf=15, far_levels=3) if rehearsal
             else {})
    return drive_tree("plummer_path", scene, dev, rehearsal, card,
                      sim_kw=dict(TREE, eps=1e-2, **extra), steps=3,
                      per_pass=FAR3_PASS, far_levels=3,
                      cluster_mode="adaptive", count_ops=count_ops)


def phase_strip_kernels(dev, rehearsal):
    """near_strip, quad_strip and quad_refine against their plain versions
    on strip-mode preps built by the port's tree_prep: float64 within 1e-9
    of max|a|; float32 target by target within `pair_hold.F32_TOL` of the
    size of what float32 rounds, against the float64 sums
    (tests/pair_hold.py), where deliberately wrong versions must fail the
    same limit. near_strip and quad_strip: N=4099 (leaf 31, ragged) and
    N=65536 (leaf 255) with the geometric k_near, so rows end in null
    slots; the last target cluster's list emptied; both laws (plummer with
    massless pseudo-bodies as at order 2 and unsoftened with -g M ones;
    ref with -g M as at order 1); and K = 0. quad_refine: the far3 strip
    prep of 15,353 bodies at leaf 15 (1,024 clusters, 16 supers, strips of
    1,024 columns: two 512-column tiles) with null columns; and on one
    column a super, exact negatives of quad_strip's terms of the negated
    column (`pair_hold.one_column_terms`: both kernels take the one
    quad_term, two targets a thread or one, every term bit for bit)."""
    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops
    pair_hold = load_tests_module("pair_hold")

    sizes = ((600, 15),) if rehearsal else ((4099, 31), (65_536, 255))
    theta, rows = 0.5, []

    def check(row):
        rows.append(row)
        if not row["ok"]:
            emit({"phase": "strip_kernels", "cases": rows})
            fail(f"strip kernel disagrees with its plain version: {row}")

    def held(name, got, want, exact, args, kw, what, pick=None):
        """float64: got against the plain version; float32: the hold and
        the wrong versions."""
        row = {"kernel": name, "dtype": str(got.dtype)[6:],
               "finite": bool(torch.isfinite(got).all()), **what}
        if got.dtype == torch.float64:
            err = float((got - want).abs().max())
            row.update(max_abs_err=err,
                       max_rel_err=err / (float(want.abs().max()) or 1.0),
                       tol=1e-9)
            row["ok"] = row["finite"] and row["max_rel_err"] <= 1e-9
        else:
            row.update(pair_hold.hold(got.reshape(exact.shape[:-1] + (3,)),
                                      exact))
            row["mutants"] = pair_hold.strip_mutant_ratios(name, args, kw,
                                                           exact, pick)
            row["ok"] = row["ok"] and row["finite"] and all(
                r > row["hold_tol"] for r in row["mutants"].values())
        check(row)

    for n, leaf in sizes:
        pos, mass = bodies(n, seed=n, dtype=torch.float64, dev=dev)
        gg = -(-n // leaf)
        prep = tree_ops.tree_prep(
            pos, mass, theta=theta, gg=gg, leaf=leaf, near_mode="strip",
            k_near=tree_ops.default_k_near(theta, gg))
        idx = prep["idx"].clone()
        idx[-1] = gg  # an empty near list
        nulls = int((idx == gg).sum())
        if nulls == idx.shape[1]:
            fail(f"strip_kernels: no null slot but the emptied row at n={n}")
        what = dict(n=n, leaf=leaf, clusters=gg, k=idx.shape[1],
                    null_slots=nulls)
        for dtype in (torch.float32, torch.float64):
            pool = [prep[k].to(dtype) for k in ("pos_g", "mass_g", "com",
                                                 "m_tot")]
            for law, eps, pseudo in (("plummer", 1e-2, False),
                                     ("plummer", 0.0, True),
                                     ("ref", 1e-2, True)):
                kw = dict(softening=law, eps=eps, g=1.0,
                          monopole_pseudo=pseudo)
                args = (pool[0], idx, *pool)
                got = cuda_tree.near_strip(*args, **kw)
                exact = (pair_hold.strip_exact_sums(args, kw)
                         if dtype == torch.float32 else None)
                want = (cuda_tree.near_strip_plain(*args, **kw)
                        if dtype == torch.float64 else None)
                held("near_strip", got, want, exact, args, kw,
                     dict(what, law=law, eps=eps, monopole_pseudo=pseudo))
            none = cuda_tree.near_strip(pool[0], idx[:, :0], *pool, **kw)
            check({"kernel": "near_strip", "case": "k=0", **what,
                   "ok": bool((none == 0).all())})
            summ = tree_ops._cluster_summaries(*pool, 1.0)
            args = (pool[0], tree_ops._negated(summ), idx)
            got = cuda_tree.quad_strip(*args, eps=1e-2)
            exact = (pair_hold.quad_strip_exact_sums(*args, 1e-2)
                     if dtype == torch.float32 else None)
            want = (cuda_tree.quad_strip_plain(*args, eps=1e-2)
                    if dtype == torch.float64 else None)
            held("quad_strip", got, want, exact, args, dict(eps=1e-2), what)
            none = cuda_tree.quad_strip(*args[:2], idx[:, :0], eps=1e-2)
            check({"kernel": "quad_strip", "case": "k=0", **what,
                   "ok": bool((none == 0).all())})
        sync(dev)
    # quad_refine on the far3 strip prep
    n3, leaf3, gg3 = 15_353, 15, 1024
    pos, mass = far3_bodies(n3, seed=3, dtype=torch.float64, dev=dev)
    prep = tree_ops.tree_prep(pos, mass, theta=theta, k_near=64, gg=gg3,
                              leaf=leaf3, far_levels=3, near_mode="strip")
    for dtype in (torch.float32, torch.float64):
        pool = [prep[k].to(dtype) for k in ("pos_g", "mass_g", "com",
                                             "m_tot")]
        summ = tree_ops._cluster_summaries(*pool, 1.0)
        strips = tree_ops._superfar_refine_table(summ[:, :gg3], None,
                                                 prep["idx2"])
        g2 = gg3 // tree_ops.SUPER
        s_pad = strips.shape[1] // g2
        null_cols = int((strips[3:10] == 0).all(0).sum())
        what = dict(n=n3, leaf=leaf3, clusters=gg3, supers=g2, s_pad=s_pad,
                    null_columns=null_cols,
                    clusters_in_super_past_0=gg3 - g2)
        if s_pad < 1024 or null_cols == 0:
            fail(f"strip_kernels: the refine case needs two strip tiles "
                 f"and null columns: {what}")
        kw = dict(eps=1e-2, group=tree_ops.SUPER)
        args = (pool[0], strips)
        got = cuda_tree.quad_refine(*args, **kw)
        exact = (pair_hold.quad_refine_exact_sums(
            *args, 1e-2, tree_ops.SUPER, torch.arange(gg3, device=dev))
                 if dtype == torch.float32 else None)
        want = (cuda_tree.quad_refine_plain(*args, **kw)
                if dtype == torch.float64 else None)
        held("quad_refine", got, want, exact, args, kw, what)
        # the one quad_term in both kernels: on one column a super,
        # quad_refine gives quad_strip's terms of the negated column negated
        refine, strip = pair_hold.one_column_terms(pool[0], strips, 1e-2,
                                                   tree_ops.SUPER)
        same = bool(torch.equal(refine, -strip))
        live = int((refine != 0).any(1).sum())
        check({"kernel": "quad_refine", "case": "one column a super, "
               "against quad_strip on it negated", "dtype":
               str(dtype)[6:], "exact_negatives": same,
               "targets_with_a_term": live, "ok": same and live > 0})
    sync(dev)
    worst = {}
    for row in rows:
        key = row.get("hold_ratio", row.get("max_rel_err"))
        if key is not None:
            worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0), key)
    emit({"phase": "strip_kernels", "cases": rows,
          "worst_hold_ratio_or_rel_err": worst})


def strip_holds(prep, g, eps, names) -> dict:
    """The strip kernels at a path's final prep (float32) held target by
    target against the float64 sums (`pair_hold.hold`) on four target
    clusters: the one whose list is the longest (for quad_refine, the
    second member of the super whose strip has the most live columns), the
    first, and two seeded ones. The plain version over all clusters would
    take minutes."""
    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops
    pair_hold = load_tests_module("pair_hold")

    x = strip_inputs(prep, g)
    gg, leaf = prep["pos_g"].shape[:2]
    seeded = np.random.default_rng(0).choice(gg, size=2, replace=False)
    valid = (prep["idx"] < gg).sum(1)
    out = {}
    for name in names:
        if name == "quad_refine":
            pos_g, strips = x["refine"]
            g2 = gg // tree_ops.SUPER
            live = (strips[3:10] != 0).any(0).reshape(g2, -1).sum(1)
            first = int(live.argmax()) * tree_ops.SUPER + 1
        else:
            first = int(valid.argmax())
        sel = list(dict.fromkeys([first, 0, *map(int, seeded)]))
        ids = torch.as_tensor(sel, device=prep["pos_g"].device)
        if name == "near_strip":
            kw = dict(softening="plummer", eps=eps, g=g,
                      monopole_pseudo=False)
            got = cuda_tree.near_strip(*x["near"], **kw)[ids]
            a = x["near"]
            exact = pair_hold.strip_exact_sums((a[0][ids], a[1][ids],
                                                *a[2:]), kw)
        elif name == "quad_strip":
            pos_g, neg, idx = x["quad"]
            got = cuda_tree.quad_strip(pos_g, neg, idx, eps=eps).reshape(
                gg, leaf, 3)[ids]
            exact = pair_hold.quad_strip_exact_sums(pos_g[ids], neg,
                                                    idx[ids], eps)
        else:
            got = cuda_tree.quad_refine(
                pos_g, strips, eps=eps, group=tree_ops.SUPER).reshape(
                    gg, leaf, 3)[ids]
            exact = pair_hold.quad_refine_exact_sums(
                pos_g, strips, eps, tree_ops.SUPER, ids)
        row = pair_hold.hold(got, exact)
        row.update(clusters=sel, finite=bool(torch.isfinite(got).all()),
                   max_abs_err=float((got.double() - exact[..., :3])
                                     .abs().max()))
        if name != "quad_refine":
            row["list_lengths"] = [int(valid[c]) for c in sel]
        out[name] = row
        if not (row["ok"] and row["finite"]):
            fail(f"{name} off the float64 sums at its path's shapes: {row}")
    return out


def native_check(dev, rehearsal, card) -> dict:
    """The strip tree's float64 force on fixed_cloud(20000) (the path's
    settings) against the native oracle's direct sum
    (`spacetpu_torch.native`): the median and p99 of |a - a_direct| /
    |a_direct|; the median must stay within the tree's 1e-3."""
    import spacetpu_torch as st
    from spacetpu_torch import native
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(2000 if rehearsal else 20_000)
    state = scene.state(dtype=torch.float64, device=dev)
    extra = dict(backend="cuda", leaf=31) if rehearsal else {}
    sim = st.make_simulation(scene.n, g=scene.g, device=dev,
                             **dict(TREE, near_mode="strip", **extra))
    state = sim.prime(state)
    t0 = time.perf_counter()
    want = torch.as_tensor(native.acc_direct(
        state.pos, state.mass, g=scene.g, eps=TREE["eps"],
        softening="plummer"), device=dev)
    oracle_s = time.perf_counter() - t0
    rel = (torch.linalg.norm(state.acc - want, dim=1)
           / torch.linalg.norm(want, dim=1))
    out = {"n": scene.n, "dtype": "float64",
           "force_rel_err_median": float(rel.median()),
           "force_rel_err_p99": float(torch.quantile(rel, 0.99)),
           "native_s": oracle_s}
    if not out["force_rel_err_median"] <= 1e-3:
        fail(f"the strip tree off the native direct sum: {out}")
    return out


def padded_work(prep) -> dict:
    """The strip kernels' live pairs on a prep beside what the TPU's
    launch forms compute: near_strip's G K block^2 (every slot of every
    list, null clusters too, each a block x block tile) and quad_strip's G
    K_pad block (K padded to 128)."""
    gg, leaf = prep["pos_g"].shape[:2]
    k = prep["idx"].shape[1]
    valid = int((prep["idx"] < gg).sum())
    block = leaf + 1
    return {"k_near": k, "valid_entries": valid,
            "near_strip_live_pairs": float(valid) * leaf * block,
            "near_strip_tpu_pairs": float(gg) * k * block * block,
            "quad_strip_live_pairs": float(valid) * leaf,
            "quad_strip_tpu_pairs": float(gg) * (-(-k // 128) * 128) * block}


def phase_strip_path(dev, rehearsal, card, count_ops=False):
    """tree_path's configuration with near_mode="strip": fixed_cloud(1M),
    two far-field levels, the strip kernels in place of the pair lists;
    then the kernels held on four target clusters, the padded work, and the
    native oracle's check at N=20000."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 1_000_000)
    extra = dict(backend="cuda", leaf=31) if rehearsal else {}
    prep, g, launches = drive_tree(
        "strip_path", scene, dev, rehearsal, card,
        sim_kw=dict(TREE, near_mode="strip", **extra), steps=5,
        per_pass=STRIP2_PASS, far_levels=2, cluster_mode="equal",
        count_ops=count_ops)
    emit({"phase": "strip_path", "part": "holds",
          "holds": strip_holds(prep, g, TREE["eps"],
                               ("near_strip", "quad_strip")),
          "work": padded_work(prep),
          "native": native_check(dev, rehearsal, card),
          "nvidia_smi": card["smi"]})
    return prep, g, launches


def phase_far3_strip_path(dev, rehearsal, card, count_ops=False):
    """far3_path's scene (fixed_cloud(4M), 15,744 clusters, three far-field
    levels) with near_mode="strip": quad_masked, quad_refine, near_strip and
    quad_strip a force pass; three timed steps; the kernels held on four
    target clusters."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 4_000_000)
    extra = (dict(backend="cuda", leaf=15, far_levels=3) if rehearsal
             else {})
    prep, g, launches = drive_tree(
        "far3_strip_path", scene, dev, rehearsal, card,
        sim_kw=dict(TREE, near_mode="strip", **extra), steps=3,
        per_pass=STRIP3_PASS, far_levels=3, cluster_mode="equal",
        count_ops=count_ops)
    emit({"phase": "far3_strip_path", "part": "holds",
          "holds": strip_holds(prep, g, TREE["eps"],
                               ("near_strip", "quad_strip", "quad_refine")),
          "work": padded_work(prep), "nvidia_smi": card["smi"]})
    return prep, g, launches


@functools.cache
def load_tests_module(name: str):
    """tests/<name>.py (pair_hold: the float32 limit of the body kernels;
    splat_hold: the splat kernel's), which the card tests share, loaded by
    its path: an installed package may take the name `tests`."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module



def hold_body(name, got, want, args, kw, mutants=False) -> dict:
    """A body kernel's result against its plain version's on the same
    inputs: float64 within 1e-9 of max|a| (the same arithmetic in another
    order); float32, softened or not, target by target within
    `pair_hold.F32_TOL` of the size of what float32 rounds, against the
    float64 sum (tests/pair_hold.py), and where softened and not hybrid
    also within 2e-5 of max|a| (tests/test_pallas.py:26). Fails where the
    result is not finite. With `mutants` (float32), also the same measure
    of deliberately wrong versions (`pair_hold.mutant_ratios`), each of
    which must fail the limit."""
    pair_hold = load_tests_module("pair_hold")

    err = float((got - want).abs().max())
    row = {"finite": bool(torch.isfinite(got).all()), "max_abs_err": err,
           "max_rel_err": err / float(want.abs().max())}
    if got.dtype == torch.float64:
        row.update(tol=1e-9, ok=row["max_rel_err"] <= 1e-9)
    else:
        exact = pair_hold.exact_sums(name, args, kw)
        row.update(pair_hold.hold(got, exact))
        if kw["eps"] > 0.0 and not pair_hold.KERNELS[name][1]:
            row.update(tol=2e-5, ok=row["ok"] and row["max_rel_err"] <= 2e-5)
        if mutants:
            row["mutants"] = pair_hold.mutant_ratios(name, args, kw, exact)
            row["ok"] = row["ok"] and all(
                r > row["hold_tol"] for r in row["mutants"].values())
    row["ok"] = row["ok"] and row["finite"]
    return row


def short_walk_checks(name, got, args, kw, mutants, strict) -> dict:
    """The poly walk of `name` (pairs_short or pairs_short_hybrid) beyond the
    hold: a second call agrees bit for bit. With `mutants`, the walk's pair
    counts (`cuda_tree.short_pair_counts`: no pair inside r_cut skipped) and
    its skip moved inside r_cut (`pair_hold.near_pairs_short_cut_plain`),
    held target by target against the float64 sums (`pair_hold.hold`): in
    float32 the skip 25% inside must fail F32_TOL (1% inside is recorded:
    the pairs it drops keep under 7.8e-5 of their weight, below float32's
    rounding); in float64 the kernel must meet F64_TOL (1e-12 of the term
    size: only the order of the sums differs) and the skip 1% inside must
    fail it (`strict`: on the card's 65,536 bodies, where it drops such
    pairs)."""
    from spacetpu_torch.ops import cuda_tree
    pair_hold = load_tests_module("pair_hold")

    again = getattr(cuda_tree, f"near_{name}")(*args, **kw)
    out = {"repeat_bitwise": bool(torch.equal(got, again))}
    ok = out["repeat_bitwise"]
    if mutants:
        out["pairs"] = cuda_tree.short_pair_counts(*args, rcut=kw["rcut"])
        ok = ok and out["pairs"]["in_cutoff_skipped"] == 0
        exact = pair_hold.exact_sums(name, args, kw)
        out["skip_inside_ratio"] = {
            f"{round(100 * x)}pct": pair_hold.skip_inside_ratio(
                args, kw, exact, x, name) for x in (0.25, 0.01)}
        if got.dtype == torch.float32:
            ok = ok and out["skip_inside_ratio"]["25pct"] > pair_hold.F32_TOL
        else:
            out["f64_hold"] = pair_hold.hold(got, exact, pair_hold.F64_TOL)
            ok = ok and out["f64_hold"]["ok"] and (
                out["skip_inside_ratio"]["1pct"] > pair_hold.F64_TOL
                or not strict)
    out["walk_ok"] = ok
    return out


def phase_treepm_kernels(dev, rehearsal):
    """pairs_hybrid, pairs_short and pairs_short_hybrid against their plain
    versions on cutoff tile lists built by the port's treepm_prep: at
    N=4099 (leaf 31, ragged) every law, eps in {1e-2, 0} and both splits,
    float32 and float64; at N=65536 (leaf 255) the paths' own settings,
    where the float32 cases also show that the limit fails deliberately
    wrong versions; at N=1500 (leaf 15) the poly walk of pairs_short and
    pairs_short_hybrid where a chunk spans two clusters; the walk checks
    of both (`short_walk_checks`); and two pairs one ulp inside r_cut,
    each side of a chunk boundary, which both walks must evaluate
    (`pair_hold.edge_pair_case`). Tolerances: `hold_body`."""
    from spacetpu_torch.ops import cuda_tree
    pair_hold = load_tests_module("pair_hold")

    small, big = ((600, 15), (2000, 31)) if rehearsal else ((4099, 31),
                                                            (65_536, 255))
    rcut = 0.3
    rs = rcut / 4.5
    rows = []
    laws = [(law, eps) for law in ("plummer", "ref") for eps in (1e-2, 0.0)]
    # the sizes: every case at leaf 31, the paths' settings at leaf 255, and
    # the poly walks at leaf 15, where a chunk spans two clusters
    for (n, leaf), full in ((small, True), (big, False), ((1500, 15), None)):
        for dtype in (torch.float32, torch.float64):
            prep, srows = pair_hold.short_inputs(n, leaf, rcut, dtype, dev)
            what = dict(dtype=str(dtype)[6:], n=n, leaf=leaf,
                        tiles=int(prep["near_ntiles"]))
            if full is None:
                cases = [(k, law, eps, "poly")
                         for k in ("pairs_short", "pairs_short_hybrid")
                         for law, eps in laws]
            elif full:
                cases = ([("pairs_hybrid", law, eps, None)
                          for law, eps in laws]
                         + [(k, law, eps, split)
                            for k in ("pairs_short", "pairs_short_hybrid")
                            for law, eps in laws
                            for split in ("poly", "gauss")])
            else:
                cases = [("pairs_hybrid", "plummer", 1e-3, None),
                         ("pairs_short", "plummer", 0.0, "poly"),
                         ("pairs_short", "plummer", 1e-2, "gauss"),
                         ("pairs_short_hybrid", "plummer", 0.0, "poly")]
            for name, law, eps, split in cases:
                kw = dict(softening=law, eps=eps)
                if split:
                    kw.update(rs=rs, rcut=rcut, split=split)
                args = (prep["pos_g"], srows[split is None],
                        prep["near_flat"], prep["near_tile_tgt"])
                got = getattr(cuda_tree, f"near_{name}")(*args, **kw)
                want = getattr(cuda_tree, f"near_{name}_plain")(*args, **kw)
                sync(dev)
                row = {"kernel": name, "law": law, "eps": eps,
                       "split": split, **what,
                       **hold_body(name, got, want, args, kw,
                                   mutants=full is False)}
                if split == "poly":
                    row.update(short_walk_checks(
                        name, got, args, kw, mutants=full is False,
                        strict=not rehearsal))
                    row["ok"] = row["ok"] and row["walk_ok"]
                rows.append(row)
                if not row["ok"]:
                    emit({"phase": "treepm_kernels", "cases": rows})
                    fail(f"kernel disagrees with its plain version: {row}")
    # a pair one ulp inside r_cut on each side of a chunk boundary, each the
    # one term of its own target cluster: a weight of float32's rounding
    # (1 - G(y) at y = 1 - 2^-24), but not 0 unless the walk skips its chunk
    # (the hybrid form's centre is each target's own position: it gives
    # pairs_short's term bit for bit)
    edge = pair_hold.edge_pair_case(torch.float32, dev)
    terms = {}
    for name in ("pairs_short", "pairs_short_hybrid"):
        terms[name] = getattr(cuda_tree, f"near_{name}")(*edge["args"],
                                                         **edge["kw"])
        sync(dev)
        row = {"kernel": name, "case": "pairs one ulp inside r_cut",
               "dtype": "float32", **pair_hold.edge_pair_checks(terms[name])}
        if name == "pairs_short_hybrid":
            row["same_as_pairs_short"] = bool(torch.equal(
                terms[name], terms["pairs_short"]))
            row["ok"] = row["ok"] and row["same_as_pairs_short"]
        rows.append(row)
        if not row["ok"]:
            emit({"phase": "treepm_kernels", "cases": rows})
            fail(f"{name} skipped a pair inside r_cut: {row}")
    worst = {"float64_rel_err": {}, "float32_hold_ratio": {},
             "least_mutant_ratio": {}}
    for row in rows:
        for key, value, pick in (
                ("float64_rel_err", row["max_rel_err"]
                 if row["dtype"] == "float64" else None, max),
                ("float32_hold_ratio", row.get("hold_ratio"), max),
                ("least_mutant_ratio", min(row["mutants"].values())
                 if "mutants" in row else None, min)):
            if value is not None:
                got = worst[key].get(row["kernel"])
                worst[key][row["kernel"]] = (value if got is None
                                             else pick(got, value))
    emit({"phase": "treepm_kernels", "cases": rows, "hold_tol":
          pair_hold.F32_TOL, **worst})


def mesh_phase_ms(sim, state) -> dict:
    """CUDA-event ms of the pieces of one mesh force pass at the final
    state: TreePM's treepm_prep and short-range pass, and the PM pass as
    the CIC deposit, the Poisson solve (cuFFT forward, kernel product,
    inverse, window) and the gradient with the CIC gather."""
    from spacetpu_torch.ops import pm as pm_ops
    from spacetpu_torch.ops import treepm as treepm_ops

    mp, cfg = sim.mesh_params, sim.config
    pos, mass, grid = state.pos, state.mass, mp["grid"]
    box, inv_h = pm_ops._scalars(pos, sim.jit_consts["box_min"], mp["h"])
    mesh_c = pm_ops.deposit_cic_compact(pos, mass, box_min=box, inv_h=inv_h,
                                        grid=grid)
    phi_e = pm_ops.potential_ext(mesh_c, mp["kernel_hat"], grid)
    out = {
        "pm_deposit_ms": cuda_ms(lambda: pm_ops.deposit_cic_compact(
            pos, mass, box_min=box, inv_h=inv_h, grid=grid), 3),
        "pm_solve_ms": cuda_ms(lambda: pm_ops.potential_ext(
            mesh_c, mp["kernel_hat"], grid), 3),
        "pm_gather_ms": cuda_ms(lambda: pm_ops.acc_from_potential_ext(
            pos, phi_e, box_min=box, inv_h=inv_h, grid=grid), 3),
        "pm_ms": cuda_ms(lambda: pm_ops.acc_pm(
            pos, mass, kernel_hat=mp["kernel_hat"], box_min=box, h=mp["h"],
            grid=grid), 3)}
    if sim.algorithm == "treepm":
        kw = dict(rcut=mp["rcut"], k_near=sim.caps["k_near"],
                  gg=sim.caps["gg"], leaf=cfg.resolved_leaf(),
                  near_tiles=sim.caps["near_tiles"])
        prep = treepm_ops.treepm_prep(pos, mass, **kw)
        short_kw = dict(softening=cfg.softening, eps=cfg.resolved_eps(),
                        g=cfg.g, rs=mp["rs"], rcut=mp["rcut"],
                        split=mp["split"], backend="cuda",
                        accum=cfg.pallas_method)
        out.update(
            prep_ms=cuda_ms(lambda: treepm_ops.treepm_prep(pos, mass, **kw),
                            3),
            short_ms=cuda_ms(lambda: treepm_ops._short_eval(prep, **short_kw),
                             3))
    return out


def drive_mesh(phase, scene, dev, rehearsal, card, *, sim_kw, steps,
               per_pass, limits, count_ops=False):
    """A mesh family at full size through the port's entry points: prime
    (which calibrates), a warm-up step and `steps` timed steps, each force
    pass launching the kernels of `per_pass`; then the caps, the mesh, the
    health (out_of_box and near_overflow must be 0), the pieces of a force
    pass by CUDA events, the peak memory, and the force error on 4096
    sampled targets against the direct kernel over all sources (TreePM: at
    the scene's softening; PM: at the PM's own softening max(eps, h), as
    tests/test_pm.py holds it) within `limits`. Returns the final state's
    TreePM prep (None for PM), its source table and the launches."""
    import spacetpu_torch as st
    from spacetpu_torch.ops import cuda_direct
    from spacetpu_torch.ops import tree as tree_ops
    from spacetpu_torch.ops import treepm as treepm_ops

    n = scene.n
    state = scene.state(dtype=torch.float32, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = st.make_simulation(n, g=scene.g, device=dev, **sim_kw)
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        state = sim.prime(state)
        sync(dev)
        prime_s = time.perf_counter() - t0
        state = sim.step(state, DT)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state = sim.step(state, DT)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    passes = steps + 2
    if rehearsal:
        if any(launches.values()):
            fail(f"the rehearsal launched a kernel: {launches}")
    else:
        for name, k in per_pass.items():
            if launches[name] != k * passes:
                fail(f"{name} launched {launches[name]} times on {phase}, "
                     f"want {k * passes} ({k} a force pass, prime + "
                     f"{steps + 1} steps)")
    for field in ("pos", "vel", "acc"):
        if not bool(torch.isfinite(getattr(state, field)).all()):
            fail(f"non-finite state.{field} after {phase}")
    health = sim.health(state)
    mp = sim.mesh_params
    eps = sim.config.resolved_eps()
    eps_ref = max(eps, mp["h"]) if sim.algorithm == "pm" else eps
    idx = torch.as_tensor(np.random.default_rng(0).choice(
        n, size=min(4096, n), replace=False), device=dev)
    a_ref = cuda_direct.acc_cross_kernel(
        state.pos[idx], state.pos, state.mass, softening="plummer",
        eps=eps_ref, g=scene.g)
    rel = (torch.linalg.norm(state.acc[idx] - a_ref, dim=1)
           / torch.linalg.norm(a_ref, dim=1)).double()
    row = {"phase": phase, "n": n, "steps": steps,
           "algorithm": sim.algorithm,
           "pallas_method": sim.config.pallas_method,
           "grid": mp["grid"], "h": mp["h"], "rs": mp.get("rs"),
           "rcut": mp.get("rcut"), "split": mp.get("split"),
           "prime_s": prime_s, "ms_per_step": 1e3 * wall / steps,
           "caps": {k: v for k, v in sim.caps.items()
                    if k in ("k_near", "gg", "near_tiles")},
           "degenerate": sim.degenerate, "health": health,
           "launches": launches,
           "launches_per_pass": {k: launches[k] / passes
                                 for k in TREE_KERNELS},
           "peak_memory_gb": None if peak is None else peak / 1e9,
           "force_ref_eps": eps_ref,
           "force_rel_err_median": float(rel.median()),
           "force_rel_err_p99": float(torch.quantile(rel, 0.99)),
           "limits": limits,
           "warnings": [str(w.message) for w in caught]}
    prep = srows = None
    if sim.algorithm == "treepm":
        cfg = sim.config
        prep = treepm_ops.treepm_prep(
            state.pos, state.mass, rcut=mp["rcut"], k_near=sim.caps["k_near"],
            gg=sim.caps["gg"], leaf=cfg.resolved_leaf(),
            near_tiles=sim.caps["near_tiles"])
        srows = tree_ops._pack_augmented(prep["pos_g"], prep["mass_g"],
                                         prep["com"], prep["m_tot"],
                                         float(cfg.g), monopole_pseudo=False)
        row["near_ntiles"] = int(prep["near_ntiles"])
    if not rehearsal:
        row.update(mesh_phase_ms(sim, state), nvidia_smi=card["smi"])
        if count_ops:
            row["ops"] = {"step": device_ops(lambda: sim.step(state, DT))}
    emit(row)
    RESULTS[phase] = row
    if health.get("out_of_box") != 0:
        fail(f"out_of_box={health.get('out_of_box')} on {phase}")
    if health.get("near_overflow", 0) != 0:
        fail(f"near_overflow={health['near_overflow']} on {phase}")
    for q, lim in limits.items():
        if not row[f"force_rel_err_{q}"] <= lim:
            fail(f"{phase} force off the direct kernel's by a {q} of "
                 f"{row[f'force_rel_err_{q}']} (want <= {lim})")
    return prep, srows, launches, sim


def phase_treepm_path(dev, rehearsal, card, method="vpu", phase=None,
                      steps=5, count_ops=False):
    """fixed_cloud(1M), algorithm="treepm", every other default: pm_grid
    "auto" resolves to 256, the poly split, plummer eps 0, float32. The
    rehearsal runs fixed_cloud(3000) at leaf 15 through the plain versions
    (backend="cuda" on CPU tensors), on a 64^3 mesh: 2.3 cells a lattice
    spacing, where the full size has 2.6."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 1_000_000)
    # the rehearsal's mesh resolves its lattice as the full size's does
    extra = dict(backend="cuda", leaf=15, pm_grid=64) if rehearsal else {}
    return drive_mesh(
        phase or "treepm_path", scene, dev, rehearsal, card,
        sim_kw=dict(algorithm="treepm", pallas_method=method, **extra),
        steps=steps,
        per_pass=TREEPM_MXU_PASS if method == "mxu" else TREEPM_PASS,
        limits=TREEPM_ERR, count_ops=count_ops)


def phase_pm_path(dev, rehearsal, card, count_ops=False):
    """fixed_cloud(1M), algorithm="pm", every other default: pm_grid "auto"
    resolves to 128. No pair kernel: the pass is cuFFT and torch ops."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 1_000_000)
    drive_mesh("pm_path", scene, dev, rehearsal, card,
               sim_kw=dict(algorithm="pm"), steps=5, per_pass=PM_PASS,
               limits=PM_ERR, count_ops=count_ops)


def phase_mxu_paths(dev, rehearsal, card):
    """tree-1M (tree_path's configuration) and treepm-1M with
    pallas_method="mxu", three timed steps each: the hybrid sums in place
    of pairs_direct and pairs_short. Prints each one's ms a step and force
    error beside the "vpu" run of the same configuration."""
    from spacetpu_torch.models import presets

    scene = presets.fixed_cloud(3000 if rehearsal else 1_000_000)
    extra = dict(backend="cuda", leaf=31) if rehearsal else {}
    tree = drive_tree("mxu_paths/tree", scene, dev, rehearsal, card,
                      sim_kw=dict(TREE, pallas_method="mxu", **extra),
                      steps=3, per_pass=FAR2_MXU_PASS, far_levels=2,
                      cluster_mode="equal")
    treepm = phase_treepm_path(dev, rehearsal, card, method="mxu",
                               phase="mxu_paths/treepm", steps=3)
    keys = ("ms_per_step", "force_rel_err_median", "force_rel_err_p99")
    emit({"phase": "mxu_paths", **{
        name: {"mxu": {k: RESULTS[f"mxu_paths/{name}"][k] for k in keys},
               "vpu": {k: RESULTS[f"{name}_path"][k] for k in keys}}
        for name in ("tree", "treepm")}})
    return tree, treepm


def phase_default_workload(dev, rehearsal, count_ops=False):
    """The reference's default workload with every default of the port:
    "auto" picks the tree above 1000 bodies, theta 0.3, plummer eps 0,
    quadrupoles; the energy budget is the direct solver's (BASELINE.md:20)."""
    import spacetpu_torch as st
    from spacetpu_torch.constants import DELTA
    from spacetpu_torch.models import presets
    from spacetpu_torch.ops import energy

    scene = presets.fixed_cloud(1200 if rehearsal else 10_000)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = st.make_simulation(scene.n, device=dev)
        if sim.algorithm != "tree":
            fail(f"algorithm='auto' picked {sim.algorithm!r} at n={scene.n}")

        def e_of(s):
            return float(energy.total_energy(
                s.pos.double(), s.vel.double(), s.mass.double(),
                softening="plummer", eps=0.0))

        reset_launches()
        state = sim.prime(scene.state(dtype=torch.float32, device=dev))
        e0 = e_of(state)
        t0 = time.perf_counter()
        state = sim.run(state, DELTA, 100)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = read_launches()
    e1 = e_of(state)
    drift = abs(e1 - e0) / abs(e0)
    row = {"phase": "default_workload", "n": scene.n, "steps": 100,
           "dt": DELTA, "backend": sim.backend, "caps": sim.caps,
           "near_mode": sim.config.resolved_near_mode(sim.backend),
           "ms_per_step": 10.0 * wall, "launches": launches,
           "e0": e0, "e1": e1, "rel_drift": drift,
           "warnings": [str(w.message) for w in caught]}
    if count_ops and not rehearsal:
        row["ops"] = {"step": device_ops(lambda: sim.step(state, DELTA))}
    emit(row)
    if not rehearsal:
        for name, k in FAR2_PASS.items():
            if launches[name] != 101 * k:
                fail(f"{name} launched {launches[name]} times on the default "
                     f"workload, want {101 * k} (prime + 100 steps)")
    if not drift < 1e-4:
        fail(f"default workload energy drift {drift} >= 1e-4")


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


# --- the app, the engine and the renderer -----------------------------------


def source_entries(source):
    """The splat entries of a FrameSource's current frame, as its render
    passes them: (px, py, radius, rgbw, valid)."""
    from spacetpu_torch.render import fastsplat, trails

    dev = source.device
    return fastsplat.scene_entries(
        source.trails.history, trails.ages(source.trails), source.colors,
        source.radii, torch.as_tensor(source.camera.view(), device=dev),
        torch.as_tensor(source.camera.projection(), device=dev),
        width=source.width, height=source.height)


def splat_inputs(source):
    """(keys, pay1, pay2, n_tiles) of a FrameSource's current frame."""
    from spacetpu_torch.render import fastsplat

    keys, pay1, pay2 = fastsplat.prepare_entries(
        *source_entries(source), width=source.width, height=source.height)
    tx, ty = fastsplat.tiles_for(source.width, source.height)
    return keys, pay1, pay2, tx * ty


def hold_splat(case, keys, pay1, pay2, n_tiles, tiles=None) -> dict:
    """splat_tiles against its float64 plain version (tests/splat_hold.py),
    with the ratios of the four wrong versions. With `tiles`, the kernel's
    windows of those tiles only, against the plain version run over those
    tiles' entry ranges only."""
    from spacetpu_torch.render import cuda_splat, fastsplat

    sh = load_tests_module("splat_hold")
    got = cuda_splat.splat_tiles(keys, pay1, pay2, n_tiles=n_tiles)
    # no atomics: a second call gives the same bits
    same = torch.equal(got, cuda_splat.splat_tiles(keys, pay1, pay2,
                                                   n_tiles=n_tiles))
    if tiles is None:
        want = cuda_splat.splat_tiles_plain(keys, pay1, pay2,
                                            n_tiles=n_tiles,
                                            dtype=torch.float64)
        swapped = sh.swapped_windows(keys, pay1, pay2, n_tiles=n_tiles)
        entries = int((keys < n_tiles).sum())
    else:
        starts = fastsplat.tile_starts(keys, n_tiles).tolist()
        got = got[tiles]
        want, swapped, entries = [], [], 0
        for t in tiles:
            lo, hi = starts[t], starts[t + 1]
            args = (keys[lo:hi] - t, pay1[lo:hi], pay2[lo:hi])
            want.append(cuda_splat.splat_tiles_plain(
                *args, n_tiles=1, dtype=torch.float64))
            swapped.append(sh.swapped_windows(*args, n_tiles=1))
            entries += hi - lo
        want, swapped = torch.cat(want), torch.cat(swapped)
    row = {"case": case, "tiles": n_tiles if tiles is None else tiles,
           "entries": entries, **segments(keys, n_tiles),
           **sh.hold(got, want, swapped), "deterministic": same}
    if not (row["ok"] and same):
        fail(f"splat_tiles off its float64 plain version, or a wrong "
             f"version passed the limit: {row}")
    return row


def segments(keys, n_tiles) -> dict:
    """How splat_tiles cuts these entries: its live segments, the entries
    of the fullest, and the partial windows it merges."""
    from spacetpu_torch.render import cuda_splat, fastsplat

    table = cuda_splat.segment_table(fastsplat.tile_starts(keys, n_tiles),
                                     n_tiles, keys.shape[0])
    live = table["tile"] < n_tiles
    return {"segments": int(live.sum()),
            "fullest_segment_entries": int((table["hi"] - table["lo"]).max())
            if bool(live.any()) else 0,
            "partial_windows": int((table["slot"] >= 0).sum()),
            "seg": cuda_splat.SEG}


def app_frames(n, width, height, frames, dev):
    """The default app's FrameSource (`main`'s own pieces, engine not
    started) at `frames` successive frames: yields the source after each
    frame's render, the sim stepping once between frames."""
    from spacetpu_torch import main as app
    from spacetpu_torch.render.viewer import FrameSource

    cfg = app.parse_args(["--n", str(n), "--width", str(width), "--height",
                          str(height)])
    scene = app.build_scene(cfg)
    state, scene = app.resolve_state(cfg, scene, dev)
    engine = app.build_engine(cfg, scene, state)
    source = FrameSource(engine, scene, width=width, height=height)
    sim = engine.sim
    state = sim.prime(state)
    for k in range(frames):
        if k:
            state = sim.step(state, cfg.dt)
        source.render(state.pos.float().cpu().numpy())
        yield source


def phase_splat_kernels(dev, rehearsal, card):
    """splat_tiles against its float64 plain version on the cases of
    tests/test_fastsplat.py and on the default app's first and tenth
    frame."""
    from spacetpu_torch.render import cuda_splat

    sh = load_tests_module("splat_hold")
    seg = cuda_splat.SEG
    split = {"seg": seg, "seg+1": seg + 1, "5seg+3": 5 * seg + 3}
    cases = []
    for case, entries in (
            ("rand_3000", sh.rand_entries(3000, 256, 96)),
            ("hot_tile_5000", sh.hot_entries()),
            *((f"one_tile_{c}", sh.hot_entries(split.get(c, c)))
              for c in SPLAT_SPLIT_COUNTS)):
        cases.append(hold_splat(case, *sh.sorted_entries(entries, 256, 96,
                                                          dev)))
    n = 1200 if rehearsal else 10_000
    for k, source in enumerate(app_frames(n, 960, 540, 10, dev)):
        if k in (0, 9):
            cases.append(hold_splat(f"default_app_frame_{k + 1}",
                                    *splat_inputs(source)))
    emit({"phase": "splat_kernels", "tol": sh.F32_TOL,
          "worst_hold_ratio": max(c["hold_ratio"] for c in cases),
          "cases": cases, "nvidia_smi": card["smi"]})


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG as `termgfx.encode_png` writes it (one IDAT
    stream, filter 0 on every row)."""
    import struct
    import zlib

    data = open(path, "rb").read()
    w, h = struct.unpack(">II", data[16:24])
    at, idat = 8, b""
    while at < len(data):
        size = struct.unpack(">I", data[at:at + 4])[0]
        if data[at + 4:at + 8] == b"IDAT":
            idat += data[at + 8:at + 8 + size]
        at += size + 12
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        fail(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def run_app(argv, out_dir, dev, rehearsal):
    """`spacetpu_torch.main.main(argv)` with --out-dir, the launch counts set
    to 0 just before and read just after; returns (source, launches,
    wall seconds, the peak of the memory the run allocated on the card in
    GB (above what earlier phases still hold) or None, the frames read back
    from the written PNGs)."""
    from spacetpu_torch import main as app

    if rehearsal:
        argv = argv + ["--platform", "cpu"]
    held = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    reset_launches()
    t0 = time.perf_counter()
    source = app.main(argv + ["--out-dir", out_dir])
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = ((torch.cuda.max_memory_allocated(dev) - held) / 1e9
            if dev.type == "cuda" else None)
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    frames = [read_png(os.path.join(out_dir, f)) for f in pngs]
    return source, launches, wall, peak, frames


def viewer_rates(viewer) -> dict:
    """frames/s and ticks/s over the frames after the first (which waits
    for the engine's prime), PNG ms and frame ms."""
    frame_s = np.asarray(viewer.frame_seconds)
    png_s = np.asarray(viewer.png_seconds)
    loop = float((frame_s[1:] + png_s[1:]).sum())
    return {"frames": len(frame_s), "first_frame_s": float(frame_s[0]),
            "frames_per_s": (len(frame_s) - 1) / loop if loop else None,
            "ticks_per_s": ((viewer.ticks[-1] - viewer.ticks[0]) / loop
                            if loop else None),
            "ticks": viewer.ticks[-1],
            "frame_ms_median": 1e3 * float(np.median(frame_s[1:]))
            if len(frame_s) > 1 else None,
            "png_ms_median": 1e3 * float(np.median(png_s))}


def lit(frames) -> dict:
    return {"max": int(max(int(f.max()) for f in frames)),
            "lit_share_min": float(min((f.max(axis=-1) > 0).mean()
                                       for f in frames))}


def render_pieces_ms(source, reps=3) -> dict:
    """ms of each piece of one frame's render at the source's current state,
    by CUDA events: the projection and entries, pack_entries, the sort (pad,
    stable sort, gather), splat_tiles (with its tile starts), overlap_add
    (with the exposure), to_u8 and its readback."""
    from spacetpu_torch.engine import Readback
    from spacetpu_torch.render import cuda_splat, fastsplat, rasterizer

    w, h = source.width, source.height
    tx, ty = fastsplat.tiles_for(w, h)
    exposure = min(1.0, 5000.0 / max(source.scene.n, 1))
    names = ("entries", "pack", "sort", "splat_tiles", "overlap_add",
             "to_u8_readback")
    totals = dict.fromkeys(names, 0.0)
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        ev[0].record()
        px, py, rad, rgbw, valid = source_entries(source)
        ev[1].record()
        packed = fastsplat.pack_entries(
            px, py, torch.clamp(rad, fastsplat.MIN_RADIUS,
                                fastsplat.MAX_RADIUS), rgbw, valid,
            width=w, height=h)
        ev[2].record()
        keys, pay1, pay2 = fastsplat.sort_entries(
            *fastsplat.pad_entries(*packed, tx * ty))
        ev[3].record()
        windows = cuda_splat.splat_tiles(keys, pay1, pay2, n_tiles=tx * ty)
        ev[4].record()
        frame = torch.clamp(fastsplat.overlap_add(windows, width=w, height=h)
                            * exposure, 0.0, 1.0)
        ev[5].record()
        rb = Readback(rasterizer.to_u8_device(frame))
        ev[6].record()
        rb.wait()
        ev[6].synchronize()
        if _:
            for i, name in enumerate(names):
                totals[name] += ev[i].elapsed_time(ev[i + 1]) / reps
    totals["total"] = sum(totals.values())
    return totals, (keys, pay1, pay2, tx * ty)


def splat_bound(keys, pay1, pay2, n_tiles) -> dict:
    """The least time of splat_tiles on these inputs, counted two ways.
    By what the inputs need: each live entry's nonzero footprint,
    ceil(2r) columns by 3 ceil(2r) rows at 2 flops, over the float32 rate,
    against the bytes (the three int32 arrays read once, the windows written
    once) over the memory rate; and the dense contraction the TPU kernel
    computes, M x 96 x 256 x 2 flops."""
    live = keys < n_tiles
    # r = qr / 4 px (qr: the 6-bit radius field), ceil(2r) = ceil(qr / 2)
    span = ((pay1[live] & 63).double() / 2.0).ceil()
    flops = float((2.0 * 3.0 * span * span).sum())
    nbytes = 3 * 4 * keys.numel() + n_tiles * 96 * 256 * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    m = int(live.sum())
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "footprint_flops": flops, "bytes": nbytes,
            "dense_bound_ms": 1e3 * m * 96 * 256 * 2 / PEAK_F32_FLOPS,
            "live_entries": m}


def phase_app_path(dev, rehearsal, card):
    """`python -m spacetpu_torch` on fixed_cloud(1000000) at 1920x1080, 30
    offline frames, every other flag at its default: the solver the auto
    tier picks (PM), frames/s and ticks/s, the render's pieces by CUDA
    events, PNG ms, entries a frame, the fullest tile, peak memory, one
    splat_tiles launch a frame, frames not blank; then splat_tiles held on
    the last frame's 3 fullest tiles and 3 tiles chosen by seed."""
    import tempfile

    argv = APP_ARGS
    if rehearsal:
        argv = ["--preset", "fixed_cloud", "--n", "3000", "--frontend",
                "offline", "--frames", "3", "--width", "480", "--height",
                "270"]
    with tempfile.TemporaryDirectory() as tmp:
        source, launches, wall, peak, frames = run_app(argv, tmp, dev,
                                                       rehearsal)
    sim = source.engine.sim
    n_frames = len(frames)
    row = {"phase": "app_path", "argv": argv, "wall_s": wall,
           "solver": sim.config.resolved_algorithm(),
           "grid": (sim.mesh_params or {}).get("grid"),
           **viewer_rates(source.viewer), "launches": launches,
           "peak_memory_gb": peak, **lit(frames), "nvidia_smi": card["smi"]}
    if rehearsal:
        emit(row)
        return None
    pieces, (keys, pay1, pay2, n_tiles) = render_pieces_ms(source)
    counts = torch.bincount(keys[keys < n_tiles].long(), minlength=n_tiles)
    row.update(render_ms=pieces,
               entries_per_frame=int(source_entries(source)[0].numel()),
               splat_entries_live=int(counts.sum()),
        largest_tile_entries=int(counts.max()), tiles=n_tiles)
    fullest = torch.topk(counts, 3).indices.tolist()
    rng = np.random.default_rng(0)
    chosen = sorted(set(fullest) | set(rng.choice(
        [t for t in range(n_tiles) if t not in fullest], 3,
        replace=False).tolist()))
    held = hold_splat("app_1M_frame_30", keys, pay1, pay2, n_tiles,
                      tiles=chosen)
    row["hold"] = held
    row["splat_segments"] = segments(keys, n_tiles)
    emit(row)
    if row["solver"] != "pm":
        fail(f"the auto tier picked {row['solver']!r} at N=1M, want 'pm'")
    if launches["splat_tiles"] != n_frames:
        fail(f"splat_tiles launched {launches['splat_tiles']} times in "
             f"{n_frames} frames, want one a frame")
    if not (row["max"] > 0 and row["lit_share_min"] > 0.01):
        fail(f"blank frames on the app path: {lit(frames)}")
    return {"launches": launches, "inputs": (keys, pay1, pay2, n_tiles),
            "hold": held}


def phase_default_app(dev, rehearsal, card):
    """`main` at every default (fixed_cloud(10000), 960x540, the tree tier)
    for 60 offline frames, and a 3-body preset whose blend="auto" takes
    render_ordered."""
    import tempfile

    rows = []
    for name, argv, frames in (
            ("default", [], 3 if rehearsal else 60),
            ("earth_sun_mars", ["--preset", "earth_sun_mars"], 10)):
        if rehearsal and not argv:
            argv = ["--n", "1200"]
        with tempfile.TemporaryDirectory() as tmp:
            source, launches, wall, _, pngs = run_app(
                argv + ["--frontend", "offline", "--frames", str(frames)],
                tmp, dev, rehearsal)
        rows.append({"case": name, "solver": source.engine.algorithm,
                     "blend": source.blend, "wall_s": wall,
                     **viewer_rates(source.viewer),
                     "splat_launches": launches["splat_tiles"],
                     **lit(pngs)})
        if rehearsal:
            continue
        want = frames if source.blend == "additive" else 0
        if launches["splat_tiles"] != want:
            fail(f"{name}: splat_tiles launched {launches['splat_tiles']} "
                 f"times in {frames} frames, want {want}")
        if not rows[-1]["max"] > 0:
            fail(f"{name}: blank frames")
    emit({"phase": "default_app", "runs": rows, "nvidia_smi": card["smi"]})
    if not rehearsal and (rows[0]["solver"], rows[0]["blend"],
                          rows[1]["blend"]) != ("tree", "additive",
                                                "ordered"):
        fail(f"default app: want the tree, additive frames and an ordered "
             f"3-body scene, got {rows}")


def phase_headless_path(dev, rehearsal, card, dump=None):
    """`main` with --frontend none at N=1000000, 20 steps, which prints its
    rate, the tree's health and the energy drift; the seconds of its two
    energy sums (each one pair_potential launch on the card). With `dump`,
    the final state's pos, vel and mass go to that .npz file. Returns the
    final state and the launches."""
    import contextlib
    import io

    from spacetpu_torch import main as app
    from spacetpu_torch.ops import energy

    argv = ["--frontend", "none", "--n", "1000000", "--steps", "20"]
    if rehearsal:
        argv = ["--frontend", "none", "--n", "3000", "--steps", "3",
                "--platform", "cpu"]
    total_energy, energy_s = energy.total_energy, []

    def timed_energy(*args, **kw):
        sync(dev)
        t0 = time.perf_counter()
        value = total_energy(*args, **kw)
        sync(dev)
        energy_s.append(time.perf_counter() - t0)
        return value

    out = io.StringIO()
    reset_launches()
    energy.total_energy = timed_energy
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            state = app.main(argv)
    finally:
        energy.total_energy = total_energy
    wall = time.perf_counter() - t0
    launches = read_launches()
    lines = out.getvalue().splitlines()
    drift = [float(ln.split(":")[1].split()[0]) for ln in lines
             if "energy drift" in ln]
    emit({"phase": "headless_path", "argv": argv, "wall_s": wall,
          "energy_sums_s": energy_s, "printed": lines,
          "launches": launches, "nvidia_smi": card["smi"]})
    if not (drift and np.isfinite(drift[0])
            and bool(torch.isfinite(state.pos).all())):
        fail(f"headless path: no finite energy drift or state: {lines}")
    want = 0 if rehearsal else len(energy_s)
    if len(energy_s) != 2 or launches["pair_potential"] != want:
        fail(f"headless path: {len(energy_s)} energy sums and "
             f"{launches['pair_potential']} pair_potential launches, want 2 "
             f"and {want}")
    kernels = launches["pair_potential_kernels"]
    if (kernels == 0) != rehearsal or kernels % 2:
        fail(f"headless path: {kernels} kernel launches of pair_potential's "
             f"2 calls, want the same count for each call")
    if dump:
        os.makedirs(os.path.dirname(os.path.abspath(dump)), exist_ok=True)
        np.savez(dump, **{k: getattr(state, k).cpu().numpy()
                          for k in ("pos", "vel", "mass")})
    return state, launches


def phase_headless_strip(dev, rehearsal, card):
    """`main` with --frontend none --algorithm tree --near-mode strip at
    N=200000, 10 steps: the command line on the card in strip mode (at 1M
    the run's two O(N^2) energy sums would take about 0.4 s on an H100, each
    one pair_potential call of about 0.19 s: `headless_path`)."""
    import contextlib
    import io

    from spacetpu_torch import main as app

    argv = ["--frontend", "none", "--algorithm", "tree", "--near-mode",
            "strip", "--n", "200000", "--steps", "10"]
    if rehearsal:
        argv[-3:] = ["3000", "--steps", "3"]
        argv += ["--platform", "cpu"]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = app.main(argv)
    wall = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    rate = [float(ln.split("(")[1].split()[0]) for ln in lines
            if "steps/s" in ln and ln.split()[1] == "steps"]
    drift = [float(ln.split(":")[1].split()[0]) for ln in lines
             if "energy drift" in ln]
    launches = read_launches()
    emit({"phase": "headless_strip", "argv": argv, "wall_s": wall,
          "steps_per_s": rate[0] if rate else None,
          "energy_drift": drift[0] if drift else None, "printed": lines,
          "launches": launches, "nvidia_smi": card["smi"]})
    if not (rate and drift and np.isfinite(drift[0])
            and bool(torch.isfinite(state.pos).all())):
        fail(f"headless strip: no rate, finite drift or state: {lines}")
    if not rehearsal and not (launches["near_strip"] and
                              launches["quad_strip"]):
        fail(f"headless strip ran without the strip kernels: {launches}")


def phase_engine(dev, rehearsal, card, seconds=5.0):
    """A SimEngine at N=1000000 (make_engine_for: PM): ticks/s without a
    consumer, then with one sampling at 20 Hz, the snapshot's latency, and
    current_ticks never going back; then a TreePM engine whose forced
    mid-run fallback swaps to the tree."""
    import spacetpu_torch as st
    from spacetpu_torch.engine import SimEngine, make_engine_for
    from spacetpu_torch.models import presets

    if rehearsal:
        seconds = 1.0
    n = 3000 if rehearsal else 1_000_000
    scene = presets.fixed_cloud(n)
    eng = make_engine_for(scene.state(device=dev))
    seen, lat = [], []
    with eng:
        deadline = time.perf_counter() + 300
        while eng.exchange.current_ticks() == 0:
            eng.check_health()
            if time.perf_counter() > deadline:
                fail("engine: no tick within 300 s")
            time.sleep(0.01)
        k0, t0 = eng.exchange.current_ticks(), time.perf_counter()
        time.sleep(seconds)
        k1, t1 = eng.exchange.current_ticks(), time.perf_counter()
        while time.perf_counter() < t1 + seconds:
            a = time.perf_counter()
            eng.exchange.sample()
            lat.append(time.perf_counter() - a)
            seen.append(eng.exchange.current_ticks())
            time.sleep(max(0.0, 0.05 - (time.perf_counter() - a)))
        k2, t2 = eng.exchange.current_ticks(), time.perf_counter()
    eng.check_health()
    row = {"phase": "engine", "n": scene.n, "solver": eng.algorithm,
           "ticks_per_s_no_consumer": (k1 - k0) / (t1 - t0),
           "ticks_per_s_consumer_20hz": (k2 - k1) / (t2 - t1),
           "samples": len(lat),
           "sample_ms_median": 1e3 * float(np.median(lat)),
           "sample_ms_max": 1e3 * float(np.max(lat)),
           "ticks_monotone": all(b >= a for a, b in zip(seen, seen[1:])),
           "final_finite": bool(torch.isfinite(eng.final_state.pos).all())}

    sim = st.make_simulation(scene.n, algorithm="treepm", device=dev)
    state = sim.prime(scene.state(device=dev))

    def factory(reason):
        return st.make_simulation(scene.n, algorithm="tree", theta=0.5,
                                  tree_refresh_every=8, device=dev)

    eng = SimEngine(sim, state, recal_every=3, fallback_factory=factory)
    sim.degenerate = "treepm-saturated"
    with eng:
        t0 = time.perf_counter()
        while eng.algorithm != "tree" and time.perf_counter() - t0 < 300:
            eng.check_health()
            time.sleep(0.02)
        t_swap = time.perf_counter() - t0
        at_swap = eng.exchange.current_ticks()
        while (eng.exchange.current_ticks() < at_swap + 3
               and time.perf_counter() - t0 < 300):
            eng.check_health()
            time.sleep(0.02)
    eng.check_health()
    row.update(fallback={"from": "treepm", "to": eng.algorithm,
                         "swap_s": t_swap, "ticks_at_swap": at_swap,
                         "ticks_end": eng.exchange.current_ticks(),
                         "final_finite": bool(torch.isfinite(
                             eng.final_state.pos).all())},
               nvidia_smi=card["smi"])
    emit(row)
    if not (row["ticks_monotone"] and row["final_finite"]
            and row["fallback"]["to"] == "tree"
            and row["fallback"]["ticks_end"] >= at_swap + 3
            and row["fallback"]["final_finite"]):
        fail(f"engine: {row}")
    if not rehearsal and row["solver"] != "pm":
        fail(f"engine: make_engine_for picked {row['solver']!r} at 1M")


def splat_kernel_row(app) -> dict:
    """splat_tiles at the app path's last frame: timed beside its bound
    (`splat_bound`) and its plain version's time (float32, one call over
    the whole frame)."""
    from spacetpu_torch.render import cuda_splat

    keys, pay1, pay2, n_tiles = app["inputs"]

    def run():
        return cuda_splat.splat_tiles(keys, pay1, pay2, n_tiles=n_tiles)

    def plain():
        return cuda_splat.splat_tiles_plain(keys, pay1, pay2,
                                            n_tiles=n_tiles)

    return {"name": "splat_tiles", "route": "cuda", "source": SPLAT_SOURCE,
            "replaces": REPLACES["splat_tiles"],
            "launches": app["launches"]["splat_tiles"],
            "max_abs_err": app["hold"]["max_abs_err"],
            "hold_ratio": app["hold"]["hold_ratio"],
            "ms": cuda_ms(run, 5), "plain_ms": cuda_ms(plain, 1),
            **splat_bound(keys, pay1, pay2, n_tiles), "library_ms": None,
            "dtype": "float32", "shape": [n_tiles, 96, 256]}


#: pairs a thread evaluates in one trip of a kernel's pair loop: 8 (the
#: loops unrolled 8 times); in direct_mxu's float32 kernel 4 k-steps x 4
#: row tiles x the 4 pairs an m16n8 accumulator holds a lane; in the poly
#: walk of pairs_short and pairs_short_hybrid a chunk of 32 sources (the
#: loop over a stage's chunks, its skip test included); in quad_refine,
#: pairs_quad_shared, near_strip, pairs_direct and pairs_hybrid 8 sources
#: for each of a thread's two targets; in direct_vpu 16 / LEAN_TARGETS
#: sources for each of a thread's LEAN_TARGETS targets; in quad_dense and
#: quad_masked 8 / QUAD_TARGETS summaries for each of a thread's
#: QUAD_TARGETS targets; in pairs_quad 4 summaries for its one target; in
#: pair_potential's band kernel POT_UNROLL (4) columns against a lane's
#: POT_P (16) rows, each an unordered pair
PAIRS_PER_LOOP = {"direct_mxu": 64, "pairs_short": 32,
                  "pairs_short_hybrid": 32, "quad_refine": 16,
                  "pairs_quad_shared": 16, "near_strip": 16,
                  "pairs_direct": 16, "pairs_hybrid": 16, "direct_vpu": 16,
                  "quad_dense": 8, "quad_masked": 8, "pairs_quad": 4,
                  "pair_potential": 64}


def potential_kernel_row(headless, loops, card) -> dict:
    """pair_potential at the headless path's final state (float32, N =
    1,000,001, eps = 0): timed beside its bound (the larger of its flops at
    the float32 rate and its rsqrts at the MUFU rate, over the N (N - 1) / 2
    unordered pairs that the function needs, since 1/d_ij = 1/d_ji, as the
    kernels take them), its issue bound over those pairs, the kernel
    launches that each of the headless path's calls made
    (`launches_per_call`, as the C entry counted them: the diagonal tiles,
    a band each, the join), and one call of its plain version, which it is
    held against body by body."""
    from spacetpu_torch.ops import energy

    state, launches = headless
    pos, mass = state.pos, state.mass
    n = pos.shape[0]
    kw = dict(softening="plummer", eps=0.0)

    def run():
        return energy.pair_potential(pos, mass, **kw)

    got = run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync(pos.device)
    start.record()
    want = energy.pair_potential_plain(pos, mass, **kw)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not rel <= POTENTIAL_TOL[pos.dtype]:
        fail(f"pair_potential off its plain version at the headless state: "
             f"{rel}")
    pairs = float(n) * (n - 1) / 2
    t_ops = POTENTIAL_FLOPS * pairs / PEAK_F32_FLOPS
    t_mufu = mufu_ms(pairs, card) / 1e3
    t_bytes = (4 * n + n) * pos.element_size() / PEAK_BYTES
    rows = energy.potential_rows(pos.dtype)
    return {"name": "pair_potential", "route": "cuda", "source": SOURCE,
            "replaces": "spacetpu/ops/energy.py:28 (potential_energy, a "
                        "jitted lax.scan; no pallas_call)",
            "tpu_kernel": None, "launches": launches["pair_potential"],
            "launches_per_call": (launches["pair_potential_kernels"]
                                  // launches["pair_potential"]),
            "rows": rows, "slots": energy.POTENTIAL_SLOTS,
            "max_abs_err": err, "max_rel_err": rel, "ms": cuda_ms(run, 3),
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_mufu,
                                                        t_bytes),
            "bound_by": "bytes" if t_bytes > max(t_ops, t_mufu)
            else "operations",
            "pipe_floors_ms": {"f32_ms": 1e3 * t_ops, "mufu_ms": 1e3 * t_mufu},
            "library_ms": None, "pairs": pairs, "dtype": "float32",
            "shape": [n], **issue_fields(loops, "pair_potential", pairs,
                                         card)}


def issue_fields(loops, name, pairs, card) -> dict:
    """`sass_per_pair`: the inner-loop instructions of the instance the path
    runs (`phase_build`) over the pairs a thread takes a loop
    (`PAIRS_PER_LOOP`); `issue_bound_ms`: the time to issue them for
    `pairs` pairs at one warp instruction a clock on each of the SM's 4
    sub-partitions, at the card's maximum SM clock."""
    per_pair = (loops[name] / PAIRS_PER_LOOP.get(name, 8)
                if loops.get(name) else None)
    issue_ms = (None if per_pair is None else 1e3 * per_pair * pairs
                / (card["sm_count"] * 4 * 32 * card["max_sm_mhz"] * 1e6))
    return {"sass_per_pair": per_pair, "issue_bound_ms": issue_ms}


def kernel_row(name, source, launches, run, plain, err, rel, *, pairs,
               nbytes, flops=None, **more):
    """One entry of the kernels line: run() and plain() timed between CUDA
    events, beside the bound for `pairs` interactions of `flops` each
    (FLOPS_PER_PAIR[name] where None) and `nbytes` moved. All kernels here
    are timed in float32."""
    flops = FLOPS_PER_PAIR[name] if flops is None else flops
    t_ops = flops * pairs / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "max_rel_err": rel,
            "ms": cuda_ms(run, 5), "plain_ms": cuda_ms(plain, 1),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "pairs": pairs, "flops_per_pair": flops,
            "dtype": "float32", **more}


def phase_kernel_table(scene, launches, loops, card, dev):
    """Each kernel at the main path's shapes: against its plain version,
    timed beside its bound, its issue bound (`issue_fields`) and the plain
    version's time."""
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
        a_k = cuda_direct.acc_direct_kernel(pos, mass, method=method, **kw)
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
        row = kernel_row(
            name, SOURCE, launches,
            lambda: cuda_direct.acc_direct_kernel(pos, mass, method=method,
                                                  **kw),
            plain, err, rel, pairs=float(n) * n,
            nbytes=(3 * n + 4 * n + 3 * n) * pos.element_size(),
            rel_to_terms=None if scale is None else err / scale,
            **issue_fields(loops, name, float(n) * n, card), shape=[n, n])
        if method == "mxu":
            # the tensor-core kernel: the largest of its pipes' floors
            row.update(mxu_bound(float(n) * n, card),
                       route_detail="tensor cores, 3xTF32 (mma.sync)")
        table.append(row)
    return table


def tree_kernel_table(prep, g, launches, loops, card):
    """The tree's kernels at the tree path's shapes (its final state's prep,
    float32): each held against its plain version (2e-5 of max|a|), timed
    beside its bound, its issue bound (`issue_fields`) and its plain
    version's time. The bound counts the work this run's tile lists hold:
    `valid` ids, not the lists' capacity. The issue bound counts the pairs
    each kernel evaluates: pairs_quad stages a live tile's null slots as
    zero summaries and sweeps all pj of them (`evaluated_pairs`)."""
    from spacetpu_torch.ops import cuda_tree

    x = tree_inputs(prep, g)
    pos_g = prep["pos_g"]
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    elem = pos_g.element_size()
    m, n_sum = gg * leaf, gg
    valid_d = int((prep["near_flat"] < gg).sum())
    valid_q = int((prep["nearq_flat"] < gg).sum())
    pj_q = prep["nearq_flat"].numel() // prep["nearq_tile_tgt"].numel()
    evaluated_q = (float(int((prep["nearq_tile_tgt"] < gg).sum())) * pj_q
                   * leaf)
    lists = {k: prep[k].numel() * 8 for k in
             ("near_flat", "near_tile_tgt", "nearq_flat", "nearq_tile_tgt")}
    eps = TREE["eps"]
    d_args = (pos_g, x["srows"][False], prep["near_flat"],
              prep["near_tile_tgt"])
    q_args = (pos_g, x["neg"], prep["nearq_flat"], prep["nearq_tile_tgt"])
    kernels = {
        "quad_dense": dict(
            run=lambda: cuda_tree.acc_cross_quad(
                x["targets"], x["summaries"], eps=eps),
            plain=lambda: cuda_tree.acc_cross_quad_plain(
                x["targets"], x["summaries"], eps=eps),
            pairs=float(m) * n_sum,
            nbytes=(3 * m + 10 * n_sum + 3 * m) * elem,
            shape=[m, n_sum]),
        "pairs_direct": dict(
            run=lambda: cuda_tree.near_pairs_direct(
                *d_args, softening="plummer", eps=eps),
            plain=lambda: cuda_tree.near_pairs_direct_plain(
                *d_args, softening="plummer", eps=eps),
            pairs=float(valid_d) * leaf * block,
            nbytes=((3 * m + 4 * (gg + 1) * block + 3 * m) * elem
                    + lists["near_flat"] + lists["near_tile_tgt"]),
            shape=[gg, leaf, valid_d]),
        "pairs_quad": dict(
            run=lambda: cuda_tree.near_pairs_quad(*q_args, eps=eps),
            plain=lambda: cuda_tree.near_pairs_quad_plain(*q_args, eps=eps),
            pairs=float(valid_q) * leaf, evaluated=evaluated_q,
            nbytes=((3 * m + 10 * (gg + 1) + 3 * m) * elem
                    + lists["nearq_flat"] + lists["nearq_tile_tgt"]),
            shape=[gg, leaf, valid_q]),
    }
    table = []
    for name, k in kernels.items():
        a_k, a_p = k["run"](), k["plain"]()
        err = float((a_k.reshape(-1, 3) - a_p.reshape(-1, 3)).abs().max())
        rel = err / float(a_p.abs().max())
        if not rel <= 2e-5:
            fail(f"{name} off its plain version at the tree path's shapes: "
                 f"max_abs_err={err} rel={rel}")
        evaluated = k.get("evaluated", k["pairs"])
        issue = issue_fields(loops, name, evaluated, card)
        if "evaluated" in k:
            issue["evaluated_pairs"] = evaluated
        table.append(kernel_row(
            name, TREE_SOURCE, launches, k["run"], k["plain"], err, rel,
            pairs=k["pairs"], nbytes=k["nbytes"], shape=k["shape"], **issue))
    return table


def far3_kernel_table(prep, g, launches, loops, card):
    """The 3-level far field's kernels at the far3 path's shapes (its final
    state's prep, float32), as `tree_kernel_table` does for the others.
    quad_masked's bound and issue bound count the (target, super) pairs
    that the mask keeps (the pairs it evaluates); pairs_quad_shared's row
    times its two launches of a force pass (M1 and M2) together, bounds the
    valid ids of both lists' live tiles (the pairs it evaluates: it skips
    null slots) and gives its issue bound over them (`issue_fields`)."""
    from spacetpu_torch.ops import cuda_tree
    from spacetpu_torch.ops import tree as tree_ops

    x = far3_inputs(prep, g)
    pos_g = prep["pos_g"]
    gg, leaf = pos_g.shape[:2]
    g2, g_m = gg // tree_ops.SUPER, gg // tree_ops.MID
    elem = pos_g.element_size()
    m = gg * leaf
    eps = TREE["eps"]
    rows = m // g2
    kept = g2 * g2 - int((prep["idx2"] < g2).sum())
    pj = tree_ops.NEAR_QUAD_PJ
    shared, valid, list_bytes = {}, 0, 0
    for k, n_src in (("m1", g_m), ("m2", gg)):
        live = int(prep[f"{k}_ntiles"])
        ids = prep[f"{k}_flat"].reshape(-1, pj)[prep[f"{k}_src"][:live]]
        valid += int((ids < n_src).sum())
        list_bytes += sum(prep[f"{k}_{f}"].numel() * 8
                          for f in ("flat", "tgt", "src"))
        shared[k] = (pos_g, x[k], prep[f"{k}_flat"], prep[f"{k}_tgt"],
                     prep[f"{k}_src"])

    def both(fn):
        return lambda: fn(*shared["m1"], eps=eps) + fn(*shared["m2"],
                                                       eps=eps)

    masked = (x["targets"], x["supers"], prep["idx2"])
    kernels = {
        "quad_masked": dict(
            run=lambda: cuda_tree.acc_cross_quad_masked(*masked, eps=eps),
            plain=lambda: cuda_tree.acc_cross_quad_masked_plain(*masked,
                                                                eps=eps),
            pairs=float(rows) * kept,
            nbytes=(3 * m + 10 * g2 + 3 * m) * elem
            + prep["idx2"].numel() * 8,
            shape=[m, g2, int((prep["idx2"] < g2).sum())]),
        "pairs_quad_shared": dict(
            run=both(cuda_tree.near_pairs_quad_shared),
            plain=both(cuda_tree.near_pairs_quad_shared_plain),
            pairs=float(valid) * leaf,
            nbytes=(2 * (3 * m + 3 * m) + 10 * (g_m + 1 + gg + 1)) * elem
            + list_bytes,
            shape=[gg, leaf, valid]),
    }
    table = []
    for name, k in kernels.items():
        a_k, a_p = k["run"](), k["plain"]()
        err = float((a_k - a_p).abs().max())
        # a pass whose every column is masked gives exactly 0 in both
        rel = err / (float(a_p.abs().max()) or 1.0)
        if not rel <= 2e-5:
            fail(f"{name} off its plain version at the far3 path's shapes: "
                 f"max_abs_err={err} rel={rel}")
        issue = issue_fields(loops, name, k["pairs"], card)
        table.append(kernel_row(
            name, TREE_SOURCE, launches, k["run"], k["plain"], err, rel,
            pairs=k["pairs"], nbytes=k["nbytes"], shape=k["shape"], **issue))
    return table


def body_kernel_row(name, prep, srows, kw, launches, loops, card):
    """One body kernel (pairs_hybrid, pairs_short, pairs_short_hybrid) at a
    path's final prep (float32): held against its plain version and the
    float64 sum (`hold_body`), timed beside its bound, its issue bound and
    its plain version's time. The bound counts the pairs the function
    needs on this run's lists: pairs_hybrid all live pairs (valid ids of
    the tile list times leaf targets times block source slots, as
    pairs_direct's row does); the short-range law with the poly split the
    pairs inside r_cut (`cuda_tree.short_pair_counts`, beside the listed
    pairs and those the kernel evaluates: pairs_short and
    pairs_short_hybrid run one walk, which skips the same chunks of the same
    lists; `in_cutoff_skipped` must be 0), at the flops of the function
    that the case's law and eps give (`short_flops`). The issue bound
    counts the evaluated pairs."""
    from spacetpu_torch.ops import cuda_tree

    pos_g = prep["pos_g"]
    gg, leaf = pos_g.shape[:2]
    block = leaf + 1
    m, elem = gg * leaf, pos_g.element_size()
    valid = int((prep["near_flat"] < gg).sum())
    args = (pos_g, srows, prep["near_flat"], prep["near_tile_tgt"])
    run = lambda: getattr(cuda_tree, f"near_{name}")(*args, **kw)  # noqa
    plain = lambda: getattr(cuda_tree, f"near_{name}_plain")(  # noqa
        *args, **kw)
    held = hold_body(name, run(), plain(), args, kw)
    if not held["ok"]:
        fail(f"{name} off its plain version at its path's shapes: {held}")
    pairs = evaluated = float(valid) * leaf * block
    counts = {}
    flops = short_flops(name, kw) if "split" in kw else None
    if kw.get("split") == "poly":
        got = cuda_tree.short_pair_counts(*args, rcut=kw["rcut"])
        if got["in_cutoff_skipped"] or got["listed"] != pairs:
            fail(f"{name}'s pair counts at its path's shapes: {got}")
        pairs = float(got["in_cutoff"])
        evaluated = float(got["evaluated"])
        counts = {"listed_pairs": float(got["listed"]),
                  "in_cutoff_pairs": pairs, "evaluated_pairs": evaluated,
                  "in_cutoff_skipped": got["in_cutoff_skipped"]}
    return kernel_row(
        name, TREE_SOURCE, launches, run, plain, held["max_abs_err"],
        held["max_rel_err"], pairs=pairs, flops=flops,
        nbytes=((3 * m + 4 * (gg + 1) * block + 3 * m) * elem
                + (prep["near_flat"].numel()
                   + prep["near_tile_tgt"].numel()) * 8),
        shape=[gg, leaf, valid], settings=kw,
        hold_ratio=held["hold_ratio"], hold_tol=held["hold_tol"],
        term_over_a=held["term_over_a"], **counts,
        **issue_fields(loops, name, evaluated, card))


def strip_kernel_table(runs, loops, card):
    """The strip kernels at their paths' shapes (`STRIP_KERNELS`; each
    path's final prep, float32): against the plain version on the whole
    input (2e-5 of max|a|), timed beside its bound, its issue bound and the
    plain version's time. The bound counts the live work of this run's
    lists: near_strip 22 flops a (target, body) pair of each valid list
    entry's block rows, quad_strip 58 a (target, valid entry), quad_refine
    58 a (target, live column of its super's strip)."""
    from spacetpu_torch.ops import tree as tree_ops

    table = []
    for name, phase in STRIP_KERNELS.items():
        prep, g, launches = runs[phase]
        run, plain = strip_calls(prep, g, TREE["eps"])[name]
        pos_g, idx = prep["pos_g"], prep["idx"]
        gg, leaf = pos_g.shape[:2]
        block, m, elem = leaf + 1, gg * leaf, pos_g.element_size()
        valid, k = int((idx < gg).sum()), idx.shape[1]
        if name == "near_strip":
            pairs = float(valid) * leaf * block
            tpu = float(gg) * k * block * block
            nbytes = (3 * m + (4 * leaf + 4) * gg + 3 * m) * elem + \
                idx.numel() * 8
            shape = [gg, leaf, k, valid]
        elif name == "quad_strip":
            pairs = float(valid) * leaf
            tpu = float(gg) * (-(-k // 128) * 128) * block
            nbytes = (3 * m + 10 * (gg + 1) + 3 * m) * elem + idx.numel() * 8
            shape = [gg, leaf, k, valid]
        else:
            strips = strip_inputs(prep, g)["refine"][1]
            g2 = gg // tree_ops.SUPER
            s_pad = strips.shape[1] // g2
            live = int((strips[3:10] != 0).any(0).sum())
            pairs = float(live) * tree_ops.SUPER * leaf
            tpu = float(gg) * block * s_pad
            nbytes = (3 * m + 10 * g2 * s_pad + 3 * m) * elem
            shape = [gg, leaf, s_pad, live]
        a_k, a_p = run(), plain()
        err = float((a_k.reshape(-1, 3) - a_p.reshape(-1, 3)).abs().max())
        rel = err / float(a_p.abs().max())
        if not rel <= 2e-5:
            fail(f"{name} off its plain version at {phase}'s shapes: "
                 f"max_abs_err={err} rel={rel}")
        table.append(kernel_row(
            name, TREE_SOURCE, launches, run, plain, err, rel, pairs=pairs,
            nbytes=nbytes, shape=shape, path=phase, tpu_pairs=tpu,
            **issue_fields(loops, name, pairs, card)))
    return table


def disjoint_cluster_pairs(prep, srows) -> dict:
    """The (target cluster, source cluster) pairs of a prep's near tile list
    (valid ids) whose boxes are disjoint: gap^2 > 0, gap the per-axis
    distance between the box of the target cluster's leaf slots and that
    of the source cluster's block entries, squared and summed in float32.
    There no (target, source) pair has r^2 = 0, so pairs_hybrid's r^2 = 0
    mask could be left out."""
    pos_g = prep["pos_g"]
    gg, leaf = pos_g.shape[:2]
    table = srows[:3].reshape(3, -1, leaf + 1)
    lo_s, hi_s = table.amin(2).T, table.amax(2).T
    lo_t, hi_t = pos_g.amin(1), pos_g.amax(1)
    flat, tgt = prep["near_flat"], prep["near_tile_tgt"]
    t = tgt.repeat_interleave(flat.numel() // tgt.numel())
    keep = (t < gg) & (flat < table.shape[1] - 1)
    t, c = t[keep], flat[keep]
    gap = torch.clamp_min(torch.maximum(lo_s[c] - hi_t[t], lo_t[t] - hi_s[c]),
                          0.0)
    n = int(keep.sum())
    disjoint = int(((gap * gap).sum(1) > 0).sum())
    return {"cluster_pairs": n, "disjoint": disjoint,
            "share": disjoint / max(n, 1)}


def mesh_kernel_table(mxu_tree, treepm, mxu_treepm, loops, card):
    """The kernels of the mesh and hybrid paths at their paths' shapes:
    pairs_hybrid on mxu_paths/tree's final prep (with the share of its
    cluster pairs whose boxes are disjoint, `disjoint_cluster_pairs`),
    pairs_short on treepm_path's, pairs_short_hybrid on mxu_paths/treepm's,
    each with the launches of the run that launched it."""
    prep, g, launches = mxu_tree
    srows = tree_inputs(prep, g)["srows"][False]
    table = [dict(body_kernel_row(
        "pairs_hybrid", prep, srows,
        dict(softening="plummer", eps=TREE["eps"]), launches, loops, card),
        disjoint_cluster_pairs=disjoint_cluster_pairs(prep, srows))]
    for name, (prep, srows, launches, sim) in (
            ("pairs_short", treepm), ("pairs_short_hybrid", mxu_treepm)):
        mp = sim.mesh_params
        kw = dict(softening=sim.config.softening,
                  eps=sim.config.resolved_eps(), rs=mp["rs"],
                  rcut=mp["rcut"], split=mp["split"])
        table.append(body_kernel_row(name, prep, srows, kw, launches, loops,
                                     card))
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases on the CPU with the plain versions "
                         "at tiny N (prints no result)")
    ap.add_argument("--count-ops", action="store_true",
                    help="also trace tree_prep, tree_eval and one step of "
                         "the three tree paths, one step of the two mesh "
                         "paths and of default_workload with "
                         "torch.profiler "
                         "and print the number of kernels and copies the "
                         "card ran and the time it was busy")
    ap.add_argument("--dump-headless", metavar="NPZ",
                    help="write the headless path's final state (pos, vel, "
                         "mass) to this .npz file; its one use is the input "
                         "of tests/near_overflow_parity.py, which counts the "
                         "near-list overflow there with both packages")
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
    phase_tree_kernels(dev, rehearsal)
    scene, launches = phase_main_path(dev, rehearsal, card)
    prep, tree_g, tree_launches = phase_tree_path(dev, rehearsal, card,
                                                   args.count_ops)
    prep3, g3, far3_launches = phase_far3_path(dev, rehearsal, card,
                                               args.count_ops)
    phase_plummer_path(dev, rehearsal, card, args.count_ops)
    phase_strip_kernels(dev, rehearsal)
    strip = {"strip_path": phase_strip_path(dev, rehearsal, card,
                                            args.count_ops),
             "far3_strip_path": phase_far3_strip_path(dev, rehearsal, card,
                                                      args.count_ops)}
    phase_treepm_kernels(dev, rehearsal)
    treepm = phase_treepm_path(dev, rehearsal, card,
                               count_ops=args.count_ops)
    phase_pm_path(dev, rehearsal, card, args.count_ops)
    mxu_tree, mxu_treepm = phase_mxu_paths(dev, rehearsal, card)
    phase_default_workload(dev, rehearsal, args.count_ops)
    phase_reference_path(dev, rehearsal)
    phase_energy(dev, rehearsal)
    phase_splat_kernels(dev, rehearsal, card)
    app = phase_app_path(dev, rehearsal, card)
    phase_default_app(dev, rehearsal, card)
    headless = phase_headless_path(dev, rehearsal, card,
                                   dump=args.dump_headless)
    phase_headless_strip(dev, rehearsal, card)
    phase_engine(dev, rehearsal, card)
    if rehearsal:
        print("chip_smoke: cpu rehearsal finished; no result is printed",
              file=sys.stderr)
        return 0
    emit({"kernels": phase_kernel_table(scene, launches, loops, card, dev)
          + tree_kernel_table(prep, tree_g, tree_launches, loops, card)
          + far3_kernel_table(prep3, g3, far3_launches, loops, card)
          + mesh_kernel_table(mxu_tree, treepm, mxu_treepm, loops, card)
          + [splat_kernel_row(app)]
          + strip_kernel_table(strip, loops, card)
          + [potential_kernel_row(headless, loops, card)]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
