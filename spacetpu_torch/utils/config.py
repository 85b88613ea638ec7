"""Run configuration and CLI flags (the port's `python -m spacetpu_torch`).

The counterpart of `spacetpu/utils/config.py`: the same `RunConfig` fields
and defaults and the same flags, so that a command line of the JAX package
runs here unchanged. `--platform` takes auto | cpu | gpu ("auto" is the
card, `state.resolve_device`). The flags of what the port leaves out are
parsed and refused by `main` with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

from spacetpu_torch import constants


@dataclasses.dataclass
class RunConfig:
    platform: str = "auto"  # auto | cpu | gpu (auto = the card)
    preset: str = "fixed_cloud"  # the reference default (main.rs:61)
    n: int = 10000
    seed: int = 0
    algorithm: str = "auto"
    profile: str = "interactive"  # auto-select tier: interactive | accurate
    backend: str = "auto"
    pallas_method: str = "vpu"  # pair kernels: vpu | mxu
    integrator: str = "leapfrog"
    softening: str = "plummer"
    eps: Optional[float] = None
    theta: Optional[float] = None  # None = solver-tier default (see
    # resolved_theta: 0.3 reference parity pinned / 0.4 interactive auto)
    multipole_order: str = "auto"  # 1 | 2 | auto
    k_near: str = "default"  # default | auto | <int>: tree near-list cap
    near_mode: str = "auto"  # auto | pairs | strip: tree near-phase kernel
    cluster_mode: str = "auto"  # auto | equal | adaptive: tree partition
    leaf: str = "auto"  # auto | <int>: bodies per tree leaf cluster
    far_levels: str = "auto"  # auto | 2 | 3: tree far-field levels
    tree_refresh_every: int = 0  # 0 = auto (8 where auto-select builds it)
    run_chunk: int = 0  # max device-scan length per run() call (0 = auto)
    substeps: str = "1"  # multirate KDK substeps per outer dt (auto | <int>)
    fast_cap: str = "auto"  # multirate fast-set capacity (auto | <int>)
    pm_grid: str = "auto"  # particle-mesh size per axis (auto | <int>)
    pm_margin: float = 2.0  # PM bounding-box margin factor
    pm_rs_cells: Optional[float] = None  # TreePM split scale in cells
    pm_rcut_rs: Optional[float] = None  # TreePM cutoff in split scales
    pm_split: Optional[str] = None  # TreePM split family (poly | gauss)
    pm_fft: str = "auto"  # Poisson transform: auto | fft | matmul
    dt: float = constants.DELTA
    auto_frame: bool = True  # frame the camera to the scene at startup
    dtype: str = "float32"
    compensated: bool = True  # Kahan-compensated f32 integration
    frontend: str = "terminal"  # terminal | window | offline | none
    term_graphics: str = "auto"  # auto | kitty | iterm2 | sixel | ansi
    blend: str = "auto"  # auto | ordered | additive (body compositing)
    # multi-host: one rank a device (parallel/multihost.py)
    coordinator: str = ""  # host:port of process 0 ("" = single process)
    num_processes: int = 0
    process_id: int = -1
    width: int = 960
    height: int = 540
    trail_length: int = constants.TRAIL_MAX_LENGTH  # ring buffer snapshots
    frames: int = 300
    out_dir: str = "frames"
    gif: Optional[str] = None
    steps: int = 1000  # for frontend=none batch runs
    checkpoint: Optional[str] = None  # save path
    restore: Optional[str] = None  # load path
    checkpoint_every: int = 0  # steps between checkpoints (0 = off)
    recalibrate_every: int = 0  # steps between cap-degradation checks (0 = off)
    shard: int = 0  # headless: shard bodies over a D-device mesh (0 = off)
    report_encounters: bool = False  # headless: min-separation telemetry
    merge_collisions: int = 0  # headless: steps between merge checks (0=off)
    snapshot_wire: str = "f32"  # exchange snapshot format: f32 | u16
    profile_dir: Optional[str] = None  # torch.profiler trace directory

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RunConfig":
        return RunConfig(**json.loads(s))


def resolved_theta(theta: Optional[float]) -> float:
    """Opening angle for PINNED-solver contexts: the user's value, else
    reference parity. The interactive auto tier resolves None to
    constants.INTERACTIVE_TREE_THETA instead (engine.make_engine_for)."""
    return constants.BARNES_HUT_THETA if theta is None else float(theta)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spacetpu_torch",
        description="gravitational N-body simulator (PyTorch, CUDA)",
    )
    d = RunConfig()
    p.add_argument("--platform", default=d.platform,
                   choices=["auto", "cpu", "gpu"],
                   help="device: 'auto' and 'gpu' run on the CUDA card"
                        " (an error where there is none), 'cpu' runs the"
                        " plain PyTorch versions on the host")
    p.add_argument("--preset", default=d.preset,
                   help="scene preset (see"
                        " spacetpu_torch.models.presets.PRESETS)")
    p.add_argument("--n", type=int, default=d.n,
                   help="body count for parameterized presets")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--algorithm", default=d.algorithm,
                   choices=["auto", "direct", "tree", "pm", "treepm"],
                   help="force solver: direct (exact), tree, treepm, or pm"
                        " (display-grade forces; the interactive tier)."
                        " auto picks by N + scene (see --profile)")
    p.add_argument("--profile", default=d.profile,
                   choices=["interactive", "accurate"],
                   help="--algorithm auto tier above 500k bodies:"
                        " 'interactive' ticks the PM mesh when it resolves"
                        " the scene; 'accurate' runs the structure-cached"
                        " tree. Pin --algorithm treepm for the mesh-split"
                        " family")
    p.add_argument("--backend", default=d.backend,
                   choices=["auto", "xla", "pallas"],
                   help="force kernels: 'pallas' (the hand-written CUDA"
                        " kernels), 'xla' (the plain PyTorch versions),"
                        " 'auto' (the kernels on the card)")
    p.add_argument("--pallas-method", dest="pallas_method",
                   default=d.pallas_method, choices=["vpu", "mxu"],
                   help="pair kernels: 'vpu' (exact pairwise"
                        " differences, the default) or 'mxu' (the"
                        " expanded-form direct kernel, plummer eps > 0"
                        " only, and the hybrid near sums of the tree and"
                        " TreePM)")
    p.add_argument("--integrator", default=d.integrator,
                   choices=["leapfrog", "euler", "yoshida4"])
    p.add_argument("--softening", default=d.softening,
                   choices=["plummer", "ref"])
    p.add_argument("--eps", type=float, default=None,
                   help="softening length (default: law-specific)")
    p.add_argument("--theta", type=float, default=d.theta,
                   help="tree opening angle (default: 0.3 reference-parity"
                        " for pinned solvers, 0.4 quad for the interactive"
                        " auto tier)")
    p.add_argument("--multipole-order", default=d.multipole_order,
                   choices=["1", "2", "auto"],
                   help="tree far-field order (2 = +quadrupole)")
    p.add_argument("--k-near", dest="k_near", default=d.k_near,
                   help="tree near-list cap: 'default' (geometric formula),"
                        " 'auto' (measured from the scene at startup --"
                        " accuracy-safe on any mass distribution), or an"
                        " integer")
    p.add_argument("--near-mode", dest="near_mode", default=d.near_mode,
                   choices=["auto", "pairs", "strip"],
                   help="tree near-phase kernel: 'pairs' (cost tracks the"
                        " actual near-pair count; the auto default) or"
                        " 'strip' (static per-cluster cap)")
    p.add_argument("--cluster-mode", dest="cluster_mode",
                   default=d.cluster_mode,
                   choices=["auto", "equal", "adaptive"],
                   help="tree partition: 'equal' (equal-count SFC runs),"
                        " 'adaptive' (density-bounded cells), or 'auto'"
                        " (measure the scene and pick)")
    p.add_argument("--leaf", default=d.leaf,
                   help="bodies per tree leaf cluster ('auto' = 255)")
    p.add_argument("--far-levels", dest="far_levels", default=d.far_levels,
                   choices=["auto", "2", "3"],
                   help="tree far-field levels: 2 (dense cluster"
                        " multipoles) or 3 (+supercluster refinement; auto"
                        " above 4096 clusters)")
    p.add_argument("--tree-refresh-every", dest="tree_refresh_every",
                   type=int, default=d.tree_refresh_every,
                   help="steps between tree sort/near-list rebuilds"
                        " (1 = every step, reference parity; 0 = auto:"
                        " 8 where the auto-select builds the solver, that"
                        " is the interactive frontends' engine under"
                        " --algorithm auto and the headless run with"
                        " --profile accurate; 1 everywhere else,"
                        " including the default headless run and every"
                        " pinned --algorithm)")
    p.add_argument("--shard", type=int, default=d.shard,
                   help="headless: run body-sharded over a group of D"
                        " ranks, one a device (direct -> the ring, pm ->"
                        " one all_reduce of the mesh; tree and treepm are"
                        " not ported yet; N is zero-mass padded to the"
                        " shard grain; 0 = single-device)")
    p.add_argument("--recalibrate-every", dest="recalibrate_every",
                   type=int, default=d.recalibrate_every,
                   help="headless: every N steps check the tree overflow"
                        " telemetry and re-measure the caps if the scene"
                        " outgrew them (0 = off)")
    p.add_argument("--run-chunk", dest="run_chunk", type=int,
                   default=d.run_chunk,
                   help="accepted for the JAX package's command lines; the"
                        " port's run() is a Python loop and has no scan to"
                        " chunk")
    p.add_argument("--substeps", default=d.substeps,
                   help="two-level multirate leapfrog: the fastest bodies"
                        " take this many KDK substeps per outer dt"
                        " (1 = plain stepping; 'auto' measures the scene's"
                        " timescale spread at --dt and picks m and the"
                        " fast capacity)")
    p.add_argument("--fast-cap", dest="fast_cap", default=d.fast_cap,
                   help="multirate fast-set capacity: 'auto' (~N/8) or an"
                        " integer body count")
    p.add_argument("--pm-grid", dest="pm_grid", default=d.pm_grid,
                   help="particle-mesh size per axis for --algorithm"
                        " pm/treepm: 'auto' (pm ~N^(1/3) cap 128; treepm"
                        " 2N^(1/3) cap 256) or an integer")
    p.add_argument("--pm-margin", dest="pm_margin", type=float,
                   default=d.pm_margin,
                   help="PM bounding-box margin factor measured at startup"
                        " (bodies leaving the box are face-clamped +"
                        " counted; --recalibrate-every re-measures)")
    p.add_argument("--pm-rs-cells", dest="pm_rs_cells", type=float,
                   default=d.pm_rs_cells,
                   help="TreePM Gaussian split scale in mesh cells"
                        " (rs = cells * h; default ops/treepm.RS_CELLS)")
    p.add_argument("--pm-rcut-rs", dest="pm_rcut_rs", type=float,
                   default=d.pm_rcut_rs,
                   help="TreePM short-range cutoff in split scales"
                        " (r_cut = x * rs; default ops/treepm.RCUT_RS)")
    p.add_argument("--pm-split", dest="pm_split", default=d.pm_split,
                   choices=("poly", "gauss"),
                   help="TreePM force-split family: 'poly' (quintic"
                        " blend, cheap pair kernel; default) or 'gauss'"
                        " (classic erf/Ewald split)")
    p.add_argument("--pm-fft", dest="pm_fft", default=d.pm_fft,
                   choices=("auto", "fft", "matmul"),
                   help="PM/TreePM Poisson transform (ops/pm.fft_method):"
                        " every name runs torch.fft (cuFFT on the card);"
                        " 'matmul' is accepted for the JAX package's"
                        " command lines")
    p.add_argument("--no-auto-frame", dest="auto_frame",
                   action="store_false", default=d.auto_frame,
                   help="keep the reference's fixed camera at (0,0,2)")
    p.add_argument("--dt", type=float, default=d.dt,
                   help="timestep seconds (live-tunable with l/o keys)")
    p.add_argument("--dtype", default=d.dtype,
                   choices=["float32", "float64"])
    p.add_argument("--no-compensated", dest="compensated",
                   action="store_false", default=d.compensated,
                   help="disable Kahan-compensated integration")
    p.add_argument("--frontend", default=d.frontend,
                   choices=["terminal", "window", "offline", "none"])
    p.add_argument("--coordinator", default=d.coordinator,
                   help="multi-host: coordinator host:port (all processes"
                        " run the same command, one a device; see"
                        " parallel/multihost.py)")
    p.add_argument("--num-processes", dest="num_processes", type=int,
                   default=d.num_processes)
    p.add_argument("--process-id", dest="process_id", type=int,
                   default=d.process_id)
    p.add_argument("--blend", default=d.blend,
                   choices=["auto", "ordered", "additive"],
                   help="body compositing: depth-ordered alpha-over "
                        "(few-body scenes; auto for N<=128) or additive "
                        "glow splatting")
    p.add_argument("--term-graphics", dest="term_graphics",
                   default=d.term_graphics,
                   choices=["auto", "kitty", "iterm2", "sixel", "ansi"],
                   help="terminal frontend pixel protocol (auto-detected; "
                        "ansi = half-block fallback)")
    p.add_argument("--width", type=int, default=d.width)
    p.add_argument("--height", type=int, default=d.height)
    p.add_argument("--trail-length", type=int, default=d.trail_length,
                   help="trail ring-buffer snapshots (constants.rs:22-23)")
    p.add_argument("--frames", type=int, default=d.frames)
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--gif", default=None, help="also write an animated gif")
    p.add_argument("--steps", type=int, default=d.steps,
                   help="sim steps for --frontend none")
    p.add_argument("--checkpoint", default=None, help="save state here at end")
    p.add_argument("--restore", default=None, help="start from this checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace here (trace.json)")
    p.add_argument("--report-encounters", dest="report_encounters",
                   action="store_true", default=d.report_encounters,
                   help="headless: report the global minimum separation"
                        " before and after the run (O(N^2) pass)")
    p.add_argument("--merge-collisions", dest="merge_collisions", type=int,
                   default=d.merge_collisions, metavar="EVERY",
                   help="every EVERY steps, merge overlapping bodies"
                        " (perfectly inelastic, barycentric; collision"
                        " radii = the scene's body radii; works headless"
                        " and in the interactive/offline frontends;"
                        " 0 = off)")
    p.add_argument("--snapshot-wire", dest="snapshot_wire",
                   choices=("f32", "u16"), default=d.snapshot_wire,
                   help="interactive snapshot transfer format: f32 ="
                        " full-precision positions; u16 = per-axis 16-bit"
                        " box quantization (half the device->host bytes,"
                        " error <= box/65535)")
    p.add_argument("--list-presets", action="store_true",
                   help="list available scene presets and exit")
    return p


def parse_args(argv=None) -> RunConfig:
    ns = build_parser().parse_args(argv)
    if getattr(ns, "list_presets", False):
        from spacetpu_torch.models import presets

        print("presets: " + ", ".join(sorted(presets.PRESETS)))
        raise SystemExit(0)
    return RunConfig(**{
        f.name: getattr(ns, f.name) for f in dataclasses.fields(RunConfig)
    })
