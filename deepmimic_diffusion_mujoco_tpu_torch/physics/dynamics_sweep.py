"""Time the humanoid's control-step (B5) and rollout (B6) kernels, on one
CUDA card:

    python -m deepmimic_diffusion_mujoco_tpu_torch.physics.dynamics_sweep \\
        [--baseline OLD/humanoid_dynamics.cu] [--out sweep.json]

Inputs are the walk clip's frames staggered over N envs, each targeting the
next frames (as ``PhysicsTrackingEnv.reset`` staggers them), at dt 1/30 and
17 substeps with contacts and limits on, fall height 0.3.

``--baseline`` names an earlier copy of ``csrc/humanoid_dynamics.cu`` with
the one-thread-per-env C interface (no plan arguments); its
``humanoid_tables.h`` must lie beside it. It is built and measured beside
the current kernel.

Each kernel is held against the plain version at N 33 first (one step, and
a T-3 rollout). Then, for each kernel:

- B6 at T 20 at N = 32 ... 65536 (every launch plan of the current kernel
  at each N), in ms and env-steps/s; B5 at N 4096 with and without the
  fused reward. CUDA events, the median of several launches, L2 flushed
  before each and the card held busy while they queue, after 2 s of matrix
  products.
- The phases of one substep and of the reward in SM cycles: a probe build
  of the source stamps ``clock64`` by lane 0 of every warp at each phase
  boundary and sums each phase over the launch (B6, T 20, N 4096); the
  median warp's sum over the substeps it ran. The probe builds exist only
  here. The lane-group kernel stamps fewer boundaries: "fk" is its chain
  walk (FK, subspaces, velocities, torques), "contacts" the contact
  records, "inertias" the bodies (inertias, contact sums, body forces),
  "aba_backward" the leaf-to-root pass (RNEA forces and ABA), "forward"
  the accelerations with the Euler step.
- Registers, stack and spill bytes of each entry point, from ptxas's log;
  the libraries build at once, one nvcc each.

Prints one JSON line per measurement and the card's name and power limit;
``--out`` keeps every row.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data.mocap import load_clip
from ..ops import _build
from ..ops.conv_block_sweep import time_ms, warm
from . import dynamics_kernel as DK

WALK = Path(__file__).resolve().parents[2] / "data" / "motions" / "humanoid3d_walk.txt"
SUBSTEPS, DT, FALL = 17, 1.0 / 30.0, 0.3
KW = dict(h=DT / SUBSTEPS, substeps=SUBSTEPS)
SCALING_N = (32, 132, 528, 1056, 4096, 16384, 65536)
T_MAIN, PROBE_N = 20, 4096
STEP_QPOS_TOL, STEP_QVEL_REL, REWARD_TOL = 1e-4, 1e-2, 1e-4  # as chip_smoke.py
PHASES = ("fk", "torques", "velocities", "inertias", "contacts", "rnea", "aba_backward",
          "root_solve", "forward", "integrate", "reward")
MAX_WARPS = 1 << 14

# The probe: lane 0 of each warp adds the SM cycles since its last stamp to
# the warp's sum for phase k; HUM_MARK only stamps.
PROBE_DECL = f"""
__device__ long long hum_probe_acc[{MAX_WARPS} * {len(PHASES)}];
__device__ long long hum_probe_last[{MAX_WARPS}];
#define HUM_PROBE_WARP ((int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5))
#define HUM_MARK() do {{ if ((threadIdx.x & 31) == 0) \\
    hum_probe_last[HUM_PROBE_WARP] = clock64(); }} while (0)
#define HUM_PHASE(k) do {{ if ((threadIdx.x & 31) == 0) {{ long long t_ = clock64(); \\
    hum_probe_acc[HUM_PROBE_WARP * {len(PHASES)} + (k)] += t_ - hum_probe_last[HUM_PROBE_WARP]; \\
    hum_probe_last[HUM_PROBE_WARP] = t_; }} }} while (0)
"""
PROBE_API = f"""
extern "C" int hum_probe_reset() {{
  void* p;
  cudaGetSymbolAddress(&p, hum_probe_acc);
  return (int)cudaMemset(p, 0, sizeof(long long) * {MAX_WARPS} * {len(PHASES)});
}}
extern "C" int hum_probe_read(long long* dst, int n) {{
  return (int)cudaMemcpyFromSymbol(dst, hum_probe_acc, sizeof(long long) * n);
}}
"""
# (anchor, text inserted, before the anchor?) in the one-thread-per-env source
BASELINE_ANCHORS = [
    ("HD_NOINLINE void substep(float* qp, float* qv, const float* tg, const StepParams& p) {\n",
     "  HUM_MARK();\n", False),
    ("  // joint-space applied torques\n", "  HUM_PHASE(0);\n", True),
    ("  // motion subspaces: the root's", "  HUM_PHASE(1);\n", True),
    ("  // spatial inertias, contacts", "  HUM_PHASE(2);\n", True),
    ("  if (p.contacts) {\n", "  HUM_PHASE(3);\n", True),
    ("  // RNEA bias,", "  HUM_PHASE(4);\n", True),
    ("  // zero-velocity ABA;", "  HUM_PHASE(5);\n", True),
    ("  float D0[6][6], u0[6], qdd0[6];\n", "  HUM_PHASE(6);\n", True),
    ("  SV a_root = sscale(Sr[0], qdd0[0]);\n", "  HUM_PHASE(7);\n", True),
    ("  // semi-implicit Euler,", "  HUM_PHASE(8);\n", True),
    ("}\n\n// ---------------------------------------------------------------------------\n"
     "// DeepMimic tracking reward", "  HUM_PHASE(9);\n", True),
    ("    rewards[row] = tracking_reward(", "    HUM_MARK();\n", True),
    ("    rewards[row] = tracking_reward(qp, qv, tg, rqv) * (1.f - dn);\n",
     "    HUM_PHASE(10);\n", False),
]


def emit(obj):
    print(json.dumps(obj), flush=True)


def walk_inputs(dev, n, steps):
    """The walk clip's frames staggered over n envs, each targeting the next
    ``steps`` frames: qpos, qvel (n, 35/34), targets, reference velocities
    (steps, n, 35/34)."""
    clip = load_clip(str(WALK))
    nf = len(clip.qpos)
    mot = torch.tensor(clip.qpos, dtype=torch.float32, device=dev)
    vel = torch.tensor(clip.qvel, dtype=torch.float32, device=dev)
    frame = (torch.arange(n, device=dev) * nf // n) % nf
    frames = (frame[None] + 1 + torch.arange(steps, device=dev)[:, None]) % nf
    return mot[frame], vel[frame], mot[frames], vel[frames]


def ptxas_summary(log: str) -> dict:
    """{function: {registers, stack, spill_stores, spill_loads}} from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def log_of(so: Path) -> dict:
    log = Path(str(so) + ".log")
    return ptxas_summary(log.read_text()) if log.exists() else {}


class OldStepParams(ctypes.Structure):
    """The earlier kernel's per-launch constants."""
    _fields_ = [("h", ctypes.c_float), ("half_h", ctypes.c_float),
                ("kp", ctypes.c_float * DK.NJ), ("kd", ctypes.c_float * DK.NJ),
                ("d_extra", ctypes.c_float * DK.NJ), ("fall_height", ctypes.c_float),
                ("substeps", ctypes.c_int), ("contacts", ctypes.c_int),
                ("limits", ctypes.c_int)]


def old_params(fall_height=0.0):
    h = KW["h"]
    p = OldStepParams()
    p.h, p.half_h = h, 0.5 * h
    for i in range(DK.NJ):
        p.kp[i], p.kd[i] = DK._KP[i], DK._KD[i]
        p.d_extra[i] = DK.JOINT_ARMATURE + h * (DK.JOINT_DAMPING + DK._KD[i])
    p.fall_height, p.substeps, p.contacts, p.limits = fall_height, SUBSTEPS, 1, 1
    return p


class OneThreadPerEnv:
    """The earlier kernel's library (one thread per env, no plan)."""

    def __init__(self, so: Path):
        self.lib = ctypes.CDLL(str(so))
        vp, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(OldStepParams)
        self.lib.humanoid_control_step_f32.argtypes = [vp] * 7 + [i, pp, vp]
        self.lib.humanoid_rollout_f32.argtypes = [vp] * 9 + [i, i, pp, vp]

    def control_step(self, qpos, qvel, tgt, rqv=None):
        N = qpos.shape[0]
        qp, qv = torch.empty_like(qpos), torch.empty_like(qvel)
        r = qpos.new_empty(N) if rqv is not None else None
        p = old_params()
        err = self.lib.humanoid_control_step_f32(
            qpos.data_ptr(), qvel.data_ptr(), tgt.data_ptr(),
            None if rqv is None else rqv.data_ptr(), qp.data_ptr(), qv.data_ptr(),
            None if r is None else r.data_ptr(), N, ctypes.byref(p),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B5 launch failed: {err}")
        return (qp, qv) if r is None else (qp, qv, r)

    def rollout(self, qpos, qvel, tgts, rqvs, done):
        N, T = qpos.shape[0], tgts.shape[0]
        dn = done.to(torch.float32)
        qp, qv, dn_out = torch.empty_like(qpos), torch.empty_like(qvel), torch.empty_like(dn)
        rewards = qpos.new_empty((T, N))
        p = old_params(FALL)
        err = self.lib.humanoid_rollout_f32(
            qpos.data_ptr(), qvel.data_ptr(), dn.data_ptr(), tgts.data_ptr(), rqvs.data_ptr(),
            qp.data_ptr(), qv.data_ptr(), dn_out.data_ptr(), rewards.data_ptr(), N, T,
            ctypes.byref(p), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline B6 launch failed: {err}")
        return qp, qv, rewards, dn_out > 0.5


def baseline_probe_source(source: Path) -> str:
    text = source.read_text()
    for anchor, stamp, before in BASELINE_ANCHORS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"probe anchor {anchor!r} not found once in {source}")
        text = text.replace(anchor, stamp + anchor if before else anchor + stamp)
    tables = (source.parent / "humanoid_tables.h").resolve()
    text = text.replace('#include "humanoid_tables.h"', f'#include "{tables}"')
    return PROBE_DECL + text + PROBE_API


def build_probe(name: str, text: str) -> Path:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    path.write_text(text)
    return _build.build(name, path)


def read_phases(lib, steps_run):
    """Median over warps of each phase's SM cycles per substep (the reward:
    per step), and the 90th percentile; ``steps_run`` (warps,) is the steps
    whose substeps each warp's lane 0 ran."""
    torch.cuda.synchronize()
    warps = len(steps_run)
    n = warps * len(PHASES)
    buf = (ctypes.c_longlong * n)()
    if lib.hum_probe_read(buf, n):
        raise RuntimeError("hum_probe_read failed")
    acc = np.frombuffer(buf, dtype=np.int64).reshape(warps, len(PHASES)).astype(np.float64)
    div = np.concatenate([np.repeat(np.asarray(steps_run, np.float64)[:, None] * SUBSTEPS,
                                    len(PHASES) - 1, 1), np.full((warps, 1), float(T_MAIN))], 1)
    per = acc / div
    med = dict(zip(PHASES, np.median(per, axis=0).tolist()))
    return {"warps": warps, "cycles_per_substep_median": med,
            "cycles_per_substep_p90": dict(zip(PHASES, np.percentile(per, 90, axis=0).tolist())),
            "substep_cycles_median": float(sum(v for k, v in med.items() if k != "reward"))}


def errors(out, ref):
    e = {"qpos": (out[0] - ref[0]).abs().max().item(),
         "qvel": (out[1] - ref[1]).abs().max().item()}
    ok = (e["qpos"] <= STEP_QPOS_TOL
          and e["qvel"] <= STEP_QVEL_REL * ref[1].abs().max().item()
          and all(torch.isfinite(t).all() for t in out[:3]))
    if len(out) > 2:
        e["reward"] = (out[2] - ref[2]).abs().max().item()
        ok = ok and e["reward"] <= REWARD_TOL
    if len(out) > 3:
        ok = ok and torch.equal(out[3], ref[3])
    return e, ok


@functools.lru_cache(maxsize=None)
def check_case(dev):
    """The checks' inputs (N 33, T 3, every fifth env done) and the plain
    versions' results on them, computed once."""
    qpos, qvel, tgts, rqvs = walk_inputs(dev, 33, 3)
    done = torch.zeros(33, dtype=torch.bool, device=dev)
    done[::5] = True
    return ((qpos, qvel, tgts, rqvs, done),
            DK.control_step_plain(qpos, qvel, tgts[0], rqvs[0], **KW),
            DK.rollout_plain(qpos, qvel, tgts, rqvs, done, fall_height=FALL, **KW))


def check(dev, step_fn, roll_fn, what):
    """One B5 step (with the reward) and a T-3 B6 rollout at N 33 against the
    plain versions."""
    (qpos, qvel, tgts, rqvs, done), ref5, ref6 = check_case(dev)
    e5, ok5 = errors(step_fn(qpos, qvel, tgts[0], rqvs[0]), ref5)
    e6, ok6 = errors(roll_fn(qpos, qvel, tgts, rqvs, done), ref6)
    if not (ok5 and ok6):
        raise RuntimeError(f"{what} disagrees with the plain version: B5 {e5}, B6 {e6}")
    return {"b5": e5, "b6": e6}


def scaling(dev, roll_fn, flush):
    """B6 at T 20 at every N: ms and env-steps/s."""
    rows = []
    for n in SCALING_N:
        qpos, qvel, tgts, rqvs = walk_inputs(dev, n, T_MAIN)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        ms = time_ms(lambda: roll_fn(qpos, qvel, tgts, rqvs, done), flush,
                     reps=3 if n >= 16384 else 5, warmup=1)
        rows.append({"N": n, "ms": ms, "env_steps_per_s": n * T_MAIN / ms * 1e3})
    return rows


def control_step_times(dev, step_fn, flush, n=PROBE_N):
    qpos, qvel, tgts, rqvs = walk_inputs(dev, n, 1)
    return {"N": n,
            "with_reward_ms": time_ms(lambda: step_fn(qpos, qvel, tgts[0], rqvs[0]), flush,
                                      reps=10),
            "without_reward_ms": time_ms(lambda: step_fn(qpos, qvel, tgts[0]), flush, reps=10)}


def probe_phases(dev, roll_fn, lib, envs_per_warp):
    """The probe build's phases over one B6 launch at T 20, N 4096."""
    qpos, qvel, tgts, rqvs = walk_inputs(dev, PROBE_N, T_MAIN)
    done = torch.zeros(PROBE_N, dtype=torch.bool, device=dev)
    roll_fn(qpos, qvel, tgts, rqvs, done)  # loads the module
    torch.cuda.synchronize()
    if lib.hum_probe_reset():
        raise RuntimeError("hum_probe_reset failed")
    _, _, rewards, _ = roll_fn(qpos, qvel, tgts, rqvs, done)
    # an env runs the substeps of step t unless it was done before t (a done
    # env's reward is exactly 0); lane 0 of a warp runs its first env
    ran = 1 + (rewards[:-1] != 0).sum(0).cpu().numpy()
    return read_phases(lib, ran[::envs_per_warp])


def build_all(baseline: Path | None) -> dict:
    """Every library the sweep runs, built at once (one nvcc each)."""
    jobs = {"current": lambda: _build.build("humanoid_dynamics"),
            "current_probe": lambda: build_probe("humanoid_dynamics_probe",
                                                 probe_current_source())}
    if baseline is not None:
        jobs["baseline"] = lambda: _build.build("humanoid_dynamics_baseline", baseline)
        jobs["baseline_probe"] = lambda: build_probe("humanoid_dynamics_probe_baseline",
                                                     baseline_probe_source(baseline))
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def measure_baseline(dev, source: Path, libs, flush):
    so = libs["baseline"]
    base = OneThreadPerEnv(so)
    probe = OneThreadPerEnv(libs["baseline_probe"])
    probe.lib.hum_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    row = {"kernel": "baseline", "source": str(source), "ptxas": log_of(so),
           "check": check(dev, base.control_step, base.rollout, "the baseline")}
    row["control_step"] = control_step_times(dev, base.control_step, flush)
    row["rollout_t20"] = scaling(dev, base.rollout, flush)
    row["phases"] = probe_phases(dev, probe.rollout, probe.lib, 32)
    qpos, qvel, tgts, rqvs = walk_inputs(dev, PROBE_N, T_MAIN)
    done = torch.zeros(PROBE_N, dtype=torch.bool, device=dev)
    row["probe_ms"] = time_ms(lambda: probe.rollout(qpos, qvel, tgts, rqvs, done), flush, reps=3,
                              warmup=1)
    return row


def current_plans():
    """Every plan the kernels take: L lanes per env, blocks of 32-256 threads."""
    out = []
    for lanes in DK.LANE_COUNTS:
        for threads in (32, 64, 128, 256):
            try:
                out.append(DK.dynamics_plan(1, lanes, threads // lanes))
            except ValueError:
                pass
    return out


def probe_current_source() -> str:
    return PROBE_DECL + f'#include "{_build.CSRC / "humanoid_dynamics.cu"}"\n' + PROBE_API


def measure_current(dev, libs, flush):
    so = libs["current"]
    probe = DK.bind(ctypes.CDLL(str(libs["current_probe"])))
    probe.hum_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    plans = current_plans()
    row = {"kernel": "current", "ptxas": log_of(so),
           "default_plan_n4096": dataclasses.asdict(DK.dynamics_plan(PROBE_N)), "plans": []}
    for pl in plans:
        step = functools.partial(DK.control_step_cuda, plan=pl, **KW)
        roll = functools.partial(DK.rollout_cuda, plan=pl, fall_height=FALL, **KW)
        entry = {"lanes": pl.lanes, "envs": pl.envs, "threads": pl.threads,
                 "check": check(dev, step, roll, f"plan {pl}")}
        entry["control_step"] = control_step_times(dev, step, flush)
        entry["rollout_t20"] = scaling(dev, roll, flush)
        emit({"plan": {k: v for k, v in entry.items() if k != "check"}})
        row["plans"].append(entry)
    # the probe build's phases at each lane count's default block
    real = DK._library
    DK._library = lambda: probe
    try:
        row["phases"] = {}
        for lanes in DK.LANE_COUNTS:
            pl = DK.dynamics_plan(PROBE_N, lanes)
            roll = functools.partial(DK.rollout_cuda, plan=pl, fall_height=FALL, **KW)
            row["phases"][f"L{lanes}"] = probe_phases(dev, roll, probe, 32 // lanes)
            qpos, qvel, tgts, rqvs = walk_inputs(dev, PROBE_N, T_MAIN)
            done = torch.zeros(PROBE_N, dtype=torch.bool, device=dev)
            row["phases"][f"L{lanes}"]["probe_ms"] = time_ms(
                lambda: roll(qpos, qvel, tgts, rqvs, done), flush, reps=3, warmup=1)
    finally:
        DK._library = real
    return row


def summary(results):
    """The default plan's time over the baseline's at each N, B5 likewise."""
    base, cur = results["baseline"], results["current"]
    best = {}
    for entry in cur["plans"]:
        for r in entry["rollout_t20"]:
            if r["N"] not in best or r["ms"] < best[r["N"]][0]:
                best[r["N"]] = (r["ms"], entry["lanes"], entry["envs"])
    def entry(n):
        default = DK.dynamics_plan(n)
        return next(e for e in cur["plans"]
                    if (e["lanes"], e["envs"]) == (default.lanes, default.envs))

    out = {"rollout_t20": []}
    for i, rb in enumerate(base["rollout_t20"]):
        n = rb["N"]
        rd = entry(n)["rollout_t20"][i]
        out["rollout_t20"].append({"N": n, "baseline_ms": rb["ms"], "default_ms": rd["ms"],
                                   "default_plan": [entry(n)["lanes"], entry(n)["envs"]],
                                   "baseline_over_default": rb["ms"] / rd["ms"],
                                   "best_ms": best[n][0], "best_lanes_envs": best[n][1:]})
    d_entry = entry(PROBE_N)
    out["control_step_with_reward"] = {
        "baseline_ms": base["control_step"]["with_reward_ms"],
        "default_ms": d_entry["control_step"]["with_reward_ms"],
        "baseline_over_default": base["control_step"]["with_reward_ms"]
        / d_entry["control_step"]["with_reward_ms"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=None, help="an earlier csrc/humanoid_dynamics.cu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dynamics_sweep: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()  # the flush and spin kernels load here, not inside a timed window
    torch.cuda._sleep(1000)
    t0 = time.perf_counter()
    baseline = Path(args.baseline).resolve() if args.baseline else None
    built = _build.library_path("humanoid_dynamics").exists()
    libs = build_all(baseline)
    # nvcc's seconds for all the sweep's libraries at once (null where the
    # current library was built already)
    results = {"device": smi, "build_seconds": None if built else time.perf_counter() - t0}
    warm(dev)
    if baseline:
        results["baseline"] = measure_baseline(dev, baseline, libs, flush)
        emit({k: v for k, v in results["baseline"].items()})
    results["current"] = measure_current(dev, libs, flush)
    emit({k: v for k, v in results["current"].items() if k != "plans"})
    if args.baseline:
        results["speedup"] = summary(results)
        emit({"speedup": results["speedup"]})
    results["seconds"] = time.perf_counter() - t0
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
