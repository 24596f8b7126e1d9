"""Probes behind the design of K7 (csrc/two_site_step.cu), the fused engine's
step, on a machine with one CUDA card; run from the root of the repository:

    python3 scripts/torch_k7_probe.py trace
        one profiled flagship fused sweep (N=196, M=128, L=10, B=256;
        torch.profiler with CPU and CUDA activities): the device gaps
        between K7's launches within a step and from one step's last launch
        to the next step's first, whether the host enqueued each launch
        before its predecessor ended (ahead) or after (behind), the host
        calls that sit between two steps' launches, and the sweep's
        unprofiled time and idle share beside the hybrid sweep's; the
        trace goes to --trace-out (results/k7_fused_sweep_trace.json)
    python3 scripts/torch_k7_probe.py time --other-csrc DIR
        K7 at flagship step 98 and at M=256 B=64, and K2, K1 and K8 at the
        flagship step, this build and the builds from another csrc
        directory (e.g. a parent commit's, from
        `git archive HEAD tensornetworkforml_torch/csrc`) in turns by CUDA
        events (other, this, this, other); then whole flagship sweeps in
        turns: the fused sweep through this build's sweep entry, through
        this build's K7 called step by step, through the other build's K7
        step by step (the parent's fused sweep), and the hybrid sweep
    python3 scripts/torch_k7_probe.py variants
        K7 built from patched copies of csrc/ (VARIANTS: the launches'
        dependent-launch trigger at the kernels' exit instead of their
        start, no programmatic dependent launch at all, the scratch's parts
        on 16-byte instead of 256-byte boundaries): the flagship step by
        CUDA events and the fused sweep through the sweep entry, each
        variant in turns with this build; the device time by launch of 20
        calls of the step without programmatic dependent launch
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tensornetworkforml_torch.ops.kernels import (  # noqa: E402
    _build,
    polar_split,
    presplit_kernel,
    step_kernel,
)


# K7's launches by the parts of their names, in the order a step runs them
K7_LAUNCHES = ("prep_kernel", "gradient_kernel", "update_kernel", "transpose_kernel",
               "products_kernel", "finish_kernel", "polar_cluster_kernel",
               "polar_streaming_kernel", "step_product_kernel", "step_scale_kernel",
               "step_env_kernel", "step_store_kernel")


def k7_launch(name: str):
    return next((p for p in K7_LAUNCHES if f"::{p}(" in name or f"::{p}<" in name), None)


def flagship():
    """chip_smoke.py's flagship model and its first training batch."""
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x_tr, y_tr = cs.pooled(cs.TRAIN_BATCHES * cs.BATCH, seed=cs.SEED + 2)
    xb = torch.as_tensor(x_tr[:cs.BATCH], device="cuda")
    yb = torch.as_tensor(y_tr[:cs.BATCH], device="cuda")
    mps = cs.product_init(torch.Generator().manual_seed(cs.SEED), N=cs.N, M=cs.M, D=cs.D,
                          L=cs.L, act_fn="linear", loss_fn="MSE", calibration_x=requests[:512])
    return mps, xb, yb


def sweep_ms(mps, xb, yb, engine) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs.one_sweep(mps, xb, yb, engine)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def stats(v) -> str:
    if not v:
        return "none"
    return (f"mean {statistics.mean(v):.2f} median {statistics.median(v):.2f} "
            f"max {max(v):.2f} us (n={len(v)})")


def trace(path: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    mps, xb, yb = flagship()
    for engine in ("fused", "hybrid"):
        cs.one_sweep(mps, xb, yb, engine)
    walls = {e: [] for e in ("fused", "hybrid")}
    for engine in ("fused", "hybrid", "hybrid", "fused"):
        walls[engine].append(sweep_ms(mps, xb, yb, engine))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cs.one_sweep(mps, xb, yb, "fused")
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]

    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
    first = next(i for i, k in enumerate(kernels) if k7_launch(k["name"]) == "prep_kernel")
    seq = kernels[first:]
    last = max(i for i, k in enumerate(seq) if k7_launch(k["name"]) is not None)
    seq = seq[: last + 1]
    print(f"[trace] {len(seq)} kernels in the sweep from its first K7 launch, "
          f"{sum(1 for k in seq if k7_launch(k['name']) == 'prep_kernel')} steps; kernel times "
          f"sum to {sum(k['dur'] for k in kernels) / 1e3:.1f} ms (every kernel of the profile)")

    # position of each kernel in its step: K7's launches by name, anything else 'other'
    steps, cur = [], None
    for k in seq:
        part = k7_launch(k["name"])
        if part == "prep_kernel":
            cur = []
            steps.append(cur)
        cur.append(k)
    within, between, between_other = {}, [], {}
    ahead = {"within": [0, 0], "between": [0, 0]}
    gap_host = {}
    for s, ks in enumerate(steps):
        if s > 0:
            prev = steps[s - 1][-1]
            # the last K7 launch of the previous step
            prev_k7 = next(k for k in reversed(steps[s - 1]) if k7_launch(k["name"]))
            between.append(ks[0]["ts"] - (prev_k7["ts"] + prev_k7["dur"]))
            for k in steps[s - 1]:
                if not k7_launch(k["name"]):
                    between_other.setdefault(k["name"][:60], []).append(k["dur"])
            launch = runtime.get(ks[0]["args"].get("correlation"))
            prev_launch = runtime.get(prev_k7["args"].get("correlation"))
            if launch is not None and prev_launch is not None:
                lo, hi = prev_launch["ts"] + prev_launch["dur"], launch["ts"]
                for op in cpu_ops:
                    if op["ts"] >= lo and op["ts"] + op["dur"] <= hi:
                        gap_host.setdefault(op["name"], []).append(op["dur"])
                ahead["between"][launch["ts"] + launch["dur"] < prev["ts"] + prev["dur"]] += 1
        k7 = [k for k in ks if k7_launch(k["name"])]
        for a, b in zip(k7, k7[1:]):
            key = f"{k7_launch(a['name'])} -> {k7_launch(b['name'])}"
            within.setdefault(key, []).append(b["ts"] - (a["ts"] + a["dur"]))
            launch = runtime.get(b["args"].get("correlation"))
            if launch is not None:
                ahead["within"][launch["ts"] + launch["dur"] < a["ts"] + a["dur"]] += 1
    # a negative gap: the launch started while its predecessor ran (a
    # programmatic dependent launch), its blocks resident and waiting
    for key, v in within.items():
        print(f"[trace] gap {key}: {stats(v)}")
    print(f"[trace] gap from a step's last K7 launch to the next step's first: {stats(between)}")
    period = [b[0]["ts"] - a[0]["ts"] for a, b in zip(steps, steps[1:])]
    print(f"[trace] from one step's first launch to the next step's first: {stats(period)}")
    print(f"[trace] device kernels between steps that are not K7's: " + (
        "; ".join(f"{k} {statistics.mean(v):.2f} us x {len(v)}"
                  for k, v in between_other.items()) or "none"))
    for where, (behind, ahead_n) in ahead.items():
        print(f"[trace] launches {where} steps: enqueued before the predecessor ended (host "
              f"ahead) {ahead_n}, after it had ended (host behind) {behind}")
    top = sorted(gap_host.items(), key=lambda kv: -sum(kv[1]))[:10]
    print("[trace] host calls between one step's last launch and the next step's first "
          "(total us / count a sweep): "
          + "; ".join(f"{k} {sum(v):.0f} / {len(v)}" for k, v in top))
    mid = steps[len(steps) // 2]
    t0 = mid[0]["ts"]
    line = []
    for k in mid:
        launch = runtime.get(k["args"].get("correlation"))
        host = f", enqueued at {launch['ts'] - t0:+.1f}" if launch else ""
        line.append(f"{(k7_launch(k['name']) or k['name'][:30])} at {k['ts'] - t0:.1f} for "
                    f"{k['dur']:.1f}{host}")
    print(f"[trace] step {len(steps) // 2} (us from its first launch): " + "; ".join(line))
    for engine, v in walls.items():
        print(f"[trace] {engine} sweep unprofiled {v[0]:.1f} / {v[1]:.1f} ms")
    fused = statistics.mean(walls["fused"])
    busy = cs.union_ms([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    k7 = cs.union_ms([(k["ts"], k["ts"] + k["dur"]) for k in seq])
    first_ts = min(e["ts"] for e in cpu_ops) if cpu_ops else kernels[0]["ts"]
    print(f"[trace] fused sweep: device busy {busy:.1f} ms (the union of kernel intervals; "
          f"from the first K7 launch on {k7:.1f} ms) of {fused:.1f} ms unprofiled, idle share "
          f"{max(0.0, 1 - busy / fused):.3f}; the first K7 launch starts "
          f"{(seq[0]['ts'] - first_ts) / 1e3:.1f} ms into the profiled sweep, with "
          f"{cs.union_ms([(k['ts'], k['ts'] + k['dur']) for k in kernels[:first]]):.1f} ms of "
          f"device work before it")


def other_build(csrc: str, names) -> None:
    """``names`` built from a copy of ``csrc`` into chip_smoke.py's OTHER,
    bound like this build's libraries."""
    tmp = tempfile.mkdtemp()
    shutil.copytree(csrc, os.path.join(tmp, "csrc"))
    for name in names:
        cs.OTHER[name] = cs.bind_other(name, cs.build_other(name, tmp))


def run(name, other: bool, fn):
    """``fn()`` with the other build of ``name`` (other) or with this one."""
    if not other:
        return fn()
    with cs.using_other(name):
        return fn()


def in_turns(what, name, fn, reps=20) -> None:
    o1, t1, t2, o2 = (run(name, o, lambda: cs.cuda_ms(fn, reps))
                      for o in (True, False, False, True))
    print(f"[time] {what}: this build {t1 * 1e3:.1f} / {t2 * 1e3:.1f} us, the other "
          f"{o1 * 1e3:.1f} / {o2 * 1e3:.1f} us (in turns)")


def time_builds() -> None:
    mps, xb, yb = flagship()
    cap = cs.capture_step(mps, xb, yb, cs.CAPTURE_STEP)
    sargs = cs.step_args(cap)
    gen = torch.Generator().manual_seed(cs.SEED + 8)
    cs.random_step_args(cs.L, 48, 100, gen)  # chip_smoke.py's draw order
    wide = cs.random_step_args(cs.L, 256, 64, gen)
    for what, a, kw in ((f"K7 flagship step {cs.CAPTURE_STEP}", sargs, {}),
                        ("K7 M=256 B=64, growth_cap=1e-3", wide, dict(growth_cap=1e-3))):
        in_turns(what, "two_site_step", lambda: step_kernel.two_site_step(*a, **kw), reps=10)
    args, kwargs = cap["k2"]
    in_turns("K2 flagship", "presplit", lambda: presplit_kernel.two_site_presplit(*args, **kwargs))
    y0, g, n2 = cap["k1"]
    in_turns("K1 flagship", "polar_iterate", lambda: polar_split.polar_iterate(y0, g, n2), reps=10)
    in_turns("K8 flagship", "polar_iterate", lambda: polar_split.polar_split(cap["bmat"], cs.M),
             reps=10)

    # whole flagship sweeps: this build's sweep entry, this build's K7 called
    # step by step (the parent's loop), the other build's K7 so (the parent's
    # fused sweep), and the hybrid sweep, in turns
    def loop(*a, **k):
        return step_kernel.two_site_sweep_reference(*a, step=step_kernel.two_site_step, **k)

    def fused(kind):
        if kind == "entry":
            return sweep_ms(mps, xb, yb, "fused")
        with mock.patch.object(cs.sweep_mod, "two_site_sweep", loop):
            return run("two_site_step", kind == "other", lambda: sweep_ms(mps, xb, yb, "fused"))

    kinds = ("other", "loop", "entry", "hybrid", "hybrid", "entry", "loop", "other")
    for kind in kinds[:4]:  # warm
        fused(kind) if kind != "hybrid" else sweep_ms(mps, xb, yb, "hybrid")
    got = {}
    for kind in kinds:
        got.setdefault(kind, []).append(
            fused(kind) if kind != "hybrid" else sweep_ms(mps, xb, yb, "hybrid"))
    names = {"entry": "fused, this build's sweep entry", "loop": "fused, this K7 step by step",
             "other": "fused, the other build's K7 step by step", "hybrid": "hybrid"}
    print("[time] flagship sweeps in turns (ms): " + "; ".join(
        f"{names[k]} {v[0]:.1f} / {v[1]:.1f}" for k, v in got.items()))


# name -> (file, text, replacement) patches of csrc/; an edit to these lines
# must follow here
VARIANTS = {
    "trigger at exit": [
        ("pdl.cuh", '  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n', "")],
    "no PDL": [("pdl.cuh", "cfg.numAttrs = pdl ? 1 : 0;", "cfg.numAttrs = 0;"),
               ("polar_iterate.cuh", "cfg.numAttrs = with_pdl ? 2 : 1;", "cfg.numAttrs = 1;")],
    "16-byte parts": [
        ("layout.cuh", "constexpr long PART = 64;", "constexpr long PART = 4;")],
}


def variant_lib(tmp: str, name: str):
    """two_site_step.cu built from a copy of this csrc/ with ``name``'s patches."""
    root = os.path.join(tmp, name.replace(" ", "_"))
    src = os.path.join(root, "csrc")
    shutil.copytree(str(_build.CSRC), src)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"variant {name!r}: {fname} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    return cs.bind_other("two_site_step", cs.build_other("two_site_step", root))


def variants() -> None:
    from torch.profiler import ProfilerActivity, profile

    mps, xb, yb = flagship()
    cap = cs.capture_step(mps, xb, yb, cs.CAPTURE_STEP)
    sargs = cs.step_args(cap)
    tmp = tempfile.mkdtemp()
    libs = {name: variant_lib(tmp, name) for name in VARIANTS}
    step = lambda: step_kernel.two_site_step(*sargs)  # noqa: E731
    for name, lib in libs.items():
        cs.OTHER["two_site_step"] = lib

        def sweep():
            sweep_ms(mps, xb, yb, "fused")
            return sweep_ms(mps, xb, yb, "fused")

        turns = (True, False, False, True)
        s = [run("two_site_step", o, lambda: cs.cuda_ms(step, 20)) for o in turns]
        w = [run("two_site_step", o, sweep) for o in turns]
        print(f"[variants] {name}: K7 flagship step {s[0] * 1e3:.1f} / {s[3] * 1e3:.1f} us "
              f"against this build's {s[1] * 1e3:.1f} / {s[2] * 1e3:.1f}; fused sweep "
              f"{w[0]:.1f} / {w[3]:.1f} ms against {w[1]:.1f} / {w[2]:.1f}")
    cs.OTHER["two_site_step"] = libs["no PDL"]
    with cs.using_other("two_site_step"):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                step()
            torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        part = k7_launch(ev.key)
        if part and us > 0:
            parts.append((part, us / 20))
    print("[variants] no PDL, device us a call by launch: " + "; ".join(
        f"{p} {us:.1f}" for p, us in parts) + f"; {sum(us for _, us in parts):.1f} in all")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=("trace", "time", "variants"))
    ap.add_argument("--other-csrc", help="a csrc directory to build the other kernels from")
    ap.add_argument("--trace-out",
                    default=os.path.join(ROOT, "results", "k7_fused_sweep_trace.json"),
                    help="where trace writes the profiled sweep's trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("these probes need a CUDA card")
    if args.probe == "time" and not args.other_csrc:
        raise SystemExit("time needs --other-csrc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.other_csrc:
        cs.OTHER_CSRC = args.other_csrc
        other_build(args.other_csrc, ("two_site_step", "presplit", "polar_iterate"))
    if args.probe == "trace":
        trace(args.trace_out)
    else:
        {"time": time_builds, "variants": variants}[args.probe]()


if __name__ == "__main__":
    main()
