"""Probes behind the design of K2 (csrc/presplit.cuh), on a machine with one
CUDA card; run from the root of the repository:

    python3 scripts/torch_k2_probe.py launches [--other-csrc DIR]
        K2's time a call (CUDA events), the wrapper's host time a call, and
        its device time by launch (torch.profiler, 20 calls) on the inputs
        of step 98 of chip_smoke.py's flagship and M=256 hybrid sweeps, for
        this build and, with --other-csrc, for a build of presplit.cu from
        another csrc directory (e.g. a parent commit's, from
        `git archive HEAD tensornetworkforml_torch/csrc`); and, as context,
        the five products K2 computes, each as one cuBLAS call (CUDA events)
    python3 scripts/torch_k2_probe.py bits --other-csrc DIR
        whether this K2 and K7 give the same bits as the builds of
        presplit.cu and two_site_step.cu from DIR: K2 on both captured steps
        and at a ragged shape, K7 at chip_smoke.py's four shapes, and the
        final f of one M=256 hybrid sweep
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tensornetworkforml_torch.ops.kernels import _build, presplit_kernel, step_kernel  # noqa: E402

REPS = 20


def other_libraries(tmp: str, csrc: str) -> dict:
    """presplit.cu and two_site_step.cu built from ``csrc``, bound like this
    build's libraries."""
    copy = os.path.join(tmp, "csrc")
    shutil.copytree(csrc, copy)
    libs = {}
    for name, module in (("presplit", presplit_kernel), ("two_site_step", step_kernel)):
        so = os.path.join(tmp, f"lib{name}_other.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               os.path.join(copy, f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}.cu from {csrc}:\n{proc.stderr[-4000:]}")
        lib, ref = ctypes.CDLL(so), module._lib()
        for sym in ("tnml_presplit", "tnml_presplit_scratch_floats", "tnml_two_site_step",
                    "tnml_step_scratch_floats", "tnml_cuda_error_string"):
            if hasattr(ref, sym) and getattr(ref, sym).argtypes is not None:
                getattr(lib, sym).argtypes = getattr(ref, sym).argtypes
                getattr(lib, sym).restype = getattr(ref, sym).restype
        libs[module] = lib
    return libs


class using:
    """Within the block, ``module``'s wrapper launches ``lib`` (None: this build)."""

    def __init__(self, module, lib):
        self.module, self.lib, self.own = module, lib, module._lib

    def __enter__(self):
        if self.lib is not None:
            self.module._lib = lambda: self.lib

    def __exit__(self, *exc):
        self.module._lib = self.own


def captured_steps():
    """chip_smoke.py's flagship and M=256 models and training batch, and the
    K2 inputs of step 98 of each one's hybrid sweep."""
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x_tr, y_tr = cs.pooled(cs.TRAIN_BATCHES * cs.BATCH, seed=cs.SEED + 2)
    xb = torch.as_tensor(x_tr[:cs.BATCH], device="cuda")
    yb = torch.as_tensor(y_tr[:cs.BATCH], device="cuda")
    flag = cs.product_init(torch.Generator().manual_seed(cs.SEED), N=cs.N, M=cs.M, D=cs.D,
                           L=cs.L, act_fn="linear", loss_fn="MSE",
                           calibration_x=requests[:512])
    wide = cs.wide_model(requests)
    steps = {f"flagship M={cs.M}": cs.capture_step(flag, xb, yb, cs.CAPTURE_STEP),
             f"M={cs.M_WIDE}": cs.capture_step(wide, xb, yb, cs.CAPTURE_STEP)}
    return steps, wide, xb, yb


def by_launch(fn) -> dict:
    """Device µs per call of each CUDA kernel ``fn`` launches, over REPS calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            out[ev.key] = us / REPS
    return out


def host_us(fn, n: int = 50) -> float:
    """Host µs per call of ``fn`` while the card keeps up: the wrapper's own
    cost, launches included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def short(name: str) -> str:
    found = re.search(r"presplit::(\w+)\(", name)
    return found.group(1) if found else name[:40]


def launches(other) -> None:
    steps, *_ = captured_steps()
    for what, cap in steps.items():
        args, kwargs = cap["k2"]
        builds = [("this K2", None)] + ([("other K2", other[presplit_kernel])] if other else [])
        for label, lib in builds:
            with using(presplit_kernel, lib):
                table = by_launch(lambda: presplit_kernel.two_site_presplit(*args, **kwargs))
                ms = cs.cuda_ms(lambda: presplit_kernel.two_site_presplit(*args, **kwargs))
                host = host_us(lambda: presplit_kernel.two_site_presplit(*args, **kwargs))
            parts = "; ".join(f"{short(k)} {v:.1f} us" for k, v in
                              sorted(table.items(), key=lambda kv: -kv[1]))
            print(f"[launches] {what} {label}: {ms * 1e3:.1f} us a call by CUDA events, host "
                  f"{host:.1f} us a call, device "
                  f"{sum(table.values()):.1f} us by launch: {parts}")
        lab, a2m, x1, x2, l_env, r_env, y1h, f, om, lr, wd = args
        bnew, _, _, _, left, _ = cap["k2_out"]
        B, I = left.shape
        L, _, DM = bnew.shape
        right = (x2[:, :, None] * r_env[:, None, :]).reshape(B, DM)
        w = right[None] * (y1h - f)[:, :, None]
        bmat = cap["bmat"]
        om_flat = om.reshape(L * DM, -1)
        products = {
            "lab_o a2m": lambda: lab @ a2m,
            "left^T (right ld)": lambda: left.T @ w,
            "bnew Omega": lambda: bmat @ om_flat,
            "bnew bnew^T": lambda: bmat @ bmat.T,
            "left bnew": lambda: left @ bnew,
        }
        times = {k: cs.cuda_ms(fn) for k, fn in products.items()}
        print(f"[cublas] {what}: " + "; ".join(f"{k} {v * 1e3:.1f} us" for k, v in times.items())
              + f"; together {sum(times.values()) * 1e3:.1f} us")


def same(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def bits(other) -> None:
    steps, wide, xb, yb = captured_steps()
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    rl, rm, rb, rq = 3, 5, 37, 5
    r = lambda *s: torch.randn(s, generator=gen).to("cuda")  # noqa: E731
    ragged = (r(rl, rm * cs.D, rm) / rm ** 0.5, r(rm, cs.D * rm) / rm ** 0.5,
              torch.rand((rb, cs.D), generator=gen).to("cuda"),
              torch.rand((rb, cs.D), generator=gen).to("cuda"), r(rb, rm), r(rb, rm),
              torch.eye(rl)[torch.randint(0, rl, (rb,), generator=gen)].T.contiguous().to("cuda"),
              0.3 * r(rl, rb), r(rl, cs.D * rm, rq), cs.LR, cs.WD)
    cases = [(what, cap["k2"]) for what, cap in steps.items()]
    cases.append((f"ragged L={rl} M={rm} B={rb}",
                  (ragged, dict(act_fn="softmax", loss_fn="cross_entropy", T=0.5))))
    names = ("bnew", "y0", "G", "f_new", "left_part", "stats")
    for what, (args, kwargs) in cases:
        outs = []
        for lib in (None, other[presplit_kernel]):
            with using(presplit_kernel, lib):
                outs.append(presplit_kernel.two_site_presplit(*args, **kwargs))
        diff = [n for n, a, b in zip(names, *outs) if not same(a, b)]
        print(f"[bits] K2 {what}: " + ("identical" if not diff else f"differ in {diff}"))

    sgen = torch.Generator().manual_seed(cs.SEED + 8)
    sargs = cs.step_args(steps[f"flagship M={cs.M}"])
    for what, a, kw in (
            (f"flagship step {cs.CAPTURE_STEP}", sargs, {}),
            (f"flagship step {cs.CAPTURE_STEP}, growth_cap=1e-3, renorm_envs", sargs,
             dict(growth_cap=1e-3, renorm_envs=True)),
            ("ragged L=10 M=48 B=100", cs.random_step_args(cs.L, 48, 100, sgen), {}),
            ("M=256 B=64, growth_cap=1e-3", cs.random_step_args(cs.L, 256, 64, sgen),
             dict(growth_cap=1e-3))):
        outs = []
        for lib in (None, other[step_kernel]):
            with using(step_kernel, lib):
                outs.append(step_kernel.two_site_step(*a, act_fn="linear", loss_fn="MSE", **kw))
        diff = [i for i, (x, y) in enumerate(zip(*outs)) if not same(x, y)]
        print(f"[bits] K7 {what}: " + ("identical" if not diff else f"outputs {diff} differ"))

    finals = []
    for lib in (None, other[presplit_kernel]):
        with using(presplit_kernel, lib):
            finals.append(cs.one_sweep(wide, xb, yb, "hybrid")[2])
    print(f"[bits] f_final of one M={cs.M_WIDE} hybrid sweep: "
          + ("identical" if same(*finals) else
             f"differ by {float((finals[0] - finals[1]).abs().max()):.3g}"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=("launches", "bits"))
    ap.add_argument("--other-csrc", help="a csrc directory to build the other K2 and K7 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("these probes need a CUDA card")
    if args.probe == "bits" and not args.other_csrc:
        raise SystemExit("bits needs --other-csrc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        other = other_libraries(tmp, args.other_csrc) if args.other_csrc else None
        (launches if args.probe == "launches" else bits)(other)


if __name__ == "__main__":
    main()
