"""Probes behind the design of K8 (tnml_polar_split in csrc/polar_iterate.cu),
the all-in-one polar split, on a machine with one CUDA card; run from the
root of the repository:

    python3 scripts/torch_k8_probe.py launches [--other-csrc DIR]
        on the two-site matrices of step 98 of chip_smoke.py's flagship and
        M=256 hybrid sweeps (I=256, J=2560, q=128 and I=512, J=5120, q=256):
        K8's device time by launch (torch.profiler over 20 calls: the tile
        launch, the fixed-order sum, K1's cluster launch, and the call's
        other device work, R = Q^T B), the
        device busy time and the span of one call from its profile, the
        call time by CUDA events, and the wrapper's host time a call (each
        call started on an idle card); for this build and, with
        --other-csrc, for polar_iterate.cu built from another csrc
        directory (e.g. a parent commit's, from
        `git archive HEAD tensornetworkforml_torch/csrc`)
    python3 scripts/torch_k8_probe.py time --other-csrc DIR
        at both shapes, by CUDA events in turns (other, this, two-stage,
        K1, K5, K5, K1, two-stage, this, other): the other build's K8, this
        K8, polar_split_two_stage, K1 alone on the step's own (y, G, n2) and
        K5 alone on the same matrix and Omega; then the kernels that share
        K8's code, this build and the other's in turns (other, this, this,
        other): K1 alone at both shapes, K5 alone at both shapes and at
        M=512 (I=1024, J=10240, q=512), K4a and K4b at M=512 (polar_sketch.cu
        built from DIR too; the M=512 inputs random, from a seed)
    python3 scripts/torch_k8_probe.py bits --other-csrc DIR
        whether this K8's Q and R are the other build's bit for bit at both
        shapes and at (96, 300, 48) with n_power=2, and polar_split_two_stage's
        at both shapes (J needs no pad for Omega there); and whether K1
        alone, K5 alone, K4a and K4b give the other build's bits at the
        shapes `time` runs them at
    python3 scripts/torch_k8_probe.py variants
        K8 built from patched copies of csrc/ (VARIANTS: no programmatic
        dependent launch, the scratch's parts on 16-byte instead of 256-byte
        boundaries, the chain's first launch with the attribute too), each
        in turns with this build at both shapes; then the device time by
        launch of the build without programmatic dependent launch, whose
        launches do not overlap
"""

from __future__ import annotations

import argparse
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
from tensornetworkforml_torch.ops import svd as svd_mod  # noqa: E402
from tensornetworkforml_torch.ops.kernels import _build, polar_split  # noqa: E402

REPS = 20


def short(name: str) -> str:
    """K8's launch a profiled kernel name belongs to, else the name, shortened."""
    for label, part in cs.K8_LAUNCHES:
        if f"::{part}(" in name or f"::{part}<" in name:
            return label
    if "Memcpy" in name or "memcpy" in name:
        return "copy " + name.split("(")[0][-24:]
    return re.sub(r"\s+", " ", name)[:36]


def shapes():
    """chip_smoke.py's flagship and M=256 models and training batch, and the
    two-site matrix and K1's inputs of step 98 of each one's hybrid sweep:
    label -> (bmat, rank, (y0, g, n2))."""
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x_tr, y_tr = cs.pooled(cs.TRAIN_BATCHES * cs.BATCH, seed=cs.SEED + 2)
    xb = torch.as_tensor(x_tr[:cs.BATCH], device="cuda")
    yb = torch.as_tensor(y_tr[:cs.BATCH], device="cuda")
    flag = cs.product_init(torch.Generator().manual_seed(cs.SEED), N=cs.N, M=cs.M, D=cs.D,
                           L=cs.L, act_fn="linear", loss_fn="MSE",
                           calibration_x=requests[:512])
    out = {}
    for m, model in ((cs.M, flag), (cs.M_WIDE, cs.wide_model(requests))):
        cap = cs.capture_step(model, xb, yb, cs.CAPTURE_STEP)
        I, J = cap["bmat"].shape
        out[f"M={m} (I={I} J={J} q={m})"] = (cap["bmat"], m, cap["k1"])
    return out


def other_build(csrc: str) -> None:
    """polar_iterate.cu built from a copy of ``csrc`` into chip_smoke.py's
    OTHER, bound like this build's library."""
    cs.OTHER_CSRC = csrc
    tmp = tempfile.mkdtemp()
    shutil.copytree(csrc, os.path.join(tmp, "csrc"))
    cs.OTHER["polar_iterate"] = cs.bind_other("polar_iterate",
                                              cs.build_other("polar_iterate", tmp))


def run(other: bool, fn):
    """``fn()`` with the other build of polar_iterate.cu (other) or this one."""
    if not other:
        return fn()
    with cs.using_other("polar_iterate"):
        return fn()


OTHER_SKETCH = {}  # "lib": polar_sketch.cu built from the other csrc directory


def other_sketch(csrc: str) -> None:
    """polar_sketch.cu (K4a, K4b, K5) built from a copy of ``csrc``, bound
    like this build's library."""
    import ctypes

    tmp = tempfile.mkdtemp()
    shutil.copytree(csrc, os.path.join(tmp, "csrc"))
    lib, ref = ctypes.CDLL(cs.build_other("polar_sketch", tmp)), polar_split._sketch_lib()
    for sym in [k for k in vars(ref) if k.startswith("tnml_")]:
        getattr(lib, sym).argtypes = getattr(ref, sym).argtypes
        getattr(lib, sym).restype = getattr(ref, sym).restype
    OTHER_SKETCH["lib"] = lib


def run_sketch(other: bool, fn):
    """``fn()`` with the other build of polar_sketch.cu (other) or this one;
    the scratch sizes are asked of the library that runs."""
    if not other:
        return fn()
    own = polar_split._sketch_lib
    polar_split._scratch_floats.cache_clear()
    polar_split._sketch_lib = lambda: OTHER_SKETCH["lib"]
    try:
        return fn()
    finally:
        polar_split._sketch_lib = own
        polar_split._scratch_floats.cache_clear()


def neighbours(cases) -> list:
    """The kernels that share K8's code, with their inputs: (what, runner,
    fn), runner choosing the build. K1 alone and K5 alone at the step shapes;
    K5, K4a and K4b at M=512 on random inputs from a seed."""
    out = []
    for what, (bmat, rank, (y0, g, n2)) in cases.items():
        om = svd_mod.rangefinder_omega(bmat.shape[1], rank, torch.float32, "cuda").contiguous()
        out.append((f"K1 alone {what}", run,
                    lambda y0=y0, g=g, n2=n2: (polar_split.polar_iterate(y0, g, n2),)))
        out.append((f"K5 alone {what}", run_sketch,
                    lambda b=bmat, om=om: polar_split.polar_sketch_gram(b, om)))
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    I, J, q = cs.M_LARGE * cs.D, cs.L * cs.D * cs.M_LARGE, cs.M_LARGE
    b = (torch.randn((I, J), generator=gen) / J ** 0.5).to("cuda")
    om = torch.randn((J, q), generator=gen).to("cuda")
    y1 = torch.randn((I, q), generator=gen).to("cuda")
    big = f"M={cs.M_LARGE} (I={I} J={J} q={q}, random)"
    out += [(f"K5 alone {big}", run_sketch, lambda: polar_split.polar_sketch_gram(b, om)),
            (f"K4a {big}", run_sketch, lambda: polar_split.gramfree_sketch(b, om)),
            (f"K4b {big}", run_sketch, lambda: (polar_split.gramfree_gmul(b, y1),))]
    return out


def by_launch(fn) -> dict:
    """Device µs a call of each name ``fn`` runs on the card, over REPS calls."""
    table = cs.device_time_table(lambda: [fn() for _ in range(REPS)])["by_kernel_ms"]
    out = {}
    for name, ms in table.items():
        key = short(name)
        out[key] = out.get(key, 0.0) + ms * 1e3 / REPS
    return out


def host_us(fn, n: int = 20) -> float:
    """The wrapper's host µs a call, each call started on an idle card (Omega's
    copy to the card synchronises inside the call)."""
    fn()
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / n * 1e6


def one_call(fn) -> tuple[float, float]:
    """Device busy µs (the union of the call's intervals) and the span from
    its first device event to its last, from one profiled call."""
    spans = [(a, b) for _, a, b in cs.device_time_table(fn, timeline=True)["intervals"]]
    return cs.union_ms(spans) * 1e3, max(b for _, b in spans) - min(a for a, _ in spans)


def launches(other: bool) -> None:
    for what, (bmat, rank, _) in shapes().items():
        for label, use in (("this K8", False),) + ((("other K8", True),) if other else ()):
            def k8():
                return polar_split.polar_split(bmat, rank)

            table = run(use, lambda: by_launch(k8))
            busy, span = run(use, lambda: one_call(k8))
            ms = run(use, lambda: cs.cuda_ms(k8, REPS))
            host = run(use, lambda: host_us(k8))
            parts = "; ".join(f"{k} {v:.1f} us" for k, v in
                              sorted(table.items(), key=lambda kv: -kv[1]))
            print(f"[launches] {what} {label}: {ms * 1e3:.1f} us a call by CUDA events; host "
                  f"{host:.1f} us a call; one profiled call busy {busy:.1f} us over a span of "
                  f"{span:.1f} us; device by name, a call: {parts}")
        J, q = bmat.shape[1], min(rank, bmat.shape[0])
        pad = polar_split._tile_j(bmat.shape[0], J)[2]
        omega = host_us(lambda: svd_mod.rangefinder_omega(J + pad, q, torch.float32, "cuda"))
        print(f"[launches] {what}: Omega's draw on the host and copy to the card alone "
              f"{omega:.1f} us a call (host)")


def time_builds() -> None:
    for what, (bmat, rank, (y0, g, n2)) in shapes().items():
        om = svd_mod.rangefinder_omega(bmat.shape[1], min(rank, bmat.shape[0]),
                                       torch.float32, "cuda").contiguous()
        fns = {
            "other K8": lambda: run(True, lambda: polar_split.polar_split(bmat, rank)),
            "this K8": lambda: polar_split.polar_split(bmat, rank),
            "two-stage": lambda: polar_split.polar_split_two_stage(bmat, rank),
            "K1 alone": lambda: polar_split.polar_iterate(y0, g, n2),
            "K5 alone": lambda: polar_split.polar_sketch_gram(bmat, om),
        }
        order = ("other K8", "this K8", "two-stage", "K1 alone", "K5 alone")
        got = {}
        for name in order + order[::-1]:
            got.setdefault(name, []).append(cs.cuda_ms(fns[name], 10) * 1e3)
        print(f"[time] {what}, us a call in turns: " + "; ".join(
            f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in got.items()))
    for what, runner, fn in neighbours(shapes()):
        t = [runner(o, lambda: cs.cuda_ms(fn, REPS)) * 1e3 for o in (True, False, False, True)]
        print(f"[time] {what}: this build {t[1]:.1f} / {t[2]:.1f} us, the other build's "
              f"{t[0]:.1f} / {t[3]:.1f} us (in turns)")


def same(a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def bits() -> None:
    steps = shapes()
    cases = [(what, bmat, rank, 1, True) for what, (bmat, rank, _) in steps.items()]
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    cases.append(("padded (96, 300, 48), n_power=2",
                  cs.gapped(96, 300, 48, gen).float().to("cuda"), 48, 2, False))
    for what, bmat, rank, n_power, two_stage in cases:
        mine = polar_split.polar_split(bmat, rank, n_power=n_power)
        theirs = run(True, lambda: polar_split.polar_split(bmat, rank, n_power=n_power))
        line = (f"[bits] K8 {what}: against the other build's Q "
                f"{'identical' if same(mine[0], theirs[0]) else 'differs'}, R "
                f"{'identical' if same(mine[1], theirs[1]) else 'differs'}")
        if two_stage:
            two = polar_split.polar_split_two_stage(bmat, rank)
            line += (f"; against polar_split_two_stage Q "
                     f"{'identical' if same(mine[0], two[0]) else 'differs'}, R "
                     f"{'identical' if same(mine[1], two[1]) else 'differs'}")
        print(line)
    for what, runner, fn in neighbours(steps):
        mine, theirs = runner(False, fn), runner(True, fn)
        diff = [i for i, (a, b) in enumerate(zip(mine, theirs)) if not same(a, b)]
        print(f"[bits] {what}: against the other build's "
              + ("identical" if not diff else f"outputs {diff} differ"))


# name -> (file, text, replacement) patches of csrc/; an edit to these lines
# must follow here
VARIANTS = {
    "no PDL": [("pdl.cuh", "cfg.numAttrs = pdl ? 1 : 0;", "cfg.numAttrs = 0;"),
               ("polar_iterate.cuh", "cfg.numAttrs = with_pdl ? 2 : 1;", "cfg.numAttrs = 1;")],
    "16-byte parts": [("layout.cuh", "constexpr long PART = 64;", "constexpr long PART = 4;")],
    "first launch with PDL": [(
        "tc_gemm.cuh",
        "  tc_sketch_gram_kernel<<<dim3(tiles, p.y.S), NT, SMEM_BYTES, stream>>>(p.y, p.g);\n"
        "  const cudaError_t err = cudaGetLastError();",
        "  const cudaError_t err = pdl::launch(tc_sketch_gram_kernel, dim3(tiles, p.y.S), NT,\n"
        "                                     SMEM_BYTES, stream, chained, p.y, p.g);")],
}


def variant(tmp: str, name: str) -> None:
    """polar_iterate.cu built from a copy of this csrc/ with ``name``'s
    patches, as chip_smoke.py's OTHER."""
    root = os.path.join(tmp, name.replace(" ", "_"))
    src = os.path.join(root, "csrc")
    shutil.copytree(str(_build.CSRC), src)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"variant {name!r}: {fname} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    cs.OTHER["polar_iterate"] = cs.bind_other("polar_iterate",
                                              cs.build_other("polar_iterate", root))


def variants() -> None:
    cases = shapes()
    for name in VARIANTS:
        variant(tempfile.mkdtemp(), name)
        for what, (bmat, rank, _) in cases.items():
            def k8():
                return polar_split.polar_split(bmat, rank)

            t = [run(o, lambda: cs.cuda_ms(k8, REPS)) * 1e3 for o in (True, False, False, True)]
            print(f"[variants] {name}, {what}: {t[0]:.1f} / {t[3]:.1f} us against this build's "
                  f"{t[1]:.1f} / {t[2]:.1f} (in turns)")
    variant(tempfile.mkdtemp(), "no PDL")
    for what, (bmat, rank, _) in cases.items():
        table = run(True, lambda: by_launch(lambda: polar_split.polar_split(bmat, rank)))
        print(f"[variants] no PDL, {what}, device us a call by name: " + "; ".join(
            f"{k} {v:.1f}" for k, v in sorted(table.items(), key=lambda kv: -kv[1])))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=("launches", "time", "bits", "variants"))
    ap.add_argument("--other-csrc", help="a csrc directory to build the other K8 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("these probes need a CUDA card")
    if args.probe in ("time", "bits") and not args.other_csrc:
        raise SystemExit(f"{args.probe} needs --other-csrc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.other_csrc:
        other_build(args.other_csrc)
        if args.probe in ("time", "bits"):
            other_sketch(args.other_csrc)
    {"launches": lambda: launches(bool(args.other_csrc)), "time": time_builds, "bits": bits,
     "variants": variants}[args.probe]()


if __name__ == "__main__":
    main()
