"""Probes behind the one-pass TF32 form of K4a and K4b (tnml_gramfree_sketch_tf32
and tnml_gramfree_gmul_tf32 in csrc/polar_sketch.cu, the pipeline of
csrc/tc_tf32.cuh), on a machine with one CUDA card; run from the root of the
repository:

    python3 scripts/torch_k4_probe.py check [--variant NAME ...]
        builds polar_sketch.cu (this build, or a patched copy per --variant,
        VARIANTS below), prints ptxas's report of the one-pass kernels, and
        holds the one-pass K4a and K4b against the plain product of their
        TF32-rounded operands (chip_smoke.py's ONE_PASS_PLAIN_TOL and
        ONE_PASS_TOL, n2 to RED_TOL) at the ragged (77, 1000, 47), the
        flagship (256, 2560, 128) and the M=512 (1024, 10240, 512) shapes, on
        random inputs from a seed, and two launches bit for bit
    python3 scripts/torch_k4_probe.py sass [--out DIR]
        this build's SASS of the one-pass GEMM kernels into DIR/k4_sass.txt
        and polar_sketch.cu's PTX into DIR/k4.ptx (DIR: the current
        directory), and each kernel's count of HGMMA and of the waits between
        them (WARPGROUP.DEPBAR, WARPGROUP.ARRIVE)
    python3 scripts/torch_k4_probe.py time [--variant NAME ...] [--other-csrc DIR]
        at M=512 by CUDA events in turns: each build's one-pass K4a and K4b
        (this one, each variant, and DIR's, e.g. a parent commit's from
        `git archive HEAD tensornetworkforml_torch/csrc`), the 3xTF32 form
        and cuBLAS in TF32 (`b @ om`, `b @ (b.T @ y1)`); then this build's
        device time by launch (torch.profiler over 20 calls), and
        gramfree_split at M=512 under "tensorfloat32" and "default": its time
        a call, its device busy time, K4a and K4b's share, the idle share
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
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tensornetworkforml_torch.ops.kernels import _build, polar_split  # noqa: E402
from tensornetworkforml_torch.utils.precision import matmul_precision  # noqa: E402

SHAPES = {"ragged": (77, 1000, 47), "flagship": (256, 2560, 128), "m512": (1024, 10240, 512)}
REPS = 20
HDR = "tc_tf32.cuh"
# name -> (file, pattern, replacement[, pattern, replacement ...]): a patched
# copy of csrc/ built beside this one
VARIANTS = {
    "stages3": (HDR, r"constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
    # no accumulator fences between a chunk's wgmma.fence and its commit
    "nofence": (HDR, r"tc::wgmma_fence\(\);\n      fence_acc\(d\);", "tc::wgmma_fence();",
                r"tc::wgmma_commit\(\);\n      fence_acc\(d\);", "tc::wgmma_commit();"),
    # K4a's converters wait and arrive but round nothing (wrong results: timing only)
    "noconvert": (HDR, r"for \(int i = i0; i < B_BYTES / 16; i \+= CONVERTERS\)",
                  "for (int i = i0; i < 0; i += CONVERTERS)"),
    # no setmaxnreg (every warp keeps the launch's 168 registers)
    "nosetmaxnreg": (HDR, r'asm volatile\("setmaxnreg\.inc\.sync\.aligned\.u32 %0;\\n" ::"n"\(CONSUMER_REGS\)\);', "",
                     r'asm volatile\("setmaxnreg\.dec\.sync\.aligned\.u32 %0;\\n" ::"n"\(PRODUCER_REGS\)\);', ""),
    # K4a on 128 x 256 tiles (as K4b), not 256 x 128
    "k4a_mw1": (HDR, r"const Gemm g = plan<2>\(q, I, J\);", "const Gemm g = plan<1>(q, I, J);",
                r"Gemm g = plan<2>\(q, I, J\);", "Gemm g = plan<1>(q, I, J);",
                r"return gemm<2, false, true, true, false>", "return gemm<1, false, true, true, false>"),
    # the plan counting 4 chunks of pipeline fill a block (8 in this build)
    "fill4": (HDR, r"constexpr int FILL = 8;", "constexpr int FILL = 4;"),
    # the k split at most a cluster's pair (no exchange in global memory)
    "pairs_only": (HDR, r"for \(int S = 1; S <= 8; S \*= 2\)", "for (int S = 1; S <= 2; S *= 2)"),
}

def build(csrc: str, tag: str):
    """polar_sketch.cu built from a copy of ``csrc`` (patched for variant
    ``tag`` when it names one): the library's path and nvcc's report."""
    tmp = tempfile.mkdtemp()
    dst = os.path.join(tmp, "csrc")
    shutil.copytree(csrc, dst)
    if tag in VARIANTS:
        fname, *subs = VARIANTS[tag]
        path = os.path.join(dst, fname)
        src = open(path).read()
        for pat, rep in zip(subs[::2], subs[1::2]):
            src, n = re.subn(pat, rep, src)
            if n != 1:
                sys.exit(f"variant {tag}: pattern {pat!r} matched {n} times in {fname}")
        open(path, "w").write(src)
    so = os.path.join(tmp, f"libpolar_sketch_{tag}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           os.path.join(dst, "polar_sketch.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"nvcc failed for {tag}: {proc.stderr[-3000:]}")
    return so, proc.stdout + proc.stderr


def bind(so: str):
    """The library at ``so``, bound like this build's."""
    lib, ref = ctypes.CDLL(so), polar_split._sketch_lib()
    for sym in [k for k in vars(ref) if k.startswith("tnml_")]:
        if hasattr(lib, sym):
            getattr(lib, sym).argtypes = getattr(ref, sym).argtypes
            getattr(lib, sym).restype = getattr(ref, sym).restype
    return lib


def report(tag: str, log: str) -> None:
    """ptxas's lines for the one-pass kernels (registers, spills, warnings)."""
    lines, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif fn and "tf1_" in fn and ("registers" in ln or "spill" in ln):
            lines.append(f"{fn[:60]}: {ln.split('ptxas info    : ')[-1].strip()}")
        if "arning" in ln or "setmaxnreg" in ln or "serializ" in ln:
            lines.append(ln.strip())
    print(f"[{tag}] ptxas: " + (" | ".join(lines) or "(no lines)"))


def inputs(shape):
    I, J, q = SHAPES[shape]
    g = torch.Generator().manual_seed(I)
    b = torch.randn((I, J), generator=g) / J ** 0.5
    if shape == "ragged":
        b[:, [0, 3, J - 1]] = 0.0
    om = torch.randn((J, q), generator=g)
    y1 = torch.linalg.qr(torch.randn((I, q), generator=g))[0].contiguous()
    return b.cuda(), om.cuda(), y1.cuda()


def call(lib, entry, b, x):
    """One call of ``entry`` of ``lib`` (either K4a or K4b, either form); the
    scratch sized by the library's own function."""
    (I, J), q = b.shape, x.shape[1]
    name = polar_split._SCRATCH[entry]
    if not hasattr(lib, name):
        name = cs.LEGACY_SCRATCH[entry]
    scratch = torch.empty(getattr(lib, name)(I, J, q), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if "sketch" in entry:
        y0 = torch.empty((I, q), device="cuda")
        n2 = torch.empty((1, 1), device="cuda")
        err = getattr(lib, entry)(b.data_ptr(), x.data_ptr(), y0.data_ptr(), n2.data_ptr(),
                                  scratch.data_ptr(), I, J, q, stream)
        out = (y0, n2)
    else:
        z = torch.empty((I, q), device="cuda")
        err = getattr(lib, entry)(b.data_ptr(), x.data_ptr(), z.data_ptr(), scratch.data_ptr(),
                                  I, J, q, stream)
        out = (z,)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return out


def check(lib, tag) -> bool:
    ok = True
    for shape in SHAPES:
        b, om, y1 = inputs(shape)
        (y0, n2), (z,) = call(lib, "tnml_gramfree_sketch_tf32", b, om), call(
            lib, "tnml_gramfree_gmul_tf32", b, y1)
        torch.cuda.synchronize()
        tf_y0, tf_z = cs.one_pass_plain(b, om, y1)
        b64 = b.double()
        f_y0, f_n2 = b64 @ om.double(), (b64 * b64).sum()
        f_z = b64 @ (b64.T @ y1.double())
        errs = []
        for got, tf, f64 in ((y0, tf_y0, f_y0), (z, tf_z, f_z)):
            scale = float(f64.abs().max())
            fin = bool(torch.isfinite(got).all())
            errs += [float((got.double() - tf).abs().max()) / scale if fin else float("nan"),
                     float((got.double() - f64).abs().max()) / scale if fin else float("nan")]
        n2_rel = abs(float(n2) - float(f_n2)) / float(f_n2)
        again = (torch.equal(call(lib, "tnml_gramfree_sketch_tf32", b, om)[0], y0)
                 and torch.equal(call(lib, "tnml_gramfree_gmul_tf32", b, y1)[0], z))
        good = (errs[0] <= cs.ONE_PASS_PLAIN_TOL and errs[1] <= cs.ONE_PASS_TOL
                and errs[2] <= cs.ONE_PASS_PLAIN_TOL and errs[3] <= cs.ONE_PASS_TOL
                and n2_rel <= cs.RED_TOL and again)
        ok = ok and good
        print(f"[{tag}] {shape} {SHAPES[shape]}: y0 vs TF32-rounded plain {errs[0]:.3g}, vs "
              f"float64 {errs[1]:.3g}; z {errs[2]:.3g}, {errs[3]:.3g}; n2 {n2_rel:.3g}; "
              f"repeat bit for bit {again} -> {'ok' if good else 'FAIL'}")
    return ok


def time_builds(builds) -> None:
    b, om, y1 = inputs("m512")
    fns = {}
    for tag, lib in builds.items():
        fns[f"{tag} K4a"] = lambda lib=lib: call(lib, "tnml_gramfree_sketch_tf32", b, om)
        fns[f"{tag} K4b"] = lambda lib=lib: call(lib, "tnml_gramfree_gmul_tf32", b, y1)

    def lib_y0():
        with matmul_precision("tensorfloat32"):
            return b @ om

    def lib_z():
        with matmul_precision("tensorfloat32"):
            return b @ (b.T @ y1)

    fns["3xTF32 K4a"] = lambda: polar_split.gramfree_sketch(b, om)
    fns["3xTF32 K4b"] = lambda: polar_split.gramfree_gmul(b, y1)
    fns["cuBLAS TF32 K4a"], fns["cuBLAS TF32 K4b"] = lib_y0, lib_z
    ms = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            ms[k].append(cs.cuda_ms(fns[k], REPS))
    for k, v in ms.items():
        print(f"[time] M=512 {k}: {v[0] * 1e3:.1f} / {v[1] * 1e3:.1f} us")
    this = builds["this"]
    for what, fn in (("K4a (the wrapper)", lambda: polar_split.gramfree_sketch_tf32(b, om)),
                     ("K4b (the wrapper)", lambda: polar_split.gramfree_gmul_tf32(b, y1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host = (time.perf_counter() - t0) / REPS * 1e6
        torch.cuda.synchronize()
        print(f"[host] {what}: {host:.1f} us of host time a call, issued back to back")
    for prec in ("tensorfloat32", "default"):
        def split():
            return polar_split.gramfree_split(b, 512, precision=prec)

        wall = cs.cuda_ms(split, 10)
        table = cs.device_time_table(lambda: [split() for _ in range(10)])["by_kernel_ms"]
        busy = sum(table.values()) / 10
        k4 = sum(v for k, v in table.items() if "tf1_" in k or "tc_gemm" in k
                 or "split_sum" in k) / 10
        print(f"[split] gramfree_split(precision={prec!r}) M=512: {wall * 1e3:.1f} us a call by "
              f"CUDA events, device busy {busy * 1e3:.1f} us (K4a and K4b {k4 * 1e3:.1f} us), "
              f"idle share {max(0.0, 1 - busy / wall):.3f}")
    for entry, x in (("tnml_gramfree_sketch_tf32", om), ("tnml_gramfree_gmul_tf32", y1)):
        table = cs.device_time_table(lambda: [call(this, entry, b, x) for _ in range(REPS)])
        print(f"[profile] {entry} device us a call by kernel: " + "; ".join(
            f"{k[:70]} {v * 1e3 / REPS:.2f}" for k, v in table["by_kernel_ms"].items()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["check", "time", "sass"])
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS))
    ap.add_argument("--other-csrc")
    ap.add_argument("--out", default=".", help="where sass writes its files")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), f"| torch {torch.__version__} CUDA {torch.version.cuda}")
    csrc = os.path.join(ROOT, "tensornetworkforml_torch", "csrc")
    jobs = [(tag, csrc) for tag in a.variant] + ([("other", a.other_csrc)] if a.other_csrc else [])
    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as pool:
        this = pool.submit(polar_split._sketch_lib)  # this build, through the package
        done = list(pool.map(lambda job: build(job[1], job[0]), jobs))
        builds = {"this": this.result()}
    logs = {"this": open(f"{_build.library_path('polar_sketch')}.log").read()}
    for (tag, _), (so, log) in zip(jobs, done):
        builds[tag], logs[tag] = bind(so), log
    for tag, log in logs.items():
        if tag != "other":
            report(tag, log)
    p = (ctypes.c_int * 6)()
    for what, mnk, mw in (("K4a", (512, 1024, 10240), 2), ("K4b first half", (10240, 512, 1024), 1),
                          ("K4b second half", (1024, 512, 10240), 1)):
        builds["this"].tnml_tf32_plan(*mnk, mw, p)
        print(f"[plan] {what} M, N, K = {mnk}: tiles {p[0]} x {p[1]} of {p[4]} x {p[5]}, k split "
              f"{p[2]}, {p[3]} chunks of 32 a split")
    if a.mode == "sass":
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", str(_build.library_path("polar_sketch"))],
                              capture_output=True, text=True, check=True).stdout
        keep, fn, counts = [], None, {}
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :")[-1].strip()
            if fn and "tf1_gemm_kernel" in fn:
                keep.append(ln)
                c = counts.setdefault(fn, {"HGMMA": 0, "DEPBAR": 0, "ARRIVE": 0})
                for k in c:
                    c[k] += k in ln
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "k4_sass.txt"), "w") as fh:
            fh.write("\n".join(keep))
        for fn, c in counts.items():
            print(f"[sass] {fn[-60:]}: {c}")
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([_build._nvcc(), *flags, "-ptx", "-o",
                        os.path.join(a.out, "k4.ptx"),
                        os.path.join(csrc, "polar_sketch.cu")], check=True)
        return
    if a.mode == "check":
        ok = all([check(lib, tag) for tag, lib in builds.items() if tag != "other"])
        sys.exit(0 if ok else 1)
    time_builds(builds)


if __name__ == "__main__":
    main()
