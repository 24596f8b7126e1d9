"""Probes behind the design of K1's cluster form (csrc/polar_iterate.cuh), on
a machine with one CUDA card; run from the root of the repository:

    python3 scripts/torch_k1_probe.py bandwidth
        how fast a CTA of a 16-CTA cluster reads data other CTAs produced:
        through distributed shared memory, from L2 by ld.global.cg and by
        cp.async, and by TMA bulk copies (the same 64 KB in every CTA, 64 KB
        of its own, multicast); what a cluster barrier costs
        (scripts/torch_k1_probe.cu)
    python3 scripts/torch_k1_probe.py edge [--other-csrc DIR] [--single-chain]
        K1 on the inputs of the M=256 hybrid sweep's rank-deficient edge
        steps (and steps 98 and 150), taken from the sweep through the plain
        versions: the live columns (norm > 0.5) and |Q Q^T B - Q64 Q64^T B| /
        max|B| of the plain float32 version, of K1, and of another build of
        polar_iterate.cu (--other-csrc: a csrc directory, e.g. a parent
        commit's; --single-chain: this K1 with each output summed in one FMA
        chain instead of chunk by chunk), against a float64 run
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tensornetworkforml_torch.ops.kernels import _build, polar_split  # noqa: E402
from tensornetworkforml_torch.ops.kernels import presplit_kernel  # noqa: E402

# the edit that turns K1's chunk-by-chunk sums back into one FMA chain per output
SINGLE_CHAIN = ("      for (int j = 0; j < RN; ++j) sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);",
                "      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);")


def nvcc(out: str, source: str) -> None:
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")


def timed(fn) -> float:
    """ms of one call of ``fn`` after a warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bandwidth(tmp: str) -> None:
    so = os.path.join(tmp, "libk1probe.so")
    nvcc(so, os.path.join(ROOT, "scripts", "torch_k1_probe.cu"))
    lib = ctypes.CDLL(so)
    for fn in (lib.read_bench, lib.tma_bench):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.sync_bench.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    src = torch.randn(16 * 8192 * 4, device="cuda")  # 2 MB: stays in L2
    out = torch.empty(16 * 256, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        err = fn(*args)
        if err != 0:
            raise SystemExit(f"launch failed: cudaError {err}")

    for C in (2, 8, 16):
        for mode, route in ((0, "distributed shared memory"), (1, "L2, ld.global.cg"),
                            (2, "L2, cp.async")):
            reps = 10
            ms = timed(lambda: call(lib.read_bench, src.data_ptr(), out.data_ptr(), C, reps,
                                    mode, st))
            per_cta = reps * (C - 1) * 8192 * 16
            print(f"[read] cluster of {C}, {route}: {per_cta / ms / 1e6:.1f} GB/s per CTA")
        reps = 2000
        ms = timed(lambda: call(lib.sync_bench, out.data_ptr(), C, reps, st))
        print(f"[sync] cluster of {C}: {ms * 1e3 / reps:.3f} us per cluster barrier")
    for mode, what in ((0, "the same 64 KB in every CTA"), (1, "64 KB of its own"),
                       (2, "multicast, 1/16 from each CTA to all")):
        reps = 200
        ms = timed(lambda: call(lib.tma_bench, src.data_ptr(), out.data_ptr(), 16, reps, mode,
                                st))
        print(f"[tma] cluster of 16, {what}: {ms * 1e3 / reps:.2f} us per 64 KB bulk copy and "
              f"cluster barrier")


def other_library(tmp: str, csrc: str | None, single_chain: bool):
    """A build of polar_iterate.cu from ``csrc`` (or this one, edited to one
    FMA chain), bound like polar_split._lib(); None if neither is asked for."""
    if csrc is None and not single_chain:
        return None
    copy = os.path.join(tmp, "csrc")
    shutil.copytree(csrc or _build.CSRC, copy)
    if single_chain:
        path = os.path.join(copy, "polar_iterate.cuh")
        text = open(path).read()
        if SINGLE_CHAIN[0] not in text:
            raise SystemExit("--single-chain: the sum this edits is not in polar_iterate.cuh")
        open(path, "w").write(text.replace(*SINGLE_CHAIN))
    so = os.path.join(tmp, "libpolar_other.so")
    nvcc(so, os.path.join(copy, "polar_iterate.cu"))
    lib = ctypes.CDLL(so)
    ref = polar_split._lib()
    for name in ("tnml_polar_iterate", "tnml_polar_scratch_floats", "tnml_cuda_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    return lib


def edge(other) -> None:
    """K1, its plain version and ``other`` at the M=256 sweep's edge steps,
    on chip_smoke.py's model and batch."""
    import chip_smoke as cs
    from tensornetworkforml_torch.train import sweep as sweep_mod
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x_tr, y_tr = cs.pooled(cs.TRAIN_BATCHES * cs.BATCH, seed=cs.SEED + 2)
    xb = torch.as_tensor(x_tr[:cs.BATCH], device="cuda")
    yb = torch.as_tensor(y_tr[:cs.BATCH], device="cuda")
    wide = cs.wide_model(requests)
    steps, caps, last_b = [0], {}, {}

    def k2(*args, **kwargs):
        want = presplit_kernel.two_site_presplit_reference(*args, **kwargs)
        last_b["b"] = want[0].permute(1, 0, 2).reshape(want[0].shape[1], -1)
        return want

    def k1(y0, g, n2=None):
        i = steps[0]
        steps[0] += 1
        if i in (1, 2, 3, 5, 8, 98, 150, 194):
            caps[i] = (y0.clone(), g.clone(), None if n2 is None else n2.clone(), last_b["b"])
        return polar_split.polar_iterate_reference(y0, g, n2)

    with mock.patch.object(sweep_mod, "two_site_presplit", k2), \
            mock.patch.object(sweep_mod, "polar_iterate", k1):
        cs.one_sweep(wide, xb, yb, "hybrid")
    own = polar_split._lib()
    runs = [("plain float32", None), ("K1", own)] + ([("other K1", other)] if other else [])
    for i, (y0, g, n2, b) in caps.items():
        q64 = polar_split.polar_iterate_reference(y0.double(), g.double(),
                                                  None if n2 is None else n2.double())
        b64 = b.double()
        exact = q64 @ (q64.T @ b64)
        parts = [f"float64 live {int((torch.linalg.vector_norm(q64, dim=0) > 0.5).sum())}"]
        for name, lib in runs:
            if lib is None:
                q = polar_split.polar_iterate_reference(y0, g, n2)
            else:
                polar_split._lib = (lambda lib=lib: lib)
                q = polar_split.polar_iterate(y0, g, n2)
            torch.cuda.synchronize()
            q = q.double()
            dist = float((q @ (q.T @ b64) - exact).abs().max() / b64.abs().max())
            live = int((torch.linalg.vector_norm(q, dim=0) > 0.5).sum())
            parts.append(f"{name} live {live}, distance {dist:.3g}")
        print(f"[edge] M=256 step {i}: " + "; ".join(parts))
    polar_split._lib = lambda: own


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=("bandwidth", "edge"))
    ap.add_argument("--other-csrc", help="a csrc directory to build the other K1 from")
    ap.add_argument("--single-chain", action="store_true",
                    help="the other K1: this one with one FMA chain per output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("these probes need a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        if args.probe == "bandwidth":
            bandwidth(tmp)
            return
        other = other_library(tmp, args.other_csrc, args.single_chain)
        edge(other)


if __name__ == "__main__":
    main()
