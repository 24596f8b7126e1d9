"""Probes behind the design of K3 (csrc/env_scan.cu), on a machine with one
CUDA card; run from the root of the repository:

    python3 scripts/torch_k3_probe.py forms
        every instantiated form (latency: 8-sample tiles on clusters of C = 1
        to 4 CTAs, 12 warps at C=3 and 8 else; throughput) on chip_smoke.py's
        flagship chain at B=256, B=240 (the last batch whose clusters of 4
        the card holds at once), B=248 and
        B=8192 and on the M=512 chain at B=256: its error against the
        float64 plain version (of max|v|) and its time a call and a site
        (CUDA events); then the form the kernel picks at a list of shapes,
        against the Python mirror ops.kernels.env_scan.plan
    python3 scripts/torch_k3_probe.py bits [--other-csrc DIR]
        whether two calls give the same bits, and the error against the
        float64 plain version, at the serving shapes, a ragged shape, B=1,
        the throughput switch and M=512; with --other-csrc, beside the error
        of env_scan.cu built from another csrc directory (e.g. the parent
        commit's, from `git archive HEAD tensornetworkforml_torch/csrc`)
    python3 scripts/torch_k3_probe.py time --other-csrc DIR
        this K3 and the other build's at B=256 and B=8192: the call time by
        CUDA events in turns (other, this, this, other) and the device time
        by launch (torch.profiler over 20 calls)
    python3 scripts/torch_k3_probe.py ablate
        where a site's time goes: builds of env_scan.cu with one piece taken
        out (A's loads and copies; the cluster barrier and the stores into
        the other CTAs, replaced by a CTA barrier and local stores; both; the
        products and the epilogue), timed a site at the flagship's B=256
        (clusters of 3), B=240 (clusters of 4) and B=8192 (the throughput
        form). Their outputs are wrong by design; only the times are read.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tensornetworkforml_torch.ops.kernels import _build, env_scan  # noqa: E402

REPS = 20
# the instantiated forms: (form, C, BT)
CANDIDATES = [(env_scan.LATENCY, c, 8) for c in (1, 2, 3, 4)] + [(env_scan.THROUGHPUT, 1, 64)]


def call(lib, sites, x, form=None) -> torch.Tensor:
    """One launch of ``lib``'s chain on ``sites`` and ``x`` (rows strided),
    in ``form`` = (form, C, BT) or the one the library picks."""
    n, M, B = sites.shape[0], sites.shape[1], x.shape[0]
    out = torch.empty((B, M), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (sites.data_ptr(), x.data_ptr(), x.stride(0), out.data_ptr(), n, M, B, stream)
    err = (lib.tnml_right_env_chain(*args) if form is None
           else lib.tnml_right_env_chain_as(*form, *args))
    if err != 0:
        raise RuntimeError(f"cudaError {err} ({lib.tnml_cuda_error_string(err).decode()})")
    return out


def chains():
    """chip_smoke.py's flagship chain and requests, and the M=512 chain."""
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x = torch.as_tensor(requests, device="cuda")
    flag = cs.product_init(torch.Generator().manual_seed(cs.SEED), N=cs.N, M=cs.M, D=cs.D,
                           L=cs.L, act_fn="linear", loss_fn="MSE",
                           calibration_x=requests[:512])
    big = cs.large_model(requests)
    return {f"M={cs.M}": flag.sites[1:], f"M={cs.M_LARGE}": big.sites[1:]}, x[:, 1:]


def ragged(n, M, B, seed):
    gen = torch.Generator().manual_seed(seed)
    sites = (torch.randn((n + 1, M, 2, M), generator=gen) / M ** 0.5).to("cuda")[1:]
    return sites, torch.rand((B, n + 1), generator=gen).to("cuda")[:, 1:]


def error(got, sites, x) -> float:
    want = env_scan.right_env_chain_reference(sites.double(), x.double())
    return float((got.double() - want).abs().max() / want.abs().max())


def form_name(form) -> str:
    kind, C, BT = form
    return f"{env_scan.FORMS[kind]} C={C} BT={BT}"


def forms(_other) -> None:
    lib = env_scan._lib()
    stacks, x = chains()
    for what, sites, B in ((f"M={cs.M}", stacks[f"M={cs.M}"], cs.BATCH),
                           (f"M={cs.M}", stacks[f"M={cs.M}"], 240),
                           (f"M={cs.M}", stacks[f"M={cs.M}"], 248),
                           (f"M={cs.M}", stacks[f"M={cs.M}"], cs.BIG),
                           (f"M={cs.M_LARGE}", stacks[f"M={cs.M_LARGE}"], cs.BATCH)):
        n = sites.shape[0]
        picked = env_scan.kernel_plan(sites.shape[1], B)
        print(f"[forms] {what} n={n} B={B}: the kernel picks {picked}")
        for form in CANDIDATES:
            try:
                got = call(lib, sites, x[:B], form)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                print(f"[forms]   {form_name(form)}: not taken ({exc})")
                continue
            ms = cs.cuda_ms(lambda: call(lib, sites, x[:B], form), REPS)
            print(f"[forms]   {form_name(form)}: err {error(got, sites, x[:B]):.3g} of max|v|, "
                  f"{ms * 1e3:.1f} us a call, {ms * 1e3 / n:.3f} us a site")
    rs, rx = ragged(21, 130, 37, 3)
    for form in CANDIDATES:
        got = call(lib, rs, rx, form)
        print(f"[forms] ragged M=130 n=21 B=37 {form_name(form)}: "
              f"err {error(got, rs, rx):.3g} of max|v|")
    sms, clusters = env_scan.kernel_card()
    mismatch = []
    for M in (1, 5, 31, 32, 64, 127, 128, 130, 300, 512, 2248):
        for B in (1, 8, 37, 240, 248, 256, 264, 1056, 4160, 4161, 8192):
            if env_scan.kernel_plan(M, B) != env_scan.plan(M, B, sms, clusters):
                mismatch.append((M, B))
    print(f"[forms] the card: {sms} SMs, holding {clusters} clusters of 2, 3 and 4 CTAs; "
          f"the kernel's plan against the Python mirror at 121 shapes: "
          + ("all agree" if not mismatch else f"differ at {mismatch}"))


def bits(other) -> None:
    lib = env_scan._lib()
    stacks, x = chains()
    cases = [(f"M={cs.M} B={B}", stacks[f"M={cs.M}"], x[:B]) for B in (1, cs.BATCH, 4160, 4161,
                                                                      cs.BIG)]
    cases.append((f"M={cs.M_LARGE} B={cs.BATCH}", stacks[f"M={cs.M_LARGE}"], x[:cs.BATCH]))
    cases.append(("ragged M=5 n=21 B=37", *ragged(21, 5, 37, 1)))
    cases.append(("ragged M=130 n=21 B=37", *ragged(21, 130, 37, 3)))
    for what, sites, xs in cases:
        first, second = call(lib, sites, xs), call(lib, sites, xs)
        same = bool(torch.equal(first.view(torch.int32), second.view(torch.int32)))
        line = (f"[bits] {what} ({env_scan.kernel_plan(sites.shape[1], xs.shape[0])['form']}): "
                f"repeat {'identical' if same else 'DIFFERS'}, err {error(first, sites, xs):.3g}")
        if other is not None:
            line += f", the other build's err {error(call(other, sites, xs), sites, xs):.3g}"
        print(line + " of max|v| against float64")


def by_launch(fn) -> dict:
    """Device µs a call of each CUDA kernel ``fn`` launches, over REPS calls."""
    table = cs.device_time_table(lambda: [fn() for _ in range(REPS)])["by_kernel_ms"]
    return {k[:60]: v * 1e3 / REPS for k, v in table.items()}


def time_builds(other) -> None:
    lib = env_scan._lib()
    stacks, x = chains()
    sites = stacks[f"M={cs.M}"]
    for B in (cs.BATCH, cs.BIG):
        xs = x[:B]
        this_fn, other_fn = (lambda: call(lib, sites, xs)), (lambda: call(other, sites, xs))
        o1, t1 = cs.cuda_ms(other_fn, REPS), cs.cuda_ms(this_fn, REPS)
        t2, o2 = cs.cuda_ms(this_fn, REPS), cs.cuda_ms(other_fn, REPS)
        print(f"[time] B={B} ({env_scan.kernel_plan(cs.M, B)['form']}): this K3 "
              f"{t1 * 1e3:.1f} / {t2 * 1e3:.1f} us, the other build {o1 * 1e3:.1f} / "
              f"{o2 * 1e3:.1f} us a call (CUDA events, in turns)")
        for label, fn in (("this", this_fn), ("other", other_fn)):
            table = by_launch(fn)
            print(f"[time] B={B} {label} build, device time by launch: " + "; ".join(
                f"{k} {v:.1f} us" for k, v in table.items()))


# ablations: (text in csrc/env_scan.cu, its replacement)
_NO_A = [("        fill<NT, RP, KC, F::SR>(ring + ps * L.stage_floats, pA, a, r0 + pp * RP, r1, "
          "pc * KC);", ""),
         ("            F::load(frag, pA, a, r0 + pp * RP, r1, pc * KC);", "")]
_LOCAL = [('asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");',
           "__syncthreads();"),
          ('asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");', ";"),
          ("        for (int q = 0; q < C; ++q) *cl.map_shared_rank(dst, q) = out;",
           "        *dst = out;")]
_NO_PRODUCTS = [("        if (c == NC - 1) F::epilogue(", "        if (0) F::epilogue(")]
_NO_PIXELS = [("            xr = x_at(a, b0 + threadIdx.x, a.n - 3 - t);", "")]
ABLATIONS = {"as built": [], "no loads of A": _NO_A, "no pixel loads in the walk": _NO_PIXELS,
             "CTA barrier, local stores": _LOCAL,
             "CTA barrier, local stores, no loads of A": _LOCAL + _NO_A,
             "no products (nor epilogue)": _NO_PRODUCTS}


def ablate(_other) -> None:
    from concurrent.futures import ThreadPoolExecutor

    src = os.path.join(ROOT, "tensornetworkforml_torch", "csrc")
    ref = env_scan._lib()
    tmp = tempfile.mkdtemp()

    def build(name):
        d = os.path.join(tmp, str(list(ABLATIONS).index(name)))
        shutil.copytree(src, d)
        path = os.path.join(d, "env_scan.cu")
        text = open(path).read()
        for old, new in ABLATIONS[name]:
            if old not in text:
                raise SystemExit(f"ablation {name!r}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        so = os.path.join(d, "lib.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on ablation {name!r}:\n{proc.stderr[-3000:]}")
        lib = ctypes.CDLL(so)
        for sym in ("tnml_right_env_chain_as", "tnml_cuda_error_string"):
            getattr(lib, sym).argtypes = getattr(ref, sym).argtypes
            getattr(lib, sym).restype = getattr(ref, sym).restype
        return name, lib

    with ThreadPoolExecutor(len(ABLATIONS)) as pool:
        libs = list(pool.map(build, ABLATIONS))
    stacks, x = chains()
    sites = stacks[f"M={cs.M}"]
    n = sites.shape[0]
    cases = (((env_scan.LATENCY, 3, 8), cs.BATCH), ((env_scan.LATENCY, 4, 8), 240),
             ((env_scan.THROUGHPUT, 1, 64), cs.BIG))
    for name, lib in libs:
        times = [cs.cuda_ms(lambda: call(lib, sites, x[:B], form), REPS) * 1e3 / n
                 for form, B in cases]
        print(f"[ablate] {name}: " + ", ".join(
            f"{form_name(form)} B={B} {t:.3f} us a site" for (form, B), t in zip(cases, times)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("probe", choices=("forms", "bits", "time", "ablate"))
    ap.add_argument("--other-csrc", help="a csrc directory to build the other K3 from")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("these probes need a CUDA card")
    if args.probe == "time" and not args.other_csrc:
        raise SystemExit("time needs --other-csrc")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    other = cs.other_chain_lib(args.other_csrc) if args.other_csrc else None
    {"forms": forms, "bits": bits, "time": time_builds, "ablate": ablate}[args.probe](other)


if __name__ == "__main__":
    main()
