#!/usr/bin/env python
"""The M=512 polar iteration's precision on the card: IEEE float32 or TF32.

The port-side copy of ``scripts/opt_iterate_m512.py``'s harness. The matrix
is the same gapped two-site matrix at I=1024, J=10240, q=512 (a kept
spectrum over three decades, a 0.06 gap below it; ``gapped_bmat``), its Gram
``G = B B^T`` formed on the host in float32, and the sketch ``y0 = B Omega``
in IEEE float32 on the card. Each variant maps ``y0`` to Q; it is scored by
the worst isometry error among its live columns (``|Q^T Q - I|`` on the
columns whose norm is above 1/2) and the capture loss ``1 - |Q^T B|_F^2 /
sum of the top q squared singular values``, and timed with CUDA events.

Variants, each the iteration of ``train/factored_step.py::_iterate`` (its
shortened q >= 512 schedules) with its phases in a given precision
(``utils/precision.py``):

  ieee        every Newton-Schulz product and the power multiply in IEEE
  tf32_all    every one in TF32
  tf32_loop   the loop phase (conditioner passes and the power multiply) in
              TF32, the final passes in IEEE

and, for ``gramfree_split``'s ``ns_prec``, its two orthonormalisations (the
loop and ``(1e-8, 1e-7)`` final schedules) around an IEEE ``B (B^T y1)``:

  gramfree_ns_ieee, gramfree_ns_tf32

The bar is the JAX package's own HIGH figures (results/iterate_variants.json:
aligned_high iso 3.67e-5, cap_loss -1.84e-5; aligned_high_short iso
1.05e-4, cap 7.58e-6): a TF32 variant that is faster than IEEE with iso <=
1.05e-4 and |cap_loss| <= 1e-5 passes.

    python3 scripts/torch_iterate_m512.py [--out results/iterate_variants_torch.json]

needs a CUDA card (it fails without one). ``--small`` runs I=64, J=320,
q=32 (on the CPU with ``--device cpu``, where TF32 is a no-op) to check the
harness.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ISO_BAR, CAP_BAR = 1.05e-4, 1e-5
JAX_HIGH = {"aligned_high": {"iso": 3.67e-5, "cap_loss": -1.84e-5},
            "aligned_high_short": {"iso": 1.05e-4, "cap_loss": 7.58e-6}}


def gapped_bmat(I, J, rank, seed=0):
    """``scripts/opt_iterate_m512.py``'s matrix: ``(B float32, singular values)``."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((I, I)))
    v, _ = np.linalg.qr(rng.standard_normal((J, I)))
    s = np.zeros(I)
    s[:rank] = np.logspace(0, -3, rank)
    s[rank:] = 0.06 * s[rank - 1] * np.logspace(0, -2, I - rank)
    return ((u * s) @ v.T).astype(np.float32), s


def variants(b, g, y0):
    from tensornetworkforml_torch.ops.kernels import polar_split as ps
    from tensornetworkforml_torch.train.factored_step import _iterate
    from tensornetworkforml_torch.utils.precision import matmul_precision

    n2 = torch.diagonal(g).sum()

    def factored(modes):
        return lambda: _iterate(y0, g, n2, 1e-6, modes=modes)

    loop_s = ps._pe_schedule(*ps._PE_LOOP)
    final_s = ps._pe_schedule(*ps._PE_FINAL_GRAMFREE)

    def gramfree(mode):
        def run():
            with matmul_precision(mode):
                y1 = ps._polar_ns_greedy(ps._colnorm(y0 / torch.sqrt(n2), 1e-6), loop_s)
            z = b @ (b.T @ y1)
            with matmul_precision(mode):
                return ps._polar_ns_greedy(ps._colnorm(z / n2, 1e-6), final_s)
        return run

    return {
        "ieee": factored(("float32", "float32")),
        "tf32_all": factored(("tensorfloat32", "tensorfloat32")),
        "tf32_loop": factored(("tensorfloat32", "float32")),
        "gramfree_ns_ieee": gramfree("float32"),
        "gramfree_ns_tf32": gramfree("tensorfloat32"),
    }


def score(q, b, exact):
    q = q.double()
    gq = q.T @ q
    live = torch.diagonal(gq) > 0.5
    n = int(live.sum())
    iso = float((gq[live][:, live] - torch.eye(n, dtype=torch.float64, device=q.device))
                .abs().max())
    cap = float(((q.T @ b.double()) ** 2).sum()) / exact
    return iso, 1.0 - cap, n


def event_ms(fn, reps, cuda):
    fn()
    if not cuda:
        import time

        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="results/iterate_variants_torch.json")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_iterate_m512: no CUDA card (pass --device cpu --small to check "
                         "the harness)")
    card = "cpu"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
        print(card)
    I, J, q = (64, 320, 32) if args.small else (1024, 10240, 512)
    from tensornetworkforml_torch.ops import svd as tsvd

    b_np, s = gapped_bmat(I, J, q)
    b = torch.as_tensor(b_np, device=dev)
    g = torch.as_tensor(b_np @ b_np.T, device=dev)
    y0 = b @ tsvd.rangefinder_omega(J, q, torch.float32, dev)
    exact = float(np.sum(s[:q] ** 2))
    fns = variants(b, g, y0)
    out = {"shape": f"I={I} J={J} q={q}", "reps": args.reps, "card": card,
           "torch": torch.__version__, "bar": {"iso": ISO_BAR, "abs_cap_loss": CAP_BAR},
           "jax_high": JAX_HIGH, "variants": {}}
    for name, fn in fns.items():
        iso, loss, live = score(fn(), b, exact)
        out["variants"][name] = {"iso": iso, "cap_loss": loss, "live": live}
    # in turns: forward, then backward, over the variants
    names = list(fns)
    times = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            times[n].append(event_ms(fns[n], args.reps, cuda))
    for n in names:
        v = out["variants"][n]
        v["us"] = [t * 1e3 for t in times[n]]
        v["us_mean"] = sum(v["us"]) / len(v["us"])
        print(f"{n}: {v['us'][0]:.1f} / {v['us'][1]:.1f} us, iso {v['iso']:.3g}, cap_loss "
              f"{v['cap_loss']:.3g}, live {v['live']}", flush=True)
    for base, cands in (("ieee", ("tf32_all", "tf32_loop")),
                        ("gramfree_ns_ieee", ("gramfree_ns_tf32",))):
        for n in cands:
            v = out["variants"][n]
            v["passes"] = bool(v["us_mean"] < out["variants"][base]["us_mean"]
                               and v["iso"] <= ISO_BAR and abs(v["cap_loss"]) <= CAP_BAR)
            print(f"{n} against {base}: {'passes' if v['passes'] else 'fails'} the bar "
                  f"(faster, iso <= {ISO_BAR:g}, |cap_loss| <= {CAP_BAR:g})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
