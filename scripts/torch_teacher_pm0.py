#!/usr/bin/env python
"""The pure-teacher comparison (proto_mix=0) on the PyTorch port.

The counterpart of ``scripts/teacher_pm0.py``: the same flags, defaults and
JSON, except that ``--device`` (the card by default; ``cpu`` here) takes the
place of ``--tpu``. The task is ``teacher_task(proto_mix=0)``: labels from
entangled teacher chains with no class-mean prototype channel. Each trainer
starts from its own product init at ``--seed``:

* ``brickwall`` / ``brickwall_ls``: ``boundary_product_init``, then
  ``train_brickwall`` with ``BrickConfig(act_fn="linear", loss_fn="MSE",
  split_method="cholqr", line_search=...)`` at lr ``min(0.02, 0.5 / N)``;
* ``twosite``: ``product_init``, then ``train_model(svd_method="cholqr",
  split_mode="canonical", L2_flag=False)`` at lr ``min(0.2, 1.6 / N)``.

The port draws its task and its initial models from ``torch.Generator``s
and NumPy as it does everywhere, so a seed gives another task and other
models than the JAX package's at that seed: compare the two packages over
seeds, by their means and spreads. Run on an H100:

    python3 scripts/torch_teacher_pm0.py --N 64 --M 16 --n_train 2048 \
        --n_epochs 12 --trainers brickwall,twosite --seed 0

and ``--device cpu`` on the CPU. The last line printed is the test
accuracies as JSON; ``--out`` also writes the whole result.

    python3 scripts/torch_teacher_pm0.py --combine OUT.json \
        jax=A_seed0.json,A_seed1.json,... torch=B_seed0.json,...

gathers per-seed results of both packages (``scripts/teacher_pm0.py --out``
files, their seed read from the ``seed<N>`` in the file name, and this
script's) into one file: per trainer, each package's seeds, test accuracies
and validation curves, the means and sample standard deviations, and whether
the two means lie within twice the larger of the two deviations.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the task's teachers and the models (default: the card)")
    ap.add_argument("--N", type=int, default=196)
    ap.add_argument("--M", type=int, default=32)
    ap.add_argument("--L", type=int, default=10)
    ap.add_argument("--teacher_m", type=int, default=4)
    ap.add_argument("--margin", type=float, default=0.3)
    ap.add_argument("--n_train", type=int, default=4096)
    ap.add_argument("--n_epochs", type=int, default=16)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--trainers", type=str, default="brickwall,brickwall_ls,twosite")
    ap.add_argument("--lr_decay", type=float, default=1.0,
                    help="per-epoch lr multiplier for the brick path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--combine", type=str, default=None, metavar="OUT",
                    help="gather --out files of both packages into OUT (see the docstring)")
    ap.add_argument("groups", nargs="*", help="with --combine: package=file,file,...")
    return ap.parse_args(argv)


def combine(out_path, groups) -> dict:
    """The ``--combine`` summary (see the module docstring)."""
    import re

    packages = {}
    for group in groups:
        package, paths = group.split("=", 1)
        runs = []
        for path in paths.split(","):
            with open(path) as f:
                run = json.load(f)
            seed = run.get("seed")
            if seed is None:
                seed = int(re.search(r"seed(\d+)", os.path.basename(path)).group(1))
            runs.append((seed, run))
        packages[package] = sorted(runs, key=lambda r: r[0])
    first = next(iter(packages.values()))[0][1]
    out = {"task": first["task"], "student_M": first["student_M"],
           "n_epochs": first["n_epochs"], "B": first["B"], "packages": {}, "hold": {}}
    trainers = sorted(set.intersection(*(set(r["results"]) for runs in packages.values()
                                         for _, r in runs)))
    for package, runs in packages.items():
        entry = {"seeds": [seed for seed, _ in runs],
                 "backend": sorted({r["backend"] for _, r in runs}),
                 "device_name": sorted({r.get("device_name", r["backend"]) for _, r in runs}),
                 "trainers": {}}
        for name in trainers:
            tests = [r["results"][name]["test_acc"] for _, r in runs]
            entry["trainers"][name] = {
                "test_acc": tests,
                "val_acc": [r["results"][name]["val_acc"] for _, r in runs],
                "mean": float(np.mean(tests)),
                "std": float(np.std(tests, ddof=1)) if len(tests) > 1 else 0.0,
            }
        out["packages"][package] = entry
    if len(packages) == 2:
        a, b = out["packages"].values()
        for name in trainers:
            ta, tb = a["trainers"][name], b["trainers"][name]
            gap, spread = abs(ta["mean"] - tb["mean"]), 2.0 * max(ta["std"], tb["std"])
            out["hold"][name] = {"gap": gap, "twice_larger_std": spread,
                                 "within_seed_spread": bool(gap <= spread)}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["hold"]))
    return out


def make_task(args, device):
    """``(train_x, train_y, test_x, test_y)`` of the pure-teacher task."""
    from tensornetworkforml_torch.data.teacher import teacher_task

    return teacher_task(n_train=args.n_train, n_test=1024, N=args.N, L=args.L,
                        teacher_m=args.teacher_m, margin=args.margin, proto_mix=0.0,
                        seed=args.seed, device=device)


def initial_boundary(seed, N, M, L, x_cal, device):
    """The brick wall's initial boundary-label model."""
    from tensornetworkforml_torch.models.boundary import boundary_product_init

    return boundary_product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L,
                                 act_fn="linear", loss_fn="MSE", dtype=torch.float32,
                                 calibration_x=x_cal, device=device)


def initial_mps(seed, N, M, L, x_cal, device):
    """The two-site sweep's initial MPS."""
    from tensornetworkforml_torch.models.mps import product_init

    return product_init(torch.Generator().manual_seed(seed), N=N, M=M, L=L, act_fn="linear",
                        loss_fn="MSE", dtype=torch.float32, calibration_x=x_cal, device=device)


def main(argv=None) -> dict:
    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.models.mps import resolve_device
    from tensornetworkforml_torch.train.brickwall import BrickConfig, train_brickwall
    from tensornetworkforml_torch.train.onesite import boundary_accuracy
    from tensornetworkforml_torch.train.trainer import evaluate_accuracy, train_model

    args = parse_args(argv)
    if args.combine:
        return combine(args.combine, args.groups)
    device = resolve_device(args.device)
    tr_x, tr_y, te_x, te_y = make_task(args, device)
    data = np.concatenate([tr_x, te_x])
    labels = np.concatenate([tr_y, te_y])
    tl, vl, test_l = prepare_dataset(
        data, labels, len(tr_x) / len(data), 0.125, args.B, 256, 256,
        embed=False, seed=1, even_train_batches=True,
    )
    x_cal, _ = next(tl.batches())
    N, L, M = args.N, args.L, args.M

    results, devices = {}, {}
    for name in args.trainers.split(","):
        if name.startswith("brickwall"):
            cfg = BrickConfig(act_fn="linear", loss_fn="MSE", split_method="cholqr",
                              line_search=name.endswith("_ls"))
            model = initial_boundary(args.seed, N, M, L, x_cal[:256], device)
            lr0 = min(0.02, 0.5 / N)
            lr_arg = (lr0 if args.lr_decay == 1.0
                      else (lambda e, _l=lr0, _d=args.lr_decay: _l * _d ** e))
            model, val_acc = train_brickwall(model, tl, vl, lr=lr_arg, n_epochs=args.n_epochs,
                                             weight_dec=1e-5, verbose=False, cfg=cfg)
            test_acc = boundary_accuracy(model, test_l)
        elif name == "twosite":
            model = initial_mps(args.seed, N, M, L, x_cal[:256], device)
            model, val_acc, _ = train_model(
                model, tl, vl, lr=min(0.2, 1.6 / N), n_epochs=args.n_epochs, weight_dec=1e-5,
                L2_flag=False, split_mode="canonical", svd_method="cholqr", verbose=False)
            test_acc = evaluate_accuracy(model, test_l)
        else:
            raise ValueError(name)
        devices[name] = str(model.device)
        results[name] = {
            "val_acc": [round(float(v), 4) for v in val_acc],
            "best_val": round(max(float(v) for v in val_acc), 4),
            "test_acc": round(float(test_acc), 4),
        }
        print(name, results[name]["val_acc"], "test", results[name]["test_acc"], flush=True)

    out = {
        "task": ("teacher proto_mix=0 (pure entangled labels), "
                 f"N={N} L={L} teacher_m={args.teacher_m} "
                 f"margin={args.margin} n_train={args.n_train}"),
        "student_M": M,
        "n_epochs": args.n_epochs,
        "B": args.B,
        "seed": args.seed,
        "backend": str(device),
        "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "model_devices": devices,
        "results": results,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v["test_acc"] for k, v in results.items()}))
    return out


if __name__ == "__main__":
    main()
