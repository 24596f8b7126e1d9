"""One-command Stoudenmire-Schwab replication runner.

Pins the full-resolution 10-class MNIST configuration of the method's
published result -- 99.03% test accuracy at bond dimension m=120 with full
28x28 images (Stoudenmire & Schwab 2016, section 4) -- on the stable
long-chain recipe of ``cli/training_mnist.py``:

* N=784 chain (no pooling), two-site canonical-gauge sweeps, linear/MSE,
  N-scaled lr (1.6/N), growth cap, norm-transfer gauge;
* bond schedule 32 -> 64 -> 120;
* one small-batch warmup epoch.

With the real IDX files present::

    python -m tensornetworkforml_torch.cli.replicate_stoudenmire --data_dir datasets

``--synthetic`` runs the identical pipeline end to end on the deterministic
stand-in. Exits 0 iff the gate passes (0.99 on the stand-in, 0.9903 on real
MNIST). Runs on the CUDA card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys

from tensornetworkforml_torch.cli.common import add_device_flag

NORTH_STAR = 0.9903  # MNIST test accuracy @ m=120, Stoudenmire-Schwab 2016
SYNTHETIC_GATE = 0.99  # the stand-in task saturates; gate near-perfect


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Replicate the Stoudenmire-Schwab 99.03% MNIST result"
    )
    p.add_argument("--data_dir", type=str, default="datasets")
    p.add_argument("--synthetic", action="store_true",
                   help="run the identical pipeline on the synthetic "
                        "stand-in (no dataset files needed)")
    p.add_argument("--smoke", action="store_true",
                   help="tiny-config smoke mode: pooled 14x14, M 8->16, "
                        "2 epochs -- checks the runner end to end, not the "
                        "accuracy gate")
    p.add_argument("--n_epochs", type=int, default=12)
    p.add_argument("--M_final", type=int, default=120,
                   help="final bond dimension (the paper's m)")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out", type=str, default="stoudenmire_m120_model.npz")
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from tensornetworkforml_torch.cli.training_mnist import main as train_main

    if args.smoke:
        sub = [
            "--pool", "--M", "8", "--bond_schedule", "1:16",
            "--n_epochs", "2", "--batch_size", "64",
        ]
    else:
        # bond schedule: thirds of the run at 32 -> 64 -> M_final
        e1 = max(1, args.n_epochs // 3)
        e2 = max(e1 + 1, (2 * args.n_epochs) // 3)
        sub = [
            "--full", "--M", "32",
            "--bond_schedule", f"{e1}:64,{e2}:{args.M_final}",
            "--n_epochs", str(args.n_epochs),
            "--batch_size", str(args.batch_size),
        ]
    sub += ["--data_dir", args.data_dir, "--out", args.out, "--seed", str(args.seed)]
    if args.synthetic:
        sub.append("--synthetic")
    if args.checkpoint:
        sub += ["--checkpoint", args.checkpoint]
    if args.resume:
        sub.append("--resume")
    if args.device:
        sub += ["--device", args.device]

    val_acc, test_acc = train_main(sub)

    gate = SYNTHETIC_GATE if args.synthetic else NORTH_STAR
    label = "synthetic stand-in" if args.synthetic else "real MNIST"
    print(f"\n=== Stoudenmire-Schwab replication gate ({label}) ===")
    print(f"test accuracy : {test_acc:.4f}")
    print(f"target        : {gate:.4f}"
          + ("" if args.synthetic else "  (99.03% @ m=120, paper section 4)"))
    if args.smoke:
        print("smoke mode: gate not evaluated")
        return 0
    if test_acc >= gate:
        print("GATE PASSED")
        return 0
    print(f"GATE NOT MET (gap {gate - test_acc:.4f})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
