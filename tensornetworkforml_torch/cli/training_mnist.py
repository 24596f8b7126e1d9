"""Train the MPS classifier on 10-class MNIST (28x28 or pooled 14x14).

    python -m tensornetworkforml_torch.cli.training_mnist --data_dir datasets
    python -m tensornetworkforml_torch.cli.training_mnist --synthetic --pool

Recipe: per-site-calibrated product-state init + canonical-gauge two-site
sweeps + linear activation / MSE loss (``models/mps.py::product_init``).
MNIST is read from local IDX files; ``--synthetic`` substitutes the
deterministic stand-in, ``--dataset cifar10`` reads the CIFAR-10 binary
batches as grayscale. Trains on the CUDA card unless given ``--device cpu``.

The flags, defaults and derived defaults are the JAX package's
``cli/training_mnist.py``, plus ``--device``. Only ``--trainer twosite`` is
ported: ``onesite`` and ``brickwall`` (ROADMAP queue 1 item 10) and ``--dp``
(item 11) raise ``NotImplementedError`` before any data is loaded.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tensornetworkforml_torch.cli.common import add_device_flag
from tensornetworkforml_torch.models.mps import MPS, product_init


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the Tensor Network on 10-class MNIST"
    )
    p.add_argument("--data_dir", type=str, default="datasets")
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "fashion", "cifar10"],
                   help="mnist/fashion share the IDX loader (Fashion-MNIST "
                        "ships the same file names); cifar10 reads the "
                        "binary batches as 32x32 grayscale")
    p.add_argument("--pool", action="store_true", default=True,
                   help="2x2 max-pool (default; 28x28 -> 14x14)")
    p.add_argument("--full", dest="pool", action="store_false",
                   help="train on the full-resolution chain (N=784/1024; "
                        "long-chain DMRG optimisation is oscillatory)")
    p.add_argument("--M", type=int, default=32, help="Bond dimension")
    p.add_argument("--n_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=128,
                   help="quality tracks the UPDATE count, not the batch "
                        "size: when growing B by k, run ~k x the epochs and "
                        "raise --lr_decay to decay^(1/k)")
    p.add_argument("--lr", type=float, default=None,
                   help="default 0.2; 1.6/N for chains longer than 400 "
                        "sites (the clipped update takes a ~lr-relative "
                        "step at every bond, so per-sweep growth compounds "
                        "like (1+lr)^N); at most 0.02 from bond dimension 64")
    p.add_argument("--lr_decay", type=float, default=None,
                   help="per-epoch geometric lr decay (lr * decay^epoch). "
                        "Default: 1.0 (off) below bond dimension 64, 0.6 at "
                        "M >= 64")
    p.add_argument("--weight_dec", type=float, default=1e-5)
    p.add_argument("--act_fn", type=str, default="linear")
    p.add_argument("--loss_fn", type=str, default="MSE")
    p.add_argument("--out", type=str, default="trained_mnist10_model.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dp", action="store_true",
                   help="Shard the batch over all devices (data parallel; "
                        "not ported yet)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Path for per-epoch training-state checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="Resume from --checkpoint if it exists")
    p.add_argument("--bond_schedule", type=str, default=None,
                   help='grow the bond dimension mid-training, e.g. '
                        '"2:32,4:64" grows M to 32 at epoch 2 and 64 at '
                        'epoch 4 (zero-padded embedding, function preserved)')
    p.add_argument("--stall_threshold", type=float, default=0.95,
                   help="validation accuracy above which a run is never "
                        "flagged stalled (restart gate); lower it, or pass "
                        "--restarts 0, on tasks whose attainable accuracy "
                        "is below 0.95")
    p.add_argument("--restarts", type=int, default=None,
                   help="max fresh-init retries when validation stalls "
                        "below --stall_threshold. Default: 2 when "
                        "batch_size > 128, else 0")
    p.add_argument("--warmup_epochs", type=int, default=None,
                   help="epochs at a small (<= 128-sample) batch before the "
                        "full batch (default: 1 when batch_size > 128, else 0)")
    p.add_argument("--svd_method", type=str, default="cholqr",
                   choices=["svd", "rangefinder", "cholsvd", "cholqr",
                            "polar"],
                   help="two-site split: cholqr (default) is the "
                        "matmul/Cholesky subspace split, valid for a kept "
                        "spectral block spanning <= ~3 decades in float32; "
                        "rangefinder (QR subspace split, the K6 kernel from "
                        "I = 128 rows) or svd (exact) for wide spectra; "
                        "polar runs the polar-iteration kernel K1")
    p.add_argument("--renorm_envs", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="norm-transfer gauge for canonical two-site sweeps; "
                        "'auto' enables it for long chains (N > 400) or "
                        "bond dimension >= 64")
    p.add_argument("--trainer", type=str, default="twosite",
                   choices=["twosite", "onesite", "brickwall"],
                   help="twosite is ported; onesite and brickwall are not "
                        "yet (ROADMAP queue 1 item 10)")
    add_device_flag(p)
    return p


def initial_mps(seed: int, N: int, M: int, act_fn: str, loss_fn: str,
                x_cal: np.ndarray, device) -> MPS:
    """The run's initial model, and each stall restart's (``seed + 7919 *
    attempt``): ``product_init`` from a CPU generator, so a seed gives the
    same model on the CPU and on the card."""
    return product_init(
        torch.Generator().manual_seed(seed), N=N, M=M, L=10, act_fn=act_fn,
        loss_fn=loss_fn, dtype=torch.float32, calibration_x=x_cal, device=device,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.trainer != "twosite":
        raise NotImplementedError(
            f"--trainer {args.trainer} is not ported yet (ROADMAP queue 1 item 10)"
        )
    if args.dp:
        raise NotImplementedError(
            "--dp (data-parallel training) is not ported yet (ROADMAP queue 1 item 11)"
        )

    from tensornetworkforml_torch.data.loader import prepare_dataset
    from tensornetworkforml_torch.data.mnist import (
        get_MNIST_dataset,
        max_pool_2x2,
        synthetic_mnist,
    )
    from tensornetworkforml_torch.models.mps import resolve_device
    from tensornetworkforml_torch.models.network import Network
    from tensornetworkforml_torch.train.trainer import evaluate_accuracy, train_model

    device = resolve_device(args.device)
    if args.dataset == "cifar10":
        from tensornetworkforml_torch.data.cifar import (
            get_CIFAR10_grayscale,
            synthetic_cifar10,
        )

        if args.synthetic:
            tr_x, tr_y, te_x, te_y = synthetic_cifar10()
        else:
            tr_x, tr_y, te_x, te_y = get_CIFAR10_grayscale(args.data_dir)
        scale = 1.0  # already in [0, 1]
    else:
        if args.synthetic:
            tr_x, tr_y, te_x, te_y = synthetic_mnist()
        else:
            tr_x, tr_y, te_x, te_y = get_MNIST_dataset(data_root_dir=args.data_dir)
        scale = 255.0
    n_train = len(tr_x)
    data = np.concatenate([tr_x, te_x]) / scale
    labels = np.concatenate([tr_y, te_y])
    if args.pool:
        data = max_pool_2x2(data)
    N = data[0].size

    train_perc = n_train / len(data)
    train_loader, val_loader, test_loader = prepare_dataset(
        data, labels, train_perc, 0.1,
        train_batch_size=args.batch_size, val_batch_size=256,
        test_batch_size=256, embed=False, seed=args.seed,
        even_train_batches=True,  # keep every epoch on the whole-epoch path
    )

    # long chains need the norm-transfer gauge, a growth cap on the two-site
    # tensor and an N-scaled step: the clipped two-site update moves
    # ~lr x |B| at every one of N-1 bonds, so the function can compound by
    # (1+lr)^N per sweep; lr ~ 1.6/N bounds that to ~5x
    long_chain = N > 400
    lr = args.lr if args.lr is not None else (min(0.2, 1.6 / N) if long_chain else 0.2)
    growth_cap = 0.002 if long_chain else 0.0
    warmup_epochs = (
        args.warmup_epochs if args.warmup_epochs is not None
        else (1 if args.batch_size > 128 else 0)
    )
    bond_schedule = None
    if args.bond_schedule:
        bond_schedule = {
            int(e): int(m)
            for e, m in (kv.split(":") for kv in args.bond_schedule.split(","))
        }

    # the norm-transfer gauge: auto-on for long chains or large bond
    # dimension, schedule targets included
    max_m = max([args.M, *(bond_schedule or {}).values()])
    renorm = {"auto": long_chain or max_m >= 64, "on": True, "off": False}[args.renorm_envs]
    # large-M recipe: the gauge alone is not enough -- at M >= 64 the greedy
    # sweeps also need a growth cap and per-epoch lr decay, or they walk back
    # out of the epoch-1 optimum
    lr_decay = args.lr_decay if args.lr_decay is not None else (0.6 if max_m >= 64 else 1.0)
    if max_m >= 64 and args.lr is None:
        lr = min(lr, 0.02)
    if max_m >= 64 and not long_chain:
        growth_cap = growth_cap or 0.002

    x_cal, _ = next(train_loader.batches())
    mps = initial_mps(args.seed, N, args.M, args.act_fn, args.loss_fn, x_cal[:256], device)

    lr_arg = lr if lr_decay == 1.0 else (lambda e, _lr=lr, _d=lr_decay: _lr * _d ** e)
    restarts = (
        args.restarts if args.restarts is not None
        else (2 if args.batch_size > 128 else 0)
    )

    def reinit_fn(attempt):
        # a fresh init for a stall restart: the same calibration batch, a
        # seed offset far from any user-chosen --seed range
        return initial_mps(args.seed + 7919 * attempt, N, args.M, args.act_fn,
                           args.loss_fn, x_cal[:256], device)

    mps, val_acc, var_hist = train_model(
        mps, train_loader, val_loader, lr=lr_arg,
        n_epochs=args.n_epochs, weight_dec=args.weight_dec,
        L2_flag=False, split_mode="canonical",
        svd_method=args.svd_method, renorm_envs=renorm,
        growth_cap=growth_cap, checkpoint_path=args.checkpoint,
        resume=args.resume, warmup_epochs=warmup_epochs,
        bond_schedule=bond_schedule, restarts=restarts,
        reinit_fn=reinit_fn, stall_threshold=args.stall_threshold,
    )

    test_acc = evaluate_accuracy(mps, test_loader)
    print(f"\nTest accuracy: {test_acc:.4f}")

    net = Network.__new__(Network)
    net.mps = mps
    net.save(args.out)
    print(f"Model saved to {args.out}")
    return val_acc, test_acc


if __name__ == "__main__":
    main()
