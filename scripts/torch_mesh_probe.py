"""Where a data-parallel sweep in a world of one spends its time, on a machine
with one CUDA card; run from the root of the repository:

    python3 scripts/torch_mesh_probe.py

In a world of one (``parallel/mesh.py::make_mesh()``: NCCL over a HashStore),
at chip_smoke.py's flagship (N=196, M=128, D=2, L=10, B=256, the polar
split, lr 0.05, weight decay 1e-5):

1. one ``dist.all_reduce`` on the card at 1, 98,305 (y, G and n2 of a
   dist-polar split) and 655,363 floats (a step's gradient and metrics): its
   host time a call (200 calls, no synchronisation between them), and its
   host time right after a 2 ms device spin (``torch.cuda._sleep``): equal to
   the first if the call only enqueues, ~2 ms more if it waits for the card;
2. one flagship sweep in turns: ``sweep_once``, the data-parallel sweep, the
   data-parallel sweep with ``DataShards.sum`` summing nothing (the same
   packing into one buffer, no collective) and the data-parallel sweep with
   ``DataShards.sum`` handing its inputs back (no packing, no collective);
   each ``ROUNDS`` x 2 times, in the order a, b, c, d, d, c, b, a repeated;
   the µs each adds a step against ``sweep_once``. The differences name the
   shares: the collective (mesh against no collective), the packing
   (no collective against no packing) and the rest of the mesh step (no
   packing against ``sweep_once``).

NCCL's flight recorder is on by default; run the probe again with
``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` in the environment to time it off.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

N, M, D, L, B = 196, 128, 2, 10, 256
LR, WD = 0.05, 1e-5
ROUNDS = 3


def host_us(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def after_spin_us(fn, reps: int = 20) -> float:
    """Host time of ``fn`` issued right after a 2 ms device spin."""
    cycles = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e6 / reps


def collectives(mesh) -> None:
    group = mesh.get_group("data")
    for n in (1, 98_305, 655_363):
        t = torch.ones(n, device="cuda")
        fn = lambda: dist.all_reduce(t, group=group)  # noqa: E731
        print(f"[collective] all_reduce of {n} floats: {host_us(fn, 200):.1f} us of host a call; "
              f"{after_spin_us(fn):.1f} us after a 2 ms device spin")
    t = torch.ones(655_363, device="cuda")
    print(f"[collective] torch.cat of the step's four parts: "
          f"{host_us(lambda: torch.cat([t, t[:1], t[:1], t[:1]]), 200):.1f} us of host a call")


def sweeps(mesh) -> None:
    from tensornetworkforml_torch.models.mps import product_init
    from tensornetworkforml_torch.ops.embedding import psi_embed
    from tensornetworkforml_torch.parallel import mesh as mesh_mod
    from tensornetworkforml_torch.parallel.dp import ShardedTrainer
    from tensornetworkforml_torch.train.sweep import SweepConfig, one_hot_labels, sweep_once

    gen = torch.Generator().manual_seed(0)
    x = torch.rand((B, N), generator=gen).cuda()
    y = torch.randint(0, L, (B,), generator=gen).cuda()
    mps = product_init(torch.Generator().manual_seed(0), N=N, M=M, D=D, L=L, act_fn="linear",
                       loss_fn="MSE", calibration_x=x[:256].cpu().numpy())
    cfg = SweepConfig(act_fn="linear", loss_fn="MSE", L2_flag=False, split_mode="canonical",
                      svd_method="polar")
    phi, y1h = psi_embed(x), one_hot_labels(y, L, torch.float32)

    def no_sum(self, *tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                                tensors)]

    def no_pack(self, *tensors):
        return list(tensors)

    def patched_sum(fn):
        return lambda: mock.patch.object(mesh_mod.DataShards, "sum", fn)

    variants = {
        "sweep_once": (lambda: sweep_once(mps, phi, y1h, LR, WD, cfg), contextlib.nullcontext),
        "mesh": (None, contextlib.nullcontext),
        "mesh, no collective": (None, patched_sum(no_sum)),
        "mesh, no packing": (None, patched_sum(no_pack)),
    }
    times = {k: [] for k in variants}
    order = (list(variants) + list(variants)[::-1]) * ROUNDS
    for name in order:
        fn, ctx = variants[name]
        if fn is None:
            trainer = ShardedTrainer(mesh, mps, LR, WD, cfg=cfg)
            fn = lambda: trainer.step(x, y)  # noqa: E731
        with ctx():
            fn()  # the first call of each pays its allocations
            torch.cuda.synchronize()
            if variants[name][0] is None:
                trainer = ShardedTrainer(mesh, mps, LR, WD, cfg=cfg)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    mean = {name: sum(ms) / len(ms) for name, ms in times.items()}
    for name, ms in times.items():
        print(f"[sweep] {name}: {' / '.join(f'{t:.1f}' for t in ms)} ms, mean {mean[name]:.1f}, "
              f"{(mean[name] - mean['sweep_once']) / (N - 1) * 1e3:+.1f} us a step against "
              "sweep_once")
    for share, (a, b) in (("the collective", ("mesh", "mesh, no collective")),
                          ("the packing", ("mesh, no collective", "mesh, no packing")),
                          ("the rest of the mesh step", ("mesh, no packing", "sweep_once"))):
        print(f"[sweep] {share}: {(mean[a] - mean[b]) / (N - 1) * 1e3:+.1f} us a step")


def main() -> None:
    import subprocess

    from tensornetworkforml_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), f"torch {torch.__version__}, TORCH_NCCL_TRACE_BUFFER_SIZE="
          f"{os.environ.get('TORCH_NCCL_TRACE_BUFFER_SIZE', 'unset')}")
    mesh = make_mesh()
    try:
        collectives(mesh)
        sweeps(mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
