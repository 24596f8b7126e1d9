"""When does ``utils/profiling.py::device_trace`` record no device events?
Run from the root of the repository, on a machine with one CUDA card:

    python3 scripts/torch_trace_probe.py sequence
    python3 scripts/torch_trace_probe.py phases

Each line traces one flagship serving batch (N=196, M=128, L=10, B=256,
through K3) with ``device_trace`` and prints how many device events the
trace holds, and how many of them are K3's ``chain_kernel``.

``sequence``: three traces in a fresh process; then after a CUDA-only
profile (as ``chip_smoke.py::device_time_table`` takes them), also over ten
batches; inside an NCCL world of one after a profile of an all-reduce with
``record_shapes``; and after the world is destroyed.

``phases``: ``chip_smoke.py``'s build, then a trace after each of its
phases that run before its last traced batch, in the script's order:
``[serve]``, the ``--dp`` CLI and ``[mesh]`` (whose world it closes),
``[reference]`` and ``[examples]``; the first trace that holds no device
event names the phase after which collection stopped.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tensornetworkforml_torch.models.mps import product_init  # noqa: E402
from tensornetworkforml_torch.models.serving import Predictor  # noqa: E402
from tensornetworkforml_torch.utils.profiling import device_trace  # noqa: E402


def flagship():
    mps = product_init(torch.Generator().manual_seed(0), N=196, M=128, L=10,
                       act_fn="linear", loss_fn="MSE")
    pred = Predictor(mps, batch_size=256)
    pred.warmup()
    x = torch.as_tensor(np.random.default_rng(0).random((256, 196)), dtype=torch.float32,
                        device="cuda")
    return mps, pred, x


def tracer(pred, x):
    tmp = tempfile.mkdtemp()

    def trace(label, n=1):
        with device_trace(tmp) as prof:
            for _ in range(n):
                pred._chunk_scores(x)
        dev = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"[trace] {label}: {len(dev)} device events, K3 "
              f"{sum('chain_kernel' in d for d in dev)}", flush=True)

    return trace


def sequence() -> None:
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tensornetworkforml_torch.parallel.mesh import make_mesh

    _, pred, x = flagship()
    trace = tracer(pred, x)
    for i in range(3):
        trace(f"fresh process #{i}")
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    trace("after a CUDA-only profile")
    trace("after a CUDA-only profile, 10 batches", 10)
    make_mesh()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True):
        dist.all_reduce(torch.ones(1000, device="cuda"))
        pred._chunk_scores(x)
        torch.cuda.synchronize()
    trace("inside an NCCL world of one")
    dist.destroy_process_group()
    for i in range(3):
        trace(f"after the world is destroyed #{i}")


def phases() -> None:
    import chip_smoke as cs

    cs.phase_device()
    cs.phase_build()
    requests, _ = cs.pooled(cs.BIG, seed=cs.SEED)
    x_tr, y_tr = cs.pooled(cs.TRAIN_BATCHES * cs.BATCH, seed=cs.SEED + 2)
    x_fresh = torch.as_tensor(cs.pooled(cs.BATCH, seed=cs.SEED + 4)[0], device="cuda")
    mps = product_init(torch.Generator().manual_seed(cs.SEED), N=cs.N, M=cs.M, D=cs.D,
                       L=cs.L, act_fn="linear", loss_fn="MSE", calibration_x=requests[:512])
    _, pred, x = flagship()
    trace = tracer(pred, x)
    trace("the build")
    serve = cs.phase_serve(mps, requests)
    trace("[serve]")
    cli = cs.phase_cli(x_fresh)
    trace("[cli]")
    cs.phase_mesh(mps, x_tr, y_tr, x_fresh, requests)
    trace("[mesh]")
    xb = torch.as_tensor(x_tr[:cs.BATCH], device="cuda")
    yb = torch.as_tensor(y_tr[:cs.BATCH], device="cuda")
    cs.phase_reference(mps, requests, serve, cli, xb, yb, x_fresh)
    trace("[reference]")
    cs.phase_examples()
    trace("[examples]")


if __name__ == "__main__":
    {"sequence": sequence, "phases": phases}[sys.argv[1] if len(sys.argv) > 1 else "phases"]()
