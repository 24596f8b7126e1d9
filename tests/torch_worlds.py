"""Spawned gloo worlds for the port's multi-rank tests on the CPU.

A ``World`` starts ``size`` processes (``spawn``), one a rank, each with one
torch thread, joined in a gloo process group over a ``FileStore`` in a
temporary directory (no TCP port: the suite runs several workers at once).
Each rank hands ``ops.svd.rangefinder_omega`` the sketch matrices it is
given (the JAX package's draws, made in the parent; a shape not given keeps
the port's own draw), imports the test module
and runs its ``case_<name>(payload)`` functions in order, the same on every
rank, and returns what each case returned (numpy arrays and numbers) to the
parent: ``results()[rank][name]``. A case that raises gives
``{"error": traceback}`` for that case. Every wait has a timeout, and the
parent kills the ranks on a failure, so a hung rank fails the tests that
read the world instead of stalling the suite.

This module and the case functions import no JAX: the ranks never do.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import time
import traceback

RANK_TIMEOUT_S = 60  # a collective that waits longer raises in the rank


def _patch_omega(omegas: dict) -> None:
    """The sketch matrices handed over, by ``(J, q)``; the port's own draw at
    any other shape (cases that compare the port with itself)."""
    import torch

    from tensornetworkforml_torch.ops import svd as tsvd

    own = tsvd.rangefinder_omega

    def omega(J, q, dtype=torch.float32, device=None):
        if (J, q) not in omegas:
            return own(J, q, dtype, device)
        return torch.as_tensor(omegas[(J, q)]).to(dtype=dtype, device=device)

    tsvd.rangefinder_omega = omega


def _run_rank(rank: int, size: int, store: str, module: str, cases: list, payload: dict,
              out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, size), rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        _patch_omega(payload.get("omegas", {}))
        mod = importlib.import_module(module)
        results = {}
        for name in cases:
            t0 = time.perf_counter()
            try:
                results[name] = getattr(mod, f"case_{name}")(payload)
            except Exception:  # reported to the test that reads this case
                results[name] = {"error": traceback.format_exc()}
            results[name + ":seconds"] = time.perf_counter() - t0
        dist.destroy_process_group()
        out.put((rank, results))
    except BaseException:
        out.put((rank, {"error": traceback.format_exc()}))
        raise


class World:
    """``size`` ranks running ``cases`` of ``module``; ``start`` returns at
    once, ``results`` waits for every rank (at most ``timeout`` seconds)."""

    def __init__(self, size: int, module: str, cases: list, payload: dict, tmp_dir: str,
                 timeout: float = 240.0):
        self.size, self.timeout = size, timeout
        ctx = multiprocessing.get_context("spawn")
        self._out = ctx.Queue()
        store = os.path.join(str(tmp_dir), f"world{size}.store")
        self._procs = [
            ctx.Process(target=_run_rank, args=(r, size, store, module, cases, payload, self._out),
                        daemon=True)
            for r in range(size)
        ]
        self._results = None

    def start(self) -> "World":
        for p in self._procs:
            p.start()
        self._t0 = time.monotonic()
        return self

    def results(self) -> list:
        if self._results is not None:
            return self._results
        got = {}
        try:
            while len(got) < self.size:
                left = self.timeout - (time.monotonic() - self._t0)
                try:
                    rank, res = self._out.get(timeout=max(left, 0.1))
                except queue.Empty:
                    raise RuntimeError(
                        f"world of {self.size}: ranks {sorted(set(range(self.size)) - set(got))} "
                        f"gave no result within {self.timeout} s") from None
                if set(res) == {"error"}:
                    raise RuntimeError(f"world of {self.size}, rank {rank} failed:\n"
                                       + res["error"])
                got[rank] = res
            for p in self._procs:
                p.join(timeout=30)
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        self._results = [got[r] for r in range(self.size)]
        return self._results


def case_result(world: World, name: str, rank: int = 0):
    """One rank's result of one case; fails the calling test with the rank's
    traceback where the case raised."""
    res = world.results()[rank][name]
    if isinstance(res, dict) and "error" in res:
        raise AssertionError(f"case {name!r} raised on rank {rank}:\n{res['error']}")
    return res
