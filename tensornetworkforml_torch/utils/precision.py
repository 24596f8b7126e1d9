"""The matmul precision scope: the port's ``jax.default_matmul_precision``.

``matmul_precision(name)`` runs the block with cuBLAS's float32 products
(``torch.matmul``, ``@``, ``torch.einsum`` on CUDA tensors) in the mode that
``name`` asks for, and restores the previous mode on exit, also on an
exception. The names are the JAX package's:

===========================================  ==========================  =========
name                                         CUDA tensors                CPU
===========================================  ==========================  =========
``"default"``, ``"float32"``, ``"highest"``  IEEE float32, TF32 off      unchanged
``"tensorfloat32"``, ``"high"``,             TF32 (one tensor-core pass  unchanged
``"bfloat16"``                               on 10-bit mantissas)
===========================================  ==========================  =========

Any other name raises ``ValueError`` before the block runs.

* ``"default"`` stays IEEE float32. On a TPU it means single-pass bf16, but
  the port has run every float32 product in IEEE since it began, and every
  result it has accepted rests on that.
* ``"bfloat16"`` takes TF32: TF32 is the card's one reduced path for
  float32 operands that can be scoped to the CUDA backend alone (a bf16
  product would need the operands cast, and PyTorch's bf16 switch for
  float32 products also reaches the CPU's oneDNN).

Only the CUDA backend's switch is touched (``torch.backends.cuda.matmul.
allow_tf32``, the one family of TF32 switches the port uses; recent PyTorch
refuses a mix of it and ``fp32_precision``). ``torch.set_float32_matmul_
precision`` is not called, since it also reaches oneDNN on the CPU, where
the JAX package's knob does nothing. The hand-written kernels fix their own
precision and are not reached by the scope.

``full_float32`` is the scope at ``"float32"`` as a decorator: the splits
re-enter it, as the JAX package's re-enter ``default_matmul_precision(
"float32")``, so that a reduced sweep never rounds a Gram, a sketch or
``R`` to TF32 and moves the kept rank.
"""

from __future__ import annotations

import contextlib
import functools

import torch

FULL = ("default", "float32", "highest")
REDUCED = ("tensorfloat32", "high", "bfloat16")


def check_name(name: str) -> bool:
    """True for a reduced name, False for a full float32 one; raises
    ``ValueError`` for any other."""
    if name in FULL:
        return False
    if name in REDUCED:
        return True
    raise ValueError(f"unknown matmul precision {name!r}; expected one of {FULL + REDUCED}")


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the block with cuBLAS's float32 products in ``name``'s mode (the
    module's table); restores the previous mode on exit."""
    tf32 = check_name(name)
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    if before == tf32:
        yield
        return
    matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def full_float32(fn):
    """Run ``fn`` inside ``matmul_precision("float32")``."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with matmul_precision("float32"):
            return fn(*args, **kwargs)

    return run
