"""ring_gemm_roofline: the ring's contractions, the share of its autodiff
step that cuBLAS runs for it (the port adds no kernel of its own on this
path), as a share of their roofline in %: the least time for one step's
batched products, site matrices and closure with their gradients
(``ring_work.step_bound_s``), over the summed device time per step of the
launches whose names are cuBLAS's contractions.

The names, from a traced window of the cell on the H100 (torch 2.11, CUDA
12.8): the batched products, the site matrices (one launch for all sites)
and their gradients (another) are
``sm80_xmma_gemm_f32f32_f32f32_f32_{nn,nt,tn,tt}_n_tilesize..._cublas``, the
closure's forward ``cutlass_80_simt_sgemm_128x32_8x5_nn_align1`` and its
split-k second pass ``cublasLt::splitKreduce_kernel``. ``gemv`` keeps a
closure that cuBLAS runs as a matrix-vector product at another batch. The
``stack`` of the site matrices' gradients (autograd's backward of
``unbind``) is a copy, not a contraction, and is left out."""

from tnbench import ring_work

PATTERN = r"gemm|gemv|splitKreduce_kernel"


def read(view):
    launches = view.matching(PATTERN)
    steps = view.counts.get("steps", 0)
    if not launches or not steps:
        return None
    per_step_s = sum(b - a for _, _, a, b in launches) / 1e6 / steps
    cfg = view.config
    bound = ring_work.step_bound_s(cfg["N"], cfg["M"], cfg["D"], cfg["L"], view.traffic["batch"])
    return 100.0 * bound / per_step_s
