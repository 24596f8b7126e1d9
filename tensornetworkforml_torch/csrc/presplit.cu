// The hybrid engine's fused pre-split step (kernel K2) for Hopper (sm_90a).
//
// Replaces: tensornetworkforml_tpu/ops/kernels/presplit_kernel.py, the Pallas
// kernel _presplit_kernel behind two_site_presplit_pallas. From the label
// core in carry layout lab (L, I, Mk), the right site a2m (Mk, DM), the site
// inputs x1, x2 (B, D), the environments l_env, r_env (B, M), targets and
// output y1h, f (L, B) and the sketch matrix om (L, DM, q) it computes, per
// label block o:
//   bt_o = lab_o a2m;  db_o = left_part^T (right_part * loss_der_o) - wd bt_o
//   eta  = lr * (sum|db| > sum|bt| ? sum|bt| / sum|db| : 1)   (L1 clip)
//   bnew_o = bt_o + eta db_o
//   y0 = sum_o bnew_o om_o;  G = sum_o bnew_o bnew_o^T
//   f_new[o, b] = sum_{r,s} left_part[b, r] bnew_o[r, s] right_part[b, s]
// with left_part[b, (a, i)] = l_env[b, a] x1[b, i] and right_part[b, (j, c)] =
// x2[b, j] r_env[b, c] built on the fly (the TPU kernel's 0/1 expander
// products were a Mosaic workaround), and the stats row
// [sum|bt|, sum|db|, |bnew|^2, sum|bnew|, acc, mae, mean|f|, 0].
//
// What bounds it on this card: the operations. At the flagship (L = 10,
// I = DM = 256, Mk = 128, B = 256, q = 128) it is ~5.9e8 FMA (G as one
// triangle) against ~12 MB of traffic, at M = 256 (I = DM = 512) ~3.4e9 FMA
// against ~24 MB, so the float32 FMA rate, and how many SMs have work, decide.
// Measured (PERF.md section 6), the copies into shared memory and the phases'
// tails take a third to a half of the time the FMAs alone would.
//
// Design: the clip is a dependency on ALL label blocks before any bnew
// exists, and blocks cannot carry a sum from one to the next, so the step is
// six launches on one stream (counted as one kernel):
//   prep_kernel       loss_der (L, B), left_part and its transpose,
//                     right_part (B, DM) and lab's transpose, each once;
//                     one block writes acc, mae and mean|f|;
//   gradient_kernel   a 64 x 64 tile (I-tile, DM-tile, o) of bt and db a
//                     block, with the tile's partial |bt| and |db| sums;
//   update_kernel     every block reduces the partials to eta in the same
//                     order and forms bnew (written out) with partial
//                     |bnew|^2 and |bnew| sums;
//   transpose_kernel  bnew's transpose, for G's and y0's operands;
//   products_kernel   per-label tiles of G (on and above the diagonal, each
//                     also written mirrored: G is symmetric) and y0, and
//                     per-(label, DM-tile) partials of f_new;
//   finish_kernel     sums the partials in fixed order.
// Every product is a 64 x 64 tile of float32 FMAs on 128 threads, 8 x 4
// outputs a thread. Both operands are read with the tile's index contiguous
// (hence the transposes), so that cp.async copies them 16 bytes at a time
// into shared memory, three chunks of 16 k in flight; a thread scales what it
// copied as it lands (right_part by loss_der, bnew by the growth cap). There
// are no float atomics: every sum has one order, and two runs agree bit for
// bit. The orders are those of this kernel's first version (presplit.cuh,
// header), so its outputs are the same bits. The device code is in
// presplit.cuh, which K7 (two_site_step.cu) shares.

#include <cuda_runtime.h>

#include "presplit.cuh"

extern "C" {

long tnml_presplit_scratch_floats(int L, int I, int DM, int B, int q) {
  return presplit::scratch_floats(L, I, DM, B, q);
}

int tnml_presplit(const float* lab, const float* a2m, const float* x1, const float* x2,
                  const float* l_env, const float* r_env, const float* y1h, const float* f,
                  const float* om, const float* lr, const float* wd, float* bnew, float* y0,
                  float* g, float* f_new, float* left_part, float* stats, float* scratch, int L,
                  int I, int Mk, int DM, int B, int D, int M, int q, int act, int loss, float temp,
                  void* stream_ptr) {
  presplit::Args a{};
  a.lab = lab; a.a2m = a2m; a.x1 = x1; a.x2 = x2; a.l_env = l_env; a.r_env = r_env;
  a.y1h = y1h; a.f = f; a.om = om; a.lr = lr; a.wd = wd;
  a.bnew = bnew; a.y0 = y0; a.g = g; a.f_new = f_new; a.left_part = left_part; a.stats = stats;
  a.L = L; a.I = I; a.Mk = Mk; a.DM = DM; a.B = B; a.D = D; a.M = M; a.q = q;
  a.with_gram = g != nullptr;
  a.act = act; a.loss = loss; a.temp = temp;
  presplit::fill_counts(a);
  return presplit::launch(a, scratch, (cudaStream_t)stream_ptr);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
