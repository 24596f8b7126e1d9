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
// I = DM = 256, Mk = 128, B = 256, q = 128) it is ~6.7e8 FMA against ~12 MB
// of traffic, so the float32 FMA rate, and how many SMs have work, decide.
//
// Design: the clip is a dependency on ALL label blocks before any bnew
// exists, and blocks cannot carry a sum from one to the next, so the step is
// four launches (counted as one kernel):
//   A  tiles over (I-tile, DM-tile, o): bt and db to scratch, per-block
//      partial |bt| and |db| sums; one block writes acc, mae and mean|f|,
//      the blocks of the first column write left_part;
//   B  every block reduces the partials to eta in the same order and forms
//      bnew (written out) with partial |bnew|^2 and |bnew| sums;
//   C  G, y0 and f_new as per-label (and, for f, per-DM-tile) partial tiles,
//      so that enough blocks have work;
//   D  sums the partials in fixed order.
// There are no float atomics: every sum has one order, and two runs agree
// bit for bit. All products are float32 FMAs in 64 x 64 tiles (tile_gemm.cuh).
// The device code is in presplit.cuh, which K7 (two_site_step.cu) shares.

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
