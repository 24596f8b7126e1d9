// The fused engine's whole two-site step (kernel K7) for Hopper (sm_90a).
//
// Replaces: tensornetworkforml_tpu/ops/kernels/step_kernel.py, the Pallas
// kernel _step_kernel behind two_site_step_pallas. From the label core in
// carry layout lab (L, I, M) (I = M*D), the right site a2m (M, JC) (JC = D*M),
// the site inputs x1, x2 (B, D), the environments l_env, r_env (B, M), targets
// and output y1h, f (L, B), the sketch matrix om (L, JC, M), lr and wd, it
// computes one step of engine="fused":
//   pre-split  bt_o = lab_o a2m;  db_o = left^T (right * loss_der_o) - wd bt_o
//              bn_o = bt_o + eta db_o          (eta: lr and the L1 clip)
//              bn_o *= g_sc                    (growth cap, g_sc <= 1)
//              f_new;  n2 = |bn|_F^2;  y = sum_o bn_o om_o;  G = sum_o bn_o bn_o^T
//   split      Q = NS_final(colnorm((G / n2) NS_loop(colnorm(y))))
//   epilogue   lenv_new = left Q;  gg = 1 / mean_b |lenv_new[b]| (renorm_envs,
//              else 1);  a_left = gg Q;  lenv_new *= gg
//              lab_new_o = (1 / gg) Q^T bn_o (M, JC): the next step's carry
//              metrics = [acc, mae, sum|bt|, sum|db|]
// with left[b, (a, i)] = l_env[b, a] x1[b, i] and right[b, (j, c)] =
// x2[b, j] r_env[b, c] built on the fly.
//
// What bounds it on this card: at the flagship (L = 10, M = 128, B = 256) the
// step is ~2.0e9 FLOP (pre-split 1.34e9, iteration 4.3e8, Q^T bn 1.7e8,
// left Q 1.7e7) against ~13 MB of traffic, so the operations: ~29 us at the
// float32 rate. The iteration's chain of ~60 dependent products on one
// cluster, as in K1, is what sets its time in practice.
//
// Design: the Pallas body is one program; here the step is a chain of
// launches on one stream with no host work between them, counted as one
// kernel by the wrapper:
//   prep ... finish               K2's six launches (presplit.cuh), the
//                                 growth cap applied where products_kernel
//                                 loads bn;
//   polar_cluster / streaming     K1's iteration (polar_iterate.cuh) on
//                                 (y, G, n2), writing Q into a_left;
//   step_product_kernel           lenv_new = left Q as 64 x 64 tiles, each
//                                 with its partial row sums of squares, and
//                                 lab_new_o = Q^T (g_sc bn_o) as L tile GEMMs
//                                 written straight into the next carry;
//   step_scale_kernel             gg from the partial row sums in one fixed
//                                 order (every block alike), the scaling and
//                                 the metrics row.
// The Pallas kernel's 0/1 expander products, its batched/looped switch and its
// SMEM scalars were Mosaic workarounds: the two forms compute the same
// function, and there is one here. No float atomics: two launches agree bit
// for bit. Every product is a float32 FMA (tile_gemm.cuh).

#include <cuda_runtime.h>

#include <algorithm>

#include "polar_iterate.cuh"
#include "presplit.cuh"

namespace {

constexpr int NT = 256;
constexpr int T = 64, TK = 16;
using Smem = TileSmem<T, T, TK>;

struct StepArgs {
  const float* bnew;   // (L, I, JC), before the growth cap
  const float* left;   // (B, I)
  const float* gsc;    // (1) g_sc, or null: no cap
  const float* stats;  // (8) the pre-split stats row
  float* a_left;       // (I, M): Q from the iteration, scaled in place
  float* lab_new;      // (L, M, JC)
  float* lenv_new;     // (B, M)
  float* metrics;      // (4)
  float* rowss;        // (nM, B) partial row sums of lenv_new^2
  int L, I, M, JC, B;
  int nB, nM, nJ;      // tile counts over B, M and JC
  int renorm;
};

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }
long round4(long n) { return (n + 3) / 4 * 4; }

__global__ void __launch_bounds__(NT) step_product_kernel(StepArgs a) {
  __shared__ Smem sm;
  __shared__ float rowpart[T][T / 4 + 1];
  const int I = a.I, M = a.M, JC = a.JC, B = a.B;
  const int tid = threadIdx.x, ty = tid / (T / 4), tx = tid % (T / 4);
  const float* q = a.a_left;
  float acc[4][4];
  int job = blockIdx.x;
  if (job < a.nB * a.nM) {  // a tile of lenv_new = left Q, and its rows' sums of squares
    const int bt = job % a.nB, mt = job / a.nB;
    const float* left = a.left;
    tile_gemm<T, T, TK, NT, true, false>(
        sm, bt * T, mt * T, I,
        [=](int b, int k) { return (b < B && k < I) ? left[(size_t)b * I + k] : 0.f; },
        [=](int k, int n) { return (k < I && n < M) ? q[(size_t)k * M + n] : 0.f; }, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = bt * T + ty * 4 + i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = mt * T + tx * 4 + j;
        if (b < B && n < M) {
          a.lenv_new[(size_t)b * M + n] = acc[i][j];
          s = fmaf(acc[i][j], acc[i][j], s);
        }
      }
      rowpart[ty * 4 + i][tx] = s;
    }
    __syncthreads();
    if (tid < T) {
      const int b = bt * T + tid;
      float s = 0.f;
      for (int p = 0; p < T / 4; ++p) s += rowpart[tid][p];
      if (b < B) a.rowss[(size_t)mt * B + b] = s;
    }
    return;
  }
  job -= a.nB * a.nM;  // a tile of lab_new_o = Q^T (g_sc bn_o)
  const int nt = job % a.nJ, mt = (job / a.nJ) % a.nM, o = job / (a.nJ * a.nM);
  const float gs = a.gsc != nullptr ? *a.gsc : 1.f;
  const float* bn = a.bnew + (size_t)o * I * JC;
  tile_gemm<T, T, TK, NT, false, false>(
      sm, mt * T, nt * T, I,
      [=](int m, int k) { return (m < M && k < I) ? q[(size_t)k * M + m] : 0.f; },
      [=](int k, int n) { return (k < I && n < JC) ? bn[(size_t)k * JC + n] * gs : 0.f; }, acc);
  float* out = a.lab_new + (size_t)o * M * JC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = mt * T + ty * 4 + i, n = nt * T + tx * 4 + j;
      if (m < M && n < JC) out[(size_t)m * JC + n] = acc[i][j];
    }
}

__global__ void __launch_bounds__(NT) step_scale_kernel(StepArgs a) {
  __shared__ float red[NT];
  const int tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < 4) {
    const int src[4] = {4, 5, 0, 1};  // acc, mae, sum|bt|, sum|db| in the stats row
    a.metrics[tid] = a.stats[src[tid]];
  }
  if (!a.renorm) return;
  // gg = 1 / mean_b |lenv_new[b]|, the same sums in the same order in every block
  float s = 0.f;
  for (int b = tid; b < a.B; b += NT) {
    float ss = 0.f;
    for (int mt = 0; mt < a.nM; ++mt) ss += a.rowss[(size_t)mt * a.B + b];
    s += sqrtf(ss);
  }
  s = block_sum<NT>(s, red) / (float)a.B;
  const float gg = 1.f / (s != s ? s : fmaxf(s, 1e-30f));
  const float inv = 1.f / gg;
  const size_t e = (size_t)blockIdx.x * NT + tid;
  if (e < (size_t)a.I * a.M) a.a_left[e] *= gg;
  if (e < (size_t)a.B * a.M) a.lenv_new[e] *= gg;
  if (e < (size_t)a.L * a.M * a.JC) a.lab_new[e] = inv * a.lab_new[e];
}

// The scratch of one step, in floats, each part 16-byte aligned.
struct Layout {
  long bnew, y0, g, left, stats, gsc, rowss, pre, pol, floats;
};

Layout layout(int L, int M, int D, int B) {
  const long I = (long)M * D, JC = (long)D * M;
  Layout s;
  long o = 0;
  s.bnew = o; o += round4(L * I * JC);
  s.y0 = o; o += round4(I * M);
  s.g = o; o += round4(I * I);
  s.left = o; o += round4(B * I);
  s.stats = o; o += 8;
  s.gsc = o; o += 4;
  s.rowss = o; o += round4((long)cdiv(M, T) * B);
  s.pre = o; o += round4(presplit::scratch_floats(L, (int)I, (int)JC, B, M));
  s.pol = o; o += polar::scratch_floats((int)I, M);
  s.floats = o;
  return s;
}

}  // namespace

extern "C" {

long tnml_step_scratch_floats(int L, int M, int D, int B) { return layout(L, M, D, B).floats; }

int tnml_two_site_step(const float* lab, const float* a2m, const float* x1, const float* x2,
                       const float* l_env, const float* r_env, const float* y1h, const float* f,
                       const float* om, const float* lr, const float* wd, float* a_left,
                       float* lab_new, float* lenv_new, float* f_new, float* metrics,
                       float* scratch, int L, int M, int D, int B, int act, int loss, float temp,
                       int renorm, float growth_cap, const Coeffs* loop, const Coeffs* fin,
                       void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int I = M * D, JC = D * M;
  const Layout s = layout(L, M, D, B);

  presplit::Args p{};
  p.lab = lab; p.a2m = a2m; p.x1 = x1; p.x2 = x2; p.l_env = l_env; p.r_env = r_env;
  p.y1h = y1h; p.f = f; p.om = om; p.lr = lr; p.wd = wd;
  p.bnew = scratch + s.bnew; p.y0 = scratch + s.y0; p.g = scratch + s.g; p.f_new = f_new;
  p.left_part = scratch + s.left; p.stats = scratch + s.stats;
  p.L = L; p.I = I; p.Mk = M; p.DM = JC; p.B = B; p.D = D; p.M = M; p.q = M;
  p.with_gram = 1;
  p.act = act; p.loss = loss; p.temp = temp;
  p.growth_cap = growth_cap; p.gsc = scratch + s.gsc;
  presplit::fill_counts(p);
  int err = presplit::launch(p, scratch + s.pre, st);
  if (err != 0) return err;

  // n2 of the capped bn: stats[2]; dead_tol 1e-6, as the Pallas kernel
  err = polar::launch(p.y0, p.g, p.stats + 2, a_left, scratch + s.pol, I, M, 1, loop, fin, 1e-6f,
                      st);
  if (err != 0) return err;

  StepArgs a{};
  a.bnew = p.bnew; a.left = p.left_part; a.gsc = growth_cap > 0.f ? p.gsc : nullptr;
  a.stats = p.stats;
  a.a_left = a_left; a.lab_new = lab_new; a.lenv_new = lenv_new; a.metrics = metrics;
  a.rowss = scratch + s.rowss;
  a.L = L; a.I = I; a.M = M; a.JC = JC; a.B = B;
  a.nB = cdiv(B, T); a.nM = cdiv(M, T); a.nJ = cdiv(JC, T);
  a.renorm = renorm;
  step_product_kernel<<<a.nB * a.nM + L * a.nM * a.nJ, NT, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long n = std::max({(long)I * M, (long)B * M, (long)L * M * JC});
  step_scale_kernel<<<renorm ? cdiv(n, NT) : 1, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
