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
//              metrics = [acc, mae, sum|bt|, sum|db|], and mean|f| of the carried f
// with left[b, (a, i)] = l_env[b, a] x1[b, i] and right[b, (j, c)] =
// x2[b, j] r_env[b, c] built on the fly.
//
// What bounds it on this card: at the flagship (L = 10, M = 128, B = 256) the
// step is ~2.0e9 FLOP (pre-split 1.34e9, iteration 4.3e8, Q^T bn 1.7e8,
// left Q 1.7e7) against ~13 MB of traffic, so the operations: ~29 us at the
// float32 rate. The iteration's chain of ~60 dependent products on one
// cluster, as in K1, is what sets its time in practice.
//
// Design: the Pallas body is one program; here the step is a chain of eight
// launches on one stream (nine with renorm_envs) with no host work between
// them, counted as one kernel by the wrapper:
//   prep ... finish               K2's six launches (presplit.cuh), the
//                                 growth cap applied where products_kernel
//                                 loads bn;
//   polar_cluster / streaming     K1's iteration (polar_iterate.cuh) on
//                                 (y, G, n2), writing Q;
//   step_env_kernel               env = left Q as 64 x 64 tiles, each with
//                                 its partial row sums of squares; the
//                                 metrics row and mean|f| from K2's stats;
//                                 without renorm_envs (gg = 1) also
//                                 lab_new_o = Q^T (g_sc bn_o) as L tile GEMMs
//                                 straight into the next carry, K1 having
//                                 written Q into a_left and env being
//                                 lenv_new itself;
//   step_store_kernel             renorm_envs only: every block forms gg from
//                                 the partial row sums in one fixed order,
//                                 then writes a tile of lab_new_o =
//                                 (1 / gg) Q^T (g_sc bn_o), or a_left = gg Q
//                                 and lenv_new = gg env.
// Each output is written once, scaled at its store: no pass rereads lab_new.
// Every launch of the chain is a programmatic dependent launch (pdl.cuh): it
// may start while its predecessor runs, and waits in its first statement for
// the predecessor to complete. tnml_fused_sweep runs the chain for all N - 1
// steps of a sweep from one call, the counterpart of the JAX package's scan
// over steps, the carry (label core, left environment, output) alternating
// between two buffers.
// The Pallas kernel's 0/1 expander products, its batched/looped switch and its
// SMEM scalars were Mosaic workarounds: the two forms compute the same
// function, and there is one here. No float atomics: two launches agree bit
// for bit. Every product is a float32 FMA (tile_gemm.cuh).

#include <cuda_runtime.h>

#include <algorithm>

#include "layout.cuh"  // every part of the scratch on a 256-byte boundary
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
  const float* q;      // (I, M): Q from the iteration
  float* env;          // (B, M): left Q (lenv_new itself without renorm)
  float* a_left;       // (I, M): gg Q (renorm only; else K1 wrote Q there)
  float* lab_new;      // (L, M, JC)
  float* lenv_new;     // (B, M): gg env (renorm only)
  float* metrics;      // (4)
  float* mean_abs_f;   // (1) mean|f| of the carried output, or null
  float* rowss;        // (nM, B) partial row sums of env^2
  int L, I, M, JC, B;
  int nB, nM, nJ;      // tile counts over B, M and JC
};

int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

// A tile of lab_new_o = Q^T (g_sc bn_o), times inv at its store when scale
__device__ __forceinline__ void lab_tile(const StepArgs& a, Smem& sm, int job, bool scale,
                                         float inv) {
  const int I = a.I, M = a.M, JC = a.JC;
  const int tid = threadIdx.x, ty = tid / (T / 4), tx = tid % (T / 4);
  const int nt = job % a.nJ, mt = (job / a.nJ) % a.nM, o = job / (a.nJ * a.nM);
  const float gs = a.gsc != nullptr ? *a.gsc : 1.f;
  const float* bn = a.bnew + (size_t)o * I * JC;
  const float* q = a.q;
  float acc[4][4];
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
      if (m < M && n < JC) out[(size_t)m * JC + n] = scale ? inv * acc[i][j] : acc[i][j];
    }
}

// Blocks [0, nB nM): a tile of env = left Q and its rows' sums of squares;
// without renorm_envs the lab_new tiles follow (gg = 1, nothing to wait for).
// Block 0 also writes the metrics row and mean|f|.
__global__ void __launch_bounds__(NT) step_env_kernel(StepArgs a) {
  pdl::start();
  __shared__ Smem sm;
  __shared__ float rowpart[T][T / 4 + 1];
  const int I = a.I, M = a.M, B = a.B;
  const int tid = threadIdx.x, ty = tid / (T / 4), tx = tid % (T / 4);
  if (blockIdx.x == 0 && tid < 4) {
    const int src[4] = {4, 5, 0, 1};  // acc, mae, sum|bt|, sum|db| in the stats row
    a.metrics[tid] = a.stats[src[tid]];
    if (tid == 0 && a.mean_abs_f != nullptr) *a.mean_abs_f = a.stats[6];
  }
  if ((int)blockIdx.x >= a.nB * a.nM) {
    lab_tile(a, sm, blockIdx.x - a.nB * a.nM, false, 1.f);
    return;
  }
  const int bt = blockIdx.x % a.nB, mt = blockIdx.x / a.nB;
  const float* left = a.left;
  const float* q = a.q;
  float acc[4][4];
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
        a.env[(size_t)b * M + n] = acc[i][j];
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
}

// renorm_envs only. Every block forms gg = 1 / mean_b |env[b]| from the
// partial row sums, the same sums in the same order; blocks [0, L nM nJ)
// then write a lab_new tile times 1 / gg, the rest a_left = gg Q and
// lenv_new = gg env elementwise.
__global__ void __launch_bounds__(NT) step_store_kernel(StepArgs a) {
  pdl::start();
  __shared__ Smem sm;
  __shared__ float red[NT];
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int b = tid; b < a.B; b += NT) {
    float ss = 0.f;
    for (int mt = 0; mt < a.nM; ++mt) ss += a.rowss[(size_t)mt * a.B + b];
    s += sqrtf(ss);
  }
  s = block_sum<NT>(s, red) / (float)a.B;
  const float gg = 1.f / (s != s ? s : fmaxf(s, 1e-30f));
  const int tiles = a.L * a.nM * a.nJ;
  if ((int)blockIdx.x < tiles) {
    lab_tile(a, sm, blockIdx.x, true, 1.f / gg);
    return;
  }
  const size_t e = (size_t)(blockIdx.x - tiles) * NT + tid;
  if (e < (size_t)a.I * a.M) a.a_left[e] = a.q[e] * gg;
  if (e < (size_t)a.B * a.M) a.lenv_new[e] = a.env[e] * gg;
}

// The scratch of one step, in floats.
struct Layout {
  long bnew, y0, g, left, stats, gsc, rowss, q, env, pre, pol, floats;
};

Layout layout(int L, int M, int D, int B) {
  const long I = (long)M * D, JC = (long)D * M;
  Layout s;
  long o = 0;
  s.bnew = o; o += part(L * I * JC);
  s.y0 = o; o += part(I * M);
  s.g = o; o += part(I * I);
  s.left = o; o += part(B * I);
  s.stats = o; o += part(8);
  s.gsc = o; o += part(4);
  s.rowss = o; o += part((long)cdiv(M, T) * B);
  s.q = o; o += part(I * M);
  s.env = o; o += part((long)B * M);
  s.pre = o; o += part(presplit::scratch_floats(L, (int)I, (int)JC, B, M));
  s.pol = o; o += polar::scratch_floats((int)I, M);
  s.floats = o;
  return s;
}

// One step's inputs and outputs (mean_abs_f may be null).
struct StepIO {
  const float *lab, *a2m, *x1, *x2, *l_env, *r_env, *y1h, *f, *om, *lr, *wd;
  float *a_left, *lab_new, *lenv_new, *f_new, *metrics, *mean_abs_f;
};

struct StepShape {
  int L, M, D, B, act, loss;
  float temp;
  int renorm;
  float growth_cap;
  const Coeffs* loop;
  const Coeffs* fin;
};

// The step's launches on `st` (eight, nine with renorm_envs), each a
// programmatic dependent launch.
int run_step(const StepIO& io, float* scratch, const StepShape& sh, cudaStream_t st) {
  const int L = sh.L, M = sh.M, D = sh.D, B = sh.B, I = M * D, JC = D * M;
  const Layout s = layout(L, M, D, B);

  presplit::Args p{};
  p.lab = io.lab; p.a2m = io.a2m; p.x1 = io.x1; p.x2 = io.x2; p.l_env = io.l_env;
  p.r_env = io.r_env; p.y1h = io.y1h; p.f = io.f; p.om = io.om; p.lr = io.lr; p.wd = io.wd;
  p.bnew = scratch + s.bnew; p.y0 = scratch + s.y0; p.g = scratch + s.g; p.f_new = io.f_new;
  p.left_part = scratch + s.left; p.stats = scratch + s.stats;
  p.L = L; p.I = I; p.Mk = M; p.DM = JC; p.B = B; p.D = D; p.M = M; p.q = M;
  p.with_gram = 1;
  p.act = sh.act; p.loss = sh.loss; p.temp = sh.temp;
  p.growth_cap = sh.growth_cap; p.gsc = scratch + s.gsc;
  presplit::fill_counts(p);
  int err = presplit::launch(p, scratch + s.pre, st, true);
  if (err != 0) return err;

  // Q goes straight to a_left when no renormalisation scales it
  float* q = sh.renorm ? scratch + s.q : io.a_left;
  // n2 of the capped bn: stats[2]; dead_tol 1e-6, as the Pallas kernel
  err = polar::launch(p.y0, p.g, p.stats + 2, q, scratch + s.pol, I, M, 1, sh.loop, sh.fin,
                      1e-6f, st, true);
  if (err != 0) return err;

  StepArgs a{};
  a.bnew = p.bnew; a.left = p.left_part; a.gsc = sh.growth_cap > 0.f ? p.gsc : nullptr;
  a.stats = p.stats; a.q = q;
  a.env = sh.renorm ? scratch + s.env : io.lenv_new;
  a.a_left = io.a_left; a.lab_new = io.lab_new; a.lenv_new = io.lenv_new;
  a.metrics = io.metrics; a.mean_abs_f = io.mean_abs_f;
  a.rowss = scratch + s.rowss;
  a.L = L; a.I = I; a.M = M; a.JC = JC; a.B = B;
  a.nB = cdiv(B, T); a.nM = cdiv(M, T); a.nJ = cdiv(JC, T);
  const int tiles = L * a.nM * a.nJ;
  cudaError_t e = pdl::launch(step_env_kernel, a.nB * a.nM + (sh.renorm ? 0 : tiles), NT, 0,
                              st, true, a);
  if (e != cudaSuccess || !sh.renorm) return (int)e;
  const int n_el = cdiv(std::max((long)I * M, (long)B * M), NT);
  return (int)pdl::launch(step_store_kernel, tiles + n_el, NT, 0, st, true, a);
}

// A sweep's workspace, in floats: one step's scratch, then two buffers each
// of the carried label core, left environment and output.
struct SweepLayout {
  long step, lab, env, f, floats;
};

SweepLayout sweep_layout(int L, int M, int D, int B) {
  const long I = (long)M * D;
  SweepLayout w;
  long o = 0;
  w.step = o; o += part(layout(L, M, D, B).floats);
  w.lab = o; o += 2 * part(L * I * M);
  w.env = o; o += 2 * part((long)B * M);
  w.f = o; o += 2 * part((long)L * B);
  w.floats = o;
  return w;
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
  const StepIO io{lab, a2m, x1, x2, l_env, r_env, y1h, f, om, lr, wd,
                  a_left, lab_new, lenv_new, f_new, metrics, nullptr};
  const StepShape sh{L, M, D, B, act, loss, temp, renorm, growth_cap, loop, fin};
  return run_step(io, scratch, sh, (cudaStream_t)stream_ptr);
}

long tnml_sweep_work_floats(int L, int M, int D, int B) {
  return sweep_layout(L, M, D, B).floats;
}

// A whole fused sweep of N - 1 steps: step s takes the right site a2s[s]
// (N - 1, M, D, M), the site inputs x[s] and x[s + 1] (N, B, D) and the stale
// right environment r_env[s + 2] (N + 1, B, M); the carry starts at lab0
// (L, M*D, M), l_env0 (B, M) and f0 (L, B). Out: a_lefts (N - 1, M*D, M), the
// final label core lab_out (L, M, D*M) and output f_out (L, B), the metrics
// rows (N - 1, 4) and mean|f| of each step's carried output (N - 1).
int tnml_fused_sweep(const float* lab0, const float* a2s, const float* x, const float* r_env,
                     const float* y1h, const float* l_env0, const float* f0, const float* om,
                     const float* lr, const float* wd, float* a_lefts, float* lab_out,
                     float* f_out, float* metrics, float* mean_abs_f, float* work, int N, int L,
                     int M, int D, int B, int act, int loss, float temp, int renorm,
                     float growth_cap, const Coeffs* loop, const Coeffs* fin, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const long I = (long)M * D;
  const SweepLayout w = sweep_layout(L, M, D, B);
  const long n_lab = part(L * I * M), n_env = part((long)B * M), n_f = part((long)L * B);
  float* lab_buf[2] = {work + w.lab, work + w.lab + n_lab};
  float* env_buf[2] = {work + w.env, work + w.env + n_env};
  float* f_buf[2] = {work + w.f, work + w.f + n_f};
  const StepShape sh{L, M, D, B, act, loss, temp, renorm, growth_cap, loop, fin};
  for (int s = 0; s < N - 1; ++s) {
    const bool first = s == 0, last = s == N - 2;
    const int in = (s + 1) & 1, out = s & 1;  // step s - 1 wrote buffer (s - 1) & 1
    StepIO io{};
    io.lab = first ? lab0 : lab_buf[in];
    io.a2m = a2s + (size_t)s * M * D * M;
    io.x1 = x + (size_t)s * B * D;
    io.x2 = x + (size_t)(s + 1) * B * D;
    io.l_env = first ? l_env0 : env_buf[in];
    io.r_env = r_env + (size_t)(s + 2) * B * M;
    io.y1h = y1h;
    io.f = first ? f0 : f_buf[in];
    io.om = om; io.lr = lr; io.wd = wd;
    io.a_left = a_lefts + (size_t)s * I * M;
    io.lab_new = last ? lab_out : lab_buf[out];
    io.lenv_new = env_buf[out];
    io.f_new = last ? f_out : f_buf[out];
    io.metrics = metrics + (size_t)s * 4;
    io.mean_abs_f = mean_abs_f + s;
    const int err = run_step(io, work + w.step, sh, st);
    if (err != 0) return err;
  }
  return 0;
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
