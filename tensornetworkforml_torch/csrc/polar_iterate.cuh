// The polar split's subspace iteration (K1) as device code, shared by
// polar_iterate.cu (K1 alone, and K8's iteration) and two_site_step.cu (K7's
// split stage). The design is described in
// polar_iterate.cu; launch() runs the resident or the streaming kernel, as
// the shapes allow, on one 8-CTA cluster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

// A schedule of per-pass (a, b, c) coefficients; the layout of the Python
// side's ctypes structure. Outside the anonymous namespace: the exported C
// entry point takes it.
constexpr int MAX_PASSES = 64;

struct Coeffs {
  int n;
  float c[3 * MAX_PASSES];
};

namespace {
namespace polar {

constexpr int CLUSTER = 8;
constexpr int KS = 2;           // thread groups splitting each product's k range
constexpr int NG = 128;         // threads per group: one 4 x 4 sub-tile each
constexpr int NT = NG * KS;     // threads per CTA
constexpr int TM = 128, TN = 16, TK = 16;
constexpr int PART = (KS - 1) * 16 * NG;  // the groups' partial sums
constexpr long SMEM_LIMIT = 232448;       // bytes of shared memory a block may use

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int col_block(int q) { return round4((q + CLUSTER - 1) / CLUSTER); }
// row stride of the resident y and W: a multiple of 4 (float4 rows), 4 mod 8
// words when q is, so that strided row reads spread over the banks
__host__ __device__ inline int ld_of(int q) { return round4(q) + 4; }

struct Ctx {
  const float* g;
  int I, q, c0, nc;  // this CTA's columns: [c0, c0 + nc)
  float* W;
  float* P;
  float* nrm;
  float* rs;
  float dead_tol;
  float bn2;
};

__device__ __forceinline__ void cluster_barrier() {
  __threadfence();  // make this CTA's global writes visible at device scope
  cg::this_cluster().sync();
}

__device__ __forceinline__ void block_barrier() {
  __threadfence();
  __syncthreads();
}

using Smem = TileSmem<TM, TN, TK, KS>;

// out(m, c0 + n) for m < M, n < nc:  sum_k la(m, k) lb(k, n), then epi(m, j, v)
template <bool A_KFAST, class LA, class LB, class EPI>
__device__ __forceinline__ void gemm_cols(Smem& sm, const Ctx cx, int M, int K, const LA& la, const LB& lb,
                          const EPI& epi) {
  const int tid = threadIdx.x % NG, ty = tid / (TN / 4), tx = tid % (TN / 4);
  for (int m0 = 0; m0 < M; m0 += TM)
    for (int n0 = 0; n0 < cx.nc; n0 += TN) {
      float acc[4][4];
      if (!tile_gemm<TM, TN, TK, NG, A_KFAST, false, KS>(sm, m0, n0, K, la, lb, acc)) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
          if (m < M && n < cx.nc) epi(m, cx.c0 + n, acc[i][j]);
        }
    }
}

// dst[:, cb] = colnorm(src)[:, cb]; dst may equal src (only own columns move)
__device__ __forceinline__ void colnorm(float* red, const Ctx cx, const float* src, float* dst) {
  const int I = cx.I, q = cx.q;
  // column sums of squares: thread t sums rows i = t / 16 (mod 8) of column t % 16
  for (int j0 = 0; j0 < cx.nc; j0 += 16) {
    const int jj = threadIdx.x % 16, part = threadIdx.x / 16;
    const int j = cx.c0 + j0 + jj;
    float s = 0.f;
    if (j0 + jj < cx.nc)
      for (int i = part; i < I; i += NT / 16) {
        const float v = __ldcg(src + (size_t)i * q + j);
        s = fmaf(v, v, s);
      }
    __syncthreads();
    red[threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.x < 16 && j0 + threadIdx.x < cx.nc) {
      float t = 0.f;
      for (int p = 0; p < NT / 16; ++p) t += red[p * 16 + threadIdx.x];
      cx.nrm[cx.c0 + j0 + threadIdx.x] = sqrtf(t);
    }
  }
  cluster_barrier();
  float mx = -__int_as_float(0x7f800000);
  for (int j = threadIdx.x; j < q; j += NT) mx = nanmax(mx, __ldcg(cx.nrm + j));
  const float n_max = block_max<NT>(mx, red);
  for (int e = threadIdx.x; e < I * cx.nc; e += NT) {
    const int i = e / cx.nc, j = cx.c0 + e % cx.nc;
    const float n = __ldcg(cx.nrm + j);
    const bool live = (n > cx.dead_tol * n_max) && isfinite(n);
    const float v = __ldcg(src + (size_t)i * q + j);
    dst[(size_t)i * q + j] = live ? v / fmaxf(n, 1e-30f) : 0.f;
  }
  cluster_barrier();
}

// W[:, cb] = y^T y[:, cb]
__device__ __forceinline__ void gram_cols(Smem& sm, const Ctx cx, const float* y) {
  const int I = cx.I, q = cx.q, c0 = cx.c0, nc = cx.nc;
  auto la = [=](int m, int k) { return (m < q && k < I) ? __ldcg(y + (size_t)k * q + m) : 0.f; };
  auto lb = [=](int k, int n) { return (k < I && n < nc) ? __ldcg(y + (size_t)k * q + c0 + n) : 0.f; };
  float* W = cx.W;
  gemm_cols<false>(sm, cx, q, I, la, lb, [=](int m, int j, float v) { W[(size_t)m * q + j] = v; });
}

// polar Newton-Schulz on y (own columns in place for the prescale); the passes
// alternate between y and other; returns the buffer holding the result
__device__ __forceinline__ float* polar_ns(Smem& sm, float* red, const Ctx cx, float* y,
                                           float* other, const Coeffs& co) {
  const int I = cx.I, q = cx.q, c0 = cx.c0, nc = cx.nc;
  // prescale: y /= sqrt(max_i sum_j |W_ij|); W symmetric, so row sums are column sums
  gram_cols(sm, cx, y);
  block_barrier();
  for (int jj = threadIdx.x; jj < nc; jj += NT) {
    const int j = c0 + jj;
    float s = 0.f;
    for (int m = 0; m < q; ++m) s += fabsf(__ldcg(cx.W + (size_t)m * q + j));
    cx.rs[j] = s;
  }
  cluster_barrier();
  float mx = -__int_as_float(0x7f800000);
  for (int j = threadIdx.x; j < q; j += NT) mx = nanmax(mx, __ldcg(cx.rs + j));
  const float rowsum = block_max<NT>(mx, red);
  const float scale = sqrtf(rowsum != rowsum ? rowsum : fmaxf(rowsum, 1e-30f));
  for (int e = threadIdx.x; e < I * nc; e += NT) {
    const size_t idx = (size_t)(e / nc) * q + c0 + e % nc;
    y[idx] = __ldcg(y + idx) / scale;
  }
  cluster_barrier();

  const float* W = cx.W;
  float* P = cx.P;
  for (int p = 0; p < co.n; ++p) {
    const float a = co.c[3 * p], b = co.c[3 * p + 1], c = co.c[3 * p + 2];
    gram_cols(sm, cx, y);
    cluster_barrier();
    // P[:, cb] = (a I + b W[:, cb]) + c (W W)[:, cb]; W[m, k] read as W[k, m]
    auto la_w = [=](int m, int k) { return (m < q && k < q) ? __ldcg(W + (size_t)k * q + m) : 0.f; };
    auto lb_w = [=](int k, int n) { return (k < q && n < nc) ? __ldcg(W + (size_t)k * q + c0 + n) : 0.f; };
    gemm_cols<false>(sm, cx, q, q, la_w, lb_w, [=](int m, int j, float v) {
      const float t = (m == j ? a : 0.f) + b * __ldcg(W + (size_t)m * q + j);
      P[(size_t)m * q + j] = t + c * v;
    });
    block_barrier();
    // other[:, cb] = y P[:, cb]
    auto la_y = [=](int m, int k) { return (m < I && k < q) ? __ldcg(y + (size_t)m * q + k) : 0.f; };
    auto lb_p = [=](int k, int n) { return (k < q && n < nc) ? __ldcg(P + (size_t)k * q + c0 + n) : 0.f; };
    gemm_cols<true>(sm, cx, I, q, la_y, lb_p,
                    [=](int m, int j, float v) { other[(size_t)m * q + j] = v; });
    cluster_barrier();
    float* t = y;
    y = other;
    other = t;
  }
  return y;
}

// ---- the resident path ------------------------------------------------------

// Shared-memory layout of the resident path, in floats: y (I x ld), then a
// region that holds W (q x ld), the P block (q x pld) and the groups' partial
// sums during a pass, or a KC-column chunk of g (I x (KC + 1)), the partial
// sums and the (I x pld) sum of g y's columns; then NT floats for block
// reductions.
constexpr int KC = 32;

struct Resident {
  int ld, pld;
  long y, w, p, part, gc, gpart, gacc, red, floats;
};

__host__ __device__ inline Resident resident_layout(int I, int q) {
  Resident r;
  r.ld = ld_of(q);
  r.pld = col_block(q) + 4;
  r.y = 0;
  r.w = (long)I * r.ld;
  r.p = r.w + (long)q * r.ld;
  r.part = r.p + (long)q * r.pld;
  r.gc = r.w;
  r.gpart = r.gc + (long)I * (KC + 1);
  r.gacc = r.gpart + PART;
  const long pass_end = r.part + PART, gy_end = r.gacc + (long)I * r.pld;
  r.red = pass_end > gy_end ? pass_end : gy_end;
  r.floats = r.red + NT;
  return r;
}

// out(m, n) = sum_k A(m, k) B(k, n) for m < M, n < nc, all operands in shared
// memory: B(k, n) = b[k*ldb + n] (rows of 4-aligned floats); A(m, k) =
// a[k*lda + m] when AT (this thread's 4 consecutive rows in one float4), else
// a[m*lda + k] (this thread's rows m0 + ty + 32 i). The two thread groups take
// the two halves of the k range; group 0 adds group 1's sums and calls
// epi(m, n, v).
template <bool AT, class EPI>
__device__ __forceinline__ void sgemm(const float* a, int lda, const float* b, int ldb, int M,
                                      int nc, int K, float* part, const EPI& epi) {
  const int grp = threadIdx.x / NG, tid = threadIdx.x % NG, ty = tid / 4, tx = tid % 4;
  const int kh = (K + 1) / 2, k_lo = grp * kh, k_hi = min(K, k_lo + kh);
  for (int m0 = 0; m0 < M; m0 += TM)
    for (int n0 = 0; n0 < nc; n0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const int nb = n0 + 4 * tx;
      const bool active = nb < nc && (AT ? m0 + 4 * ty < M : m0 + ty < M);
      if (active) {
#pragma unroll 4
        for (int k = k_lo; k < k_hi; ++k) {
          const float4 bv4 = *reinterpret_cast<const float4*>(b + (size_t)k * ldb + nb);
          const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
          float av[4];
          if (AT) {
            const float4 t = *reinterpret_cast<const float4*>(a + (size_t)k * lda + m0 + 4 * ty);
            av[0] = t.x; av[1] = t.y; av[2] = t.z; av[3] = t.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = m0 + ty + 32 * i;
              av[i] = m < M ? a[(size_t)m * lda + k] : 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[(i * 4 + j) * NG + tid] = acc[i][j];
      }
      __syncthreads();
      if (grp == 0 && active) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = AT ? m0 + 4 * ty + i : m0 + ty + 32 * i, n = nb + j;
            if (m < M && n < nc) epi(m, n, acc[i][j] + part[(i * 4 + j) * NG + tid]);
          }
      }
    }
}

// dst (rows x cols, stride ldd) <- src (stride lds) with cp.async: each
// thread queues all its copies, which hold no registers, then waits once, so
// the reload costs about one L2 round trip plus its bytes. 16-byte copies
// (.cg: L2 only, safe for data other CTAs wrote) when rows and pointers are
// 16-byte aligned; otherwise 4-byte copies (.ca), used only for the kernel's
// inputs y and g, which nothing writes during the launch.
__device__ __forceinline__ void load_rows(float* dst, int ldd, const float* src, int lds,
                                          int rows, int cols) {
  const bool wide = lds % 4 == 0 && ldd % 4 == 0 && cols % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (wide) {
    const int c4 = cols / 4;
    for (int e = threadIdx.x; e < rows * c4; e += NT) {
      const int i = e / c4, j = (e % c4) * 4;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + (size_t)i * ldd + j);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + (size_t)i * lds + j));
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += NT) {
      const int i = e / cols, j = e % cols;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + (size_t)i * ldd + j);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src + (size_t)i * lds + j));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// colnorm of the resident y, every column, the same in every CTA (no barrier
// across the cluster); nrm is q floats of scratch
__device__ __forceinline__ void colnorm_resident(float* y, int ld, float* nrm, float* red,
                                                 const Ctx cx) {
  const int I = cx.I, q = cx.q;
  float mx = -__int_as_float(0x7f800000);
  for (int j = threadIdx.x; j < q; j += NT) {
    float s = 0.f;
    for (int i = 0; i < I; ++i) s = fmaf(y[(size_t)i * ld + j], y[(size_t)i * ld + j], s);
    nrm[j] = sqrtf(s);
    mx = nanmax(mx, nrm[j]);
  }
  const float n_max = block_max<NT>(mx, red);
  for (int e = threadIdx.x; e < I * q; e += NT) {
    const int i = e / q, j = e % q;
    const float n = nrm[j];
    const bool live = (n > cx.dead_tol * n_max) && isfinite(n);
    y[(size_t)i * ld + j] = live ? y[(size_t)i * ld + j] / fmaxf(n, 1e-30f) : 0.f;
  }
  __syncthreads();
}

// polar Newton-Schulz on the resident y; yg is global scratch (I x ld) for
// the new columns, wg (q x ld) for W's columns, rs (q) for its column sums
__device__ __forceinline__ void polar_ns_resident(float* sm, const Resident lay, float* red,
                                                  const Ctx cx, float* yg, float* wg,
                                                  float* rs, const Coeffs& co) {
  const int I = cx.I, q = cx.q, c0 = cx.c0, nc = cx.nc, ld = lay.ld, pld = lay.pld;
  float* y = sm + lay.y;
  float* w = sm + lay.w;
  float* pb = sm + lay.p;
  float* part = sm + lay.part;
  // W[:, cb] = y^T y[:, cb] to global
  auto gram = [&]() {
    sgemm<true>(y, ld, y + c0, ld, q, nc, I, part,
                [=](int m, int n, float v) { wg[(size_t)m * ld + c0 + n] = v; });
  };
  // prescale: y /= sqrt(max_i sum_j |W_ij|); W symmetric, so row sums are column sums
  gram();
  block_barrier();
  for (int jj = threadIdx.x; jj < nc; jj += NT) {
    float s = 0.f;
#pragma unroll 8
    for (int m = 0; m < q; ++m) s += fabsf(__ldcg(wg + (size_t)m * ld + c0 + jj));
    rs[c0 + jj] = s;
  }
  cluster_barrier();
  float mx = -__int_as_float(0x7f800000);
  for (int j = threadIdx.x; j < q; j += NT) mx = nanmax(mx, __ldcg(rs + j));
  const float rowsum = block_max<NT>(mx, red);
  const float scale = sqrtf(rowsum != rowsum ? rowsum : fmaxf(rowsum, 1e-30f));
  for (int e = threadIdx.x; e < I * q; e += NT) {
    const size_t idx = (size_t)(e / q) * ld + e % q;
    y[idx] = y[idx] / scale;
  }
  __syncthreads();

  for (int p = 0; p < co.n; ++p) {
    const float a = co.c[3 * p], b = co.c[3 * p + 1], c = co.c[3 * p + 2];
    gram();
    cluster_barrier();
    load_rows(w, ld, wg, ld, q, round4(q));
    __syncthreads();
    // P[:, cb] = (a I + b W[:, cb]) + c (W W)[:, cb]; W[m, k] read as W[k, m]
    sgemm<true>(w, ld, w + c0, ld, q, nc, q, part, [=](int m, int n, float v) {
      const float t = (m == c0 + n ? a : 0.f) + b * w[(size_t)m * ld + c0 + n];
      pb[m * pld + n] = t + c * v;
    });
    __syncthreads();
    // y'[:, cb] = y P[:, cb] to global, then every CTA reloads all of y'
    sgemm<false>(y, ld, pb, pld, I, nc, q, part,
                 [=](int m, int n, float v) { yg[(size_t)m * ld + c0 + n] = v; });
    cluster_barrier();
    load_rows(y, ld, yg, ld, I, round4(q));
    __syncthreads();
  }
}

// The resident path: see the note at the top.
__device__ __forceinline__ void run_resident(float* sm, Ctx cx, const float* y_in,
                                             float* q_out, float* scratch, int n_power,
                                             const Coeffs& loop, const Coeffs& fin) {
  const int I = cx.I, q = cx.q, c0 = cx.c0, nc = cx.nc;
  const Resident lay = resident_layout(I, q);
  const int ld = lay.ld;
  float* y = sm + lay.y;
  float* red = sm + lay.red;
  float* yg = scratch;
  float* yg2 = yg + (size_t)I * ld;
  float* wg = yg2 + (size_t)I * ld;
  float* rs = wg + (size_t)q * ld;

  load_rows(y, ld, y_in, q, I, q);
  __syncthreads();
  for (int p = 0; p < n_power; ++p) {
    colnorm_resident(y, ld, sm + lay.w, red, cx);
    polar_ns_resident(sm, lay, red, cx, yg, wg, rs, loop);
    // yg2[:, cb] = (g / n2) y[:, cb], KC columns of g at a time through shared
    // memory; each (m, n) belongs to one thread, which adds the chunks' sums
    // in chunk order
    float* gc = sm + lay.gc;
    float* gpart = sm + lay.gpart;
    float* gacc = sm + lay.gacc;
    const int pld = lay.pld;
    for (int k0 = 0; k0 < I; k0 += KC) {
      const int kc = min(KC, I - k0);
      __syncthreads();
      load_rows(gc, KC + 1, cx.g + k0, I, I, kc);
      for (int e = threadIdx.x; e < I * kc; e += NT) {  // g / n2, as the plain version
        float* v = gc + (size_t)(e / kc) * (KC + 1) + e % kc;
        *v = *v / cx.bn2;
      }
      __syncthreads();
      sgemm<false>(gc, KC + 1, y + (size_t)k0 * ld + c0, ld, I, nc, kc, gpart,
                   [=](int m, int n, float v) {
                     gacc[m * pld + n] = k0 == 0 ? v : gacc[m * pld + n] + v;
                   });
    }
    __syncthreads();
    for (int e = threadIdx.x; e < I * nc; e += NT) {
      const int m = e / nc, n = e % nc;
      yg2[(size_t)m * ld + c0 + n] = gacc[m * pld + n];
    }
    cluster_barrier();
    load_rows(y, ld, yg2, ld, I, round4(q));
    __syncthreads();
  }
  colnorm_resident(y, ld, sm + lay.w, red, cx);
  polar_ns_resident(sm, lay, red, cx, yg, wg, rs, fin);
  for (int e = threadIdx.x; e < I * nc; e += NT) {
    const int i = e / nc, j = c0 + e % nc;
    q_out[(size_t)i * q + j] = y[(size_t)i * ld + j];
  }
}

// The streaming path: see the note at the top.
__device__ __forceinline__ void run_streaming(float* sm, Ctx cx, const float* y_in,
                                              float* q_out, float* scratch, int n_power,
                                              const Coeffs& loop, const Coeffs& fin) {
  const int I = cx.I, q = cx.q;
  Smem& tile = *reinterpret_cast<Smem*>(sm);
  float* red = sm + sizeof(Smem) / sizeof(float);
  float* ya = scratch;
  float* yb = ya + (size_t)I * q;
  cx.W = yb + (size_t)I * q;
  cx.P = cx.W + (size_t)q * q;
  cx.nrm = cx.P + (size_t)q * q;
  cx.rs = cx.nrm + q;
  const float* src = y_in;
  float* cur = ya;
  for (int p = 0; p < n_power; ++p) {
    colnorm(red, cx, src, cur);
    float* res = polar_ns(tile, red, cx, cur, cur == ya ? yb : ya, loop);
    float* dst = res == ya ? yb : ya;
    // dst[:, cb] = (g / n2) res[:, cb]: only this CTA's columns of res
    const float bn = cx.bn2;
    const float* g = cx.g;
    const int c0 = cx.c0, nc = cx.nc;
    auto la_g = [=](int m, int k) { return (m < I && k < I) ? __ldg(g + (size_t)m * I + k) / bn : 0.f; };
    auto lb_r = [=](int k, int n) { return (k < I && n < nc) ? __ldcg(res + (size_t)k * q + c0 + n) : 0.f; };
    gemm_cols<true>(tile, cx, I, I, la_g, lb_r,
                    [=](int m, int j, float v) { dst[(size_t)m * q + j] = v; });
    block_barrier();
    src = dst;
    cur = dst;
  }
  colnorm(red, cx, src, cur);
  const float* res = polar_ns(tile, red, cx, cur, cur == ya ? yb : ya, fin);
  for (int e = threadIdx.x; e < I * cx.nc; e += NT) {
    const size_t idx = (size_t)(e / cx.nc) * q + cx.c0 + e % cx.nc;
    q_out[idx] = __ldcg(res + idx);
  }
}

__host__ __device__ inline long streaming_smem_floats() {
  return (long)(sizeof(Smem) / sizeof(float)) + NT;
}

// n2 = |B|_F^2: given, or the trace of the unscaled Gram (fixed order)
__device__ __forceinline__ float read_n2(const float* n2p, const float* g, int I, float* red) {
  float bn2;
  if (n2p != nullptr) {
    bn2 = __ldcg(n2p);
  } else {
    float s = 0.f;
    for (int i = threadIdx.x; i < I; i += NT) s += __ldg(g + (size_t)i * I + i);
    bn2 = block_sum<NT>(s, red);
  }
  return bn2 != bn2 ? bn2 : fmaxf(bn2, 1e-30f);
}

__device__ __forceinline__ Ctx make_ctx(const float* g, int I, int q, float dead_tol) {
  const int r = (int)cg::this_cluster().block_rank();
  const int cb = col_block(q);
  Ctx cx;
  cx.g = g;
  cx.I = I;
  cx.q = q;
  cx.c0 = min(q, r * cb);
  cx.nc = max(0, min(q, cx.c0 + cb) - cx.c0);
  cx.dead_tol = dead_tol;
  return cx;
}

// Two kernels, so that each path gets its own register allocation.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    polar_resident_kernel(const float* __restrict__ y_in, const float* __restrict__ g,
                          const float* __restrict__ n2p, float* __restrict__ q_out,
                          float* __restrict__ scratch, int I, int q, int n_power,
                          const __grid_constant__ Coeffs loop,
                          const __grid_constant__ Coeffs fin, float dead_tol) {
  extern __shared__ __align__(16) float sm[];
  Ctx cx = make_ctx(g, I, q, dead_tol);
  cx.bn2 = read_n2(n2p, g, I, sm + resident_layout(I, q).red);
  run_resident(sm, cx, y_in, q_out, scratch, n_power, loop, fin);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    polar_streaming_kernel(const float* __restrict__ y_in, const float* __restrict__ g,
                           const float* __restrict__ n2p, float* __restrict__ q_out,
                           float* __restrict__ scratch, int I, int q, int n_power,
                           const __grid_constant__ Coeffs loop,
                           const __grid_constant__ Coeffs fin, float dead_tol) {
  extern __shared__ __align__(16) float sm[];
  Ctx cx = make_ctx(g, I, q, dead_tol);
  cx.bn2 = read_n2(n2p, g, I, sm + streaming_smem_floats() - NT);
  run_streaming(sm, cx, y_in, q_out, scratch, n_power, loop, fin);
}

bool fits_resident(int I, int q) {
  return resident_layout(I, q).floats * (long)sizeof(float) <= SMEM_LIMIT;
}

long scratch_floats(int I, int q) {
  const long streaming = 2L * I * q + 2L * q * q + 2L * q;
  const long ld = ld_of(q);
  const long resident = 2L * I * ld + (long)q * ld + q;
  return streaming > resident ? streaming : resident;
}

// One launch of the iteration on `stream`: y (I, q), the unscaled Gram g
// (I, I) and n2 (1), or null to read tr g, give the isometric q_out (I, q).
int launch(const float* y, const float* g, const float* n2, float* q_out, float* scratch, int I,
           int q, int n_power, const Coeffs* loop, const Coeffs* fin, float dead_tol,
           cudaStream_t st) {
  if (loop->n > MAX_PASSES || fin->n > MAX_PASSES || loop->n < 0 || fin->n < 0)
    return (int)cudaErrorInvalidValue;
  if (!fits_resident(I, q)) {
    polar_streaming_kernel<<<CLUSTER, NT, streaming_smem_floats() * sizeof(float), st>>>(
        y, g, n2, q_out, scratch, I, q, n_power, *loop, *fin, dead_tol);
    return (int)cudaGetLastError();
  }
  const long bytes = resident_layout(I, q).floats * (long)sizeof(float);
  static bool opted_in = false;
  if (bytes > 48 * 1024 && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        polar_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  polar_resident_kernel<<<CLUSTER, NT, bytes, st>>>(y, g, n2, q_out, scratch, I, q, n_power,
                                                     *loop, *fin, dead_tol);
  return (int)cudaGetLastError();
}

}  // namespace polar
}  // namespace
