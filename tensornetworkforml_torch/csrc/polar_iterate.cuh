// The polar split's subspace iteration (K1) as device code, shared by
// polar_iterate.cu (K1 alone, and K8's iteration) and two_site_step.cu (K7's
// split stage). The design is described in polar_iterate.cu; launch() runs
// the cluster form (16 CTAs fed by the TMA from L2) where the shape fits,
// else the streaming form (8 CTAs, operands streamed from L2).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "pdl.cuh"
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

constexpr int NT = 256;               // threads per CTA, both forms
constexpr long SMEM_LIMIT = 232448;   // bytes of shared memory a block may use

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int ilog2(int v) {  // v a power of two
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}
__host__ __device__ inline int pow2_at_least(int v) { return 1 << ilog2(v); }
__host__ __device__ inline int pow2_at_most(int v) {
  const int p = pow2_at_least(v);
  return p > v ? p / 2 : p;
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

// ---- the cluster form ---------------------------------------------------------

constexpr int CL = 16;              // CTAs of the cluster (a non-portable size)
constexpr int RM = 8, RN = 4;       // each thread's output tile
constexpr int TILE = NT * RM * RN;  // outputs of one CTA's product: 8192
constexpr int NF4 = TILE / 4 / NT;  // float4s a thread stages per chunk of g: 8
constexpr int STAGES = 2;           // chunk buffers: one in flight while one is multiplied
constexpr int CHUNK = 2 * TILE;     // floats of a chunk the TMA brings (64 KB at most)
constexpr int CNT = NT + 32;        // threads of a CTA: NT consumers and one producer warp

// The cluster form's shape plan, the same on the host and in every CTA. CTA r
// owns columns [r nc, (r + 1) nc) of y, W and P; nc, kc1, kc2 and kc3 are
// powers of two. Offsets are in floats: of shared memory, and (g_*) of global
// scratch.
struct Plan {
  int nc, lg_nc;     // columns per CTA: 4, 8 or 16
  int cg;            // thread columns of an output tile: nc / 4
  int sact, qa;      // CTAs that own live columns; sact * nc (q rounded up)
  int ip;            // I rounded up to 8
  int kc1;           // rows of y or W a row chunk takes
  int kc2;           // rows of y^T a column chunk takes
  int kc3, ld2;      // columns of g a chunk takes, through registers; its stage row
  int ks_q, ks_i;    // k-split thread groups of products with qa and with I rows
  long bars, y, w, p, stage, sf, part, red, nrm, slots, floats;
  long g_yr, g_yc, g_w, g_floats;
};

// the most k-split groups (1 to 8) that still leave enough threads for `rows`
__host__ __device__ inline int ksplit(int rows, int cgr) {
  int ks = 8;
  while (ks > 1 && (NT / ks / cgr) * RM < rows) ks /= 2;
  return ks;
}

__host__ __device__ inline Plan cluster_plan(int I, int q) {
  Plan L;
  L.nc = imax(4, pow2_at_least((q + CL - 1) / CL));
  L.lg_nc = ilog2(L.nc);
  L.cg = L.nc / 4;
  L.sact = (q + L.nc - 1) / L.nc;
  L.qa = L.sact * L.nc;
  L.ip = (I + 7) / 8 * 8;
  const int cap = pow2_at_least(imax(imax(I, L.qa), 8));
  L.kc1 = imin(cap, imax(8, pow2_at_most(CHUNK / L.qa)));
  L.kc2 = imin(cap, imax(8, pow2_at_most(CHUNK / L.ip)));
  L.kc3 = imin(cap, imax(8, pow2_at_most(TILE / L.ip)));
  L.ld2 = L.ip + 4;
  L.ks_q = ksplit(L.qa, L.cg);
  L.ks_i = ksplit(I, L.cg);  // kc1, kc2 and kc3 are multiples of 8, so of ks
  // 8 floats more than a chunk fills: a thread whose rows run past qa reads
  // there (those rows are discarded)
  const long s1 = (long)L.kc1 * L.qa, s2 = (long)L.kc2 * L.ip, s3 = (long)L.kc3 * L.ld2;
  L.sf = (s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3)) + 8;
  long o = 0;
  L.bars = o; o += 4 * STAGES;  // a full and an empty mbarrier a stage (8 bytes each)
  L.y = o; o += (long)I * L.nc;
  L.w = o; o += (long)L.qa * L.nc;
  L.p = o; o += (long)L.qa * L.nc;
  L.stage = o; o += STAGES * L.sf;
  L.part = o; o += TILE;  // the groups' tiles: ks * M * nc <= TILE
  L.red = o; o += CNT;
  L.nrm = o; o += 16;
  L.slots = o; o += 4;
  L.floats = o;
  // the cluster's y twice over (the current and the next y), as y (I x qa)
  // and as y^T (qa x ip), and W (qa x qa), all row-major; each CTA writes
  // its own columns (rows of y^T)
  o = 0;
  L.g_yr = o; o += 2L * I * L.qa;
  L.g_yc = o; o += 2L * L.qa * L.ip;
  L.g_w = o; o += (long)L.qa * L.qa;
  L.g_floats = o;
  return L;
}

// The cluster form takes a shape when one pass over k holds a CTA's whole
// output (I * nc <= TILE), a chunk fits a stage and the layout fits a
// block's shared memory: at q <= 256 up to I = 512, at q <= 128 up to I = 1024.
inline bool fits_cluster(int I, int q) {
  if (I < 1 || q < 1) return false;
  const Plan L = cluster_plan(I, q);
  return L.nc <= 16 && (long)I * L.nc <= TILE && L.ip <= 1024 &&
         L.floats * (long)sizeof(float) <= SMEM_LIMIT;
}

struct Cx {
  Plan L;
  float* sm;
  float* gs;  // global scratch
  const float* g;
  int I, q, rank, c0, live;
  float dead_tol, bn2;
};

// buffer b of the cluster's y in global scratch: y (I x qa) and y^T (qa x ip)
__device__ __forceinline__ float* y_rows(const Cx& c, int b) {
  return c.gs + c.L.g_yr + (long)b * c.I * c.L.qa;
}
__device__ __forceinline__ float* y_cols(const Cx& c, int b) {
  return c.gs + c.L.g_yc + (long)b * c.L.qa * c.L.ip;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from global memory into this CTA's shared
// memory by the TMA, reported to the mbarrier at `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// a cluster barrier that also orders this thread's global writes before the
// TMA reads of them that follow it in other CTAs
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cg::this_cluster().sync();
}

// acc += A(:, k0 + kb .. k0 + ke) B(k0 + kb .. k0 + ke, n0 .. n0 + 3) for this
// thread's rows m0 .. m0 + 7: A(m0 .. m0 + 3, k) is the float4 at st + a0 +
// k ldk, A(m0 + 4 .., k) the one at st + a1 + k ldk. The chunk's terms are
// summed apart and then added to acc (blocked summation): one FMA chain over
// all of K (512 terms at I = 512) leaves rounding in the near-null directions
// of a rank-deficient step that the final schedule then lifts to unit
// columns (on an H100, scripts/torch_k1_probe.py edge: all 256 columns live
// at the M=256 sweep's first step, where float64 keeps 3 and the plain
// version 5; blocked: 4).
template <class BROW>
__device__ __forceinline__ void mma_chunk(float (&acc)[RM][RN], const float* st, int ldk, int a0,
                                          int a1, int kb, int ke, int k0, int n0,
                                          const BROW& brow) {
  float sum[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) sum[i][j] = 0.f;
#pragma unroll 8
  for (int k = kb; k < ke; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(st + a0 + k * ldk);
    const float4 x1 = *reinterpret_cast<const float4*>(st + a1 + k * ldk);
    const float4 b = brow(k0, k, n0);
    const float av[RM] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float bv[RN] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] += sum[i][j];
}

// A product's thread roles: ks groups of NT / ks threads, each thread an
// 8 x 4 tile at (m0, n0) of the CTA's (M x nc) output, its group taking the
// kq = kc / ks k of each chunk from kb on
struct Roles {
  int tpg, grp, t, m0, n0, kq, kb;
  bool act;
};

__device__ __forceinline__ Roles roles(const Cx& c, int M, int kc, int ks) {
  Roles r;
  r.tpg = NT / ks;
  r.grp = threadIdx.x / r.tpg;
  r.t = threadIdx.x % r.tpg;
  r.m0 = r.t / c.L.cg * RM;
  r.n0 = r.t % c.L.cg * RN;
  r.kq = kc / ks;
  r.kb = r.grp * r.kq;
  r.act = r.m0 < M && threadIdx.x < NT;
  return r;
}

__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// a barrier of the NT consumer threads alone (the producer warp runs ahead)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// The product's output (M x nc): with ks = 1 each thread's tile goes to
// epi(m, n0, v) row by row (v: the float4 at columns n0 .. n0 + 3 of row m);
// otherwise every group's tile goes to shared memory and each output is
// (((group 0) + group 1) + ...) + group ks - 1, formed by all consumers.
// Every consumer is done with the operands before any epi writes (an epi may
// write over the B operand). Consumers only.
template <class EPI>
__device__ __forceinline__ void finish(const Cx& c, const Roles& r, int ks, int M,
                                       float (&acc)[RM][RN], const EPI& epi) {
  consumer_sync();
  if (ks == 1) {
    if (r.act)
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r.m0 + i < M) epi(r.m0 + i, r.n0, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
  } else {
    const int nc = c.L.nc, mn = M * nc;
    float* part = c.sm + c.L.part;
    if (r.act)
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r.m0 + i < M)
          *reinterpret_cast<float4*>(part + (size_t)r.grp * mn + (r.m0 + i) * nc + r.n0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    consumer_sync();
    for (int e = 4 * threadIdx.x; e < mn; e += 4 * NT) {
      float4 v = *reinterpret_cast<const float4*>(part + e);
      for (int gr = 1; gr < ks; ++gr) {
        const float4 u = *reinterpret_cast<const float4*>(part + (size_t)gr * mn + e);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      epi(e >> c.L.lg_nc, e & (nc - 1), v);
    }
  }
  consumer_sync();
}

// nch chunks through the STAGES buffers, fed by the TMA. The producer
// (thread NT) waits until the consumers have released a buffer (its empty
// mbarrier), then calls issue(buf, ch, full) for the next chunk; each
// consumer waits for a chunk's bytes (its full mbarrier), calls mma(buf, ch)
// and releases the buffer. The chunks run from chunk rot on, cyclically.
// gk counts the chunks of the launch so far, the same in every thread: chunk
// gk of the launch uses buffer gk mod STAGES, for the (gk / STAGES)-th time.
template <class FEED, class MMA>
__device__ __forceinline__ void pipeline(const Cx& c, int& gk, int nch, int rot,
                                         const FEED& issue, const MMA& mma) {
  float* st0 = c.sm + c.L.stage;
  const uint32_t full0 = smem_u32(c.sm + c.L.bars), empty0 = full0 + 8 * STAGES;
  if (threadIdx.x == NT) {
    for (int i = 0; i < nch; ++i) {
      const int g = gk + i, s = g % STAGES, use = g / STAGES;
      if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
      issue(st0 + s * c.L.sf, (i + rot) % nch, full0 + 8 * s);
    }
  } else if (threadIdx.x < NT) {
    for (int i = 0; i < nch; ++i) {
      const int g = gk + i, s = g % STAGES;
      mbar_wait(full0 + 8 * s, (g / STAGES) & 1);
      mma(st0 + s * c.L.sf, (i + rot) % nch);
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(empty0 + 8 * s) : "memory");
    }
  }
  gk += nch;
}

// acc (qa x nc) = X^T X[:, own columns] for X (K x qa, row-major in global
// memory at x): each chunk is kc1 rows of X, one TMA copy. One chunk order in
// every CTA, so W[i, j] and W[j, i] are the same FMA sequence. mode 0 writes
// W (the own block, and the own columns of W in global memory); mode 1
// writes P = (a I + b W) + c acc (X = W; its rows are its columns).
__device__ __noinline__ void gram_product(const Cx& c, int& gk, const float* x, int K,
                                          int mode, float a, float b, float cc) {
  const Plan& L = c.L;
  const int nc = L.nc, kc = L.kc1, qa = L.qa, c0 = c.c0;
  const Roles r = roles(c, qa, kc, L.ks_q);
  float acc[RM][RN];
  zero(acc);
  auto issue = [&](float* buf, int ch, uint32_t bar) {
    const int k0 = ch * kc;
    const uint32_t bytes = (uint32_t)imin(kc, K - k0) * qa * 4;
    mbar_expect_tx(bar, bytes);
    bulk_load(buf, x + (long)k0 * qa, bytes, bar);
  };
  pipeline(c, gk, (K + kc - 1) / kc, 0, issue, [&](const float* st, int ch) {
    const int k0 = ch * kc, ke = imin(r.kb + r.kq, K - k0);
    const float* own = st + c0;
    if (r.act)
      mma_chunk(acc, st, qa, r.m0, r.m0 + 4, r.kb, ke, k0, r.n0, [=](int, int k, int n0) {
        return *reinterpret_cast<const float4*>(own + k * qa + n0);
      });
  });
  if (threadIdx.x >= NT) return;
  float* W = c.sm + L.w;
  float* P = c.sm + L.p;
  float* Wg = c.gs + L.g_w + c0;
  finish(c, r, L.ks_q, qa, acc, [&](int m, int n0, float4 v) {
    if (mode == 0) {
      *reinterpret_cast<float4*>(W + m * nc + n0) = v;
      *reinterpret_cast<float4*>(Wg + (size_t)m * qa + n0) = v;
      return;
    }
    const float4 w = *reinterpret_cast<const float4*>(W + m * nc + n0);
    const float t[4] = {v.x, v.y, v.z, v.w}, wv[4] = {w.x, w.y, w.z, w.w};
    float pv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = (m == c0 + n0 + j ? a : 0.f) + b * wv[j];
      pv[j] = u + cc * t[j];
    }
    *reinterpret_cast<float4*>(P + m * nc + n0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
  });
}

// the own columns of y (the block at y in shared memory) as rows of buffer
// b's y^T, four rows of y a float4; the padding past I takes zeros.
// Consumers only; the caller's barrier makes the block complete first.
__device__ __forceinline__ void put_yt(const Cx& c, const float* y, int b) {
  const int nc = c.L.nc, ip = c.L.ip, I = c.I;
  float* yc = y_cols(c, b) + (long)c.c0 * ip;
  for (int e = threadIdx.x; e < nc * (ip / 4); e += NT) {
    const int j = e & (nc - 1), m = (e >> c.L.lg_nc) * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = m + i < I ? y[(m + i) * nc + j] : 0.f;
    *reinterpret_cast<float4*>(yc + (size_t)j * ip + m) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// y[:, own] = Y P[:, own] for the cluster's y in global buffer yb (read from
// y^T, kc2 of its rows a chunk, one TMA copy) and the own block of P; the new
// y goes into the own block in shared memory and into this CTA's columns of
// global buffer nb (and rows of its y^T, whose columns past I take whatever
// the tile holds there). CTA r starts at the chunk of its own columns.
__device__ __noinline__ void y_product(const Cx& c, int& gk, int yb, int nb) {
  const Plan& L = c.L;
  const int nc = L.nc, kc = L.kc2, ip = L.ip, I = c.I, qa = L.qa;
  const Roles r = roles(c, I, kc, L.ks_i);
  float acc[RM][RN];
  zero(acc);
  const float* P = c.sm + L.p;
  const float* yt = y_cols(c, yb);
  auto issue = [&](float* buf, int ch, uint32_t bar) {
    const int k0 = ch * kc;
    const uint32_t bytes = (uint32_t)imin(kc, qa - k0) * ip * 4;
    mbar_expect_tx(bar, bytes);
    bulk_load(buf, yt + (long)k0 * ip, bytes, bar);
  };
  const int nch = (qa + kc - 1) / kc;
  pipeline(c, gk, nch, (c.c0 / kc) % nch, issue, [&](const float* st, int ch) {
    const int k0 = ch * kc, ke = imin(r.kb + r.kq, qa - k0);
    if (r.act)
      mma_chunk(acc, st, ip, r.m0, r.m0 + 4, r.kb, ke, k0, r.n0, [=](int k0_, int k, int n0) {
        return *reinterpret_cast<const float4*>(P + (k0_ + k) * nc + n0);
      });
  });
  if (threadIdx.x >= NT) return;
  float* y = c.sm + L.y;
  float* yr = y_rows(c, nb) + c.c0;
  finish(c, r, L.ks_i, I, acc, [&](int m, int n0, float4 v) {
    *reinterpret_cast<float4*>(y + m * nc + n0) = v;
    *reinterpret_cast<float4*>(yr + (size_t)m * qa + n0) = v;
  });
  put_yt(c, y, nb);
}

// y's own block (consumers only) after an elementwise change, copied to
// buffer b's y and y^T (CTAs without live columns own none of them)
__device__ __forceinline__ void mirror_y(const Cx& c, const float* y, int b) {
  if (c.live == 0 || threadIdx.x >= NT) return;
  float* yr = y_rows(c, b) + c.c0;
  for (int e = 4 * threadIdx.x; e < c.I * c.L.nc; e += 4 * NT)
    *reinterpret_cast<float4*>(yr + (size_t)(e >> c.L.lg_nc) * c.L.qa + (e & (c.L.nc - 1))) =
        *reinterpret_cast<const float4*>(y + e);
  put_yt(c, y, b);
}

// the largest of every CTA's slots[k] (NaN if any is NaN), the same bits in
// every CTA; called after the cluster barrier that follows the writes
__device__ __forceinline__ float cluster_max(const Cx& c, int k) {
  float* red = c.sm + c.L.red;
  __syncthreads();
  if (threadIdx.x < CL)
    red[threadIdx.x] = *cg::this_cluster().map_shared_rank(c.sm + c.L.slots + k, threadIdx.x);
  __syncthreads();
  float mx = -__int_as_float(0x7f800000);
  for (int s = 0; s < CL; ++s) mx = nanmax(mx, red[s]);
  return mx;
}

// per own column j < nc: nrm[j] = fin(sum over rows m < M of f(src[m nc + j])),
// the sum in one fixed order; then slots[k] = the largest over live columns
template <class F, class FIN>
__device__ __forceinline__ void column_sums(const Cx& c, const float* src, int M, int k,
                                            const F& f, const FIN& fin) {
  const Plan& L = c.L;
  float* red = c.sm + L.red;
  float* nrm = c.sm + L.nrm;
  const int j = threadIdx.x & (L.nc - 1), part = threadIdx.x >> L.lg_nc, parts = NT >> L.lg_nc;
  float s = 0.f;
  for (int m = part; m < M; m += parts) s += f(src[(size_t)m * L.nc + j]);
  __syncthreads();
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < L.nc) {
    float t = 0.f;
    for (int p = 0; p < parts; ++p) t += red[p * L.nc + threadIdx.x];
    nrm[threadIdx.x] = fin(t);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mx = -__int_as_float(0x7f800000);
    for (int jj = 0; jj < c.live; ++jj) mx = nanmax(mx, nrm[jj]);
    c.sm[L.slots + k] = mx;
  }
}

// y's own columns unit-normalised, those below dead_tol of the largest
// column norm (or not finite) set to zero by select, and copied to buffer
// b's global blocks; ends with them visible to the cluster
__device__ __forceinline__ void colnorm(const Cx& c, float* y, int b) {
  const Plan& L = c.L;
  const float* nrm = c.sm + L.nrm;
  column_sums(c, y, c.I, 0, [](float v) { return v * v; }, [](float t) { return sqrtf(t); });
  cg::this_cluster().sync();
  const float n_max = cluster_max(c, 0);
  for (int e = threadIdx.x; e < c.I * L.nc && threadIdx.x < NT; e += NT) {
    const int j = e & (L.nc - 1);
    const float n = nrm[j];
    const bool live = j < c.live && n > c.dead_tol * n_max && isfinite(n);
    y[e] = live ? y[e] / fmaxf(n, 1e-30f) : 0.f;
  }
  __syncthreads();
  mirror_y(c, y, b);
  publish();
}

// polar Newton-Schulz on the cluster's y (own columns at y, every CTA's in
// buffer b of global scratch): prescale by sqrt(max row sum of |W|), then per
// pass W = y^T y, P = a I + b W + c W W, y = y P. The passes alternate the
// global buffers; b follows.
__device__ __forceinline__ void polar_ns(const Cx& c, int& gk, float* y, int& b,
                                         const Coeffs& co) {
  const Plan& L = c.L;
  const bool owner = c.live > 0;
  const int I = c.I, nc = L.nc, qa = L.qa;
  // prescale: W symmetric, so row sums are column sums
  if (owner) gram_product(c, gk, y_rows(c, b), I, 0, 0.f, 0.f, 0.f);
  column_sums(c, c.sm + L.w, qa, 1, [](float v) { return fabsf(v); }, [](float t) { return t; });
  cg::this_cluster().sync();
  const float rowsum = cluster_max(c, 1);
  const float scale = sqrtf(rowsum != rowsum ? rowsum : fmaxf(rowsum, 1e-30f));
  for (int e = threadIdx.x; e < I * nc && threadIdx.x < NT; e += NT) y[e] = y[e] / scale;
  __syncthreads();
  mirror_y(c, y, b);
  publish();

  for (int p = 0; p < co.n; ++p) {
    if (owner) gram_product(c, gk, y_rows(c, b), I, 0, 0.f, 0.f, 0.f);
    publish();  // W is complete in every CTA
    if (owner) {
      gram_product(c, gk, c.gs + L.g_w, qa, 1, co.c[3 * p], co.c[3 * p + 1], co.c[3 * p + 2]);
      y_product(c, gk, b, b ^ 1);
    }
    publish();  // the new y is complete, and no CTA reads the old one
    b ^= 1;
  }
}

// y[:, own] = (g / n2) y[:, own], g read from global memory, transposed on
// its way into the stage through registers (two buffers, the next chunk in
// flight while one is multiplied); only this CTA's own block is read and
// written
__device__ __noinline__ void power_step(const Cx& c, float* y) {
  if (threadIdx.x >= NT) return;  // the producer warp has no part in it
  const Plan& L = c.L;
  const int I = c.I, nc = L.nc, kc = L.kc3, ld = L.ld2, q4 = kc / 4, total = I * q4;
  const float* g = c.g;
  const float bn2 = c.bn2;
  const bool vec = I % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const Roles r = roles(c, I, kc, L.ks_i);
  float acc[RM][RN];
  zero(acc);
  auto load = [&](int ch, float4 (&v)[NF4]) {
    const int k0 = ch * kc;
#pragma unroll
    for (int u = 0; u < NF4; ++u) {
      const int e = threadIdx.x + u * NT, m = e / q4, kg = k0 + 4 * (e - m * q4);
      if (e < total && kg < I) {
        const float* row = g + (size_t)m * I;
        float4 x;
        if (vec) {
          x = __ldg(reinterpret_cast<const float4*>(row + kg));
        } else {
          x.x = __ldg(row + kg);
          x.y = kg + 1 < I ? __ldg(row + kg + 1) : 0.f;
          x.z = kg + 2 < I ? __ldg(row + kg + 2) : 0.f;
          x.w = kg + 3 < I ? __ldg(row + kg + 3) : 0.f;
        }
        v[u] = make_float4(x.x / bn2, x.y / bn2, x.z / bn2, x.w / bn2);  // g / n2, as the plain version
      }
    }
  };
  auto store = [&](float* buf, int ch, const float4 (&v)[NF4]) {
    const int k0 = ch * kc;
#pragma unroll
    for (int u = 0; u < NF4; ++u) {
      const int e = threadIdx.x + u * NT, m = e / q4, k4 = e - m * q4;
      if (e < total && k0 + 4 * k4 < I) {
        float* d = buf + 4 * k4 * ld + m;
        d[0] = v[u].x;
        d[ld] = v[u].y;
        d[2 * ld] = v[u].z;
        d[3 * ld] = v[u].w;
      }
    }
  };
  float* st0 = c.sm + L.stage;
  float4 v[NF4];
  const int nch = (I + kc - 1) / kc;
  load(0, v);
  store(st0, 0, v);
  consumer_sync();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) load(ch + 1, v);
    const int k0 = ch * kc, ke = imin(r.kb + r.kq, I - k0);
    if (r.act)
      mma_chunk(acc, st0 + (ch & 1) * L.sf, ld, r.m0, r.m0 + 4, r.kb, ke, k0, r.n0,
                [=](int k0_, int k, int n0) {
                  return *reinterpret_cast<const float4*>(y + (k0_ + k) * nc + n0);
                });
    if (ch + 1 < nch) store(st0 + ((ch + 1) & 1) * L.sf, ch + 1, v);
    consumer_sync();
  }
  // these stage writes came through the generic proxy; the TMA writes there next
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  finish(c, r, L.ks_i, I, acc,
         [&](int m, int n0, float4 v) { *reinterpret_cast<float4*>(y + m * nc + n0) = v; });
}

__global__ void __launch_bounds__(CNT, 1)
    polar_cluster_kernel(const float* __restrict__ y_in, const float* __restrict__ g,
                         const float* __restrict__ n2p, float* __restrict__ q_out,
                         float* __restrict__ scratch, int I, int q, int n_power,
                         const __grid_constant__ Coeffs loop, const __grid_constant__ Coeffs fin,
                         float dead_tol) {
  pdl::start();  // K7's and K8's chains (pdl.cuh); returns at once for K1 alone
  extern __shared__ __align__(16) float sm[];
  Cx c;
  c.L = cluster_plan(I, q);
  c.sm = sm;
  c.gs = scratch;
  c.g = g;
  c.I = I;
  c.q = q;
  c.rank = (int)cg::this_cluster().block_rank();
  c.c0 = c.rank * c.L.nc;
  c.live = imax(0, imin(q - c.c0, c.L.nc));
  c.dead_tol = dead_tol;
  c.bn2 = read_n2(n2p, g, I, sm + c.L.red);
  const int nc = c.L.nc;
  float* y = sm + c.L.y;
  if (threadIdx.x < 2 * STAGES) {  // full: one arrival (the producer's); empty: every consumer
    const uint32_t bar = smem_u32(sm + c.L.bars) + 8 * threadIdx.x;
    const int count = threadIdx.x < STAGES ? 1 : NT;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int e = threadIdx.x; e < I * nc && threadIdx.x < NT; e += NT) {
    const int i = e >> c.L.lg_nc, j = e & (nc - 1);
    y[e] = j < c.live ? __ldg(y_in + (size_t)i * q + c.c0 + j) : 0.f;
  }
  __syncthreads();
  int b = 0;   // the global buffer that holds the cluster's current y
  int gk = 0;  // chunks through the stages so far
  for (int round = 0; round <= n_power; ++round) {
    colnorm(c, y, b);
    polar_ns(c, gk, y, b, round < n_power ? loop : fin);
    if (round < n_power) power_step(c, y);
  }
  for (int e = threadIdx.x; e < I * nc && threadIdx.x < NT; e += NT) {
    const int i = e >> c.L.lg_nc, j = e & (nc - 1);
    if (j < c.live) q_out[(size_t)i * q + c.c0 + j] = y[e];
  }
}

// ---- the streaming form -------------------------------------------------------

constexpr int SCL = 8;          // CTAs of the streaming form's cluster
constexpr int KS = 2;           // thread groups splitting each product's k range
constexpr int NG = NT / KS;     // threads per group: one 4 x 4 sub-tile each
constexpr int TM = 128, TN = 16, TK = 16;

__host__ __device__ inline int col_block(int q) { return round4((q + SCL - 1) / SCL); }

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
__device__ __forceinline__ void colnorm_cols(float* red, const Ctx cx, const float* src, float* dst) {
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
__device__ __forceinline__ float* polar_ns_cols(Smem& sm, float* red, const Ctx cx, float* y,
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

// The streaming form: see the note at the top of polar_iterate.cu.
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
    colnorm_cols(red, cx, src, cur);
    float* res = polar_ns_cols(tile, red, cx, cur, cur == ya ? yb : ya, loop);
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
  colnorm_cols(red, cx, src, cur);
  const float* res = polar_ns_cols(tile, red, cx, cur, cur == ya ? yb : ya, fin);
  for (int e = threadIdx.x; e < I * cx.nc; e += NT) {
    const size_t idx = (size_t)(e / cx.nc) * q + cx.c0 + e % cx.nc;
    q_out[idx] = __ldcg(res + idx);
  }
}

__host__ __device__ inline long streaming_smem_floats() {
  return (long)(sizeof(Smem) / sizeof(float)) + NT;
}

__global__ void __cluster_dims__(SCL, 1, 1) __launch_bounds__(NT)
    polar_streaming_kernel(const float* __restrict__ y_in, const float* __restrict__ g,
                           const float* __restrict__ n2p, float* __restrict__ q_out,
                           float* __restrict__ scratch, int I, int q, int n_power,
                           const __grid_constant__ Coeffs loop,
                           const __grid_constant__ Coeffs fin, float dead_tol) {
  pdl::start();  // K7's and K8's chains (pdl.cuh); returns at once for K1 alone
  extern __shared__ __align__(16) float sm[];
  const int r = (int)cg::this_cluster().block_rank();
  const int cb = col_block(q);
  Ctx cx;
  cx.g = g;
  cx.I = I;
  cx.q = q;
  cx.c0 = min(q, r * cb);
  cx.nc = max(0, min(q, cx.c0 + cb) - cx.c0);
  cx.dead_tol = dead_tol;
  cx.bn2 = read_n2(n2p, g, I, sm + streaming_smem_floats() - NT);
  run_streaming(sm, cx, y_in, q_out, scratch, n_power, loop, fin);
}

// global scratch of one launch, in floats
long scratch_floats(int I, int q) {
  return fits_cluster(I, q) ? cluster_plan(I, q).g_floats : 2L * I * q + 2L * q * q + 2L * q;
}

cudaError_t launch_cluster(const float* y, const float* g, const float* n2, float* q_out,
                           float* scratch, int I, int q, int n_power, const Coeffs* loop,
                           const Coeffs* fin, float dead_tol, cudaStream_t st, bool with_pdl) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(polar_cluster_kernel,
                                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(polar_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(CNT);
  cfg.dynamicSmemBytes = (size_t)(cluster_plan(I, q).floats * (long)sizeof(float));
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = with_pdl ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, polar_cluster_kernel, y, g, n2, q_out, scratch, I, q, n_power,
                            *loop, *fin, dead_tol);
}

// One launch of the iteration on `stream`: y (I, q), the unscaled Gram g
// (I, I) and n2 (1), or null to read tr g, give the isometric q_out (I, q).
// with_pdl: the launch may start while its predecessor runs (pdl.cuh), as in
// K7's and K8's chains; K1 alone launches without it.
int launch(const float* y, const float* g, const float* n2, float* q_out, float* scratch, int I,
           int q, int n_power, const Coeffs* loop, const Coeffs* fin, float dead_tol,
           cudaStream_t st, bool with_pdl = false) {
  if (loop->n > MAX_PASSES || fin->n > MAX_PASSES || loop->n < 0 || fin->n < 0)
    return (int)cudaErrorInvalidValue;
  if (fits_cluster(I, q)) {
    const cudaError_t err = launch_cluster(y, g, n2, q_out, scratch, I, q, n_power, loop, fin,
                                           dead_tol, st, with_pdl);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  return (int)pdl::launch(polar_streaming_kernel, SCL, NT, streaming_smem_floats() * sizeof(float),
                          st, with_pdl, y, g, n2, q_out, scratch, I, q, n_power, *loop, *fin,
                          dead_tol);
}

}  // namespace polar
}  // namespace
