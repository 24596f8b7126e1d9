// The rangefinder split of the two-site matrix B (I, J), for Hopper (sm_90a):
// kernel K6.
//
// Replaces tensornetworkforml_tpu/ops/kernels/split_kernel.py::_split_kernel
// (with _hqr_orth), reached through rangefinder_split_pallas. It computes, in
// float32:
//   bs = B / (|B|_F + 1e-30);  y = bs Omega (I, q);  G = bs bs^T (I, I)
//   repeat n_iter: y = G hqr(colnorm(y))     (hqr every mid_orth iterations)
//   Q = hqr(colnorm(y))[:, :rank];  R = Q^T B
// colnorm divides each column by max(|col|, 1e-30); hqr is Householder QR
// with one reflector per column, Q accumulated by applying the reflectors in
// reverse to the (I, q) identity, and the identity reflector for a column
// whose |v|^2 <= 1e-30 (a zero column becomes e_j).
//
// What bounds it on this card: the dependent steps. The arithmetic is ~7e8
// FLOP at the flagship (I = 256, J = 2560, q = 136, rank = 128), 11 us at the
// float32 rate, but the 7 orthonormalisations are 136 reflectors each, every
// one formed from a column that all the reflectors before it have updated.
// The first version of this kernel ran the whole iteration on one block of
// one SM, every reflector applied to every later column on its own: ~1900
// dependent steps of a few block barriers each, 6.24 ms per launch on an H100
// (PERF.md).
//
// Design: four launches, counted as one kernel by the wrapper.
//   sketch_tile_kernel  (sketch_gram.cuh) y = B Omega, G = B B^T and partial
//                       sums of |B|_F^2 over many blocks, with the J range
//                       split when the tiles alone cannot fill the card.
//   rf_finish_kernel    adds the split partials in split order and scales:
//                       y / bn and G / bn / bn with bn = sqrt(n2) + 1e-30,
//                       which is bs Omega and bs bs^T up to rounding.
//   rf_cluster_kernel   the whole subspace iteration on ONE cluster of CL = 16
//                       CTAs of 256 threads, as a blocked Householder QR
//                       (LAPACK's geqrf and orgqr, with larft's T): the same
//                       reflectors as the unblocked form in exact arithmetic,
//                       applied in another association.
//     * The q columns are cut into panels of NB = 8, dealt to the CTAs in
//       turn (panel b to CTA b % CL). A CTA keeps its columns, column-major,
//       in shared memory when they fit (the flagship: 55 KB; I = 512,
//       q = 264: 135 KB) and in global memory (L2) otherwise; both paths run
//       the same code on the same values and compute the same bits, as does
//       any cluster size (each column sees the same operations in the same
//       order, whichever CTA holds it).
//     * colnorm and G y are column by column, so each CTA does them for its
//       own columns with no barrier; G (exactly symmetric) is read from L2
//       through the tile GEMM (tile_gemm.cuh).
//     * hqr, forward, one cluster barrier per panel: after panel b's barrier
//       the owner of panel b + 1 applies panel b to that panel's columns (a
//       warp each), and one warp factors it in registers (factor_panel: the
//       panel's 8 reflectors one after another, each two shuffle
//       reductions, no block barrier) and forms T (NB x NB, upper
//       triangular; a reflector with beta = 0 gives a zero row and column)
//       with H_0 ... H_{NB-1} = I - V T V^T. The reflectors V stay in place
//       of the panel; V and T go straight into the stage of the next panel's
//       owner (distributed shared memory). Every other CTA copies V and T
//       from the owner and updates its later columns C as two small
//       products, C -= V (T^T (V^T C)), a warp per column; the factoring
//       CTA defers its own such update to the next step, so that nothing
//       else runs on its SM while the one warp factors.
//     * hqr, backward: Q = H_0 ... H_{q-1} [I_q; 0] column by column, so each
//       CTA builds its own columns of Q from e_j through the panels from the
//       last to the first, two panels a step, C -= V (T (V^T C)), reading
//       each panel's V and T from its owner with no cluster barrier. One
//       cluster barrier ends the hqr (no CTA overwrites its reflectors while
//       another still reads them).
//     What bounds it now: the forward pass's chain of q / NB = 17 panels per
//     orthonormalisation, 119 per launch, each a cluster barrier (~0.7 us),
//     the next owner's update of its panel (~1.7 us) and the one-warp
//     factorisation (~3.9 us: two shuffle reductions and the scalars between
//     them, ~900 cycles a reflector), one after another: 0.86-0.88 ms of the
//     cluster launch's 1.26 ms at the flagship on an H100; then the backward
//     pass (0.27 ms in the busiest CTA, whose last columns take all 17
//     panels one after another) and the six products with G (0.11 ms).
//   rf_r_kernel         R = Q^T B through the tile GEMM (tile_gemm.cuh).
// There are no float atomics and every sum runs in a fixed order: two
// launches agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sketch_gram.cuh"

namespace cg = cooperative_groups;

namespace {

// CTAs of the cluster: 16, a non-portable size (the H100 takes it), so that
// the 17 panels of the flagship's q = 136 leave one CTA with two panels, not
// three, and the backward pass's work spreads evenly
constexpr int CL = 16;
constexpr int NB = 8;     // columns of a panel
// threads of a CTA: 8 warps, so that a thread may hold 255 registers: a
// panel's RPL x NB values and the code around them fit without spilling
// (with 12 warps and 168 registers they spill, and K6 runs ~13% slower on
// an H100)
constexpr int SNT = 256;
constexpr int SNW = SNT / 32;
// A panel is factored in registers by the first fw = ceil(I / (32 RPL))
// warps, RPL rows of it per lane: one warp up to I = 256, all 8 at the
// most, so I <= MAX_ROWS.
constexpr int RPL = 8;
constexpr int MAX_ROWS = SNW * 32 * RPL;
constexpr float EPS = 1e-30f;
// the opt-in shared memory of one block on sm_90
constexpr long MAX_SMEM = 232448;
// G y: tiles of GM x GN (GN = 2 NB, a CTA's columns at the flagship), one
// 4 x 4 sub-tile per thread of GNT, k chunks of GK taken by GKS thread
// groups in turn
constexpr int GM = 128, GN = 16, GK = 16, GKS = 2, GNT = SNT / GKS;
// values of a panel each thread has in flight when copying it
constexpr int SB = 12;
// values of one group sum: at most NB
constexpr int XK = NB;
using GSmem = TileSmem<GM, GN, GK, GKS>;

struct SerialArgs {
  const float* g;  // (I, I) scaled Gram
  const float* y;  // (I, q) scaled sketch, row-major
  float* cols;     // CL x 2 column regions, when they are not resident
  float* q_out;    // (I, rank) row-major
  int I, q, rank, n_iter, mid_orth;
};

// A CTA's columns and its shared memory, in floats. Local column lc of CTA r
// is column NB (lc / NB * CL + r) + lc % NB of the iterate; it sits at
// lc * ld of a column region. Two regions: the iterate, and the other one
// (Q while an hqr runs, G y after it).
struct Layout {
  int panels, own, ncol, ld;
  int region;    // floats of one column region
  int a, b;      // the two regions (resident only)
  int stage;     // two stage slots: V (NB x ld) and T (NB x NB) of a panel; G y's tiles alias them
  int t_own;     // T of this CTA's own panels, own x NB x NB
  int xch;       // the factoring warps' partial sums, 2 x SNW x XK
  int zst;       // a panel's dot products v_m . v_j (NB x NB) and betas (NB), for T
  int floats;
};

// floats of one stage slot
__host__ __device__ inline int stage_floats(int ld) { return NB * ld + NB * NB; }

__host__ __device__ inline int factor_warps(int I) { return (I + 32 * RPL - 1) / (32 * RPL); }

__host__ __device__ inline Layout layout(int I, int q, bool resident) {
  Layout L;
  L.panels = (q + NB - 1) / NB;
  L.own = (L.panels + CL - 1) / CL;
  L.ncol = L.own * NB;
  // a multiple of 4 (float4 tiles), 8 mod 32 words: G y's loads of four
  // columns at one row spread over the banks
  L.ld = (I + 31) / 32 * 32 + 8;
  L.region = L.ncol * L.ld;
  int o = 0;
  L.a = o;
  if (resident) o += L.region;
  L.b = o;
  if (resident) o += L.region;
  L.stage = o;
  const int stages = 2 * stage_floats(L.ld), tiles = (int)(sizeof(GSmem) / sizeof(float));
  o += stages > tiles ? stages : tiles;
  L.t_own = o;
  o += L.own * NB * NB;
  L.xch = o;
  o += 2 * SNW * XK;
  L.zst = o;
  o += NB * NB + NB;
  L.floats = o;
  return L;
}

bool resident_fits(int I, int q) {
  return layout(I, q, true).floats * (long)sizeof(float) <= MAX_SMEM;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// warp_sum of K values at once: each round's K shuffles are issued together
// (the compiler keeps shuffles in program order, so K separate butterflies
// would wait out 5 K shuffle latencies); the same additions as warp_sum
template <int K>
__device__ __forceinline__ void warp_sums(float (&v)[K]) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    float o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = __shfl_xor_sync(0xffffffffu, v[k], m);
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += o[k];
  }
}

// y / bn and G / bn / bn from the tile pass's outputs or split partials
__global__ void __launch_bounds__(NT) rf_finish_kernel(Args a) {
  __shared__ float red[NT];
  float v = 0.f;
  for (int p = threadIdx.x; p < a.S * a.nI; p += NT) v += a.n2p[p];
  const float n2 = block_sum<NT>(v, red);  // the same order in every block
  const float bn = sqrtf(n2) + EPS;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n2 = n2;
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t Iq = (size_t)a.I * a.q, II = (size_t)a.I * a.I;
  if (e < Iq) {
    float s = a.S > 1 ? 0.f : a.y[e];
    if (a.S > 1)
      for (int p = 0; p < a.S; ++p) s += a.yp[p * Iq + e];
    a.y[e] = s / bn;
  }
  if (e < II) {
    float s = a.S > 1 ? 0.f : a.g[e];
    if (a.S > 1)
      for (int p = 0; p < a.S; ++p) s += a.gp[p * II + e];
    a.g[e] = s / bn / bn;
  }
}

// The cluster's shared view of one CTA: its regions and its panels' T.
struct Ctx {
  float* sm;          // this CTA's shared memory
  float* cols;        // the global column regions (null when resident)
  Layout L;
  int I, q, rank;     // rank: this CTA's rank in the cluster
};

// column of the iterate held in local column lc, or -1 past q
__device__ __forceinline__ int global_col(const Ctx& c, int lc) {
  const int panel = lc / NB * CL + c.rank, col = panel * NB + lc % NB;
  return (panel < c.L.panels && col < c.q) ? col : -1;
}

// region k (0 or 1) of CTA `who`
template <bool RES>
__device__ __forceinline__ float* region(const Ctx& c, int k, int who) {
  if (RES) {
    float* mine = c.sm + (k ? c.L.b : c.L.a);
    return who == c.rank ? mine : cg::this_cluster().map_shared_rank(mine, who);
  }
  return c.cols + ((long)who * 2 + k) * c.L.region;
}

// a value another CTA wrote before the last cluster barrier
template <bool RES>
__device__ __forceinline__ float shared_ld(const float* p) {
  if (RES) return *p;  // distributed shared memory
  return __ldcg(p);    // L2, not a stale L1 line
}

// every own column divided by max(|col|, 1e-30); a warp per column
__device__ __forceinline__ void colnorm(const Ctx& c, float* P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ld = c.L.ld;
  for (int lc = warp; lc < c.L.ncol; lc += SNW) {
    if (global_col(c, lc) < 0) continue;
    float* col = P + (size_t)lc * ld;
    float ss = 0.f;
    for (int r = lane; r < c.I; r += 32) ss = fmaf(col[r], col[r], ss);
    const float d = nanmax(sqrtf(warp_sum(ss)), EPS);
    for (int r = lane; r < c.I; r += 32) col[r] = col[r] / d;
  }
  __syncthreads();
}

// v[0 .. K) summed over the factoring warps in one fixed order (each warp's
// xor butterfly, then, with MULTI (fw > 1), the warps in turn): every thread
// of the group gets the same bits. Two slot sets of xch alternate, so one
// barrier of the group per sum suffices.
template <bool MULTI, int K>
__device__ __forceinline__ void group_sum(float (&v)[K], int fw, float* xch, int& flip) {
  warp_sums(v);
  if (!MULTI) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* slot = xch + flip * SNW * XK;
  flip ^= 1;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) slot[warp * XK + k] = v[k];
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(fw * 32) : "memory");
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float t = 0.f;
#pragma unroll 1
    for (int w = 0; w < fw; ++w) t += slot[w * XK + k];
    v[k] = t;
  }
}

// The first fw warps factor the panel of w <= NB columns at `pan` (column j
// at pan + j * ld), rows kb .. I-1, held in registers: thread f holds the
// panel's rows f + 32 fw i, i < RPL, counted from kb, and zeros past its
// end. Reflector j is formed from column j and applied to the panel's
// columns right of it; each step is two group sums (|x|^2 below the
// diagonal with x0; the dot products of v_j with the other columns). Column
// j then holds v_j: zero above row kb + j, v0 on it (0 for the identity
// reflector), the column's entries below. Columns from w on are zero, so
// their steps form identity reflectors and leave everything as it is; all
// NB steps run. T (NB x NB, row-major, at tm) gets H_0 ... H_{w-1} =
// I - V T V^T: T[j][j] = beta_j, T[:j, j] = -beta_j T[:j, :j] (V[:, :j]^T v_j),
// from the same dot products, which the steps leave in zst. The steps'
// dependent chain is the two sums and the scalars between them (measured on
// an H100: ~1000 cycles a step), so T is formed after them, thread l < NB
// forming row l; zero rows and columns from w on. Rows and steps are
// unrolled and only the first row of each thread is compared with the
// diagonal. One instance for one factoring warp and one for several.
template <bool MULTI>
__device__ __forceinline__ void factor_panel(float* pan, float* tm, int kb, int w, int I, int ld,
                                          int fw, float* xch, float* zst) {
  const int f = threadIdx.x, stride = 32 * fw, nrows = I - kb;
  pan += kb;
  float x[RPL][NB];
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int rl = f + stride * i;
#pragma unroll
    for (int u = 0; u < NB; ++u) x[i][u] = (rl < nrows && u < w) ? pan[(size_t)u * ld + rl] : 0.f;
  }
  int flip = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    // |x|^2 below the diagonal (row j of the panel: thread j's first), in
    // two chains, and x0
    float s2[2] = {f > j ? x[0][j] * x[0][j] : 0.f, f == j ? x[0][j] : 0.f};
    float odd = 0.f;
#pragma unroll
    for (int i = 1; i < RPL; ++i) {
      if (i & 1)
        odd = fmaf(x[i][j], x[i][j], odd);
      else
        s2[0] = fmaf(x[i][j], x[i][j], s2[0]);
    }
    s2[0] += odd;
    group_sum<MULTI>(s2, fw, xch, flip);
    const float tail = s2[0], x0 = s2[1];
    const float sigma = sqrtf(fmaf(x0, x0, tail));
    const float t = x0 + EPS;
    const float alpha = -(float)((t > 0.f) - (t < 0.f)) * sigma;  // sign(0) = 0
    const float v0 = x0 - alpha;
    const float vn2 = fmaf(v0, v0, tail);
    const bool live = vn2 > EPS;  // uniform over the group
    const float bj = live ? __fdividef(2.f, vn2) : 0.f;  // 0: the update keeps x
    // v_j on this thread's rows: zero above the diagonal, v0 (or 0) on it
    if (f <= j) x[0][j] = f == j ? (live ? v0 : 0.f) : 0.f;
    float dz[NB];  // u > j: v_j . column u; u < j: v_u . v_j
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      dz[u] = 0.f;
      if (u == j) continue;
#pragma unroll
      for (int i = 0; i < RPL; ++i) dz[u] = fmaf(x[i][j], x[i][u], dz[u]);
    }
    group_sum<MULTI>(dz, fw, xch, flip);
#pragma unroll
    for (int u = j + 1; u < NB; ++u)
#pragma unroll
      for (int i = 0; i < RPL; ++i) x[i][u] = fmaf(-(bj * x[i][j]), dz[u], x[i][u]);
    if (f == 0) {  // z_m = v_m . v_j, m < j, and beta_j
#pragma unroll
      for (int m = 0; m < j; ++m) zst[j * NB + m] = dz[m];
      zst[NB * NB + j] = bj;
    }
  }
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int rl = f + stride * i;
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (rl < nrows && u < w) pan[(size_t)u * ld + rl] = x[i][u];
  }
  __syncwarp();
  if (f < NB) {  // row f of T, column by column
    float trow[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float bj = zst[NB * NB + j];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < j; ++m) acc = fmaf(m >= f ? trow[m] : 0.f, zst[j * NB + m], acc);
      trow[j] = j == f ? bj : (j > f ? -bj * acc : 0.f);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) tm[f * NB + u] = trow[u];
  }
}

// One warp applies a staged panel (V: rows kb .. I-1 of w columns at
// V[l * ld + r - kb]; T) to the column C, rows kb .. I-1:
// TRANS: C -= V T^T V^T C (the forward pass, H_{w-1} ... H_0 C);
// else:  C -= V T V^T C   (the backward pass, H_0 ... H_{w-1} C).
// Rows go 32 RPL at a time, each lane's RPL rows of C and V loaded together.
template <bool TRANS>
__device__ __forceinline__ void apply_panel(float* C, const float* V, const float* tm, int kb,
                                         int w, int I, int ld) {
  const int lane = threadIdx.x & 31, nrows = I - kb;
  C += kb;
  float W[NB];
#pragma unroll
  for (int l = 0; l < NB; ++l) W[l] = 0.f;
  for (int c0 = 0; c0 < nrows; c0 += 32 * RPL) {
    float cr[RPL], vr[RPL][NB];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int rl = c0 + lane + 32 * i;
      cr[i] = rl < nrows ? C[rl] : 0.f;
#pragma unroll
      for (int l = 0; l < NB; ++l) vr[i][l] = (rl < nrows && l < w) ? V[(size_t)l * ld + rl] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int l = 0; l < NB; ++l) W[l] = fmaf(vr[i][l], cr[i], W[l]);
  }
  warp_sums(W);
  float U[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    float u = 0.f;
    if (TRANS) {  // U = T^T W: U[m] = sum_{l <= m} T[l][m] W[l]
#pragma unroll
      for (int l = 0; l <= m; ++l) u = fmaf(tm[l * NB + m], W[l], u);
    } else {  // U = T W: U[m] = sum_{l >= m} T[m][l] W[l]
#pragma unroll
      for (int l = m; l < NB; ++l) u = fmaf(tm[m * NB + l], W[l], u);
    }
    U[m] = u;
  }
  for (int c0 = 0; c0 < nrows; c0 += 32 * RPL) {
    float cr[RPL], vr[RPL][NB];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int rl = c0 + lane + 32 * i;
      cr[i] = rl < nrows ? C[rl] : 0.f;
#pragma unroll
      for (int l = 0; l < NB; ++l) vr[i][l] = (rl < nrows && l < w) ? V[(size_t)l * ld + rl] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int rl = c0 + lane + 32 * i;
#pragma unroll
      for (int l = 0; l < NB; ++l) cr[i] = fmaf(-vr[i][l], U[l], cr[i]);
      if (rl < nrows) C[rl] = cr[i];
    }
  }
}

// Panel b of region k as its owner holds it: V from row kb on, at
// v[l * ld + r - kb] for column l and row r (v points at the owner's column 0,
// row kb), and T. Copied into the stage as V[e] = v[e], e < n = w ld - kb
// (entries past row I - 1 are never read).
struct PanelSrc {
  const float* v;
  const float* t;
  int kb, w, n;
};

template <bool RES>
__device__ __forceinline__ PanelSrc panel_src(const Ctx& c, int k, int b) {
  const int o = b % CL, ld = c.L.ld;
  PanelSrc p;
  p.kb = b * NB;
  p.w = min(NB, c.q - p.kb);
  p.n = p.w * ld - p.kb;
  p.v = region<RES>(c, k, o) + (size_t)(b / CL) * NB * ld + p.kb;
  // T always lives in shared memory
  float* t_own = c.sm + c.L.t_own + (size_t)(b / CL) * NB * NB;
  p.t = o == c.rank ? t_own : cg::this_cluster().map_shared_rank(t_own, o);
  return p;
}

// thread tid of the nt copying: its SB values of the batch at e0 (and, with
// the first batch, T[tid]), all loads in flight at once; then their stores
template <bool RES>
__device__ __forceinline__ void fetch(const PanelSrc& p, int e0, int tid, int nt,
                                      float (&v)[SB + 1]) {
#pragma unroll
  for (int u = 0; u < SB; ++u) {
    const int e = e0 + tid + u * nt;
    v[u] = e < p.n ? shared_ld<RES>(p.v + e) : 0.f;
  }
  v[SB] = (e0 == 0 && tid < NB * NB) ? p.t[tid] : 0.f;
}

__device__ __forceinline__ void put(const PanelSrc& p, int e0, int tid, int nt,
                                    const float (&v)[SB + 1], float* V, float* tm) {
#pragma unroll
  for (int u = 0; u < SB; ++u) {
    const int e = e0 + tid + u * nt;
    if (e < p.n) V[e] = v[u];
  }
  if (e0 == 0 && tid < NB * NB) tm[tid] = v[SB];
}

// the batches from e0 on, by threads tid of nt (nt >= NB * NB)
template <bool RES>
__device__ __forceinline__ void stage(const PanelSrc& p, int e0, int tid, int nt, float* V,
                                      float* tm) {
  for (; e0 < p.n; e0 += SB * nt) {
    float v[SB + 1];
    fetch<RES>(p, e0, tid, nt, v);
    put(p, e0, tid, nt, v, V, tm);
  }
}

template <bool RES>
__device__ __forceinline__ void cluster_barrier() {
  if (!RES) __threadfence();  // the column regions' global writes, at device scope
  cg::this_cluster().sync();
}

// Householder orthonormalisation of the iterate in region k: the region
// then holds the reflectors, and region 1 - k holds Q.
template <bool RES>
__device__ __forceinline__ void hqr(const Ctx& c, int k) {
  const int warp = threadIdx.x >> 5, ld = c.L.ld;
  float* P = region<RES>(c, k, c.rank);
  float* Qc = region<RES>(c, 1 - k, c.rank);
  // stage slot `slot`: V, then T
  auto V_of = [&](int slot) { return c.sm + c.L.stage + slot * stage_floats(ld); };
  auto T_of = [&](int slot) { return V_of(slot) + (size_t)NB * ld; };
  const int fw = factor_warps(c.I);
  float* xch = c.sm + c.L.xch;
  // the panel in local columns lb NB .. of P, and its T
  float* zst = c.sm + c.L.zst;
  auto factor = [&](int b) {
    float* pan = P + (size_t)(b / CL) * NB * ld;
    float* t = c.sm + c.L.t_own + (b / CL) * NB * NB;
    const int w = min(NB, c.q - b * NB);
    if (fw == 1)
      factor_panel<false>(pan, t, b * NB, w, c.I, ld, fw, xch, zst);
    else
      factor_panel<true>(pan, t, b * NB, w, c.I, ld, fw, xch, zst);
  };
  // A panel just factored here goes straight into the stage slot pb % 2 of
  // the next panel's owner, which then starts on it without copying it.
  auto push = [&](int pb) {
    if (pb + 1 >= c.L.panels) return;
    const int o = (pb + 1) % CL;
    const PanelSrc src = panel_src<RES>(c, k, pb);  // this CTA's own panel
    float* dst = cg::this_cluster().map_shared_rank(V_of(pb & 1), o);
    float* t_dst = cg::this_cluster().map_shared_rank(T_of(pb & 1), o);
    for (int e = threadIdx.x; e < src.n; e += SNT) dst[e] = src.v[e];
    if (threadIdx.x < NB * NB) t_dst[threadIdx.x] = src.t[threadIdx.x];
  };
  if (c.rank == 0) {
    if (warp < fw) factor(0);
    __syncthreads();
    push(0);
  }
  // The owner of the next panel defers its other columns' update with panel
  // b to the next step, so that nothing else runs on its SM while it factors
  // (the factoring warp's shuffles and shared-memory loads would queue behind
  // theirs); panel b then stays in its slot, b % 2, for one more step.
  PanelSrc deferred{};
  bool pending = false;
  for (int b = 0; b < c.L.panels; ++b) {
    const int next = b + 1, slot = b & 1;
    const bool ahead = next < c.L.panels && next % CL == c.rank;
    cluster_barrier<RES>();  // panel b's V and T are out (in the next owner's slot)
    const PanelSrc p = panel_src<RES>(c, k, b);
    if (!ahead) stage<RES>(p, 0, threadIdx.x, SNT, V_of(slot), T_of(slot));
    __syncthreads();
    if (ahead) {
      // the next panel's columns take panel b, one warp each, then it is
      // factored and sent on
      const int lc = next / CL * NB + warp;
      if (warp < NB && global_col(c, lc) >= 0)
        apply_panel<true>(P + (size_t)lc * ld, V_of(slot), T_of(slot), p.kb, p.w, c.I, ld);
      __syncthreads();
      if (warp < fw) factor(next);
      __syncthreads();
      push(next);
      deferred = p;
      pending = true;
    } else {
      // own columns of the panels after b: the deferred panel b - 1 first
      for (int lc = warp; lc < c.L.ncol; lc += SNW) {
        if (lc / NB * CL + c.rank <= b || global_col(c, lc) < 0) continue;
        if (pending)
          apply_panel<true>(P + (size_t)lc * ld, V_of(1 - slot), T_of(1 - slot), deferred.kb,
                            deferred.w, c.I, ld);
        apply_panel<true>(P + (size_t)lc * ld, V_of(slot), T_of(slot), p.kb, p.w, c.I, ld);
      }
      pending = false;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < c.L.ncol * c.I; e += SNT) {
    const int lc = e / c.I, r = e % c.I;
    Qc[(size_t)lc * ld + r] = r == global_col(c, lc) ? 1.f : 0.f;
  }
  // Backward, two panels a step from the last (one barrier pair for two):
  // the first batches of the next step's two copies are in flight while
  // this step's panels are applied.
  float pre[2][SB + 1];
  PanelSrc p2[2] = {};
  for (int h = 0; h < 2; ++h) {
    const int pb = c.L.panels - 1 - h;
    if (pb >= 0) {
      p2[h] = panel_src<RES>(c, k, pb);
      fetch<RES>(p2[h], 0, threadIdx.x, SNT, pre[h]);
    }
  }
  for (int b = c.L.panels - 1; b >= 0; b -= 2) {
    __syncthreads();  // the stage is free, Q's columns are written
    for (int h = 0; h < 2 && b - h >= 0; ++h) {
      put(p2[h], 0, threadIdx.x, SNT, pre[h], V_of(h), T_of(h));
      stage<RES>(p2[h], SB * SNT, threadIdx.x, SNT, V_of(h), T_of(h));
    }
    __syncthreads();
    const PanelSrc cur[2] = {p2[0], p2[1]};
    for (int h = 0; h < 2; ++h) {
      const int pb = b - 2 - h;
      if (pb >= 0) {
        p2[h] = panel_src<RES>(c, k, pb);
        fetch<RES>(p2[h], 0, threadIdx.x, SNT, pre[h]);
      }
    }
    // panel b, then panel b - 1, on the own columns from each panel on
    for (int lc = warp; lc < c.L.ncol; lc += SNW) {
      const int pl = lc / NB * CL + c.rank;
      if (global_col(c, lc) < 0 || pl < b - 1) continue;
      if (pl >= b)
        apply_panel<false>(Qc + (size_t)lc * ld, V_of(0), T_of(0), cur[0].kb, cur[0].w, c.I, ld);
      if (b >= 1)
        apply_panel<false>(Qc + (size_t)lc * ld, V_of(1), T_of(1), cur[1].kb, cur[1].w, c.I, ld);
    }
  }
  cluster_barrier<RES>();
}

// dst = G src on the own columns; each output sums k = 0 .. I-1 in order
__device__ __forceinline__ void gram_mul(const Ctx& c, const float* __restrict__ g,
                                         const float* src, float* dst) {
  GSmem& tiles = *reinterpret_cast<GSmem*>(c.sm + c.L.stage);
  const int I = c.I, ncol = c.L.ncol, ld = c.L.ld;
  const int tid = threadIdx.x % GNT, ty = tid / (GN / 4), tx = tid % (GN / 4);
  for (int m0 = 0; m0 < I; m0 += GM)
    for (int n0 = 0; n0 < ncol; n0 += GN) {
      float acc[4][4];
      // G is symmetric: G(m, k) is read as row k, m contiguous; the first
      // thread group ends with the tile
      if (!tile_gemm<GM, GN, GK, GNT, false, true, GKS>(
              tiles, m0, n0, I,
              [=](int m, int k) { return (m < I && k < I) ? __ldg(g + (size_t)k * I + m) : 0.f; },
              [=](int k, int n) { return (k < I && n < ncol) ? src[(size_t)n * ld + k] : 0.f; },
              acc))
        continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
          if (m < I && n < ncol) dst[(size_t)n * ld + m] = acc[i][j];
        }
    }
  __syncthreads();
}

// launched as one cluster of CL CTAs (launch_cluster)
template <bool RES>
__global__ void __launch_bounds__(SNT) rf_cluster_kernel(SerialArgs s) {
  extern __shared__ __align__(16) float sm[];
  Ctx c;
  c.sm = sm;
  c.cols = s.cols;
  c.L = layout(s.I, s.q, RES);
  c.I = s.I;
  c.q = s.q;
  c.rank = (int)cg::this_cluster().block_rank();
  const int ld = c.L.ld;
  int k = 0;  // the region holding the iterate
  float* P = region<RES>(c, 0, c.rank);
  for (int e = threadIdx.x; e < c.L.ncol * c.I; e += SNT) {
    const int lc = e / c.I, r = e % c.I, col = global_col(c, lc);
    P[(size_t)lc * ld + r] = col >= 0 ? s.y[(size_t)r * c.q + col] : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < s.n_iter; ++it) {
    colnorm(c, region<RES>(c, k, c.rank));
    if (s.mid_orth > 0 && (it + 1) % s.mid_orth == 0) {
      hqr<RES>(c, k);
      k = 1 - k;
    }
    gram_mul(c, s.g, region<RES>(c, k, c.rank), region<RES>(c, 1 - k, c.rank));
    k = 1 - k;
  }
  colnorm(c, region<RES>(c, k, c.rank));
  hqr<RES>(c, k);  // ends in a cluster barrier: no CTA reads another's memory after it
  const float* Qc = region<RES>(c, 1 - k, c.rank);
  for (int e = threadIdx.x; e < c.L.ncol * c.I; e += SNT) {
    const int lc = e / c.I, r = e % c.I, col = global_col(c, lc);
    if (col >= 0 && col < s.rank) s.q_out[(size_t)r * s.rank + col] = Qc[(size_t)lc * ld + r];
  }
}

// R = Q^T B (rank, J), k = I
__global__ void __launch_bounds__(NT) rf_r_kernel(const float* __restrict__ qm,
                                           const float* __restrict__ b, float* r, int I, int J,
                                           int rank, int nR) {
  __shared__ Smem sm;
  const int mt = blockIdx.x % nR, nt = blockIdx.x / nR;
  const int ty = threadIdx.x / (T / 4), tx = threadIdx.x % (T / 4);
  float acc[4][4];
  tile_gemm<T, T, TK, NT, false, false>(
      sm, mt * T, nt * T, I,
      [=](int m, int k) { return (m < rank && k < I) ? qm[(size_t)k * rank + m] : 0.f; },
      [=](int k, int n) { return (k < I && n < J) ? b[(size_t)k * J + n] : 0.f; }, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = mt * T + ty * 4 + i, n = nt * T + tx * 4 + j;
      if (m < rank && n < J) r[(size_t)m * J + n] = acc[i][j];
    }
}

struct Scratch {
  float *y, *g, *n2, *cols, *partials;
};

long cols_floats(int I, int q) {
  return resident_fits(I, q) ? 0L : (long)CL * 2 * layout(I, q, false).region;
}

Scratch carve(float* base, const Args& a) {
  Scratch s;
  s.y = base;
  s.g = s.y + (size_t)a.I * a.q;
  s.n2 = s.g + (size_t)a.I * a.I;
  s.cols = s.n2 + 1;
  s.partials = s.cols + cols_floats(a.I, a.q);
  return s;
}

template <bool RES>
cudaError_t launch_cluster(const SerialArgs& s, cudaStream_t st) {
  const long bytes = layout(s.I, s.q, RES).floats * (long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rf_cluster_kernel<RES>,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(rf_cluster_kernel<RES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(SNT);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rf_cluster_kernel<RES>, s);
}

}  // namespace

extern "C" {

// scratch of one call, in floats: y, G, n2, the column regions when they
// are not resident, the split partials
long tnml_rangefinder_scratch_floats(int I, int J, int q) {
  Args a{};
  plan(a, I, J, q);
  return (long)I * q + (long)I * I + 1 + cols_floats(I, q) + partial_floats(a);
}

// the most rows the kernel takes
int tnml_rangefinder_max_rows() { return MAX_ROWS; }

// 1 when the cluster keeps the columns of an (I, q) iterate in shared memory
int tnml_rangefinder_resident(int I, int q) { return resident_fits(I, q) ? 1 : 0; }

// K6: (Q (I, rank), R = Q^T B (rank, J)) with q = q_cols sketch columns,
// rank <= q <= I
int tnml_rangefinder_split(const float* b, const float* om, float* q_out, float* r_out,
                           float* scratch, int I, int J, int q, int rank, int n_iter,
                           int mid_orth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rank < 1 || rank > q || q > I || I > MAX_ROWS || J < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  plan(a, I, J, q);
  const Scratch sc = carve(scratch, a);
  a.b = b;
  a.rhs = om;
  a.y = sc.y;
  a.g = sc.g;
  a.n2 = sc.n2;
  a.n2p = sc.partials;
  a.yp = a.n2p + (size_t)a.S * a.nI;
  a.gp = a.yp + (a.S > 1 ? (size_t)a.S * a.I * a.q : 0);
  sketch_tile_kernel<<<dim3(a.jobs_y + a.jobs_g, a.S), NT, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_out = std::max((long)I * q, (long)I * I);
  rf_finish_kernel<<<cdiv(n_out, NT), NT, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const SerialArgs s{sc.g, sc.y, sc.cols, q_out, I, q, rank, n_iter, mid_orth};
  err = resident_fits(I, q) ? launch_cluster<true>(s, st) : launch_cluster<false>(s, st);
  if (err != cudaSuccess) return (int)err;

  const int nR = cdiv(rank, T);
  rf_r_kernel<<<nR * cdiv(J, T), NT, 0, st>>>(q_out, b, r_out, I, J, rank, nR);
  return (int)cudaGetLastError();
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
