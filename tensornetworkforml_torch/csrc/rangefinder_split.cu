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
// What bounds it on this card: the dependent steps. The arithmetic is ~1e9
// FLOP at the flagship (I = 256, J = 2560, q = 136, rank = 128), 16 us at the
// float32 rate, but the 7 orthonormalisations are 2 x 136 reflector steps
// each, every one waiting for the one before: ~1900 dependent steps.
//
// Design: four launches, counted as one kernel by the wrapper.
//   sketch_tile_kernel  (sketch_gram.cuh, as K5) y = B Omega, G = B B^T and
//                       partial sums of |B|_F^2 over many blocks, with the J
//                       range split when the tiles alone cannot fill the card.
//   rf_finish_kernel    adds the split partials in split order and scales:
//                       y / bn and G / bn / bn with bn = sqrt(n2) + 1e-30,
//                       which is bs Omega and bs bs^T up to rounding.
//   rf_serial_kernel    the whole subspace iteration on ONE block of 512
//                       threads. The panel y is column-major with an odd
//                       leading dimension (I + 1), so that a warp reading a
//                       column or a row of it hits 32 banks. It lives in
//                       shared memory when it fits (I = 256, q = 136: 139 KB)
//                       and in global memory (L2) otherwise. The reflectors
//                       are stored in place, as LAPACK's geqr2 does: v_j in
//                       column j below the diagonal, its diagonal entry and
//                       beta in two short vectors; Q is then accumulated in
//                       place, as org2r does. Each forward step has one block
//                       barrier (every warp forms the reflector itself), each
//                       backward step two. G y reads G (exactly symmetric)
//                       from global memory, row k for column k. The helpers
//                       are inlined so that the compiler sees which memory
//                       the panel is in.
//   rf_r_kernel         R = Q^T B through the tile GEMM (tile_gemm.cuh).
// There are no float atomics and every sum runs in a fixed order: two
// launches agree bit for bit, and both panel paths compute the same bits.

#include <cuda_runtime.h>

#include "sketch_gram.cuh"

namespace {

constexpr int SNT = 512;  // threads of the serial kernel
constexpr int SNW = SNT / 32;
constexpr float EPS = 1e-30f;
// the opt-in shared memory of one block on sm_90
constexpr long MAX_SMEM = 232448;

struct SerialArgs {
  const float* g;  // (I, I) scaled Gram
  const float* y;  // (I, q) scaled sketch, row-major
  float* panel;    // (q, I + 1) column-major, when the panel is not resident
  float* w;        // (q, I + 1) scratch for G y
  float* q_out;    // (I, rank) row-major
  int I, q, rank, n_iter, mid_orth;
};

long serial_smem_bytes(int I, int q, bool resident) {
  return 4L * ((resident ? (long)(I + 1) * q : 0L) + 2L * q);
}

bool resident_fits(int I, int q) { return serial_smem_bytes(I, q, true) <= MAX_SMEM; }

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
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

// every column divided by max(|col|, 1e-30); a warp per column
__device__ __forceinline__ void colnorm(float* P, int I, int q, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < q; c += SNW) {
    float* col = P + (size_t)c * ld;
    float ss = 0.f;
    for (int r = lane; r < I; r += 32) ss = fmaf(col[r], col[r], ss);
    const float d = nanmax(sqrtf(warp_sum(ss)), EPS);
    for (int r = lane; r < I; r += 32) col[r] = col[r] / d;
  }
  __syncthreads();
}

// Columns c > j of the panel, c = j + 1 + warp + SNW t, in groups of four
// (independent dot products in flight): d_c = sum_{r >= j} v_r P[r, c], then
// P[r, c] -= (beta v_r) d_c. v is column j below the diagonal and v0 on it.
// With ROW_J_ZERO (the backward pass) row j of the columns counts as zero in
// the dot product and is set to -(beta v0) d_c.
template <bool ROW_J_ZERO>
__device__ __forceinline__ void apply_reflector(float* P, int I, int q, int ld, int j, float v0,
                                                float beta) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* x = P + (size_t)j * ld;
  const int r_first = ROW_J_ZERO ? j + 1 : j;
  for (int c0 = j + 1 + warp; c0 < q; c0 += 4 * SNW) {
    float* col[4];
    bool ok[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ok[u] = c0 + u * SNW < q;
      col[u] = P + (size_t)(ok[u] ? c0 + u * SNW : c0) * ld;
      d[u] = 0.f;
    }
    for (int r = r_first + lane; r < I; r += 32) {
      const float v = r == j ? v0 : x[r];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ok[u]) d[u] = fmaf(v, col[u][r], d[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = warp_sum(d[u]);
    if (ROW_J_ZERO && lane == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ok[u]) col[u][j] = -(beta * v0) * d[u];
    }
    for (int r = r_first + lane; r < I; r += 32) {
      const float bv = beta * (r == j ? v0 : x[r]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (ok[u]) col[u][r] = fmaf(-bv, d[u], col[u][r]);
    }
  }
}

// Householder orthonormalisation of the panel in place: P (I x q) -> Q.
__device__ __forceinline__ void hqr(float* P, float* vdiag, float* betas, int I, int q,
                                    int ld) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < q; ++j) {
    // every warp forms reflector j from column j, which no one writes now
    const float* x = P + (size_t)j * ld;
    float s = 0.f;
    for (int r = j + 1 + lane; r < I; r += 32) s = fmaf(x[r], x[r], s);
    const float tail = warp_sum(s);
    const float x0 = x[j];
    const float sigma = sqrtf(fmaf(x0, x0, tail));
    const float t = x0 + EPS;
    const float alpha = -(float)((t > 0.f) - (t < 0.f)) * sigma;  // sign(0) = 0
    const float v0 = x0 - alpha;
    const float vn2 = fmaf(v0, v0, tail);
    const bool live = vn2 > EPS;  // uniform over the block
    const float beta = live ? 2.f / fmaxf(vn2, EPS) : 0.f;
    if (threadIdx.x == 0) {
      vdiag[j] = live ? v0 : 0.f;
      betas[j] = beta;
    }
    if (live) apply_reflector<false>(P, I, q, ld, j, v0, beta);
    __syncthreads();
  }
  // Q = H_0 ... H_{q-1} [I_q; 0]: at step k the columns right of k hold
  // rows k+1.. of the product so far, and row k of them is zero
  for (int k = q - 1; k >= 0; --k) {
    const float beta = betas[k], v0 = vdiag[k];
    const float* x = P + (size_t)k * ld;
    if (beta != 0.f) {
      apply_reflector<true>(P, I, q, ld, k, v0, beta);
    } else {
      for (int c = k + 1 + (int)threadIdx.x; c < q; c += SNT) P[(size_t)c * ld + k] = 0.f;
    }
    __syncthreads();  // every read of v_k is done
    for (int r = k + (int)threadIdx.x; r < I; r += SNT) {
      const float v = r == k ? v0 : x[r];
      P[(size_t)k * ld + r] = (r == k ? 1.f : 0.f) - (beta * v) * v0;
    }
    __syncthreads();
  }
}

// P <- G P through the scratch W; each thread owns 4 rows x 8 columns of the
// product at a time and runs k = 0 .. I-1 in order. G is symmetric, so row k
// of G stands for its column k and a warp reads it in one run.
__device__ __forceinline__ void gram_mul(const float* __restrict__ g, float* P, float* W, int I,
                                         int q, int ld) {
  const int nRG = (I + 3) / 4, nCG = (q + 7) / 8;
  for (int t = threadIdx.x; t < nRG * nCG; t += SNT) {
    const int r0 = (t % nRG) * 4, c0 = (t / nRG) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
#pragma unroll 4
    for (int k = 0; k < I; ++k) {
      float gv[4], pv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = r0 + i < I ? g[(size_t)k * I + r0 + i] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) pv[u] = c0 + u < q ? P[(size_t)(c0 + u) * ld + k] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[i][u] = fmaf(gv[i], pv[u], acc[i][u]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (r0 + i < I && c0 + u < q) W[(size_t)(c0 + u) * ld + r0 + i] = acc[i][u];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < I * q; e += SNT) {
    const size_t off = (size_t)(e / I) * ld + e % I;
    P[off] = W[off];
  }
  __syncthreads();
}

template <bool RESIDENT>
__global__ void __launch_bounds__(SNT) rf_serial_kernel(SerialArgs s) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  const int I = s.I, q = s.q, ld = I + 1;
  float* P = RESIDENT ? dyn : s.panel;
  float* vdiag = RESIDENT ? dyn + (size_t)ld * q : dyn;
  float* betas = vdiag + q;
  for (int e = threadIdx.x; e < I * q; e += SNT) P[(size_t)(e % q) * ld + e / q] = s.y[e];
  __syncthreads();
  for (int it = 0; it < s.n_iter; ++it) {
    colnorm(P, I, q, ld);
    if (s.mid_orth > 0 && (it + 1) % s.mid_orth == 0) hqr(P, vdiag, betas, I, q, ld);
    gram_mul(s.g, P, s.w, I, q, ld);
  }
  colnorm(P, I, q, ld);
  hqr(P, vdiag, betas, I, q, ld);
  for (int e = threadIdx.x; e < I * s.rank; e += SNT)
    s.q_out[e] = P[(size_t)(e % s.rank) * ld + e / s.rank];
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
  float *y, *g, *n2, *w, *panel, *partials;
};

Scratch carve(float* base, const Args& a) {
  const size_t Iq = (size_t)a.I * a.q, panel = (size_t)(a.I + 1) * a.q;
  Scratch s;
  s.y = base;
  s.g = s.y + Iq;
  s.n2 = s.g + (size_t)a.I * a.I;
  s.w = s.n2 + 1;
  s.panel = s.w + panel;
  s.partials = s.panel + panel;
  return s;
}

}  // namespace

extern "C" {

// scratch of one call, in floats: y, G, n2, W, the panel, the split partials
long tnml_rangefinder_scratch_floats(int I, int J, int q) {
  Args a{};
  plan(a, I, J, q, true);
  return (long)I * q + (long)I * I + 1 + 2L * (I + 1) * q + partial_floats(a);
}

// 1 when the panel of an (I, q) iterate stays in shared memory
int tnml_rangefinder_resident(int I, int q) { return resident_fits(I, q) ? 1 : 0; }

// K6: (Q (I, rank), R = Q^T B (rank, J)) with q = q_cols sketch columns,
// rank <= q <= I
int tnml_rangefinder_split(const float* b, const float* om, float* q_out, float* r_out,
                           float* scratch, int I, int J, int q, int rank, int n_iter,
                           int mid_orth, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rank < 1 || rank > q || q > I || J < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  plan(a, I, J, q, true);
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

  SerialArgs s{sc.g, sc.y, sc.panel, sc.w, q_out, I, q, rank, n_iter, mid_orth};
  const bool resident = resident_fits(I, q);
  const long smem = serial_smem_bytes(I, q, resident);
  if (resident) {
    err = cudaFuncSetAttribute(rf_serial_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    rf_serial_kernel<true><<<1, SNT, smem, st>>>(s);
  } else {
    rf_serial_kernel<false><<<1, SNT, smem, st>>>(s);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nR = cdiv(rank, T);
  rf_r_kernel<<<nR * cdiv(J, T), NT, 0, st>>>(q_out, b, r_out, I, J, rank, nR);
  return (int)cudaGetLastError();
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
