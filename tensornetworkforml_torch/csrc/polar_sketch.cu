// The polar splits' streaming reductions over the columns of the two-site
// matrix B (I, J), for Hopper (sm_90a): kernels K4a, K4b and K5.
//
// Replaces, in tensornetworkforml_tpu/ops/kernels/polar_split.py:
//   K4a  _sketch_kernel (gramfree_split):  y0 = B Omega (I, q), n2 = |B|_F^2
//   K4b  _gmul_kernel (gramfree_split):    z = B (B^T y1) (I, q)
//   K5   _sketch_gram_kernel (polar_sketch_gram_pallas):
//                                          y = B Omega, G = B B^T (I, I), n2
// The Pallas kernels walk J in chunks on one core and carry the (I, q) and
// (I, I) sums in VMEM from one grid step to the next. Here every output is cut
// into 64 x 64 tiles whose k range (the J axis) is split over S blocks when
// the tiles alone cannot fill the card; the S partial tiles are then added in
// a fixed order by a second launch. There are no float atomics: two launches
// agree bit for bit. Every product is a float32 FMA (tile_gemm.cuh); TF32 is
// not used.
//
// What bounds them on this card: the operations. At M = 512 (I = 1024,
// J = 10240, q = 512) K4a is 1.07e10 FLOP against 64 MB of traffic, K4b
// 2.15e10 and K5 3.22e10 against at most 69 MB, so the float32 FMA rate and
// how many SMs have work decide; B (42 MB) fits the 50 MB L2.
//
// Design:
//   sketch_tile_kernel    (sketch_gram.cuh, shared with K6) one block per
//                         (output tile, k split). The y tiles of
//                         output column-tile 0 also sum the squares of the B
//                         elements they load, so n2 costs no second pass over
//                         B. K5 adds the tiles of G's upper triangle and
//                         writes each off-diagonal tile twice (G and its
//                         mirror): 136 instead of 256 tiles at I = 1024.
//   sketch_finish_kernel  (sketch_gram.cuh) adds the S partial tiles in split
//                         order, and the n2 partials in a fixed tree order.
//   sketch_bt_kernel      K4b's first half, t = B^T y1 (J, q) with k = I; t
//                         goes to scratch (21 MB at M = 512, mostly held in
//                         L2), and the second half z = B t is
//                         sketch_tile_kernel with t for Omega.
// K4b is these launches together, counted as one kernel by its wrapper.

#include <cuda_runtime.h>

#include "sketch_gram.cuh"

namespace {

// t = B^T y1: (J, q), k = I
__global__ void __launch_bounds__(NT) sketch_bt_kernel(const float* __restrict__ b,
                                                const float* __restrict__ y1, float* t, int I,
                                                int J, int q, int nJ) {
  __shared__ Smem sm;
  const int jt = blockIdx.x % nJ, qt = blockIdx.x / nJ;
  const int ty = threadIdx.x / (T / 4), tx = threadIdx.x % (T / 4);
  float acc[4][4];
  tile_gemm<T, T, TK, NT, false, false>(
      sm, jt * T, qt * T, I,
      [=](int m, int k) { return (m < J && k < I) ? b[(size_t)k * J + m] : 0.f; },
      [=](int k, int n) { return (k < I && n < q) ? y1[(size_t)k * q + n] : 0.f; }, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = jt * T + ty * 4 + i, n = qt * T + tx * 4 + j;
      if (m < J && n < q) t[(size_t)m * q + n] = acc[i][j];
    }
}

}  // namespace

extern "C" {

// scratch of K4a (gram = 0) or K5 (gram = 1), in floats
long tnml_sketch_scratch_floats(int I, int J, int q, int gram) {
  Args a{};
  plan(a, I, J, q, gram != 0);
  return partial_floats(a);
}

// scratch of K4b, in floats: t (J, q) and the partials of z = B t
long tnml_gmul_scratch_floats(int I, int J, int q) {
  Args a{};
  plan(a, I, J, q, false);
  return (long)J * q + partial_floats(a);
}

// K4a: y0 = B Omega, n2 = |B|_F^2
int tnml_gramfree_sketch(const float* b, const float* om, float* y0, float* n2, float* scratch,
                         int I, int J, int q, void* stream) {
  Args a{};
  plan(a, I, J, q, false);
  a.b = b;
  a.rhs = om;
  a.y = y0;
  a.n2 = n2;
  return launch_sketch(a, scratch, (cudaStream_t)stream);
}

// K5: y = B Omega, G = B B^T, n2 = |B|_F^2
int tnml_sketch_gram(const float* b, const float* om, float* y, float* g, float* n2,
                     float* scratch, int I, int J, int q, void* stream) {
  Args a{};
  plan(a, I, J, q, true);
  a.b = b;
  a.rhs = om;
  a.y = y;
  a.g = g;
  a.n2 = n2;
  return launch_sketch(a, scratch, (cudaStream_t)stream);
}

// K4b: z = B (B^T y1)
int tnml_gramfree_gmul(const float* b, const float* y1, float* z, float* scratch, int I, int J,
                       int q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nJ = cdiv(J, T);
  float* t = scratch;
  sketch_bt_kernel<<<nJ * cdiv(q, T), NT, 0, st>>>(b, y1, t, I, J, q, nJ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a{};
  plan(a, I, J, q, false);
  a.b = b;
  a.rhs = t;
  a.y = z;
  return launch_sketch(a, scratch + (size_t)J * q, st);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
