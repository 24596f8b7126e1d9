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
// into tiles whose k range is split over S blocks when the tiles alone cannot
// fill the card; the S partial tiles are then added in a fixed order by a
// second launch (tc::split_sum_kernel). There are no float atomics: two
// launches agree bit for bit.
//
// What bounds them on this card: the operations. At M = 512 (I = 1024,
// J = 10240, q = 512) K4a is 1.07e10 FLOP against 65 MB of traffic, K4b
// 2.15e10 against 46 MB and K5 2.15e10 (G as one triangle) against 67 MB;
// B (42 MB) fits the 50 MB L2.
//
// Design: all three run on the tensor cores in 3xTF32 (tc_gemm.cuh: 128 x 128
// tiles, wgmma m64n128k8, a cp.async ring): each product within about ten
// times float32's error (tc_gemm.cuh), at up to 3 x 495 / 67 ~ 2.5 times the
// float32 FMA rate's bound.
//   K4a  y0 = B Omega; the y0 tiles of output column-tile 0 also sum the
//        squares of the float32 B elements they load, so n2 costs no second
//        pass over B.
//   K4b  t^T = y1^T B (q, J), k = I, into scratch (21 MB at M = 512), then
//        z = B t, k = J, with t^T read K-major; both operands of the first
//        half are transposed while they are split into hi and lo. Its blocks
//        run in one wave, all walking their k ranges in step, so the chunks
//        of B and t^T they share are read from L2 while hot.
//   K5   y = B Omega as K4a, and G = B B^T from its upper triangle of tiles
//        with both operands B read K-major, in one launch of one tile list
//        (tc_sketch_gram_kernel) whose k split is planned from both tile
//        counts together; each G tile writes its elements on and above the
//        diagonal at (i, j) and (j, i), so G is symmetric bit for bit. K8's
//        first stage (polar_iterate.cu) is this same call.
// K4b and K5 are their launches together, each counted as one kernel by its
// wrapper.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc_gemm.cuh"

namespace {

// K4b's halves: t^T (q, J) = y1^T B, k = I; z (I, q) = B t, k = J
tc::Gemm gmul_first_plan(const float* b, const float* y1, float* tt, int I, int J, int q) {
  tc::Gemm g{};
  tc::plan(g, q, J, I);
  g.a = y1;
  g.lda = q;
  g.a_vec = tc::aligned16(y1, q);
  g.b = b;
  g.ldb = J;
  g.b_vec = tc::aligned16(b, J);
  g.c = tt;
  g.ldc = J;
  return g;
}

tc::Gemm gmul_second_plan(const float* b, const float* tt, float* z, int I, int J, int q) {
  tc::Gemm g{};
  tc::plan(g, I, q, J);
  g.a = b;
  g.lda = J;
  g.a_vec = tc::aligned16(b, J);
  g.b = tt;
  g.ldb = J;
  g.b_vec = tc::aligned16(tt, J);
  g.c = z;
  g.ldc = q;
  return g;
}

}  // namespace

extern "C" {

// scratch of K5, in floats
long tnml_sketch_scratch_floats(int I, int J, int q) {
  return tc::sketch_gram_scratch_floats(I, J, q);
}

// scratch of K4a, in floats: the partial sums of squares, then the partials
// of y0
long tnml_gramfree_sketch_scratch_floats(int I, int J, int q) {
  const tc::Gemm g = tc::sketch_plan(nullptr, nullptr, nullptr, I, J, q);
  return (long)g.S * g.nM + tc::partial_floats(g);
}

// scratch of K4b, in floats: t^T (q, J), then the partials of either half
long tnml_gmul_scratch_floats(int I, int J, int q) {
  const tc::Gemm g1 = gmul_first_plan(nullptr, nullptr, nullptr, I, J, q);
  const tc::Gemm g2 = gmul_second_plan(nullptr, nullptr, nullptr, I, J, q);
  return (long)q * J + std::max(tc::partial_floats(g1), tc::partial_floats(g2));
}

// K4a: y0 = B Omega, n2 = |B|_F^2
int tnml_gramfree_sketch(const float* b, const float* om, float* y0, float* n2, float* scratch,
                         int I, int J, int q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  tc::Gemm g = tc::sketch_plan(b, om, y0, I, J, q);
  g.n2p = scratch;
  g.cp = scratch + (size_t)g.S * g.nM;
  cudaError_t err = tc::launch<true, false>(g, st);
  if (err != cudaSuccess) return (int)err;
  return tc::sum_splits(g, n2, nullptr, st);
}

// K5: y = B Omega, G = B B^T, n2 = |B|_F^2
int tnml_sketch_gram(const float* b, const float* om, float* y, float* g, float* n2,
                     float* scratch, int I, int J, int q, void* stream) {
  return tc::sketch_gram(b, om, y, g, n2, scratch, I, J, q, (cudaStream_t)stream);
}

// K4b: z = B (B^T y1)
int tnml_gramfree_gmul(const float* b, const float* y1, float* z, float* scratch, int I, int J,
                       int q, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* tt = scratch;
  float* parts = scratch + (size_t)q * J;
  tc::Gemm g1 = gmul_first_plan(b, y1, tt, I, J, q);
  g1.cp = parts;
  cudaError_t err = tc::launch<false, false>(g1, st);
  if (err != cudaSuccess) return (int)err;
  int e = tc::sum_splits(g1, nullptr, nullptr, st);
  if (e != 0) return e;
  tc::Gemm g2 = gmul_second_plan(b, tt, z, I, J, q);
  g2.cp = parts;
  err = tc::launch<true, true>(g2, st);
  if (err != cudaSuccess) return (int)err;
  return tc::sum_splits(g2, nullptr, nullptr, st);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
