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
//
// K4a and K4b also have a one-pass TF32 form (tnml_gramfree_sketch_tf32,
// tnml_gramfree_gmul_tf32) for gramfree_split under a reduced precision:
// every product from cvt.rna-rounded operands summed in float32, on a pipeline
// of its own (tc_tf32.cuh: the TMA and mbarriers feeding wgmma on 256 x 128
// tiles for K4a and 128 x 256 for K4b, the m-contiguous operand rounded and transposed in registers, the k
// split in clusters of 2 that add their tiles through distributed shared
// memory, and past two splits one fixed-order exchange in global memory, all
// in one launch a GEMM). Their bound is a third of the 3xTF32 form's tensor work: 21.7 us
// for K4a and 43.4 us for K4b at M = 512 at 495 TFLOP/s, against 19.5 and
// 13.7 us of traffic.

#include <cuda_runtime.h>

#include <algorithm>

#include "tc_gemm.cuh"
#include "tc_tf32.cuh"

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

// scratch of the one-pass K4a, in floats: n2's partial sums, then Omega and B
// copied to 16-byte rows where they need it
long tnml_gramfree_sketch_tf32_scratch_floats(int I, int J, int q) {
  return tf1::sketch_layout(I, J, q).floats;
}

// scratch of the one-pass K4b, in floats: y1^T and t^T, then B copied to
// 16-byte rows where it needs it
long tnml_gmul_tf32_scratch_floats(int I, int J, int q) {
  return tf1::gmul_layout(I, J, q).floats;
}

// the one-pass forms' plan of a GEMM of C (M, N) over k = K on tiles of
// 128 mw x 256 / mw (mw = 2 for K4a, 1 for K4b's halves): {tiles in m, in n,
// the k split, chunks of 32 a split, the tile's rows, its columns}
void tnml_tf32_plan(int M, int N, int K, int mw, int* out) {
  const tf1::Gemm g = mw == 2 ? tf1::plan<2>(M, N, K) : tf1::plan<1>(M, N, K);
  out[0] = g.nM;
  out[1] = g.nN;
  out[2] = g.S;
  out[3] = g.kc;
  out[4] = 128 * (mw == 2 ? 2 : 1);
  out[5] = 256 / (mw == 2 ? 2 : 1);
}

// K4a: y0 = B Omega, n2 = |B|_F^2 (3xTF32)
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

// K4a in one TF32 pass (one launch; its own scratch)
int tnml_gramfree_sketch_tf32(const float* b, const float* om, float* y0, float* n2,
                              float* scratch, int I, int J, int q, void* stream) {
  return (int)tf1::sketch(b, om, y0, n2, scratch, I, J, q, (cudaStream_t)stream);
}

// K5: y = B Omega, G = B B^T, n2 = |B|_F^2
int tnml_sketch_gram(const float* b, const float* om, float* y, float* g, float* n2,
                     float* scratch, int I, int J, int q, void* stream) {
  return tc::sketch_gram(b, om, y, g, n2, scratch, I, J, q, (cudaStream_t)stream);
}

// K4b: z = B (B^T y1) (3xTF32)
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

// K4b in one TF32 pass (y1's transpose, then the two halves; its own scratch)
int tnml_gramfree_gmul_tf32(const float* b, const float* y1, float* z, float* scratch, int I,
                            int J, int q, void* stream) {
  return (int)tf1::gmul(b, y1, z, scratch, I, J, q, (cudaStream_t)stream);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
