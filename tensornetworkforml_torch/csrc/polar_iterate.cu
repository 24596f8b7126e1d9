// The polar split's subspace iteration (kernel K1) for Hopper (sm_90a).
//
// Replaces: tensornetworkforml_tpu/ops/kernels/polar_split.py, the Pallas
// kernel _iterate_kernel behind polar_iterate_pallas. Given a sketch y (I, q),
// the unscaled Gram g = B B^T (I, I) and n2 = |B|_F^2 (or tr g), it computes
//
//   g <- g / n2;  n_power times: y = g @ NS_loop(colnorm(y));
//   Q = NS_final(colnorm(y))
//
// where colnorm unit-normalises the live columns and zeroes (by select, so a
// NaN column cannot leak) those below dead_tol * max column norm, and NS is
// the polar Newton-Schulz iteration: a row-sum prescale of W = y^T y, then per
// pass  W = y^T y,  P = a I + b W + c W W,  y = y P  with the per-pass minimax
// coefficients of the host schedule (passed in as a parameter block). At the
// flagship (I = 256, q = 128; 5 loop and 14 final passes) that is a serial
// chain of ~60 dependent products of ~1e6 FMA each, ~2.2e8 FMA in all.
//
// What bounds it on this card: not the bytes (y, g and Q are 0.5 MB and stay in
// L2) but the dependence chain. Every pass needs all of W before any column of
// the next y, so the work can spread only as wide as one pass allows, and
// every pass ends in a barrier. The TPU kernel held y, g and W in VMEM; here g
// alone (256 KiB) exceeds a block's 227 KB of shared memory.
//
// Design: ONE launch of one thread-block cluster of 8 CTAs. CTA r owns the
// column block [r*CB, (r+1)*CB) of y, W and P (CB a multiple of 4), so each
// pass is two barriers:
//   W[:, cb] = y^T y[:, cb]                         -> barrier (W is shared)
//   P[:, cb] = a I + b W[:, cb] + c W W[:, cb];  y'[:, cb] = y P[:, cb]
//                                                   -> barrier (y' is shared)
// The product y P needs only this CTA's columns of P, and g y only its columns
// of y, so neither needs a barrier before it. Shared values pass through global
// scratch (L2-resident, read with ld.global.cg so that no CTA sees a stale L1
// line), ordered by the cluster barrier after a memory fence. W is symmetric
// bit for bit (the same FMA sequence for W[i,j] and W[j,i]), which lets W be
// read column-major. Every reduction runs in one fixed order, so all CTAs
// agree bit for bit. Products are full float32 FMAs.
//
// Two kernels, chosen at launch by what fits in a block's shared memory (each
// kernel gets its own register allocation):
//  * resident (the flagship: I = 256, q = 128 needs 217 KB): every CTA keeps
//    the whole iterate y and, during a pass, the whole of W in shared memory,
//    reloading each from L2 once per pass with cp.async (all copies queued,
//    one wait), so every product reads shared memory only; g y streams g
//    through shared memory in 32-column chunks. Column norms are cheap enough
//    for each CTA to compute for all columns, so colnorm needs no barrier.
//    Measured at the flagship on an H100: ~20 us per pass, near what 8 SMs of
//    8 warps issue for the ~1.3e6 FMA each CTA does per pass; the rest is
//    barriers and L2 round trips. More SMs per pass is the next step.
//  * streaming (larger I * q): operands stream from L2 in chunks through a
//    register-prefetched tile (tile_gemm.cuh), with each product's k range
//    split over two thread groups so that two L2 round trips are in flight.
//    Each chunk waits on an L2 round trip, which is what bounds this path.
// The device code is in polar_iterate.cuh, which K7 (two_site_step.cu) shares.
//
// This library also holds the all-in-one polar split (kernel K8), which
// replaces the Pallas kernel _polar_split_kernel behind polar_split_pallas in
// the same file. From the two-site matrix B (I, J) and the sketch Omega (J, q)
// it computes y = B Omega, G = B B^T and n2 = |B|_F^2 (accumulated, not tr G),
// then the iteration above with that n2: one C entry, two stages on one stream
// with no host work between. The first stage is K5's call (tc_gemm.cuh:
// y and G's upper triangle of 128 x 128 tiles, mirrored, on the tensor cores
// in 3xTF32, then the fixed-order sum), the second K1's launch. It sits here, not in a source of its own,
// because its device code is exactly K5's and K1's, and a library of its own
// would compile K1's two cluster kernels once more. The Pallas kernel's
// J-tiling, its 2 MB block cap and its 128-column padding were Mosaic
// workarounds: only the padded length at which the caller draws Omega is
// semantics, and the caller hands over its first J rows. R = Q^T B is a plain
// product outside the kernel, as in the JAX package. At the flagship two-site
// shape (I = 256, J = 2560, q = 128, n_power = 1) its reductions are ~3.4e8
// FLOP (one triangle of G) and the iteration 4.3e8, against ~3 MB of traffic.

#include <cuda_runtime.h>

#include "polar_iterate.cuh"
#include "tc_gemm.cuh"

namespace {

long round4(long n) { return (n + 3) / 4 * 4; }

// The scratch of one K8 split, in floats, each part 16-byte aligned:
// y (I, q), G (I, I), n2, K5's scratch, the iteration's scratch.
struct SplitLayout {
  long y, g, n2, part, pol, floats;
};

SplitLayout split_layout(int I, int J, int q) {
  SplitLayout s;
  long o = 0;
  s.y = o; o += round4((long)I * q);
  s.g = o; o += round4((long)I * I);
  s.n2 = o; o += 4;
  s.part = o; o += round4(tc::sketch_gram_scratch_floats(I, J, q));
  s.pol = o; o += polar::scratch_floats(I, q);
  s.floats = o;
  return s;
}

}  // namespace

extern "C" {

long tnml_polar_scratch_floats(int I, int q) { return polar::scratch_floats(I, q); }

int tnml_polar_iterate(const float* y, const float* g, const float* n2, float* q_out,
                       float* scratch, int I, int q, int n_power, const Coeffs* loop,
                       const Coeffs* fin, float dead_tol, void* stream) {
  return polar::launch(y, g, n2, q_out, scratch, I, q, n_power, loop, fin, dead_tol,
                       (cudaStream_t)stream);
}

int tnml_polar_resident(int I, int q) { return polar::fits_resident(I, q); }

// K8
long tnml_polar_split_scratch_floats(int I, int J, int q) {
  return split_layout(I, J, q).floats;
}

int tnml_polar_split(const float* b, const float* om, float* q_out, float* scratch, int I, int J,
                     int q, int n_power, const Coeffs* loop, const Coeffs* fin, float dead_tol,
                     void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const SplitLayout s = split_layout(I, J, q);
  float *y = scratch + s.y, *g = scratch + s.g, *n2 = scratch + s.n2;
  const int err = tc::sketch_gram(b, om, y, g, n2, scratch + s.part, I, J, q, st);
  if (err != 0) return err;
  return polar::launch(y, g, n2, q_out, scratch + s.pol, I, q, n_power, loop, fin, dead_tol,
                       st);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
