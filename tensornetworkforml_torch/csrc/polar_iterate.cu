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
// What bounds it on this card: not the bytes (y, g and Q are 0.5 MB at the
// flagship, 2 MB at I = 512, q = 256, and stay in L2) but the
// dependence chain. Every pass needs all of W before any column of the next
// y, so the work can spread only as wide as one pass allows, and every pass
// ends in a barrier. The TPU kernel held y, g and W in VMEM; here g alone
// (256 KiB at the flagship) exceeds a block's 227 KB of shared memory.
//
// Two forms, chosen from the shape alone (fits_cluster):
//  * the cluster form, for every shape where a CTA's output fits one pass over
//    k (I * nc <= 8192, nc = q / 16 rounded up to 4, 8 or 16) and its buffers
//    fit shared memory: q <= 256 up to I = 512, so the flagship (I = 256,
//    q = 128) and the hybrid step at M = 256 (I = 512, q = 256). ONE launch
//    of a 16-CTA cluster (a non-portable size, cudaLaunchKernelEx) of 288
//    threads: 256 consumers and one producer warp. CTA r owns the column
//    block [r nc, (r + 1) nc) of y, W and P in its shared memory, and copies
//    its columns of y (as y and as y^T, two buffers) and of W into whole
//    matrices in global scratch, which stay in L2. Per pass:
//      W[:, own] = y^T y[:, own]       chunks of rows of y
//                                          -> cluster barrier (W complete)
//      P[:, own] = a I + b W[:, own] + c W W[:, own]
//                                      chunks of rows of W (W is symmetric bit
//                                      for bit, so its rows are its columns)
//      y'[:, own] = y P[:, own]        chunks of rows of y^T, P local
//                                          -> cluster barrier (y' complete)
//    A chunk (up to 64 KB) is one TMA bulk copy (cp.async.bulk) into one of
//    two stage buffers: the producer waits for a buffer's empty mbarrier,
//    the consumers for its full one, so a chunk is in flight while the other
//    is multiplied and the consumers never meet per chunk. Each consumer
//    holds an 8 x 4 tile of the CTA's output; where the output is small (the
//    flagship's W is 128 x 8 a CTA) up to 8 thread groups split each chunk's
//    k range, and all consumers add the groups' tiles in group order. Each
//    chunk's terms are summed apart and then added (blocked summation): one
//    FMA chain over 512 terms left rounding in the near-null directions of
//    rank-deficient steps that the final schedule lifted to unit columns.
//    g y reads g (read once a launch) through registers, transposed, and only
//    the own columns of y, so it needs no barrier; colnorm and the prescale
//    need one cluster-wide max each, through one slot per CTA in distributed
//    shared memory. A barrier.cluster arrive.release / wait.acquire, after a
//    proxy fence, orders the global writes before the TMA reads them.
//    On an H100 (scripts/torch_k1_probe.py bandwidth) a CTA reads 20-26 GB/s
//    through distributed shared memory at cluster sizes 2 to 16 and 52-81
//    GB/s from L2 by cp.async, so the shared operands go through L2, and by
//    the TMA, whose copies a producer warp issues off the consumers' path.
//  * the streaming form, for the shapes past that (I = 768, q = 384: the
//    hybrid split at M = 384): ONE launch of one 8-CTA cluster; CTA r owns a
//    column block of y, W and P held in global scratch (L2), two barriers a
//    pass after a memory fence, shared values read back with ld.global.cg;
//    operands stream from L2 in chunks through a register-prefetched tile
//    (tile_gemm.cuh), with each product's k range split over two thread
//    groups. Each chunk waits on an L2 round trip, which bounds this form.
// In both, every cross-CTA sum runs in one fixed order, so all CTAs agree bit
// for bit and repeat launches are bit-identical; W is symmetric bit for bit
// (W[i,j] and W[j,i] are the same FMA sequence); no float atomics; products
// are full float32 FMAs. The device code is in polar_iterate.cuh, which K7
// (two_site_step.cu) shares.
//
// This library also holds the all-in-one polar split (kernel K8), which
// replaces the Pallas kernel _polar_split_kernel behind polar_split_pallas in
// the same file. From the two-site matrix B (I, J) and the sketch Omega (J, q)
// it computes y = B Omega, G = B B^T and n2 = |B|_F^2 (accumulated, not tr G),
// then the iteration above with that n2: one C entry, a chain of three
// launches on one stream with no host work between. The first stage is K5's
// call (tc_gemm.cuh: y and G's upper triangle of 128 x 128 tiles, mirrored,
// on the tensor cores in 3xTF32, then the fixed-order sum of the k split's
// partials), the second K1's launch. The sum and K1's launch are programmatic
// dependent launches (pdl.cuh), as in K7: each becomes resident while its
// predecessor runs and waits in its first statement for it to complete. Every
// part of the scratch starts on a 256-byte boundary (layout.cuh), so K1's
// TMA copies meet its mirrors as they do when K1 runs alone. The order of
// every sum is K5's and K1's own, so Q is polar_split_two_stage's bit for
// bit wherever both draw the same Omega. It sits here, not in a source of
// its own, because its device code is exactly K5's and K1's, and a library of
// its own would compile K1's two kernels once more. The Pallas kernel's
// J-tiling, its 2 MB block cap and its 128-column padding were Mosaic
// workarounds: only the padded length at which the caller draws Omega is
// semantics, and the caller hands over its first J rows. R = Q^T B is a plain
// product outside the kernel, as in the JAX package. At the flagship two-site
// shape (I = 256, J = 2560, q = 128, n_power = 1) its reductions are ~3.4e8
// FLOP (one triangle of G) and the iteration 4.3e8, against ~3 MB of traffic.

#include <cuda_runtime.h>

#include "layout.cuh"
#include "polar_iterate.cuh"
#include "tc_gemm.cuh"

namespace {

// The scratch of one K8 split, offsets in floats, each part on a 256-byte
// boundary (layout.cuh): y (I, q), G (I, I), n2, K5's scratch (its own parts
// aligned too), the iteration's scratch.
struct SplitLayout {
  long y, g, n2, part, pol, floats;
};

SplitLayout split_layout(int I, int J, int q) {
  SplitLayout s;
  long o = 0;
  s.y = o; o += part((long)I * q);
  s.g = o; o += part((long)I * I);
  s.n2 = o; o += part(1);
  s.part = o; o += part(tc::sketch_gram_scratch_floats(I, J, q));
  s.pol = o; o += part(polar::scratch_floats(I, q));
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

// 1 when an (I, q) launch runs the cluster form, 0 for the streaming form
int tnml_polar_cluster(int I, int q) { return polar::fits_cluster(I, q) ? 1 : 0; }

// K8
long tnml_polar_split_scratch_floats(int I, int J, int q) {
  return split_layout(I, J, q).floats;
}

// K8's scratch layout at (I, J, q), offsets in floats into `out` (8 slots): y,
// G, n2, K5's partial sums of squares, its partial tiles of y and of G, K1's
// scratch, and the total; returns the number of slots written
int tnml_polar_split_layout(int I, int J, int q, long* out) {
  const SplitLayout s = split_layout(I, J, q);
  const tc::SketchGramLayout k5 = tc::sketch_gram_layout(I, J, q);
  const long slots[8] = {s.y, s.g, s.n2, s.part + k5.n2p, s.part + k5.yp, s.part + k5.gp,
                         s.pol, s.floats};
  for (int i = 0; i < 8; ++i) out[i] = slots[i];
  return 8;
}

int tnml_polar_split(const float* b, const float* om, float* q_out, float* scratch, int I, int J,
                     int q, int n_power, const Coeffs* loop, const Coeffs* fin, float dead_tol,
                     void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const SplitLayout s = split_layout(I, J, q);
  float *y = scratch + s.y, *g = scratch + s.g, *n2 = scratch + s.n2;
  // The chain: the tile launch, the fixed-order sum, K1's launch; the last two
  // are programmatic dependent launches of their predecessors (pdl.cuh). The
  // first is not: its predecessor on the stream is PyTorch's work (the
  // caller's, or the last split's R = Q^T B), whose kernels do not trigger
  // their dependents early, so the attribute could start it no sooner (with
  // it, the call read within noise on an H100); without it the stream's order
  // alone keeps it from writing the scratch before all queued work is done.
  const int err = tc::sketch_gram(b, om, y, g, n2, scratch + s.part, I, J, q, st, true);
  if (err != 0) return err;
  return polar::launch(y, g, n2, q_out, scratch + s.pol, I, q, n_power, loop, fin, dead_tol,
                       st, true);
}

const char* tnml_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
