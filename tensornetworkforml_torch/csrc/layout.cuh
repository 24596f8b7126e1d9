// The layout of a kernel chain's global scratch: every part starts on a
// 256-byte boundary (PART floats). K1's cluster form copies its whole-matrix
// mirrors of y, y^T and W in and out of its part by the TMA, and at 16-byte
// offsets those copies ran ~30 us a step slower inside K7 on an H100; the
// tensor-core tiles' partials (tc_gemm.cuh) and K2's operands (presplit.cuh)
// are read by 16-byte copies. The wrappers allocate the scratch with
// torch.empty, whose blocks start on 512-byte boundaries, so an offset of a
// multiple of PART floats is a 256-byte boundary. K7 (two_site_step.cu), K8
// (polar_iterate.cu) and K5 (tc_gemm.cuh) lay out their scratch with part().
#pragma once

namespace {

constexpr long PART = 64;

// n floats rounded up to a whole number of parts
inline long part(long n) { return (n + PART - 1) / PART * PART; }

}  // namespace
