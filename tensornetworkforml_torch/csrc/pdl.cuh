// Programmatic dependent launch (PDL) for a chain of kernels on one stream,
// as K7 (two_site_step.cu) runs its step (K2's six launches, K1's, and its
// own two) and K8 (polar_iterate.cu) its split (K5's tile launch and sum,
// then K1's).
//
// A kernel launched with launch(..., pdl = true) may start while its
// predecessor on the stream still runs: as soon as every block of the
// predecessor has called pdl::start(). Its blocks then sit resident in their
// own pdl::start() until the predecessor has completed and its memory writes
// are visible (griddepcontrol.wait waits for the whole predecessor grid, not
// for its trigger), so the launch and the blocks' ramp overlap the
// predecessor's run instead of following it.
//
// pdl::start() is the first statement of every kernel of the chain, in every
// block, before any read of a predecessor's output and before any write:
// kernel n + 1 then finishes after kernel n, so kernel n + 2, waiting for
// n + 1, also waits for n, and the first kernel of the next step waits for
// the last one of this step before it overwrites the scratch they share.
// Launched without the attribute (K1, K2, K4a, K4b and K5 alone), both
// instructions return at once: nothing is waited for and no dependent reacts.
#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace {
namespace pdl {

__device__ __forceinline__ void start() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// kernel<<<grid, block, smem, st>>>(args...), with the PDL attribute when pdl
template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                   bool pdl, A&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
}

}  // namespace pdl
}  // namespace
