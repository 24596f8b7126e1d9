// Microbenchmarks behind the design of K1's cluster form (csrc/polar_iterate.cuh),
// built and run by scripts/torch_k1_probe.py: how fast one CTA of a 16-CTA
// cluster can read data that other CTAs produced, by each route the kernel
// could take, and what a cluster barrier costs.
//
//   read_kernel   every CTA reads 128 KB from each other CTA in turn (CTA r
//                 starts at r + 1), `reps` times: mode 0 through distributed
//                 shared memory (generic loads of float4), mode 1 from L2
//                 (ld.global.cg float4), mode 2 from L2 by cp.async (16 bytes,
//                 32 KB batches, two in flight) into shared memory
//   tma_kernel    every CTA brings 64 KB into its shared memory by one TMA
//                 bulk copy, `reps` times, with a cluster barrier between:
//                 mode 0 the same 64 KB in every CTA, mode 1 a 64 KB of its
//                 own, mode 2 multicast (CTA r copies 1/16 of it to all)
//   sync_kernel   `reps` cluster barriers
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int N4 = 8192;       // float4s of a CTA's shared block: 128 KB
constexpr int TMA_BYTES = 65536;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void read_kernel(const float4* __restrict__ src, float* __restrict__ out, int reps,
                            int mode) {
  extern __shared__ float4 buf[];  // the own block, then (mode 2) a 64 KB stage
  cg::cluster_group cl = cg::this_cluster();
  const int r = cl.block_rank(), C = cl.num_blocks();
  for (int i = threadIdx.x; i < N4; i += blockDim.x) buf[i] = make_float4(i, r, 0, 1);
  cl.sync();
  float4 acc = make_float4(0, 0, 0, 0);
  for (int rep = 0; rep < reps; ++rep)
    for (int s = 1; s < C; ++s) {
      const int from = (r + s) % C;
      if (mode == 0) {
        const float4* p = cl.map_shared_rank(buf, from);
#pragma unroll 8
        for (int i = threadIdx.x; i < N4; i += blockDim.x) {
          const float4 v = p[i];
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
      } else if (mode == 1) {
        const float4* p = src + (size_t)from * N4;
#pragma unroll 8
        for (int i = threadIdx.x; i < N4; i += blockDim.x) {
          const float4 v = __ldcg(p + i);
          acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
        }
      } else {
        const float4* p = src + (size_t)from * N4;
        float4* stage = buf + N4;
        for (int b0 = 0; b0 < N4; b0 += 2048) {
          for (int i = threadIdx.x; i < 2048; i += blockDim.x)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                             smem_u32(stage + b0 % 4096 + i)),
                         "l"(p + b0 + i));
          asm volatile("cp.async.commit_group;\n" ::);
          asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        acc.x += stage[threadIdx.x].x;
      }
    }
  cl.sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}

__global__ void tma_kernel(const float* __restrict__ src, float* __restrict__ out, int reps,
                           int mode) {
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t bar = smem_u32(sm);
  unsigned char* buf = sm + 128;
  cg::cluster_group cl = cg::this_cluster();
  const int r = cl.block_rank(), C = cl.num_blocks();
  if (threadIdx.x == 0) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  cl.sync();
  float acc = 0.f;
  for (int it = 0; it < reps; ++it) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(TMA_BYTES)
                   : "memory");
      const unsigned char* from = reinterpret_cast<const unsigned char*>(src);
      if (mode == 2) {
        const int part = TMA_BYTES / C;
        const uint16_t mask = (uint16_t)((1u << C) - 1);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
            " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(buf + r * part)),
            "l"(from + r * part), "r"(part), "r"(bar), "h"(mask)
            : "memory");
      } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(buf)), "l"(from + (mode == 1 ? (size_t)r * TMA_BYTES : 0)),
            "r"(TMA_BYTES), "r"(bar)
            : "memory");
      }
    }
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"((uint32_t)(it & 1))
          : "memory");
    acc += reinterpret_cast<const float*>(buf)[threadIdx.x];
    cl.sync();  // every CTA has its copy before the next one overwrites it
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void sync_kernel(float* out, int reps) {
  for (int i = 0; i < reps; ++i) cg::this_cluster().sync();
  out[blockIdx.x] = 1.f;
}

template <class K, class... A>
int launch(K kern, int C, size_t smem, cudaStream_t st, A... a) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, a...);
}

}  // namespace

extern "C" {

// bytes each CTA reads in one read_bench call: reps * (C - 1) * 128 KB
int read_bench(const float4* src, float* out, int C, int reps, int mode, void* st) {
  return launch(read_kernel, C, (size_t)(N4 + (mode == 2 ? 4096 : 0)) * 16, (cudaStream_t)st,
                src, out, reps, mode);
}

int tma_bench(const float* src, float* out, int C, int reps, int mode, void* st) {
  return launch(tma_kernel, C, (size_t)TMA_BYTES + 128, (cudaStream_t)st, src, out, reps, mode);
}

int sync_bench(float* out, int C, int reps, void* st) {
  return launch(sync_kernel, C, 0, (cudaStream_t)st, out, reps);
}

}  // extern "C"
