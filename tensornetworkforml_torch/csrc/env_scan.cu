// Fused psi-embedding + right-to-left MPS chain contraction (serving forward), K3.
//
// Replaces tensornetworkforml_tpu/ops/kernels/env_scan.py::_right_env_kernel
// (right_env_chain_pallas). Given sites (n, M, 2, M) and raw pixels x (B, n),
// it returns the right environment of the whole chain, (B, M):
//
//     v <- e0;  for site = n-1 .. 0:  v'[l] = s(x) A[l,0,:] v + c(x) A[l,1,:] v
//
// with (s, c) = (sin(pi x / 2), cos(pi x / 2)) of the sample's pixel at that
// site. Each sample keeps two sums a row, one per half of A's row, and scales
// them by s and c once they are complete. Full float32 FMAs: no TF32, no
// float atomics; every sum runs in a fixed order, so repeats give the same bits.
//
// What bounds it on an H100. 4 n B M^2 FLOP (3.3e9 at the flagship N=196,
// M=128, B=256: 49 us at 67 TFLOP/s) and the site stack (n M 2M floats,
// 25.6 MB, which fits the 50 MB L2). The sites form a chain of n dependent
// products, so at serving batches the time is n times the latency of one
// site: its products, a barrier, and A's slice from L2 (each batch tile
// reads the whole stack, so a call moves B / BT stacks through L2). At bulk
// batches it is the FMA rate.
//
// Two forms, chosen from (M, B) and the card's SM layout alone (plan()):
//  * The latency form (serving batches). A tile of 8 samples is spread over a
//    thread-block cluster of C = 1..4 CTAs: CTA r owns rows [r Mc, (r+1) Mc)
//    of every site, Mc = ceil(M / C), and keeps the whole env v (M x 8) in
//    shared memory. A warp owns 4 rows by 8 samples and splits each row's 2M
//    terms over its 32 lanes (a 4-column quad of each half a lane), so a
//    site's products need no wait on other warps; the lanes' sums meet in a
//    butterfly that leaves one output on each lane, and four lanes' outputs
//    go as one float4 into every CTA's next v through distributed shared
//    memory. One cluster barrier ends the site. Each element of A meets one
//    lane, so A goes from L2 straight into registers, the next chunk's while
//    this chunk's epilogue and barrier run. C is the cluster size whose
//    clusters fit the card in the fewest waves (cudaOccupancyMaxActiveClusters:
//    an H100 holds 30 clusters of 4 and 39 of 3, so B=256's 32 tiles run on
//    clusters of 3 CTAs of 12 warps, 43 rows a CTA in one pass).
//  * The throughput form (bulk batches: B / 64 tiles fill at least half the
//    SMs). One CTA owns 64 samples and all M rows; each thread keeps 8 rows x
//    4 samples of both halves' sums in registers (256 FMAs for every 20
//    16-byte shared loads). 16 lanes share each row of A, so A streams
//    through a ring of up to 4 chunks of 128 rows x 2 x 32 columns in shared
//    memory, filled by cp.async; 64 samples a tile read the stack B / 64
//    times from L2.
//  * Any M (rows and columns past M are zero-filled and never stored) and
//    any B (a ragged last tile runs on x = 0 and is not stored). 16-byte
//    loads where M % 4 == 0 and the stack is 16-byte aligned, else 4-byte.
//
// The stack form (tnml_right_env_stack, the training sweep's prologue). The
// same chain, but it keeps every intermediate env: given sites (n, M, 2, M)
// and the embedded inputs phi (n, B, 2) it writes out (n + 1, B, M), out[n]
// the one-hot boundary and out[k] the chain from site k to n - 1 closed on
// it, as contractions.py::right_env_stack_fused computes it. It replaces no
// Pallas kernel: the JAX package computes these stale right environments by
// an XLA scan (two einsums a site), which the port ran as 195 host-bound
// einsum steps a sweep. Its bound is the serial chain's latency a site, as
// the serving forms' is; at the flagship (n = 196, M = 128, B = 256) 3.3e9
// FLOP and 51 MB (the site stack read, the env stack written). It differs
// from the serving forms in three ways only: the two scalars of a sample at
// a site are read, not computed from a pixel (sin and cos are the caller's);
// after each site every lane also stores its output of that site's env into
// out[k] (the env stays in shared memory for the next site as before); the
// final (B, M) store is left out, since out[0] is stored by the last site.
// It is a separate instantiation (stack_kernel) of the same walk, on the
// same plan(), so serving's chain_kernel instantiations keep their code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "tile_gemm.cuh"  // cp_async16, cp_async4, cp_async_commit, cp_async_wait

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_STAGES = 4;          // the throughput form's ring: chunks of A in flight
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into
// more than half an SM's shared memory: a latency-form CTA takes at least this
// much, so that each CTA of a cluster has its SM to itself
constexpr size_t ONE_CTA_AN_SM = SMEM_LIMIT / 2 + 1024;
constexpr int LATENCY = 0, THROUGHPUT = 1;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch's shape plan, the same on the host and in every CTA.
struct Plan {
  int form, C, BT;  // form, CTAs of a cluster, samples of a batch tile
  int NW;           // warps of a CTA
  int RP, KC, SR;   // rows of a pass, columns of a chunk (each half), floats a ring row
  int stages;       // ring stages of the throughput form (0: none)
  int fits;         // the buffers fit a CTA's shared memory
  int Mc, P, NC;    // rows of a CTA, passes over them, chunks of a pass
  int Mv;           // rows of each env buffer (M rounded up to KC; the rest stays zero)
  int stage_floats, v_floats;
  size_t smem;
};

Plan make_plan(int form, int C, int BT, int M) {
  Plan L = {};
  L.form = form;
  L.C = C;
  L.BT = BT;
  L.NW = form == LATENCY && C == 3 ? 12 : 8;
  if (form == LATENCY) {
    L.RP = 4 * L.NW;               // warps of 4 rows x 8 samples
    L.KC = 128;                    // one 4-column quad per lane
  } else {
    L.RP = 128;  // 8 warps of 16 rows, 8 rows a thread
    L.KC = 32;
    L.SR = 2 * L.KC + 4;  // padded: a warp's two rows fall in other banks
  }
  L.Mc = cdiv(M, C);
  L.P = cdiv(L.Mc, L.RP);
  L.NC = cdiv(M, L.KC);
  L.Mv = L.NC * L.KC;
  L.v_floats = L.Mv * BT;
  const size_t fixed = sizeof(float) * (size_t(2) * L.v_floats + size_t(6) * BT);
  if (form == LATENCY) {  // no ring: A goes from L2 into registers
    L.smem = fixed > ONE_CTA_AN_SM ? fixed : ONE_CTA_AN_SM;
    L.fits = fixed <= SMEM_LIMIT;
  } else {
    L.stage_floats = L.RP * L.SR;
    for (int s = MAX_STAGES; s >= 2 && L.stages == 0; --s) {
      const size_t bytes = fixed + sizeof(float) * size_t(s) * L.stage_floats;
      if (bytes <= SMEM_LIMIT) {
        L.stages = s;
        L.smem = bytes;
        L.fits = 1;
      }
    }
  }
  return L;
}

// The form for (M, B) on a card with `sms` SMs that holds at most cap[C]
// clusters of C CTAs at once (cap[1] = sms). The throughput form once its
// 64-sample tiles fill half the SMs (B > 4160 on an H100) and its buffers fit;
// else the latency form on 8-sample tiles, on the cluster of 1 to 4 CTAs
// whose walk costs least: waves of clusters x passes a CTA x rows a pass (the
// clusters of 3 run 12 warps, so that 43 rows at M=128 take one pass). Ties go
// to the smaller cluster.
Plan plan(int M, int B, int sms, const int* cap) {
  if (2 * cdiv(B, 64) >= sms) {
    const Plan t = make_plan(THROUGHPUT, 1, 64, M);
    if (t.fits) return t;
  }
  Plan best = make_plan(LATENCY, 1, 8, M);
  long best_cost = -1;
  for (int C = 1; C <= 4; ++C) {
    const Plan L = make_plan(LATENCY, C, 8, M);
    const long cost = long(cdiv(cdiv(B, 8), cap[C])) * L.P * L.RP;
    if (L.fits && (best_cost < 0 || cost < best_cost)) {
      best = L;
      best_cost = cost;
    }
  }
  return best;
}

// ---- device pieces shared by both forms ---------------------------------------

struct Args {
  const float* sites;
  const float* x;
  float* out;
  int ldx, n, M, B;
  int vec;  // 16-byte loads and copies of A
};

// One chunk of A into a stage of the throughput form's ring, as
// stage[row][half][col]: rows [row0, row0 + RP) and columns [col0, col0 + KC)
// of each half of the site at A. Rows past r1 and columns past M are
// zero-filled. In 16-byte copies thread tid always takes the same quad q,
// half h and rows r + i * RSTEP of a chunk, so its addresses move by constant
// strides.
template <int NT, int RP, int KC, int SR>
__device__ __forceinline__ void fill(float* st, const float* A, const Args& a, int row0, int r1,
                                     int col0) {
  const int K2 = 2 * a.M;
  if (a.vec) {
    constexpr int QC = KC / 4, RSTEP = NT / (2 * QC), NE = RP / RSTEP;
    static_assert(NT % (2 * QC) == 0 && RP % RSTEP == 0, "copy map");
    const int q = threadIdx.x % QC, h = (threadIdx.x / QC) & 1, r = threadIdx.x / (2 * QC);
    const int col = col0 + 4 * q;
    const float* src = A + (row0 + r) * K2 + h * a.M + col;
    float* dst = st + r * SR + h * KC + 4 * q;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const bool ok = row0 + r + i * RSTEP < r1 && col < a.M;
      cp_async16(dst + i * RSTEP * SR, ok ? src + i * RSTEP * K2 : a.sites, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < RP * 2 * KC; e += NT) {
      const int q = e % KC, h = (e / KC) & 1, r = e / (2 * KC);
      const bool ok = row0 + r < r1 && col0 + q < a.M;
      cp_async4(st + r * SR + h * KC + q, ok ? A + (row0 + r) * K2 + h * a.M + col0 + q : a.sites,
                ok ? 4 : 0);
    }
  }
}

// leaves at most stages - 2 of this thread's copy groups in flight
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages >= 4) {
    cp_async_wait<2>();
  } else if (stages == 3) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

template <int C>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <int C>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (C > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// this thread's sample's (sin, cos)(pi x / 2) into a (sin, cos) row
__device__ __forceinline__ void psi(float* sc, int BT, float xv) {
  float s, c;
  sincospif(0.5f * xv, &s, &c);
  sc[threadIdx.x] = s;
  sc[BT + threadIdx.x] = c;
}

__device__ __forceinline__ float x_at(const Args& a, int b, int site) {
  return b < a.B && site >= 0 ? __ldg(a.x + size_t(b) * a.ldx + site) : 0.f;
}

// a sample's input at a site: its raw pixel (serving), or its two embedded
// scalars (the stack form: x is phi (n, B, 2)); zero past B and before site 0
template <bool Stack>
__device__ __forceinline__ auto input_at(const Args& a, int b, int site) {
  if constexpr (Stack) {
    if (b >= a.B || site < 0) return make_float2(0.f, 0.f);
    const float* p = a.x + (size_t(site) * a.B + b) * 2;
    return make_float2(__ldg(p), __ldg(p + 1));
  } else {
    return x_at(a, b, site);
  }
}

// this thread's sample's (sin, cos) into a (sin, cos) row: from its pixel,
// or as given
__device__ __forceinline__ void feed(float* sc, int BT, float xv) { psi(sc, BT, xv); }

__device__ __forceinline__ void feed(float* sc, int BT, float2 p) {
  sc[threadIdx.x] = p.x;
  sc[BT + threadIdx.x] = p.y;
}

// ---- the latency form ------------------------------------------------------------

// one level of a butterfly reduce-scatter: lanes whose bit H is set keep the
// upper H of their 2H values, the others the lower H, each summed with the
// partner lane's copy
template <int H>
__device__ __forceinline__ void fold(float (&val)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? val[i] : val[i + H];
    const float keep = up ? val[i + H] : val[i];
    val[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

template <int C_, int NW = 8>
struct Latency {
  static constexpr int C = C_, BT = 8, NT = 32 * NW, RP = 4 * NW, KC = 128;
  static constexpr bool RING = false;  // A goes from L2 straight into registers

  // env element (k, b): 4-sample planes split by k % 4, so that the 32 lanes'
  // quads k = 4 lane + j of one plane are 32 consecutive float4
  __device__ __forceinline__ static int vaddr(int k, int b, int Mv) {
    return ((b >> 2) * 4 + (k & 3)) * Mv + (k >> 2) * 4 + (b & 3);
  }

  struct Acc {
    float h0[4][8], h1[4][8];  // 4 rows x 8 samples, one sum for each half of A
  };

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.h0[i][j] = acc.h1[i][j] = 0.f;
  }

  // A's fragments of one lane: rows 4 warp + i of the pass, its quad of columns
  // of each half. At BT = 8 each element of A meets one lane, so it goes from
  // L2 into registers with no stop in shared memory.
  struct Frag {
    float4 a0[4], a1[4];
  };

  // the lane's fragments of the chunk at rows row0.. (< r1), columns col0.. of
  // each half of the site at A; zero past r1 and past M
  __device__ __forceinline__ static void load(Frag& f, const float* A, const Args& a, int row0,
                                              int r1, int col0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int col = col0 + 4 * lane, K2 = 2 * a.M;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + warp * 4 + i;
      const float* p0 = A + row * K2 + col;
      if (a.vec) {
        const bool ok = row < r1 && col < a.M;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        f.a0[i] = ok ? __ldcg(reinterpret_cast<const float4*>(p0)) : z;
        f.a1[i] = ok ? __ldcg(reinterpret_cast<const float4*>(p0 + a.M)) : z;
      } else {
        float e0[4], e1[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = row < r1 && col + t < a.M;
          e0[t] = ok ? __ldcg(p0 + t) : 0.f;
          e1[t] = ok ? __ldcg(p0 + a.M + t) : 0.f;
        }
        f.a0[i] = make_float4(e0[0], e0[1], e0[2], e0[3]);
        f.a1[i] = make_float4(e1[0], e1[1], e1[2], e1[3]);
      }
    }
  }

  // the lane's quad of columns [c KC + 4 lane, +4) of each half, all 8 samples
  __device__ __forceinline__ static void chunk(Acc& acc, const Frag& f, const float* v, int c,
                                               int Mv) {
    const int kq = c * (KC / 4) + (threadIdx.x & 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 lo = *reinterpret_cast<const float4*>(v + j * Mv + kq * 4);
      const float4 hi = *reinterpret_cast<const float4*>(v + (4 + j) * Mv + kq * 4);
      const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q0 = f.a0[i], q1 = f.a1[i];
        const float x0 = j == 0 ? q0.x : j == 1 ? q0.y : j == 2 ? q0.z : q0.w;
        const float x1 = j == 0 ? q1.x : j == 1 ? q1.y : j == 2 ? q1.z : q1.w;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          acc.h0[i][b] = fmaf(x0, w[b], acc.h0[i][b]);
          acc.h1[i][b] = fmaf(x1, w[b], acc.h1[i][b]);
        }
      }
    }
  }

  // the pass's rows row0.. (< r1) of the next env, scaled by this site's
  // (s, c), stored into every CTA of the cluster; in the stack form also into
  // the site's slot of the output (the tile's nb samples, rows M apart)
  template <bool Stack = false>
  __device__ __forceinline__ static void epilogue(Acc& acc, const float* sc, float* vnext,
                                                  int row0, int r1, int Mv, float* slot = nullptr,
                                                  int nb = 0, int M = 0) {
    const int lane = threadIdx.x & 31;
    float val[32];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const float s = sc[b], c = sc[BT + b];
#pragma unroll
      for (int i = 0; i < 4; ++i) val[i * 8 + b] = s * acc.h0[i][b] + c * acc.h1[i][b];
    }
    // butterfly reduce-scatter over the lanes: lane g ends with the sum of value g
    fold<16>(val, lane);
    fold<8>(val, lane);
    fold<4>(val, lane);
    fold<2>(val, lane);
    fold<1>(val, lane);
    // lanes 4i..4i+3 hold 4 consecutive samples of one row: lane 4i stores them
    // as one float4 into every CTA of the cluster
    const float4 out = make_float4(val[0], __shfl_down_sync(0xffffffffu, val[0], 1),
                                   __shfl_down_sync(0xffffffffu, val[0], 2),
                                   __shfl_down_sync(0xffffffffu, val[0], 3));
    const int row = row0 + (threadIdx.x >> 5) * 4 + (lane >> 3);
    if constexpr (Stack) {  // lane g holds row g / 8 of the warp's 4, sample g % 8
      if (row < r1 && (lane & 7) < nb) slot[size_t(lane & 7) * M + row] = val[0];
    }
    if ((lane & 3) == 0 && row < r1) {
      float4* dst = reinterpret_cast<float4*>(vnext + vaddr(row, lane & 7, Mv));
      if constexpr (C > 1) {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int q = 0; q < C; ++q) *cl.map_shared_rank(dst, q) = out;
      } else {
        *dst = out;
      }
    }
  }
};

// ---- the throughput form -----------------------------------------------------------

struct Throughput {
  static constexpr int C = 1, BT = 64, NT = 256, RP = 128, KC = 32, SR = 2 * KC + 4;
  static constexpr bool RING = true;  // A streams through shared memory: 16 lanes share a row
  struct Frag {};

  __device__ __forceinline__ static int vaddr(int k, int b, int) { return k * BT + b; }

  struct Acc {
    float h0[8][4], h1[8][4];  // 8 rows x 4 samples, one sum for each half of A
  };

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.h0[i][j] = acc.h1[i][j] = 0.f;
  }

  // rows 16 warp + 2 i + lane / 16 (i < 8) of the pass, samples 4 (lane % 16)..
  __device__ __forceinline__ static int row_of(int i) {
    return (threadIdx.x >> 5) * 16 + 2 * i + ((threadIdx.x & 31) >> 4);
  }

  __device__ __forceinline__ static void chunk(Acc& acc, const float* st, const float* v, int c,
                                               int) {
    const int bc = (threadIdx.x & 15) * 4;
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const int k = c * KC + 4 * q;
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(v + (k + j) * BT + bc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a0 = *reinterpret_cast<const float4*>(st + row_of(i) * SR + 4 * q);
        const float4 a1 = *reinterpret_cast<const float4*>(st + row_of(i) * SR + KC + 4 * q);
        const float x0[4] = {a0.x, a0.y, a0.z, a0.w}, x1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc.h0[i][0] = fmaf(x0[j], w[j].x, acc.h0[i][0]);
          acc.h0[i][1] = fmaf(x0[j], w[j].y, acc.h0[i][1]);
          acc.h0[i][2] = fmaf(x0[j], w[j].z, acc.h0[i][2]);
          acc.h0[i][3] = fmaf(x0[j], w[j].w, acc.h0[i][3]);
          acc.h1[i][0] = fmaf(x1[j], w[j].x, acc.h1[i][0]);
          acc.h1[i][1] = fmaf(x1[j], w[j].y, acc.h1[i][1]);
          acc.h1[i][2] = fmaf(x1[j], w[j].z, acc.h1[i][2]);
          acc.h1[i][3] = fmaf(x1[j], w[j].w, acc.h1[i][3]);
        }
      }
    }
  }

  template <bool Stack = false>
  __device__ __forceinline__ static void epilogue(Acc& acc, const float* sc, float* vnext,
                                                  int row0, int r1, int, float* slot = nullptr,
                                                  int nb = 0, int M = 0) {
    const int bc = (threadIdx.x & 15) * 4;
    const float4 s = *reinterpret_cast<const float4*>(sc + bc);
    const float4 c = *reinterpret_cast<const float4*>(sc + BT + bc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + row_of(i);
      if (row < r1) {
        const float4 o = make_float4(s.x * acc.h0[i][0] + c.x * acc.h1[i][0],
                                     s.y * acc.h0[i][1] + c.y * acc.h1[i][1],
                                     s.z * acc.h0[i][2] + c.z * acc.h1[i][2],
                                     s.w * acc.h0[i][3] + c.w * acc.h1[i][3]);
        *reinterpret_cast<float4*>(vnext + row * BT + bc) = o;
        if constexpr (Stack) {  // the thread's 4 samples of the row, M apart
          const float e[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (bc + j < nb) slot[size_t(bc + j) * M + row] = e[j];
        }
      }
    }
  }
};

// ---- the chain, both forms -------------------------------------------------------------

// A batch tile's walk over the sites: site step t (site n-1-t), pass p over
// this CTA's rows, column chunk c. A producer cursor runs ahead of the
// consumer: in the throughput form it names the chunk that the ring copies
// stages - 1 chunks ahead; in the latency form the chunk whose fragments each
// lane loads while the current one's epilogue and barrier run. Shared memory:
// the ring (throughput form), two env buffers (the current site's and the
// next's) and three (sin, cos) rows (a site's is written one site ahead).
// Stack: the stack form (out is the (n + 1, B, M) env stack, x the embedded
// inputs), else the serving forms (out is the final env, x raw pixels).
template <class F, bool Stack>
__device__ __forceinline__ void walk(const Args& a, const Plan& L) {
  extern __shared__ __align__(16) float sm[];
  constexpr int C = F::C, BT = F::BT, NT = F::NT, RP = F::RP, KC = F::KC;
  int rank = 0;
  if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
  const int b0 = (blockIdx.x / C) * BT;
  const int r0 = min(rank * L.Mc, a.M), r1 = min(r0 + L.Mc, a.M);
  const int S = L.stages, P = L.P, NC = L.NC;
  const size_t site_floats = size_t(a.M) * 2 * a.M;
  float* ring = sm;
  float* vbuf = ring + S * L.stage_floats;
  float* sc = vbuf + 2 * L.v_floats;  // [3][2][BT]

  for (int i = threadIdx.x; i < 2 * L.v_floats; i += NT) vbuf[i] = 0.f;
  // this thread's sample's input at the site after the next
  decltype(input_at<Stack>(a, 0, 0)) xr = {};
  if (threadIdx.x < BT) {
    feed(sc, BT, input_at<Stack>(a, b0 + threadIdx.x, a.n - 1));
    xr = input_at<Stack>(a, b0 + threadIdx.x, a.n - 2);
  }
  if constexpr (Stack) {  // out[n]: the boundary e0, this CTA's rows of the tile
    float* top = a.out + (size_t(a.n) * a.B + b0) * a.M;
    const int rows = r1 - r0;
    for (int e = threadIdx.x; e < BT * rows; e += NT) {
      const int b = e / rows, l = r0 + e % rows;
      if (b0 + b < a.B) top[size_t(b) * a.M + l] = l == 0 ? 1.f : 0.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < BT) vbuf[F::vaddr(0, threadIdx.x, L.Mv)] = 1.f;  // e0

  // the producer cursor: the next chunk to fetch (site step pt, pass pp,
  // chunk pc, at site pA), and in the ring the stage it goes to
  int pt = 0, pp = 0, pc = 0, ps = 0;
  const float* pA = a.sites + site_floats * (a.n - 1);
  auto advance = [&]() {
    if (++pc == NC) {
      pc = 0;
      if (++pp == P) {
        pp = 0;
        ++pt;
        pA -= site_floats;
      }
    }
  };
  [[maybe_unused]] auto copy_ahead = [&]() {
    if constexpr (F::RING) {
      if (pt < a.n) {
        fill<NT, RP, KC, F::SR>(ring + ps * L.stage_floats, pA, a, r0 + pp * RP, r1, pc * KC);
        advance();
      }
      cp_async_commit();
      ps = ps + 1 == S ? 0 : ps + 1;
    }
  };
  typename F::Frag frag;  // the latency form's fragments of the next chunk
  if constexpr (F::RING) {
    for (int i = 0; i < S - 1; ++i) copy_ahead();
  } else {
    F::load(frag, pA, a, r0, r1, 0);
    advance();
  }

  typename F::Acc acc;
  int stage = 0;  // the ring stage of the chunk being multiplied
  for (int t = 0; t < a.n; ++t) {
    const float* v = vbuf + (t & 1) * L.v_floats;
    float* vnext = vbuf + ((t + 1) & 1) * L.v_floats;
    for (int p = 0; p < P; ++p) {
      for (int c = 0; c < NC; ++c) {
        if constexpr (F::RING) wait_ring(S);  // this thread's copies of this chunk landed
        if (p == 0 && c == 0) {
          // a site begins: the last site's env is complete in every CTA of
          // the cluster; the sin and cos of the next site go out meanwhile
          cluster_arrive<C>();
          if (threadIdx.x < BT && t + 1 < a.n) {
            feed(sc + ((t + 1) % 3) * 2 * BT, BT, xr);
            xr = input_at<Stack>(a, b0 + threadIdx.x, a.n - 3 - t);
          }
          __syncwarp();
          cluster_wait<C>();
        } else if constexpr (F::RING) {
          __syncthreads();
        }
        if (c == 0) F::zero(acc);
        if constexpr (F::RING) {
          copy_ahead();  // into the stage of the last chunk, which every thread is done with
          F::chunk(acc, ring + stage * L.stage_floats, v, c, L.Mv);
          stage = stage + 1 == S ? 0 : stage + 1;
        } else {
          F::chunk(acc, frag, v, c, L.Mv);
          if (pt < a.n) {  // the next chunk's fragments, in flight through the epilogue
            F::load(frag, pA, a, r0 + pp * RP, r1, pc * KC);
            advance();
          }
        }
        if (c == NC - 1) {
          if constexpr (Stack) {  // out[n-1-t]: this site's env, the tile's rows
            float* slot = a.out + (size_t(a.n - 1 - t) * a.B + b0) * a.M;
            F::template epilogue<true>(acc, sc + (t % 3) * 2 * BT, vnext, r0 + p * RP, r1, L.Mv,
                                       slot, a.B - b0, a.M);
          } else {
            F::epilogue(acc, sc + (t % 3) * 2 * BT, vnext, r0 + p * RP, r1, L.Mv);
          }
        }
      }
    }
  }
  if constexpr (F::RING) cp_async_wait<0>();
  // every CTA's last rows are in; after this no CTA touches another's memory
  cluster_arrive<C>();
  cluster_wait<C>();
  if constexpr (!Stack) {
    const float* v = vbuf + (a.n & 1) * L.v_floats;
    const int rows = r1 - r0;
    for (int e = threadIdx.x; e < BT * rows; e += NT) {
      const int b = e / rows, l = r0 + e % rows;
      if (b0 + b < a.B) a.out[size_t(b0 + b) * a.M + l] = v[F::vaddr(l, b, L.Mv)];
    }
  }
}

// serving: the final env (B, M) from raw pixels
template <class F>
__global__ void __launch_bounds__(F::NT, 1) chain_kernel(const Args a, const Plan L) {
  walk<F, false>(a, L);
}

// the training sweep's prologue: the env stack (n + 1, B, M) from embedded inputs
template <class F>
__global__ void __launch_bounds__(F::NT, 1) stack_kernel(const Args a, const Plan L) {
  walk<F, true>(a, L);
}

template <class F, bool Stack>
cudaError_t launch(const Args& a, const Plan& L, cudaStream_t stream) {
  void (*const kernel)(const Args, const Plan) = Stack ? stack_kernel<F> : chain_kernel<F>;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(SMEM_LIMIT));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(a.B, F::BT) * F::C);
  cfg.blockDim = dim3(F::NT);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = F::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = F::C > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the instantiated forms: the throughput form (C = 1, BT = 64) and the latency
// form on clusters of C = 1..4 (BT = 8; the clusters of 3 run 12 warps), each
// as a serving chain and as a stack
template <bool Stack>
cudaError_t dispatch(const Args& a, const Plan& L, cudaStream_t s) {
  if (!L.fits) return cudaErrorInvalidValue;
  if (L.form == THROUGHPUT) return L.C == 1 && L.BT == 64 ? launch<Throughput, Stack>(a, L, s)
                                                          : cudaErrorInvalidValue;
  if (L.BT != 8) return cudaErrorInvalidValue;
  switch (L.C) {
    case 1: return launch<Latency<1>, Stack>(a, L, s);
    case 2: return launch<Latency<2>, Stack>(a, L, s);
    case 3: return launch<Latency<3, 12>, Stack>(a, L, s);
    case 4: return launch<Latency<4>, Stack>(a, L, s);
    default: return cudaErrorInvalidValue;
  }
}

// The clusters of C CTAs (1 to 4) that the current card holds at once, at one
// latency-form CTA an SM, read once per device with
// cudaOccupancyMaxActiveClusters.
template <class F>
cudaError_t capacity(int* n) {
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_LIMIT));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(F::C * 64);
  cfg.blockDim = dim3(F::NT);
  cfg.dynamicSmemBytes = ONE_CTA_AN_SM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = F::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, chain_kernel<F>, &cfg);
}

struct Card {
  int sms;
  int cap[5];  // cap[C]: clusters of C CTAs held at once; cap[1] = sms
};

cudaError_t card(Card* out) {
  static Card cards[64];
  static bool known[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev]) {
    *out = cards[dev];
    return cudaSuccess;
  }
  Card c = {};
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = capacity<Latency<2>>(&c.cap[2]);
  if (err == cudaSuccess) err = capacity<Latency<3, 12>>(&c.cap[3]);
  if (err == cudaSuccess) err = capacity<Latency<4>>(&c.cap[4]);
  if (err != cudaSuccess) return err;
  c.cap[0] = c.cap[1] = c.sms;
  if (dev < 64) {
    cards[dev] = c;
    known[dev] = true;
  }
  *out = c;
  return cudaSuccess;
}

template <bool Stack>
int run(const Plan& L, const float* sites, const float* x, int ldx, float* out, int n, int M,
        int B, void* stream) {
  if (n < 1 || M < 1 || B < 1 || ldx < n) return cudaErrorInvalidValue;
  Args a = {sites, x, out, ldx, n, M, B,
            M % 4 == 0 && reinterpret_cast<uintptr_t>(sites) % 16 == 0};
  return dispatch<Stack>(a, L, static_cast<cudaStream_t>(stream));
}

}  // namespace

// sites: (n, M, 2, M) f32 contiguous; x: (B, n) f32 with row stride ldx;
// out: (B, M) f32 contiguous. Launches the form plan() picks on `stream`;
// returns a cudaError_t.
extern "C" int tnml_right_env_chain(const float* sites, const float* x, int ldx, float* out,
                                    int n, int M, int B, void* stream) {
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return err;
  return run<false>(plan(M, B, c.sms, c.cap), sites, x, ldx, out, n, M, B, stream);
}

// The stack form: sites (n, M, 2, M) f32 contiguous; phi (n, B, 2) f32
// contiguous, the embedded inputs; out (n + 1, B, M) f32 contiguous, every
// right environment of the chain, out[n] the one-hot boundary. Launches the
// form plan() picks on `stream`; returns a cudaError_t.
extern "C" int tnml_right_env_stack(const float* sites, const float* phi, float* out, int n,
                                    int M, int B, void* stream) {
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return err;
  return run<true>(plan(M, B, c.sms, c.cap), sites, phi, n, out, n, M, B, stream);
}

// The same chain in a given form (form 0 latency, 1 throughput; C CTAs a
// cluster, BT samples a tile), for probes that time the candidates; an
// uninstantiated (form, C, BT) or a shape whose buffers do not fit gives
// cudaErrorInvalidValue.
extern "C" int tnml_right_env_chain_as(int form, int C, int BT, const float* sites,
                                       const float* x, int ldx, float* out, int n, int M, int B,
                                       void* stream) {
  return run<false>(make_plan(form, C, BT, M), sites, x, ldx, out, n, M, B, stream);
}

// The current card: out = {SMs, clusters of 2, 3 and 4 CTAs it holds at once};
// returns a cudaError_t.
extern "C" int tnml_env_scan_card(int* out) {
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return err;
  out[0] = c.sms;
  for (int C = 2; C <= 4; ++C) out[C - 1] = c.cap[C];
  return cudaSuccess;
}

// The plan tnml_right_env_chain launches for (M, B) on the current device:
// out = {form, C, BT, ring stages, shared-memory bytes, fits}; returns a
// cudaError_t.
extern "C" int tnml_env_scan_plan(int M, int B, int* out) {
  Card c;
  const cudaError_t err = card(&c);
  if (err != cudaSuccess) return err;
  const Plan L = plan(M, B, c.sms, c.cap);
  out[0] = L.form;
  out[1] = L.C;
  out[2] = L.BT;
  out[3] = L.stages;
  out[4] = static_cast<int>(L.smem);
  out[5] = L.fits;
  return cudaSuccess;
}

extern "C" const char* tnml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
