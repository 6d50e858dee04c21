// RG-LRU (RecurrentGemma / Griffin) fused gates and linear recurrence for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_pallas and
// computes what src/repro/kernels/ref.py::rglru_ref computes, per (b, c):
//   log_a_t = -8 softplus(lam[c]) sigmoid(r_t)          a_t = exp(log_a_t)
//   b_t     = sqrt(max(1 - exp(2 log_a_t), 1e-12)) sigmoid(i_t) x_t
//   h_t     = a_t h_{t-1} + b_t,  from h0 (or zeros)
// returning y = h in x's dtype and h_last in fp32.
//
// Design: a time-chunked scan whose carry stays on chip.  The recurrence
// composes: a span of steps acts on the h entering it as h -> A h + H, with
// A the product of its a and H its scan from h = 0, and two spans join as
// (A1 A2, A2 H1 + H2).  So the work splits over (b, channel tile, time):
//   * a thread owns 16 bytes of channels (8 bf16 or 4 fp32: one vector load
//     per step and input) and a sub-chunk of TS = 8 steps; a block is 8
//     such lanes by 16 sub-chunks (128 threads), a tile of 64 bf16 or 32
//     fp32 channels by CHUNK = 128 steps, so each step of a tile is one
//     128-byte row;
//   * the first walk loads the sub-chunk's x, r and i (24 vector loads in
//     flight per thread), computes the gates once, keeps a and b in shared
//     memory, and forms the sub-chunk's (A, H);
//   * the 16 sub-chunks' pairs scan in shared memory; across the blocks of
//     one time span the carry goes through a thread-block cluster of K <= 8
//     blocks (the portable size) along time: each block joins its
//     sub-chunks' pairs into its piece's (A, H) in its shared memory, and
//     after one cluster barrier every block reads all K pieces' pairs
//     through distributed shared memory (one thread per channel) and
//     applies them, in order, to the h entering the span;
//   * the second walk reruns h = fma(a, h, b) from that exact entering h,
//     in the plain version's order, from the a and b in shared memory, and
//     stores y: a sub-chunk's y differs from the sequential result only
//     through its entering h.  x, r and i are read from device memory once.
// Where S needs more than K pieces of CHUNK steps, the cluster walks time in
// rounds of K pieces.  Every block folds all K pieces onto the carry in the
// same order, so every block holds the same carry for the next round, bit
// for bit, with no second barrier; the pieces' pairs are double-buffered by
// round.  A cluster and not a decoupled look-back across blocks: the
// hardware schedules a cluster's blocks together, so no block spins on a
// block that has not started, and no workspace, flag reset or ticket counter
// is needed; the price is one cluster barrier per round.  S <= CHUNK
// launches without a cluster (K = 1): no carry, no cluster wait.  S <= TS
// (decode, the shortest prompts) takes rglru_step_kernel instead: one
// thread per (b, channel) walks the steps in registers, the same order with
// no shared memory, so a decode step costs what a launch costs.  h_last is
// the walk's h at step S - 1.  Every call is one launch.
// Any C and any S >= 1: a C that is not a multiple of the 16-byte lane, or
// a pointer that is not 16-byte aligned, takes masked scalar loads and
// stores (an instance of the kernel of its own, `VEC` false: a runtime
// branch in one instance spilled more and ran 2-10 % slower, PERF.md).
// Compiled without fast math, so exp, log1p, the division in sigmoid and the
// square root are the accurate (IEEE) ones, as in the plain version.
//
// Bound on this card.  For one RecurrentGemma-2B recurrent block and a
// 1024-token prompt (B=1, S=1024, C=2560, bf16) the function reads x, r and
// i (15.73 MB) and writes y (5.24 MB), plus lam and h_last (~20 KB): ~21 MB,
// 6.3 us at 3.35 TB/s.  Counted as ~20 fp32 operations per element it is far
// under that at the fp32 peak: bound by bytes.  The gates as written here
// (4 exp, 2 IEEE divisions, an IEEE square root) issue some 80 instructions
// per element (counted from the source), ~8 us over 132 SMs at this shape,
// and a block keeps its a and b (8 bytes an element, 64 KB) in shared
// memory, so 3 blocks (12 warps) share an SM:
// the first walk's issue rate, not the bytes, is what the kernel waits on.
// The grid is (K x C/64, B): 320 blocks at this shape, all resident at once.
// At decode (B=4, S=1) the data is ~0.17 MB and a launch's own latency is
// the floor.  Measured times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 8;               // 16-byte channel groups of a tile
constexpr int SUBS = 16;               // time sub-chunks of a block
constexpr int THREADS = LANES * SUBS;  // one thread per (lane, sub-chunk)
constexpr int TS = 8;                  // steps of a sub-chunk
constexpr int CHUNK = SUBS * TS;       // steps of a block's piece of one round
constexpr int MAX_CLUSTER = 8;         // blocks of a cluster along time (portable)
constexpr float GATE_C = 8.f;  // RecurrentGemma's c in a = exp(-c softplus(lam) sigmoid(r))

template <class T>
__host__ __device__ constexpr int cpt() { return 16 / (int)sizeof(T); }  // channels of one lane

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float neg_c_softplus(float l) {  // softplus as logaddexp(l, 0)
  return -GATE_C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
}

// the gates of one element, from nsp = -c softplus(lam)
__device__ __forceinline__ void gates(float nsp, float x, float r, float i, float& a, float& b) {
  const float log_a = nsp * sigmoid(r);
  a = expf(log_a);
  b = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (sigmoid(i) * x);
}

// 16 bytes of channels c0 .. c0+cpt-1 at element offset `off`: one vector
// load, or (VEC false) scalar loads of the first `nc`, zeros after
template <class T, bool VEC>
__device__ __forceinline__ uint4 load16(const T* __restrict__ p, size_t off, int nc) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p + off));
  } else if constexpr (sizeof(T) == 4) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = j < nc ? __float_as_uint(p[off + j]) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nc) w[j / 2] |= (uint32_t)__bfloat16_as_ushort(p[off + j]) << (16 * (j % 2));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <class T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[cpt<T>()]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 4) {
      f[q] = __uint_as_float(w[q]);
    } else {  // bf16 -> fp32 is exact: the high half of the word
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
}

template <class T, bool VEC>
__device__ __forceinline__ void store16(T* __restrict__ p, size_t off, const float (&f)[cpt<T>()],
                                        int nc) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(p + off) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nc) p[off + j] = f[j];
    }
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * q])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * q + 1])) << 16);
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(p + off) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < nc) p[off + j] = __ushort_as_bfloat16((unsigned short)(w[j / 2] >> (16 * (j % 2))));
    }
  }
}

// the cluster barrier in two halves: arrive once this block reads no more
// of the others' shared memory, wait before its own may go away
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// grid (K * tiles, B), K blocks of one tile form a cluster along time (none
// when K == 1); block rank q of tile `tile` owns piece rd * K + q of round rd.
// VEC: every row of x, r, i and y starts 16-byte aligned and C is a whole
// number of lanes, so each lane loads and stores 16-byte vectors
template <class T, bool VEC>
__global__ void __launch_bounds__(THREADS, 3)
    rglru_chunk_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ i, const float* __restrict__ lam,
                       const float* __restrict__ h0, T* __restrict__ y,
                       float* __restrict__ h_last, int S, int C, int K, int rounds) {
  constexpr int N = cpt<T>();
  constexpr int TILE = LANES * N;
  extern __shared__ float4 smem_ab[];  // a then b, [TS][N / 4][THREADS] float4 each
  __shared__ __align__(16) float sA[SUBS][TILE];    // each sub-chunk's (A, H)
  __shared__ __align__(16) float sH[SUBS][TILE];
  __shared__ __align__(16) float sAgg[2][2][TILE];  // this piece's (A, H), by round parity
  __shared__ float sCarry[TILE];                    // h entering the round's span
  __shared__ float sIn[TILE];                       // h entering this piece

  float4* sa4 = smem_ab;
  float4* sb4 = smem_ab + TS * (N / 4) * THREADS;
  const int tid = threadIdx.x;
  const int lane = tid % LANES, sub = tid / LANES;
  const int rank = blockIdx.x % K;
  const int tile0 = (blockIdx.x / K) * TILE;
  const int c0 = tile0 + lane * N;  // this thread's first channel
  const int nc = min(N, C - c0);    // its channels (none when <= 0)
  const int b = blockIdx.y;
  const size_t row0 = (size_t)b * S * C + c0;

  float nsp[N];  // -c softplus(lam)
#pragma unroll
  for (int j = 0; j < N; ++j) nsp[j] = neg_c_softplus(j < nc ? lam[c0 + j] : 0.f);
  // the span phase runs one thread per channel of the tile
  if (tid < TILE) sCarry[tid] = (h0 != nullptr && tile0 + tid < C) ? h0[(size_t)b * C + tile0 + tid] : 0.f;

  for (int rd = 0; rd < rounds; ++rd) {
    const int t0 = (rd * K + rank) * CHUNK + sub * TS;  // first step of the sub-chunk
    const int n = nc > 0 ? max(0, min(TS, S - t0)) : 0;
    uint4 xv[TS], rv[TS], iv[TS];
#pragma unroll
    for (int k = 0; k < TS; ++k) {
      if (k < n) {
        const size_t off = row0 + (size_t)(t0 + k) * C;
        xv[k] = load16<T, VEC>(x, off, nc);
        rv[k] = load16<T, VEC>(r, off, nc);
        iv[k] = load16<T, VEC>(i, off, nc);
      }
    }

    // first walk: the gates once, and the sub-chunk's (A, H) from h = 0; a
    // and b go to shared memory as float4 rows [TS][N / 4][THREADS]
    float A[N], H[N];
#pragma unroll
    for (int j = 0; j < N; ++j) A[j] = 1.f, H[j] = 0.f;
    auto first = [&](int k) {
      float xf[N], rf[N], gf[N], av[N], bv[N];
      unpack<T>(xv[k], xf);
      unpack<T>(rv[k], rf);
      unpack<T>(iv[k], gf);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        gates(nsp[j], xf[j], rf[j], gf[j], av[j], bv[j]);
        A[j] *= av[j];
        H[j] = fmaf(av[j], H[j], bv[j]);
      }
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        sa4[(k * (N / 4) + q) * THREADS + tid] = make_float4(av[4 * q], av[4 * q + 1], av[4 * q + 2], av[4 * q + 3]);
        sb4[(k * (N / 4) + q) * THREADS + tid] = make_float4(bv[4 * q], bv[4 * q + 1], bv[4 * q + 2], bv[4 * q + 3]);
      }
    };
#pragma unroll
    for (int k = 0; k < TS; ++k)
      if (k < n) first(k);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sA[sub][lane * N + j] = A[j];
      sH[sub][lane * N + j] = H[j];
    }
    __syncthreads();

    // the h entering this block's piece
    if (K > 1) {
      if (tid < TILE) {  // the piece's (A, H): its sub-chunks joined in order
        float Ab = 1.f, Hb = 0.f;
        for (int q = 0; q < SUBS; ++q) {
          const float aq = sA[q][tid];
          Hb = fmaf(aq, Hb, sH[q][tid]);
          Ab *= aq;
        }
        sAgg[rd & 1][0][tid] = Ab;
        sAgg[rd & 1][1][tid] = Hb;
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (tid < TILE) {  // the span's pieces, read from the cluster, applied in order
        float pa[MAX_CLUSTER], ph[MAX_CLUSTER];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
          if (q < K) {
            pa[q] = *cluster.map_shared_rank(&sAgg[rd & 1][0][tid], q);
            ph[q] = *cluster.map_shared_rank(&sAgg[rd & 1][1][tid], q);
          }
        }
        float hc = sCarry[tid];
#pragma unroll
        for (int q = 0; q < MAX_CLUSTER; ++q) {
          if (q < K) {
            if (q == rank) sIn[tid] = hc;
            hc = fmaf(pa[q], hc, ph[q]);
          }
        }
        sCarry[tid] = hc;
      }
      if (rd + 1 == rounds) cluster_arrive();
    } else if (tid < TILE) {
      sIn[tid] = sCarry[tid];
    }
    __syncthreads();

    // the h entering this sub-chunk, then the second walk in the plain order
    float h[N];
#pragma unroll
    for (int j = 0; j < N; ++j) h[j] = sIn[lane * N + j];
    for (int q = 0; q < sub; ++q) {
#pragma unroll
      for (int j = 0; j < N; ++j) h[j] = fmaf(sA[q][lane * N + j], h[j], sH[q][lane * N + j]);
    }
    auto second = [&](int k) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 a4 = sa4[(k * (N / 4) + q) * THREADS + tid];
        const float4 b4 = sb4[(k * (N / 4) + q) * THREADS + tid];
        h[4 * q] = fmaf(a4.x, h[4 * q], b4.x);
        h[4 * q + 1] = fmaf(a4.y, h[4 * q + 1], b4.y);
        h[4 * q + 2] = fmaf(a4.z, h[4 * q + 2], b4.z);
        h[4 * q + 3] = fmaf(a4.w, h[4 * q + 3], b4.w);
      }
      store16<T, VEC>(y, row0 + (size_t)(t0 + k) * C, h, nc);
    };
#pragma unroll
    for (int k = 0; k < TS; ++k)
      if (k < n) second(k);
    if (n > 0 && t0 + n == S) {  // this thread holds step S - 1
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < nc) h_last[(size_t)b * C + c0 + j] = h[j];
    }
    if (rd + 1 < rounds) __syncthreads();  // sA, sH and sIn are rewritten next round
  }
  if (K > 1) cluster_wait();
}

constexpr int STEP_THREADS = 128;  // channels of a block of the step kernel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// S <= TS (decode, the shortest prompts): one thread per (b, channel) walks
// the steps with h in a register, in the plain order, as the chunked kernel's
// one sub-chunk would from h0; no shared memory, no carry.  Grid
// (C / STEP_THREADS, B).
template <class T>
__global__ void __launch_bounds__(STEP_THREADS)
    rglru_step_kernel(const T* __restrict__ x, const T* __restrict__ r,
                      const T* __restrict__ i, const float* __restrict__ lam,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ h_last, int S, int C) {
  const int ch = blockIdx.x * STEP_THREADS + threadIdx.x;
  if (ch >= C) return;
  const int b = blockIdx.y;
  const float nsp = neg_c_softplus(lam[ch]);
  float h = h0 != nullptr ? h0[(size_t)b * C + ch] : 0.f;
  const size_t base = (size_t)b * S * C + ch;
  for (int t = 0; t < S; ++t) {
    const size_t off = base + (size_t)t * C;
    float a, bt;
    gates(nsp, to_f(x[off]), to_f(r[off]), to_f(i[off]), a, bt);
    h = fmaf(a, h, bt);
    put(y + off, h);
  }
  h_last[(size_t)b * C + ch] = h;
}

// the launch's kernel and tiling: the step kernel for S <= TS, else the
// chunked one with a cluster of K blocks along time and its rounds
struct Plan {
  int step, K, rounds, tile, grid_x, grid_y, threads, smem;
};

Plan plan(int elem_bytes, int B, int S, int C) {
  Plan p;
  const int pieces = (S + CHUNK - 1) / CHUNK;
  p.step = S <= TS;
  p.K = pieces < MAX_CLUSTER ? pieces : MAX_CLUSTER;
  p.rounds = (pieces + p.K - 1) / p.K;
  p.tile = p.step ? STEP_THREADS : LANES * (16 / elem_bytes);
  p.grid_x = p.K * ((C + p.tile - 1) / p.tile);
  p.grid_y = B;
  p.threads = p.step ? STEP_THREADS : THREADS;
  p.smem = p.step ? 0 : (int)(2 * sizeof(float) * TS * THREADS * (16 / elem_bytes));
  return p;
}

// the chunked kernel's launch, with a cluster of K blocks along time when K > 1
template <class T, bool VEC>
cudaError_t launch_chunked(const Plan& p, const T* x, const T* r, const T* i, const float* lam,
                           const float* h0, T* y, float* h_last, int S, int C,
                           cudaStream_t stream) {
  // once per device and instance: the dynamic shared memory above 48 KB, and
  // the carveout that lets three bf16 blocks share an SM
  static hopper::SmemOptIn allow_smem;
  auto kernel = rglru_chunk_kernel<T, VEC>;
  cudaError_t err = allow_smem((const void*)kernel, p.smem, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.grid_x, p.grid_y);
  if (p.K == 1) {
    rglru_chunk_kernel<T, VEC><<<grid, THREADS, p.smem, stream>>>(x, r, i, lam, h0, y, h_last, S, C, 1,
                                                                   p.rounds);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.K;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, r, i, lam, h0, y, h_last, S, C, p.K, p.rounds);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class T>
cudaError_t launch(const void* x, const void* r, const void* i, const void* lam,
                   const void* h0, void* y, void* h_last, int B, int S, int C,
                   cudaStream_t stream) {
  const Plan p = plan((int)sizeof(T), B, S, C);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* it = static_cast<const T*>(i);
  const float* lt = static_cast<const float*>(lam);
  const float* h0t = static_cast<const float*>(h0);
  T* yt = static_cast<T*>(y);
  float* hl = static_cast<float*>(h_last);
  if (p.step) {
    const dim3 grid(p.grid_x, p.grid_y);
    rglru_step_kernel<T><<<grid, STEP_THREADS, 0, stream>>>(xt, rt, it, lt, h0t, yt, hl, S, C);
    return cudaGetLastError();
  }
  if (C % cpt<T>() == 0 && aligned16(x) && aligned16(r) && aligned16(i) && aligned16(y))
    return launch_chunked<T, true>(p, xt, rt, it, lt, h0t, yt, hl, S, C, stream);
  return launch_chunked<T, false>(p, xt, rt, it, lt, h0t, yt, hl, S, C, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, r, i and y, all [B,S,C] contiguous).  lam
// [C], h0 [B,C] (may be null) and h_last [B,C] are fp32.  Launches once on
// `stream`, does not synchronise; returns the CUDA error of the launch (0 on
// success).
int rglru_scan_launch(int dtype, const void* x, const void* r, const void* i,
                      const void* lam, const void* h0, void* y, void* h_last, int B, int S,
                      int C, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, r, i, lam, h0, y, h_last, B, S, C, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, r, i, lam, h0, y, h_last, B, S, C, st);
  return (int)cudaErrorInvalidValue;
}

// The launch's kernel and tiling for dtype (0 fp32, 1 bf16) and [B,S,C],
// into out[10]: step kernel (1) or chunked (0), cluster size K, rounds, tile
// channels, grid x, grid y, threads, steps of a sub-chunk, steps of a
// block's piece, dynamic shared memory bytes.  Returns 0, or
// cudaErrorInvalidValue for what the launch refuses.
int rglru_scan_plan(int dtype, int B, int S, int C, int* out) {
  if (B < 1 || B > 65535 || S < 1 || C < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(dtype == 0 ? 4 : 2, B, S, C);
  const int v[10] = {p.step, p.K, p.rounds, p.tile, p.grid_x, p.grid_y, p.threads, TS, CHUNK, p.smem};
  for (int k = 0; k < 10; ++k) out[k] = v[k];
  return 0;
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
