// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_pallas and
// computes what src/repro/kernels/ref.py::ssd_ref computes, per (b, h) and
// chunk of L rows:
//   cum_i    = cumsum over the chunk of dt_i * A,   A = -exp(A_log[h])
//   y_i      = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra-chunk)
//            + exp(cum_i) C_i . state_entering                         (inter-chunk)
//            + D[h] x_i                                                (skip)
//   state'   = state exp(cum_last) + sum_j x_j dt_j exp(cum_last - cum_j) B_j^T
// with state0 applied to y and to the final state, as ssd_ref does.
// Built for P = 64 (head_dim) and N = 128 (d_state), chunks of up to 256.
//
// Two designs, picked by dtype.  This is dispatch by type, not a fallback:
// bf16 always runs the tensor-core passes and fp32 the CUDA-core kernel.
//
// bf16: three passes on the warpgroup tensor-core products, launched one
// after the other on the caller's stream by ssd_scan_launch.  The TPU walks
// the chunks in a sequential grid dimension with the state in VMEM; here
// the chunks of one (b, h) run in parallel, and only the [P, N] state
// recurrence, a few FMAs per element and chunk, stays sequential.  The
// workspace (cum, the chunks' states, the entering states; one allocation,
// laid out by ssd_scan_workspace_bytes) comes from the caller.  Each pass is one warpgroup (128 threads) per block.
//   1. ssd_scan_chunk_kernel, per (chunk, h, b): the cumsum of dt*A over the
//      chunk (to the workspace), w_j = dt_j exp(cum_L - cum_j), and the
//      chunk's own state  sum_j (x_j w_j) B_j^T  [P, N] as an m64n64k16
//      product per 64-column block of B (M = P, K = the chunk's rows), A in
//      registers built from the x slice and w, B MN-major from a swizzled
//      64-row B slice.  The chunk goes by in 64-row slices.
//   2. ssd_scan_state_kernel, per (p, n) element: state_{c+1} = state_c
//      exp(cum_L,c) + chunk_state_c from state0 or zeros, in fp32; writes
//      the state entering each chunk and the final state.
//   3. ssd_scan_output_kernel, per (64-row tile of a chunk, h, b): the
//      flash-attention kernel's loop with C for Q, B for K, x for V and a
//      decay mask in place of the softmax.  The entering state comes in
//      through the two B stages of the ring, acc = C . state^T (m64n64k16,
//      8 k-steps, both K-major), scaled by exp(cum_i) per row (<= 1);
//      then for each 64-row source tile at or below the diagonal, S = C .
//      B_j^T (m64n64k16, both K-major), W = S exp(cum_i - cum_j) dt_j on the
//      accumulator (per element: exp(cum_i) exp(-cum_j) overflows fp32 once
//      cum falls below -88, which Mamba2's dt reaches inside one chunk;
//      only the diagonal tile is masked to j <= i), and acc += W x_j in the
//      register-A form with x_j MN-major.  The D skip goes on at the store.
//      Shared memory: C 16 KB, a two-stage ring of (B 16 KB, x 8 KB), cum
//      and dt 2 KB: 67 KB, so three blocks fit on an SM.
//   Precision.  The products take bf16 operands.  C, B and x are bf16
//   already; x*w, the entering state and W are fp32, and one bf16 copy of
//   any of them misses the element-wise bf16 limit (2e-2) against ssd_ref
//   at Mamba2's widths (measured on the CPU with the Python mirror of these
//   passes, tests/torch_ssd_phases.py).  So each goes in as a bf16 high part
//   plus a bf16 low part (two products, error ~2^-17 relative): twice the
//   tensor-core work of those products, which the bound does not count.
//   Rows past the chunk's end (a ragged chunk, e.g. 100 rows) load as zeros
//   with dt = 0, so cum stays flat there, and are never stored.
//
// fp32: ssd_scan_kernel, the first design on the CUDA cores.  Tensor cores
// would take fp32 as TF32 (10-bit mantissas), too coarse for the fp32
// limit the card checks hold (1e-4).  One block owns one (b, h) and loops
// over the chunks itself, carrying the [P,N] fp32 state (32 KB) in shared
// memory.  The LxL matrix (C B^T) * decay * dt of a 256-row chunk is 256 KB
// in fp32, more than a block's 227 KB, so it is produced and consumed in
// 64x64 tiles: for each 64-row output tile, the 64-row source tiles at or
// below the diagonal are multiplied in, then the inter-chunk term.  The
// state update rides on the last row tile, which visits every source tile;
// its sum lives in registers until the inter-chunk term of that tile has
// read the entering state.  Shared memory: state 32 KB, C and B tiles
// transposed to [N][64+4] (35 KB each), x tile 16 KB, W tile 17 KB,
// per-step cumsum/dt/weights 3 KB: ~136 KB.  Each thread computes 4x4
// outputs from float4 shared-memory reads with fp32 FMAs.
//
// Bound on this card.  For one Mamba2-1.3B layer and a 1024-token prompt
// (B=1, H=64, P=64, G=1, N=128, chunk 256, bf16) the function moves ~19.7
// MB (5.9 us at 3.35 TB/s) and, counting only the causal triangle of the
// LxL intra-chunk products, does ~5.4 GFLOP (5.4 us at the 989 TFLOP/s bf16
// tensor-core peak): bound by bytes, barely.  The bf16 passes add the
// workspace's traffic (the chunks' states in fp32 and the entering states
// as bf16 pairs, 8 MB each at S=1024, mostly through L2) and the low parts'
// products; the fp32 kernel runs at the 67 TFLOP/s of the CUDA cores and
// fills under half of the 132 SMs at batch 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>

#include "wgmma.cuh"

namespace {

constexpr int P = 64;        // head_dim
constexpr int N = 128;       // d_state
constexpr int MAXL = 256;    // longest chunk

// ---------------------------------------------------------------------------
// bf16: three passes on the warpgroup tensor-core products
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // rows of a tile (output pass) or slice (chunk pass)
constexpr int THREADS = 128;  // one warpgroup
constexpr int XLD = P + 8;    // padded row of the chunk pass's x slice (no bank conflicts)
constexpr int TILE_BN = TILE * N * 2;  // bytes of a 64 x 128 bf16 tile (B, C, a state part)
constexpr int TILE_XP = TILE * P * 2;  // bytes of a 64 x 64 bf16 x tile
constexpr int STATE_THREADS = 256;

// dynamic shared memory, plus 1 KB to align the base to the swizzle pattern
constexpr size_t CHUNK_SMEM = TILE_BN + TILE * XLD * 2 + 2 * MAXL * 4 + 1024;
constexpr size_t OUT_SMEM = TILE_BN + 2 * (TILE_BN + TILE_XP) + 2 * MAXL * 4 + 1024;

__host__ __device__ constexpr int tiles(int L) { return (L + TILE - 1) / TILE; }

// The workspace's parts at 256-byte boundaries: cum [B,H,S] fp32, the
// chunks' own states [B,H,nc,P,N] fp32 and the states entering the chunks
// [B,H,nc,2,P,N] bf16 (high and low parts); `bytes` in all.
struct Workspace {
  size_t cum, states, entering, bytes;
};
inline size_t round256(size_t n) { return (n + 255) / 256 * 256; }
inline Workspace workspace(int B, int S, int H, int L) {
  const size_t bh = (size_t)B * H, nc = S / L;
  Workspace w;
  w.cum = 0;
  w.states = round256(bh * S * sizeof(float));
  w.entering = w.states + round256(bh * nc * P * N * sizeof(float));
  w.bytes = w.entering + bh * nc * 2 * P * N * sizeof(bf16);
  return w;
}

// rows [row0, row0 + 64) of a bf16 slab whose row r starts at src + r *
// stride, CH 16-byte chunks a row, into a swizzled 64-row tile at shared
// address `dst`; rows at or past `limit` come in as zeros
template <int CH>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* __restrict__ src, size_t stride,
                                          int row0, int limit) {
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    const bool in = row < limit;
    cp_async16(dst + swizzled(TILE, r, c), src + (size_t)(in ? row : 0) * stride + c * 8, in ? 16 : 0);
  }
}

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// (hi, lo): the bf16 high and low parts of (a, b), packed as two bf16 pairs
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf(a), b - bf(b));
}

// Pass 1: the cumsum of dt*A over chunk c of (b, h), to cum_out [B,H,S],
// and the chunk's own state sum_j (x_j w_j) B_j^T to chunk_state [B,H,nc,P,N].
__global__ void __launch_bounds__(THREADS)
    ssd_scan_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A_log, const bf16* __restrict__ Bm,
                          float* __restrict__ cum_out, float* __restrict__ chunk_state, int S,
                          int H, int G, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Bs = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (Bs - raw);
  const bf16* xs = reinterpret_cast<const bf16*>(base + TILE_BN);  // [TILE][XLD]
  float* cum = reinterpret_cast<float*>(base + TILE_BN + TILE * XLD * 2);
  float* w = cum + MAXL;
  __shared__ float wsum[THREADS / 32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = S / L;
  const int g = h / (H / G), s0 = c * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const float A = -expf(A_log[h]);

  // inclusive cumsum of dt*A: thread k owns steps 2k and 2k+1 (dt = 0 past L)
  const int k0 = 2 * tid;
  const float d0 = k0 < L ? dt[((size_t)b * S + s0 + k0) * H + h] : 0.f;
  const float d1 = k0 + 1 < L ? dt[((size_t)b * S + s0 + k0 + 1) * H + h] : 0.f;
  const float a0 = d0 * A, a1 = d1 * A;
  float run = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += v;
  }
  if (lane == 31) wsum[warp] = run;
  __syncthreads();
  for (int wi = 0; wi < warp; ++wi) run += wsum[wi];
  const float c0 = run - a1;  // cum at step 2k
  cum[k0] = c0;
  cum[k0 + 1] = run;
  __syncthreads();
  const float cL = cum[L - 1];
  w[k0] = d0 * expf(cL - c0);
  w[k0 + 1] = d1 * expf(cL - run);
  float* cum_row = cum_out + ((size_t)b * H + h) * S + s0;
  if (k0 < L) cum_row[k0] = c0;
  if (k0 + 1 < L) cum_row[k0 + 1] = run;

  float acc[64];  // [P=64] x [N=128] as two m64n64 accumulators
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const bf16* xc = x + (((size_t)b * S + s0) * H + h) * P;  // row stride H*P
  const bf16* bc = Bm + (((size_t)b * S + s0) * G + g) * N;  // row stride G*N
  for (int r0 = 0; r0 < L; r0 += TILE) {
    __syncthreads();  // w is written; the last slice's reads of Bs and xs are done
    load_rows<N / 8>(Bs, bc, (size_t)G * N, r0, L);
    for (int idx = tid; idx < TILE * (P / 8); idx += THREADS) {
      const int r = idx / (P / 8), cc = idx % (P / 8), row = r0 + r;
      const bool in = row < L;
      cp_async16(Bs + TILE_BN + (uint32_t)(r * XLD * 2 + cc * 16),
                 xc + (size_t)(in ? row : 0) * H * P + cc * 8, in ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();

    // A = (x w)^T [p][j] in the register-A fragment: k-step kk, register r
    // holds row p = 16 warp + gq + 8 (r & 1), columns j = 16 kk + 8 (r >> 1)
    // + 2 t4 and the next one
    uint32_t ahi[16], alo[16];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * warp + gq + 8 * (r & 1), j = 16 * kk + 8 * (r >> 1) + 2 * t4;
        const float f0 = __bfloat162float(xs[j * XLD + p]) * w[r0 + j];
        const float f1 = __bfloat162float(xs[(j + 1) * XLD + p]) * w[r0 + j + 1];
        split2(f0, f1, ahi[4 * kk + r], alo[4 * kk + r]);
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(ahi[i]), pin(alo[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const uint64_t db = desc(Bs + nb * TILE * ROW + kk * 16 * ROW, 1024, 1024);
        wgmma_rs<64>(acc + 32 * nb, ahi + 4 * kk, db);
        wgmma_rs<64>(acc + 32 * nb, alo + 4 * kk, db);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(ahi[i]), pin(alo[i]);
  }

  float* out = chunk_state + (((size_t)b * H + h) * nc + c) * P * N;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 16 * warp + gq + 8 * e, n = 64 * nb + 8 * j + 2 * t4;
        const int i = 32 * nb + 4 * j + 2 * e;
        *reinterpret_cast<float2*>(out + p * N + n) = make_float2(acc[i], acc[i + 1]);
      }
}

// Pass 2: per (p, n) element of (b, h), the state entering each chunk, as
// bf16 high and low parts to entering [B,H,nc,2,P,N], and the final state.
__global__ void __launch_bounds__(STATE_THREADS)
    ssd_scan_state_kernel(const float* __restrict__ chunk_state, const float* __restrict__ cum,
                          const float* __restrict__ state0, bf16* __restrict__ entering,
                          float* __restrict__ final_state, int S, int H, int L) {
  const int h = blockIdx.y, b = blockIdx.z, nc = S / L;
  const int e = blockIdx.x * STATE_THREADS + threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  float st = state0 ? state0[bh * P * N + e] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const bf16 hi = __float2bfloat16(st);
    bf16* ent = entering + (bh * nc + c) * 2 * P * N;
    ent[e] = hi;
    ent[P * N + e] = __float2bfloat16(st - __bfloat162float(hi));
    st = st * expf(cum[bh * S + (size_t)c * L + L - 1]) + chunk_state[(bh * nc + c) * P * N + e];
  }
  final_state[bh * P * N + e] = st;
}

// Pass 3: rows [i0, i0 + 64) of chunk c of (b, h): the inter-chunk term from
// the entering state, the intra-chunk term over the source tiles at or
// below the diagonal, and the D skip.  `has_state0` = 0: chunk 0 enters
// with zeros, and its inter-chunk term is skipped.
__global__ void __launch_bounds__(THREADS, 3)
    ssd_scan_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                           const float* __restrict__ Dv, const float* __restrict__ cum,
                           const bf16* __restrict__ entering, int has_state0,
                           bf16* __restrict__ y, int S, int H, int G, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Cs = (raw + 1023) & ~1023u;
  const uint32_t Bst = Cs + TILE_BN;          // two stages of B (and the entering state)
  const uint32_t Xst = Bst + 2 * TILE_BN;     // two stages of x
  float* cum_s = reinterpret_cast<float*>(smem_raw + (Xst + 2 * TILE_XP - raw));
  float* dt_s = cum_s + MAXL;

  const int nt = tiles(L), nc = S / L;
  const int c = blockIdx.x / nt, it = nt - 1 - blockIdx.x % nt;  // the longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), s0 = c * L, i0 = it * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const size_t bh = (size_t)b * H + h;
  const bf16* xc = x + (((size_t)b * S + s0) * H + h) * P;  // row stride H*P
  const bf16* bc = Bm + (((size_t)b * S + s0) * G + g) * N;  // row stride G*N
  const bf16* cc = Cm + (((size_t)b * S + s0) * G + g) * N;
  const bool inter = has_state0 || c > 0;

  // group: the C tile and, when the chunk enters with a state, its high and
  // low parts in the two B stages
  load_rows<N / 8>(Cs, cc, (size_t)G * N, i0, L);
  if (inter) {
    const bf16* ent = entering + (bh * nc + c) * 2 * P * N;
    load_rows<N / 8>(Bst, ent, N, 0, P);
    load_rows<N / 8>(Bst + TILE_BN, ent + P * N, N, 0, P);
  }
  cp_async_commit();
  // cum and dt of the chunk; past its end dt = 0 and cum stays flat
  for (int j = tid; j < MAXL; j += THREADS) {
    const int jj = j < L ? j : L - 1;
    cum_s[j] = cum[bh * S + s0 + jj];
    dt_s[j] = j < L ? dt[((size_t)b * S + s0 + j) * H + h] : 0.f;
  }
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();

  // this thread's rows in the chunk: e = 0 is row gq of its warp, e = 1 row gq + 8
  int row[2];
  float ecum[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    row[e] = i0 + 16 * warp + gq + 8 * e;
    ecum[e] = cum_s[row[e]];
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (inter) {
    // acc = exp(cum_i) C_i . (hi + lo)^T
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint32_t kb = (kk / 4) * TILE * ROW + (kk % 4) * 32;
        wgmma_ss_n64(acc, desc(Cs + kb, 16, 1024), desc(Bst + part * TILE_BN + kb, 16, 1024),
                     part > 0 || kk > 0);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
    const float sc[2] = {expf(ecum[0]), expf(ecum[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= sc[(i >> 1) & 1];
  }
  __syncthreads();  // every warp is done with the state in the B stages

  // the source tiles 0..it, two stages ahead by one
  load_rows<N / 8>(Bst, bc, (size_t)G * N, 0, L);
  load_rows<P / 8>(Xst, xc, (size_t)H * P, 0, L);
  cp_async_commit();
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  for (int jt = 0; jt <= it; ++jt) {
    const int stage = jt & 1;
    // tile jt has landed, and every warp is done with the stage tile jt + 1 goes into
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    if (jt < it) {
      load_rows<N / 8>(Bst + (stage ^ 1) * TILE_BN, bc, (size_t)G * N, (jt + 1) * TILE, L);
      load_rows<P / 8>(Xst + (stage ^ 1) * TILE_XP, xc, (size_t)H * P, (jt + 1) * TILE, L);
    }
    cp_async_commit();
    const uint32_t Bj = Bst + stage * TILE_BN, Xj = Xst + stage * TILE_XP;

    // S = C_i . B_j^T
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t kb = (kk / 4) * TILE * ROW + (kk % 4) * 32;
      wgmma_ss_n64(s, desc(Cs + kb, 16, 1024), desc(Bj + kb, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);

    // W = S exp(cum_i - cum_j) dt_j, j <= i on the diagonal tile; high and
    // low bf16 parts, packed as the A fragments of four k16 steps
    const int j0 = jt * TILE;
    const bool diag = jt == it;
    uint32_t whi[16], wlo[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1, j = j0 + 8 * (i >> 2) + 2 * t4;
      const float w0 = !diag || j <= row[e] ? s[i] * expf(ecum[e] - cum_s[j]) * dt_s[j] : 0.f;
      const float w1 = !diag || j + 1 <= row[e] ? s[i + 1] * expf(ecum[e] - cum_s[j + 1]) * dt_s[j + 1] : 0.f;
      split2(w0, w1, whi[i / 2], wlo[i / 2]);
    }

    // acc += W x_j
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(whi[i]), pin(wlo[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      const uint64_t dx = desc(Xj + kk * 16 * ROW, 1024, 1024);
      wgmma_rs<64>(acc, whi + 4 * kk, dx);
      wgmma_rs<64>(acc, wlo + 4 * kk, dx);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(whi[i]), pin(wlo[i]);
  }

  // y = acc + D x, rows before the chunk's end only
  const float Dh = Dv[h];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (row[e] >= L) continue;
    const bf16* xr = xc + (size_t)row[e] * H * P;
    bf16* yr = y + (((size_t)b * S + s0 + row[e]) * H + h) * P;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const int p = 8 * j + 2 * t4, i = 4 * j + 2 * e;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + p));
      *reinterpret_cast<__nv_bfloat162*>(yr + p) =
          __floats2bfloat162_rn(acc[i] + Dh * xv.x, acc[i + 1] + Dh * xv.y);
    }
  }
}

cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, const void* D, const void* state0, void* y, void* final_state,
                   void* ws, int B, int S, int H, int G, int L, cudaStream_t stream) {
  static SmemOptIn allow_smem;
  cudaError_t err = allow_smem((const void*)ssd_scan_output_kernel, OUT_SMEM);
  if (err != cudaSuccess) return err;
  const int nc = S / L;
  const Workspace w = workspace(B, S, H, L);
  char* base = static_cast<char*>(ws);
  void* cum = base + w.cum;
  void* chunk_states = base + w.states;
  void* entering = base + w.entering;
  ssd_scan_chunk_kernel<<<dim3(nc, H, B), THREADS, CHUNK_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A_log),
      static_cast<const bf16*>(Bm), static_cast<float*>(cum), static_cast<float*>(chunk_states), S,
      H, G, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_state_kernel<<<dim3(P * N / STATE_THREADS, H, B), STATE_THREADS, 0, stream>>>(
      static_cast<const float*>(chunk_states), static_cast<const float*>(cum),
      static_cast<const float*>(state0), static_cast<bf16*>(entering),
      static_cast<float*>(final_state), S, H, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_scan_output_kernel<<<dim3(nc * tiles(L), H, B), THREADS, OUT_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(D), static_cast<const float*>(cum),
      static_cast<const bf16*>(entering), state0 != nullptr, static_cast<bf16*>(y), S, H, G, L);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int T = 64;        // rows per tile
constexpr int TP = T + 4;    // padded stride of the transposed tiles (float4-aligned)
constexpr int THREADS = 256; // one thread per chunk step in the cumsum
static_assert(THREADS == MAXL, "the cumsum gives each thread one step");

constexpr int SMEM_FLOATS = N * P + 2 * N * TP + T * P + T * TP + 3 * MAXL;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// rows r0..r0+T-1 of a [rows][N] slab (row stride `rs`) into dst[N][TP], transposed;
// zeros past the chunk's end
__device__ __forceinline__ void load_bc(float* dst, const float* src, int rs, int r0, int L) {
  for (int idx = threadIdx.x; idx < T * N; idx += THREADS) {
    const int r = idx / N, n = idx % N, row = r0 + r;
    dst[n * TP + r] = row < L ? src[(size_t)row * rs + n] : 0.f;
  }
}

// rows r0..r0+T-1 of a [rows][P] slab (row stride `rs`) into dst[T][P]
__device__ __forceinline__ void load_x(float* dst, const float* src, int rs, int r0, int L) {
  for (int idx = threadIdx.x; idx < T * P; idx += THREADS) {
    const int r = idx / P, p = idx % P, row = r0 + r;
    dst[idx] = row < L ? src[(size_t)row * rs + p] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ state0, float* __restrict__ y,
                float* __restrict__ final_state, int S, int H, int G, int L) {
  extern __shared__ float4 smem4[];
  float* St = reinterpret_cast<float*>(smem4);  // state, [N][P]
  float* Ct = St + N * P;                        // C tile, [N][TP]
  float* Bt = Ct + N * TP;                       // B tile, [N][TP]
  float* Xs = Bt + N * TP;                       // x tile, [T][P]
  float* Wt = Xs + T * P;                        // masked C.B^T * decay * dt, [j][TP]
  float* cum = Wt + T * TP;                      // [MAXL] cumsum of dt*A
  float* dtv = cum + MAXL;                       // [MAXL] dt
  float* wv = dtv + MAXL;                        // [MAXL] dt * exp(cum_last - cum)

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float A = -expf(A_log[h]);
  const float Dh = Dv[h];
  const int nc = S / L, nt = (L + T - 1) / T;
  const size_t st_off = ((size_t)b * H + h) * P * N;

  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    St[n * P + p] = state0 ? state0[st_off + idx] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * L;
    const float* xc = x + (((size_t)b * S + s0) * H + h) * P;  // row stride H*P
    const float* bc = Bm + (((size_t)b * S + s0) * G + g) * N; // row stride G*N
    const float* cc = Cm + (((size_t)b * S + s0) * G + g) * N;
    float* yc = y + (((size_t)b * S + s0) * H + h) * P;

    // -- inclusive cumsum of dt*A over the chunk (zeros past its end) --------
    // in order, by one thread, as torch.cumsum adds along a dimension that is
    // not the innermost: y takes exp(cum_i - cum_j), so it carries cum's
    // rounding, and under a steep decay (cum near -3800 at dt ~ 1, where
    // one fp32 ulp is 2.4e-4) a sum in another order moves y past 1e-4
    const float d = tid < L ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.f;
    cum[tid] = d * A;
    dtv[tid] = d;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < MAXL; ++i) cum[i] = run += cum[i];
    }
    __syncthreads();
    const float cL = cum[L - 1];
    wv[tid] = d * expf(cL - cum[tid]);

    // the next state, summed in registers: thread owns n = ty*8+r, p = tx*4+q
    float s[8][4];
    {
      const float eL = expf(cL);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = ld4(&St[(ty * 8 + r) * P + tx * 4]);
        s[r][0] = v.x * eL; s[r][1] = v.y * eL; s[r][2] = v.z * eL; s[r][3] = v.w * eL;
      }
    }

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      const bool last = it == nt - 1;
      load_bc(Ct, cc, G * N, i0, L);
      float acc[4][4];
#pragma unroll
      for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a4][q] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        load_bc(Bt, bc, G * N, j0, L);
        load_x(Xs, xc, H * P, j0, L);
        __syncthreads();
        // W[i][j] = C_i . B_j for i = i0+ty*4+a4, j = j0+tx*4+k
        float w[4][4];
#pragma unroll
        for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
          for (int k = 0; k < 4; ++k) w[a4][k] = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          const float4 c4 = ld4(&Ct[n * TP + ty * 4]);
          const float4 b4 = ld4(&Bt[n * TP + tx * 4]);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
            for (int k = 0; k < 4; ++k) w[a4][k] = fmaf(cv[a4], bv[k], w[a4][k]);
        }
        // causal mask, decay exp(cum_i - cum_j) <= 1, dt_j; stored as Wt[j][i]
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx * 4 + k;
          const float cj = cum[j], dj = dtv[j];
          float o[4];
#pragma unroll
          for (int a4 = 0; a4 < 4; ++a4) {
            const int i = i0 + ty * 4 + a4;
            o[a4] = j <= i ? w[a4][k] * expf(cum[i] - cj) * dj : 0.f;
          }
          *reinterpret_cast<float4*>(&Wt[(tx * 4 + k) * TP + ty * 4]) =
              make_float4(o[0], o[1], o[2], o[3]);
        }
        // the last row tile visits every source tile: accumulate the next state
        if (last) {
          for (int j = 0; j < T; ++j) {
            const float wj = wv[j0 + j];
            const float4 x4 = ld4(&Xs[j * P + tx * 4]);
            const float xw[4] = {x4.x * wj, x4.y * wj, x4.z * wj, x4.w * wj};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float bn = Bt[(ty * 8 + r) * TP + j];
#pragma unroll
              for (int q = 0; q < 4; ++q) s[r][q] = fmaf(bn, xw[q], s[r][q]);
            }
          }
        }
        __syncthreads();
        // acc[i][p] += sum_j W[i][j] x[j][p] for p = tx*4+q
#pragma unroll 4
        for (int j = 0; j < T; ++j) {
          const float4 w4 = ld4(&Wt[j * TP + ty * 4]);
          const float4 x4 = ld4(&Xs[j * P + tx * 4]);
          const float wv4[4] = {w4.x, w4.y, w4.z, w4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a4][q] = fmaf(wv4[a4], xv[q], acc[a4][q]);
        }
        __syncthreads();  // Bt, Xs and Wt are refilled next
      }

      // inter-chunk term from the entering state, then the D skip
      float inter[4][4];
#pragma unroll
      for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
        for (int q = 0; q < 4; ++q) inter[a4][q] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        const float4 c4 = ld4(&Ct[n * TP + ty * 4]);
        const float4 s4 = ld4(&St[n * P + tx * 4]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int a4 = 0; a4 < 4; ++a4)
#pragma unroll
          for (int q = 0; q < 4; ++q) inter[a4][q] = fmaf(cv[a4], sv[q], inter[a4][q]);
      }
#pragma unroll
      for (int a4 = 0; a4 < 4; ++a4) {
        const int i = i0 + ty * 4 + a4;
        if (i < L) {
          const float e = expf(cum[i]);
          const size_t off = (size_t)i * H * P + tx * 4;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            yc[off + q] = acc[a4][q] + e * inter[a4][q] + Dh * xc[off + q];
        }
      }
      __syncthreads();  // Ct is refilled next; St is rewritten after the last tile
    }

#pragma unroll
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<float4*>(&St[(ty * 8 + r) * P + tx * 4]) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    __syncthreads();
  }

  for (int idx = tid; idx < P * N; idx += THREADS) {
    const int p = idx / N, n = idx % N;
    final_state[st_off + idx] = St[n * P + p];
  }
}

cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, const void* D, const void* state0, void* y,
                   void* final_state, int B, int S, int H, int G, int chunk,
                   cudaStream_t stream) {
  static hopper::SmemOptIn allow_smem;
  const cudaError_t e = allow_smem((const void*)ssd_scan_kernel, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<<<B * H, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(state0), static_cast<float*>(y),
      static_cast<float*>(final_state), S, H, G, chunk);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, Bm, Cm and y).  dt, A_log, D, state0 (may be
// null) and final_state are fp32.  All tensors contiguous in the layouts of
// ssd_ref, bf16 ones 16-byte aligned.  bf16 also takes the workspace, from
// the caller's allocator: ssd_scan_workspace_bytes bytes, 256-byte aligned
// (fp32 ignores it; it may be null).  Launches on `stream`, does not
// synchronise; returns the CUDA error of the launches (0 on success).
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A_log,
                    const void* Bm, const void* Cm, const void* D, const void* state0,
                    void* y, void* final_state, void* workspace, int B, int S, int H, int G,
                    int P_, int N_, int chunk, void* stream) {
  if (P_ != P || N_ != N || chunk < 1 || chunk > MAXL || S % chunk != 0 || G < 1 ||
      H % G != 0 || B < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)simt::launch(x, dt, A_log, Bm, Cm, D, state0, y, final_state, B, S, H, G, chunk,
                             st);
  if (dtype == 1) {
    if (!workspace || reinterpret_cast<uintptr_t>(workspace) % 256)
      return (int)cudaErrorInvalidValue;
    return (int)tc::launch(x, dt, A_log, Bm, Cm, D, state0, y, final_state, workspace, B, S, H, G,
                           chunk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of the bf16 passes' workspace (0 for a shape ssd_scan_launch refuses).
size_t ssd_scan_workspace_bytes(int B, int S, int H, int chunk) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > MAXL || S % chunk != 0) return 0;
  return tc::workspace(B, S, H, chunk).bytes;
}

// The bf16 passes' tiling, for the tests that hold their Python mirror of
// it: out[0], out[1] the dynamic shared memory of the chunk and output
// passes' blocks; out[2..4], out[5..7], out[8..10] the grids (x, y, z) of
// the chunk, state and output passes; out[11..13] their threads per block.
// Returns 0, or cudaErrorInvalidValue.
int ssd_scan_plan(int B, int S, int H, int chunk, int* out) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > MAXL || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = S / chunk;
  const int vals[14] = {(int)tc::CHUNK_SMEM, (int)tc::OUT_SMEM,
                        nc, H, B,
                        P * N / tc::STATE_THREADS, H, B,
                        nc * tc::tiles(chunk), H, B,
                        tc::THREADS, tc::STATE_THREADS, tc::THREADS};
  for (int i = 0; i < 14; ++i) out[i] = vals[i];
  return 0;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
