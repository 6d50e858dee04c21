// Causal / sliding-window GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas and computes
// what src/repro/kernels/ref.py::flash_attention_ref computes:
//   q [B,S,H,d], k and v [B,T,Kv,d] (one dtype, fp32 or bf16, contiguous),
//   o [B,S,H,d] in q's dtype.  The query at row i sits at position
//   qpos = i + T - S; key kpos is kept when kpos <= qpos (causal) and
//   kpos > qpos - window (window); query head h reads KV head h / (H/Kv);
//   scores are scaled by 1/sqrt(d); softmax over the kept keys.
// A row with no kept key (S > T under causal, or causal with a window of 0
// or less) gets the reference's answer: its masked scores are the finite
// -1e30, so its softmax is uniform and the row is the mean of v over all T
// keys.
//
// Two kernels, picked by dtype.  This is dispatch by type, not a fallback:
// bf16 always runs the tensor-core kernel and fp32 the CUDA-core one.
//
// bf16: flash_attention_wgmma_kernel, on the warpgroup tensor-core products.
//   Block.  256 threads, two consumer warpgroups, per (128-row query tile,
//   head, batch); warpgroup w owns query rows 64w..64w+63 of the tile.
//   Query tiles run last-first, so the causal tiles with the most keys
//   start first.  Dynamic shared memory holds bf16 tiles only: Q (128 x Dp)
//   and a ring of two stages of K and V (64 x Dp each), where Dp is d
//   rounded up to 64, the width of the 128-byte swizzle atom.  A tile is
//   stored as Dp/64 column blocks of rows of 128 bytes, 16-byte chunk c of
//   row r at chunk position c ^ (r % 8): the layout the wgmma descriptors
//   read with the 128-byte swizzle.  At Dp = 128 (d = 80, 128) that is
//   32 + 2*2*16 = 96 KB (+1 KB to align the base to the swizzle pattern),
//   so two blocks (four warpgroups) fit on an SM; Dp = 64 (d <= 64) takes
//   48 KB.  The ring's depth is STAGES: three or four stages leave room for
//   one block per SM only, and were slower at danube's shapes.
//   Loads.  cp.async of 16 bytes per thread straight into the swizzled
//   layout; rows past S or T are zero-filled (src-size 0), and the columns
//   d..16*ceil(d/16) of Q and K, which QK^T reads (only d = 8 has them), are
//   zeroed once.  The next K/V stage is requested right after the barrier
//   that publishes the current one, so it lands while the current one is
//   multiplied; completion is cp.async.wait_group plus one block barrier
//   (and fence.proxy.async, which hands the writes to the tensor cores) per
//   KV tile.
//   S = Q K^T.  wgmma m64n64k16 f32.bf16.bf16, Q and K from shared memory,
//   both K-major, ceil(d/16) k-steps (5 at d = 80).  The k-step moves the
//   descriptors' start address 32 bytes inside the swizzle atom, or to the
//   next column block every four steps.
//   Softmax on the accumulator fragment.  A thread holds two rows (warp
//   row g and g + 8) with 16 scores each; a row's 64 scores sit in a quad
//   of lanes, so the running max reduces with two shuffles (the running
//   sum stays per thread until the end).  The running max m is kept in the
//   exp2 domain, so p = 2^(s * log2(e)/sqrt(d) - m) is one FFMA and one
//   ex2.approx (the special-function unit, measurably faster than the
//   accurate exp2f at danube's shapes); a masked key is -inf and
//   contributes exactly 0.  O is rescaled by alpha in registers.
//   O += P V.  P is rounded to bf16 in registers, as the reference rounds
//   its probabilities before PV, and the m64n64 accumulator regroups in
//   place into the A fragments of four k16 steps: the register-A ("RS")
//   form of wgmma.  V is the B operand read MN-major (transposed) from the
//   same swizzled layout.  Each wgmma spans one 64-column block of V, so
//   d = 80 is an N = 64 and an N = 16 product and d = 128 two of N = 64;
//   with N <= 64 the descriptor's block stride is never used.
//   Visited tiles.  Only the KV tiles that meet the block's band of kept
//   keys: under causal the loop stops at the last row's position, under a
//   window it starts at the tile of the first row's window start.  A
//   warpgroup skips the products of a tile that meets none of its own
//   rows' keys (half of the diagonal tile), and masks only tiles that some
//   of its rows do not keep whole.
//   Epilogue: the quad sums l, rows divide by it, a row with l = 0 takes
//   the mean of v, and o is written as bf16 pairs.
//
// fp32: flash_attention_kernel, the first design on the CUDA cores.
//   Tensor cores would take fp32 as TF32 (10-bit mantissas), too coarse
//   for the fp32 limits the card checks hold (2e-5, 1e-4 at full width).
//   One block of 256 threads per (64-row query tile, head, batch); Q and
//   64-row K and V tiles in dynamic shared memory in fp32 (rows padded by 4
//   floats), fp32 FMAs, thread (ty, tx) of a 16x16 layout owning query
//   rows ty + 16i and the scores against keys tx + 16j; half-warp shuffles
//   reduce m and l; the probabilities go through shared memory into PV.
//   Same band of visited tiles, last-first order and empty-row mean.
//   Compiled without fast math: expf is the accurate one.
//
// Bound on this card.  Counting only the kept (query, key) pairs, the
// function does 4 d FLOPs per pair and head (QK^T and PV) and moves q, k,
// v and o once.  For h2o-danube-1.8b's prefill (B=1, H=32, Kv=8, d=80,
// bf16, window 4096) it is bound by FLOPs at the bf16 tensor-core peak from
// S ~ 1024 up (S=4096: 85.9 GFLOP, 0.087 ms at 989 TFLOP/s, against 0.016
// ms for its 53 MB) and by bytes below that.  The wgmma kernel runs the
// products on the tensor cores; what still keeps it from the bound is not
// measured inside the kernel.  The candidates: QK^T as m64n64k16 with both
// operands in shared memory reads 128 bytes a cycle, the SM's whole
// shared-memory rate; a warpgroup's softmax does not overlap its own
// products (other warpgroups of the SM fill the gap); one block barrier
// per KV tile; and the masked half of each diagonal tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float MASKED = -1e30f;

// The keys [lo, hi) that some query row of [r0, r1) keeps (0 <= lo, hi <= T;
// none when hi <= lo), with the band of the first and of the last row: a
// row keeps [max(0, qpos - window + 1), min(T, qpos + 1)), and both ends
// grow with the row, so the rows' bands join into one.  `all_lo` and
// `all_hi` bound the keys every row keeps: a tile inside [all_lo, all_hi)
// needs no mask.  Causal with a window of 0 or less keeps no key at all.
struct Band {
  int lo, hi, all_lo, all_hi;
};

__host__ __device__ inline void row_keys(long long row, int S, int T, int causal, int has_window,
                                         int window, int& lo, int& hi) {
  const long long qpos = row + T - S;
  long long a = 0, b = T;
  if (causal && qpos + 1 < b) b = qpos + 1;
  if (has_window && qpos - window + 1 > a) a = qpos - window + 1;
  lo = (int)(a < T ? a : T);
  hi = (int)(b > 0 ? b : 0);
}

__host__ __device__ inline Band band(int r0, int r1, int S, int T, int causal, int has_window,
                                     int window) {
  Band out;
  int first_lo, first_hi, last_lo, last_hi;
  row_keys(r0, S, T, causal, has_window, window, first_lo, first_hi);
  row_keys(r1 - 1, S, T, causal, has_window, window, last_lo, last_hi);
  out.lo = first_lo;
  out.hi = (causal && has_window && window <= 0) ? first_lo : last_hi;
  out.all_lo = last_lo;
  out.all_hi = first_hi;
  return out;
}

// ---------------------------------------------------------------------------
// bf16: warpgroup tensor-core products
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BQ = 128;       // query rows per block
constexpr int WG_ROWS = 64;   // query rows per warpgroup
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // two warpgroups
constexpr int ATOM = 64;      // bf16 columns in one 128-byte swizzled row
constexpr int STAGES = 2;     // K/V tiles in the ring

__host__ __device__ constexpr int padded(int d) { return (d + ATOM - 1) / ATOM * ATOM; }

// Q tile and two stages of K and V, bf16, plus 1 KB to align the base to
// the 1024-byte swizzle pattern
__host__ __device__ constexpr size_t smem_bytes(int d) {
  return (size_t)(BQ + 2 * STAGES * BK) * padded(d) * 2 + 1024;
}

// 2^x by the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, far under what a bf16 probability can add to a row)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of one head of a [*, rows, heads, D] bf16
// tensor into a swizzled tile at shared address `dst`; rows at or past
// `rows` come in as zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          int row0, int rows, int heads, int head,
                                          size_t batch_off) {
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS, c = idx % CHUNKS, row = row0 + r;
    const bool in = row < rows;
    const __nv_bfloat16* g = src + batch_off + ((size_t)(in ? row : 0) * heads + head) * D + c * 8;
    cp_async16(dst + swizzled(ROWS, r, c), g, in ? 16 : 0);
  }
}

// The accumulator of a warpgroup's m64nN product: thread (warp w, lane
// 4g + t) holds, for each 8-column chunk j, d[4j + 2e + i] = (row 16w + g +
// 8e, column 8j + 2t + i).  So d[i] lies in row g + 8 * ((i >> 1) & 1).

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ o, int S, int Tk, int H, int Kv,
                                 int causal, int has_window, int window, float scale_log2) {
  constexpr int DP = padded(D);
  constexpr int KSTEPS = (D + 15) / 16;  // k16 steps of QK^T over the head width
  constexpr int NB = (D + ATOM - 1) / ATOM;  // 64-column blocks of the output
  constexpr int Q_BYTES = BQ * DP * 2, KV_BYTES = BK * DP * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t Qs = base, Ks = base + Q_BYTES, Vs = Ks + STAGES * KV_BYTES;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t q_boff = (size_t)b * S * H * D;
  const size_t kv_boff = (size_t)b * Tk * Kv * D;

  const Band blk = band(q0, min(q0 + BQ, S), S, Tk, causal, has_window, window);
  const int w0 = q0 + wg * WG_ROWS;
  const bool wg_rows = w0 < S;
  const Band wgb = band(w0, min(w0 + WG_ROWS, S), S, Tk, causal, has_window, window);
  // this thread's rows: e = 0 is row g of its warp, e = 1 row g + 8
  int row[2], rlo[2], rhi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    row[e] = w0 + warp * 16 + g + 8 * e;
    row_keys(row[e], S, Tk, causal, has_window, window, rlo[e], rhi[e]);
  }

  // zero the columns past D that QK^T's last k-step reads (D = 8 only)
  if constexpr (D % 16 != 0) {
    constexpr int C0 = D / 8, C1 = KSTEPS * 2;
    for (int idx = tid; idx < (BQ + STAGES * BK) * (C1 - C0); idx += THREADS) {
      const int r = idx / (C1 - C0), c = C0 + idx % (C1 - C0);
      const uint32_t at = r < BQ ? Qs + swizzled(BQ, r, c)
                                 : Ks + ((r - BQ) / BK) * KV_BYTES + swizzled(BK, (r - BQ) % BK, c);
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
    }
  }

  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // one copy group per K/V tile (Q joins the first), STAGES - 1 tiles
  // ahead; a group past the last tile is empty, so the count stays even
  const int k_first = (blk.lo / BK) * BK;
  const bool any = blk.hi > blk.lo;
  if (any) load_tile<D, BQ>(Qs, q, q0, S, H, h, q_boff);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    const int kt = k_first + st * BK;
    if (any && kt < blk.hi) {
      load_tile<D, BK>(Ks + st * KV_BYTES, k, kt, Tk, Kv, kvh, kv_boff);
      load_tile<D, BK>(Vs + st * KV_BYTES, v, kt, Tk, Kv, kvh, kv_boff);
    }
    cp_async_commit();
  }
  int stage = 0;
  for (int k0 = k_first; any && k0 < blk.hi; k0 += BK, stage = stage + 1 == STAGES ? 0 : stage + 1) {
    // this tile has landed, and every warpgroup is done with the stage the
    // tile STAGES - 1 ahead goes into
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();
    {
      const int kt = k0 + (STAGES - 1) * BK;
      const int st = stage == 0 ? STAGES - 1 : stage - 1;
      if (kt < blk.hi) {
        load_tile<D, BK>(Ks + st * KV_BYTES, k, kt, Tk, Kv, kvh, kv_boff);
        load_tile<D, BK>(Vs + st * KV_BYTES, v, kt, Tk, Kv, kvh, kv_boff);
      }
      cp_async_commit();
    }
    if (!wg_rows || wgb.hi <= wgb.lo || k0 >= wgb.hi || k0 + BK <= wgb.lo) continue;
    const uint32_t Kst = Ks + stage * KV_BYTES, Vst = Vs + stage * KV_BYTES;

    // S = Q K^T
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t kb = (kk % 4) * 32;  // 16 columns in, inside the swizzle atom
      const uint64_t dq = desc(Qs + (kk / 4) * BQ * ROW + wg * WG_ROWS * ROW + kb, 16, 1024);
      const uint64_t dk = desc(Kst + (kk / 4) * BK * ROW + kb, 16, 1024);
      wgmma_ss_n64(s, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) pin(s[i]);

    // online softmax in the exp2 domain: m is the running max of the
    // scaled scores, p = 2^(s * scale_log2 - m)
    if (!(k0 >= wgb.all_lo && k0 + BK <= wgb.all_hi)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1, key = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (key < rlo[e] || key >= rhi[e]) s[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e] * scale_log2);
      alpha[e] = ex2(m[e] - m_new);
      m[e] = m_new;
      l[e] *= alpha[e];
    }
    uint32_t p[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int e = (i >> 1) & 1;
      const float p0 = ex2(fmaf(s[i], scale_log2, -m[e]));
      const float p1 = ex2(fmaf(s[i + 1], scale_log2, -m[e]));
      l[e] += p0 + p1;
      p[i / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: k-step kk takes keys 16kk..16kk+15, whose P fragment is
    // p[4kk..4kk+3]; one product per 64-column block of V
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(p[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs<(D < ATOM ? D : ATOM)>(acc, p + 4 * kk, desc(Vst + kk * 16 * ROW, 1024, 1024));
      if constexpr (NB > 1)
        wgmma_rs<D - ATOM>(acc + ATOM / 2, p + 4 * kk,
                           desc(Vst + BK * ROW + kk * 16 * ROW, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int i = 0; i < 16; ++i) pin(p[i]);
  }

  // full row sums over the quad; rows with no kept key take the mean of v
  bool empty = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    empty |= row[e] < S && l[e] == 0.f;
  }
  float* mean_v = reinterpret_cast<float*>(smem_raw + (base - raw));
  if (__syncthreads_or(empty)) {
    for (int c = tid; c < D; c += THREADS) {
      float sum = 0.f;
      for (int t = 0; t < Tk; ++t) sum += __bfloat162float(v[kv_boff + ((size_t)t * Kv + kvh) * D + c]);
      mean_v[c] = sum / (float)Tk;
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (row[e] >= S) continue;
    const float inv = l[e] > 0.f ? 1.f / l[e] : 0.f;
    __nv_bfloat16* out = o + q_boff + ((size_t)row[e] * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const int i = 4 * j + 2 * e;  // block nb's chunks follow block nb-1's 32 registers
      const float v0 = l[e] > 0.f ? acc[i] * inv : mean_v[col];
      const float v1 = l[e] > 0.f ? acc[i + 1] * inv : mean_v[col + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int Kv, int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  auto kern = flash_attention_wgmma_kernel<D>;
  static hopper::SmemOptIn allow_smem;
  const cudaError_t err = allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, Tk, H, Kv, causal,
      has_window, window, scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 layout
constexpr int LDP = BK + 4;     // padded row of the probability tile

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }  // padded fp32 row of a Q, K or V tile

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(3 * 64 * ld<D>() + BQ * LDP) * sizeof(float);
}

// rows [row0, row0 + 64) of one head of a [*, rows, heads, D] tensor into
// an fp32 [64][LD] tile; rows at or past `rows` are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int rows, int heads, int head, size_t batch_off) {
  constexpr int LD = ld<D>();
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * LD + c] = row < rows ? src[batch_off + ((size_t)row * heads + head) * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int S, int Tk, int H,
                           int Kv, int causal, int has_window, int window, float scale) {
  constexpr int LD = ld<D>();
  constexpr int CPT = (D + 15) / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Tk - S;  // qpos = row + off
  const size_t q_boff = (size_t)b * S * H * D;
  const size_t kv_boff = (size_t)b * Tk * Kv * D;

  load_tile<D>(Qs, q, q0, S, H, h, q_boff);

  // the keys any row of this tile may keep: [lo, hi)
  const long long first_q = (long long)q0 + off;
  const long long last_q = (long long)min(q0 + BQ, S) - 1 + off;
  long long lo = 0, hi = Tk;
  if (causal) hi = min(hi, last_q + 1);
  if (has_window) lo = max(lo, first_q - window + 1);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    load_tile<D>(Ks, k, (int)k0, Tk, Kv, kvh, kv_boff);
    load_tile<D>(Vs, v, (int)k0, Tk, Kv, kvh, kv_boff);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q0 + ty + 16 * i + off;
      bool keep[4];
      float mt = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        keep[j] = kpos < Tk && (!causal || kpos <= qpos) && (!has_window || kpos > qpos - window);
        s[i][j] *= scale;
        if (keep[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o2 = 8; o2 > 0; o2 >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o2);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + j]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (D % 16 != 0 && col >= D) continue;
        const float v0 = Vs[(j + 0) * LD + col], v1 = Vs[(j + 1) * LD + col];
        const float v2 = Vs[(j + 2) * LD + col], v3 = Vs[(j + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(pv[i].x, v0, a);
          a = fmaf(pv[i].y, v1, a);
          a = fmaf(pv[i].z, v2, a);
          a = fmaf(pv[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

  // rows with no kept key: the mean of v over all Tk keys (into Ks[0..D))
  bool empty = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) empty |= (q0 + ty + 16 * i < S) && l[i] == 0.f;
  if (__syncthreads_or(empty)) {
    for (int c = threadIdx.x; c < D; c += THREADS) {
      float sum = 0.f;
      for (int t = 0; t < Tk; ++t) sum += v[kv_boff + ((size_t)t * Kv + kvh) * D + c];
      Ks[c] = sum / (float)Tk;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* out = o + q_boff + ((size_t)row * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 != 0 && col >= D) continue;
      out[col] = l[i] > 0.f ? acc[i][c] * inv : Ks[col];
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int Kv, int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<D>;
  static hopper::SmemOptIn allow_smem;
  const cudaError_t err = allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                        static_cast<const float*>(v), static_cast<float*>(o), S, Tk,
                                        H, Kv, causal, has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace simt

template <bool TC>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, int B, int S,
                     int Tk, int H, int Kv, int causal, int has_window, int window,
                     cudaStream_t st) {
#define FA_CASE(D)                                                                          \
  case D:                                                                                   \
    return TC ? tc::launch<D>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st)  \
              : simt::launch<D>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
  switch (d) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o).  q and o [B,S,H,d], k and v
// [B,T,Kv,d], all contiguous, bf16 ones 16-byte aligned; d in {8, 16, 32,
// 64, 80, 128}; H % Kv == 0.  has_window = 0 ignores `window`.  Launches on
// `stream`, does not synchronise; returns the CUDA error of the launch (0 on
// success).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                           int B, int S, int T, int H, int Kv, int d, int causal,
                           int has_window, int window, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T < 1 || H < 1 || H > 65535 || Kv < 1 || H % Kv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<false>(d, q, k, v, o, B, S, T, H, Kv, causal, has_window, window, st);
  if (dtype == 1)
    return (int)dispatch<true>(d, q, k, v, o, B, S, T, H, Kv, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 kernel's tiling, for the tests that hold their Python mirror
// of it: out[0] the padded head width Dp, out[1] the dynamic shared-memory
// bytes, out[2..5] the block's Band for query tile qt (lo, hi, all_lo,
// all_hi) and out[6..9], out[10..13] those of its two warpgroups (all 0 for
// a warpgroup with no row below S).  Returns 0, or cudaErrorInvalidValue.
int flash_attention_plan(int d, int S, int T, int causal, int has_window, int window, int qt,
                         int* out) {
  if (d < 1 || S < 1 || T < 1 || qt < 0 || (long long)qt * tc::BQ >= S)
    return (int)cudaErrorInvalidValue;
  out[0] = tc::padded(d);
  out[1] = (int)tc::smem_bytes(d);
  const int q0 = qt * tc::BQ;
  const int r1 = q0 + tc::BQ < S ? q0 + tc::BQ : S;
  const Band blk = band(q0, r1, S, T, causal, has_window, window);
  int* at = out + 2;
  at[0] = blk.lo, at[1] = blk.hi, at[2] = blk.all_lo, at[3] = blk.all_hi;
  for (int w = 0; w < 2; ++w) {
    at = out + 6 + 4 * w;
    const int w0 = q0 + w * tc::WG_ROWS;
    if (w0 >= S) {
      at[0] = at[1] = at[2] = at[3] = 0;
      continue;
    }
    const Band wb = band(w0, w0 + tc::WG_ROWS < S ? w0 + tc::WG_ROWS : S, S, T, causal,
                         has_window, window);
    at[0] = wb.lo, at[1] = wb.hi, at[2] = wb.all_lo, at[3] = wb.all_hi;
  }
  return 0;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
