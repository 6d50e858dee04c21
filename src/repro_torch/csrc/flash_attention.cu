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
// A row with no kept key (only S > T under causal) gets the reference's
// answer: its masked scores are the finite -1e30, so its softmax is uniform
// and the row is the mean of v over all T keys.
//
// Design.  One block of 256 threads per (64-row query tile, head, batch).
// The Q tile and 64-row K and V tiles are staged in dynamic shared memory,
// converted to fp32 on load (rows padded by 4 floats, so the float4 reads
// of 8 neighbouring rows hit distinct banks).  Thread (ty, tx) of a 16x16
// layout owns query rows ty + 16i (i < 4): it computes the scores of those
// rows against keys tx + 16j (j < 4) as fp32 FMAs, as the Pallas body's
// .astype(f32) does, and the output columns tx + 16c of the same rows.  A
// row's 64 scores lie in the 16 lanes of one half-warp, so its running max
// m and sum l (online softmax, fp32) reduce with shuffles; acc stays in
// registers.  Masked keys contribute exactly 0, which is what exp(-1e30 - m)
// gives the reference for any row that has a kept key.  The loop visits
// only the KV tiles that meet the query tile's band: under causal it stops
// at the tile holding the last query's position, under a window it starts
// at the tile holding max(0, q0 + T - S - window + 1).  The Pallas kernel
// walks every tile; at S = 4096 with a 4096 window most of them are masked.
// Query tiles run last-first, so the causal tiles with the most keys start
// first.  Compiled without fast math: expf is the accurate one.
//
// Bound on this card.  Counting only the kept (query, key) pairs, the
// function does 4 d FLOPs per pair and head (QK^T and PV) and moves q, k,
// v and o once.  For h2o-danube-1.8b's prefill (B=1, H=32, Kv=8, d=80,
// bf16, window 4096) it is bound by FLOPs at the bf16 tensor-core peak from
// S ~ 1024 up (S=4096: 85.9 GFLOP, 0.087 ms at 989 TFLOP/s, against 0.016
// ms for its 53 MB) and by bytes below that.  This first design sits far
// from that bound: its products are fp32 FMAs on the CUDA cores (67 TFLOP/s
// at most, and shared-memory reads cap it well below), with no tensor cores
// (mma.sync / wgmma) and no asynchronous copies (cp.async / TMA) that would
// overlap the tile loads with the products.  Those are the next design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 layout
constexpr int LDP = BK + 4;     // padded row of the probability tile
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }  // padded fp32 row of a Q, K or V tile

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(3 * 64 * ld<D>() + BQ * LDP) * sizeof(float);
}

// rows [row0, row0 + 64) of one head of a [*, rows, heads, D] tensor into
// an fp32 [64][LD] tile; rows at or past `rows` are zeros
template <int D, class T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int rows, int heads, int head, size_t batch_off) {
  constexpr int LD = ld<D>();
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    dst[r * LD + c] =
        row < rows ? to_f(src[batch_off + ((size_t)row * heads + head) * D + c]) : 0.f;
  }
}

template <int D, class T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
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
      for (int t = 0; t < Tk; ++t) sum += to_f(v[kv_boff + ((size_t)t * Kv + kvh) * D + c]);
      Ks[c] = sum / (float)Tk;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* out = o + q_boff + ((size_t)row * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (D % 16 != 0 && col >= D) continue;
      out[col] = from_f<T>(l[i] > 0.f ? acc[i][c] * inv : Ks[col]);
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
// The attribute belongs to the device, so each instance sets it once per
// device (a bit each for devices 0-63; others set it on every launch).
// Two threads may both set it the first time: setting it twice is harmless.
template <int D, class T>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit & done.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<D>());
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int D, class T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk,
                   int H, int Kv, int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<D, T>;
  const cudaError_t err = allow_smem<D, T>();
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H,
                                        Kv, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, int B, int S,
                     int Tk, int H, int Kv, int causal, int has_window, int window,
                     cudaStream_t st) {
  switch (d) {
    case 8: return launch<8, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    case 16: return launch<16, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    case 32: return launch<32, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    case 64: return launch<64, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    case 80: return launch<80, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    case 128: return launch<128, T>(q, k, v, o, B, S, Tk, H, Kv, causal, has_window, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o).  q and o [B,S,H,d], k and v
// [B,T,Kv,d], all contiguous; d in {8, 16, 32, 64, 80, 128}; H % Kv == 0.
// has_window = 0 ignores `window`.  Launches on `stream`, does not
// synchronise; returns the CUDA error of the launch (0 on success).
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                           int B, int S, int T, int H, int Kv, int d, int causal,
                           int has_window, int window, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || T < 1 || H < 1 || H > 65535 || Kv < 1 || H % Kv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, o, B, S, T, H, Kv, causal, has_window, window, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, o, B, S, T, H, Kv, causal, has_window,
                                        window, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
