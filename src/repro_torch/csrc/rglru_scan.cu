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
// Design.  The recurrence is sequential in time and independent across
// channels.  On the TPU the kernel tiles channels into 128-lane VMEM blocks
// and walks time with h in vector registers.  Here one thread owns one
// (b, channel) and walks time with h in a register; a block holds 32
// channels, so a row of x, r or i is one coalesced 64-byte (bf16) or
// 128-byte (fp32) load per warp, and the grid is (C/32, B).  Only the FMA
// chain through h is sequential: the loads and the gate math of a step do
// not depend on h.  So each thread loads U = 8 steps of x, r and i into
// registers one group ahead of the group it computes (a register double
// buffer), computes the group's gates independently, and then runs the
// group's 8 dependent FMAs.  The last group masks steps past S; threads past
// C return at once (any C, any S >= 1; decode calls it with S = 1).
// Compiled without fast math, so exp, log1p and sqrt are the accurate ones
// and the kernel stays within fp32 tolerance of the plain version.
//
// Bound on this card.  For one RecurrentGemma-2B recurrent block and a
// 1024-token prompt (B=1, S=1024, C=2560, bf16) the function reads x, r and
// i (15.73 MB) and writes y (5.24 MB), plus lam and h_last (~20 KB): ~21 MB,
// 6.3 us at 3.35 TB/s.  It does a few tens of operations per element, far
// under the bytes' time at any peak: bound by bytes.  This kernel keeps only
// 3 x 8 loads of 2-4 bytes in flight per thread, and at batch 1 runs 2,560
// threads (80 warps on 132 SMs): far too few bytes in flight to reach the
// card's memory rate.  A time-chunked two-pass scan (local scans of chunks
// in parallel, then a pass that carries h across chunks) is later work.
// At decode (B=4, S=1) the data is ~0.17 MB and a launch's own latency is
// the floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;    // channels per block
constexpr int U = 8;           // time steps loaded ahead of the h chain
constexpr float GATE_C = 8.f;  // RecurrentGemma's c in a = exp(-c softplus(lam) sigmoid(r))

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

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// steps t0 .. t0+U-1 of one channel (stride C between steps); zeros past S
template <class In>
__device__ __forceinline__ void load_group(const In* __restrict__ p, size_t off, int C,
                                           int n, In (&dst)[U]) {
#pragma unroll
  for (int k = 0; k < U; ++k)
    dst[k] = k < n ? p[off + (size_t)k * C] : from_f<In>(0.f);
}

template <class In>
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const In* __restrict__ x, const In* __restrict__ r,
                      const In* __restrict__ i, const float* __restrict__ lam,
                      const float* __restrict__ h0, In* __restrict__ y,
                      float* __restrict__ h_last, int S, int C) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= C) return;
  const int b = blockIdx.y;
  const float l = lam[ch];
  // softplus as logaddexp(l, 0): no overflow for large l
  const float neg_c_sp = -GATE_C * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  float h = h0 ? h0[(size_t)b * C + ch] : 0.f;
  const size_t base = (size_t)b * S * C + ch;

  In xc[U], rc[U], ic[U], xn[U], rn[U], i_n[U];
  load_group(x, base, C, S, xc);
  load_group(r, base, C, S, rc);
  load_group(i, base, C, S, ic);
  for (int t0 = 0; t0 < S; t0 += U) {
    const int next = t0 + U;
    if (next < S) {  // the next group's loads go out before this group's math
      const size_t off = base + (size_t)next * C;
      load_group(x, off, C, S - next, xn);
      load_group(r, off, C, S - next, rn);
      load_group(i, off, C, S - next, i_n);
    }
    float a[U], bv[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const float log_a = neg_c_sp * sigmoid(to_f(rc[k]));
      a[k] = expf(log_a);
      bv[k] = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f)) * (sigmoid(to_f(ic[k])) * to_f(xc[k]));
    }
    const int n = min(U, S - t0);
    const size_t off = base + (size_t)t0 * C;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (k < n) {
        h = fmaf(a[k], h, bv[k]);
        y[off + (size_t)k * C] = from_f<In>(h);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      xc[k] = xn[k];
      rc[k] = rn[k];
      ic[k] = i_n[k];
    }
  }
  h_last[(size_t)b * C + ch] = h;
}

template <class In>
cudaError_t launch(const void* x, const void* r, const void* i, const void* lam,
                   const void* h0, void* y, void* h_last, int B, int S, int C,
                   cudaStream_t stream) {
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<In><<<grid, THREADS, 0, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(r), static_cast<const In*>(i),
      static_cast<const float*>(lam), static_cast<const float*>(h0), static_cast<In*>(y),
      static_cast<float*>(h_last), S, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, r, i and y, all [B,S,C] contiguous).  lam
// [C], h0 [B,C] (may be null) and h_last [B,C] are fp32.  Launches on
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

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
