// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_pallas and
// computes what src/repro/kernels/ref.py::ssd_ref computes, per (b, h):
//   cum_i    = cumsum over the chunk of dt_i * A,   A = -exp(A_log[h])
//   y_i      = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra-chunk)
//            + exp(cum_i) C_i . state_entering                         (inter-chunk)
//            + D[h] x_i                                                (skip)
//   state'   = state exp(cum_last) + sum_j x_j dt_j exp(cum_last - cum_j) B_j^T
// with state0 applied to y and to the final state, as ssd_ref does.
//
// Design.  On the TPU the chunk axis is a sequential grid dimension with the
// state in VMEM scratch.  Hopper runs blocks in no order, so one block owns
// one (b, h) and loops over the chunks itself, carrying the [P,N] fp32 state
// (32 KB) in shared memory.  The LxL matrix (C B^T) * decay * dt of a
// 256-row chunk is 256 KB in fp32, more than a block's 227 KB, so it is
// produced and consumed in 64x64 tiles: for each 64-row output tile, the
// 64-row source tiles at or below the diagonal are multiplied in, then the
// inter-chunk term.  The state update rides on the last row tile, which
// visits every source tile; its sum lives in registers until the inter-chunk
// term of that tile has read the entering state.  Shared memory: state 32 KB,
// C and B tiles transposed to [N][64+4] (35 KB each), x tile 16 KB, W tile
// 17 KB, per-step cumsum/dt/weights 3 KB: ~136 KB, dynamic, so
// cudaFuncSetAttribute raises the block's limit.  Ragged chunks (any length
// up to 256, e.g. 100) load zeros past the chunk's end and store no rows
// there.  Each thread computes 4x4 outputs from float4 shared-memory reads;
// the products run as fp32 FMAs on the CUDA cores.
//
// Bound on this card.  For one Mamba2-1.3B layer and a 1024-token prompt
// (B=1, H=64, P=64, G=1, N=128, chunk 256) the function moves ~19.7 MB
// (5.9 us at 3.35 TB/s) and, counting only the causal triangle of the LxL
// intra-chunk products, does ~5.4 GFLOP (5.4 us at the 989 TFLOP/s bf16
// tensor-core peak): bound by bytes, barely.  This kernel uses no tensor
// cores (fp32 FMA peak is 67 TFLOP/s, where the same work takes 80 us) and
// at batch 1 its 64 blocks fill under half of the 132 SMs; wgmma tiles and
// splitting a (b, h) over more blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int P = 64;        // head_dim
constexpr int N = 128;       // d_state
constexpr int T = 64;        // rows per tile
constexpr int TP = T + 4;    // padded stride of the transposed tiles (float4-aligned)
constexpr int MAXL = 256;    // longest chunk
constexpr int THREADS = 256; // one thread per chunk step in the cumsum
static_assert(THREADS == MAXL, "the cumsum gives each thread one step");

constexpr int SMEM_FLOATS = N * P + 2 * N * TP + T * P + T * TP + 3 * MAXL + 8;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class In> __device__ __forceinline__ In from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows r0..r0+T-1 of a [rows][N] slab (row stride `rs`) into dst[N][TP], transposed;
// zeros past the chunk's end
template <class In>
__device__ __forceinline__ void load_bc(float* dst, const In* src, int rs, int r0, int L) {
  for (int idx = threadIdx.x; idx < T * N; idx += THREADS) {
    const int r = idx / N, n = idx % N, row = r0 + r;
    dst[n * TP + r] = row < L ? to_f(src[(size_t)row * rs + n]) : 0.f;
  }
}

// rows r0..r0+T-1 of a [rows][P] slab (row stride `rs`) into dst[T][P]
template <class In>
__device__ __forceinline__ void load_x(float* dst, const In* src, int rs, int r0, int L) {
  for (int idx = threadIdx.x; idx < T * P; idx += THREADS) {
    const int r = idx / P, p = idx % P, row = r0 + r;
    dst[idx] = row < L ? to_f(src[(size_t)row * rs + p]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <class In>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const In* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const In* __restrict__ Bm,
                const In* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ state0, In* __restrict__ y,
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
  float* wsum = wv + MAXL;                       // [8] per-warp scan totals

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
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
    const In* xc = x + (((size_t)b * S + s0) * H + h) * P;  // row stride H*P
    const In* bc = Bm + (((size_t)b * S + s0) * G + g) * N; // row stride G*N
    const In* cc = Cm + (((size_t)b * S + s0) * G + g) * N;
    In* yc = y + (((size_t)b * S + s0) * H + h) * P;

    // -- inclusive cumsum of dt*A over the chunk (zeros past its end) --------
    const float d = tid < L ? dt[((size_t)b * S + s0 + tid) * H + h] : 0.f;
    float a = d * A;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, a, off);
      if (lane >= off) a += v;
    }
    if (lane == 31) wsum[warp] = a;
    __syncthreads();
    for (int w = 0; w < warp; ++w) a += wsum[w];
    cum[tid] = a;
    dtv[tid] = d;
    __syncthreads();
    const float cL = cum[L - 1];
    wv[tid] = d * expf(cL - a);

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
            yc[off + q] = from_f<In>(acc[a4][q] + e * inter[a4][q] + Dh * to_f(xc[off + q]));
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

template <class In>
cudaError_t launch(const void* x, const void* dt, const void* A_log, const void* Bm,
                   const void* Cm, const void* D, const void* state0, void* y,
                   void* final_state, int B, int S, int H, int G, int chunk,
                   cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  // (per device, so on every launch: the call is cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  ssd_scan_kernel<In><<<B * H, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const In*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const In*>(Bm),
      static_cast<const In*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(state0), static_cast<In*>(y),
      static_cast<float*>(final_state), S, H, G, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, Bm, Cm and y).  dt, A_log, D, state0 (may be
// null) and final_state are fp32.  All tensors contiguous in the layouts of
// ssd_ref.  Launches on `stream`, does not synchronise; returns the CUDA error
// of the launch (0 on success).
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A_log,
                    const void* Bm, const void* Cm, const void* D, const void* state0,
                    void* y, void* final_state, int B, int S, int H, int G, int P_, int N_,
                    int chunk, void* stream) {
  if (P_ != P || N_ != N || chunk < 1 || chunk > MAXL || S % chunk != 0 || G < 1 ||
      H % G != 0 || B < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A_log, Bm, Cm, D, state0, y, final_state, B, S, H, G,
                              chunk, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, D, state0, y, final_state, B, S,
                                      H, G, chunk, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
