// FlowNetC correlation (cost volume) forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package:
//   * unflow_tpu/ops/pallas/correlation.py::_corr_fwd_chunk (f32, "B1"):
//     instantiated here as unflow_corr_fwd_f32;
//   * unflow_tpu/ops/pallas/correlation_mxu.py::corr_fwd_mxu (bf16, "B4"):
//     instantiated here as unflow_corr_fwd_bf16_simt (bf16 in, f32 sums over
//     all C channels, bf16 out) for the geometries that the tensor-core
//     kernel of correlation_fwd_mma.cu does not take.
//
// Computes, for NHWC inputs (B, H, W, C) and D = 2*(P/s) + 1,
//
//   out[b, y, x, i*D + j] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y + s*i - P, x + s*j - P, c]
//
// with reads of f2 outside the map taken as zero, sums kept in f32 and the
// result cast to the input type. The output (B, H, W, D*D) keeps dy (i) as
// the slower axis.
//
// What bounds it. The work is 2*B*H*W*D*D*C operations against reading f1
// and f2 once and writing the cost volume once. At FlowNetC's eval shape
// (B=4, 48x160, C=256, D=21) that is 6.94 GFLOP against 63 MB (bf16) or
// 117 MB (f32) of traffic: the f32 path is bound by FP32 FMA throughput
// (~104 us at 67 TFLOP/s), the bf16 path by memory (~17.5 us at 3.35 TB/s).
//
// Design. One block per (x-tile of 32 output columns, output row, batch
// element [, displacement block]); each lane owns one output column and
// each of the 7 warps owns 3 of the 21 displacement rows, so a thread keeps
// 3 x 21 f32 sums in registers for the whole channel loop. Channels go in
// steps of 8: the block stages the f1 tile and, for each of its displacement
// rows, the f2 row segment of (32 + s*20) columns into shared memory
// (converted to f32, zero outside the map), once per step: f1 is read once,
// and each f2 value by the D output rows and the ~(32 + 2P)/32 x-tiles that
// need it (~47 times for FlowNetC, mostly from L2) instead of D*D times by a
// shifted-product formulation. Each f1 value read from shared memory feeds
// 63 FMAs; each f2 value one, with lanes on consecutive words (no bank
// conflicts). The results go through shared memory so that each block
// writes its contiguous (32, D*D) slice of the output with coalesced stores.
// Not done yet: register tiling across x, which would cut the shared-memory
// reads per FMA (bf16 maps of the usual widths run on the tensor cores, in
// correlation_fwd_mma.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;            // output columns per block, one per lane
constexpr int kWarps = 7;          // warps per block
constexpr int kRowsPerWarp = 3;    // displacement rows each warp owns
constexpr int kDi = kWarps * kRowsPerWarp;  // displacement rows per block (21)
constexpr int kDj = 21;            // displacement columns per block
constexpr int kCk = 8;             // channels staged per step
constexpr int kThreads = kTx * kWarps;

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Eight channels [c0, c0 + 8) of one pixel, as f32; zeros where src is null
// (pixel outside the map) or a channel is past C. `vec`: src is 16-byte
// aligned and all eight channels exist.
__device__ __forceinline__ void load8(const float* src, bool vec, int c0, int C, float v[kCk]) {
  if (src == nullptr) {
#pragma unroll
    for (int k = 0; k < kCk; ++k) v[k] = 0.f;
  } else if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kCk; ++k) v[k] = (c0 + k < C) ? __ldg(src + k) : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, bool vec, int c0, int C, float v[kCk]) {
  if (src == nullptr) {
#pragma unroll
    for (int k = 0; k < kCk; ++k) v[k] = 0.f;
  } else if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < kCk / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCk; ++k) v[k] = (c0 + k < C) ? to_float(src[k]) : 0.f;
  }
}

__host__ __device__ constexpr int window_cols(int s) { return kTx + s * (kDj - 1); }
// Odd row stride: the staging stores (lanes on consecutive columns, one
// channel each) and the reads stay free of bank conflicts.
__host__ __device__ constexpr int window_stride(int s) { return window_cols(s) | 1; }

// S > 0 fixes the stride at compile time, so that every shared-memory read
// of the inner loop is one base register plus an immediate offset. S == 0
// takes the stride `s` at run time and keeps the channel loop rolled: unrolled,
// its 3 x 8 x 21 addresses need registers of their own and spill.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int H, int W, int C, int P, int s_run, int D, int n_iblk, int n_jblk, bool vec) {
  extern __shared__ float smem[];
  const int s = S > 0 ? S : s_run;
  const int cols = window_cols(s);
  const int colp = window_stride(s);
  float* f2s = smem;                          // [kDi][kCk][colp]
  float* f1s = smem + kDi * kCk * colp;       // [kCk][kTx]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTx;
  const int y = blockIdx.y;
  int z = blockIdx.z;
  const int jb = z % n_jblk;
  z /= n_jblk;
  const int ib = z % n_iblk;
  const int b = z / n_iblk;
  const int i0 = ib * kDi;
  const int j0 = jb * kDj;
  const int xw0 = x0 + s * j0 - P;  // f2 column of window column 0

  const size_t plane = static_cast<size_t>(H) * W * C;
  const T* f1b = f1 + b * plane;
  const T* f2b = f2 + b * plane;

  float acc[kRowsPerWarp][kDj];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < kDj; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCk) {
    for (int u = threadIdx.x; u < kTx; u += kThreads) {
      const int x = x0 + u;
      float v[kCk];
      load8(x < W ? f1b + (static_cast<size_t>(y) * W + x) * C + c0 : nullptr, vec, c0, C, v);
#pragma unroll
      for (int k = 0; k < kCk; ++k) f1s[k * kTx + u] = v[k];
    }
    for (int u = threadIdx.x; u < kDi * cols; u += kThreads) {
      const int il = u / cols;
      const int col = u - il * cols;
      const int y2 = y + s * (i0 + il) - P;
      const int x2 = xw0 + col;
      const bool inside = i0 + il < D && y2 >= 0 && y2 < H && x2 >= 0 && x2 < W;
      float v[kCk];
      load8(inside ? f2b + (static_cast<size_t>(y2) * W + x2) * C + c0 : nullptr, vec, c0, C, v);
#pragma unroll
      for (int k = 0; k < kCk; ++k) f2s[(il * kCk + k) * colp + col] = v[k];
    }
    __syncthreads();
#pragma unroll(S > 0 ? kCk : 1)
    for (int k = 0; k < kCk; ++k) {
      const float a = f1s[k * kTx + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float* row = f2s + ((warp + kWarps * r) * kCk + k) * colp + lane;
#pragma unroll
        for (int j = 0; j < kDj; ++j) acc[r][j] = fmaf(a, row[s * j], acc[r][j]);
      }
    }
    __syncthreads();
  }

  // Stage the (x, i, j) results in shared memory (the windows are dead by
  // now), then write the block's slice of the output with coalesced stores.
  const int ni = min(kDi, D - i0);
  const int nj = min(kDj, D - j0);
  const int nx = min(kTx, W - x0);
  const float inv_c = 1.f / static_cast<float>(C);
  float* os = smem;  // [nx][ni][nj]
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int il = warp + kWarps * r;
    if (il < ni && lane < nx) {
#pragma unroll
      for (int j = 0; j < kDj; ++j)
        if (j < nj) os[(lane * ni + il) * nj + j] = acc[r][j] * inv_c;
    }
  }
  __syncthreads();
  T* ob = out + ((static_cast<size_t>(b) * H + y) * W + x0) * D * D;
  const int per_x = ni * nj;
  const int n = nx * per_x;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int x = e / per_x;
    const int rem = e - x * per_x;
    const int il = rem / nj;
    const int jl = rem - il * nj;
    store_as(ob + static_cast<size_t>(x) * D * D + (i0 + il) * D + j0 + jl, os[e]);
  }
}

template <typename T, int S>
int launch_stride(const T* f1, const T* f2, T* out, int B, int H, int W, int C, int P, int s,
                  cudaStream_t stream) {
  const int D = 2 * (P / s) + 1;
  const int n_iblk = (D + kDi - 1) / kDi;
  const int n_jblk = (D + kDj - 1) / kDj;
  const int window = kDi * kCk * window_stride(s) + kCk * kTx;
  const int staged_out = kTx * kDi * kDj;
  const int smem = static_cast<int>(sizeof(float)) * (window > staged_out ? window : staged_out);
  cudaError_t err = cudaFuncSetAttribute(corr_fwd_kernel<T, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = C % kCk == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  const dim3 grid((W + kTx - 1) / kTx, H, B * n_iblk * n_jblk);
  corr_fwd_kernel<T, S><<<grid, kThreads, smem, stream>>>(f1, f2, out, H, W, C, P, s, D, n_iblk,
                                                          n_jblk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int P, int s,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || P < 0 || s <= 0 || P % s != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 2) return launch_stride<T, 2>(a, b, o, B, H, W, C, P, s, st);
  if (s == 1) return launch_stride<T, 1>(a, b, o, B, H, W, C, P, s, st);
  return launch_stride<T, 0>(a, b, o, B, H, W, C, P, s, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). Pointers are
// contiguous NHWC device tensors; `stream` is a cudaStream_t.
int unflow_corr_fwd_f32(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                        int P, int s, void* stream) {
  return launch<float>(f1, f2, out, B, H, W, C, P, s, stream);
}

int unflow_corr_fwd_bf16_simt(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                              int P, int s, void* stream) {
  return launch<__nv_bfloat16>(f1, f2, out, B, H, W, C, P, s, stream);
}

}  // extern "C"
