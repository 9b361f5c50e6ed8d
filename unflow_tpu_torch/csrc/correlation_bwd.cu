// Gradients of the FlowNetC correlation (cost volume) for Hopper (sm_90a).
//
// Replaces four TPU kernels of the JAX package:
//   * unflow_tpu/ops/pallas/correlation.py::_corr_bwd_f1_chunk (f32, "B2"):
//     unflow_corr_bwd_f1_f32;
//   * unflow_tpu/ops/pallas/correlation.py::_corr_bwd_f2_chunk (f32, "B3"):
//     unflow_corr_bwd_f2_f32;
//   * unflow_tpu/ops/pallas/correlation_mxu.py::corr_bwd_f1_mxu (bf16, "B5"):
//     unflow_corr_bwd_f1_bf16_simt;
//   * unflow_tpu/ops/pallas/correlation_mxu.py::corr_bwd_f2_mxu (bf16, "B6"):
//     unflow_corr_bwd_f2_bf16_simt;
//     the two bf16 instantiations for the geometries that the tensor-core
//     kernels of correlation_bwd_mma.cu do not take.
//
// With NHWC maps (B, H, W, C), the cotangent g (B, H, W, D*D) of the cost
// volume (channel i*D + j, dy = s*i - P, dx = s*j - P, D = 2*(P/s) + 1):
//
//   df1[b, y, x, c] = (1/C) * sum_{i,j} g[b, y, x, i*D + j] * f2[b, y + dy, x + dx, c]
//   df2[b, u, v, c] = (1/C) * sum_{i,j} g[b, u - dy, v - dx, i*D + j] * f1[b, u - dy, v - dx, c]
//
// with reads outside the map taken as zero. g has the type of the maps;
// products and sums are f32 over all D*D displacements, scaled once by 1/C
// and cast once to the maps' type (for bf16: bf16 in, f32 sums, bf16 out).
// df2 is a gather over the 441 source pixels of each output pixel, so
// neither kernel needs atomics.
//
// What bounds them. Each gradient is 2*B*H*W*D*D*C operations against
// reading g and one map and writing one map. At the training shape
// (B=16, 40x144, C=256, D=21) that is 20.8 GFLOP against 351 MB (f32) or
// 176 MB (bf16): f32 is bound by FP32 FMA throughput (~0.31 ms at
// 67 TFLOP/s), bf16 by memory (~0.05 ms at 3.35 TB/s).
//
// Design, the same for both gradients. One block per (64-channel group,
// 32-column tile, output row, batch element); each lane owns one output
// column and each of the 8 warps owns 8 channels, so a thread keeps 8 f32
// sums in registers for the whole displacement loop. The block walks the D
// displacement rows i; a row whose source row lies outside the map is
// skipped. For each i it stages, converted to f32 and zero outside the map,
//   * the source row segment of the other map, (32 + s*(D-1)) columns by 64
//     channels, as [channel][column];
//   * the D cotangent values of displacement row i, as [j][column]: for df1
//     those of the block's own 32 pixels (g[y, x, i*D .. i*D + D-1] is
//     contiguous); for df2 those of the window's source pixels, where
//     output column v needs g[u - dy, v - dx, i*D + j], one value from each
//     of D different pixels. Read straight from device memory that would be
//     a stride of D*D elements across the lanes of a warp; staged, the lanes
//     read consecutive shared-memory words. Only the (column, j) pairs that
//     some lane of the tile reads are loaded.
// Then each thread runs D x 8 FMAs: one cotangent value (shared by its 8
// channels) times 8 map values, lanes on consecutive words (no bank
// conflicts). The channel group is the fastest grid index, so the 4 blocks
// that stage the same cotangent tile run together and find it in L2.
// Each thread writes its 8 contiguous channels with one or two 16-byte
// stores.
// Not done yet: register tiling across x (columns x and x + s share map
// values, as the forward of correlation_fwd.cu uses), which would cut the
// shared-memory reads per FMA from 9/8. The bf16 maps of the usual widths run
// on the tensor cores, in correlation_bwd_mma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;      // output columns per block, one per lane
constexpr int kWarps = 8;    // warps per block
constexpr int kCk = 8;       // channels per thread
constexpr int kCg = kWarps * kCk;  // channels per block (64)
constexpr int kThreads = kTx * kWarps;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Eight sums, scaled, to channels [c0, c0 + 8) of one output pixel.
__device__ __forceinline__ void store8(float* dst, bool vec, int c0, int C, const float v[kCk]) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kCk; ++k)
      if (c0 + k < C) dst[k] = v[k];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, bool vec, int c0, int C, const float v[kCk]) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < kCk / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(dst) = u;
  } else {
#pragma unroll
    for (int k = 0; k < kCk; ++k)
      if (c0 + k < C) dst[k] = __float2bfloat16(v[k]);
  }
}

__host__ __device__ constexpr int window_cols(int s, int D) { return kTx + s * (D - 1); }
// Odd row stride: staging stores and inner-loop reads stay free of bank
// conflicts.
__host__ __device__ constexpr int window_stride(int s, int D) { return window_cols(s, D) | 1; }

// Row `row` of map `fb` (one batch element), columns [xw0, xw0 + cols),
// channels [cg0, cg0 + 64), into ms[channel][column] as f32; zero outside
// the map.
template <typename T>
__device__ __forceinline__ void stage_map_row(const T* __restrict__ fb, float* ms, int row, int xw0,
                                              int cols, int colp, int cg0, int W, int C, bool vec) {
  for (int u = threadIdx.x; u < (kCg / kCk) * cols; u += kThreads) {
    const int c8 = u / cols;
    const int col = u - c8 * cols;
    const int x = xw0 + col;
    const int c0 = cg0 + c8 * kCk;
    const bool inside = x >= 0 && x < W && c0 < C;
    float v[kCk];
    load8(inside ? fb + (static_cast<size_t>(row) * W + x) * C + c0 : nullptr, vec, c0, C, v);
#pragma unroll
    for (int k = 0; k < kCk; ++k) ms[(c8 * kCk + k) * colp + col] = v[k];
  }
}

// The block's position, shared by both kernels.
struct Tile {
  int cg0, x0, row, b;
};

__device__ __forceinline__ Tile tile_of_block(int n_cg) {
  Tile t;
  t.cg0 = (blockIdx.x % n_cg) * kCg;
  t.x0 = (blockIdx.x / n_cg) * kTx;
  t.row = blockIdx.y;
  t.b = blockIdx.z;
  return t;
}

// df1: S > 0 fixes the stride at compile time (the inner loop's addresses
// become immediates); S == 0 takes `s_run`.
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
corr_bwd_f1_kernel(const T* __restrict__ g, const T* __restrict__ f2, T* __restrict__ df1,
                   int H, int W, int C, int P, int s_run, int D, int n_cg, bool vec) {
  extern __shared__ float smem[];
  const int s = S > 0 ? S : s_run;
  const int cols = window_cols(s, D);
  const int colp = window_stride(s, D);
  float* ms = smem;                 // [kCg][colp]   f2 row window
  float* gs = smem + kCg * colp;    // [D][kTx + 1]  cotangent of the tile, row i

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Tile t = tile_of_block(n_cg);
  const int y = t.row;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f2b = f2 + t.b * plane * C;
  const T* gb = g + (t.b * plane + static_cast<size_t>(y) * W) * D * D;
  const int nx = min(kTx, W - t.x0);

  float acc[kCk];
#pragma unroll
  for (int k = 0; k < kCk; ++k) acc[k] = 0.f;

  for (int i = 0; i < D; ++i) {
    const int y2 = y + s * i - P;
    if (y2 < 0 || y2 >= H) continue;  // the same for the whole block
    __syncthreads();                  // the previous row's reads are done
    stage_map_row(f2b, ms, y2, t.x0 - P, cols, colp, t.cg0, W, C, vec);
    for (int e = threadIdx.x; e < kTx * D; e += kThreads) {
      const int x = e / D;
      const int j = e - x * D;
      gs[j * (kTx + 1) + x] =
          x < nx ? to_float(gb[static_cast<size_t>(t.x0 + x) * D * D + i * D + j]) : 0.f;
    }
    __syncthreads();
    const float* mrow = ms + (warp * kCk) * colp + lane;
#pragma unroll 3
    for (int j = 0; j < D; ++j) {
      const float gv = gs[j * (kTx + 1) + lane];
#pragma unroll
      for (int k = 0; k < kCk; ++k) acc[k] = fmaf(gv, mrow[k * colp + s * j], acc[k]);
    }
  }

  const int x = t.x0 + lane;
  const int c0 = t.cg0 + warp * kCk;
  if (x < W && c0 < C) {
    const float inv_c = 1.f / static_cast<float>(C);
#pragma unroll
    for (int k = 0; k < kCk; ++k) acc[k] *= inv_c;
    store8(df1 + (t.b * plane + static_cast<size_t>(y) * W + x) * C + c0, vec, c0, C, acc);
  }
}

// df2: output pixel (u, v); displacement (i, j) reads source pixel
// (u + P - s*i, v + P - s*j), which is window column lane + s*(D-1-j).
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
corr_bwd_f2_kernel(const T* __restrict__ g, const T* __restrict__ f1, T* __restrict__ df2,
                   int H, int W, int C, int P, int s_run, int D, int n_cg, bool vec) {
  extern __shared__ float smem[];
  const int s = S > 0 ? S : s_run;
  const int cols = window_cols(s, D);
  const int colp = window_stride(s, D);
  float* ms = smem;                 // [kCg][colp]  f1 row window
  float* gs = smem + kCg * colp;    // [D][colp]    cotangent at the window's pixels, row i

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Tile t = tile_of_block(n_cg);
  const int u = t.row;
  const int xw0 = t.x0 - P;  // map column of window column 0
  const size_t plane = static_cast<size_t>(H) * W;
  const T* f1b = f1 + t.b * plane * C;
  const T* gb = g + t.b * plane * D * D;

  float acc[kCk];
#pragma unroll
  for (int k = 0; k < kCk; ++k) acc[k] = 0.f;

  for (int i = 0; i < D; ++i) {
    const int y = u + P - s * i;
    if (y < 0 || y >= H) continue;  // the same for the whole block
    __syncthreads();                // the previous row's reads are done
    stage_map_row(f1b, ms, y, xw0, cols, colp, t.cg0, W, C, vec);
    const T* grow = gb + static_cast<size_t>(y) * W * D * D + i * D;
    for (int e = threadIdx.x; e < cols * D; e += kThreads) {
      const int col = e / D;
      const int j = e - col * D;
      const int reader = col - s * (D - 1 - j);  // the lane that reads (col, j)
      if (reader < 0 || reader >= kTx) continue;
      const int x = xw0 + col;
      gs[j * colp + col] =
          (x >= 0 && x < W) ? to_float(grow[static_cast<size_t>(x) * D * D + j]) : 0.f;
    }
    __syncthreads();
    const float* mrow = ms + (warp * kCk) * colp + lane;
    const float* grd = gs + lane;
#pragma unroll 3
    for (int j = 0; j < D; ++j) {
      const int off = s * (D - 1 - j);
      const float gv = grd[j * colp + off];
#pragma unroll
      for (int k = 0; k < kCk; ++k) acc[k] = fmaf(gv, mrow[k * colp + off], acc[k]);
    }
  }

  const int v = t.x0 + lane;
  const int c0 = t.cg0 + warp * kCk;
  if (v < W && c0 < C) {
    const float inv_c = 1.f / static_cast<float>(C);
#pragma unroll
    for (int k = 0; k < kCk; ++k) acc[k] *= inv_c;
    store8(df2 + (t.b * plane + static_cast<size_t>(u) * W + v) * C + c0, vec, c0, C, acc);
  }
}

enum class Wrt { kF1, kF2 };

template <typename T, int S, Wrt kWrt>
int launch_stride(const T* g, const T* f, T* out, int B, int H, int W, int C, int P, int s,
                  cudaStream_t stream) {
  const int D = 2 * (P / s) + 1;
  const int n_cg = (C + kCg - 1) / kCg;
  const int colp = window_stride(s, D);
  const int g_words = kWrt == Wrt::kF1 ? D * (kTx + 1) : D * colp;
  const int smem = static_cast<int>(sizeof(float)) * (kCg * colp + g_words);
  auto kernel = kWrt == Wrt::kF1 ? corr_bwd_f1_kernel<T, S> : corr_bwd_f2_kernel<T, S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = C % kCk == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(n_cg * ((W + kTx - 1) / kTx), H, B);
  kernel<<<grid, kThreads, smem, stream>>>(g, f, out, H, W, C, P, s, D, n_cg, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Wrt kWrt>
int launch(const void* g, const void* f, void* out, int B, int H, int W, int C, int P, int s,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || P < 0 || s <= 0 || P % s != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* a = static_cast<const T*>(g);
  const T* b = static_cast<const T*>(f);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 2) return launch_stride<T, 2, kWrt>(a, b, o, B, H, W, C, P, s, st);
  if (s == 1) return launch_stride<T, 1, kWrt>(a, b, o, B, H, W, C, P, s, st);
  return launch_stride<T, 0, kWrt>(a, b, o, B, H, W, C, P, s, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). `g` is the
// contiguous (B, H, W, D*D) cotangent, `f2`/`f1` the contiguous NHWC map the
// gradient is contracted with, `df1`/`df2` the contiguous NHWC output;
// `stream` is a cudaStream_t.
int unflow_corr_bwd_f1_f32(const void* g, const void* f2, void* df1, int B, int H, int W, int C,
                           int P, int s, void* stream) {
  return launch<float, Wrt::kF1>(g, f2, df1, B, H, W, C, P, s, stream);
}

int unflow_corr_bwd_f2_f32(const void* g, const void* f1, void* df2, int B, int H, int W, int C,
                           int P, int s, void* stream) {
  return launch<float, Wrt::kF2>(g, f1, df2, B, H, W, C, P, s, stream);
}

int unflow_corr_bwd_f1_bf16_simt(const void* g, const void* f2, void* df1, int B, int H, int W,
                                 int C, int P, int s, void* stream) {
  return launch<__nv_bfloat16, Wrt::kF1>(g, f2, df1, B, H, W, C, P, s, stream);
}

int unflow_corr_bwd_f2_bf16_simt(const void* g, const void* f1, void* df2, int B, int H, int W,
                                 int C, int P, int s, void* stream) {
  return launch<__nv_bfloat16, Wrt::kF2>(g, f1, df2, B, H, W, C, P, s, stream);
}

}  // extern "C"
