// FlowNetC correlation (cost volume) forward in bf16 on Hopper's tensor cores
// (sm_90a): unflow_corr_fwd_bf16.
//
// Replaces the TPU kernel unflow_tpu/ops/pallas/correlation_mxu.py::corr_fwd_mxu
// ("B4") and takes its formulation, the banded matrix product, but none of its
// blocks. For bf16 NHWC maps (B, H, W, C) and D = 2*(P/s) + 1,
//
//   out[b, y, x, i*D + j] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y + s*i - P, x + s*j - P, c]
//
// with reads of f2 outside the map taken as zero, products and sums in f32 over
// all C channels, one scaling by 1/C and one rounding to bf16. It takes s in
// {1, 2}, D = 21 (FlowNetC's grid: P = 20 with s = 2, P = 10 with s = 1) and C
// a multiple of 16 up to 256; the wrapper sends everything else to the
// FP32-core kernel of correlation_fwd.cu.
//
// What bounds it. 2*B*H*W*D*D*C operations against two maps read and the
// volume written once: at the training shape (16, 40x144, 256) 20.8 GFLOP
// against 176 MB, so device memory bounds it (0.05 ms at 3.35 TB/s; the
// tensor cores need 0.02 ms). What sets the pace in practice is the traffic
// from L2 into shared memory: every f2 row is needed by D output rows and by
// (64 + 2P)/64 column tiles.
//
// Design. One block per (tile of 64 output columns, kRy output rows y, y + s,
// ..., batch element); 4 warps per output row. The tile's columns are split
// by phase (correlation_mma.cuh), and a warp owns one 16-row matrix tile of
// one phase of one output row. It loads its 16 x C slice of f1 straight from
// device memory into the A fragments of mma.sync m16n8k16 and keeps them in
// registers (64 at C = 256) for the whole block. The block walks the
// D + kRy - 1 f2 source rows that its output rows need (rows y and y + s
// share D - 1 of them, so kRy rows cut the traffic from L2 by almost kRy),
// each staged by cp.async into a three-deep ring of row windows, the copy of
// row t + 2 running under the products of row t. Per source row a warp
// multiplies its A (16 x C) with the 40 window columns its band touches (five
// n8 tiles, B fragments by ldmatrix) into 20 f32 sums per thread, which live
// for this displacement row only, and picks the band G[k, k + j], j < D, out
// of the known lanes of the accumulator. The 16 x D results go through a
// warp-private shared-memory tile so that each pixel's D contiguous values
// are written by neighbouring lanes. A source row outside the map is not
// staged and not multiplied: its displacement row is written as zeros.
// kRy is 4 where that still gives every SM a block, else 2 (launch()): more
// rows per block means fewer, longer blocks.

#include "correlation_mma.cuh"

namespace {

using namespace corr_mma;

constexpr int D = kD;
constexpr int kBandCols = 40;                   // window columns per row tile: 15 + D in n8 tiles
constexpr int kNt = kBandCols / 8;              // n8 tiles per row tile
static_assert(kMmaRows - 1 + D <= kBandCols, "the band fits the n8 tiles");
constexpr int kKs = kMaxC / 16;                 // k16 steps at the widest C
constexpr int kOutPitch = 24;                   // bf16 per row of a warp's result tile

template <int S, int kRy>
__global__ void __launch_bounds__(32 * kCombos * kRy, 1)
corr_fwd_mma_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C, int P) {
  constexpr int kThreads = 32 * kCombos * kRy;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int cols = window_cols(S, kBandCols);
  const int pitch = row_pitch_bytes(C);
  const int stage_bytes = S * cols * pitch;
  unsigned char* ring = smem;
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem + kStages * stage_bytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = warp / kCombos;  // which of the block's output rows
  const int q = warp % kCombos;
  const int p = q % S;           // phase
  const int rt = q / S;          // row tile of the phase
  const int x0 = blockIdx.x * kTx;
  const int group = blockIdx.y;
  const int y_base = (group / S) * (S * kRy) + group % S;
  const int y = y_base + S * r;
  const int b = blockIdx.z;
  const int nks = C >> 4;
  constexpr int needed = rows_per_phase(S) + D - 1;
  constexpr int n_src = D + kRy - 1;
  const int lane_shift = lanes_per_pixel_shift(C);

  const size_t plane = static_cast<size_t>(H) * W * C;
  const __nv_bfloat16* f2b = f2 + b * plane;

  // the warp's rows of f1, as A fragments
  const int xa = x0 + S * (rt * kMmaRows + g) + p;       // fragment row g
  const int xb = xa + S * 8;                             // fragment row g + 8
  const bool active = y < H && x0 + S * (rt * kMmaRows) + p < W;
  uint32_t a[kKs][4];
  {
    const __nv_bfloat16* row = f1 + b * plane + static_cast<size_t>(y < H ? y : 0) * W * C;
    const bool in_a = active && xa < W;
    const bool in_b = active && xb < W;
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(row + static_cast<size_t>(in_a ? xa : 0) * C);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(row + static_cast<size_t>(in_b ? xb : 0) * C);
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const bool k_in = ks < nks;
      const int w0 = ks * 8 + t4;  // 32-bit word of channels ks*16 + 2*t4
      a[ks][0] = (k_in && in_a) ? __ldg(pa + w0) : 0u;
      a[ks][1] = (k_in && in_b) ? __ldg(pb + w0) : 0u;
      a[ks][2] = (k_in && in_a) ? __ldg(pa + w0 + 4) : 0u;
      a[ks][3] = (k_in && in_b) ? __ldg(pb + w0 + 4) : 0u;
    }
  }

  auto prefetch = [&](int t) {
    const int ys = y_base - P + S * t;
    if (t < n_src && ys >= 0 && ys < H)
      stage_row_async<S>(ring + (t % kStages) * stage_bytes,
                         f2b + static_cast<size_t>(ys) * W * C, x0 - P, W, C, cols, needed, pitch,
                         kThreads, lane_shift);
    cp_async_commit();
  };

  // lane offsets of the ldmatrix rows inside a stage: n8 tile pairs (0,1) and
  // (2,3) by x4 (matrices: tile, k low / high), tile 4 by x2
  const int k_half = ((lane >> 3) & 1) * 16;
  const int row0 = p * cols + rt * kMmaRows;
  const uint32_t off01 = (row0 + (lane >> 4) * 8 + (lane & 7)) * pitch + k_half;
  const uint32_t off23 = off01 + 16 * pitch;
  const uint32_t off4 = (row0 + 32 + (lane & 7)) * pitch + k_half;
  __nv_bfloat16* tile = tiles + warp * (kMmaRows * kOutPitch);
  const float inv_c = 1.f / static_cast<float>(C);
  constexpr size_t dd = static_cast<size_t>(D) * D;
  __nv_bfloat16* out_row = out + (static_cast<size_t>(b) * H + (y < H ? y : 0)) * W * dd;

  for (int t = 0; t < kStages - 1; ++t) prefetch(t);
  for (int t = 0; t < n_src; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // row t has landed; everyone is done with row t - 1
    prefetch(t + kStages - 1);
    const int i = t - r;
    if (!active || i < 0 || i >= D) continue;

    float acc[kNt][4];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    const int ys = y_base - P + S * t;
    if (ys >= 0 && ys < H) {
      const uint32_t base = smem_addr(ring + (t % kStages) * stage_bytes);
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks) {
        if (ks < nks) {
          uint32_t bq[4];
          ldmatrix_x4(base + off01 + ks * 32, bq);
          mma_bf16(acc[0], a[ks], bq[0], bq[1]);
          mma_bf16(acc[1], a[ks], bq[2], bq[3]);
          ldmatrix_x4(base + off23 + ks * 32, bq);
          mma_bf16(acc[2], a[ks], bq[0], bq[1]);
          mma_bf16(acc[3], a[ks], bq[2], bq[3]);
          uint32_t bp[2];
          ldmatrix_x2(base + off4 + ks * 32, bp);
          mma_bf16(acc[4], a[ks], bp[0], bp[1]);
        }
      }
    }

    // the band: accumulator (row, column n) is displacement j = n - row
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = g + (c >> 1) * 8;
        const int j = nt * 8 + 2 * t4 + (c & 1) - row;
        if (j >= 0 && j < D) tile[row * kOutPitch + j] = __float2bfloat16(acc[nt][c] * inv_c);
      }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < kMmaRows * D; e += 32) {
      const int row = e / D;
      const int j = e - row * D;
      const int x = x0 + S * (rt * kMmaRows + row) + p;
      if (x < W) out_row[static_cast<size_t>(x) * dd + i * D + j] = tile[row * kOutPitch + j];
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

template <int S, int kRy>
int launch_rows(const __nv_bfloat16* f1, const __nv_bfloat16* f2, __nv_bfloat16* out, int B,
                int H, int W, int C, int P, cudaStream_t stream) {
  constexpr int kWarps = kCombos * kRy;
  const int smem = kStages * S * window_cols(S, kBandCols) * row_pitch_bytes(C) +
                   kWarps * kMmaRows * kOutPitch * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(corr_fwd_mma_kernel<S, kRy>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_blocks(H, S, kRy);
  const dim3 grid((W + kTx - 1) / kTx, groups, B);
  corr_fwd_mma_kernel<S, kRy><<<grid, 32 * kWarps, smem, stream>>>(f1, f2, out, H, W, C, P);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_stride(bool many, const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* o,
                  int B, int H, int W, int C, int P, cudaStream_t st) {
  return many ? launch_rows<S, 4>(a, b, o, B, H, W, C, P, st)
              : launch_rows<S, 2>(a, b, o, B, H, W, C, P, st);
}

inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Output rows per block: 4 where that still gives each SM a block, else 2.
int launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C, int P, int s,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC || C % 16 != 0 || P < 0 ||
      (s != 1 && s != 2) || P % s != 0 || 2 * (P / s) + 1 != D || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(f1) % 16 != 0 || reinterpret_cast<uintptr_t>(f2) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(f1);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(f2);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool many = row_blocks(H, s, 4) * ((W + kTx - 1) / kTx) * B >= sms;
  return s == 2 ? launch_stride<2>(many, a, b, o, B, H, W, C, P, st)
                : launch_stride<1>(many, a, b, o, B, H, W, C, P, st);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success), cudaErrorInvalidValue
// for a geometry the kernel does not take. Pointers are contiguous bf16 NHWC
// device tensors, 16-byte aligned; `stream` is a cudaStream_t.
int unflow_corr_fwd_bf16(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                         int P, int s, void* stream) {
  return launch(f1, f2, out, B, H, W, C, P, s, stream);
}

}  // extern "C"
