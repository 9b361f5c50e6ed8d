// Both gradients of the FlowNetC correlation in bf16 on Hopper's tensor cores
// (sm_90a): unflow_corr_bwd_f1_bf16 and unflow_corr_bwd_f2_bf16.
//
// They replace the TPU kernels
// unflow_tpu/ops/pallas/correlation_mxu.py::corr_bwd_f1_mxu ("B5") and
// ::corr_bwd_f2_mxu ("B6") and take their formulation, a banded matrix
// product, but none of their blocks (no pre-shifted cotangent, no rotating band
// buffer). With bf16 NHWC maps (B, H, W, C), the bf16 cotangent g
// (B, H, W, D*D) and D = 2*(P/s) + 1,
//
//   df1[b, y, x, c] = (1/C) * sum_{i,j} g[b, y, x, i*D + j] * f2[b, y + s*i - P, x + s*j - P, c]
//   df2[b, u, v, c] = (1/C) * sum_{i,j} g[b, y, x, i*D + j] * f1[b, y, x, c],
//                     y = u + P - s*i,  x = v + P - s*j,
//
// with g and the maps zero outside the map, products and sums in f32 over all
// D*D displacements, one scaling by 1/C and one rounding to bf16. df2 is a
// gather: no atomics. They take s in {1, 2}, D = 21 (FlowNetC's grid: P = 20
// with s = 2, P = 10 with s = 1) and C a multiple of 16 up to 256; the wrapper
// sends everything else to the FP32-core kernels of correlation_bwd.cu.
//
// What bounds them. 2*B*H*W*D*D*C operations against g and one map read and
// one map written: at the training shape (16, 40x144, 256) 20.8 GFLOP against
// 176 MB, so device memory bounds them (0.05 ms at 3.35 TB/s). In practice the
// number of instructions sets the pace (staging, the band, the products), then
// the traffic from L2 into shared memory: every map row is needed by D output
// rows and by (64 + 2P)/64 column tiles.
//
// Design, one body for both (Wrt says which). One block per (tile of 64
// output columns, kRy = 2 output rows of one row phase, batch element); 16
// warps. The tile's columns are split by phase (correlation_mma.cuh); a warp
// owns one 16-row matrix tile of one phase and 64 of the C channels for each of
// the block's output rows, 32 f32 sums per thread and row that persist over the
// displacement rows. The two output rows meet the same source row of the other
// map at displacement rows i and i + 1, so two rows per block halve the traffic
// from L2 and share every B fragment. For each source row inside the map (the
// others are skipped by the whole block) the block
//   * stages the other map's row window by cp.async into a three-deep ring,
//     the copy of row n + 2 running under the products of row n (B operand,
//     read by ldmatrix.trans: window column = K, channel = N);
//   * builds, per matrix tile and output row, the 16 x 48 band matrix A^ in
//     shared memory. Tile row k and window column m meet at j = m - k:
//       df1: A^[k, m] = g[y, tile row k's pixel, i*D + (m-k)]: the D values of
//            one displacement row of the tile's own pixels, contiguous in g;
//       df2: A^[k, m] = g[source row, window column m's pixel, i*D + (D-1) - (m-k)]
//     for 0 <= m-k < D. A pixel of g is 441 bf16 = 882 bytes, so no 16-byte
//     copy can address the contiguous values g[., x, i*D ..]: they are read
//     with 2-byte loads, neighbouring threads on neighbouring values, into
//     registers one source row ahead and scattered into the other of two A^
//     buffers after this row's products. The 16*D band entries of a tile are
//     dealt to the threads once per block (3 per thread and output row; each
//     thread's pixel and A^ entry stay fixed, only the row of g moves). The
//     zeros of A^ (off the band, and columns 36..47 that pad K to three k16
//     steps) never move and are written once per block; band entries whose
//     pixel lies outside the map are written as zeros every time.
// Then 3 k16 steps x 8 n8 tiles of mma.sync m16n8k16 per warp and output row.
// Window columns past the band are staged as zeros, so the padded K steps add
// 0 * 0. The two kernels differ in the order of the source rows (df1 walks
// y + s*i - P upwards, df2 u + P - s*i downwards), in the band index and in
// whose pixels the cotangent is read at.

#include "correlation_mma.cuh"

namespace {

using namespace corr_mma;

constexpr int D = kD;
constexpr int kRy = 2;                           // output rows per block
constexpr int kCg = 64;                          // channels per warp
constexpr int kWarps = kCombos * (kMaxC / kCg);  // 16
constexpr int kThreads = 32 * kWarps;            // 512
constexpr int kBandK = 48;                       // columns of A^: 15 + D in k16 steps
constexpr int kBandPitch = kBandK + 8;           // bf16 per row of A^ (padding: see the header)
constexpr int kBandElems = kCombos * kMmaRows * kBandPitch;  // one A^ buffer, all matrix tiles
constexpr int kGPer = (kCombos * kMmaRows * D + kThreads - 1) / kThreads;  // band entries per thread: 3
constexpr int kNt = kCg / 8;                     // n8 tiles per warp
static_assert(kMmaRows - 1 + D <= kBandK, "the band fits the k16 steps");

enum class Wrt { kF1, kF2 };

// `f` is the other map (f2 for df1, f1 for df2), `out` the gradient.
template <int S, Wrt kWrt>
__device__ __forceinline__ void corr_bwd_mma_body(const __nv_bfloat16* __restrict__ g,
                                                  const __nv_bfloat16* __restrict__ f,
                                                  __nv_bfloat16* __restrict__ out, int H, int W,
                                                  int C, int P) {
  constexpr bool kF1 = kWrt == Wrt::kF1;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int cols = window_cols(S, kBandK);
  const int pitch = row_pitch_bytes(C);
  const int stage_bytes = S * cols * pitch;
  unsigned char* ring = smem;
  // A^ buffers: [2 (step parity)][kRy][kBandElems]
  __nv_bfloat16* band = reinterpret_cast<__nv_bfloat16*>(smem + kStages * stage_bytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = warp % kCombos;
  const int cg0 = (warp / kCombos) * kCg;
  const int p = q % S;
  const int rt = q / S;
  const int x0 = blockIdx.x * kTx;
  const int group = blockIdx.y;
  const int u0 = (group / S) * (S * kRy) + group % S;  // output rows u0 + S*r
  const int b = blockIdx.z;
  constexpr int needed = rows_per_phase(S) + D - 1;
  const int lane_shift = lanes_per_pixel_shift(C);
  constexpr size_t dd = static_cast<size_t>(D) * D;
  const size_t plane = static_cast<size_t>(H) * W;
  const __nv_bfloat16* fb = f + b * plane * C;
  const __nv_bfloat16* gb = g + b * plane * dd;

  // Source rows y(t), t = 0 .. D + kRy - 2. df1: y(t) = u0 - P + S*t, and
  // output row r meets y(t) at displacement row i = t - r. df2:
  // y(t) = y_top - S*t, met at i = t - (kRy - 1 - r). Those inside the map are
  // the steps t_first .. t_first + n_steps - 1.
  const int y_top = u0 + S * (kRy - 1) + P;
  const int y_low = u0 - P;
  const int t_first = kF1 ? (y_low >= 0 ? 0 : (-y_low + S - 1) / S)
                          : (y_top < H ? 0 : (y_top - H) / S + 1);
  const int t_last = min(D + kRy - 2, kF1 ? (H - 1 - y_low) / S : y_top / S);
  const int n_steps = t_last - t_first + 1;
  auto source_row = [&](int n) {
    return kF1 ? y_low + S * (t_first + n) : y_top - S * (t_first + n);
  };

  // This thread's share of the band: entry e of the 16*D entries of a matrix
  // tile, counted pixel by pixel and, within a pixel, along its contiguous
  // displacement columns j, so that neighbouring threads read neighbouring
  // values of g. df1: the pixel is tile row k, with all D entries (k, k + j).
  // df2: the pixel is window column ml of the tile, with the entries
  // k = max(0, ml-D+1) .. min(15, ml), at j = D-1 - (ml-k).
  int g_off[kGPer];  // offset in a row of g, -1: pixel outside the map (a zero)
  int s_off[kGPer];  // entry of A^, -1: nothing to write
  {
    constexpr int per_combo = kMmaRows * D;
#pragma unroll
    for (int n = 0; n < kGPer; ++n) {
      const int e = threadIdx.x + n * kThreads;
      const int cq = e / per_combo;
      int rem = e - cq * per_combo;
      int k, j, ml, x;
      if constexpr (kF1) {
        k = rem / D;
        j = rem - k * D;
        ml = k + j;
        x = x0 + S * ((cq / S) * kMmaRows + k) + cq % S;
      } else {
        for (ml = 0;; ++ml) {
          const int count = min(kMmaRows - 1, ml) - max(0, ml - D + 1) + 1;
          if (rem < count || ml >= kMmaRows + D - 2) break;
          rem -= count;
        }
        k = max(0, ml - D + 1) + rem;
        j = D - 1 - (ml - k);
        x = x0 - P + S * ((cq / S) * kMmaRows + ml) + cq % S;
      }
      const bool wanted = cq < kCombos;
      s_off[n] = wanted ? (cq * kMmaRows + k) * kBandPitch + ml : -1;
      g_off[n] = (wanted && x >= 0 && x < W) ? x * D * D + j : -1;
    }
  }

  auto prefetch = [&](int n) {
    if (n < n_steps) {
      stage_row_async<S>(ring + (n % kStages) * stage_bytes,
                         fb + static_cast<size_t>(source_row(n)) * W * C,
                         x0 - P, W, C, cols, needed, pitch, kThreads, lane_shift);
    }
    cp_async_commit();
  };
  // displacement row of output row r at step n; outside [0, D): nothing to add
  auto disp_row = [&](int n, int r) { return t_first + n - (kF1 ? r : kRy - 1 - r); };
  auto row_live = [&](int n, int r) {
    const int i = disp_row(n, r);
    return i >= 0 && i < D && u0 + S * r < H;
  };
  unsigned short g_val[kRy][kGPer];
  auto load_g = [&](int n) {
#pragma unroll
    for (int r = 0; r < kRy; ++r) {
      if (!row_live(n, r)) continue;
      // the cotangent's row: the output row's own (df1), the source row (df2)
      const int y = kF1 ? u0 + S * r : source_row(n);
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          gb + static_cast<size_t>(y) * W * dd + disp_row(n, r) * D);
#pragma unroll
      for (int m = 0; m < kGPer; ++m) g_val[r][m] = g_off[m] >= 0 ? __ldg(src + g_off[m]) : 0;
    }
  };
  auto store_g = [&](int n) {
#pragma unroll
    for (int r = 0; r < kRy; ++r) {
      if (!row_live(n, r)) continue;
      unsigned short* dst =
          reinterpret_cast<unsigned short*>(band + ((n & 1) * kRy + r) * kBandElems);
#pragma unroll
      for (int m = 0; m < kGPer; ++m)
        if (s_off[m] >= 0) dst[s_off[m]] = g_val[r][m];
    }
  };

  for (int n = 0; n < kStages - 1; ++n) prefetch(n);
  for (int e = threadIdx.x; e < kRy * kBandElems; e += kThreads)  // 2 * kRy buffers of bf16, as words
    reinterpret_cast<uint32_t*>(band)[e] = 0u;
  __syncthreads();  // the zeros are down before any band entry is written
  load_g(0);
  store_g(0);

  float acc[kRy][kNt][4];
#pragma unroll
  for (int r = 0; r < kRy; ++r)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][nt][c] = 0.f;

  // ldmatrix rows: A^ tile rows (x4: rows 0-7 / 8-15, k low / high); window
  // rows of the stage (x4.trans: k low / high, channels +0 / +8)
  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = ((q * kMmaRows + frag_row) * kBandPitch + (lane >> 4) * 8) * 2;
  const uint32_t b_off = (p * cols + rt * kMmaRows + frag_row) * pitch + (cg0 + (lane >> 4) * 8) * 2;
  const bool active = cg0 < C && x0 + S * (rt * kMmaRows) + p < W;

  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // row n and its A^ are in place; everyone is done with row n - 1
    prefetch(n + kStages - 1);
    const bool more = n + 1 < n_steps;
    if (more) load_g(n + 1);
    if (active) {
      const uint32_t b_base = smem_addr(ring + (n % kStages) * stage_bytes) + b_off;
      bool live[kRy];
      uint32_t a_base[kRy];
#pragma unroll
      for (int r = 0; r < kRy; ++r) {
        live[r] = row_live(n, r);
        a_base[r] = smem_addr(band + ((n & 1) * kRy + r) * kBandElems) + a_off;
      }
#pragma unroll
      for (int kk = 0; kk < kBandK / 16; ++kk) {
        uint32_t a[kRy][4];
#pragma unroll
        for (int r = 0; r < kRy; ++r)
          if (live[r]) ldmatrix_x4(a_base[r] + kk * 32, a[r]);
#pragma unroll
        for (int pr = 0; pr < kNt / 2; ++pr) {
          if (cg0 + pr * 16 < C) {
            uint32_t bq[4];
            ldmatrix_x4_trans(b_base + kk * 16 * pitch + pr * 32, bq);
#pragma unroll
            for (int r = 0; r < kRy; ++r) {
              if (live[r]) {
                mma_bf16(acc[r][2 * pr], a[r], bq[0], bq[1]);
                mma_bf16(acc[r][2 * pr + 1], a[r], bq[2], bq[3]);
              }
            }
          }
        }
      }
    }
    if (more) store_g(n + 1);  // into the buffers that row n - 1 used
  }
  cp_async_wait<0>();

  if (active) {
    const float inv_c = 1.f / static_cast<float>(C);
    const int gq = lane >> 2;
    const int t4 = lane & 3;
#pragma unroll
    for (int r = 0; r < kRy; ++r) {
      const int u = u0 + S * r;
      if (u >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int v = x0 + S * (rt * kMmaRows + gq + half * 8) + p;
        if (v >= W) continue;
        __nv_bfloat16* dst = out + ((b * plane + static_cast<size_t>(u) * W + v) * C);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int c = cg0 + nt * 8 + 2 * t4;
          if (c < C)
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(
                acc[r][nt][2 * half] * inv_c, acc[r][nt][2 * half + 1] * inv_c);
        }
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
corr_bwd_f1_mma_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f2,
                       __nv_bfloat16* __restrict__ df1, int H, int W, int C, int P) {
  corr_bwd_mma_body<S, Wrt::kF1>(g, f2, df1, H, W, C, P);
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
corr_bwd_f2_mma_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ f1,
                       __nv_bfloat16* __restrict__ df2, int H, int W, int C, int P) {
  corr_bwd_mma_body<S, Wrt::kF2>(g, f1, df2, H, W, C, P);
}

template <int S, Wrt kWrt>
int launch_stride(const __nv_bfloat16* g, const __nv_bfloat16* f, __nv_bfloat16* out, int B,
                  int H, int W, int C, int P, cudaStream_t stream) {
  const int smem = kStages * S * window_cols(S, kBandK) * row_pitch_bytes(C) +
                   2 * kRy * kBandElems * static_cast<int>(sizeof(__nv_bfloat16));
  auto kernel = kWrt == Wrt::kF1 ? corr_bwd_f1_mma_kernel<S> : corr_bwd_f2_mma_kernel<S>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = row_blocks(H, S, kRy);
  const dim3 grid((W + kTx - 1) / kTx, groups, B);
  kernel<<<grid, kThreads, smem, stream>>>(g, f, out, H, W, C, P);
  return static_cast<int>(cudaGetLastError());
}

template <Wrt kWrt>
int launch(const void* g, const void* f, void* out, int B, int H, int W, int C, int P, int s,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxC || C % 16 != 0 || P < 0 ||
      (s != 1 && s != 2) || P % s != 0 || 2 * (P / s) + 1 != D || B > 65535 || H > 65535 ||
      static_cast<long long>(W) * D * D > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(f) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(g);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(f);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s == 2 ? launch_stride<2, kWrt>(a, b, o, B, H, W, C, P, st)
                : launch_stride<1, kWrt>(a, b, o, B, H, W, C, P, st);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success),
// cudaErrorInvalidValue for a geometry the kernels do not take. `g` is the
// contiguous bf16 (B, H, W, D*D) cotangent, the other map (`f2` / `f1`) and the
// gradient contiguous bf16 NHWC maps, 16-byte aligned; `stream` is a
// cudaStream_t.
int unflow_corr_bwd_f1_bf16(const void* g, const void* f2, void* df1, int B, int H, int W, int C,
                            int P, int s, void* stream) {
  return launch<Wrt::kF1>(g, f2, df1, B, H, W, C, P, s, stream);
}

int unflow_corr_bwd_f2_bf16(const void* g, const void* f1, void* df2, int B, int H, int W, int C,
                            int P, int s, void* stream) {
  return launch<Wrt::kF2>(g, f1, df2, B, H, W, C, P, s, stream);
}

}  // extern "C"
