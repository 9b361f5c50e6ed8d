// FlowNetC correlation (cost volume) forward for Hopper (sm_90a), on the FP32
// cores.
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
// with reads of f2 outside the map taken as zero, products and sums kept in
// f32 and the result cast to the input type. The output (B, H, W, D*D) keeps
// dy (i) as the slower axis.
//
// What bounds it. The work is 2*B*H*W*D*D*C operations against reading f1
// and f2 once and writing the cost volume once. At FlowNetC's eval shape
// (B=4, 48x160, C=256, D=21) that is 6.94 GFLOP against 63 MB (bf16) or
// 117 MB (f32) of traffic: the f32 path is bound by FP32 FMA throughput
// (~104 us at 67 TFLOP/s), the bf16 path by memory (~17.5 us at 3.35 TB/s).
// An SM reads 32 shared-memory words per clock and does 128 FMAs, so a kernel
// that reads one word per FMA cannot pass a quarter of the FP32 rate: the
// design below reads 1/3 of a word per FMA, as 16-byte loads.
//
// Design: register tiling across x. Output columns x and x + s read the same
// f2 value at displacement columns j and j - 1, so a thread owns kCols = 4
// columns x, x + s, x + 2s, x + 3s (a "group") of one output row and one
// displacement row i, with all J displacement columns of its block: 4*J f32
// sums (84 for J = 21) that live in registers for the whole channel loop. Per
// four channels it loads its 4 f1 pixels and the J + 3 f2 pixels of its window
// (one 16-byte load each: a pixel's channels are contiguous) for 16*J FMAs.
//   * A block takes 6 groups (24 columns), kRy = 8 output rows of one row
//     phase (y0 + s*r) and kDi = 7 displacement rows: 56 (row, i) pairs x 6
//     groups = 336 threads, which leaves each thread 168 registers (84 sums,
//     16 f1 values, the window values in flight; 8 groups at 128 registers
//     spill and are slower). The 56 pairs read only kRy + kDi - 1 = 14 f2
//     source rows (row r and displacement row i meet source row
//     y0 + s*(r + i) - P), a quarter of what one output row per block stages.
//     Blocks along z cover the D displacement rows in sevens and the
//     displacement columns in blocks of J (J = 11 where D <= 11, else 21): a
//     grid smaller than 21 x 21 does its own work only.
//   * Channels go in steps of 16 (8 for a run-time stride) through two
//     shared-memory stages filled by 16-byte cp.async (zero fill by source
//     size 0 outside the map), the copy of step n + 1 in flight under the FMAs
//     of step n, one barrier per step. Where each staged pixel comes from and
//     goes to is worked out once per block into a table in shared memory: a
//     copy costs a table read and an add, and neighbouring threads copy the
//     pieces of one pixel. Pixels outside the map are zeroed once in both
//     stages and left out of the table: a block at the map's edge copies only
//     what exists. Staged data keeps the maps' type (bf16 converts when read)
//     and layout [row][column][channel]; a row is padded by 16 bytes so that
//     the threads of a quarter warp, which differ in their source row only,
//     read eight different bank groups (or the same address). Maps whose C is
//     no multiple of 8 or that are not 16-byte aligned are staged by plain
//     loads.
//   * A pair whose source row lies outside the map has nothing to add and
//     skips the FMAs. The pairs are dealt to the threads in the order of their
//     source row, eight of one group to a quarter warp, so that those pairs
//     fill whole warps at the top and the bottom of the map.
//   * Window columns are stored by phase: a group's window is contiguous
//     whatever s is, so the inner loop is the same for every stride. For
//     s = 1 the 6 groups share one window of 24 + J - 1 columns, for s = 2 the
//     3 groups of a phase share one of 12 + J - 1; for a run-time stride each
//     group stages its own 4 + J - 1 columns (no sharing, any s).
//   * The results go through shared memory, one output row at a time, so that
//     each pixel's contiguous run of displacement values is written by
//     neighbouring threads; where each thread's share goes is worked out once.
// What sets the pace now: the FMAs' instruction slots (two thirds of the time)
// and the 16-byte copies, which cost instruction and load/store slots whether
// or not they read anything and overlap the FMAs only in part; a bulk (TMA)
// copy of the windows is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;      // output columns per thread: x, x + s, x + 2s, x + 3s
constexpr int kGroups = 6;    // column groups per block (even: s = 2 has two phases)
constexpr int kPx = kGroups * kCols;  // output pixels per block and row (24)
constexpr int kRy = 8;        // output rows per block, y0 + s*r
constexpr int kDi = 7;        // displacement rows per block
constexpr int kPairs = kRy * kDi;
constexpr int kThreads = kGroups * kPairs;  // 336
constexpr int kSrc = kRy + kDi - 1;         // f2 source rows per block (14)
constexpr int kQuad = 4;      // channels per vector load
static_assert(kPairs % 8 == 0, "a quarter warp stays within one group");
static_assert(kGroups % 2 == 0, "s = 2 has a window slot per phase");

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four channels of one staged pixel, as f32, by one vector load.
__device__ __forceinline__ void load_quad(const float* p, float v[kQuad]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float v[kQuad]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);  // a bf16 is the upper half of its f32
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The shared-memory layout of one instantiation. S: 1, 2 or 0 (run-time
// stride); J: displacement columns per block and thread.
template <typename T, int S, int J>
struct Tile {
  // Window slots (windows that groups share): one for s = 1, one per phase for
  // s = 2, one per group for a run-time stride.
  static constexpr int kSlots = S == 1 ? 1 : (S == 2 ? 2 : kGroups);
  // Columns of one slot: its groups' columns and the J - 1 beyond.
  static constexpr int kSlotCols = kCols * (kGroups / kSlots) + J - 1;
  static constexpr int kWindowCols = kSlots * kSlotCols;
  // Channels per stage (the run-time stride's windows are the widest)
  static constexpr int kCk = S == 0 ? 8 : 16;
  static constexpr int kPixelBytes = kCk * static_cast<int>(sizeof(T));
  // Bytes of a staged f2 row and of a staged f1 row; the 16 bytes of padding
  // make the pitch an odd number of 16-byte units.
  static constexpr int kWindowPitch = kWindowCols * kPixelBytes + 16;
  static constexpr int kTilePitch = kPx * kPixelBytes + 16;
  static constexpr int kTilesAt = kSrc * kWindowPitch;  // the f1 rows follow the f2 rows
  static constexpr int kStageBytes = kTilesAt + kRy * kTilePitch;
  // Staged pixels per step, and the table that says where each comes from.
  static constexpr int kPixels = kSrc * kWindowCols + kRy * kPx;
  static constexpr int kTableBytes = kPixels * static_cast<int>(sizeof(int2));
  static constexpr int kResultBytes = kPx * kDi * J * static_cast<int>(sizeof(float));
  static constexpr int kSmemBytes =
      kTableBytes + (2 * kStageBytes > kResultBytes ? 2 * kStageBytes : kResultBytes);
};

// First column of column group G: the map's columns go in runs of 4*s, each
// holding one group per phase p: columns 4*s*u + p + s*k, k < 4.
__device__ __forceinline__ int group_first_column(int G, int s) {
  return kCols * s * (G / s) + G % s;
}

// S > 0 fixes the stride at compile time; S == 0 takes `s_run`.
template <typename T, int S, int J>
__global__ void __launch_bounds__(kThreads, 1)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int H, int W, int C, int P, int s_run, int D, int n_iblk, int n_jblk, bool vec) {
  using L = Tile<T, S, J>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int group_x[kGroups];  // first column of each of the block's groups
  constexpr int kCk = L::kCk;
  constexpr int pxb = L::kPixelBytes;
  constexpr int pieces = pxb / 16;  // 16-byte pieces of a staged pixel
  constexpr int per_piece = 16 / static_cast<int>(sizeof(T));
  // table[n], n < n_inside: a staged pixel that lies inside the map. .x its
  // first channel as an offset into its map of this batch element; .y its
  // byte offset in a stage, plus kFromF1 for a pixel of f1
  constexpr int kFromF1 = 1 << 30;
  __shared__ int n_inside;
  int2* table = reinterpret_cast<int2*>(smem);
  unsigned char* stages = smem + L::kTableBytes;
  const int s = S > 0 ? S : s_run;

  // Threads go in eights (quarter warps): eight (row, i) pairs of one group.
  // The pairs are counted by their source row t = r + il, so that the pairs
  // whose source row lies outside the map, which have nothing to add, fill
  // whole warps at the top and the bottom of the map; neighbouring eights are
  // the same pairs of the next group.
  const int eight = threadIdx.x >> 3;
  const int g = eight % kGroups;
  int r, il;
  {
    int rest = (eight / kGroups) * 8 + (threadIdx.x & 7);  // the pair's place in the order of t
    int t = 0;
    for (;; ++t) {  // source row t has the pairs r = max(0, t-kDi+1) .. min(kRy-1, t)
      const int count = min(kRy - 1, t) - max(0, t - kDi + 1) + 1;
      if (rest < count) break;
      rest -= count;
    }
    r = max(0, t - kDi + 1) + rest;
    il = t - r;
  }
  const int row_group = blockIdx.y;
  const int y0 = (row_group / s) * (s * kRy) + row_group % s;
  int z = blockIdx.z;
  const int jb = z % n_jblk;
  z /= n_jblk;
  const int ib = z % n_iblk;
  const int b = z / n_iblk;
  const int i0 = ib * kDi;
  const int j0 = jb * J;
  const int src0 = y0 + s * i0 - P;  // f2 row of source row t = 0; row t is src0 + s*t

  if (threadIdx.x < kGroups)
    group_x[threadIdx.x] = group_first_column(blockIdx.x * kGroups + threadIdx.x, s);
  if (threadIdx.x == 0) n_inside = 0;
  __syncthreads();
  // Where each staged pixel comes from: worked out once, read at every step.
  // The pixels outside the map are zeroed here in both stages and never
  // copied: a block at the map's edge stages only what exists.
  for (int px = threadIdx.x; px < L::kPixels; px += kThreads) {
    int x, y, dst;
    const bool from_f1 = px >= kSrc * L::kWindowCols;
    if (!from_f1) {
      const int t = px / L::kWindowCols;
      const int col = px - t * L::kWindowCols;
      const int slot = col / L::kSlotCols;
      x = group_x[slot] - P + s * (j0 + col - slot * L::kSlotCols);  // its first group's
      y = src0 + s * t;
      dst = t * L::kWindowPitch + col * pxb;
    } else {
      const int q = px - kSrc * L::kWindowCols;
      const int rr = q / kPx;
      const int col = q - rr * kPx;
      x = group_x[col / kCols] + s * (col % kCols);
      y = y0 + s * rr;
      dst = L::kTilesAt + rr * L::kTilePitch + col * pxb;
    }
    if (y >= 0 && y < H && x >= 0 && x < W) {
      table[atomicAdd(&n_inside, 1)] = make_int2((y * W + x) * C, dst + (from_f1 ? kFromF1 : 0));
    } else {
#pragma unroll
      for (int stage = 0; stage < 2; ++stage)
#pragma unroll
        for (int piece = 0; piece < pieces; ++piece)
          *reinterpret_cast<uint4*>(stages + stage * L::kStageBytes + dst + piece * 16) =
              make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  const int n_staged = n_inside;

  const size_t plane = static_cast<size_t>(H) * W * C;
  const T* f1b = f1 + b * plane;
  const T* f2b = f2 + b * plane;

  // Stage channels [c0, c0 + kCk) of the block's f2 windows and f1 rows.
  auto stage_step = [&](int c0, unsigned char* buf) {
    if (vec) {
      const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
      for (int e = threadIdx.x; e < n_staged * pieces; e += kThreads) {
        const int px = e / pieces;
        const int piece = e - px * pieces;
        const int2 entry = table[px];
        const T* map = (entry.y & kFromF1) ? f1b : f2b;
        const bool exists = c0 + piece * per_piece < C;  // else zeros: C ends within the step
        cp_async16(base + (entry.y & ~kFromF1) + piece * 16,
                   exists ? map + entry.x + c0 + piece * per_piece : map, exists ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < n_staged * kCk; e += kThreads) {
        const int px = e / kCk;
        const int k = e - px * kCk;
        const int2 entry = table[px];
        const T* map = (entry.y & kFromF1) ? f1b : f2b;
        reinterpret_cast<T*>(buf + (entry.y & ~kFromF1))[k] =
            c0 + k < C ? map[entry.x + c0 + k] : T(0.f);
      }
    }
    cp_async_commit();
  };

  float acc[kCols][J];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[k][j] = 0.f;

  // This thread's pair: output row y0 + s*r, displacement row i0 + il, source
  // row t = r + il; its group's window starts at column `wcol` of the row.
  const int t = r + il;
  const int y = y0 + s * r;
  const int ysrc = src0 + s * t;
  const bool pair_ok = y < H && i0 + il < D;
  const bool active = pair_ok && ysrc >= 0 && ysrc < H && group_x[g] < W;
  const int wcol = S == 1 ? kCols * g
                          : (S == 2 ? (g % 2) * L::kSlotCols + kCols * (g / 2) : g * L::kSlotCols);
  const int w_off = t * L::kWindowPitch + wcol * pxb;
  const int a_off = L::kTilesAt + r * L::kTilePitch + kCols * g * pxb;

  const int n_steps = (C + kCk - 1) / kCk;
  stage_step(0, stages);
  for (int n = 0; n < n_steps; ++n) {
    cp_async_wait_all();
    __syncthreads();  // step n is in place; everyone is done with step n - 1
    unsigned char* buf = stages + (n & 1) * L::kStageBytes;
    if (n + 1 < n_steps) stage_step((n + 1) * kCk, stages + ((n + 1) & 1) * L::kStageBytes);
    if (active) {
      const T* wp = reinterpret_cast<const T*>(buf + w_off);
      const T* ap = reinterpret_cast<const T*>(buf + a_off);
      // rolled: unrolled, the bf16 conversions spill (and run slower); f32
      // takes the same time either way
#pragma unroll 1
      for (int ch = 0; ch < kCk; ch += kQuad) {
        float a[kCols][kQuad];
#pragma unroll
        for (int k = 0; k < kCols; ++k) load_quad(ap + k * kCk + ch, a[k]);
#pragma unroll
        for (int m = 0; m < J + kCols - 1; ++m) {
          float w[kQuad];
          load_quad(wp + m * kCk + ch, w);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int j = m - k;  // column k meets window column m at displacement j
            if (j >= 0 && j < J) {
#pragma unroll
              for (int c = 0; c < kQuad; ++c) acc[k][j] = fmaf(a[k][c], w[c], acc[k][j]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the stages are dead: their memory takes the results

  // One output row at a time: its pairs put their 4 x J results into
  // os[pixel][il][j]; then the block writes each pixel's runs of displacement
  // values, neighbouring threads on neighbouring values.
  float* os = reinterpret_cast<float*>(stages);
  const float inv_c = 1.f / static_cast<float>(C);
  const size_t dd = static_cast<size_t>(D) * D;
  // where this thread's share of os goes within an output row (the same for
  // every row): -1 past the map or the displacement grid
  constexpr int kShare = (kPx * kDi * J + kThreads - 1) / kThreads;
  int out_off[kShare];
#pragma unroll
  for (int n = 0; n < kShare; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int px = e / (kDi * J);
    const int rem = e - px * (kDi * J);
    const int i = i0 + rem / J;
    const int j = j0 + rem % J;
    const int x = px < kPx ? group_x[px / kCols] + s * (px % kCols) : W;
    out_off[n] = (x < W && i < D && j < D) ? x * D * D + i * D + j : -1;
  }
  for (int rr = 0; rr < kRy; ++rr) {
    const int yy = y0 + s * rr;
    if (yy >= H) break;  // the same for the whole block
    if (r == rr && pair_ok) {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
#pragma unroll
        for (int j = 0; j < J; ++j) os[((kCols * g + k) * kDi + il) * J + j] = acc[k][j] * inv_c;
    }
    __syncthreads();
    T* orow = out + (static_cast<size_t>(b) * H + yy) * W * dd;
#pragma unroll
    for (int n = 0; n < kShare; ++n)
      if (out_off[n] >= 0) store_as(orow + out_off[n], os[threadIdx.x + n * kThreads]);
    __syncthreads();
  }
}

template <typename T, int S, int J>
int launch_block(const T* f1, const T* f2, T* out, int B, int H, int W, int C, int P, int s,
                 cudaStream_t stream) {
  const int D = 2 * (P / s) + 1;
  const int n_iblk = (D + kDi - 1) / kDi;
  const int n_jblk = (D + J - 1) / J;
  const int row_groups = (H + s * kRy - 1) / (s * kRy) * s;
  const int n_groups = (W + kCols * s - 1) / (kCols * s) * s;  // column groups that cover W
  // a pixel's offset within one batch element is kept as an int
  if (row_groups > 65535 || static_cast<long long>(B) * n_iblk * n_jblk > 65535 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(W) * D * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Tile<T, S, J>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(corr_fwd_kernel<T, S, J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f2) % 16 == 0;
  const dim3 grid((n_groups + kGroups - 1) / kGroups, row_groups, B * n_iblk * n_jblk);
  corr_fwd_kernel<T, S, J><<<grid, kThreads, smem, stream>>>(f1, f2, out, H, W, C, P, s, D,
                                                             n_iblk, n_jblk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_stride(const T* f1, const T* f2, T* out, int B, int H, int W, int C, int P, int s,
                  cudaStream_t stream) {
  // displacement columns per block: 11 where that covers the grid, else 21
  if (2 * (P / s) + 1 <= 11) return launch_block<T, S, 11>(f1, f2, out, B, H, W, C, P, s, stream);
  return launch_block<T, S, 21>(f1, f2, out, B, H, W, C, P, s, stream);
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
