// Gradients of the FlowNetC correlation (cost volume) for Hopper (sm_90a), on
// the FP32 cores.
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
// df2 is a gather over the D*D source pixels of each output pixel, so
// neither kernel needs atomics.
//
// What bounds them. Each gradient is 2*B*H*W*D*D*C operations against
// reading g and one map and writing one map. At the training shape
// (B=16, 40x144, C=256, D=21) that is 20.8 GFLOP against 351 MB (f32) or
// 176 MB (bf16): f32 is bound by FP32 FMA throughput (0.3106 ms at
// 67 TFLOP/s), bf16 by memory (0.05 ms at 3.35 TB/s). An SM reads 32
// shared-memory words per clock and does 128 FMAs, so the design has to read
// well under one word per FMA.
//
// Design: register tiling across x, as the forward of correlation_fwd.cu,
// with the displacements as the reduction. One __device__ body for both
// gradients (Wrt says which).
//   * A thread owns 4 output columns of one phase, x, x + s, x + 2s, x + 3s
//     (a "group"), of one output row, and kCt = 8 channels: 32 f32 sums that
//     live in registers for the whole walk. Column k of a group meets window
//     column m of the other map at displacement column j = m - k, so per
//     window column the thread reads its 8 channels there (two 16-byte loads
//     in f32, one in bf16) and the 4 cotangent values that meet it (one
//     16-byte load) for up to 32 FMAs: 12 words per 32 FMAs in f32.
//   * A warp is one output row: 4 groups (16 columns) x 8 threads of 8
//     channels, a slice of 64 channels. A block takes kRy = 4 output rows of
//     one row phase and walks the D displacement rows, n = 0 .. D-1
//     (displacement row n for df1, D-1-n for df2). Output row r meets source
//     row t = r + n, map row y0 - P + s*t, at step n: the rows in use slide by
//     one per step through a ring of staged rows of the other map, so a block
//     stages (kRy + D - 1)/kRy source rows per output row (6 for D = 21) where
//     one output row per block staged D. A row whose source row lies outside
//     the map (or that lies past the map itself) has nothing to add and skips
//     its FMAs: whole warps. Four rows fill FlowNetC's maps (40 and 48 rows
//     are 5 and 6 row groups per phase at stride 2) and leave room for two or
//     three blocks per SM, whose steps overlap each other's copies and waits.
//   * Step n stages by 16-byte cp.async the source row that step n + 1 needs
//     first (a ring of kRy + 1 rows), in flight under the step's FMAs, one
//     barrier per step. Where each staged pixel comes from and goes to is
//     worked out once per block into a table in shared memory, neighbouring
//     threads copy the pieces of one pixel, and window columns outside the map
//     are zeroed once and never copied. Staged data keeps the maps' type. Maps
//     whose C is no multiple of 4 (f32) or 8 (bf16), or that are not 16-byte
//     aligned, are staged by plain loads.
//   * The cotangent comes as a band per output row and group, stored so that
//     the 4 values one window column needs are one 16-byte word:
//       df1: band[m][k] = g[y, x + s*k, i*D + j0 + m - k], the group's own
//            pixels (contiguous runs of J values in g);
//       df2: band[m][k] = g[source row, window pixel m, i*D + D-1 - (j0 + m - k)];
//     zero off the band and outside the map. Each warp builds its own row's
//     band: the 16*J entries are dealt to its lanes once per block (each
//     lane's offsets stay fixed, only the row of g moves), read by scalar
//     loads one step ahead into registers and stored after the step's FMAs
//     into the other of two buffers.
//   * Window slots as in the forward: one for s = 1, one per phase for
//     s = 2, one per group for a run-time stride (S == 0), so one inner loop
//     serves every stride. A displacement grid wider than the thread's J
//     (21, or 11 where D <= 11) is walked in blocks of J inside the block:
//     no atomics, no second pass, deterministic.
//   * Shared memory: the ring, two band buffers and the table. f32 at s = 2
//     takes 84,928 bytes (two blocks of 128 threads per SM), at s = 1 59,168
//     (three), a run-time stride with J = 21 136,448 (one); bf16 at s = 2
//     49,088 (three). __launch_bounds__(128, 3) caps a thread at 168 registers.
// What sets the pace after that: the FMAs' issue and the shared-memory reads
// (12 words per 32 FMAs in f32, the window's 8 words not shared between
// lanes), then the steps' serial parts: the barrier, the copies' issue and
// the band's scalar loads (scattered over the window's pixels for df2). Each
// 64-channel slice reads g again (from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 4;        // output columns per thread: x, x + s, x + 2s, x + 3s
constexpr int kGroups = 4;      // column groups per block
constexpr int kLanesPerGroup = 8;
constexpr int kCt = 8;          // channels per thread
constexpr int kSlice = kLanesPerGroup * kCt;  // channels per block (64)
constexpr int kRowThreads = kGroups * kLanesPerGroup;  // threads per output row
static_assert(kRowThreads % 32 == 0, "an output row is whole warps");
static_assert(kGroups % 2 == 0, "s = 2 has a window slot per phase");

enum class Wrt { kF1, kF2 };

// The shared-memory layout of one instantiation. S: 1, 2 or 0 (run-time
// stride); J: displacement columns per block of the walk.
template <typename T, int S, int J>
struct Tile {
  static constexpr int kRy = 4;                  // output rows per block
  static constexpr int kThreads = kRowThreads * kRy;
  static constexpr int kRing = kRy + 1;          // staged source rows
  static constexpr int kSlots = S == 1 ? 1 : (S == 2 ? 2 : kGroups);
  static constexpr int kSlotCols = kCols * (kGroups / kSlots) + J - 1;
  static constexpr int kWindowCols = kSlots * kSlotCols;
  static constexpr int kM = J + kCols - 1;                 // window columns of a group
  static constexpr int kPixelBytes = kSlice * static_cast<int>(sizeof(T));
  static constexpr int kPieces = kPixelBytes / 16;
  static constexpr int kPerPiece = 16 / static_cast<int>(sizeof(T));  // channels per 16 bytes
  static constexpr int kRowBytes = kWindowCols * kPixelBytes;
  static constexpr int kRingBytes = kRing * kRowBytes;
  // 16-byte words per group's band: one more than kM, so that the 4 groups of
  // a warp read 4 different bank groups
  static constexpr int kBandPitch = kM + 1;
  static constexpr int kBandFloats = kRy * kGroups * kBandPitch * kCols;  // one buffer
  static constexpr int kBandAt = kRingBytes;
  static constexpr int kTableAt = kBandAt + 2 * kBandFloats * static_cast<int>(sizeof(float));
  static constexpr int kSmemBytes = kTableAt + kWindowCols * static_cast<int>(sizeof(int2));
  static constexpr int kPer = (kGroups * kCols * J + kRowThreads - 1) / kRowThreads;  // band entries per thread
  static_assert(kSmemBytes <= 232448, "fits one block's shared memory");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The thread's 8 channels of one staged pixel, as f32: 16-byte units cs and
// cs + 8 in f32 (channels 4*cs.. and 32 + 4*cs..), unit cs in bf16
// (channels 8*cs..): the 8 threads of a group read 128 contiguous bytes.
__device__ __forceinline__ void load_channels(const float* p, float v[kCt]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 32);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p, float v[kCt]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);  // a bf16 is the upper half of its f32
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
  v[4] = __uint_as_float(q.z << 16); v[5] = __uint_as_float(q.z & 0xffff0000u);
  v[6] = __uint_as_float(q.w << 16); v[7] = __uint_as_float(q.w & 0xffff0000u);
}

// Channel of the thread's value v (of kCt), relative to the block's slice.
template <typename T>
__device__ __forceinline__ int channel_of(int cs, int v) {
  constexpr int per = 16 / static_cast<int>(sizeof(T));
  return ((v / per) * kLanesPerGroup + cs) * per + v % per;
}

__device__ __forceinline__ void store_channels(float* dst, bool vec, int room, const float v[kCt]) {
  if (vec) {  // room >= 0: C is a multiple of 4, so a unit is all in or all out
    if (room > 0) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    if (room > 32) *reinterpret_cast<float4*>(dst + 32) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kCt; ++k) {
      const int c = channel_of<float>(0, k);
      if (c < room) dst[c] = v[k];
    }
  }
}
__device__ __forceinline__ void store_channels(__nv_bfloat16* dst, bool vec, int room,
                                               const float v[kCt]) {
  if (vec) {
    if (room > 0) {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < kCt / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(dst) = u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCt; ++k)
      if (k < room) dst[k] = __float2bfloat16(v[k]);
  }
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

// First column of column group G: the map's columns go in runs of 4*s, each
// holding one group per phase p: columns 4*s*u + p + s*k, k < 4.
__device__ __forceinline__ int group_first_column(int G, int s) {
  return kCols * s * (G / s) + G % s;
}

// `f` is the other map (f2 for df1, f1 for df2), `out` the gradient.
template <typename T, int S, int J, Wrt kWrt>
__device__ __forceinline__ void corr_bwd_body(const T* __restrict__ g, const T* __restrict__ f,
                                              T* __restrict__ out, int H, int W, int C, int P,
                                              int s_run, int D, int n_slices, bool vec) {
  using L = Tile<T, S, J>;
  constexpr bool kF1 = kWrt == Wrt::kF1;
  constexpr int kRy = L::kRy;
  constexpr int kM = L::kM;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int group_x[kGroups];  // first column of each of the block's groups
  __shared__ int n_inside;
  unsigned char* ring = smem;
  float* band = reinterpret_cast<float*>(smem + L::kBandAt);  // [2][kRy][kGroups][kM][kCols]
  // table[n], n < n_inside: a window column inside the map. .x its pixel's
  // offset in a map row, .y its byte offset in a staged row
  int2* table = reinterpret_cast<int2*>(smem + L::kTableAt);
  const int s = S > 0 ? S : s_run;

  const int lane = threadIdx.x % kRowThreads;  // within the output row
  const int r = threadIdx.x / kRowThreads;     // the warps' output row
  const int gi = lane / kLanesPerGroup;
  const int cs = lane % kLanesPerGroup;
  const int row_group = blockIdx.y;
  const int y0 = (row_group / s) * (s * kRy) + row_group % s;
  const int c0 = (blockIdx.z % n_slices) * kSlice;
  const int b = blockIdx.z / n_slices;
  const int y = y0 + s * r;
  const size_t dd = static_cast<size_t>(D) * D;
  const T* fb = f + static_cast<size_t>(b) * H * W * C;
  const T* gb = g + static_cast<size_t>(b) * H * W * dd;

  if (threadIdx.x < kGroups)
    group_x[threadIdx.x] = group_first_column(blockIdx.x * kGroups + threadIdx.x, s);
  // off the band the buffers hold zeros for good
  for (int e = threadIdx.x; e < 2 * L::kBandFloats; e += L::kThreads) band[e] = 0.f;

  // source row of output row r at step n is y0 - P + s*(r + n); inside the
  // map, it has something to add
  auto active = [&](int n) {
    const int ys = y0 - P + s * (r + n);
    return y < H && ys >= 0 && ys < H;
  };
  const int wcol = S == 1 ? kCols * gi
                          : (S == 2 ? (gi % 2) * L::kSlotCols + kCols * (gi / 2) : gi * L::kSlotCols);

  float acc[kCols][kCt];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int c = 0; c < kCt; ++c) acc[k][c] = 0.f;

  for (int j0 = 0; j0 < D; j0 += J) {
    __syncthreads();  // the previous block of columns is done with the ring and the table
    if (threadIdx.x == 0) n_inside = 0;
    __syncthreads();
    // Where each window column comes from, worked out once per block of
    // columns; those outside the map are zeroed in every ring row and never copied.
    for (int col = threadIdx.x; col < L::kWindowCols; col += L::kThreads) {
      const int slot = col / L::kSlotCols;
      const int x = group_x[slot] - P + s * (j0 + col - slot * L::kSlotCols);
      if (x >= 0 && x < W) {
        table[atomicAdd(&n_inside, 1)] = make_int2(x * C, col * L::kPixelBytes);
      } else {
        for (int t = 0; t < L::kRing; ++t)
#pragma unroll
          for (int piece = 0; piece < L::kPieces; ++piece)
            *reinterpret_cast<uint4*>(ring + t * L::kRowBytes + col * L::kPixelBytes + piece * 16) =
                make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // This lane's share of its row's band: entry e of the 16*J, counted so
    // that neighbouring lanes read neighbouring values of g. df1: pixel
    // (group, k), then jj = m - k; df2: group, window column m, then the k
    // that meet it (k = max(0, m-J+1) .. min(3, m)).
    int g_off[L::kPer];  // offset in a row of g past i*D; -1: a zero
    int s_off[L::kPer];  // entry of the row's band, -1: nothing to write
#pragma unroll
    for (int q = 0; q < L::kPer; ++q) {
      const int e = lane + kRowThreads * q;
      const int gq = e / (kCols * J);
      int rem = e - gq * (kCols * J);
      int k, m, x, j;  // j: displacement column of the entry in g's row
      if constexpr (kF1) {
        k = rem / J;
        const int jj = rem - k * J;
        m = k + jj;
        x = gq < kGroups ? group_x[gq] + s * k : W;
        j = j0 + jj;
      } else {
        for (m = 0;; ++m) {
          const int count = min(kCols - 1, m) - max(0, m - J + 1) + 1;
          if (rem < count || m >= kM - 1) break;
          rem -= count;
        }
        k = max(0, m - J + 1) + rem;
        x = gq < kGroups ? group_x[gq] - P + s * (j0 + m) : W;
        j = D - 1 - (j0 + m - k);
      }
      const bool wanted = gq < kGroups;
      const bool exists = wanted && x >= 0 && x < W && j >= 0 && j0 + m - k < D;
      s_off[q] = wanted ? ((r * kGroups + gq) * L::kBandPitch + m) * kCols + k : -1;
      g_off[q] = exists ? x * D * D + j : -1;
    }
    __syncthreads();  // the table, the zeros and group_x are in place

    const int n_staged = n_inside;
    // Stage source row t into its ring row t % (kRy + 1); a row outside the
    // map is read by no output row and not staged.
    auto stage = [&](int t) {
      const int ys = y0 - P + s * t;
      if (ys >= 0 && ys < H) {
        unsigned char* dst = ring + (t % L::kRing) * L::kRowBytes;
        const T* src = fb + ys * W * C + c0;
        if (vec) {
          const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
          for (int e = threadIdx.x; e < n_staged * L::kPieces; e += L::kThreads) {
            const int px = e / L::kPieces;
            const int piece = e - px * L::kPieces;
            const int2 entry = table[px];
            const bool exists = c0 + piece * L::kPerPiece < C;  // else zeros: C ends in the slice
            cp_async16(base + entry.y + piece * 16,
                       exists ? src + entry.x + piece * L::kPerPiece : fb, exists ? 16 : 0);
          }
        } else {
          for (int e = threadIdx.x; e < n_staged * kSlice; e += L::kThreads) {
            const int px = e / kSlice;
            const int c = e - px * kSlice;
            const int2 entry = table[px];
            reinterpret_cast<T*>(dst + entry.y)[c] = c0 + c < C ? src[entry.x + c] : T(0.f);
          }
        }
      }
      cp_async_commit();
    };
    // The row of g that output row r reads at step n, at displacement row i:
    // its own row (df1), the source row (df2).
    float gv[L::kPer];
    auto load_band = [&](int n) {
      const int i = kF1 ? n : D - 1 - n;
      const int yg = kF1 ? y : y0 - P + s * (r + n);
      const T* grow = gb + static_cast<size_t>(yg) * W * dd + i * D;
#pragma unroll
      for (int q = 0; q < L::kPer; ++q) gv[q] = g_off[q] >= 0 ? to_float(__ldg(grow + g_off[q])) : 0.f;
    };
    auto store_band = [&](int n) {
      float* buf = band + (n & 1) * L::kBandFloats;
#pragma unroll
      for (int q = 0; q < L::kPer; ++q)
        if (s_off[q] >= 0) buf[s_off[q]] = gv[q];
    };

    for (int t = 0; t < kRy; ++t) stage(t);
    if (active(0)) {
      load_band(0);
      store_band(0);
    }
    for (int n = 0; n < D; ++n) {
      cp_async_wait_all();
      __syncthreads();  // step n's rows and bands are in place; step n - 1 is done
      const bool more = n + 1 < D;
      if (more) stage(n + kRy);  // into the ring row that step n - 1 read last
      const bool next = more && active(n + 1);
      if (next) load_band(n + 1);
      if (active(n)) {
        const float4* bp = reinterpret_cast<const float4*>(band + (n & 1) * L::kBandFloats) +
                           (r * kGroups + gi) * L::kBandPitch;
        const T* wp = reinterpret_cast<const T*>(ring + ((r + n) % L::kRing) * L::kRowBytes +
                                                 wcol * L::kPixelBytes) +
                      cs * L::kPerPiece;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float4 bq = bp[m];
          const float bv[kCols] = {bq.x, bq.y, bq.z, bq.w};
          float w[kCt];
          load_channels(wp + m * kSlice, w);
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int jj = m - k;  // column k meets window column m at displacement j0 + jj
            if (jj >= 0 && jj < J) {
#pragma unroll
              for (int c = 0; c < kCt; ++c) acc[k][c] = fmaf(bv[k], w[c], acc[k][c]);
            }
          }
        }
      }
      if (next) store_band(n + 1);  // into the buffer that step n - 1 read
    }
  }
  cp_async_wait_all();

  if (y < H) {
    const float inv_c = 1.f / static_cast<float>(C);
    const int room = C - c0 - channel_of<T>(cs, 0);  // channels left from the thread's first
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int x = group_x[gi] + s * k;
      if (x >= W) continue;
#pragma unroll
      for (int c = 0; c < kCt; ++c) acc[k][c] *= inv_c;
      T* dst = out + ((static_cast<size_t>(b) * H + y) * W + x) * C + c0 + channel_of<T>(cs, 0);
      store_channels(dst, vec, room, acc[k]);
    }
  }
}

template <typename T, int S, int J>
__global__ void __launch_bounds__(Tile<T, S, J>::kThreads, 3)
corr_bwd_f1_kernel(const T* __restrict__ g, const T* __restrict__ f2, T* __restrict__ df1, int H,
                   int W, int C, int P, int s_run, int D, int n_slices, bool vec) {
  corr_bwd_body<T, S, J, Wrt::kF1>(g, f2, df1, H, W, C, P, s_run, D, n_slices, vec);
}

template <typename T, int S, int J>
__global__ void __launch_bounds__(Tile<T, S, J>::kThreads, 3)
corr_bwd_f2_kernel(const T* __restrict__ g, const T* __restrict__ f1, T* __restrict__ df2, int H,
                   int W, int C, int P, int s_run, int D, int n_slices, bool vec) {
  corr_bwd_body<T, S, J, Wrt::kF2>(g, f1, df2, H, W, C, P, s_run, D, n_slices, vec);
}

template <typename T, int S, int J, Wrt kWrt>
int launch_block(const T* g, const T* f, T* out, int B, int H, int W, int C, int P, int s,
                 cudaStream_t stream) {
  using L = Tile<T, S, J>;
  const int D = 2 * (P / s) + 1;
  const int n_slices = (C + kSlice - 1) / kSlice;
  const int row_groups = (H + s * L::kRy - 1) / (s * L::kRy) * s;
  const int n_groups = (W + kCols * s - 1) / (kCols * s) * s;  // column groups that cover W
  // offsets within one batch element's map and cotangent are kept as ints
  if (row_groups > 65535 || static_cast<long long>(B) * n_slices > 65535 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(H) * W * D * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = kWrt == Wrt::kF1 ? corr_bwd_f1_kernel<T, S, J> : corr_bwd_f2_kernel<T, S, J>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = C % L::kPerPiece == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((n_groups + kGroups - 1) / kGroups, row_groups, B * n_slices);
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(g, f, out, H, W, C, P, s, D, n_slices, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, Wrt kWrt>
int launch_stride(const T* g, const T* f, T* out, int B, int H, int W, int C, int P, int s,
                  cudaStream_t stream) {
  // displacement columns per block of the walk: 11 where that covers the grid, else 21
  if (2 * (P / s) + 1 <= 11) return launch_block<T, S, 11, kWrt>(g, f, out, B, H, W, C, P, s, stream);
  return launch_block<T, S, 21, kWrt>(g, f, out, B, H, W, C, P, s, stream);
}

template <typename T, Wrt kWrt>
int launch(const void* g, const void* f, void* out, int B, int H, int W, int C, int P, int s,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || P < 0 || s <= 0 || P % s != 0)
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
