// What the three tensor-core correlation kernels share (correlation_fwd_mma.cu,
// correlation_bwd_mma.cu): the tile geometry of the banded product and thin
// wrappers of the PTX they are built from (cp.async, ldmatrix, mma.sync
// m16n8k16 with bf16 operands and f32 sums).
//
// Geometry (mirrored by unflow_tpu_torch/ops/correlation_banded.py, which
// computes all three functions the same way in plain PyTorch). A block takes a
// tile of kTx output columns and splits them by phase p = x mod S: tile row k
// of phase p is output column x0 + S*k + p, window column m of phase p is map
// column x0 - P + S*m + p, and the two meet at displacement j = m - k. A
// phase has kTx/S rows in 16-row matrix tiles; the pair (phase, row tile) is a
// "combo", and there are kCombos = 4 of them for S = 1 and for S = 2.
//
// Staged map rows keep a pixel's C bf16 channels contiguous, one pixel per
// shared-memory row of 2*C + 16 bytes: the 16 bytes of padding put the eight
// rows of an ldmatrix on eight different 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corr_mma {

constexpr int kTx = 64;       // output columns per block
constexpr int kMmaRows = 16;  // rows of one matrix tile
constexpr int kCombos = kTx / kMmaRows;  // (phase, row tile) pairs per block
constexpr int kD = 21;        // displacements per axis: FlowNetC's grid, the one the band is built for
constexpr int kMaxC = 256;    // channels (16 k16 steps of A kept in registers)
constexpr int kStages = 3;    // ring of staged row windows

__host__ __device__ constexpr int rows_per_phase(int s) { return kTx / s; }
// Window columns staged per phase when the last row tile reads `pad` columns.
__host__ __device__ constexpr int window_cols(int s, int pad) {
  return rows_per_phase(s) - kMmaRows + pad;
}
__host__ __device__ inline int row_pitch_bytes(int C) { return 2 * C + 16; }

// Blocks along y when a block takes `rows` output rows of one row phase
// (rows y, y + s, ...: they share their source rows).
inline int row_blocks(int H, int s, int rows) { return (H + s * rows - 1) / (s * rows) * s; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously; `bytes` = 0
// writes 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t addr, uint32_t r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment).
// Lane l = 4*g + t holds d0,d1 = D[g][2t], D[g][2t+1] and d2,d3 = D[g+8][..].
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lanes per pixel when a map row is staged, as a shift: 2^shift pieces of 8
// channels cover C, so that no index of the copy needs a division.
__device__ __forceinline__ int lanes_per_pixel_shift(int C) {
  int shift = 0;
  while ((8 << shift) < C) ++shift;
  return shift;
}

// Stage one map row for all phases: shared-memory row p*cols + m holds map
// column xw0 + S*m + p (C channels), zeros where that lies outside the map or
// m >= needed. `row` is the map row's first pixel in device memory (only read
// if some column is inside); every thread of the block takes part, a pixel's
// 16-byte pieces on neighbouring lanes (lane_shift = lanes_per_pixel_shift(C)).
template <int S>
__device__ __forceinline__ void stage_row_async(unsigned char* stage, const __nv_bfloat16* row,
                                                int xw0, int W, int C, int cols, int needed,
                                                int pitch, int threads, int lane_shift) {
  const int ch = threadIdx.x & ((1 << lane_shift) - 1);
  if (ch * 8 >= C) return;
  const int step = threads >> lane_shift;
  for (int wc = threadIdx.x >> lane_shift; wc < S * cols; wc += step) {
    const int m = wc / S;  // wc is the window column in map order: S*m + p
    const int p = wc - m * S;
    const int x = xw0 + wc;
    const bool inside = m < needed && x >= 0 && x < W;
    const __nv_bfloat16* src = inside ? row + static_cast<size_t>(x) * C + ch * 8 : row;
    cp_async16(smem_addr(stage + (p * cols + m) * pitch + ch * 16), src, inside ? 16 : 0);
  }
}

}  // namespace corr_mma
