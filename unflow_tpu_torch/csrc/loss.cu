// The unsupervised loss (losses/unsupervised.py::unsupervised_loss) fused
// into six kernels, four forward and two backward, for the terms occ, fb, ternary,
// photo and smooth_2nd with forward-backward occlusion masking.
//
// It replaces no TPU kernel: the JAX package leaves the loss to XLA, which
// fuses it. Eagerly, and inside a CUDA graph, PyTorch runs it as about 2,000
// small kernels forward and 2,000 backward over 5 scales and 2 directions,
// writing 49-, 25- and 9-channel census patch tensors (F.unfold) and every
// intermediate of every term to device memory. Its inputs are small: 8 pairs
// of 3-channel frames and two 2-channel flows at 5 scales (scale 0 is 80x288
// at the training crop), so the work is bound by the full-resolution frames'
// one read (the pyramid, 70 MB at 320x1152, batch 8) and, after it, by the
// census's arithmetic (49 offsets, both directions) and by launch latency.
// The design keeps everything but a few per-pixel fields in registers and
// shared memory, and launches over every scale at once:
//
//   loss_pyramid  the 1/4 .. 1/64 average pyramid of both frames, one block
//                 per coarsest pixel, each level from the one before it in
//                 shared memory (the composite's successive means, in its
//                 summation order);
//   loss_pixel    per pixel and direction: the bilinear backward warp of the
//                 other frame and the opposite flow (taps clamped to the
//                 frame, ops/warp.py), the occlusion test, the outgoing and
//                 border masks, the occ, fb and photo terms; it writes the
//                 grey level of the pixel's own frame and of the warped frame
//                 and the mask;
//   loss_stencil  per pixel and direction over a tile with a halo of the
//                 census radius in shared memory: the census distance (zero
//                 past the frame, as F.unfold pads) and the second-order
//                 smoothness stencils anchored at the pixel; it writes the
//                 census distance;
//   loss_finish   one block: each term's per-block sums, in a fixed order,
//                 over the full element counts, weighted into the values
//                 vector (values[5 * level + term], the total last);
//   loss_grad     per pixel and direction: the census gradient gathered from
//                 every patch the pixel is in, the smoothness gradient from
//                 every stencil it is in, the pointwise terms', taken through
//                 the warp's sampling position to the pixel's own flow, which
//                 it stores; the gradient to the warped opposite flow goes to
//                 its four taps as 64-bit fixed-point atomic adds;
//   loss_grad_add the taps' fixed-point sums added to the stored gradients.
//
// The arithmetic, index for index, is ops/loss_gather.py's (float64 CPU
// tests hold it against autograd of the composite terms). Each sum is a
// block's fixed-order reduction or an integer sum, so the forward and the
// gradients repeat to the bit (a resumed run equals an uninterrupted one).
// The fixed point's scale is a power of two chosen from the gradient's own
// bound (tap_scale), so no sum can overflow and its resolution is far below
// float32's at any gradient the loss makes. Rounding follows the composite's
// separate PyTorch ops where a threshold reads the value (__f*_rn: no
// contraction).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 5;
constexpr int TERMS = 5;  // occ, fb, ternary, photo, smooth_2nd
constexpr int T_OCC = 0, T_FB = 1, T_TERNARY = 2, T_PHOTO = 3, T_SMOOTH = 4;
constexpr int THREADS = 256;
constexpr int TILE_W = 32, TILE_H = 8;  // the stencil and gradient kernels' tiles
constexpr int MAX_RADIUS = 3;
constexpr int TILE_CELLS = (TILE_H + 2 * MAX_RADIUS) * (TILE_W + 2 * MAX_RADIUS);
constexpr int PIXEL_SLOTS = 3;    // occ, fb, photo
constexpr int STENCIL_SLOTS = 5;  // census, smoothness along x, y and both diagonals
constexpr int FIELDS = 4;         // own grey, warped grey, mask, census distance
constexpr int F_OWN = 0, F_WARPED = 1, F_MASK = 2, F_DIST = 3;
constexpr float ALPHA = 0.45f, EPS2 = 1e-6f;

struct Level {
  int h, w, radius, border, census_border;
  float scale, layer_weight;
  const float* flow[2];         // forward, backward: (B, 2, h, w), each example contiguous
  long long flow_bstride[2];
  float* pyr;                   // [2 frames][B][3][h][w]
  float* fields;                // [2 directions][FIELDS][B][h][w]
  // backward: (B, 2, h, w) each, every level's forward then every level's
  // backward gradient back to back in one array from lv[0].grad[0], and so
  // for the fixed-point sums at the warp's taps (zeroed)
  float* grad[2];
  unsigned long long* taps[2];
  int pixel_block0, stencil_block0, tiles_x, tiles_y;
};

struct Params {
  int levels, batch, active;  // active: bit t for term t
  int grad_elements;          // of every level's grad[0] and grad[1], laid out back to back
  const float* im[2];
  long long im_stride[2][4];
  Level lv[MAX_LEVELS];
  float term_weight[TERMS];
  int pixel_blocks, stencil_blocks;
  float* partials;            // [PIXEL_SLOTS][pixel_blocks], then [STENCIL_SLOTS][stencil_blocks]
  float* values;              // [5 * levels + 1]
  const float* grad_values;   // backward: d loss / d values
};

__device__ __forceinline__ float charb(float x) {
  return powf(__fadd_rn(__fmul_rn(x, x), EPS2), ALPHA);
}

__device__ __forceinline__ float charb_grad(float x) {
  return 2.f * ALPHA * x * powf(__fadd_rn(__fmul_rn(x, x), EPS2), ALPHA - 1.f);
}

// the normalized census difference x / sqrt(0.81 + x^2), and its derivative
__device__ __forceinline__ float tau(float x) {
  return __fdiv_rn(x, __fsqrt_rn(__fadd_rn(0.81f, __fmul_rn(x, x))));
}

__device__ __forceinline__ float tau_grad(float x) {
  const float s = 0.81f + x * x;
  return 0.81f / (s * sqrtf(s));
}

__device__ __forceinline__ float hamming(float z) {
  const float z2 = __fmul_rn(z, z);
  return __fdiv_rn(z2, __fadd_rn(0.1f, z2));
}

__device__ __forceinline__ float hamming_grad(float z) {
  const float d = 0.1f + z * z;
  return 0.2f * z / (d * d);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  // a * (1 - t) + b * t, rounded as the composite's separate ops
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

struct Taps {
  int i00, i01, i10, i11;
  float wx, wy;
};

// the four taps of a sample at (xs, ys), each clamped to the frame on its own
__device__ __forceinline__ Taps taps_at(float xs, float ys, int h, int w) {
  const float x0 = floorf(xs), y0 = floorf(ys);
  const int ix0 = (int)fminf(fmaxf(x0, 0.f), w - 1.f), ix1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), w - 1.f);
  const int iy0 = (int)fminf(fmaxf(y0, 0.f), h - 1.f), iy1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), h - 1.f);
  Taps t;
  t.i00 = iy0 * w + ix0;
  t.i01 = iy0 * w + ix1;
  t.i10 = iy1 * w + ix0;
  t.i11 = iy1 * w + ix1;
  t.wx = __fsub_rn(xs, x0);
  t.wy = __fsub_rn(ys, y0);
  return t;
}

// the bilinear sample of a plane (its values times `scale`), and its
// derivatives to the sampling position's x and y
__device__ __forceinline__ float sample(const float* plane, const Taps& t, float scale,
                                        float* d_x, float* d_y) {
  const float v00 = __fmul_rn(plane[t.i00], scale), v01 = __fmul_rn(plane[t.i01], scale);
  const float v10 = __fmul_rn(plane[t.i10], scale), v11 = __fmul_rn(plane[t.i11], scale);
  const float top = lerp_rn(v00, v01, t.wx), bot = lerp_rn(v10, v11, t.wx);
  if (d_x) {
    *d_x = (v01 - v00) * (1.f - t.wy) + (v11 - v10) * t.wy;
    *d_y = bot - top;
  }
  return lerp_rn(top, bot, t.wy);
}

// the luminance weights of _to_grayscale
__device__ __forceinline__ float gray_weight(int c) { return c == 0 ? 0.2989f : c == 1 ? 0.5870f : 0.1140f; }

__device__ __forceinline__ float gray(float r, float g, float b) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(gray_weight(0), r), __fmul_rn(gray_weight(1), g)),
                             __fmul_rn(gray_weight(2), b)), 255.f);
}

__device__ __forceinline__ float* field(const Level& L, int batch, int dir, int f, int b) {
  return L.fields + ((size_t)(dir * FIELDS + f) * batch + b) * L.h * L.w;
}

__device__ __forceinline__ int pixel_level(const Params& p) {
  int l = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < p.levels && (int)blockIdx.x >= p.lv[i].pixel_block0) l = i;
  return l;
}

__device__ __forceinline__ int stencil_level(const Params& p) {
  int l = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < p.levels && (int)blockIdx.x >= p.lv[i].stencil_block0) l = i;
  return l;
}

// Sum each of N values over the block (all THREADS threads call it) in a
// fixed order: a shuffle tree in each warp, then the warps in turn. Thread k
// of the first N writes sum k to out[k * stride + slot].
template <int N>
__device__ __forceinline__ void block_sums(const float (&v)[N], float* out, int stride, int slot) {
  __shared__ float warp_sums[N][THREADS / 32];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) warp_sums[k][threadIdx.x >> 5] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) s += warp_sums[threadIdx.x][i];
    out[threadIdx.x * stride + slot] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) loss_pyramid_kernel(const Params p) {
  // level k of this block's region: (n0 >> k)^2 pixels of 3 channels
  __shared__ float levels[3 * (256 + 64 + 16 + 4 + 1)];
  const int top = p.levels - 1, frame = blockIdx.z, b = blockIdx.y, B = p.batch;
  const int cy = blockIdx.x / p.lv[top].w, cx = blockIdx.x - cy * p.lv[top].w;
  const int n0 = 1 << top;  // scale-0 pixels per side of the region
  const float* im = p.im[frame];
  const long long* st = p.im_stride[frame];
  {
    const Level& L = p.lv[0];
    for (int i = threadIdx.x; i < n0 * n0; i += THREADS) {
      const int y = cy * n0 + i / n0, x = cx * n0 + i % n0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* src = im + b * st[0] + c * st[1] + (long long)(4 * y) * st[2] + (long long)(4 * x) * st[3];
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 4; ++dy)
#pragma unroll
          for (int dx = 0; dx < 4; ++dx) acc += src[dy * st[2] + dx * st[3]];
        const float v = acc / 16.f;
        L.pyr[((size_t)(frame * B + b) * 3 + c) * L.h * L.w + y * L.w + x] = v;
        levels[c * n0 * n0 + i] = v;
      }
    }
  }
  int prev = 0, n = n0;
  for (int k = 1; k <= top; ++k) {
    __syncthreads();
    const int m = n >> 1, here = prev + 3 * n * n;
    const Level& L = p.lv[k];
    for (int i = threadIdx.x; i < m * m; i += THREADS) {
      const int py = i / m, px = i % m;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* s = levels + prev + c * n * n + 2 * py * n + 2 * px;
        const float v = (((s[0] + s[1]) + s[n]) + s[n + 1]) / 4.f;
        L.pyr[((size_t)(frame * B + b) * 3 + c) * L.h * L.w + (cy * m + py) * L.w + cx * m + px] = v;
        levels[here + c * m * m + i] = v;
      }
    }
    prev = here;
    n = m;
  }
}

__global__ void __launch_bounds__(THREADS) loss_pixel_kernel(const Params p) {
  const int l = pixel_level(p);
  const Level& L = p.lv[l];
  const int h = L.h, w = L.w, hw = h * w, B = p.batch;
  const int idx = ((int)blockIdx.x - L.pixel_block0) * THREADS + threadIdx.x;
  float sums[PIXEL_SLOTS] = {0.f, 0.f, 0.f};
  if (idx < 2 * B * hw) {
    const int dir = idx / (B * hw), rest = idx - dir * B * hw;
    const int b = rest / hw, pix = rest - b * hw, y = pix / w, x = pix - y * w;
    const float* own = L.pyr + (size_t)(dir * B + b) * 3 * hw;
    const float* other = L.pyr + (size_t)((1 - dir) * B + b) * 3 * hw;
    const float* f = L.flow[dir] + b * L.flow_bstride[dir];
    const float* g = L.flow[1 - dir] + b * L.flow_bstride[1 - dir];
    const float s = L.scale;
    const float u = __fmul_rn(f[pix], s), v = __fmul_rn(f[hw + pix], s);
    const float xs = __fadd_rn((float)x, u), ys = __fadd_rn((float)y, v);
    const Taps t = taps_at(xs, ys, h, w);
    float ow[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ow[c] = sample(other + c * hw, t, 1.f, nullptr, nullptr);
    const float gw0 = sample(g, t, s, nullptr, nullptr), gw1 = sample(g + hw, t, s, nullptr, nullptr);
    const float d0 = __fadd_rn(u, gw0), d1 = __fadd_rn(v, gw1);
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)),
                                __fadd_rn(__fmul_rn(gw0, gw0), __fmul_rn(gw1, gw1)));
    const bool occ = __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)) > __fadd_rn(__fmul_rn(0.01f, mag), 0.5f);
    const int bd = L.border;
    const bool inside = xs >= 0.f && xs <= w - 1.f && ys >= 0.f && ys <= h - 1.f &&
                        y >= bd && y < h - bd && x >= bd && x < w - bd;
    const float mask = inside && !occ ? 1.f : 0.f;
    if (p.active & (1 << T_OCC)) sums[0] = charb(occ ? 1.f : 0.f);
    if (p.active & (1 << T_FB)) sums[1] = (charb(d0) + charb(d1)) * mask;
    if (p.active & (1 << T_PHOTO)) {
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) e += charb(__fmul_rn(__fsub_rn(own[c * hw + pix], ow[c]), 255.f));
      sums[2] = e * mask;
    }
    field(L, B, dir, F_OWN, b)[pix] = gray(own[pix], own[hw + pix], own[2 * hw + pix]);
    field(L, B, dir, F_WARPED, b)[pix] = gray(ow[0], ow[1], ow[2]);
    field(L, B, dir, F_MASK, b)[pix] = mask;
  }
  block_sums(sums, p.partials, p.pixel_blocks, blockIdx.x);
}

// the soft Hamming distance of the census patches at the tile cell c
template <int R>
__device__ __forceinline__ float census(const float* g1s, const float* g2s, int pitch, int c) {
  const float g1 = g1s[c], g2 = g2s[c];
  float dist = 0.f;
#pragma unroll
  for (int ky = -R; ky <= R; ++ky)
#pragma unroll
    for (int kx = -R; kx <= R; ++kx) {
      const int o = c + ky * pitch + kx;
      dist += hamming(__fsub_rn(tau(__fsub_rn(g1s[o], g1)), tau(__fsub_rn(g2s[o], g2))));
    }
  return dist;
}

// d census / d (warped grey at the tile cell c), over the charbonnier's
// derivatives `a` (zero outside the frame and the masks): as the centre of
// its own patch (every offset k) and as the neighbour at offset -k of the
// patch anchored at c + k. The two share their differences up to the sign,
// and tau and the Hamming derivative are odd, tau's derivative even: one
// evaluation per offset serves both, weighted by a[c] + a[c + k].
template <int R>
__device__ __forceinline__ float census_grad(const float* g1s, const float* g2s, const float* as,
                                             int pitch, int c) {
  const float g1 = g1s[c], g2 = g2s[c], a = as[c];
  float acc = 0.f;
#pragma unroll
  for (int ky = -R; ky <= R; ++ky)
#pragma unroll
    for (int kx = -R; kx <= R; ++kx) {
      const int o = c + ky * pitch + kx;
      const float x1 = g1s[o] - g1, x2 = g2s[o] - g2;
      acc += (a + as[o]) * hamming_grad(tau(x1) - tau(x2)) * tau_grad(x2);
    }
  return acc;
}

struct Tile {
  int dir, b, y, x, cell, pitch;
};

// this block's tile and this thread's pixel in it
__device__ __forceinline__ Tile tile_of(const Level& L, int batch, int radius) {
  const int blk = (int)blockIdx.x - L.stencil_block0, tiles = L.tiles_x * L.tiles_y;
  const int db = blk / tiles, tile = blk - db * tiles;
  Tile t;
  t.dir = db / batch;
  t.b = db - t.dir * batch;
  const int ty = threadIdx.x / TILE_W, tx = threadIdx.x % TILE_W;
  t.y = (tile / L.tiles_x) * TILE_H + ty;
  t.x = (tile % L.tiles_x) * TILE_W + tx;
  t.pitch = TILE_W + 2 * radius;
  t.cell = (ty + radius) * t.pitch + tx + radius;
  return t;
}

// fill a tile with a halo of `radius` from a plane (zero past the frame),
// each value mapped through `op(value, y, x)`
template <typename Op>
__device__ __forceinline__ void load_tile(float* dst, const Level& L, const Tile& t, int radius, Op op) {
  const int y0 = t.y - (int)(threadIdx.x / TILE_W) - radius;
  const int x0 = t.x - (int)(threadIdx.x % TILE_W) - radius;
  for (int i = threadIdx.x; i < (TILE_H + 2 * radius) * t.pitch; i += THREADS) {
    const int yy = y0 + i / t.pitch, xx = x0 + i % t.pitch;
    dst[i] = yy >= 0 && yy < L.h && xx >= 0 && xx < L.w ? op(yy * L.w + xx, yy, xx) : 0.f;
  }
}

__device__ __forceinline__ bool in_census_border(const Level& L, int y, int x) {
  const int d = L.census_border;
  return y >= d && y < L.h - d && x >= d && x < L.w - d;
}

// the four second-order stencils: along x, along y, and both diagonals
__device__ __forceinline__ int stencil_dy(int k) { return k == 0 ? 0 : 1; }
__device__ __forceinline__ int stencil_dx(int k) { return k == 0 || k == 2 ? 1 : k == 1 ? 0 : -1; }

__device__ __forceinline__ float stencil_count(const Level& L, int batch, int k) {
  const long long n = (long long)batch * 2 * (L.h - 2 * stencil_dy(k)) * (L.w - 2 * abs(stencil_dx(k)));
  return (float)(n > 1 ? n : 1);
}

__device__ __forceinline__ bool stencil_anchor(const Level& L, int k, int y, int x) {
  const int dy = stencil_dy(k), dx = abs(stencil_dx(k));
  return y >= dy && y <= L.h - 1 - dy && x >= dx && x <= L.w - 1 - dx;
}

// the stencil k anchored at (y, x) of a flow plane (times scale)
__device__ __forceinline__ float stencil(const float* f, int w, float s, int k, int y, int x) {
  const int dy = stencil_dy(k), dx = stencil_dx(k);
  const float a = __fmul_rn(f[(y + dy) * w + x + dx], s), c = __fmul_rn(f[y * w + x], s);
  const float e = __fmul_rn(f[(y - dy) * w + x - dx], s);
  return __fadd_rn(__fsub_rn(a, __fmul_rn(2.f, c)), e);
}

__global__ void __launch_bounds__(THREADS) loss_stencil_kernel(const Params p) {
  __shared__ float g1s[TILE_CELLS], g2s[TILE_CELLS];
  const Level& L = p.lv[stencil_level(p)];
  const int B = p.batch, R = L.radius;
  const Tile t = tile_of(L, B, R);
  const bool ternary = p.active & (1 << T_TERNARY);
  if (ternary) {
    const float* own = field(L, B, t.dir, F_OWN, t.b);
    const float* warped = field(L, B, t.dir, F_WARPED, t.b);
    load_tile(g1s, L, t, R, [&](int i, int, int) { return own[i]; });
    load_tile(g2s, L, t, R, [&](int i, int, int) { return warped[i]; });
    __syncthreads();
  }
  float sums[STENCIL_SLOTS] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (t.y < L.h && t.x < L.w) {
    const int pix = t.y * L.w + t.x;
    if (ternary) {
      const float dist = R == 1 ? census<1>(g1s, g2s, t.pitch, t.cell)
                       : R == 2 ? census<2>(g1s, g2s, t.pitch, t.cell)
                                : census<3>(g1s, g2s, t.pitch, t.cell);
      field(L, B, t.dir, F_DIST, t.b)[pix] = dist;
      if (in_census_border(L, t.y, t.x)) sums[0] = charb(dist) * field(L, B, t.dir, F_MASK, t.b)[pix];
    }
    if (p.active & (1 << T_SMOOTH)) {
      const float* f = L.flow[t.dir] + t.b * L.flow_bstride[t.dir];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (stencil_anchor(L, k, t.y, t.x)) sums[1 + k] += charb(stencil(f + c * L.h * L.w, L.w, L.scale, k, t.y, t.x));
    }
  }
  block_sums(sums, p.partials + PIXEL_SLOTS * p.pixel_blocks, p.stencil_blocks, blockIdx.x);
}

__global__ void __launch_bounds__(THREADS) loss_finish_kernel(const Params p) {
  constexpr int SLOTS = PIXEL_SLOTS + STENCIL_SLOTS;
  __shared__ float level_sums[MAX_LEVELS][SLOTS];
  // one warp per (level, slot): each lane sums a fixed stride of the
  // level's blocks, then a shuffle tree the lanes
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < p.levels * SLOTS; q += THREADS / 32) {
    const int l = q / SLOTS, k = q % SLOTS;
    const bool pixel = k < PIXEL_SLOTS;
    const int begin = pixel ? p.lv[l].pixel_block0 : p.lv[l].stencil_block0;
    const int end = l + 1 < p.levels ? (pixel ? p.lv[l + 1].pixel_block0 : p.lv[l + 1].stencil_block0)
                                     : (pixel ? p.pixel_blocks : p.stencil_blocks);
    const float* part = pixel ? p.partials + k * p.pixel_blocks
                              : p.partials + PIXEL_SLOTS * p.pixel_blocks + (k - PIXEL_SLOTS) * p.stencil_blocks;
    float s = 0.f;
    for (int i = begin + lane; i < end; i += 32) s += part[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) level_sums[l][k] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float total = 0.f;
  for (int l = 0; l < p.levels; ++l) {
    const Level& L = p.lv[l];
    const float* s = level_sums[l];
    const float n = (float)((long long)p.batch * L.h * L.w);
    float term[TERMS];
    term[T_OCC] = s[0] / n;
    term[T_FB] = s[1] / (2.f * n);
    term[T_PHOTO] = s[2] / (3.f * n);
    term[T_TERNARY] = s[3] / n;
    float smooth = 0.f;
    for (int k = 0; k < 4; ++k) smooth += s[4 + k] / stencil_count(L, p.batch, k);
    term[T_SMOOTH] = smooth / 2.f;
    float scale_total = 0.f;
    for (int k = 0; k < TERMS; ++k) {
      const bool on = p.active & (1 << k);
      p.values[TERMS * l + k] = on ? term[k] : 0.f;
      if (on) scale_total = scale_total + p.term_weight[k] * term[k];
    }
    total = total + L.layer_weight * scale_total;
  }
  p.values[TERMS * p.levels] = total;
}

// d loss / d (term k's value at level l)
__device__ __forceinline__ float term_coef(const Params& p, int l, int k) {
  if (!(p.active & (1 << k))) return 0.f;
  const float g_total = p.grad_values ? p.grad_values[TERMS * p.levels] : 0.f;
  return (p.grad_values ? p.grad_values[TERMS * l + k] : 0.f) + g_total * p.lv[l].layer_weight * p.term_weight[k];
}

// The fixed point of the taps' sums: 2^k with the largest k that keeps every
// sum inside 2^62. A tap's contribution is gd * s * weight with |gd| under
// |coef_fb| * 1.52 / (2 B h w) (the charbonnier derivative peaks at 1.52),
// and a tap gathers at most the h w pixels of its example, so every sum lies
// under 0.76 s |coef_fb|: bounded here by 3 s |coef_fb|, over every level.
__device__ __forceinline__ double tap_scale(const Params& p) {
  double bound = 1e-30;
  for (int l = 0; l < p.levels; ++l) bound = fmax(bound, 3.0 * p.lv[l].scale * fabs((double)term_coef(p, l, T_FB)));
  return exp2(floor(62.0 - log2(bound)));
}

__device__ __forceinline__ void add_fixed(unsigned long long* dst, float v, double scale) {
  atomicAdd(dst, (unsigned long long)llrint((double)v * scale));
}

__global__ void __launch_bounds__(THREADS) loss_grad_kernel(const Params p) {
  __shared__ float g1s[TILE_CELLS], g2s[TILE_CELLS], as[TILE_CELLS];
  const int l = stencil_level(p);
  const Level& L = p.lv[l];
  const int B = p.batch, R = L.radius, h = L.h, w = L.w, hw = h * w;
  const Tile t = tile_of(L, B, R);
  const float n = (float)((long long)B * hw);
  float coef[TERMS];
#pragma unroll
  for (int k = 0; k < TERMS; ++k) coef[k] = term_coef(p, l, k);
  const bool ternary = p.active & (1 << T_TERNARY);
  if (ternary) {
    const float* own = field(L, B, t.dir, F_OWN, t.b);
    const float* warped = field(L, B, t.dir, F_WARPED, t.b);
    const float* dist = field(L, B, t.dir, F_DIST, t.b);
    const float* mask = field(L, B, t.dir, F_MASK, t.b);
    load_tile(g1s, L, t, R, [&](int i, int, int) { return own[i]; });
    load_tile(g2s, L, t, R, [&](int i, int, int) { return warped[i]; });
    load_tile(as, L, t, R, [&](int i, int y, int x) {
      return in_census_border(L, y, x) ? charb_grad(dist[i]) * mask[i] : 0.f;
    });
    __syncthreads();
  }
  if (t.y >= h || t.x >= w) return;
  const int pix = t.y * w + t.x, dir = t.dir, b = t.b;
  const float s = L.scale;
  float g_gray = 0.f;  // d loss / d (warped grey level)
  if (ternary) {
    const float acc = R == 1 ? census_grad<1>(g1s, g2s, as, t.pitch, t.cell)
                    : R == 2 ? census_grad<2>(g1s, g2s, as, t.pitch, t.cell)
                             : census_grad<3>(g1s, g2s, as, t.pitch, t.cell);
    g_gray = coef[T_TERNARY] / n * acc;
  }
  const float* own = L.pyr + (size_t)(dir * B + b) * 3 * hw;
  const float* other = L.pyr + (size_t)((1 - dir) * B + b) * 3 * hw;
  const float* f = L.flow[dir] + b * L.flow_bstride[dir];
  const float* g = L.flow[1 - dir] + b * L.flow_bstride[1 - dir];
  const float mask = field(L, B, dir, F_MASK, b)[pix];
  const float u = __fmul_rn(f[pix], s), v = __fmul_rn(f[hw + pix], s);
  const Taps tp = taps_at(__fadd_rn((float)t.x, u), __fadd_rn((float)t.y, v), h, w);
  float gpx = 0.f, gpy = 0.f;  // d loss / d (sampling position)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float dx, dy;
    const float ow = sample(other + c * hw, tp, 1.f, &dx, &dy);
    float gc = 255.f * gray_weight(c) * g_gray;
    if (p.active & (1 << T_PHOTO))
      gc -= coef[T_PHOTO] * mask * 255.f * charb_grad(__fmul_rn(__fsub_rn(own[c * hw + pix], ow), 255.f)) / (3.f * n);
    gpx += gc * dx;
    gpy += gc * dy;
  }
  float gd[2] = {0.f, 0.f};  // d loss / d (flow + warped opposite flow)
  if (p.active & (1 << T_FB)) {
    float dx0, dy0, dx1, dy1;
    const float gw0 = sample(g, tp, s, &dx0, &dy0), gw1 = sample(g + hw, tp, s, &dx1, &dy1);
    gd[0] = coef[T_FB] * mask * charb_grad(__fadd_rn(u, gw0)) / (2.f * n);
    gd[1] = coef[T_FB] * mask * charb_grad(__fadd_rn(v, gw1)) / (2.f * n);
    gpx += gd[0] * dx0 + gd[1] * dx1;
    gpy += gd[0] * dy0 + gd[1] * dy1;
    // the warped opposite flow's taps
    const double scale = tap_scale(p);
    unsigned long long* go = L.taps[1 - dir] + (size_t)b * 2 * hw;
    const float w00 = (1.f - tp.wx) * (1.f - tp.wy), w01 = tp.wx * (1.f - tp.wy);
    const float w10 = (1.f - tp.wx) * tp.wy, w11 = tp.wx * tp.wy;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float gs = gd[c] * s;
      add_fixed(go + c * hw + tp.i00, gs * w00, scale);
      add_fixed(go + c * hw + tp.i01, gs * w01, scale);
      add_fixed(go + c * hw + tp.i10, gs * w10, scale);
      add_fixed(go + c * hw + tp.i11, gs * w11, scale);
    }
  }
  float gf[2] = {gd[0] + gpx, gd[1] + gpy};  // d loss / d (this pixel's flow, in pixels)
  if (p.active & (1 << T_SMOOTH)) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* fc = f + c * hw;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float gk = 0.f;
#pragma unroll
        for (int m = -1; m <= 1; ++m) {
          const int ay = t.y + m * stencil_dy(k), ax = t.x + m * stencil_dx(k);
          if (ay >= 0 && ay < h && ax >= 0 && ax < w && stencil_anchor(L, k, ay, ax))
            gk += (m == 0 ? -2.f : 1.f) * charb_grad(stencil(fc, w, s, k, ay, ax));
        }
        acc += gk / stencil_count(L, B, k);
      }
      gf[c] += coef[T_SMOOTH] * 0.5f * acc;
    }
  }
  float* gown = L.grad[dir] + (size_t)b * 2 * hw;
  gown[pix] = gf[0] * s;
  gown[hw + pix] = gf[1] * s;
}

// grad += taps / scale over every level's gradients (one flat array each)
__global__ void __launch_bounds__(THREADS) loss_grad_add_kernel(const Params p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.grad_elements) return;
  const double scale = tap_scale(p);
  p.lv[0].grad[0][i] += (float)((double)(long long)p.lv[0].taps[0][i] / scale);
}

// Params from the wrapper's flat arrays (ops/cuda/loss.py::_arrays); the
// kernels' block counts, checked against the partial sums' room.
int build(Params& p, const long long* ptrs, const long long* ints, const float* floats,
          long long capacity) {
  p.levels = (int)ints[0];
  p.batch = (int)ints[1];
  p.active = (int)ints[2];
  if (p.levels < 1 || p.levels > MAX_LEVELS || p.batch < 1) return -1;
  for (int f = 0; f < 2; ++f) {
    p.im[f] = reinterpret_cast<const float*>(ptrs[f]);
    for (int k = 0; k < 4; ++k) p.im_stride[f][k] = ints[3 + 4 * f + k];
  }
  p.partials = reinterpret_cast<float*>(ptrs[2]);
  p.values = reinterpret_cast<float*>(ptrs[3]);
  p.grad_values = reinterpret_cast<const float*>(ptrs[4]);
  for (int k = 0; k < TERMS; ++k) p.term_weight[k] = floats[k];
  int pixel = 0, stencil = 0;
  for (int l = 0; l < p.levels; ++l) {
    Level& L = p.lv[l];
    const long long* q = ptrs + 5 + 8 * l;
    const long long* n = ints + 11 + 6 * l;
    L.flow[0] = reinterpret_cast<const float*>(q[0]);
    L.flow[1] = reinterpret_cast<const float*>(q[1]);
    L.pyr = reinterpret_cast<float*>(q[2]);
    L.fields = reinterpret_cast<float*>(q[3]);
    L.grad[0] = reinterpret_cast<float*>(q[4]);
    L.grad[1] = reinterpret_cast<float*>(q[5]);
    L.taps[0] = reinterpret_cast<unsigned long long*>(q[6]);
    L.taps[1] = reinterpret_cast<unsigned long long*>(q[7]);
    L.h = (int)n[0];
    L.w = (int)n[1];
    L.radius = (int)n[2];
    L.border = (int)n[3];
    L.flow_bstride[0] = n[4];
    L.flow_bstride[1] = n[5];
    L.scale = floats[TERMS + 2 * l];
    L.layer_weight = floats[TERMS + 2 * l + 1];
    if (L.h < 1 || L.w < 1 || L.radius < 1 || L.radius > MAX_RADIUS) return -1;
    const int d = (L.h < L.w ? L.h : L.w) - 1;
    L.census_border = L.radius < d / 2 ? L.radius : d / 2;
    L.tiles_x = (L.w + TILE_W - 1) / TILE_W;
    L.tiles_y = (L.h + TILE_H - 1) / TILE_H;
    L.pixel_block0 = pixel;
    L.stencil_block0 = stencil;
    pixel += (2 * p.batch * L.h * L.w + THREADS - 1) / THREADS;
    stencil += 2 * p.batch * L.tiles_x * L.tiles_y;
  }
  p.pixel_blocks = pixel;
  p.stencil_blocks = stencil;
  p.grad_elements = 0;
  for (int l = 0; l < p.levels; ++l) p.grad_elements += 2 * 2 * p.batch * p.lv[l].h * p.lv[l].w;
  // every level halves the one before it, down from a quarter of the frame
  for (int l = 1; l < p.levels; ++l)
    if (p.lv[l].h * 2 != p.lv[l - 1].h || p.lv[l].w * 2 != p.lv[l - 1].w) return -1;
  if ((long long)PIXEL_SLOTS * pixel + (long long)STENCIL_SLOTS * stencil > capacity) return -2;
  return 0;
}

}  // namespace

extern "C" int unflow_loss_forward(const long long* ptrs, const long long* ints, const float* floats,
                                   long long capacity, void* stream) {
  Params p;
  const int err = build(p, ptrs, ints, floats, capacity);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level& top = p.lv[p.levels - 1];
  loss_pyramid_kernel<<<dim3(top.h * top.w, p.batch, 2), THREADS, 0, s>>>(p);
  loss_pixel_kernel<<<p.pixel_blocks, THREADS, 0, s>>>(p);
  loss_stencil_kernel<<<p.stencil_blocks, THREADS, 0, s>>>(p);
  loss_finish_kernel<<<1, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int unflow_loss_backward(const long long* ptrs, const long long* ints, const float* floats,
                                    long long capacity, void* stream) {
  Params p;
  const int err = build(p, ptrs, ints, floats, capacity);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  loss_grad_kernel<<<p.stencil_blocks, THREADS, 0, s>>>(p);
  loss_grad_add_kernel<<<(p.grad_elements + THREADS - 1) / THREADS, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
