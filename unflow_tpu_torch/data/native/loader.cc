// Native decode sidecar: PNG decode and parallel batch assembly.
//
// Copy of unflow_tpu/data/native/loader.cc. A self-contained C++ decoder
// (zlib inflate + scanline unfiltering) with a std::thread batch API,
// exposed to Python over a C ABI (ctypes). The Python codecs of
// unflow_tpu_torch/data/{io,png16}.py are its reference; the outputs are
// bit-identical.
//
// Supported PNG subset (covers KITTI/Sintel/SYNTHIA/Middlebury data and
// KITTI 16-bit flow maps): 8/16-bit depth, grey/RGB/RGBA/grey+alpha,
// all five filters, non-interlaced.
//
// Build: g++ -O3 -funroll-loops -shared -fPIC -std=c++17 loader.cc -lz
// (done by unflow_tpu_torch/data/native/__init__.py at first use, into
// unflow_tpu_torch/_build/).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::abs;

namespace {

struct Image {
  int h = 0, w = 0, channels = 0, bitdepth = 0;
  std::vector<uint8_t> data;  // unfiltered raw scanline bytes
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_for_colortype(int ct) {
  switch (ct) {
    case 0: return 1;  // grey
    case 2: return 3;  // rgb
    case 4: return 2;  // grey+alpha
    case 6: return 4;  // rgba
    default: return 0;
  }
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Decode a PNG byte buffer into raw (unfiltered) scanlines.
bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || memcmp(buf, kSig, 8) != 0) return false;

  size_t pos = 8;
  std::vector<uint8_t> idat;
  int width = 0, height = 0, bitdepth = 0, colortype = -1;
  while (pos + 12 <= len) {
    uint32_t chunk_len = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* payload = buf + pos + 8;
    if (pos + 12 + chunk_len > len) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (chunk_len < 13) return false;
      width = be32(payload);
      height = be32(payload + 4);
      bitdepth = payload[8];
      colortype = payload[9];
      int interlace = payload[12];
      if (interlace != 0) return false;
      if (bitdepth != 8 && bitdepth != 16) return false;
      if (channels_for_colortype(colortype) == 0) return false;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + chunk_len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + chunk_len;
  }
  if (width <= 0 || height <= 0 || idat.empty()) return false;

  const int channels = channels_for_colortype(colortype);
  const int bpp = channels * (bitdepth / 8);
  const size_t stride = size_t(width) * bpp;
  const size_t raw_size = size_t(height) * (stride + 1);

  std::vector<uint8_t> raw(raw_size);
  {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) return false;
    zs.next_in = const_cast<Bytef*>(idat.data());
    zs.avail_in = static_cast<uInt>(idat.size());
    zs.next_out = raw.data();
    zs.avail_out = static_cast<uInt>(raw.size());
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END || zs.total_out != raw.size()) return false;
  }

  out->h = height;
  out->w = width;
  out->channels = channels;
  out->bitdepth = bitdepth;
  out->data.assign(size_t(height) * stride, 0);

  std::vector<uint8_t> zero_row(stride, 0);
  const uint8_t* prev = zero_row.data();
  for (int y = 0; y < height; ++y) {
    const uint8_t filter = raw[size_t(y) * (stride + 1)];
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1) + 1;
    uint8_t* dst = out->data.data() + size_t(y) * stride;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          dst[i] = src[i] + (i >= size_t(bpp) ? dst[i - bpp] : 0);
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) dst[i] = src[i] + prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int left = i >= size_t(bpp) ? dst[i - bpp] : 0;
          dst[i] = src[i] + uint8_t((left + prev[i]) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
          dst[i] = src[i] + uint8_t(paeth(a, prev[i], c));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    fclose(f);
    return false;
  }
  out->resize(size_t(size));
  size_t got = fread(out->data(), 1, size_t(size), f);
  fclose(f);
  return got == size_t(size);
}

}  // namespace

extern "C" {

// Probe an image's dimensions. Returns 0 on success.
// Header-only: parses the 8-byte signature + IHDR (first chunk, fixed
// offsets) instead of inflating the image — the decode wrappers call
// this before every full decode, so a full decode here would double
// the CPU cost of the entire fast path.
int unflow_png_shape(const char* path, int* h, int* w, int* channels,
                     int* bitdepth) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint8_t head[33];  // signature(8) + len(4) + "IHDR"(4) + payload(13)
  size_t got = fread(head, 1, sizeof(head), f);
  fclose(f);
  if (got < sizeof(head) || memcmp(head, kSig, 8) != 0) return 2;
  if (memcmp(head + 12, "IHDR", 4) != 0 || be32(head + 8) < 13) return 2;
  const uint8_t* payload = head + 16;
  const int width = be32(payload);
  const int height = be32(payload + 4);
  const int depth = payload[8];
  const int ct = payload[9];
  if (width <= 0 || height <= 0) return 2;
  if (depth != 8 && depth != 16) return 2;
  if (channels_for_colortype(ct) == 0) return 2;
  if (payload[12] != 0) return 2;  // interlaced unsupported
  *h = height;
  *w = width;
  *channels = channels_for_colortype(ct);
  *bitdepth = depth;
  return 0;
}

// Decode an 8-bit PNG to float32 RGB in [0, 1], shape (h, w, 3).
// The output buffer must hold h*w*3 floats (use unflow_png_shape first).
// Grey images are broadcast to RGB; alpha is dropped.
int unflow_decode_rgb(const char* path, float* out, int expect_h,
                      int expect_w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  Image im;
  if (!decode_png(buf.data(), buf.size(), &im)) return 2;
  if (im.h != expect_h || im.w != expect_w) return 3;
  if (im.bitdepth != 8) return 4;
  const int c = im.channels;
  const size_t n = size_t(im.h) * im.w;
  // Divide (not multiply-by-reciprocal): bit-identical to the Python
  // path's float32(px) / 255.0f — the reciprocal form differs by 1 ulp
  // on ~half of the 256 values.
  for (size_t p = 0; p < n; ++p) {
    const uint8_t* px = im.data.data() + p * c;
    float r, g, b;
    if (c >= 3) {
      r = px[0] / 255.0f;
      g = px[1] / 255.0f;
      b = px[2] / 255.0f;
    } else {
      r = g = b = px[0] / 255.0f;
    }
    out[p * 3 + 0] = r;
    out[p * 3 + 1] = g;
    out[p * 3 + 2] = b;
  }
  return 0;
}

// Decode a KITTI 16-bit flow PNG: flow = (u16 - 2^15) / 64, valid = ch3.
// flow_out: h*w*2 floats; valid_out: h*w floats.
int unflow_decode_kitti_flow(const char* path, float* flow_out,
                             float* valid_out, int expect_h, int expect_w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  Image im;
  if (!decode_png(buf.data(), buf.size(), &im)) return 2;
  if (im.h != expect_h || im.w != expect_w) return 3;
  if (im.bitdepth != 16 || im.channels < 3) return 4;
  const int c = im.channels;
  const size_t n = size_t(im.h) * im.w;
  for (size_t p = 0; p < n; ++p) {
    const uint8_t* px = im.data.data() + p * c * 2;  // big-endian u16
    uint16_t u = uint16_t((px[0] << 8) | px[1]);
    uint16_t v = uint16_t((px[2] << 8) | px[3]);
    uint16_t ok = uint16_t((px[4] << 8) | px[5]);
    float valid = ok > 0 ? 1.0f : 0.0f;
    flow_out[p * 2 + 0] = valid * (float(u) - 32768.0f) / 64.0f;
    flow_out[p * 2 + 1] = valid * (float(v) - 32768.0f) / 64.0f;
    valid_out[p] = valid;
  }
  return 0;
}

// Decode a batch of 8-bit PNGs in parallel into one (n, h, w, 3) float32
// buffer. paths: n C strings. Returns 0 if every file decoded, else the
// first nonzero per-file status.
int unflow_decode_rgb_batch(const char** paths, int n, float* out, int h,
                            int w, int num_threads) {
  if (num_threads <= 0) num_threads = int(std::thread::hardware_concurrency());
  if (num_threads > n) num_threads = n;
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> status(0);
  const size_t item = size_t(h) * w * 3;
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        int rc = unflow_decode_rgb(paths[i], out + item * size_t(i), h, w);
        if (rc != 0) {
          int expected = 0;
          status.compare_exchange_strong(expected, rc);
        }
      }
    });
  }
  for (auto& th : workers) th.join();
  return status.load();
}

}  // extern "C"
