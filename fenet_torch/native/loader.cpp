// fenet_torch native data loader: a whole batch of ShapeNet renders decoded
// and cropped, and of .npy point clouds read, by a pool of threads.
//
// Counterpart of fenet/native/loader.cpp, with the same outputs: 128x128x3
// HWC RGB pixels of the [4:-5, 4:-5] crop of a 137x137 render, raw 0..255
// (no /255, no normalisation), as float32 or as uint8; (points, 3) float32
// clouds from little-endian <f4 or <f8 .npy files. Exposed through a plain C
// interface loaded with ctypes; fenet_torch/native/__init__.py builds it at
// first use.
//
// The PNG decoder is this file's own, on zlib alone: the machines the port
// runs on need not have libpng. It gives the pixels libpng gives with
// fenet's transforms (16-bit samples cut to their high byte, palette and
// gray expanded to RGB, 1/2/4-bit gray scaled to 0..255, alpha dropped),
// which are the pixels of cv2.imread followed by BGR->RGB.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kSide = 128;           // the crop's height and width
constexpr int kCropLo = 4;           // rows and columns cut at the top/left
constexpr int kCropHi = 5;           // ... and at the bottom/right
constexpr int kRender = kSide + kCropLo + kCropHi;  // 137

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(fp) : -1;
  ok = ok && size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(size_t(size));
    ok = std::fread(buf->data(), 1, buf->size(), fp) == buf->size();
  }
  std::fclose(fp);
  return ok;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct Png {
  int width = 0, height = 0, depth = 0, color = 0;
  bool interlaced = false, has_palette = false;
  std::vector<uint8_t> palette = std::vector<uint8_t>(256 * 3, 0);  // RGB
  std::vector<uint8_t> zdata;  // the IDAT chunks' zlib stream
};

int channels(int color) {
  switch (color) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

// The chunks up to the end of the IDAT run. A critical chunk with a bad CRC
// fails the file; an ancillary one is skipped, as libpng does.
bool parse_png(const std::vector<uint8_t>& f, Png* png) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (f.size() < 8 || std::memcmp(f.data(), kSig, 8) != 0) return false;
  size_t pos = 8;
  bool header = false, in_idat = false;
  while (f.size() - pos >= 12) {
    uint32_t len = be32(&f[pos]);
    if (len > f.size() - pos - 12) return false;
    const uint8_t* type = &f[pos + 4];
    const uint8_t* data = type + 4;
    bool idat = std::memcmp(type, "IDAT", 4) == 0;
    if (in_idat && !idat) break;  // the image data is complete
    bool critical = !(type[0] & 0x20);
    uLong crc = crc32(crc32(0L, Z_NULL, 0), type, 4 + len);
    pos += 12 + size_t(len);
    if (crc != be32(data + len)) {
      if (critical) return false;
      continue;
    }
    if (!header) {
      if (std::memcmp(type, "IHDR", 4) != 0 || len != 13) return false;
      uint32_t w = be32(data), h = be32(data + 4);
      if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24)) return false;
      png->width = int(w);
      png->height = int(h);
      png->depth = data[8];
      png->color = data[9];
      if (!valid_depth(png->color, png->depth)) return false;
      if (data[10] != 0 || data[11] != 0 || data[12] > 1) return false;
      png->interlaced = data[12] == 1;
      header = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len == 0 || len % 3 != 0 || len > 256 * 3) return false;
      std::copy(data, data + len, png->palette.begin());
      png->has_palette = true;
    } else if (idat) {
      if (png->color == 3 && !png->has_palette) return false;
      png->zdata.insert(png->zdata.end(), data, data + len);
      in_idat = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
  }
  return header && in_idat;
}

bool inflate_all(const std::vector<uint8_t>& src, std::vector<uint8_t>* dst) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src.data());
  zs.avail_in = uInt(src.size());
  zs.next_out = dst->data();
  zs.avail_out = uInt(dst->size());
  int ret = inflate(&zs, Z_FINISH);
  bool full = zs.avail_out == 0;
  inflateEnd(&zs);
  // Data after the image's bytes is ignored, as libpng does.
  return full && (ret == Z_STREAM_END || ret == Z_BUF_ERROR || ret == Z_OK);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters of a (rows, 1 + rowbytes) block in place.
bool unfilter(uint8_t* block, int rows, size_t rowbytes, int bpp) {
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prior = zero.data();
  for (int y = 0; y < rows; ++y) {
    uint8_t* row = block + size_t(y) * (rowbytes + 1);
    int filter = row[0];
    uint8_t* x = row + 1;
    switch (filter) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) x[i] += x[i - bpp];
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) x[i] += prior[i];
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i)
          x[i] += uint8_t(((i >= size_t(bpp) ? x[i - bpp] : 0) + prior[i]) >> 1);
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= size_t(bpp) ? x[i - bpp] : 0;
          int c = i >= size_t(bpp) ? prior[i - bpp] : 0;
          x[i] += uint8_t(paeth(a, prior[i], c));
        }
        break;
      default:
        return false;
    }
    prior = x;
  }
  return true;
}

// Sample k (0-based) of an unpacked-or-packed row, as 0..255.
inline uint8_t sample8(const uint8_t* row, int k, int depth, bool scale) {
  if (depth == 8) return row[k];
  if (depth == 16) return row[2 * k];  // the high byte
  int bit = k * depth;
  int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
  return scale ? uint8_t(v * (255 / ((1 << depth) - 1))) : uint8_t(v);
}

// One row of `count` pixels to RGB8 at `out`, every `step` pixels.
void row_to_rgb(const Png& png, const uint8_t* row, int count, uint8_t* out, int step) {
  const int ch = channels(png.color);
  for (int i = 0; i < count; ++i) {
    uint8_t* px = out + size_t(i) * step * 3;
    switch (png.color) {
      case 0: case 4: {
        uint8_t g = sample8(row, i * ch, png.depth, true);
        px[0] = px[1] = px[2] = g;
        break;
      }
      case 3: {
        const uint8_t* rgb = &png.palette[3 * sample8(row, i, png.depth, false)];
        px[0] = rgb[0];
        px[1] = rgb[1];
        px[2] = rgb[2];
        break;
      }
      default:  // RGB, RGBA
        for (int c = 0; c < 3; ++c) px[c] = sample8(row, i * ch + c, png.depth, false);
    }
  }
}

// Decode a parsed PNG to 8-bit RGB (height, width, 3).
bool decode_rgb(const Png& png, std::vector<uint8_t>* rgb) {
  const int bits = channels(png.color) * png.depth;
  const int bpp = std::max(1, bits / 8);
  // Adam7 passes: x0, y0, dx, dy; a plain image is one pass of step 1.
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = png.interlaced ? kAdam7 : kPlain;
  const int n_passes = png.interlaced ? 7 : 1;
  struct Pass { int w, h; size_t rowbytes, offset; };
  std::vector<Pass> dims(n_passes);
  size_t total = 0;
  for (int p = 0; p < n_passes; ++p) {
    const int* a = passes[p];
    int w = png.width > a[0] ? (png.width - a[0] + a[2] - 1) / a[2] : 0;
    int h = png.height > a[1] ? (png.height - a[1] + a[3] - 1) / a[3] : 0;
    size_t rowbytes = (size_t(w) * bits + 7) / 8;
    dims[p] = {w, h, rowbytes, total};
    if (w > 0 && h > 0) total += size_t(h) * (rowbytes + 1);
  }
  std::vector<uint8_t> raw(total);
  if (!inflate_all(png.zdata, &raw)) return false;
  rgb->resize(size_t(png.width) * png.height * 3);
  for (int p = 0; p < n_passes; ++p) {
    const Pass& d = dims[p];
    if (d.w == 0 || d.h == 0) continue;
    uint8_t* block = raw.data() + d.offset;
    if (!unfilter(block, d.h, d.rowbytes, bpp)) return false;
    const int* a = passes[p];
    for (int y = 0; y < d.h; ++y) {
      int oy = a[1] + y * a[3];
      uint8_t* out = rgb->data() + (size_t(oy) * png.width + a[0]) * 3;
      row_to_rgb(png, block + size_t(y) * (d.rowbytes + 1) + 1, d.w, out, a[2]);
    }
  }
  return true;
}

// One render: decode, check it is 137x137, write the [4:-5, 4:-5] crop as
// (128, 128, 3) float32 or uint8.
template <typename T>
bool load_shapenet_image(const char* path, T* dst) {
  std::vector<uint8_t> file, rgb;
  Png png;
  if (!read_file(path, &file) || !parse_png(file, &png)) return false;
  if (png.width != kRender || png.height != kRender) return false;
  if (!decode_rgb(png, &rgb)) return false;
  for (int y = 0; y < kSide; ++y) {
    const uint8_t* src = rgb.data() + (size_t(y + kCropLo) * kRender + kCropLo) * 3;
    T* d = dst + size_t(y) * kSide * 3;
    for (int x = 0; x < kSide * 3; ++x) d[x] = T(src[x]);
  }
  return true;
}

// A little-endian <f4 or <f8 C-order .npy file of shape (points, 3), read
// into float32 (an <f8 value rounds to nearest, as numpy's astype does).
bool load_npy_cloud(const char* path, float* dst, int points) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return false;
  if (file.size() < 10 || std::memcmp(file.data(), "\x93NUMPY", 6) != 0) return false;
  int major = file[6];
  size_t header_len, start;
  if (major == 1) {
    header_len = file[8] | (size_t(file[9]) << 8);
    start = 10;
  } else {
    if (file.size() < 12) return false;
    header_len = file[8] | (size_t(file[9]) << 8) | (size_t(file[10]) << 16) |
                 (size_t(file[11]) << 24);
    start = 12;
  }
  if (file.size() - start < header_len) return false;
  std::string header(reinterpret_cast<const char*>(&file[start]), header_len);
  bool f8 = header.find("'descr': '<f8'") != std::string::npos;
  if (!f8 && header.find("'descr': '<f4'") == std::string::npos) return false;
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  if (header.find("'shape': (" + std::to_string(points) + ", 3)") == std::string::npos)
    return false;
  const size_t count = size_t(points) * 3, offset = start + header_len;
  if (file.size() - offset < count * (f8 ? 8 : 4)) return false;
  if (f8) {
    for (size_t i = 0; i < count; ++i) {
      double v;
      std::memcpy(&v, &file[offset + 8 * i], 8);
      dst[i] = float(v);
    }
  } else {
    std::memcpy(dst, &file[offset], count * 4);
  }
  return true;
}

void parallel_for(int n, int n_threads, const std::function<bool(int)>& fn,
                  std::atomic<int>* failures) {
  auto run = [&](std::atomic<int>* next) {
    int i;
    while ((i = next->fetch_add(1)) < n)
      if (!fn(i)) failures->fetch_add(1);
  };
  std::atomic<int> next(0);
  int workers = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  for (int t = 1; t < workers; ++t) pool.emplace_back(run, &next);
  run(&next);
  for (auto& th : pool) th.join();
}

std::vector<const char*> split_paths(const char* paths, int n) {
  std::vector<const char*> ptrs(n);
  for (int i = 0; i < n; ++i) {
    ptrs[i] = paths;
    paths += std::strlen(paths) + 1;
  }
  return ptrs;
}

}  // namespace

extern "C" {

// Batch image load: `paths` holds n NUL-terminated strings back to back;
// `out` is (n, 128, 128, 3) uint8 when out_uint8, else float32. Returns
// the number of images that failed (unreadable, not a PNG, not 137x137).
int fenet_torch_load_images(const char* paths, int n, void* out, int out_uint8,
                            int n_threads) {
  std::vector<const char*> ptrs = split_paths(paths, n);
  const size_t stride = size_t(kSide) * kSide * 3;
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    return out_uint8
        ? load_shapenet_image(ptrs[i], static_cast<uint8_t*>(out) + i * stride)
        : load_shapenet_image(ptrs[i], static_cast<float*>(out) + i * stride);
  }, &failures);
  return failures.load();
}

// Batch cloud load: each file holds (points, 3) <f4 or <f8; `out` is
// (n, points, 3) float32. Returns the number of clouds that failed.
int fenet_torch_load_clouds(const char* paths, int n, int points, float* out,
                            int n_threads) {
  std::vector<const char*> ptrs = split_paths(paths, n);
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    return load_npy_cloud(ptrs[i], out + size_t(i) * points * 3, points);
  }, &failures);
  return failures.load();
}

int fenet_torch_loader_version() { return 1; }

}  // extern "C"
