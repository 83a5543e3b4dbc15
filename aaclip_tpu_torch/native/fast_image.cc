// Native image loader: decode (libjpeg / libpng) + PIL-exact resize,
// emitting the uint8 CHW tensors the eval/serving input pipeline feeds the
// device (aaclip_tpu_torch/data/transforms.py::load_rgb_chw and
// load_mask_binarized).
//
// The reference pipeline decodes with PIL and resizes with PIL's
// fixed-point resample (torchvision Resize on PIL images,
// reference dataset/__init__.py:44-66).  Both resample schemes are
// reproduced here bit-exactly so the native path is a pure speedup:
//
// * BICUBIC: Pillow's two-pass (horizontal, then vertical) separable
//   resample with a=-0.5, fixed-point coefficients quantized to
//   PRECISION_BITS = 22 with +-0.5 rounding, accumulators seeded with the
//   rounding constant, uint8 intermediate rows (verified equal to
//   Pillow's output and to data/image.py's numpy resamplers —
//   tests/test_torch_native.py).
// * NEAREST (masks): Pillow's affine path — incremental double
//   accumulation starting at scale/2, truncated toward zero.
//
// JPEG decoding uses the same libjpeg the bundled Pillow wraps
// (JDCT_ISLOW), so decoded pixels match PIL's exactly; PNG likewise via
// libpng with PIL-convert("RGB"/"L")-equivalent channel handling.
// Unsupported layouts return nonzero and the Python caller falls back to
// data/image.py (numpy for PNG, PIL for other formats).

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// Largest accepted decoded image (pixels): generous for any benchmark
// image, small enough that forged headers cannot drive multi-GB
// allocations (268 MP ~= 0.8 GB RGB).
constexpr size_t kMaxPixels = size_t{1} << 28;

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's PRECISION_BITS

inline uint8_t clip8(int64_t v) {
  v >>= kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

double bicubic_filter(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow precompute_coeffs: per output pixel, the source window
// [xmin, xmin+n) and quantized int32 weights.
void precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                       std::vector<int>& counts, std::vector<int32_t>& kk,
                       int& ksize) {
  const double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.resize(out_size);
  counts.resize(out_size);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> w(ksize);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double wsum = 0.0;
    for (int i = 0; i < n; ++i) {
      w[i] = bicubic_filter((i + xmin - center + 0.5) * ss);
      wsum += w[i];
    }
    for (int i = 0; i < n; ++i) {
      const double v = wsum != 0.0 ? w[i] / wsum : w[i];
      const double q = v * (1 << kPrecisionBits) + (v >= 0 ? 0.5 : -0.5);
      kk[static_cast<size_t>(xx) * ksize + i] = static_cast<int32_t>(q);
    }
    bounds[xx] = xmin;
    counts[xx] = n;
  }
}

// Horizontal pass on interleaved rows: [h, in_w, ch] -> [h, out_w, ch],
// uint8 intermediate exactly like Pillow's temp image.
void resample_horizontal(const uint8_t* in, int h, int in_w, int ch,
                         int out_w, uint8_t* out) {
  std::vector<int> bounds, counts;
  std::vector<int32_t> kk;
  int ksize;
  precompute_coeffs(in_w, out_w, bounds, counts, kk, ksize);
  const int64_t half = int64_t{1} << (kPrecisionBits - 1);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * ch;
    uint8_t* orow = out + static_cast<size_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const int32_t* k = &kk[static_cast<size_t>(x) * ksize];
      const uint8_t* src = row + static_cast<size_t>(bounds[x]) * ch;
      for (int c = 0; c < ch; ++c) {
        int64_t acc = half;
        for (int i = 0; i < counts[x]; ++i)
          acc += static_cast<int64_t>(src[i * ch + c]) * k[i];
        orow[x * ch + c] = clip8(acc);
      }
    }
  }
}

// Vertical pass: [in_h, w, ch] -> [out_h, w, ch].
void resample_vertical(const uint8_t* in, int in_h, int w, int ch,
                       int out_h, uint8_t* out) {
  std::vector<int> bounds, counts;
  std::vector<int32_t> kk;
  int ksize;
  precompute_coeffs(in_h, out_h, bounds, counts, kk, ksize);
  const int64_t half = int64_t{1} << (kPrecisionBits - 1);
  const size_t rowlen = static_cast<size_t>(w) * ch;
  for (int y = 0; y < out_h; ++y) {
    const int32_t* k = &kk[static_cast<size_t>(y) * ksize];
    const uint8_t* src0 = in + static_cast<size_t>(bounds[y]) * rowlen;
    uint8_t* orow = out + static_cast<size_t>(y) * rowlen;
    for (size_t j = 0; j < rowlen; ++j) {
      int64_t acc = half;
      for (int i = 0; i < counts[y]; ++i)
        acc += static_cast<int64_t>(src0[i * rowlen + j]) * k[i];
      orow[j] = clip8(acc);
    }
  }
}

// Pillow ImagingScaleAffine nearest: incremental double accumulation from
// scale/2, truncated toward zero.
void nearest_indices(int in_size, int out_size, std::vector<int>& idx) {
  idx.resize(out_size);
  const double a0 = static_cast<double>(in_size) / out_size;
  double xo = a0 * 0.5;
  for (int x = 0; x < out_size; ++x) {
    int v = static_cast<int>(xo);
    if (v >= in_size) v = in_size - 1;
    idx[x] = v;
    xo += a0;
  }
}

// ----- decoders: fill an interleaved uint8 buffer -------------------------

struct DecodeResult {
  int w = 0, h = 0, ch = 0;       // ch: 1 (gray) or 3 (rgb)
  std::vector<uint8_t> pixels;    // h * w * ch
};

// rc: 0 ok, 1 open/read failure, 2 unsupported format, 3 decode error,
//     4 unsupported layout
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

int decode_jpeg(FILE* f, DecodeResult& res) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // PIL convert("RGB")
  cinfo.dct_method = JDCT_ISLOW;    // PIL default
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  res.w = cinfo.output_width;
  res.h = cinfo.output_height;
  res.ch = 3;
  // cap dimensions BEFORE allocating: a forged header claiming absurd
  // sizes must fall back to Python, not bad_alloc across the FFI boundary
  if (static_cast<size_t>(res.w) * res.h > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return 5;
  }
  try {
    res.pixels.resize(static_cast<size_t>(res.w) * res.h * 3);
  } catch (...) {  // bad_alloc under the cap: clean up libjpeg pools first
    jpeg_destroy_decompress(&cinfo);
    return 6;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        res.pixels.data() + static_cast<size_t>(cinfo.output_scanline) * res.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_png(FILE* f, DecodeResult& res) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 3;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);
  if (bit_depth == 16) {
    // PIL maps 16-bit files to mode I;16 with different convert("RGB")
    // semantics than a high-byte strip — punt to the Python decoder
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;
  }
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  // PIL convert("RGB"/"L") DROPS alpha without compositing
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  res.w = png_get_image_width(png, info);
  res.h = png_get_image_height(png, info);
  const int ch = png_get_channels(png, info);
  if (ch != 1 && ch != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 4;
  }
  res.ch = ch;
  if (static_cast<size_t>(res.w) * res.h > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 5;
  }
  std::vector<png_bytep> rows;
  try {
    res.pixels.resize(static_cast<size_t>(res.w) * res.h * ch);
    rows.resize(res.h);
  } catch (...) {  // bad_alloc under the cap: clean up libpng structs first
    png_destroy_read_struct(&png, &info, nullptr);
    return 6;
  }
  for (int y = 0; y < res.h; ++y)
    rows[y] = res.pixels.data() + static_cast<size_t>(y) * res.w * ch;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int decode_file(const char* path, DecodeResult& res) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  uint8_t magic[8] = {0};
  const size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  int rc;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    rc = decode_jpeg(f, res);
  } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
    rc = decode_png(f, res);
  } else {
    rc = 2;
  }
  std::fclose(f);
  return rc;
}

// PIL convert("RGB") from "L": replicate; convert("L") from RGB:
// (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
void gray_to_rgb(DecodeResult& res) {
  std::vector<uint8_t> rgb(static_cast<size_t>(res.w) * res.h * 3);
  for (size_t i = 0; i < res.pixels.size(); ++i) {
    rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = res.pixels[i];
  }
  res.pixels.swap(rgb);
  res.ch = 3;
}

void rgb_to_gray(DecodeResult& res) {
  const size_t n = static_cast<size_t>(res.w) * res.h;
  std::vector<uint8_t> gray(n);
  for (size_t i = 0; i < n; ++i) {
    const uint32_t r = res.pixels[3 * i], g = res.pixels[3 * i + 1],
                   b = res.pixels[3 * i + 2];
    gray[i] = static_cast<uint8_t>((r * 19595 + g * 38470 + b * 7471 + 0x8000)
                                   >> 16);
  }
  res.pixels.swap(gray);
  res.ch = 1;
}

}  // namespace

extern "C" {

// Decode `path`, convert to RGB, bicubic-resize to out_size x out_size, and
// write uint8 CHW planes into `out` (3 * out_size * out_size bytes).
// Returns 0 on success; nonzero = caller must fall back to Python.
int load_rgb_resize_chw(const char* path, int out_size, uint8_t* out) try {
  DecodeResult res;
  const int rc = decode_file(path, res);
  if (rc != 0) return rc;
  if (res.ch == 1) gray_to_rgb(res);
  std::vector<uint8_t> tmp(static_cast<size_t>(res.h) * out_size * 3);
  resample_horizontal(res.pixels.data(), res.h, res.w, 3, out_size,
                      tmp.data());
  std::vector<uint8_t> hw(static_cast<size_t>(out_size) * out_size * 3);
  resample_vertical(tmp.data(), res.h, out_size, 3, out_size, hw.data());
  const size_t plane = static_cast<size_t>(out_size) * out_size;
  for (size_t i = 0; i < plane; ++i) {
    out[i] = hw[3 * i];
    out[plane + i] = hw[3 * i + 1];
    out[2 * plane + i] = hw[3 * i + 2];
  }
  return 0;
} catch (...) {
  // a C++ exception (e.g. bad_alloc) must never unwind through the
  // ctypes FFI boundary — report failure and let the caller fall back
  return 100;
}

// Decode `path`, convert to grayscale (PIL "L"), nearest-resize to
// out_size x out_size, write raw uint8 values (out_size * out_size bytes).
int load_gray_resize_nearest(const char* path, int out_size, uint8_t* out) try {
  DecodeResult res;
  const int rc = decode_file(path, res);
  if (rc != 0) return rc;
  if (res.ch == 3) rgb_to_gray(res);
  std::vector<int> xs, ys;
  nearest_indices(res.w, out_size, xs);
  nearest_indices(res.h, out_size, ys);
  for (int y = 0; y < out_size; ++y) {
    const uint8_t* row = res.pixels.data() + static_cast<size_t>(ys[y]) * res.w;
    uint8_t* orow = out + static_cast<size_t>(y) * out_size;
    for (int x = 0; x < out_size; ++x) orow[x] = row[xs[x]];
  }
  return 0;
} catch (...) {
  return 100;  // see load_rgb_resize_chw: no unwind across the FFI
}

}  // extern "C"
