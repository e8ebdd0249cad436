// Host image IO of the PyTorch port, with no dependency:
//
//   * jpeg_header / jpeg_decode: a baseline (SOF0 / SOF1, 8-bit, Huffman,
//     one scan) JPEG decoder equal bit for bit to libjpeg-turbo's default
//     decompression, which is what cv2.imread(path, IMREAD_COLOR) runs: the
//     "islow" integer IDCT (jidctint.c), fancy upsampling (jdsample.c), the
//     YCbCr -> RGB tables of jdcolor.c, written as BGR. The Exif orientation
//     is returned by jpeg_header and applied by the caller.
//   * resize_linear_u8: cv2.resize(..., INTER_LINEAR) for [H, W, C] uint8,
//     the C++ transcription of data/cv2_ops.py::resize_u8_reference.
//
// Built by streamyolo_torch/native/__init__.py with g++ (-ffp-contract=off:
// the resize's float map must round as NumPy's does; -fwrapv: corrupt
// coefficients wrap instead of being undefined) and bound with ctypes. Every
// entry point returns 0, or -1 with a message in `err` for a file it refuses.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ------------------------------------------------------------ sample tables

// jdmaster.c prepare_range_limit_table, as the IDCT indexes it:
// idct_limit[x & 1023] for x = the descaled IDCT output (centred on 0).
struct Tables {
  uint8_t idct_limit[1024];
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  Tables() {
    for (int x = 0; x < 1024; ++x) {
      int v;
      if (x < 128) v = x + 128;         // 0..127 -> 128..255
      else if (x < 512) v = 255;        // overshoot
      else if (x < 896) v = 0;          // undershoot (wrapped negative)
      else v = x - 896;                 // -128..-1 -> 0..127
      idct_limit[x] = (uint8_t)v;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF, FIX(x)
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return (int64_t)(x * (double)(int64_t(1) << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = (int32_t)(-fix(0.71414) * x);
      cb_g[i] = (int32_t)(-fix(0.34414) * x + one_half);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ------------------------------------------------------------ Huffman tables

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {0};  // bits[l]: number of codes of length l
  uint8_t vals[256] = {0};
  int32_t maxcode[18];     // largest code of length l, -1 if none
  int32_t valoffset[17];   // vals index of a code of length l, minus the code
  uint16_t look[1 << 9];   // (length << 8) | value for codes up to 9 bits; 0: longer
};

constexpr int kLookBits = 9;

// jdhuff.c jpeg_make_d_derived_tbl
void derive(Huffman& t, bool is_dc) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += t.bits[l];
  if (count > 256) fail("bad Huffman table: more than 256 codes");
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.bits[l]; ++i) size[p++] = (uint8_t)l;
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (uint32_t(1) << si)) fail("bad Huffman table: code space overflow");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      t.valoffset[l] = p - (int32_t)code_of[p];
      p += t.bits[l];
      t.maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < t.bits[l]; ++i, ++p) {
      uint32_t first = code_of[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (uint32_t(1) << (kLookBits - l)); ++k)
        t.look[first + k] = (uint16_t)((l << 8) | t.vals[p]);
    }
  }
  if (is_dc)
    for (int i = 0; i < count; ++i)
      if (t.vals[i] > 15) fail("bad Huffman table: DC category above 15");
  t.defined = true;
}

// jstdhuff.c: the tables libjpeg-turbo supplies for slots 0 and 1 when a
// file has no DHT (Motion-JPEG frames)
void set_std(Huffman& t, const uint8_t* bits, const uint8_t* vals, bool is_dc) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += (t.bits[l] = bits[l - 1]);
  std::memcpy(t.vals, vals, count);
  derive(t, is_dc);
}

const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ------------------------------------------------------------ bit reader

// Entropy-coded bytes with FF 00 unstuffed. At a marker (or the end of the
// data) it feeds zero bits, as libjpeg does, but counts them: consuming one
// means the data ended early, which raises where libjpeg warns.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  int pad = 0;  // zero bits fed past the data, at the bottom of acc
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b != 0xFF) {
          ++p;
        } else {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes before a marker
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            p = q - 1;  // the FF of the marker
            at_marker = true;
            b = 0;
          }
        }
      } else {
        at_marker = true;
      }
      if (at_marker) pad += 8;
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }

  uint32_t peek(int n) const { return (uint32_t)(acc >> (64 - n)); }

  void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < pad) fail("corrupt JPEG data: premature end of data segment");
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)peek(n);
    skip(n);
    return v;
  }

  int decode(const Huffman& t) {
    if (nbits < 32) fill();
    uint16_t hit = t.look[peek(kLookBits)];
    if (hit) {
      skip(hit >> 8);
      return hit & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = (int32_t)peek(l);
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[t.valoffset[l] + code];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }

  // libjpeg's process_restart: drop the buffered bits, then the next marker
  // must be RSTn (bytes before it are skipped, as libjpeg skips them)
  void restart(int expected) {
    acc = 0;
    nbits = 0;
    pad = 0;
    if (!at_marker) {
      while (p < end && *p != 0xFF) ++p;
      while (p + 1 < end && p[1] == 0xFF) ++p;
    }
    if (p + 1 >= end || p[1] != 0xD0 + expected)
      fail("corrupt JPEG data: restart marker RST" + std::to_string(expected) + " not found");
    p += 2;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------------ IDCT

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, columns then rows
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride,
                const uint8_t* limit) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (int32_t(in[0]) * q[0]) << kPass1Bits;
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = int32_t(in[16]) * q[16], z3 = int32_t(in[48]) * q[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * q[0];
    z3 = int32_t(in[32]) * q[32];
    int32_t tmp0 = (z2 + z3) << kConstBits;
    int32_t tmp1 = (z2 - z3) << kConstBits;
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * q[56];
    tmp1 = int32_t(in[40]) * q[40];
    tmp2 = int32_t(in[24]) * q[24];
    tmp3 = int32_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = limit[descale(w[0], kPass1Bits + 3) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) << kConstBits;
    int32_t tmp1 = (w[0] - w[4]) << kConstBits;
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[descale(tmp10 + tmp3, n) & 1023];
    o[7] = limit[descale(tmp10 - tmp3, n) & 1023];
    o[1] = limit[descale(tmp11 + tmp2, n) & 1023];
    o[6] = limit[descale(tmp11 - tmp2, n) & 1023];
    o[2] = limit[descale(tmp12 + tmp1, n) & 1023];
    o[5] = limit[descale(tmp12 - tmp1, n) & 1023];
    o[3] = limit[descale(tmp13 + tmp0, n) & 1023];
    o[4] = limit[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ------------------------------------------------------------ parsing

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;  // sampling factors, quant table slot
  int td = 0, ta = 0;                // Huffman slots (from SOS)
  int dw = 0, dh = 0;                // downsampled_width / _height
  int stride = 0, rows = 0;          // plane size, MCU padded
  std::vector<uint8_t> plane;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int orientation = 0;  // Exif tag 0x0112 of the first APP1 Exif segment, 0 if none
  int restart = 0;      // DRI interval in MCUs
  bool have_frame = false, have_quant[4] = {false, false, false, false};
  int adobe_transform = -1;
  Component comp[3];
  int16_t quant[4][64];  // natural order; libjpeg keeps them as short
  Huffman dc[4], ac[4];
  const uint8_t* scan = nullptr;  // first byte of the entropy-coded data
  const uint8_t* end = nullptr;
};

inline int u16be(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 8) return 0;
  bool le;
  if (d[0] == 'I' && d[1] == 'I') le = true;
  else if (d[0] == 'M' && d[1] == 'M') le = false;
  else return 0;
  auto rd16 = [&](size_t o) -> uint32_t {
    return le ? (d[o] | (d[o + 1] << 8)) : ((d[o] << 8) | d[o + 1]);
  };
  auto rd32 = [&](size_t o) -> uint32_t {
    return le ? (rd16(o) | (rd16(o + 2) << 16)) : ((rd16(o) << 16) | rd16(o + 2));
  };
  if (rd16(2) != 0x2A) return 0;
  size_t ifd = rd32(4);
  if (ifd + 2 > n) return 0;
  uint32_t count = rd16(ifd);
  for (uint32_t i = 0; i < count; ++i) {
    size_t e = ifd + 2 + 12 * (size_t)i;
    if (e + 12 > n) break;
    if (rd16(e) == 0x0112) return (int)rd16(e + 8);
  }
  return 0;
}

std::string hex2(int m) {
  const char* digits = "0123456789ABCDEF";
  return std::string("0x") + digits[(m >> 4) & 15] + digits[m & 15];
}

void parse_sof(Jpeg& j, const uint8_t* s, int len) {
  if (j.have_frame) fail("more than one frame header (SOF)");
  if (len < 6) fail("corrupt JPEG data: short SOF segment");
  if (s[0] != 8) fail(std::to_string(s[0]) + "-bit precision is not supported (8-bit only)");
  j.height = u16be(s + 1);
  j.width = u16be(s + 3);
  j.ncomp = s[5];
  if (j.height == 0 || j.width == 0)
    fail("image height or width of 0 (a DNL marker) is not supported");
  if (j.ncomp == 4) fail("4-component (CMYK / YCCK) JPEG is not supported");
  if (j.ncomp != 1 && j.ncomp != 3)
    fail(std::to_string(j.ncomp) + "-component JPEG is not supported");
  if (len < 6 + 3 * j.ncomp) fail("corrupt JPEG data: short SOF segment");
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail("bad sampling factors in SOF");
    if (k.tq > 3) fail("bad quantization table slot in SOF");
    j.hmax = std::max(j.hmax, k.h);
    j.vmax = std::max(j.vmax, k.v);
  }
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (j.hmax % k.h || j.vmax % k.v)
      fail("fractional sampling factors are not supported");
    k.dw = (int)(((int64_t)j.width * k.h + j.hmax - 1) / j.hmax);
    k.dh = (int)(((int64_t)j.height * k.v + j.vmax - 1) / j.vmax);
  }
  j.have_frame = true;
}

void parse_dqt(Jpeg& j, const uint8_t* s, int len) {
  int o = 0;
  while (o < len) {
    int pq = s[o] >> 4, tq = s[o] & 15;
    if (pq > 1 || tq > 3) fail("bad DQT segment");
    int need = 1 + 64 * (pq + 1);
    if (o + need > len) fail("corrupt JPEG data: short DQT segment");
    for (int k = 0; k < 64; ++k) {
      int v = pq ? u16be(s + o + 1 + 2 * k) : s[o + 1 + k];
      j.quant[tq][kNatural[k]] = (int16_t)v;
    }
    j.have_quant[tq] = true;
    o += need;
  }
}

void parse_dht(Jpeg& j, const uint8_t* s, int len) {
  int o = 0;
  while (o < len) {
    if (o + 17 > len) fail("corrupt JPEG data: short DHT segment");
    int tc = s[o] >> 4, th = s[o] & 15;
    if (tc > 1 || th > 3) fail("bad DHT segment");
    Huffman& t = tc ? j.ac[th] : j.dc[th];
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += (t.bits[l] = s[o + l]);
    if (count > 256 || o + 17 + count > len) fail("corrupt JPEG data: bad DHT segment");
    std::memcpy(t.vals, s + o + 17, count);
    derive(t, tc == 0);
    o += 17 + count;
  }
}

void parse_sos(Jpeg& j, const uint8_t* s, int len) {
  if (!j.have_frame) fail("scan (SOS) before the frame header (SOF)");
  if (len < 1) fail("corrupt JPEG data: short SOS segment");
  int ns = s[0];
  if (len < 4 + 2 * ns) fail("corrupt JPEG data: short SOS segment");
  if (ns != j.ncomp)
    fail("multi-scan JPEG is not supported (a scan of " + std::to_string(ns) + " of " +
         std::to_string(j.ncomp) + " components)");
  for (int i = 0; i < ns; ++i) {
    int cs = s[1 + 2 * i], slots = s[2 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == cs) k = &j.comp[c];
    if (k == nullptr || k != &j.comp[i]) fail("scan components do not match the frame header");
    k->td = slots >> 4;
    k->ta = slots & 15;
    if (k->td > 3 || k->ta > 3) fail("bad Huffman table slot in SOS");
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
  if (ss != 0 || se != 63 || ah != 0 || al != 0) fail("bad spectral selection in a baseline scan");
}

// Markers from SOI up to the first SOS; without `to_scan` (the header
// alone) it stops as soon as the frame header and an Exif orientation have
// both been read.
void parse_headers(Jpeg& j, const uint8_t* buf, size_t n, bool to_scan) {
  if (n == 0) fail("empty file");
  if (n >= 8 && std::memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0)
    fail("not a JPEG file: PNG data (only baseline JPEG is supported)");
  if (n < 2 || buf[0] != 0xFF || buf[1] != 0xD8)
    fail("not a JPEG file: starts with " + hex2(buf[0]) + (n > 1 ? " " + hex2(buf[1]) : ""));
  const uint8_t* p = buf + 2;
  const uint8_t* end = buf + n;
  j.end = end;
  bool saw_exif = false;
  for (;;) {
    // cv2 refuses stray bytes between these segments (libjpeg would warn)
    if (p < end && *p != 0xFF) fail("corrupt JPEG data: extraneous bytes before a marker");
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("corrupt JPEG data: premature end of file before the scan");
    int m = *p++;
    if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no length
    if (m == 0xD9) fail("corrupt JPEG data: end of image before the scan");
    if (end - p < 2) fail("corrupt JPEG data: premature end of file in a marker");
    int len = u16be(p) - 2;
    if (len < 0 || end - p - 2 < len) fail("corrupt JPEG data: premature end of file in a marker");
    const uint8_t* s = p + 2;
    p = s + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
        parse_sof(j, s, len);
        break;
      case 0xC2:
        fail("progressive JPEG (SOF2) is not supported");
      case 0xC3:
        fail("lossless JPEG (SOF3) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      case 0xCC:
        fail("arithmetic-coded JPEG (DAC) is not supported");
      case 0xC4:
        parse_dht(j, s, len);
        break;
      case 0xDB:
        parse_dqt(j, s, len);
        break;
      case 0xDD:
        if (len < 2) fail("corrupt JPEG data: short DRI segment");
        j.restart = u16be(s);
        break;
      case 0xE1:
        if (!saw_exif && len >= 6 && std::memcmp(s, "Exif\0\0", 6) == 0) {
          saw_exif = true;
          j.orientation = exif_orientation(s + 6, (size_t)len - 6);
        }
        break;
      case 0xEE:
        if (len >= 12 && std::memcmp(s, "Adobe", 5) == 0) j.adobe_transform = s[11];
        break;
      case 0xDA:
        parse_sos(j, s, len);
        j.scan = p;
        return;
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) break;  // APPn, COM
        fail("unsupported JPEG marker " + hex2(m));
    }
    if (!to_scan && j.have_frame && saw_exif) return;
  }
}

void check_colour(const Jpeg& j) {
  if (j.ncomp != 3) return;
  if (j.adobe_transform >= 0 && j.adobe_transform != 1)
    fail("Adobe APP14 colour transform " + std::to_string(j.adobe_transform) +
         " (RGB / YCCK) is not supported");
  if (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B')
    fail("RGB-coded JPEG is not supported");
}

// ------------------------------------------------------------ decoding

void decode_scan(Jpeg& j) {
  const Tables& tab = tables();
  const uint8_t* limit = tab.idct_limit;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (!j.have_quant[k.tq]) fail("quantization table " + std::to_string(k.tq) + " not defined");
    if (!j.dc[k.td].defined) {
      if (k.td > 1) fail("DC Huffman table " + std::to_string(k.td) + " not defined");
      set_std(j.dc[k.td], k.td ? kDcChromBits : kDcLumBits, kDcVals, true);
    }
    if (!j.ac[k.ta].defined) {
      if (k.ta > 1) fail("AC Huffman table " + std::to_string(k.ta) + " not defined");
      set_std(j.ac[k.ta], k.ta ? kAcChromBits : kAcLumBits, k.ta ? kAcChromVals : kAcLumVals,
              false);
    }
  }
  bool single = j.ncomp == 1;
  int mcux, mcuy;
  if (single) {
    mcux = (j.comp[0].dw + 7) / 8;
    mcuy = (j.comp[0].dh + 7) / 8;
    j.comp[0].h = j.comp[0].v = 1;  // a lone component's MCU is one block
    j.hmax = j.vmax = 1;
  } else {
    mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  }
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.stride = mcux * k.h * 8;
    k.rows = mcuy * k.v * 8;
    k.plane.assign((size_t)k.stride * k.rows, 0);
  }
  BitReader br(j.scan, j.end);
  int pred[3] = {0, 0, 0};
  int16_t coef[64];
  int64_t total = (int64_t)mcux * mcuy, todo = j.restart;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart) {
      if (todo == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = 0;
        todo = j.restart;
      }
      --todo;
    }
    int mx = (int)(m % mcux), my = (int)(m / mcux);
    for (int c = 0; c < j.ncomp; ++c) {
      Component& k = j.comp[c];
      const Huffman& dc = j.dc[k.td];
      const Huffman& ac = j.ac[k.ta];
      const int16_t* q = j.quant[k.tq];
      for (int by = 0; by < k.v; ++by) {
        for (int bx = 0; bx < k.h; ++bx) {
          std::memset(coef, 0, sizeof coef);
          int s = br.decode(dc);
          if (s) pred[c] += extend(br.bits(s), s);
          coef[0] = (int16_t)pred[c];
          bool any_ac = false;
          for (int z = 1; z < 64; ++z) {
            int rs = br.decode(ac);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              z += r;
              if (z > 63) fail("corrupt JPEG data: coefficient index past 63");
              coef[kNatural[z]] = (int16_t)extend(br.bits(s), s);
              any_ac = true;
            } else {
              if (r != 15) break;
              z += 15;
            }
          }
          uint8_t* out = k.plane.data() + (size_t)((my * k.v + by) * 8) * k.stride +
                         (size_t)(mx * k.h + bx) * 8;
          if (!any_ac) {  // jidctint.c's all-zero shortcuts, taken for the whole block
            int32_t dc0 = (int32_t(coef[0]) * q[0]) << kPass1Bits;
            uint8_t v = limit[descale(dc0, kPass1Bits + 3) & 1023];
            for (int r = 0; r < 8; ++r) std::memset(out + (size_t)r * k.stride, v, 8);
          } else {
            idct_islow(coef, q, out, k.stride, limit);
          }
        }
      }
    }
  }
  // after the scan, up to EOI (bytes before a marker are skipped, as cv2
  // skips them); a second SOS would be a multi-scan file. Without an EOI
  // cv2 returns no image (its reader suspends at the end of the data).
  const uint8_t* p = br.p;
  const uint8_t* end = j.end;
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("corrupt JPEG data: premature end of file (no EOI marker)");
    int m = *p++;
    if (m == 0xD9) return;
    if (m == 0xDA) fail("multi-scan JPEG is not supported (a second SOS)");
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) continue;
    if (end - p < 2) fail("corrupt JPEG data: premature end of file (no EOI marker)");
    p += u16be(p);
  }
}

// jdsample.c, one output row of component `k` at image row y, at least
// `width` samples, into `tmp` (or a pointer into the plane when 1:1)
const uint8_t* upsample_row(const Component& k, int hr, int vr, int y, uint8_t* tmp) {
  const uint8_t* plane = k.plane.data();
  const int dw = k.dw;
  if (hr == 1 && vr == 1) return plane + (size_t)y * k.stride;
  if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
    const uint8_t* in = plane + (size_t)y * k.stride;
    tmp[0] = in[0];
    tmp[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < dw - 1; ++i) {
      int v = in[i] * 3;
      tmp[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
      tmp[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
    }
    tmp[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    tmp[2 * dw - 1] = in[dw - 1];
    return tmp;
  }
  if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
    int iy = y >> 1;
    bool below = y & 1;
    int far = below ? std::min(iy + 1, k.dh - 1) : std::max(iy - 1, 0);
    const uint8_t* n0 = plane + (size_t)iy * k.stride;
    const uint8_t* n1 = plane + (size_t)far * k.stride;
    int bias = below ? 2 : 1;
    for (int i = 0; i < dw; ++i) tmp[i] = (uint8_t)((n0[i] * 3 + n1[i] + bias) >> 2);
    return tmp;
  }
  if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
    int iy = y >> 1;
    bool below = y & 1;
    int far = below ? std::min(iy + 1, k.dh - 1) : std::max(iy - 1, 0);
    const uint8_t* n0 = plane + (size_t)iy * k.stride;
    const uint8_t* n1 = plane + (size_t)far * k.stride;
    int last = n0[0] * 3 + n1[0];
    int cur = last;
    int next = n0[1] * 3 + n1[1];
    tmp[0] = (uint8_t)((cur * 4 + 8) >> 4);
    tmp[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int i = 1; i < dw - 1; ++i) {
      next = n0[i + 1] * 3 + n1[i + 1];
      tmp[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
      tmp[2 * i + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    tmp[2 * dw - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
    tmp[2 * dw - 1] = (uint8_t)((cur * 4 + 7) >> 4);
    return tmp;
  }
  // int_upsample (and h2v1_upsample / h2v2_upsample where dw <= 2): replicate
  const uint8_t* in = plane + (size_t)(y / vr) * k.stride;
  for (int i = 0; i < dw; ++i) std::memset(tmp + (size_t)i * hr, in[i], hr);
  return tmp;
}

void decode_to_bgr(Jpeg& j, uint8_t* out) {
  decode_scan(j);
  const Tables& tab = tables();
  const int w = j.width;
  std::vector<uint8_t> tmp[3];
  for (int c = 0; c < j.ncomp; ++c) tmp[c].assign((size_t)j.comp[c].dw * j.hmax + 16, 0);
  for (int y = 0; y < j.height; ++y) {
    uint8_t* o = out + (size_t)y * w * 3;
    if (j.ncomp == 1) {
      const uint8_t* g = j.comp[0].plane.data() + (size_t)y * j.comp[0].stride;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    const uint8_t* row[3];
    for (int c = 0; c < 3; ++c) {
      const Component& k = j.comp[c];
      row[c] = upsample_row(k, j.hmax / k.h, j.vmax / k.v, y, tmp[c].data());
    }
    const uint8_t *yy = row[0], *cb = row[1], *cr = row[2];
    for (int x = 0; x < w; ++x) {
      int l = yy[x], b = cb[x], r = cr[x];
      o[3 * x] = clamp255(l + tab.cb_b[b]);
      o[3 * x + 1] = clamp255(l + ((tab.cb_g[b] + tab.cr_g[r]) >> 16));
      o[3 * x + 2] = clamp255(l + tab.cr_r[r]);
    }
  }
}

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err == nullptr || errlen <= 0) return;
  std::strncpy(err, msg, (size_t)errlen - 1);
  err[errlen - 1] = '\0';
}

// ------------------------------------------------------------ resize

// cv2's source indices and 11-bit weights along one axis (see
// data/cv2_ops.py::_linear_taps): the half-pixel map in float32; `clamp`
// pins the taps outside the image to the border with weights (1, 0).
void linear_taps(int64_t n_in, int64_t n_out, bool clamp, std::vector<int64_t>& i0v,
                 std::vector<int64_t>& i1v, std::vector<int32_t>& w0v,
                 std::vector<int32_t>& w1v) {
  const double scale = 1.0 / ((double)n_out / (double)n_in);
  i0v.resize(n_out);
  i1v.resize(n_out);
  w0v.resize(n_out);
  w1v.resize(n_out);
  for (int64_t i = 0; i < n_out; ++i) {
    float f = (float)(((double)i + 0.5) * scale - 0.5);
    float fl = std::floor(f);
    int64_t i0 = (int64_t)fl;
    float frac = f - (float)i0;
    if (clamp) {
      if (i0 < 0) {
        i0 = 0;
        frac = 0.0f;
      }
      if (i0 >= n_in - 1) {
        i0 = n_in - 1;
        frac = 0.0f;
      }
    }
    int64_t i1 = std::min(std::max(i0 + 1, int64_t(0)), n_in - 1);
    i0 = std::min(std::max(i0, int64_t(0)), n_in - 1);
    i0v[i] = i0;
    i1v[i] = i1;
    w0v[i] = (int32_t)std::nearbyint((1.0f - frac) * 2048.0f);
    w1v[i] = (int32_t)std::nearbyint(frac * 2048.0f);
  }
}

// (a + b + c + d + 2) >> 2 over each 2x2 block; C > 0 fixes the channels
// at compile time (the 3-channel frame), C == 0 reads them from c
template <int C>
void halve(const uint8_t* src, int64_t oh, int64_t ow, int64_t c_, uint8_t* dst) {
  const int64_t c = C ? C : c_;
  const size_t n = (size_t)(2 * ow) * c;
  std::vector<uint16_t> pair(n);
  for (int64_t y = 0; y < oh; ++y) {
    const uint8_t* r0 = src + (size_t)(2 * y) * n;
    const uint8_t* r1 = r0 + n;
    for (size_t i = 0; i < n; ++i) pair[i] = (uint16_t)(r0[i] + r1[i]);
    uint8_t* o = dst + (size_t)y * ow * c;
    for (int64_t x = 0; x < ow; ++x) {
      const uint16_t* a = pair.data() + (size_t)(2 * x) * c;
      for (int64_t k = 0; k < c; ++k) o[x * c + k] = (uint8_t)((a[k] + a[k + c] + 2) >> 2);
    }
  }
}

// the general INTER_LINEAR path (see data/cv2_ops.py::resize_u8_reference);
// C as in halve
template <int C>
void interpolate(const uint8_t* src, int64_t h, int64_t w, int64_t c_, uint8_t* dst,
                 int64_t oh, int64_t ow) {
  std::vector<int64_t> x0, x1, y0, y1;
  std::vector<int32_t> wx0, wx1, wy0, wy1;
  linear_taps(w, ow, true, x0, x1, wx0, wx1);
  linear_taps(h, oh, false, y0, y1, wy0, wy1);
  const int64_t c = C ? C : c_;
  const size_t n = (size_t)ow * c;
  // the horizontal pass of two source rows, each tagged with its row index
  std::vector<int32_t> rows[2] = {std::vector<int32_t>(n), std::vector<int32_t>(n)};
  int64_t tag[2] = {-1, -1};
  auto horizontal = [&](int64_t sy) -> const int32_t* {
    for (int i = 0; i < 2; ++i)
      if (tag[i] == sy) return rows[i].data();
    int slot = (tag[0] == -1 || (tag[1] != -1 && tag[0] < tag[1])) ? 0 : 1;
    const uint8_t* s = src + (size_t)sy * w * c;
    int32_t* r = rows[slot].data();
    for (int64_t x = 0; x < ow; ++x) {
      const uint8_t* a = s + x0[x] * c;
      const uint8_t* b = s + x1[x] * c;
      for (int64_t k = 0; k < c; ++k) r[x * c + k] = (a[k] * wx0[x] + b[k] * wx1[x]) >> 4;
    }
    tag[slot] = sy;
    return r;
  };
  for (int64_t y = 0; y < oh; ++y) {
    const int32_t* r0 = horizontal(y0[y]);
    const int32_t* r1 = horizontal(y1[y]);
    const int32_t b0 = wy0[y], b1 = wy1[y];
    uint8_t* o = dst + (size_t)y * n;
    for (size_t i = 0; i < n; ++i)
      o[i] = clamp255((((r0[i] * b0) >> 16) + ((r1[i] * b1) >> 16) + 2) >> 2);
  }
}

}  // namespace

extern "C" {

// Header alone: info = {height, width, orientation}, the size before the
// orientation is applied. Returns 0, or -1 with `err` set.
int jpeg_header(const uint8_t* buf, int64_t n, int64_t* info, char* err, int64_t errlen) {
  try {
    Jpeg j;
    parse_headers(j, buf, (size_t)n, false);
    if (!j.have_frame) fail("no frame header (SOF) before the scan");
    info[0] = j.height;
    info[1] = j.width;
    info[2] = j.orientation;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// The whole file to [height, width, 3] BGR uint8 in `out` (the size that
// jpeg_header gave). Returns 0, or -1 with `err` set.
int jpeg_decode(const uint8_t* buf, int64_t n, uint8_t* out, int64_t height, int64_t width,
                char* err, int64_t errlen) {
  try {
    Jpeg j;
    parse_headers(j, buf, (size_t)n, true);
    if (j.height != height || j.width != width) fail("output size does not match the header");
    check_colour(j);
    decode_to_bgr(j, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// cv2.resize(src, (ow, oh), interpolation=INTER_LINEAR) of a [h, w, c]
// uint8 image into dst [oh, ow, c] (h, w, oh, ow >= 1).
void resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, uint8_t* dst,
                      int64_t oh, int64_t ow) {
  if (h == 2 * oh && w == 2 * ow) {  // cv2's exact 2x downsample: the 2x2 average
    if (c == 3) halve<3>(src, oh, ow, c, dst);
    else halve<0>(src, oh, ow, c, dst);
    return;
  }
  if (c == 3) interpolate<3>(src, h, w, c, dst, oh, ow);
  else interpolate<0>(src, h, w, c, dst, oh, ow);
}

}  // extern "C"
