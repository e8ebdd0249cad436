// Host image IO of the PyTorch port, with no dependency:
//
//   * jpeg_header / jpeg_decode: a JPEG decoder (8-bit DCT or 2- to 8-bit
//     lossless frames, Huffman or arithmetic coding, 1, 3 or 4 components)
//     equal bit for bit to libjpeg-turbo's default decompression, which is
//     what cv2.imread(path, IMREAD_COLOR) runs: the "islow" integer IDCT
//     (jidctint.c), fancy upsampling (jdsample.c), the colour conversions of
//     jdcolor.c written as BGR, and OpenCV's CMYK -> BGR. A one-scan
//     sequential file (SOF0 / SOF1 / SOF9) is decoded block by block as it
//     is read; a progressive one (SOF2 / SOF10) or one whose scans hold part
//     of the components goes scan by scan through a whole-image coefficient
//     buffer up to EOI (jdcoefct.c), then through the IDCT, block-smoothed
//     where its last refinement scans are missing. Under both, a scan's
//     entropy decoder is Huffman (jdhuff.c, jdphuff.c) or arithmetic
//     (jdarith.c). A lossless file (SOF3) is undifferenced scan by scan
//     into the planes (jdlhuff.c, jdlossls.c, jddiffct.c). The colour space
//     follows jdapimin.c (JFIF, Adobe transform, component ids). Lossless
//     arithmetic-coded and hierarchical frames, 12-bit samples and the
//     colour conversions libjpeg refuses in lossless mode are refused, as
//     cv2 refuses them. The Exif orientation is returned by jpeg_header and
//     applied by the caller.
//   * jpeg_encode: libjpeg-turbo's default compression, which is what
//     cv2.imencode('.jpg') runs, byte for byte: jpeg_set_quality's tables,
//     the YCbCr tables of jccolor.c, 4:2:0 by jcsample.c's h2v2_downsample,
//     jcprepct.c's edge expansion and jccoefct.c's dummy blocks, the islow
//     FDCT (jfdctint.c), the standard Huffman tables, jcmarker.c's segments.
//   * png_decode: the pixel half of a PNG read (unfiltering, Adam7, the
//     conversions of cv2.imread with IMREAD_COLOR); data/image_io.py parses
//     the chunks and inflates the data. exif_orientation_tag reads a PNG's
//     eXIf chunk.
//   * resize_linear_u8: cv2.resize(..., INTER_LINEAR) for [H, W, C] uint8,
//     the C++ transcription of data/cv2_ops.py::resize_u8_reference.
//
// Built by streamyolo_torch/native/__init__.py with g++ (-ffp-contract=off:
// the resize's float map must round as NumPy's does; -fwrapv: corrupt
// coefficients wrap instead of being undefined) and bound with ctypes. Every
// entry point that can fail returns a negative value with a message in `err`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// zigzag index -> natural (row-major) index; as jutils.c's
// jpeg_natural_order, 16 entries past the end read 63, so that a corrupt
// run past the band lands on the last coefficient
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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

// jdhuff.c jpeg_make_d_derived_tbl (a DC table's values are checked where
// a scan uses it, by huffman_table)
void derive(Huffman& t) {
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
  t.defined = true;
}

// jstdhuff.c: the tables libjpeg-turbo supplies for slots 0 and 1 when a
// file has no DHT (Motion-JPEG frames)
void set_std(Huffman& t, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += (t.bits[l] = bits[l - 1]);
  std::memcpy(t.vals, vals, count);
  derive(t);
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
  int dw = 0, dh = 0;                // downsampled_width / _height
  int stride = 0, rows = 0;          // plane size, MCU padded
  std::vector<uint8_t> plane;
};

// One SOS segment: its components (frame indices, in scan order), their
// entropy table slots, the spectral band (a lossless scan's predictor in
// Ss) and the successive-approximation bits (its point transform in Al)
struct Scan {
  int ns = 0;
  int comp[4] = {0, 0, 0, 0};
  int td[4] = {0, 0, 0, 0}, ta[4] = {0, 0, 0, 0};
  int ss = 0, se = 63, ah = 0, al = 0;
};

// The colour space of the frame's components (jdapimin.c)
enum class Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, precision = 8;
  int orientation = 0;  // Exif tag 0x0112 of the first APP1 Exif segment, 0 if none
  int restart = 0;      // DRI interval in MCUs
  bool have_frame = false, have_quant[4] = {false, false, false, false};
  bool progressive = false;  // SOF2 / SOF10
  bool arithmetic = false;   // SOF9 / SOF10
  bool lossless = false;     // SOF3
  bool saw_jfif = false;     // a JFIF APP0 segment
  int adobe_transform = -1;  // of the last Adobe APP14 segment, -1 if none
  // DAC conditioning by table slot (jdmarker.c get_soi's defaults)
  uint8_t dc_l[16], dc_u[16], ac_k[16];
  Component comp[4];
  int16_t quant[4][64];  // natural order; libjpeg keeps them as short
  Huffman dc[4], ac[4];
  Scan first;                     // the first SOS
  const uint8_t* scan = nullptr;  // first byte of the entropy-coded data
  const uint8_t* end = nullptr;
  Jpeg() {
    std::fill(dc_l, dc_l + 16, 0);
    std::fill(dc_u, dc_u + 16, 1);
    std::fill(ac_k, ac_k + 16, 5);
  }
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

// jdmarker.c get_sof, and jdinput.c's precision check: 8 bits for a DCT
// frame (cv2 reads no 12-bit sample), 2 to 8 for a lossless one
void parse_sof(Jpeg& j, int m, const uint8_t* s, int len) {
  if (j.have_frame) fail("more than one frame header (SOF)");
  if (len < 6) fail("corrupt JPEG data: short SOF segment");
  j.progressive = m == 0xC2 || m == 0xCA;
  j.arithmetic = m == 0xC9 || m == 0xCA;
  j.lossless = m == 0xC3;
  j.precision = s[0];
  if (j.lossless) {
    if (s[0] < 2 || s[0] > 8)
      fail(std::to_string(s[0]) + "-bit lossless JPEG is not supported (2 to 8 bits only)");
  } else if (s[0] != 8) {
    fail(std::to_string(s[0]) + "-bit precision is not supported (8-bit only)");
  }
  j.height = u16be(s + 1);
  j.width = u16be(s + 3);
  j.ncomp = s[5];
  if (j.height == 0 || j.width == 0)
    fail("image height or width of 0 (a DNL marker) is not supported");
  if (j.ncomp != 1 && j.ncomp != 3 && j.ncomp != 4)
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
    derive(t);
    o += 17 + count;
  }
}

// jdmarker.c get_dac: the arithmetic conditioning of DC table slots 0-15
// (L in the low, U in the high nibble, L <= U) and AC slots 16-31 (Kx)
void parse_dac(Jpeg& j, const uint8_t* s, int len) {
  if (len % 2) fail("corrupt JPEG data: bad DAC segment length");
  for (int o = 0; o < len; o += 2) {
    const int index = s[o], val = s[o + 1];
    if (index >= 32) fail("bad DAC segment: table index " + std::to_string(index));
    if (index >= 16) {
      j.ac_k[index - 16] = (uint8_t)val;
    } else {
      if ((val & 15) > (val >> 4)) fail("bad DAC segment: L above U (" + hex2(val) + ")");
      j.dc_l[index] = (uint8_t)(val & 15);
      j.dc_u[index] = (uint8_t)(val >> 4);
    }
  }
}

// jdmarker.c get_sos. A scan's i-th component is matched to the first
// frame component of its id at index i or later (libjpeg-turbo's guard
// against repeated ids): a scan that names a component before one that
// precedes it in the frame is refused, as libjpeg refuses it, unless the
// later one still finds an index at or past its position.
void parse_sos(Jpeg& j, const uint8_t* s, int len, Scan& sc) {
  if (!j.have_frame) fail("scan (SOS) before the frame header (SOF)");
  if (len < 1) fail("corrupt JPEG data: short SOS segment");
  const int ns = s[0];
  if (ns < 1 || ns > 4 || len != 4 + 2 * ns) fail("corrupt JPEG data: bad SOS segment");
  sc.ns = ns;
  for (int i = 0; i < ns; ++i) {
    const int cs = s[1 + 2 * i], slots = s[2 + 2 * i];
    int found = -1;
    for (int c = i; c < j.ncomp && found < 0; ++c)
      if (j.comp[c].id == cs) found = c;
    if (found < 0) fail("scan component " + std::to_string(cs) + " is not in the frame header");
    sc.comp[i] = found;
    sc.td[i] = slots >> 4;
    sc.ta[i] = slots & 15;
  }
  sc.ss = s[1 + 2 * ns];
  sc.se = s[2 + 2 * ns];
  sc.ah = s[3 + 2 * ns] >> 4;
  sc.al = s[3 + 2 * ns] & 15;
}

// DHT, DQT, DAC, DRI and the segments skipped (APPn, COM, DNL), wherever
// they stand; false for any other marker
bool table_segment(Jpeg& j, int m, const uint8_t* s, int len) {
  switch (m) {
    case 0xC4:
      parse_dht(j, s, len);
      return true;
    case 0xCC:
      parse_dac(j, s, len);
      return true;
    case 0xDB:
      parse_dqt(j, s, len);
      return true;
    case 0xDD:
      if (len < 2) fail("corrupt JPEG data: short DRI segment");
      j.restart = u16be(s);
      return true;
    case 0xDC:  // DNL: libjpeg skips it
    case 0xFE:
      return true;
    default:
      return m >= 0xE0 && m <= 0xEF;
  }
}

// The frame types libjpeg-turbo refuses (JERR_SOF_UNSUPPORTED) or cannot
// read with cv2's 8-bit calls
[[noreturn]] void refuse_frame(int m) {
  if (m == 0xCB) fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
  fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
}

// Markers from SOI up to the first SOS; without `to_scan` (the header
// alone) it stops as soon as the frame header and an Exif orientation have
// both been read.
void parse_headers(Jpeg& j, const uint8_t* buf, size_t n, bool to_scan) {
  if (n == 0) fail("empty file");
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
      case 0xC2:
      case 0xC3:
      case 0xC9:
      case 0xCA:
        parse_sof(j, m, s, len);
        break;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        refuse_frame(m);
      case 0xE0:  // jdmarker.c examine_app0: a JFIF header of at least 14 bytes
        if (len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) j.saw_jfif = true;
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
        parse_sos(j, s, len, j.first);
        j.scan = p;
        return;
      default:
        if (!table_segment(j, m, s, len)) fail("unsupported JPEG marker " + hex2(m));
    }
    if (!to_scan && j.have_frame && saw_exif) return;
  }
}

// jdapimin.c default_decompress_parms (libjpeg-turbo 3): a JFIF APP0 makes
// three components YCbCr; else an Adobe APP14 transform (0: RGB, 1: YCbCr,
// other: YCbCr with a warning); else ids 'R', 'G', 'B' RGB, and any other
// ids YCbCr, or RGB in a lossless frame. Four components are CMYK without
// an Adobe segment or with transform 0, YCCK with any other. In lossless
// mode libjpeg converts no colour with loss and none from gray, so cv2's
// BGR output refuses lossless gray, YCbCr and YCCK frames.
Colour colour_model(const Jpeg& j) {
  Colour c;
  if (j.ncomp == 1) {
    c = Colour::kGray;
  } else if (j.ncomp == 3) {
    if (j.saw_jfif) c = Colour::kYCbCr;
    else if (j.adobe_transform >= 0) c = j.adobe_transform == 0 ? Colour::kRGB : Colour::kYCbCr;
    else if (j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B') c = Colour::kRGB;
    else c = j.lossless ? Colour::kRGB : Colour::kYCbCr;
  } else {
    c = j.adobe_transform <= 0 ? Colour::kCMYK : Colour::kYCCK;
  }
  if (j.lossless && c != Colour::kRGB && c != Colour::kCMYK)
    fail(std::string("lossless ") +
         (c == Colour::kGray ? "grayscale" : c == Colour::kYCbCr ? "YCbCr" : "YCCK") +
         " JPEG is not supported (libjpeg converts no colour in lossless mode)");
  return c;
}

// ------------------------------------------------------------ decoding

// The table of slot `slot` for a scan: libjpeg-turbo's standard tables
// (jstdhuff.c) stand in for an empty slot 0 or 1. A DC table's values are
// categories up to 15, or 16 in a lossless scan (jdhuff.c
// jpeg_make_d_derived_tbl).
const Huffman& huffman_table(Jpeg& j, bool ac, int slot) {
  const std::string kind = ac ? "AC" : "DC";
  if (slot > 3) fail(kind + " Huffman table " + std::to_string(slot) + " not defined");
  Huffman& t = ac ? j.ac[slot] : j.dc[slot];
  if (!t.defined) {
    if (slot > 1) fail(kind + " Huffman table " + std::to_string(slot) + " not defined");
    if (ac) set_std(t, slot ? kAcChromBits : kAcLumBits, slot ? kAcChromVals : kAcLumVals);
    else set_std(t, slot ? kDcChromBits : kDcLumBits, kDcVals);
  }
  if (!ac) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += t.bits[l];
    for (int i = 0; i < count; ++i)
      if (t.vals[i] > (j.lossless ? 16 : 15))
        fail(std::string("bad Huffman table: DC category above ") + (j.lossless ? "16" : "15"));
  }
  return t;
}

// A scan's decoding mode
enum Mode { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

Mode scan_mode(const Jpeg& j, const Scan& sc) {
  return !j.progressive ? kSequential
         : sc.ss == 0   ? (sc.ah == 0 ? kDcFirst : kDcRefine)
                        : (sc.ah == 0 ? kAcFirst : kAcRefine);
}

// One Huffman-coded scan block by block: jdhuff.c decode_mcu for a
// sequential scan, jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first /
// _AC_refine for a progressive one. process_restart resets the DC
// predictors and the EOB run.
struct HuffmanScan {
  BitReader br;
  Mode mode;
  const Huffman* dct[4] = {nullptr, nullptr, nullptr, nullptr};
  const Huffman* act[4] = {nullptr, nullptr, nullptr, nullptr};
  int ss, se, al, p1, m1;  // p1, m1: +1 and -1 in the bit coded
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;

  HuffmanScan(Jpeg& j, const Scan& sc, const uint8_t* p)
      : br(p, j.end), mode(scan_mode(j, sc)), ss(sc.ss), se(sc.se), al(sc.al),
        p1(1 << sc.al), m1((int)(~0u << sc.al)) {
    for (int i = 0; i < sc.ns; ++i) {
      if (mode == kSequential || mode == kDcFirst) dct[i] = &huffman_table(j, false, sc.td[i]);
      if (mode == kSequential || mode >= kAcFirst) act[i] = &huffman_table(j, true, sc.ta[i]);
    }
  }

  void restart(int n) {
    br.restart(n);
    pred[0] = pred[1] = pred[2] = pred[3] = 0;
    eobrun = 0;
  }

  const uint8_t* position() const { return br.p; }

  // a sequential block into the zeroed `coef`, for the one-pass path; true
  // if it holds an AC coefficient
  bool sequential_block(int i, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    int s = br.decode(*dct[i]);
    if (s) pred[i] += extend(br.bits(s), s);
    coef[0] = (int16_t)pred[i];
    bool any_ac = false;
    for (int z = 1; z < 64; ++z) {
      int rs = br.decode(*act[i]);
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
    return any_ac;
  }

  // a block of the whole-image buffer, in the scan's mode
  void block(int i, int16_t* b) {
    switch (mode) {
      case kSequential: {
        int s = br.decode(*dct[i]);
        if (s) pred[i] += extend(br.bits(s), s);
        b[0] = (int16_t)pred[i];
        for (int k = 1; k < 64; ++k) {
          const int rs = br.decode(*act[i]), r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            b[kNatural[k]] = (int16_t)extend(br.bits(s), s);
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        break;
      }
      case kDcFirst: {
        const int s = br.decode(*dct[i]);
        if (s) pred[i] += extend(br.bits(s), s);
        b[0] = (int16_t)((uint32_t)pred[i] << al);
        break;
      }
      case kDcRefine:
        if (br.bits(1)) b[0] = (int16_t)(b[0] | p1);
        break;
      case kAcFirst:
        if (eobrun > 0) {
          --eobrun;
          break;
        }
        for (int k = ss; k <= se; ++k) {
          const int rs = br.decode(*act[i]), r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            b[kNatural[k]] = (int16_t)((uint32_t)extend(br.bits(s), s) << al);
          } else if (r == 15) {
            k += 15;
          } else {  // EOBr: this block and 2^r - 1 + (r bits) more
            eobrun = 1u << r;
            if (r) eobrun += (unsigned)br.bits(r);
            --eobrun;
            break;
          }
        }
        break;
      case kAcRefine: {
        // a correction bit for each coefficient with history that the
        // run passes; a run counts only coefficients still zero
        auto correct = [&](int16_t& t) {
          if (br.bits(1) && (t & p1) == 0) t = (int16_t)(t >= 0 ? t + p1 : t + m1);
        };
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; ++k) {
            const int rs = br.decode(*act[i]);
            int r = rs >> 4, s = rs & 15;
            if (s) {  // a size other than 1 is a warning; libjpeg reads it as 1
              s = br.bits(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1u << r;
              if (r) eobrun += (unsigned)br.bits(r);
              break;
            }
            do {
              int16_t& t = b[kNatural[k]];
              if (t != 0) correct(t);
              else if (--r < 0) break;
              ++k;
            } while (k <= se);
            if (s) b[kNatural[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; ++k) {
            int16_t& t = b[kNatural[k]];
            if (t != 0) correct(t);
          }
          --eobrun;
        }
        break;
      }
    }
  }
};

// jaricom.c jpeg_aritab: ITU-T T.81 Table D.2 packed as
// Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state
// 113 is the fixed probability 0.5
#define QM(qe, nl, nm, sw) ((int32_t(qe) << 16) | ((nm) << 8) | ((sw) << 7) | (nl))
const int32_t kAritab[114] = {
    QM(0x5a1d, 1, 1, 1),     QM(0x2586, 14, 2, 0),    QM(0x1114, 16, 3, 0),
    QM(0x080b, 18, 4, 0),    QM(0x03d8, 20, 5, 0),    QM(0x01da, 23, 6, 0),
    QM(0x00e5, 25, 7, 0),    QM(0x006f, 28, 8, 0),    QM(0x0036, 30, 9, 0),
    QM(0x001a, 33, 10, 0),   QM(0x000d, 35, 11, 0),   QM(0x0006, 9, 12, 0),
    QM(0x0003, 10, 13, 0),   QM(0x0001, 12, 13, 0),   QM(0x5a7f, 15, 15, 1),
    QM(0x3f25, 36, 16, 0),   QM(0x2cf2, 38, 17, 0),   QM(0x207c, 39, 18, 0),
    QM(0x17b9, 40, 19, 0),   QM(0x1182, 42, 20, 0),   QM(0x0cef, 43, 21, 0),
    QM(0x09a1, 45, 22, 0),   QM(0x072f, 46, 23, 0),   QM(0x055c, 48, 24, 0),
    QM(0x0406, 49, 25, 0),   QM(0x0303, 51, 26, 0),   QM(0x0240, 52, 27, 0),
    QM(0x01b1, 54, 28, 0),   QM(0x0144, 56, 29, 0),   QM(0x00f5, 57, 30, 0),
    QM(0x00b7, 59, 31, 0),   QM(0x008a, 60, 32, 0),   QM(0x0068, 62, 33, 0),
    QM(0x004e, 63, 34, 0),   QM(0x003b, 32, 35, 0),   QM(0x002c, 33, 9, 0),
    QM(0x5ae1, 37, 37, 1),   QM(0x484c, 64, 38, 0),   QM(0x3a0d, 65, 39, 0),
    QM(0x2ef1, 67, 40, 0),   QM(0x261f, 68, 41, 0),   QM(0x1f33, 69, 42, 0),
    QM(0x19a8, 70, 43, 0),   QM(0x1518, 72, 44, 0),   QM(0x1177, 73, 45, 0),
    QM(0x0e74, 74, 46, 0),   QM(0x0bfb, 75, 47, 0),   QM(0x09f8, 77, 48, 0),
    QM(0x0861, 78, 49, 0),   QM(0x0706, 79, 50, 0),   QM(0x05cd, 48, 51, 0),
    QM(0x04de, 50, 52, 0),   QM(0x040f, 50, 53, 0),   QM(0x0363, 51, 54, 0),
    QM(0x02d4, 52, 55, 0),   QM(0x025c, 53, 56, 0),   QM(0x01f8, 54, 57, 0),
    QM(0x01a4, 55, 58, 0),   QM(0x0160, 56, 59, 0),   QM(0x0125, 57, 60, 0),
    QM(0x00f6, 58, 61, 0),   QM(0x00cb, 59, 62, 0),   QM(0x00ab, 61, 63, 0),
    QM(0x008f, 61, 32, 0),   QM(0x5b12, 65, 65, 1),   QM(0x4d04, 80, 66, 0),
    QM(0x412c, 81, 67, 0),   QM(0x37d8, 82, 68, 0),   QM(0x2fe8, 83, 69, 0),
    QM(0x293c, 84, 70, 0),   QM(0x2379, 86, 71, 0),   QM(0x1edf, 87, 72, 0),
    QM(0x1aa9, 87, 73, 0),   QM(0x174e, 72, 74, 0),   QM(0x1424, 72, 75, 0),
    QM(0x119c, 74, 76, 0),   QM(0x0f6b, 74, 77, 0),   QM(0x0d51, 75, 78, 0),
    QM(0x0bb6, 77, 79, 0),   QM(0x0a40, 77, 48, 0),   QM(0x5832, 80, 81, 1),
    QM(0x4d1c, 88, 82, 0),   QM(0x438e, 89, 83, 0),   QM(0x3bdd, 90, 84, 0),
    QM(0x34ee, 91, 85, 0),   QM(0x2eae, 92, 86, 0),   QM(0x299a, 93, 87, 0),
    QM(0x2516, 86, 71, 0),   QM(0x5570, 88, 89, 1),   QM(0x4ca9, 95, 90, 0),
    QM(0x44d9, 96, 91, 0),   QM(0x3e22, 97, 92, 0),   QM(0x3824, 99, 93, 0),
    QM(0x32b4, 99, 94, 0),   QM(0x2e17, 93, 86, 0),   QM(0x56a8, 95, 96, 1),
    QM(0x4f46, 101, 97, 0),  QM(0x47e5, 102, 98, 0),  QM(0x41cf, 103, 99, 0),
    QM(0x3c3d, 104, 100, 0), QM(0x375e, 99, 93, 0),   QM(0x5231, 105, 102, 0),
    QM(0x4c0f, 106, 103, 0), QM(0x4639, 107, 104, 0), QM(0x415e, 103, 99, 0),
    QM(0x5627, 105, 106, 1), QM(0x50e7, 108, 107, 0), QM(0x4b85, 109, 103, 0),
    QM(0x5597, 110, 109, 0), QM(0x504f, 111, 107, 0), QM(0x5a10, 110, 111, 1),
    QM(0x5522, 112, 109, 0), QM(0x59eb, 112, 111, 1), QM(0x5a1d, 113, 113, 0)};
#undef QM

// jdarith.c's QM decoder (T.81 D.2) over entropy-coded bytes with FF 00
// unstuffed. At a marker it reads zeros, as libjpeg does (legal in
// arithmetic coding); past the end of the data cv2's reader suspends and
// returns no image, so that raises.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;  // C and A registers
  int ct = -16;          // bits left in C's byte buffer; -16: two bytes to read first
  bool at_marker = false;

  ArithReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  int byte() {
    if (at_marker) return 0;
    if (p >= end) fail("corrupt JPEG data: premature end of data segment");
    int d = *p++;
    if (d != 0xFF) return d;
    while (p < end && *p == 0xFF) ++p;  // fill bytes
    if (p >= end) fail("corrupt JPEG data: premature end of data segment");
    if (*p == 0) {
      ++p;
      return 0xFF;
    }
    --p;  // the FF of the marker
    at_marker = true;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: the LPS
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // jdmarker.c read_restart_marker: bytes up to the next marker skipped
  // (a warning in libjpeg), which must be RSTn; the registers start anew
  void restart(int expected) {
    if (!at_marker) {
      for (;;) {
        while (p < end && *p != 0xFF) ++p;
        while (p + 1 < end && p[1] == 0xFF) ++p;
        if (p + 1 >= end || p[1] != 0x00) break;
        p += 2;
      }
    }
    if (p + 1 >= end || p[1] != 0xD0 + expected)
      fail("corrupt JPEG data: restart marker RST" + std::to_string(expected) + " not found");
    p += 2;
    at_marker = false;
    c = a = 0;
    ct = -16;
  }
};

// One arithmetic-coded scan block by block: jdarith.c decode_mcu for a
// sequential scan, decode_mcu_DC_first / _DC_refine / _AC_first /
// _AC_refine for a progressive one, with the DC and AC statistics bins of
// each table slot (Tables F.4, F.5), the DC conditioning L, U and the AC
// Kx of the DAC segment. Where libjpeg meets a bad code (a magnitude or
// run past its limit) it warns and stops decoding the scan; this raises.
struct ArithScan {
  ArithReader r;
  const Jpeg& j;
  Mode mode;
  int ns, ss, se, al;
  int dct[4] = {0, 0, 0, 0}, act[4] = {0, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;  // the bin of fixed probability 0.5

  ArithScan(const Jpeg& j_, const Scan& sc, const uint8_t* p)
      : r(p, j_.end), j(j_), mode(scan_mode(j_, sc)), ns(sc.ns), ss(sc.ss), se(sc.se), al(sc.al) {
    for (int i = 0; i < ns; ++i) {
      dct[i] = sc.td[i];
      act[i] = sc.ta[i];
    }
    reset();
  }

  // jdarith.c start_pass / process_restart: the bins of the scan's tables
  // zeroed, the DC predictions and contexts reset
  void reset() {
    const bool dc = mode == kSequential || mode == kDcFirst;
    const bool ac = mode == kSequential || mode >= kAcFirst;
    for (int i = 0; i < ns; ++i) {
      if (dc) {
        std::memset(dc_stats[dct[i]], 0, 64);
        last_dc[i] = context[i] = 0;
      }
      if (ac) std::memset(ac_stats[act[i]], 0, 256);
    }
  }

  void restart(int n) {
    r.restart(n);
    reset();
  }

  const uint8_t* position() const { return r.p; }

  [[noreturn]] static void bad_code() { fail("corrupt JPEG data: bad arithmetic code"); }

  // Figures F.19 - F.24: the difference of a DC value, and the context it
  // sets for the next one (zero, small or large, by sign)
  int dc_difference(int i) {
    const int t = dct[i];
    uint8_t* stats = dc_stats[t];
    uint8_t* st = stats + context[i];
    if (!r.decode(st)) {
      context[i] = 0;
      return 0;
    }
    const int sign = r.decode(st + 1);
    st += 2 + sign;
    int m = r.decode(st);
    if (m) {
      st = stats + 20;  // X1
      while (r.decode(st)) {
        if ((m <<= 1) == 0x8000) bad_code();
        ++st;
      }
    }
    if (m < (1 << j.dc_l[t]) >> 1) context[i] = 0;
    else if (m > (1 << j.dc_u[t]) >> 1) context[i] = 12 + sign * 4;
    else context[i] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (r.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // Figure F.20: the band's coefficients up to its EOB, shifted up by Al
  void ac_band(int i, int16_t* b, int start, int end, int shift) {
    const int t = act[i];
    uint8_t* stats = ac_stats[t];
    for (int k = start; k <= end; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (r.decode(st)) break;  // EOB
      while (!r.decode(st + 1)) {
        st += 3;
        if (++k > end) bad_code();
      }
      const int sign = r.decode(&fixed);
      st += 2;
      int m = r.decode(st);
      if (m && r.decode(st)) {
        m <<= 1;
        st = stats + (k <= j.ac_k[t] ? 189 : 217);  // X2
        while (r.decode(st)) {
          if ((m <<= 1) == 0x8000) bad_code();
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (r.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      b[kNatural[k]] = (int16_t)((uint32_t)v << shift);
    }
  }

  bool sequential_block(int i, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    block(i, coef);
    return true;
  }

  void block(int i, int16_t* b) {
    switch (mode) {
      case kSequential:
        last_dc[i] = (last_dc[i] + dc_difference(i)) & 0xFFFF;
        b[0] = (int16_t)last_dc[i];
        ac_band(i, b, 1, 63, 0);
        break;
      case kDcFirst:
        last_dc[i] += dc_difference(i);
        b[0] = (int16_t)((uint32_t)last_dc[i] << al);
        break;
      case kDcRefine:
        if (r.decode(&fixed)) b[0] = (int16_t)(b[0] | (1 << al));
        break;
      case kAcFirst:
        ac_band(i, b, ss, se, al);
        break;
      case kAcRefine: {
        const int p1 = 1 << al, m1 = (int)(~0u << al);
        uint8_t* stats = ac_stats[act[i]];
        int kex = se;  // the band's end of block so far
        while (kex > 0 && !b[kNatural[kex]]) --kex;
        for (int k = ss; k <= se; ++k) {
          uint8_t* st = stats + 3 * (k - 1);
          if (k > kex && r.decode(st)) break;  // EOB
          for (;;) {
            int16_t& t = b[kNatural[k]];
            if (t) {  // a correction bit
              if (r.decode(st + 2)) t = (int16_t)(t + (t < 0 ? m1 : p1));
              break;
            }
            if (r.decode(st + 1)) {  // newly nonzero
              t = (int16_t)(r.decode(&fixed) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) bad_code();
          }
        }
        break;
      }
    }
  }
};

// The single-scan file: its scan decoded and inverse transformed block by
// block into the planes.
template <class Entropy>
void decode_scan(Jpeg& j, Entropy& e) {
  const Tables& tab = tables();
  const uint8_t* limit = tab.idct_limit;
  // Ss, Se, Ah and Al other than 0, 63, 0, 0 are only a warning in
  // jdhuff.c and jdarith.c (JWRN_NOT_SEQUENTIAL): the scan is read as a
  // sequential one
  const Scan& sc = j.first;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (sc.comp[c] != c) fail("scan components do not match the frame header");
    if (!j.have_quant[k.tq]) fail("quantization table " + std::to_string(k.tq) + " not defined");
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
    int blocks = 0;
    for (int c = 0; c < j.ncomp; ++c) blocks += j.comp[c].h * j.comp[c].v;
    if (blocks > 10) fail("bad MCU size: " + std::to_string(blocks) + " blocks (at most 10)");
  }
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.stride = mcux * k.h * 8;
    k.rows = mcuy * k.v * 8;
    k.plane.assign((size_t)k.stride * k.rows, 0);
  }
  int16_t coef[64];
  int64_t total = (int64_t)mcux * mcuy, todo = j.restart;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart) {
      if (todo == 0) {
        e.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        todo = j.restart;
      }
      --todo;
    }
    int mx = (int)(m % mcux), my = (int)(m / mcux);
    for (int c = 0; c < j.ncomp; ++c) {
      Component& k = j.comp[c];
      const int16_t* q = j.quant[k.tq];
      for (int by = 0; by < k.v; ++by) {
        for (int bx = 0; bx < k.h; ++bx) {
          const bool any_ac = e.sequential_block(c, coef);
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
  // skips them). libjpeg has decided at the first SOS that the file has one
  // scan and has output the image before it meets a second SOS, so cv2
  // returns that image. Without an EOI cv2 returns no image (its reader
  // suspends at the end of the data).
  const uint8_t* p = e.position();
  const uint8_t* end = j.end;
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("corrupt JPEG data: premature end of file (no EOI marker)");
    int m = *p++;
    if (m == 0xD9 || m == 0xDA) return;
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) continue;
    if (end - p < 2) fail("corrupt JPEG data: premature end of file (no EOI marker)");
    p += u16be(p);
  }
}

// ------------------------------------------------------------ multi-scan

// jdcoefct.c's whole-image coefficient buffer (zeroed, padded to whole
// MCUs), the quantization table each component latched at its first scan
// (jdinput.c latch_quant_tables; zeros for a component no scan held, as
// jddctmgr.c leaves it) and, for a progressive file, jdphuff.c's
// coef_bits: the successive-approximation bit to which each coefficient
// is known, -1 before its first scan.
struct Coefficients {
  int wib[4] = {0, 0, 0, 0}, hib[4] = {0, 0, 0, 0};  // width_in_blocks, height_in_blocks
  int bw[4] = {0, 0, 0, 0}, bh[4] = {0, 0, 0, 0};    // the same, padded to whole MCUs
  std::vector<int16_t> blocks[4];                    // 64 natural-order coefficients a block
  int16_t quant[4][64];
  bool latched[4] = {false, false, false, false};
  int bits[4][64];

  explicit Coefficients(const Jpeg& j) {
    std::memset(quant, 0, sizeof quant);
    for (int c = 0; c < j.ncomp; ++c) {
      const Component& k = j.comp[c];
      wib[c] = (int)(((int64_t)j.width * k.h + 8 * j.hmax - 1) / (8 * j.hmax));
      hib[c] = (int)(((int64_t)j.height * k.v + 8 * j.vmax - 1) / (8 * j.vmax));
      bw[c] = (wib[c] + k.h - 1) / k.h * k.h;
      bh[c] = (hib[c] + k.v - 1) / k.v * k.v;
      blocks[c].assign((size_t)bw[c] * bh[c] * 64, 0);
      std::fill(bits[c], bits[c] + 64, -1);
    }
  }
  int16_t* block(int c, int bx, int by) {
    return blocks[c].data() + ((size_t)by * bw[c] + bx) * 64;
  }
};

// jdphuff.c / jdarith.c start_pass: the scan's parameters checked
// (JERR_BAD_PROGRESSION), then coef_bits advanced to Al over the band. A
// band whose Ah is not the bit it is known to is only a warning there
// (JWRN_BOGUS_PROGRESSION), and is decoded all the same.
void start_progressive_scan(const Scan& sc, Coefficients& cf) {
  bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.ns != 1);
  if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
  if (sc.al > 13) bad = true;
  if (bad)
    fail("bad progression parameters Ss=" + std::to_string(sc.ss) + " Se=" +
         std::to_string(sc.se) + " Ah=" + std::to_string(sc.ah) + " Al=" + std::to_string(sc.al));
  for (int i = 0; i < sc.ns; ++i) {
    int* bits = cf.bits[sc.comp[i]];
    std::fill(bits + sc.ss, bits + sc.se + 1, sc.al);
  }
}

// One scan's entropy-coded data into the buffer, MCU by MCU as
// jdcoefct.c consume_data walks them (jdinput.c per_scan_setup: a scan of
// one component covers its own blocks, one an MCU and no dummy blocks; an
// interleaved scan covers whole MCUs of the frame's grid, dummy blocks
// included), restarts between them.
template <class Entropy>
void decode_scan_into(Jpeg& j, const Scan& sc, Coefficients& cf, Entropy& e) {
  int mcux, mcuy;
  if (sc.ns == 1) {
    mcux = cf.wib[sc.comp[0]];
    mcuy = cf.hib[sc.comp[0]];
  } else {
    mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
    int blocks = 0;
    for (int i = 0; i < sc.ns; ++i) blocks += j.comp[sc.comp[i]].h * j.comp[sc.comp[i]].v;
    if (blocks > 10) fail("bad MCU size: " + std::to_string(blocks) + " blocks (at most 10)");
  }
  const int64_t total = (int64_t)mcux * mcuy;
  int64_t todo = j.restart;
  int next_rst = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart) {
      if (todo == 0) {
        e.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        todo = j.restart;
      }
      --todo;
    }
    const int mx = (int)(m % mcux), my = (int)(m / mcux);
    for (int i = 0; i < sc.ns; ++i) {
      const int c = sc.comp[i];
      const int h = sc.ns == 1 ? 1 : j.comp[c].h, v = sc.ns == 1 ? 1 : j.comp[c].v;
      for (int by = 0; by < v; ++by)
        for (int bx = 0; bx < h; ++bx) e.block(i, cf.block(c, mx * h + bx, my * v + by));
    }
  }
}

// jdmarker.c read_markers between scans: bytes up to a marker skipped (a
// warning there), table segments read; false at EOI, true at the next SOS
// with `sc` filled in. Without an EOI libjpeg suspends and cv2 returns no
// image.
bool next_scan(Jpeg& j, const uint8_t*& p, Scan& sc) {
  const uint8_t* end = j.end;
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("corrupt JPEG data: premature end of file (no EOI marker)");
    const int m = *p++;
    if (m == 0xD9) return false;
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xD8) fail("corrupt JPEG data: a second SOI marker");
    if (end - p < 2) fail("corrupt JPEG data: premature end of file in a marker");
    const int len = u16be(p) - 2;
    if (len < 0 || end - p - 2 < len) fail("corrupt JPEG data: premature end of file in a marker");
    const uint8_t* s = p + 2;
    p = s + len;
    if (m == 0xDA) {
      parse_sos(j, s, len, sc);
      return true;
    }
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
      fail("more than one frame header (SOF)");
    if (!table_segment(j, m, s, len)) fail("unsupported JPEG marker " + hex2(m));
  }
}
// jdcoefct.c smoothing_ok: block smoothing (on by default in libjpeg) runs
// on a progressive file when every component has latched a table without
// a zero among its first ten quantizers and has had a DC scan, and some
// component's AC coefficients 1-9 (zigzag) are not known to their last
// bit: the file's last refinement scans are missing. A complete file has
// every coef_bits entry at 0, so it never smooths.
bool smoothing_ok(const Jpeg& j, const Coefficients& cf) {
  bool useful = false;
  for (int c = 0; c < j.ncomp; ++c) {
    if (!cf.latched[c]) return false;
    for (int i = 0; i < 10; ++i)
      if (cf.quant[c][kNatural[i]] == 0) return false;
    if (cf.bits[c][0] < 0) return false;
    for (int i = 1; i < 10; ++i)
      if (cf.bits[c][i] != 0) useful = true;
  }
  return useful;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
// block's coefficients 1-9 (zigzag) that are still zero and not known to
// their last bit are estimated from the DC values of the 5x5 blocks around
// it (the DC too, by a Gaussian-like kernel, while the component has had
// no AC scan), then the block goes through the IDCT. Past the left and
// right edges the neighbours repeat the edge column; the rows follow
// libjpeg's iMCU-row bookkeeping, whose last iMCU row (when it holds fewer
// block rows than the sampling factor) counts its rows as if every iMCU
// row held that many, and whose dummy rows below the image may be read.
void smooth_component(Jpeg& j, Coefficients& cf, int c, const uint8_t* limit) {
  Component& k = j.comp[c];
  const int* bits = cf.bits[c];
  const int16_t* q = cf.quant[c];
  const int v = k.v, wib = cf.wib[c], hib = cf.hib[c];
  const int total = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  bool change_dc = true;
  for (int i = 1; i < 10; ++i) change_dc = change_dc && bits[i] == -1;
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2],
                Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  int16_t ws[64];
  // round(num / (256 Q)) with its magnitude capped below bit Al when Al > 0
  auto estimate = [&](int pos, int al, int64_t qv, int64_t num) {
    if (al == 0 || ws[pos] != 0) return;
    int pred = (int)(((qv << 7) + (num >= 0 ? num : -num)) / (qv << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    ws[pos] = (int16_t)(num >= 0 ? pred : -pred);
  };
  for (int r = 0; r < total; ++r) {
    int block_rows = v;
    if (r == total - 1) {
      block_rows = hib % v;
      if (block_rows == 0) block_rows = v;
    }
    const int image_block_rows = block_rows * total;
    for (int br = 0; br < block_rows; ++br) {
      const int row = r * v + br, ibr = r * block_rows + br;
      const int prev = ibr > 0 ? row - 1 : row;
      const int pprev = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
      const int rows5[5] = {pprev, prev, row, next, nnext};
      uint8_t* out = k.plane.data() + (size_t)row * 8 * k.stride;
      for (int bn = 0; bn < wib; ++bn) {
        std::memcpy(ws, cf.block(c, bn, row), sizeof ws);
        int d[26];  // d[1..25]: the 5x5 DC values, row by row
        for (int y = 0; y < 5; ++y)
          for (int x = 0; x < 5; ++x)
            d[5 * y + x + 1] = cf.block(c, std::min(std::max(bn + x - 2, 0), wib - 1), rows5[y])[0];
        const int64_t DC01 = d[1], DC02 = d[2], DC03 = d[3], DC04 = d[4], DC05 = d[5],
                      DC06 = d[6], DC07 = d[7], DC08 = d[8], DC09 = d[9], DC10 = d[10],
                      DC11 = d[11], DC12 = d[12], DC13 = d[13], DC14 = d[14], DC15 = d[15],
                      DC16 = d[16], DC17 = d[17], DC18 = d[18], DC19 = d[19], DC20 = d[20],
                      DC21 = d[21], DC22 = d[22], DC23 = d[23], DC24 = d[24], DC25 = d[25];
        estimate(1, bits[1], Q01,
                 Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                     13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                                     3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                     DC21 - DC22 + DC24 + DC25)
                                  : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)));
        estimate(8, bits[2], Q10,
                 Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                     13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                     13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                     3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                  : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)));
        estimate(16, bits[3], Q20,
                 Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                     14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 +
                                     DC23)
                                  : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)));
        estimate(9, bits[4], Q11,
                 Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                     9 * DC19 + DC21 - DC25)
                                  : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                     DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)));
        estimate(2, bits[5], Q02,
                 Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                     14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                     2 * DC19)
                                  : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)));
        if (change_dc) {
          estimate(3, bits[6], Q03, Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19));
          estimate(10, bits[7], Q12, Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19));
          estimate(17, bits[8], Q21, Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19));
          estimate(24, bits[9], Q30, Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19));
          const int64_t num =
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                     6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                     152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                     6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25);
          const int pred = (int)(((Q00 << 7) + (num >= 0 ? num : -num)) / (Q00 << 8));
          ws[0] = (int16_t)(num >= 0 ? pred : -pred);
        }
        idct_islow(ws, q, out + (size_t)bn * 8, k.stride, limit);
      }
    }
  }
}

// A multi-scan file (progressive, or sequential with scans of fewer
// components than the frame): every scan up to EOI read into the
// coefficient buffer, then each block inverse transformed into the planes
// (jdcoefct.c decompress_data, or decompress_smooth_data when
// smoothing_ok).
void decode_multi_scan(Jpeg& j) {
  Coefficients cf(j);
  Scan sc = j.first;
  const uint8_t* p = j.scan;
  do {
    for (int i = 0; i < sc.ns; ++i) {
      const int c = sc.comp[i];
      if (cf.latched[c]) continue;
      const int tq = j.comp[c].tq;
      if (!j.have_quant[tq]) fail("quantization table " + std::to_string(tq) + " not defined");
      std::memcpy(cf.quant[c], j.quant[tq], sizeof cf.quant[c]);
      cf.latched[c] = true;
    }
    if (j.progressive) start_progressive_scan(sc, cf);
    if (j.arithmetic) {
      ArithScan e(j, sc, p);
      decode_scan_into(j, sc, cf, e);
      p = e.position();
    } else {
      HuffmanScan e(j, sc, p);
      decode_scan_into(j, sc, cf, e);
      p = e.position();
    }
  } while (next_scan(j, p, sc));
  const uint8_t* limit = tables().idct_limit;
  const bool smooth = j.progressive && smoothing_ok(j, cf);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.stride = cf.bw[c] * 8;
    k.rows = cf.bh[c] * 8;
    k.plane.assign((size_t)k.stride * k.rows, 0);
    if (smooth) {
      smooth_component(j, cf, c, limit);
      continue;
    }
    for (int by = 0; by < cf.hib[c]; ++by)
      for (int bx = 0; bx < cf.wib[c]; ++bx)
        idct_islow(cf.block(c, bx, by), cf.quant[c],
                   k.plane.data() + (size_t)by * 8 * k.stride + (size_t)bx * 8, k.stride, limit);
  }
}

// ------------------------------------------------------------ lossless

// A lossless file (SOF3), scan by scan (each of one component or several,
// interleaved): jdlhuff.c's Huffman-coded differences (category 16 is
// 32768 with no extra bits) over whole MCUs of one sample a block, then
// jdlossls.c's undifferencing of each component row by the scan's
// predictor Ss (T.81 Table H.1, modulo 2^16): the scan's first row, and
// the first row of each restart interval, from the left and its first
// sample from 2^(P - Pt - 1); every other row's first sample from above.
// The point transform Al shifts each sample back up, and the sample keeps
// its low 8 bits (jddiffct.c / jdlossls.c's scaler). libjpeg counts a
// restart interval in whole MCU rows, and resets the prediction at the
// first row of the iMCU row in which a restart falls.
void decode_lossless(Jpeg& j) {
  const int mcux = (j.width + j.hmax - 1) / j.hmax, mcuy = (j.height + j.vmax - 1) / j.vmax;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.stride = mcux * k.h;
    k.rows = mcuy * k.v;
    k.plane.assign((size_t)k.stride * k.rows, 0);
  }
  Scan sc = j.first;
  const uint8_t* p = j.scan;
  std::vector<int32_t> diff[4];
  std::vector<int32_t> rows[2];
  do {
    if (sc.ss < 1 || sc.ss > 7 || sc.se != 0 || sc.ah != 0 || sc.al >= j.precision)
      fail("bad lossless parameters Ss=" + std::to_string(sc.ss) + " Se=" + std::to_string(sc.se) +
           " Ah=" + std::to_string(sc.ah) + " Al=" + std::to_string(sc.al));
    const Huffman* t[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < sc.ns; ++i) t[i] = &huffman_table(j, false, sc.td[i]);
    // the scan's MCU grid: one sample of a lone component, or each
    // component's h x v samples of the frame's grid
    int sx = mcux, sy = mcuy, hs[4], vs[4];
    for (int i = 0; i < sc.ns; ++i) {
      const Component& k = j.comp[sc.comp[i]];
      hs[i] = sc.ns == 1 ? 1 : k.h;
      vs[i] = sc.ns == 1 ? 1 : k.v;
    }
    if (sc.ns == 1) {
      sx = j.comp[sc.comp[0]].dw;
      sy = j.comp[sc.comp[0]].dh;
    } else {
      int blocks = 0;
      for (int i = 0; i < sc.ns; ++i) blocks += hs[i] * vs[i];
      if (blocks > 10) fail("bad MCU size: " + std::to_string(blocks) + " blocks (at most 10)");
    }
    if (j.restart % sx)
      fail("lossless JPEG with a restart interval of " + std::to_string(j.restart) +
           " MCUs, not a whole number of MCU rows of " + std::to_string(sx) +
           ", is not supported");
    const int restart_rows = j.restart / sx;
    for (int i = 0; i < sc.ns; ++i) diff[i].assign((size_t)sx * hs[i] * sy * vs[i], 0);
    BitReader br(p, j.end);
    int next_rst = 0;
    for (int my = 0; my < sy; ++my) {
      if (restart_rows && my && my % restart_rows == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
      }
      for (int mx = 0; mx < sx; ++mx) {
        for (int i = 0; i < sc.ns; ++i) {
          const int w = sx * hs[i];
          for (int y = 0; y < vs[i]; ++y) {
            int32_t* d = diff[i].data() + (size_t)(my * vs[i] + y) * w + (size_t)mx * hs[i];
            for (int x = 0; x < hs[i]; ++x) {
              const int s = br.decode(*t[i]);
              d[x] = s == 16 ? 32768 : s ? extend(br.bits(s), s) : 0;
            }
          }
        }
      }
    }
    const int psv = sc.ss, pt = sc.al;
    for (int i = 0; i < sc.ns; ++i) {
      Component& k = j.comp[sc.comp[i]];
      const int w = sx * hs[i], n = k.dw;
      // jddiffct.c undifferences an iMCU row (v rows of the component; one
      // MCU row of an interleaved scan, v of a lone component's) after
      // decoding it, and a restart within it resets its first row
      const int per_imcu = sc.ns == 1 ? k.v : 1;
      auto first_row = [&](int r) {
        if (r % k.v) return false;
        const int imcu = r / k.v;
        if (imcu == 0) return true;
        for (int my = imcu * per_imcu; restart_rows && my < (imcu + 1) * per_imcu; ++my)
          if (my % restart_rows == 0) return true;
        return false;
      };
      rows[0].assign(n, 0);
      rows[1].assign(n, 0);
      for (int r = 0; r < k.dh; ++r) {
        const int32_t* d = diff[i].data() + (size_t)r * w;
        int32_t* cur = rows[r & 1].data();
        const int32_t* up = rows[(r + 1) & 1].data();
        if (first_row(r)) {
          cur[0] = (d[0] + (1 << (j.precision - pt - 1))) & 0xFFFF;
          for (int x = 1; x < n; ++x) cur[x] = (d[x] + cur[x - 1]) & 0xFFFF;
        } else {
          cur[0] = (d[0] + up[0]) & 0xFFFF;
          for (int x = 1; x < n; ++x) {
            const int32_t ra = cur[x - 1], rb = up[x], rc = up[x - 1];
            int32_t pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
            cur[x] = (d[x] + pred) & 0xFFFF;
          }
        }
        uint8_t* o = k.plane.data() + (size_t)r * k.stride;
        for (int x = 0; x < n; ++x) o[x] = (uint8_t)(cur[x] << pt);
      }
    }
    p = br.p;
  } while (next_scan(j, p, sc));
}

// jdsample.c, one output row of component `k` at image row y, at least
// `width` samples, into `tmp` (or a pointer into the plane when 1:1).
// Without `fancy` (a lossless frame, whose DCT size of 1 turns fancy
// upsampling off) every factor replicates.
const uint8_t* upsample_row(const Component& k, int hr, int vr, int y, bool fancy, uint8_t* tmp) {
  const uint8_t* plane = k.plane.data();
  const int dw = k.dw;
  if (hr == 1 && vr == 1) return plane + (size_t)y * k.stride;
  if (fancy && hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
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
  if (fancy && hr == 1 && vr == 2) {  // h1v2_fancy_upsample
    int iy = y >> 1;
    bool below = y & 1;
    int far = below ? std::min(iy + 1, k.dh - 1) : std::max(iy - 1, 0);
    const uint8_t* n0 = plane + (size_t)iy * k.stride;
    const uint8_t* n1 = plane + (size_t)far * k.stride;
    int bias = below ? 2 : 1;
    for (int i = 0; i < dw; ++i) tmp[i] = (uint8_t)((n0[i] * 3 + n1[i] + bias) >> 2);
    return tmp;
  }
  if (fancy && hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
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

// OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, on the CMYK that libjpeg outputs
// (Adobe's inverted values as they are stored)
inline uint8_t cmyk_channel(int v, int k) { return (uint8_t)(k - ((255 - v) * k >> 8)); }

void decode_to_bgr(Jpeg& j, uint8_t* out) {
  const Colour colour = colour_model(j);
  // jdinput.c initial_setup's has_multiple_scans: a file whose first scan
  // is progressive or holds fewer components than the frame is read scan
  // by scan into the coefficient buffer; any other in one pass
  if (j.lossless) {
    decode_lossless(j);
  } else if (j.progressive || j.first.ns < j.ncomp) {
    decode_multi_scan(j);
  } else if (j.arithmetic) {
    ArithScan e(j, j.first, j.scan);
    decode_scan(j, e);
  } else {
    HuffmanScan e(j, j.first, j.scan);
    decode_scan(j, e);
  }
  const Tables& tab = tables();
  const int w = j.width;
  const bool fancy = !j.lossless;
  std::vector<uint8_t> tmp[4];
  for (int c = 0; c < j.ncomp; ++c) tmp[c].assign((size_t)j.comp[c].dw * j.hmax + 16, 0);
  for (int y = 0; y < j.height; ++y) {
    uint8_t* o = out + (size_t)y * w * 3;
    if (j.ncomp == 1) {
      const uint8_t* g = j.comp[0].plane.data() + (size_t)y * j.comp[0].stride;
      for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    const uint8_t* row[4];
    for (int c = 0; c < j.ncomp; ++c) {
      const Component& k = j.comp[c];
      row[c] = upsample_row(k, j.hmax / k.h, j.vmax / k.v, y, fancy, tmp[c].data());
    }
    switch (colour) {
      case Colour::kYCbCr:
        for (int x = 0; x < w; ++x) {  // jdcolor.c ycc_rgb_convert
          const int l = row[0][x], b = row[1][x], r = row[2][x];
          o[3 * x] = clamp255(l + tab.cb_b[b]);
          o[3 * x + 1] = clamp255(l + ((tab.cb_g[b] + tab.cr_g[r]) >> 16));
          o[3 * x + 2] = clamp255(l + tab.cr_r[r]);
        }
        break;
      case Colour::kRGB:
        for (int x = 0; x < w; ++x) {
          o[3 * x] = row[2][x];
          o[3 * x + 1] = row[1][x];
          o[3 * x + 2] = row[0][x];
        }
        break;
      case Colour::kCMYK:
        for (int x = 0; x < w; ++x) {
          const int k = row[3][x];
          o[3 * x] = cmyk_channel(row[2][x], k);
          o[3 * x + 1] = cmyk_channel(row[1][x], k);
          o[3 * x + 2] = cmyk_channel(row[0][x], k);
        }
        break;
      case Colour::kYCCK:
        for (int x = 0; x < w; ++x) {  // jdcolor.c ycck_cmyk_convert, then as CMYK
          const int l = row[0][x], b = row[1][x], r = row[2][x], k = row[3][x];
          o[3 * x] = cmyk_channel(clamp255(255 - (l + tab.cb_b[b])), k);
          o[3 * x + 1] = cmyk_channel(clamp255(255 - (l + ((tab.cb_g[b] + tab.cr_g[r]) >> 16))), k);
          o[3 * x + 2] = cmyk_channel(clamp255(255 - (l + tab.cr_r[r])), k);
        }
        break;
      case Colour::kGray:
        break;
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

// ------------------------------------------------------------ JPEG encoder

// jcparam.c: the Annex K tables in natural order
const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jpeg_set_quality(q, force_baseline = TRUE): jpeg_quality_scaling, then
// jpeg_add_quant_table's (t * scale + 50) / 100 clamped to 1..255
void scaled_quant(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int i = 0; i < 64; ++i) {
    int t = (base[i] * scale + 50) / 100;
    out[i] = (uint16_t)std::min(std::max(t, 1), 255);
  }
}

// jchuff.c jpeg_make_c_derived_tbl: code and length by symbol
struct HuffEnc {
  uint16_t code[256] = {0};
  uint8_t size[256] = {0};
  const uint8_t* bits;  // the 16 counts of the DHT segment
  const uint8_t* vals;
  int count = 0;
  HuffEnc(const uint8_t* bits_, const uint8_t* vals_) : bits(bits_), vals(vals_) {
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
    count = p;
  }
};

// Entropy-coded bytes: bits MSB first, FF stuffed with 00, the last byte
// padded with 1-bits (jchuff.c flush_bits)
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((uint32_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    put(0x7F, 7);
    acc = 0;
    nbits = 0;
  }
};

// jfdctint.c jpeg_fdct_islow on samples - 128: rows, then columns; the
// output is scaled up by 8
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * next;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, n);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, n);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, n);
      p[5 * step] = descale(tmp5 + z2 + z4, n);
      p[3 * step] = descale(tmp6 + z2 + z3, n);
      p[step] = descale(tmp7 + z1 + z4, n);
    }
  }
}

// one 8x8 block of a plane -> quantized coefficients (natural order):
// jcdctmgr.c, the divisor 8 * q, rounded half away from zero
void forward_block(const uint8_t* plane, int stride, const uint16_t* quant, int16_t* coef) {
  int32_t ws[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) ws[8 * r + c] = plane[(size_t)r * stride + c] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    const int32_t d = 8 * quant[i];
    int32_t v = ws[i];
    coef[i] = (int16_t)(v < 0 ? -((-v + d / 2) / d) : (v + d / 2) / d);
  }
}

// jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int16_t* coef, int& last_dc, const HuffEnc& dc,
                  const HuffEnc& ac) {
  auto emit_value = [&](const HuffEnc& t, int r, int v) {
    int mag = v < 0 ? -v : v;
    int nbits = 0;
    while (mag >> nbits) ++nbits;
    int sym = (r << 4) | nbits;
    bw.put(t.code[sym], t.size[sym]);
    if (nbits) bw.put((uint32_t)(v < 0 ? v - 1 : v), nbits);
  };
  emit_value(dc, 0, coef[0] - last_dc);
  last_dc = coef[0];
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
    emit_value(ac, run, v);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void marker(std::vector<uint8_t>& o, int m, int len) {
  o.push_back(0xFF);
  o.push_back((uint8_t)m);
  put16(o, len + 2);
}

// jcmarker.c: DQT (8-bit values in zigzag order), DHT
void write_dqt(std::vector<uint8_t>& o, int slot, const uint16_t* q) {
  marker(o, 0xDB, 65);
  o.push_back((uint8_t)slot);
  for (int k = 0; k < 64; ++k) o.push_back((uint8_t)q[kNatural[k]]);
}

void write_dht(std::vector<uint8_t>& o, int index, const HuffEnc& t) {
  marker(o, 0xC4, 17 + t.count);
  o.push_back((uint8_t)index);
  o.insert(o.end(), t.bits, t.bits + 16);
  o.insert(o.end(), t.vals, t.vals + t.count);
}

// libjpeg-turbo's default compression as cv2.imencode('.jpg') runs it:
// [h, w, 3] BGR (YCbCr 4:2:0) or [h, w] gray, baseline, standard Huffman
// tables, no restart interval
void encode_jpeg(const uint8_t* img, int h, int w, int channels, int quality,
                 std::vector<uint8_t>& o) {
  const bool color = channels == 3;
  const int ncomp = color ? 3 : 1;
  const int ms = color ? 16 : 8;  // MCU size in image pixels
  const int mcux = (w + ms - 1) / ms, mcuy = (h + ms - 1) / ms;
  const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y blocks holding image data

  // planes at the MCU grid: Y edge-replicated (jcprepct.c / jcsample.c
  // expand_*_edge); Cb / Cr by h2v2_downsample of the edge-replicated
  // full-size planes (bias 1, 2, 1, 2, ...), their rows past the image's
  // last copied from it
  const int ys = mcux * ms, yr = mcuy * ms;
  std::vector<uint8_t> yp((size_t)ys * yr), cbp, crp;
  std::vector<uint8_t> cbf, crf;  // full-size chroma, w x h
  if (color) {
    // jccolor.c rgb_ycc_start / rgb_ycc_convert: SCALEBITS 16
    const int32_t one_half = 1 << 15, cbcr_off = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + one_half;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      bcb[i] = fix(0.5) * i + cbcr_off + one_half - 1;  // also R => Cr
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
    cbf.resize((size_t)w * h);
    crf.resize((size_t)w * h);
    for (int y = 0; y < h; ++y) {
      const uint8_t* s = img + (size_t)y * w * 3;
      uint8_t* yo = yp.data() + (size_t)y * ys;
      uint8_t* cbo = cbf.data() + (size_t)y * w;
      uint8_t* cro = crf.data() + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        const int b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
        yo[x] = (uint8_t)((ry[r] + gy[g] + by[b]) >> 16);
        cbo[x] = (uint8_t)((rcb[r] + gcb[g] + bcb[b]) >> 16);
        cro[x] = (uint8_t)((bcb[r] + gcr[g] + bcr[b]) >> 16);
      }
    }
  } else {
    for (int y = 0; y < h; ++y) std::memcpy(yp.data() + (size_t)y * ys, img + (size_t)y * w, w);
  }
  for (int y = 0; y < yr; ++y) {
    uint8_t* row = yp.data() + (size_t)y * ys;
    if (y >= h) std::memcpy(row, yp.data() + (size_t)(h - 1) * ys, w);
    std::memset(row + w, row[w - 1], ys - w);
  }
  const int cs = mcux * 8, cr = mcuy * 8;  // chroma plane size
  if (color) {
    cbp.resize((size_t)cs * cr);
    crp.resize((size_t)cs * cr);
    const int rows = (h + 1) / 2;
    for (int k = 0; k < cr; ++k) {
      uint8_t* ob = cbp.data() + (size_t)k * cs;
      uint8_t* oc = crp.data() + (size_t)k * cs;
      if (k >= rows) {
        std::memcpy(ob, cbp.data() + (size_t)(rows - 1) * cs, cs);
        std::memcpy(oc, crp.data() + (size_t)(rows - 1) * cs, cs);
        continue;
      }
      const int r0 = 2 * k, r1 = std::min(2 * k + 1, h - 1);
      for (int pl = 0; pl < 2; ++pl) {
        const uint8_t* f = pl ? crf.data() : cbf.data();
        uint8_t* out = pl ? oc : ob;
        const uint8_t* a = f + (size_t)r0 * w;
        const uint8_t* b = f + (size_t)r1 * w;
        int bias = 1;
        for (int j = 0; j < cs; ++j) {
          const int x0 = std::min(2 * j, w - 1), x1 = std::min(2 * j + 1, w - 1);
          out[j] = (uint8_t)((a[x0] + a[x1] + b[x0] + b[x1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  uint16_t qlum[64], qchrom[64];
  scaled_quant(kStdLumQuant, quality, qlum);
  scaled_quant(kStdChromQuant, quality, qchrom);
  const HuffEnc dc0(kDcLumBits, kDcVals), ac0(kAcLumBits, kAcLumVals);
  const HuffEnc dc1(kDcChromBits, kDcVals), ac1(kAcChromBits, kAcChromVals);

  // jcmarker.c: SOI, JFIF 1.01 APP0 (no units, density 1:1), DQT per
  // table, SOF0, DHT DC0 AC0 (DC1 AC1), SOS
  const uint8_t app0[16] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F',
                            'I',  'F',  0,    1,    1, 0,  0, 1};
  o.insert(o.end(), app0, app0 + 16);
  put16(o, 1);
  o.push_back(0);
  o.push_back(0);
  write_dqt(o, 0, qlum);
  if (color) write_dqt(o, 1, qchrom);
  marker(o, 0xC0, 6 + 3 * ncomp);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(color && c == 0 ? 0x22 : 0x11);
    o.push_back(c ? 1 : 0);
  }
  write_dht(o, 0x00, dc0);
  write_dht(o, 0x10, ac0);
  if (color) {
    write_dht(o, 0x01, dc1);
    write_dht(o, 0x11, ac1);
  }
  marker(o, 0xDA, 4 + 2 * ncomp);
  o.push_back((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    o.push_back((uint8_t)(c + 1));
    o.push_back(c ? 0x11 : 0x00);
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  // jccoefct.c compress_data: blocks in MCU order; a Y block past the
  // image's blocks is a dummy (zero AC, the DC of the block before it in
  // the MCU)
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[4][64], cb[64], crb[64];
  const int nb = color ? 2 : 1;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      for (int by = 0; by < nb; ++by) {
        for (int bx = 0; bx < nb; ++bx) {
          const int i = by * nb + bx;
          const int gy = my * nb + by, gx = mx * nb + bx;
          if (gy < ybh && gx < ybw) {
            forward_block(yp.data() + (size_t)gy * 8 * ys + (size_t)gx * 8, ys, qlum, blk[i]);
          } else {
            std::memset(blk[i], 0, sizeof blk[i]);
            blk[i][0] = blk[i - 1][0];  // i > 0: block 0 of an MCU always holds data
          }
        }
      }
      for (int i = 0; i < nb * nb; ++i) encode_block(bw, blk[i], last_dc[0], dc0, ac0);
      if (color) {
        const size_t off = (size_t)my * 8 * cs + (size_t)mx * 8;
        forward_block(cbp.data() + off, cs, qchrom, cb);
        forward_block(crp.data() + off, cs, qchrom, crb);
        encode_block(bw, cb, last_dc[1], dc1, ac1);
        encode_block(bw, crb, last_dc[2], dc1, ac1);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

// ------------------------------------------------------------ PNG pixels

int png_channels(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray, alpha
    case 6: return 4;  // RGBA
    default: fail("bad PNG colour type " + std::to_string(color_type));
  }
}

// One pass of the image data: its first pixel, its steps, its size in
// pixels and its bytes a row (the whole image when not interlaced)
struct PngPass {
  int x0, y0, dx, dy, pw, ph;
  size_t row_bytes;
};

// The passes that hold pixels (an empty Adam7 pass has no filter bytes)
std::vector<PngPass> png_passes(int w, int h, int bpp, bool interlaced) {
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*grid)[4] = interlaced ? kAdam7 : kWhole;
  std::vector<PngPass> out;
  for (int p = 0; p < (interlaced ? 7 : 1); ++p) {
    const int x0 = grid[p][0], y0 = grid[p][1], dx = grid[p][2], dy = grid[p][3];
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw && ph) out.push_back({x0, y0, dx, dy, pw, ph, ((size_t)pw * bpp + 7) / 8});
  }
  return out;
}

// The inflated IDAT stream of a PNG -> [h, w, 3] BGR as libpng reads it
// for cv2.imread(path, IMREAD_COLOR): filters 0-4 undone per row, Adam7
// passes placed, 16-bit samples cut to their high byte (png_set_strip_16),
// 1/2/4-bit gray scaled to 0..255 (png_set_expand_gray_1_2_4_to_8), gray
// replicated, the palette looked up (an index past it reads black, as
// libpng's zeroed 256-entry palette does), alpha dropped, RGB -> BGR.
void png_to_bgr(const uint8_t* data, size_t n, int w, int h, int depth, int color_type,
                bool interlaced, const uint8_t* palette, uint8_t* out) {
  const int channels = png_channels(color_type);
  const int bpp = channels * depth;     // bits per pixel
  const int fb = std::max(1, bpp / 8);  // the filters' byte distance
  const int gray_scale = depth == 1 ? 255 : depth == 2 ? 0x55 : depth == 4 ? 0x11 : 1;
  size_t pos = 0;
  std::vector<uint8_t> prev, cur;
  for (const PngPass& pass : png_passes(w, h, bpp, interlaced)) {
    const int x0 = pass.x0, y0 = pass.y0, dx = pass.dx, dy = pass.dy;
    const int pw = pass.pw, ph = pass.ph;
    const size_t rb = pass.row_bytes;
    prev.assign(rb, 0);
    cur.resize(rb);
    for (int r = 0; r < ph; ++r) {
      if (n - pos < rb + 1) fail("PNG image data too short (truncated IDAT stream)");
      const int ft = data[pos];
      const uint8_t* s = data + pos + 1;
      pos += rb + 1;
      uint8_t* c = cur.data();
      const uint8_t* u = prev.data();
      switch (ft) {
        case 0:
          std::memcpy(c, s, rb);
          break;
        case 1:
          for (size_t i = 0; i < rb; ++i) c[i] = (uint8_t)(s[i] + (i >= (size_t)fb ? c[i - fb] : 0));
          break;
        case 2:
          for (size_t i = 0; i < rb; ++i) c[i] = (uint8_t)(s[i] + u[i]);
          break;
        case 3:
          for (size_t i = 0; i < rb; ++i)
            c[i] = (uint8_t)(s[i] + (((i >= (size_t)fb ? c[i - fb] : 0) + u[i]) >> 1));
          break;
        case 4:
          for (size_t i = 0; i < rb; ++i) {
            const int a = i >= (size_t)fb ? c[i - fb] : 0, b = u[i];
            const int cc = i >= (size_t)fb ? u[i - fb] : 0;
            const int pa = std::abs(b - cc), pb = std::abs(a - cc), pc = std::abs(a + b - 2 * cc);
            const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : cc);
            c[i] = (uint8_t)(s[i] + pred);
          }
          break;
        default:
          fail("bad PNG filter type " + std::to_string(ft));
      }
      uint8_t* orow = out + ((size_t)(y0 + r * dy) * w) * 3;
      for (int i = 0; i < pw; ++i) {
        uint8_t* o = orow + (size_t)(x0 + i * dx) * 3;
        if (depth < 8) {  // gray or palette index, packed from the high bits
          const int bit = i * depth;
          const int v = (c[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (color_type == 3) {
            o[0] = palette[3 * v + 2];
            o[1] = palette[3 * v + 1];
            o[2] = palette[3 * v];
          } else {
            o[0] = o[1] = o[2] = (uint8_t)(v * gray_scale);
          }
          continue;
        }
        const uint8_t* px = c + (size_t)i * channels * (depth / 8);  // high byte first
        const int step = depth / 8;
        if (color_type == 3) {
          o[0] = palette[3 * px[0] + 2];
          o[1] = palette[3 * px[0] + 1];
          o[2] = palette[3 * px[0]];
        } else if (channels <= 2) {
          o[0] = o[1] = o[2] = px[0];
        } else {
          o[0] = px[2 * step];
          o[1] = px[step];
          o[2] = px[0];
        }
      }
      std::swap(prev, cur);
    }
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

// cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, quality]) of a [h, w, 3]
// BGR (channels 3) or [h, w] gray (channels 1) uint8 image: returns the
// file's size, its bytes in `out` when that size is at most `cap` (else
// nothing is written, and the caller calls again with that capacity); -1
// with `err` set for an image it cannot write.
int64_t jpeg_encode(const uint8_t* img, int64_t h, int64_t w, int64_t channels, int64_t quality,
                    uint8_t* out, int64_t cap, char* err, int64_t errlen) {
  try {
    if (h < 1 || w < 1 || h > 65535 || w > 65535)
      fail("JPEG size " + std::to_string(h) + "x" + std::to_string(w) +
           " is outside 1..65535");
    if (channels != 1 && channels != 3)
      fail(std::to_string(channels) + "-channel image (JPEG takes 1 or 3)");
    std::vector<uint8_t> o;
    o.reserve(1024 + (size_t)(h * w * channels) / 4);
    encode_jpeg(img, (int)h, (int)w, (int)channels, (int)quality, o);
    if ((int64_t)o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return (int64_t)o.size();
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// The Orientation tag (0x0112) of IFD0 of TIFF-structured Exif data (a
// PNG's eXIf chunk), 0 if none.
int exif_orientation_tag(const uint8_t* data, int64_t n) {
  return exif_orientation(data, (size_t)n);
}

// Bytes of a PNG's inflated image data (each row of each pass and its
// filter byte), or -1 with `err` set for a colour type that does not exist.
int64_t png_data_size(int64_t h, int64_t w, int64_t depth, int64_t color_type,
                      int64_t interlaced, char* err, int64_t errlen) {
  try {
    int64_t total = 0;
    const int bpp = png_channels((int)color_type) * (int)depth;
    for (const PngPass& pass : png_passes((int)w, (int)h, bpp, interlaced != 0))
      total += (int64_t)pass.ph * (int64_t)(pass.row_bytes + 1);
    return total;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// The inflated IDAT stream (n bytes) of a PNG whose IHDR the caller read ->
// [h, w, 3] BGR uint8 in `out`, as cv2.imread(path, IMREAD_COLOR); palette
// holds 256 RGB entries, those past the PLTE chunk zero. Returns 0, or -1
// with `err` set.
int png_decode(const uint8_t* data, int64_t n, int64_t h, int64_t w, int64_t depth,
               int64_t color_type, int64_t interlaced, const uint8_t* palette, uint8_t* out,
               char* err, int64_t errlen) {
  try {
    png_to_bgr(data, (size_t)n, (int)w, (int)h, (int)depth, (int)color_type, interlaced != 0,
               palette, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
