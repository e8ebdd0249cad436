// MP4 video writing of the PyTorch port, with no dependency: the file
// cv2.VideoWriter(path, fourcc("mp4v"), fps, (w, h)) writes, made by an
// encoder of our own (vis/video.py binds it).
//
//   * Colour: BGR uint8 -> YUV 4:2:0, BT.601 limited range (the luma of
//     each pixel, the chroma of each 2x2 block's summed colour, integer
//     arithmetic). An odd width or height loses its last column or row, as
//     cv2 does; planes whose size is not a multiple of 16 are padded by
//     edge replication for coding, the VOL carries the true size.
//   * Encoder: ISO/IEC 14496-2 simple profile (profile_and_level 0x01,
//     video_object_type 1), as FFmpeg's mpeg4 encoder behind cv2 codes it:
//     H.263 quantisation at quantiser 3 on every VOP, an I-VOP every 12
//     frames and P-VOPs between them, f_code 1 with half-pel motion and
//     rounding_type alternating 1, 0, 1, ... after each I-VOP, one vector a
//     macroblock (no 4MV, B-VOPs, quarter-pel, GMC, data partitioning or
//     resync markers), intra_dc_vlc_thr 0, no AC prediction, not_coded
//     macroblocks, DC prediction from the F[0][0] neighbours, the median
//     vector predictor, and MPEG-4's three escapes for run/level pairs
//     outside the tables (Tables B-6 to B-8, B-12 to B-14, B-16, B-17).
//   * Motion search: candidates (zero, the left neighbour's vector, the
//     previous P-VOP's vector here and below), a 4-2-1 square search and a
//     small diamond at whole pels, then the eight half-pel neighbours; the
//     cost is the SAD plus the quantiser times the vector's bits. A
//     macroblock is coded intra when its SAD about its mean undercuts the
//     inter cost by 500.
//   * Reconstruction, as a decoder makes it: H.263 inverse quantisation,
//     then FFmpeg's 8-bit simple IDCT (libavcodec/simple_idct_template.c,
//     which FFmpeg's mpeg4 decoder runs, or its bit-exact SIMD form, on a
//     stream without Xvid or DivX user data), then half-pel interpolation
//     with rounding_type from the previous VOP's whole macroblocks (those
//     past the true size included, as FFmpeg's decoder keeps them), padded
//     by edge replication. Any other IDCT or padding would drift from the
//     decoder's pictures across a 12-frame GOP.
//   * Muxer: ftyp, free, mdat (written as frames arrive, so memory holds
//     one frame and its reference), then at close moov: mvhd, trak (tkhd
//     with the 16.16 size, mdia: mdhd, hdlr vide, minf: vmhd, dinf/dref,
//     stbl: stsd mp4v with esds (ES_Descriptor -> DecoderConfigDescriptor
//     objectTypeIndication 0x20, streamType 4 -> DecoderSpecificInfo with
//     the VOS, VO and VOL headers), stts, stss, stsc, stsz, stco). All
//     samples form one chunk at the start of mdat; an mdat of 4 GiB or more
//     takes the 64-bit size in place of the free box.
//
// No floating point decides a bit: the frame rate arrives as the reduced
// fraction (vis/video.py follows OpenCV's rule), so the bytes are the same
// on every host and under -march=native. Macroblock rows are analysed on
// up to 8 threads; each row depends only on the previous VOP and its own
// left neighbours, so the output does not depend on the thread count.
//
// Built by streamyolo_torch/native/__init__.py with g++ (-pthread).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- tables

constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Tables B-13 / B-14: dct_dc_size_luminance / _chrominance, {code, length}
constexpr uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                                   {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
constexpr uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                                     {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
// Table B-6: MCBPC of an I-VOP macroblock (mb_type 3), by cbpc
constexpr uint8_t kMcbpcIntra[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
// Table B-7: MCBPC of a P-VOP macroblock, inter (mb_type 0) then intra
// (mb_type 3), by cbpc
constexpr uint8_t kMcbpcInter[8][2] = {{1, 1}, {3, 4}, {2, 4}, {5, 6},
                                       {3, 5}, {4, 8}, {3, 8}, {3, 7}};
// Table B-8: CBPY of an intra macroblock (an inter one codes cbpy ^ 15)
constexpr uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                                  {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                                  {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Table B-12: motion_code magnitude 0..32, {code, length} before the sign
constexpr uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
    {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
    {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
    {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};

// Tables B-16 (intra) and B-17 (inter) TCOEF: {last, run, level, code,
// length before the sign}; the escape is 0000011
struct Tcoef {
  uint8_t last, run, level;
  uint16_t code;
  uint8_t len;
};
constexpr Tcoef kIntraTcoef[] = {
    {0, 0, 1, 0x2, 2},    {0, 0, 2, 0x6, 3},    {0, 0, 3, 0xf, 4},    {0, 0, 4, 0xd, 5},
    {0, 0, 5, 0xc, 5},    {0, 0, 6, 0x15, 6},   {0, 0, 7, 0x13, 6},   {0, 0, 8, 0x12, 6},
    {0, 0, 9, 0x17, 7},   {0, 0, 10, 0x1f, 8},  {0, 0, 11, 0x1e, 8},  {0, 0, 12, 0x1d, 8},
    {0, 0, 13, 0x25, 9},  {0, 0, 14, 0x24, 9},  {0, 0, 15, 0x23, 9},  {0, 0, 16, 0x21, 9},
    {0, 0, 17, 0x21, 10}, {0, 0, 18, 0x20, 10}, {0, 0, 19, 0xf, 10},  {0, 0, 20, 0xe, 10},
    {0, 0, 21, 0x7, 11},  {0, 0, 22, 0x6, 11},  {0, 0, 23, 0x20, 11}, {0, 0, 24, 0x21, 11},
    {0, 0, 25, 0x50, 12}, {0, 0, 26, 0x51, 12}, {0, 0, 27, 0x52, 12}, {0, 1, 1, 0xe, 4},
    {0, 1, 2, 0x14, 6},   {0, 1, 3, 0x16, 7},   {0, 1, 4, 0x1c, 8},   {0, 1, 5, 0x20, 9},
    {0, 1, 6, 0x1f, 9},   {0, 1, 7, 0xd, 10},   {0, 1, 8, 0x22, 11},  {0, 1, 9, 0x53, 12},
    {0, 1, 10, 0x55, 12}, {0, 2, 1, 0xb, 5},    {0, 2, 2, 0x15, 7},   {0, 2, 3, 0x1e, 9},
    {0, 2, 4, 0xc, 10},   {0, 2, 5, 0x56, 12},  {0, 3, 1, 0x11, 6},   {0, 3, 2, 0x1b, 8},
    {0, 3, 3, 0x1d, 9},   {0, 3, 4, 0xb, 10},   {0, 4, 1, 0x10, 6},   {0, 4, 2, 0x22, 9},
    {0, 4, 3, 0xa, 10},   {0, 5, 1, 0xd, 6},    {0, 5, 2, 0x1c, 9},   {0, 5, 3, 0x8, 10},
    {0, 6, 1, 0x12, 7},   {0, 6, 2, 0x1b, 9},   {0, 6, 3, 0x54, 12},  {0, 7, 1, 0x14, 7},
    {0, 7, 2, 0x1a, 9},   {0, 7, 3, 0x57, 12},  {0, 8, 1, 0x19, 8},   {0, 8, 2, 0x9, 10},
    {0, 9, 1, 0x18, 8},   {0, 9, 2, 0x23, 11},  {0, 10, 1, 0x17, 8},  {0, 11, 1, 0x19, 9},
    {0, 12, 1, 0x18, 9},  {0, 13, 1, 0x7, 10},  {0, 14, 1, 0x58, 12}, {1, 0, 1, 0x7, 4},
    {1, 0, 2, 0xc, 6},    {1, 0, 3, 0x16, 8},   {1, 0, 4, 0x17, 9},   {1, 0, 5, 0x6, 10},
    {1, 0, 6, 0x5, 11},   {1, 0, 7, 0x4, 11},   {1, 0, 8, 0x59, 12},  {1, 1, 1, 0xf, 6},
    {1, 1, 2, 0x16, 9},   {1, 1, 3, 0x5, 10},   {1, 2, 1, 0xe, 6},    {1, 2, 2, 0x4, 10},
    {1, 3, 1, 0x11, 7},   {1, 3, 2, 0x24, 11},  {1, 4, 1, 0x10, 7},   {1, 4, 2, 0x25, 11},
    {1, 5, 1, 0x13, 7},   {1, 5, 2, 0x5a, 12},  {1, 6, 1, 0x15, 8},   {1, 6, 2, 0x5b, 12},
    {1, 7, 1, 0x14, 8},   {1, 8, 1, 0x13, 8},   {1, 9, 1, 0x1a, 8},   {1, 10, 1, 0x15, 9},
    {1, 11, 1, 0x14, 9},  {1, 12, 1, 0x13, 9},  {1, 13, 1, 0x12, 9},  {1, 14, 1, 0x11, 9},
    {1, 15, 1, 0x26, 11}, {1, 16, 1, 0x27, 11}, {1, 17, 1, 0x5c, 12}, {1, 18, 1, 0x5d, 12},
    {1, 19, 1, 0x5e, 12}, {1, 20, 1, 0x5f, 12}};
constexpr Tcoef kInterTcoef[] = {
    {0, 0, 1, 0x2, 2},    {0, 0, 2, 0xf, 4},    {0, 0, 3, 0x15, 6},   {0, 0, 4, 0x17, 7},
    {0, 0, 5, 0x1f, 8},   {0, 0, 6, 0x25, 9},   {0, 0, 7, 0x24, 9},   {0, 0, 8, 0x21, 10},
    {0, 0, 9, 0x20, 10},  {0, 0, 10, 0x7, 11},  {0, 0, 11, 0x6, 11},  {0, 0, 12, 0x20, 11},
    {0, 1, 1, 0x6, 3},    {0, 1, 2, 0x14, 6},   {0, 1, 3, 0x1e, 8},   {0, 1, 4, 0xf, 10},
    {0, 1, 5, 0x21, 11},  {0, 1, 6, 0x50, 12},  {0, 2, 1, 0xe, 4},    {0, 2, 2, 0x1d, 8},
    {0, 2, 3, 0xe, 10},   {0, 2, 4, 0x51, 12},  {0, 3, 1, 0xd, 5},    {0, 3, 2, 0x23, 9},
    {0, 3, 3, 0xd, 10},   {0, 4, 1, 0xc, 5},    {0, 4, 2, 0x22, 9},   {0, 4, 3, 0x52, 12},
    {0, 5, 1, 0xb, 5},    {0, 5, 2, 0xc, 10},   {0, 5, 3, 0x53, 12},  {0, 6, 1, 0x13, 6},
    {0, 6, 2, 0xb, 10},   {0, 6, 3, 0x54, 12},  {0, 7, 1, 0x12, 6},   {0, 7, 2, 0xa, 10},
    {0, 8, 1, 0x11, 6},   {0, 8, 2, 0x9, 10},   {0, 9, 1, 0x10, 6},   {0, 9, 2, 0x8, 10},
    {0, 10, 1, 0x16, 7},  {0, 10, 2, 0x55, 12}, {0, 11, 1, 0x15, 7},  {0, 12, 1, 0x14, 7},
    {0, 13, 1, 0x1c, 8},  {0, 14, 1, 0x1b, 8},  {0, 15, 1, 0x21, 9},  {0, 16, 1, 0x20, 9},
    {0, 17, 1, 0x1f, 9},  {0, 18, 1, 0x1e, 9},  {0, 19, 1, 0x1d, 9},  {0, 20, 1, 0x1c, 9},
    {0, 21, 1, 0x1b, 9},  {0, 22, 1, 0x1a, 9},  {0, 23, 1, 0x22, 11}, {0, 24, 1, 0x23, 11},
    {0, 25, 1, 0x56, 12}, {0, 26, 1, 0x57, 12}, {1, 0, 1, 0x7, 4},    {1, 0, 2, 0x19, 9},
    {1, 0, 3, 0x5, 11},   {1, 1, 1, 0xf, 6},    {1, 1, 2, 0x4, 11},   {1, 2, 1, 0xe, 6},
    {1, 3, 1, 0xd, 6},    {1, 4, 1, 0xc, 6},    {1, 5, 1, 0x13, 7},   {1, 6, 1, 0x12, 7},
    {1, 7, 1, 0x11, 7},   {1, 8, 1, 0x10, 7},   {1, 9, 1, 0x1a, 8},   {1, 10, 1, 0x19, 8},
    {1, 11, 1, 0x18, 8},  {1, 12, 1, 0x17, 8},  {1, 13, 1, 0x16, 8},  {1, 14, 1, 0x15, 8},
    {1, 15, 1, 0x14, 8},  {1, 16, 1, 0x13, 8},  {1, 17, 1, 0x18, 9},  {1, 18, 1, 0x17, 9},
    {1, 19, 1, 0x16, 9},  {1, 20, 1, 0x15, 9},  {1, 21, 1, 0x14, 9},  {1, 22, 1, 0x13, 9},
    {1, 23, 1, 0x12, 9},  {1, 24, 1, 0x11, 9},  {1, 25, 1, 0x7, 10},  {1, 26, 1, 0x6, 10},
    {1, 27, 1, 0x5, 10},  {1, 28, 1, 0x4, 10},  {1, 29, 1, 0x24, 11}, {1, 30, 1, 0x25, 11},
    {1, 31, 1, 0x26, 11}, {1, 32, 1, 0x27, 11}, {1, 33, 1, 0x58, 12}, {1, 34, 1, 0x59, 12},
    {1, 35, 1, 0x5a, 12}, {1, 36, 1, 0x5b, 12}, {1, 37, 1, 0x5c, 12}, {1, 38, 1, 0x5d, 12},
    {1, 39, 1, 0x5e, 12}, {1, 40, 1, 0x5f, 12}};
constexpr uint32_t kEscape = 0x3, kEscapeLen = 7;

// a TCOEF table indexed by (last, run, level): the code (length 0 where
// the table has none), and the largest level of each (last, run) and run
// of each (last, level) for the first two escapes
struct RunLevel {
  uint16_t code[2][64][28];
  uint8_t len[2][64][28];
  uint8_t max_level[2][64];
  uint8_t max_run[2][28];
  template <size_t N>
  explicit RunLevel(const Tcoef (&t)[N]) {
    std::memset(this, 0, sizeof(*this));
    for (const Tcoef& e : t) {
      code[e.last][e.run][e.level] = e.code;
      len[e.last][e.run][e.level] = e.len;
      max_level[e.last][e.run] = std::max(max_level[e.last][e.run], e.level);
      max_run[e.last][e.level] = std::max(max_run[e.last][e.level], e.run);
    }
  }
  int length(int last, int run, int level) const {
    return run < 64 && level < 28 ? len[last][run][level] : 0;
  }
};
const RunLevel kIntraRL(kIntraTcoef), kInterRL(kInterTcoef);

// ------------------------------------------------------------ bit writer

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int len) {  // len <= 32
    if (len == 0) return;
    acc = (acc << len) | (v & (len == 32 ? 0xFFFFFFFFu : ((1u << len) - 1)));
    n += len;
    while (n >= 8) {
      n -= 8;
      out.push_back(uint8_t(acc >> n));
    }
  }
  // next_start_code(): a 0, then 1s to the byte boundary
  void stuffing() {
    put(0, 1);
    int k = (8 - n) & 7;
    if (k) put((1u << k) - 1, k);
  }
  void start_code(uint8_t code) { put(0x000001, 24), put(code, 8); }
  // the bits of another writer after these
  void append(const BitWriter& o) {
    if (n == 0) out.insert(out.end(), o.out.begin(), o.out.end());
    else
      for (uint8_t v : o.out) put(v, 8);
    put(uint32_t(o.acc) & ((1u << o.n) - 1), o.n);
  }
};

// --------------------------------------------------------- DCT and IDCT

// jfdctint.c jpeg_fdct_islow, rows then columns, on samples as given (no
// level shift); the output is scaled up by 8
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

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

// FFmpeg's simple_idct_template.c at 8 bits: idctRowCondDC (with its
// DC-only shortcut) on each row, then the columns; out = the column pass
// before the clip of idct_put / idct_add
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20, kDcShift = 3;

void simple_idct(int16_t* block, int32_t* out) {
  for (int i = 0; i < 8; ++i) {
    int16_t* row = block + 8 * i;
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
      const int16_t v = int16_t(uint16_t(row[0] * (1 << kDcShift)));
      for (int k = 0; k < 8; ++k) row[k] = v;
      continue;
    }
    uint32_t a0 = uint32_t(W4 * row[0]) + (1u << (kRowShift - 1));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += uint32_t(W2 * row[2]);
    a1 += uint32_t(W6 * row[2]);
    a2 -= uint32_t(W6 * row[2]);
    a3 -= uint32_t(W2 * row[2]);
    uint32_t b0 = uint32_t(W1 * row[1]) + uint32_t(W3 * row[3]);
    uint32_t b1 = uint32_t(W3 * row[1]) + uint32_t(-W7 * row[3]);
    uint32_t b2 = uint32_t(W5 * row[1]) + uint32_t(-W1 * row[3]);
    uint32_t b3 = uint32_t(W7 * row[1]) + uint32_t(-W5 * row[3]);
    a0 += uint32_t(W4 * row[4] + W6 * row[6]);
    a1 += uint32_t(-W4 * row[4] - W2 * row[6]);
    a2 += uint32_t(-W4 * row[4] + W2 * row[6]);
    a3 += uint32_t(W4 * row[4] - W6 * row[6]);
    b0 += uint32_t(W5 * row[5]) + uint32_t(W7 * row[7]);
    b1 += uint32_t(-W1 * row[5]) + uint32_t(-W5 * row[7]);
    b2 += uint32_t(W7 * row[5]) + uint32_t(W3 * row[7]);
    b3 += uint32_t(W3 * row[5]) + uint32_t(-W1 * row[7]);
    row[0] = int16_t(int32_t(a0 + b0) >> kRowShift);
    row[7] = int16_t(int32_t(a0 - b0) >> kRowShift);
    row[1] = int16_t(int32_t(a1 + b1) >> kRowShift);
    row[6] = int16_t(int32_t(a1 - b1) >> kRowShift);
    row[2] = int16_t(int32_t(a2 + b2) >> kRowShift);
    row[5] = int16_t(int32_t(a2 - b2) >> kRowShift);
    row[3] = int16_t(int32_t(a3 + b3) >> kRowShift);
    row[4] = int16_t(int32_t(a3 - b3) >> kRowShift);
  }
  for (int i = 0; i < 8; ++i) {
    const int16_t* col = block + i;
    uint32_t a0 = uint32_t(W4 * (col[0] + ((1 << (kColShift - 1)) / W4)));
    uint32_t a1 = a0, a2 = a0, a3 = a0;
    a0 += uint32_t(W2 * col[16]);
    a1 += uint32_t(W6 * col[16]);
    a2 += uint32_t(-W6 * col[16]);
    a3 += uint32_t(-W2 * col[16]);
    uint32_t b0 = uint32_t(W1 * col[8]) + uint32_t(W3 * col[24]);
    uint32_t b1 = uint32_t(W3 * col[8]) + uint32_t(-W7 * col[24]);
    uint32_t b2 = uint32_t(W5 * col[8]) + uint32_t(-W1 * col[24]);
    uint32_t b3 = uint32_t(W7 * col[8]) + uint32_t(-W5 * col[24]);
    a0 += uint32_t(W4 * col[32]);
    a1 += uint32_t(-W4 * col[32]);
    a2 += uint32_t(-W4 * col[32]);
    a3 += uint32_t(W4 * col[32]);
    b0 += uint32_t(W5 * col[40]);
    b1 += uint32_t(-W1 * col[40]);
    b2 += uint32_t(W7 * col[40]);
    b3 += uint32_t(W3 * col[40]);
    a0 += uint32_t(W6 * col[48]);
    a1 += uint32_t(-W2 * col[48]);
    a2 += uint32_t(W2 * col[48]);
    a3 += uint32_t(-W6 * col[48]);
    b0 += uint32_t(W7 * col[56]);
    b1 += uint32_t(-W5 * col[56]);
    b2 += uint32_t(W3 * col[56]);
    b3 += uint32_t(-W1 * col[56]);
    int32_t* o = out + i;
    o[0] = int32_t(a0 + b0) >> kColShift;
    o[8] = int32_t(a1 + b1) >> kColShift;
    o[16] = int32_t(a2 + b2) >> kColShift;
    o[24] = int32_t(a3 + b3) >> kColShift;
    o[32] = int32_t(a3 - b3) >> kColShift;
    o[40] = int32_t(a2 - b2) >> kColShift;
    o[48] = int32_t(a1 - b1) >> kColShift;
    o[56] = int32_t(a0 - b0) >> kColShift;
  }
}

// ---------------------------------------------------------- quantisation

// Table 7-1: dc_scaler of luminance / chrominance blocks
int dc_scale(int q, bool chroma) {
  if (chroma) return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
  return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
}

// samples (pixels of an intra block, residuals of an inter one) -> levels
// in natural order: the DC of an intra block rounded over 8 * dc_scaler,
// every other coefficient truncated over 16 * q (8 for the FDCT's scale,
// 2q for H.263's step), an inter one less a quarter step, as FFmpeg's
// encoder quantises (intra_quant_bias 0, inter_quant_bias -1/4)
void forward_block(const int16_t* in, bool intra, bool chroma, int q, int16_t* levels) {
  int32_t d[64];
  for (int i = 0; i < 64; ++i) d[i] = in[i];
  fdct_islow(d);
  const int step = 16 * q, bias = intra ? 0 : 4 * q;
  int start = 0;
  if (intra) {
    const int s = 8 * dc_scale(q, chroma);
    levels[0] = int16_t((d[0] + (s >> 1)) / s);  // d[0] >= 0 for pixels
    start = 1;
  }
  for (int i = start; i < 64; ++i) {
    const int32_t a = d[i] < 0 ? -d[i] : d[i];
    int32_t level = a > bias ? (a - bias) / step : 0;
    level = std::min(level, 2047);
    levels[i] = int16_t(d[i] < 0 ? -level : level);
  }
}

// levels in natural order -> the IDCT's output: H.263 inverse quantisation
// (the DC of an intra block times dc_scaler; an inter coefficient clipped to
// [-2048, 2047], as the decoder clips escaped levels), then the simple IDCT
void inverse_block(const int16_t* levels, bool intra, bool chroma, int q, int32_t* out) {
  int16_t c[64];
  const int qmul = 2 * q, qadd = (q - 1) | 1;
  for (int i = 0; i < 64; ++i) {
    int32_t l = levels[i], v = 0;
    if (intra && i == 0) {
      v = l * dc_scale(q, chroma);
    } else if (l) {
      v = l > 0 ? l * qmul + qadd : l * qmul - qadd;
      if (!intra) v = std::min(std::max(v, -2048), 2047);
    }
    c[i] = int16_t(v);
  }
  simple_idct(c, out);
}

inline uint8_t clip_u8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- colour

// BT.601 limited range (the coefficients of 8-bit integer converters):
// Y of each pixel, U and V of each 2x2 block's summed B, G, R; one row of
// chroma (r) and its two rows of luma
void bgr_to_yuv420_row(const uint8_t* bgr, int64_t sstride, int w, int r, uint8_t* y, int ys,
                       uint8_t* u, uint8_t* v, int cs) {
  const uint8_t* p0 = bgr + 2 * r * sstride;
  const uint8_t* p1 = p0 + sstride;
  for (int k = 0; k < 2; ++k) {
    const uint8_t* p = k ? p1 : p0;
    uint8_t* yr = y + (2 * r + k) * ys;
    for (int c = 0; c < w; ++c, p += 3)
      yr[c] = uint8_t(((66 * p[2] + 129 * p[1] + 25 * p[0] + 128) >> 8) + 16);
  }
  for (int c = 0; c < w / 2; ++c) {
    const int k = 6 * c;
    const int b = p0[k] + p0[k + 3] + p1[k] + p1[k + 3];
    const int g = p0[k + 1] + p0[k + 4] + p1[k + 1] + p1[k + 4];
    const int rr = p0[k + 2] + p0[k + 5] + p1[k + 2] + p1[k + 5];
    u[r * cs + c] = uint8_t(((-38 * rr - 74 * g + 112 * b + 512) >> 10) + 128);
    v[r * cs + c] = uint8_t(((112 * rr - 94 * g - 18 * b + 512) >> 10) + 128);
  }
}

// fn(0), ..., fn(n - 1) on up to `threads` threads, row i on thread i % t
template <class F>
void parallel_rows(int n, int threads, F&& fn) {
  const int nt = std::max(1, std::min(threads, n));
  if (nt == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t)
    pool.emplace_back([&fn, t, n, nt] {
      for (int i = t; i < n; i += nt) fn(i);
    });
  for (auto& th : pool) th.join();
}

// a plane of w x h samples at (left, top) of a buffer of pw x ph samples
// and stride s: replicate its edges into the rest of the buffer
void pad_plane(uint8_t* p, int s, int w, int h, int left, int top, int pw, int ph) {
  for (int r = top; r < top + h; ++r) {
    uint8_t* row = p + (size_t)r * s;
    std::memset(row, row[left], left);
    std::memset(row + left + w, row[left + w - 1], pw - left - w);
  }
  for (int r = 0; r < top; ++r) std::memcpy(p + (size_t)r * s, p + (size_t)top * s, pw);
  for (int r = top + h; r < ph; ++r)
    std::memcpy(p + (size_t)r * s, p + (size_t)(top + h - 1) * s, pw);
}

// -------------------------------------------------------- motion helpers

inline int sad16(const uint8_t* a, int as, const uint8_t* b, int bs) {
  int s = 0;
  for (int y = 0; y < 16; ++y, a += as, b += bs)
    for (int x = 0; x < 16; ++x) s += std::abs(int(a[x]) - int(b[x]));
  return s;
}

// a w x h prediction at half-pel (hx, hy) in {0, 1} from ref, with
// rounding_type rc (7.6.2.1)
void predict(const uint8_t* ref, int rs, int hx, int hy, int rc, int w, int h, uint8_t* dst,
             int ds) {
  for (int y = 0; y < h; ++y, ref += rs, dst += ds) {
    const uint8_t* r1 = ref + rs;
    for (int x = 0; x < w; ++x) {
      int v;
      if (!hx && !hy) v = ref[x];
      else if (hx && !hy) v = (ref[x] + ref[x + 1] + 1 - rc) >> 1;
      else if (!hx) v = (ref[x] + r1[x] + 1 - rc) >> 1;
      else v = (ref[x] + ref[x + 1] + r1[x] + r1[x + 1] + 2 - rc) >> 2;
      dst[x] = uint8_t(v);
    }
  }
}

// bits of one motion_code with f_code 1 (the value wrapped to [-32, 31])
int mv_bits(int d) {
  d = ((d + 32) & 63) - 32;
  return d == 0 ? 1 : kMv[d < 0 ? -d : d][1] + 1;
}

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ---------------------------------------------------------------- encoder

constexpr int kGop = 12;
constexpr int kQuant = 3;
constexpr int kBorder = 48;  // luma padding of the reference; 24 for chroma
constexpr int kIntraBias = 500;

struct Plane {
  int w = 0, h = 0, border = 0, stride = 0;
  std::vector<uint8_t> data;
  void init(int w_, int h_, int b) {
    w = w_, h = h_, border = b, stride = w + 2 * b;
    data.assign((size_t)stride * (h + 2 * b), 0);
  }
  uint8_t* at(int x, int y) { return data.data() + (size_t)(y + border) * stride + x + border; }
};

enum MbType : uint8_t { kSkip = 0, kInter = 1, kIntra = 2 };

struct Mb {
  MbType type;
  int8_t mvx, mvy;  // half-pel, [-32, 31]
  uint8_t cbp;      // bit 5 = block 0 ... bit 0 = block 5
  int16_t levels[6][64];  // zigzag order
};

struct Encoder {
  FILE* file = nullptr;
  std::string path;
  int width, height;        // coded (even) size
  int mbw, mbh;
  int64_t rate_num, rate_den;  // vop_time_increment_resolution, frame duration
  int time_bits;
  int64_t frames = 0, last_seconds = 0;
  int rounding = 0;
  Plane src[3], recon[3], ref[3];
  std::vector<Mb> mbs;
  std::vector<int8_t> prev_mv;  // the previous P-VOP's vectors, 2 a macroblock
  std::vector<uint32_t> sizes;
  std::vector<uint32_t> keyframes;
  uint64_t mdat_bytes = 0;
  std::vector<uint8_t> headers;  // VOS + VO + VOL
  int threads = 1;
};

void write_headers(Encoder& e) {
  BitWriter b;
  b.start_code(0xB0);  // visual_object_sequence
  b.put(0x01, 8);      // simple profile, level 1
  b.start_code(0xB5);  // visual_object
  b.put(1, 1);         // is_visual_object_identifier
  b.put(1, 4);         // visual_object_verid
  b.put(1, 3);         // visual_object_priority
  b.put(1, 4);         // visual_object_type: video
  b.put(0, 1);         // video_signal_type
  b.stuffing();
  b.start_code(0x00);  // video_object 0
  b.start_code(0x20);  // video_object_layer 0
  b.put(0, 1);         // random_accessible_vol
  b.put(1, 8);         // video_object_type_indication: simple object
  b.put(1, 1);         // is_object_layer_identifier
  b.put(1, 4);         // video_object_layer_verid
  b.put(1, 3);         // video_object_layer_priority
  b.put(1, 4);         // aspect_ratio_info: square
  b.put(1, 1);         // vol_control_parameters
  b.put(1, 2);         // chroma_format 4:2:0
  b.put(1, 1);         // low_delay
  b.put(0, 1);         // vbv_parameters
  b.put(0, 2);         // video_object_layer_shape: rectangular
  b.put(1, 1);
  b.put(uint32_t(e.rate_num), 16);  // vop_time_increment_resolution
  b.put(1, 1);
  b.put(0, 1);  // fixed_vop_rate
  b.put(1, 1);
  b.put(e.width, 13);
  b.put(1, 1);
  b.put(e.height, 13);
  b.put(1, 1);
  b.put(0, 1);  // interlaced
  b.put(1, 1);  // obmc_disable
  b.put(0, 1);  // sprite_enable
  b.put(0, 1);  // not_8_bit
  b.put(0, 1);  // quant_type: H.263
  b.put(1, 1);  // complexity_estimation_disable
  b.put(1, 1);  // resync_marker_disable
  b.put(0, 1);  // data_partitioned
  b.put(0, 1);  // scalability
  b.stuffing();
  e.headers = b.out;
}

// the half-pel motion search of one macroblock; returns the inter cost
int motion_search(Encoder& e, int mx, int my, int pred_x, int pred_y, int& best_x, int& best_y) {
  const int rs = e.ref[0].stride;
  const uint8_t* cur = e.src[0].at(16 * mx, 16 * my);
  const int cs = e.src[0].stride;
  const uint8_t* base = e.ref[0].at(16 * mx, 16 * my);
  auto cost_full = [&](int ix, int iy) {  // whole-pel vector
    return sad16(cur, cs, base + iy * rs + ix, rs) +
           kQuant * (mv_bits(2 * ix - pred_x) + mv_bits(2 * iy - pred_y));
  };
  int bx = 0, by = 0, best = cost_full(0, 0);
  auto consider = [&](int ix, int iy) {
    if (ix < -16 || ix > 15 || iy < -16 || iy > 15) return false;
    int c = cost_full(ix, iy);
    if (c < best) {
      best = c, bx = ix, by = iy;
      return true;
    }
    return false;
  };
  const int mb = my * e.mbw + mx;
  consider(pred_x >> 1, pred_y >> 1);
  consider(e.prev_mv[2 * mb] >> 1, e.prev_mv[2 * mb + 1] >> 1);
  if (my + 1 < e.mbh)
    consider(e.prev_mv[2 * (mb + e.mbw)] >> 1, e.prev_mv[2 * (mb + e.mbw) + 1] >> 1);
  for (int step = 4; step >= 1; step >>= 1) {
    const int cx = bx, cy = by;
    for (int dy = -step; dy <= step; dy += step)
      for (int dx = -step; dx <= step; dx += step)
        if (dx || dy) consider(cx + dx, cy + dy);
  }
  for (int it = 0; it < 16; ++it) {
    const int cx = bx, cy = by;
    bool moved = consider(cx + 1, cy) | consider(cx - 1, cy) | consider(cx, cy + 1) |
                 consider(cx, cy - 1);
    if (!moved) break;
  }
  // half-pel refinement around the whole-pel best
  int hbx = 2 * bx, hby = 2 * by, hbest = best;
  uint8_t tmp[16 * 16];
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      if (!dx && !dy) continue;
      const int hx = 2 * bx + dx, hy = 2 * by + dy;
      if (hx < -32 || hx > 31 || hy < -32 || hy > 31) continue;
      predict(base + (hy >> 1) * rs + (hx >> 1), rs, hx & 1, hy & 1, e.rounding, 16, 16, tmp,
              16);
      const int c = sad16(cur, cs, tmp, 16) +
                    kQuant * (mv_bits(hx - pred_x) + mv_bits(hy - pred_y));
      if (c < hbest) hbest = c, hbx = hx, hby = hy;
    }
  best_x = hbx, best_y = hby;
  return hbest;
}

// one 8x8 block of an MB: samples -> levels (zigzag) and reconstruction
// into dst (the prediction there for an inter block); returns whether any
// level is coded (an intra block's AC, an inter block's any)
bool code_block(const int16_t* samples, bool intra, bool chroma, uint8_t* dst, int ds,
                const uint8_t* pred, int ps, int16_t* zz) {
  int16_t levels[64];
  forward_block(samples, intra, chroma, kQuant, levels);
  bool coded = false;
  for (int i = 0; i < 64; ++i) {
    zz[i] = levels[kZigzag[i]];
    if (zz[i] && (i || !intra)) coded = true;
  }
  int32_t out[64];
  if (!coded && !intra) {
    for (int y = 0; y < 8; ++y) std::memcpy(dst + y * ds, pred + y * ps, 8);
    return false;
  }
  inverse_block(levels, intra, chroma, kQuant, out);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      dst[y * ds + x] = clip_u8((intra ? 0 : pred[y * ps + x]) + out[8 * y + x]);
  return coded;
}

// analyse, code and reconstruct one row of macroblocks
void encode_row(Encoder& e, int my, bool intra_vop) {
  int left_x = 0, left_y = 0;
  for (int mx = 0; mx < e.mbw; ++mx) {
    Mb& m = e.mbs[my * e.mbw + mx];
    const uint8_t* cur = e.src[0].at(16 * mx, 16 * my);
    const int cs = e.src[0].stride;
    bool intra = intra_vop;
    int mvx = 0, mvy = 0;
    if (!intra_vop) {
      const int inter = motion_search(e, mx, my, left_x, left_y, mvx, mvy);
      int sum = 0;
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) sum += cur[y * cs + x];
      const int mean = (sum + 128) >> 8;
      int dev = 0;
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) dev += std::abs(cur[y * cs + x] - mean);
      intra = dev + kIntraBias < inter;
    }
    if (intra) mvx = mvy = 0;
    // predictions: luma 16x16, chroma 8x8 (chroma vector (v >> 1) | (v & 1))
    uint8_t pred[3][256];
    if (!intra) {
      const Plane& r = e.ref[0];
      predict(e.ref[0].at(16 * mx + (mvx >> 1), 16 * my + (mvy >> 1)), r.stride, mvx & 1,
              mvy & 1, e.rounding, 16, 16, pred[0], 16);
      const int cx = (mvx >> 1) | (mvx & 1), cy = (mvy >> 1) | (mvy & 1);
      for (int p = 1; p < 3; ++p)
        predict(e.ref[p].at(8 * mx + (cx >> 1), 8 * my + (cy >> 1)), e.ref[p].stride, cx & 1,
                cy & 1, e.rounding, 8, 8, pred[p], 8);
    }
    int cbp = 0;
    int16_t samples[64];
    for (int b = 0; b < 6; ++b) {
      const int p = b < 4 ? 0 : b - 3;
      const int bx = b < 4 ? 16 * mx + 8 * (b & 1) : 8 * mx;
      const int by = b < 4 ? 16 * my + 8 * (b >> 1) : 8 * my;
      const uint8_t* s = e.src[p].at(bx, by);
      const int ss = e.src[p].stride;
      const int pstride = b < 4 ? 16 : 8;
      const uint8_t* pr = b < 4 ? pred[0] + 8 * (b >> 1) * 16 + 8 * (b & 1) : pred[p];
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          samples[8 * y + x] = int16_t(s[y * ss + x] - (intra ? 0 : pr[y * pstride + x]));
      if (code_block(samples, intra, b >= 4, e.recon[p].at(bx, by), e.recon[p].stride, pr,
                     pstride, m.levels[b]))
        cbp |= 1 << (5 - b);
    }
    m.cbp = uint8_t(cbp);
    m.mvx = int8_t(mvx), m.mvy = int8_t(mvy);
    m.type = intra ? kIntra : (cbp == 0 && mvx == 0 && mvy == 0) ? kSkip : kInter;
    left_x = mvx, left_y = mvy;
  }
}

// the run/level/last events of a block from index start, each as its
// VLC (with the sign) or an escape
void write_coefficients(BitWriter& b, const int16_t* zz, int start, const RunLevel& rl) {
  int last_index = -1;
  for (int i = 63; i >= start; --i)
    if (zz[i]) {
      last_index = i;
      break;
    }
  int run = 0;
  for (int i = start; i <= last_index; ++i) {
    const int v = zz[i];
    if (!v) {
      ++run;
      continue;
    }
    const int last = i == last_index, level = v < 0 ? -v : v, sign = v < 0;
    int len = rl.length(last, run, level);
    if (len) {
      b.put((uint32_t(rl.code[last][run][level]) << 1) | sign, len + 1);
    } else {
      const int level1 = level - rl.max_level[last][run];
      const int run1 = level < 28 ? run - rl.max_run[last][level] - 1 : -1;
      if (level1 >= 1 && (len = rl.length(last, run, level1))) {  // escape 1: level offset
        b.put(kEscape, kEscapeLen);
        b.put(0, 1);
        b.put((uint32_t(rl.code[last][run][level1]) << 1) | sign, len + 1);
      } else if (run1 >= 0 && (len = rl.length(last, run1, level))) {  // escape 2: run
        b.put(kEscape, kEscapeLen);
        b.put(2, 2);
        b.put((uint32_t(rl.code[last][run1][level]) << 1) | sign, len + 1);
      } else {  // escape 3: fixed length
        b.put(kEscape, kEscapeLen);
        b.put(3, 2);
        b.put(last, 1);
        b.put(run, 6);
        b.put(1, 1);
        b.put(uint32_t(v) & 0xFFF, 12);
        b.put(1, 1);
      }
    }
    run = 0;
  }
}

void write_mvd(BitWriter& b, int d) {
  d = ((d + 32) & 63) - 32;
  if (d == 0) {
    b.put(1, 1);
    return;
  }
  const int a = d < 0 ? -d : d;
  b.put((uint32_t(kMv[a][0]) << 1) | (d < 0), kMv[a][1] + 1);
}

// the F[0][0] of every block (1024 outside intra macroblocks, 7.4.3) and
// the vector of every macroblock ((0, 0) unless inter) of a VOP
struct Grids {
  int w[3], h[3];
  std::vector<int16_t> dc[3];
  std::vector<int8_t> mv;
  int dc_at(int p, int x, int y) const {
    return x < 0 || y < 0 || x >= w[p] || y >= h[p] ? 1024 : dc[p][(size_t)y * w[p] + x];
  }
  int mv_at(int mbw, int x, int y, int c) const { return mv[2 * ((size_t)y * mbw + x) + c]; }
};

Grids make_grids(const Encoder& e) {
  Grids g;
  for (int p = 0; p < 3; ++p) {
    g.w[p] = p ? e.mbw : 2 * e.mbw, g.h[p] = p ? e.mbh : 2 * e.mbh;
    g.dc[p].assign((size_t)g.w[p] * g.h[p], 1024);
  }
  g.mv.assign((size_t)e.mbw * e.mbh * 2, 0);
  for (int my = 0; my < e.mbh; ++my)
    for (int mx = 0; mx < e.mbw; ++mx) {
      const int idx = my * e.mbw + mx;
      const Mb& m = e.mbs[idx];
      if (m.type == kInter) g.mv[2 * idx] = m.mvx, g.mv[2 * idx + 1] = m.mvy;
      if (m.type != kIntra) continue;
      for (int k = 0; k < 6; ++k) {
        const int p = k < 4 ? 0 : k - 3;
        const int x = k < 4 ? 2 * mx + (k & 1) : mx, y = k < 4 ? 2 * my + (k >> 1) : my;
        const int f = m.levels[k][0] * dc_scale(kQuant, k >= 4);
        g.dc[p][(size_t)y * g.w[p] + x] = int16_t(std::min(std::max(f, 0), 2047));
      }
    }
  return g;
}

// one row of macroblocks of a VOP
void write_mb_row(const Encoder& e, const Grids& g, bool intra_vop, int my, BitWriter& b) {
  for (int mx = 0; mx < e.mbw; ++mx) {
    const Mb& m = e.mbs[my * e.mbw + mx];
    const int cbpc = m.cbp & 3, cbpy = m.cbp >> 2;
    if (!intra_vop) {
      b.put(m.type == kSkip, 1);  // not_coded
      if (m.type == kSkip) continue;
    }
    if (m.type == kIntra) {
      if (intra_vop) b.put(kMcbpcIntra[cbpc][0], kMcbpcIntra[cbpc][1]);
      else b.put(kMcbpcInter[4 + cbpc][0], kMcbpcInter[4 + cbpc][1]);
      b.put(0, 1);  // ac_pred_flag
      b.put(kCbpy[cbpy][0], kCbpy[cbpy][1]);
      for (int k = 0; k < 6; ++k) {
        // the DC predicted from the left (A) or above (C) neighbour, by
        // the gradients about the above-left one (B)
        const int p = k < 4 ? 0 : k - 3;
        const int x = k < 4 ? 2 * mx + (k & 1) : mx, y = k < 4 ? 2 * my + (k >> 1) : my;
        const int fa = g.dc_at(p, x - 1, y), fb = g.dc_at(p, x - 1, y - 1),
                  fc = g.dc_at(p, x, y - 1);
        const int scale = dc_scale(kQuant, k >= 4);
        const int fp = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
        const int diff = m.levels[k][0] - (fp + (scale >> 1)) / scale;
        const int a = diff < 0 ? -diff : diff;
        int size = 0;
        while (a >> size) ++size;
        const uint8_t(*tab)[2] = k < 4 ? kDcLum : kDcChrom;
        b.put(tab[size][0], tab[size][1]);
        if (size) {
          b.put(uint32_t(diff < 0 ? diff - 1 : diff) & ((1u << size) - 1), size);
          if (size > 8) b.put(1, 1);
        }
        if (m.cbp >> (5 - k) & 1) write_coefficients(b, m.levels[k], 1, kIntraRL);
      }
    } else {
      b.put(kMcbpcInter[cbpc][0], kMcbpcInter[cbpc][1]);
      b.put(kCbpy[cbpy ^ 15][0], kCbpy[cbpy ^ 15][1]);
      // the median of left (A), above (B) and above-right (C); outside
      // the VOP a candidate is 0, or on the first row the left one
      int pred[2];
      for (int c = 0; c < 2; ++c) {
        const int a = mx ? g.mv_at(e.mbw, mx - 1, my, c) : 0;
        pred[c] = my == 0 ? a
                          : median3(a, g.mv_at(e.mbw, mx, my - 1, c),
                                    mx + 1 < e.mbw ? g.mv_at(e.mbw, mx + 1, my - 1, c) : 0);
      }
      write_mvd(b, m.mvx - pred[0]);
      write_mvd(b, m.mvy - pred[1]);
      for (int k = 0; k < 6; ++k)
        if (m.cbp >> (5 - k) & 1) write_coefficients(b, m.levels[k], 0, kInterRL);
    }
  }
}

// the VOP of the macroblocks in e.mbs, its rows written on threads
std::vector<uint8_t> write_vop(Encoder& e, bool intra_vop) {
  BitWriter b;
  b.start_code(0xB6);
  b.put(intra_vop ? 0 : 1, 2);  // vop_coding_type
  const int64_t t = e.frames * e.rate_den;
  const int64_t seconds = t / e.rate_num;
  for (int64_t k = e.last_seconds; k < seconds; ++k) b.put(1, 1);  // modulo_time_base
  e.last_seconds = seconds;
  b.put(0, 1);
  b.put(1, 1);
  b.put(uint32_t(t % e.rate_num), e.time_bits);  // vop_time_increment
  b.put(1, 1);
  b.put(1, 1);  // vop_coded
  if (!intra_vop) b.put(e.rounding, 1);
  b.put(0, 3);  // intra_dc_vlc_thr: the DC VLC always
  b.put(kQuant, 5);
  if (!intra_vop) b.put(1, 3);  // vop_fcode_forward
  Grids g = make_grids(e);
  std::vector<BitWriter> rows(e.mbh);
  parallel_rows(e.mbh, e.threads, [&](int my) { write_mb_row(e, g, intra_vop, my, rows[my]); });
  for (const BitWriter& r : rows) b.append(r);
  b.stuffing();
  if (!intra_vop) e.prev_mv = g.mv;
  return b.out;
}

void put32(std::vector<uint8_t>& o, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) o.push_back(uint8_t(v >> s));
}
void put16(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back(uint8_t(v >> 8)), o.push_back(uint8_t(v));
}
void put_bytes(std::vector<uint8_t>& o, const char* s, size_t n) { o.insert(o.end(), s, s + n); }

// box writing: open returns the size field's offset, close patches it
size_t box_open(std::vector<uint8_t>& o, const char* type) {
  const size_t at = o.size();
  put32(o, 0);
  put_bytes(o, type, 4);
  return at;
}
void box_close(std::vector<uint8_t>& o, size_t at) {
  const uint32_t n = uint32_t(o.size() - at);
  for (int k = 0; k < 4; ++k) o[at + k] = uint8_t(n >> (24 - 8 * k));
}
void full_box_head(std::vector<uint8_t>& o, int version, uint32_t flags) {
  put32(o, (uint32_t(version) << 24) | flags);
}
void descriptor(std::vector<uint8_t>& o, uint8_t tag, const std::vector<uint8_t>& body) {
  o.push_back(tag);
  const uint32_t n = uint32_t(body.size());
  for (int s = 21; s > 0; s -= 7) o.push_back(uint8_t(0x80 | ((n >> s) & 0x7F)));
  o.push_back(uint8_t(n & 0x7F));
  o.insert(o.end(), body.begin(), body.end());
}
void matrix(std::vector<uint8_t>& o) {
  const uint32_t m[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
  for (uint32_t v : m) put32(o, v);
}

constexpr uint32_t kHeadBytes = 28 + 8 + 8;  // ftyp, free, mdat header

std::vector<uint8_t> moov(const Encoder& e) {
  // media timescale: the time base's resolution doubled up to 10000 or
  // more, each sample lasting the frame duration as scaled
  uint64_t timescale = uint64_t(e.rate_num), delta = uint64_t(e.rate_den);
  while (timescale < 10000) timescale *= 2, delta *= 2;
  const uint64_t n = e.sizes.size(), duration = n * delta;
  const uint64_t movie = (duration * 1000 + timescale / 2) / timescale;  // ms
  std::vector<uint8_t> o;
  const size_t moov_at = box_open(o, "moov");
  size_t at = box_open(o, "mvhd");
  full_box_head(o, 0, 0);
  put32(o, 0), put32(o, 0), put32(o, 1000), put32(o, uint32_t(movie));
  put32(o, 0x00010000), put16(o, 0x0100), put16(o, 0), put32(o, 0), put32(o, 0);
  matrix(o);
  for (int k = 0; k < 6; ++k) put32(o, 0);
  put32(o, 2);  // next_track_ID
  box_close(o, at);
  const size_t trak = box_open(o, "trak");
  at = box_open(o, "tkhd");
  full_box_head(o, 0, 3);  // enabled, in movie
  put32(o, 0), put32(o, 0), put32(o, 1), put32(o, 0), put32(o, uint32_t(movie));
  put32(o, 0), put32(o, 0), put16(o, 0), put16(o, 0), put16(o, 0), put16(o, 0);
  matrix(o);
  put32(o, uint32_t(e.width) << 16), put32(o, uint32_t(e.height) << 16);
  box_close(o, at);
  const size_t mdia = box_open(o, "mdia");
  at = box_open(o, "mdhd");
  full_box_head(o, 0, 0);
  put32(o, 0), put32(o, 0), put32(o, uint32_t(timescale)), put32(o, uint32_t(duration));
  put16(o, 0x55C4), put16(o, 0);  // language "und"
  box_close(o, at);
  at = box_open(o, "hdlr");
  full_box_head(o, 0, 0);
  put32(o, 0), put_bytes(o, "vide", 4), put32(o, 0), put32(o, 0), put32(o, 0);
  put_bytes(o, "VideoHandler", 13);
  box_close(o, at);
  const size_t minf = box_open(o, "minf");
  at = box_open(o, "vmhd");
  full_box_head(o, 0, 1);
  put32(o, 0), put32(o, 0);
  box_close(o, at);
  const size_t dinf = box_open(o, "dinf");
  at = box_open(o, "dref");
  full_box_head(o, 0, 0);
  put32(o, 1);
  const size_t url = box_open(o, "url ");
  full_box_head(o, 0, 1);  // self-contained
  box_close(o, url);
  box_close(o, at);
  box_close(o, dinf);
  const size_t stbl = box_open(o, "stbl");
  at = box_open(o, "stsd");
  full_box_head(o, 0, 0);
  put32(o, 1);
  const size_t mp4v = box_open(o, "mp4v");
  for (int k = 0; k < 6; ++k) o.push_back(0);
  put16(o, 1);  // data_reference_index
  put16(o, 0), put16(o, 0), put32(o, 0), put32(o, 0), put32(o, 0);
  put16(o, uint32_t(e.width)), put16(o, uint32_t(e.height));
  put32(o, 0x00480000), put32(o, 0x00480000), put32(o, 0), put16(o, 1);
  for (int k = 0; k < 32; ++k) o.push_back(0);  // compressorname
  put16(o, 0x18), put16(o, 0xFFFF);
  const size_t esds = box_open(o, "esds");
  full_box_head(o, 0, 0);
  uint32_t largest = 0;
  for (uint32_t s : e.sizes) largest = std::max(largest, s);
  const uint32_t avg = duration ? uint32_t((unsigned __int128)e.mdat_bytes * 8 * timescale /
                                            duration) : 0;
  std::vector<uint8_t> dcd{0x20, 0x11};  // MPEG-4 visual, visual stream
  dcd.push_back(uint8_t(largest >> 16)), dcd.push_back(uint8_t(largest >> 8));
  dcd.push_back(uint8_t(largest));
  put32(dcd, avg), put32(dcd, avg);
  descriptor(dcd, 0x05, e.headers);
  std::vector<uint8_t> es{0x00, 0x01, 0x00};  // ES_ID 1, no flags
  descriptor(es, 0x04, dcd);
  descriptor(es, 0x06, {0x02});  // SLConfigDescriptor: predefined MP4
  descriptor(o, 0x03, es);
  box_close(o, esds);
  box_close(o, mp4v);
  box_close(o, at);
  at = box_open(o, "stts");
  full_box_head(o, 0, 0);
  put32(o, n ? 1 : 0);
  if (n) put32(o, uint32_t(n)), put32(o, uint32_t(delta));
  box_close(o, at);
  at = box_open(o, "stss");
  full_box_head(o, 0, 0);
  put32(o, uint32_t(e.keyframes.size()));
  for (uint32_t k : e.keyframes) put32(o, k);
  box_close(o, at);
  at = box_open(o, "stsc");
  full_box_head(o, 0, 0);
  put32(o, n ? 1 : 0);
  if (n) put32(o, 1), put32(o, uint32_t(n)), put32(o, 1);
  box_close(o, at);
  at = box_open(o, "stsz");
  full_box_head(o, 0, 0);
  put32(o, 0), put32(o, uint32_t(n));
  for (uint32_t s : e.sizes) put32(o, s);
  box_close(o, at);
  at = box_open(o, "stco");
  full_box_head(o, 0, 0);
  put32(o, n ? 1 : 0);
  if (n) put32(o, kHeadBytes);
  box_close(o, at);
  box_close(o, stbl);
  box_close(o, minf);
  box_close(o, mdia);
  box_close(o, trak);
  box_close(o, moov_at);
  return o;
}

void set_error(char* err, int64_t cap, const std::string& msg) {
  if (err && cap > 0) std::snprintf(err, size_t(cap), "%s", msg.c_str());
}

bool write_all(Encoder& e, const uint8_t* p, size_t n) {
  return std::fwrite(p, 1, n, e.file) == n;
}

void encode_frame(Encoder& e, const uint8_t* bgr, int64_t sstride) {
  parallel_rows(e.height / 2, e.threads, [&](int r) {
    bgr_to_yuv420_row(bgr, sstride, e.width, r, e.src[0].at(0, 0), e.src[0].stride,
                      e.src[1].at(0, 0), e.src[2].at(0, 0), e.src[1].stride);
  });
  for (int p = 0; p < 3; ++p) {
    Plane& s = e.src[p];
    const int w = p ? e.width / 2 : e.width, h = p ? e.height / 2 : e.height;
    pad_plane(s.data.data(), s.stride, w, h, s.border, s.border, s.stride, s.h + 2 * s.border);
  }
  const bool intra_vop = e.frames % kGop == 0;
  e.rounding = intra_vop ? 0 : e.rounding ^ 1;
  if (intra_vop) std::fill(e.prev_mv.begin(), e.prev_mv.end(), 0);
  parallel_rows(e.mbh, e.threads, [&](int my) { encode_row(e, my, intra_vop); });
  std::vector<uint8_t> vop = write_vop(e, intra_vop);
  // the reference: the reconstruction of whole macroblocks (past the true
  // size too), its edges replicated, as FFmpeg's decoder pads it
  for (int p = 0; p < 3; ++p) {
    const int w = p ? 8 * e.mbw : 16 * e.mbw, h = p ? 8 * e.mbh : 16 * e.mbh;
    Plane& r = e.ref[p];
    for (int y = 0; y < h; ++y)
      std::memcpy(r.at(0, y), e.recon[p].at(0, y), size_t(w));
    pad_plane(r.data.data(), r.stride, w, h, r.border, r.border, r.stride, r.h + 2 * r.border);
  }
  e.sizes.push_back(uint32_t(vop.size()));
  if (intra_vop) e.keyframes.push_back(uint32_t(e.frames + 1));
  e.mdat_bytes += vop.size();
  ++e.frames;
  if (!write_all(e, vop.data(), vop.size())) throw std::runtime_error("write failed");
}

}  // namespace

extern "C" {

// a writer of (width & ~1) x (height & ~1) frames at rate_num / rate_den
// frames a second (a reduced fraction, rate_num < 65536), or null
void* video_open(const char* path, int64_t width, int64_t height, int64_t rate_num,
                 int64_t rate_den, int64_t threads, char* err, int64_t errlen) {
  width &= ~int64_t(1), height &= ~int64_t(1);
  if (width < 2 || height < 2 || width > 8190 || height > 8190) {
    set_error(err, errlen, "frame size " + std::to_string(width) + "x" +
                               std::to_string(height) + " outside 2..8190");
    return nullptr;
  }
  if (rate_num < 1 || rate_num > 65535 || rate_den < 1 || rate_den > (int64_t(1) << 31)) {
    set_error(err, errlen, "time base " + std::to_string(rate_den) + "/" +
                               std::to_string(rate_num) + " outside MPEG-4's range");
    return nullptr;
  }
  Encoder* e = new Encoder();
  e->path = path;
  e->width = int(width), e->height = int(height);
  e->mbw = (e->width + 15) / 16, e->mbh = (e->height + 15) / 16;
  e->rate_num = rate_num, e->rate_den = rate_den;
  e->time_bits = 1;
  while ((int64_t(1) << e->time_bits) < rate_num) ++e->time_bits;
  e->threads = int(std::max<int64_t>(1, std::min<int64_t>(threads, 8)));
  for (int p = 0; p < 3; ++p) {
    const int s = p ? 8 : 16, b = p ? kBorder / 2 : kBorder;
    e->src[p].init(s * e->mbw, s * e->mbh, 0);
    e->recon[p].init(s * e->mbw, s * e->mbh, 0);
    e->ref[p].init(s * e->mbw, s * e->mbh, b);
  }
  e->mbs.resize(size_t(e->mbw) * e->mbh);
  e->prev_mv.assign(size_t(e->mbw) * e->mbh * 2, 0);
  write_headers(*e);
  e->file = std::fopen(path, "wb");
  if (!e->file) {
    set_error(err, errlen, std::string("cannot open ") + path + " for writing");
    delete e;
    return nullptr;
  }
  std::vector<uint8_t> head;
  size_t at = box_open(head, "ftyp");
  put_bytes(head, "isom", 4), put32(head, 0x200);
  put_bytes(head, "isomiso2mp41", 12);
  box_close(head, at);
  put32(head, 8), put_bytes(head, "free", 4);
  put32(head, 8), put_bytes(head, "mdat", 4);  // the size is patched at close
  if (!write_all(*e, head.data(), head.size())) {
    set_error(err, errlen, std::string("cannot write ") + path);
    std::fclose(e->file);
    delete e;
    return nullptr;
  }
  return e;
}

// encode one contiguous BGR frame of the writer's size, or larger by an
// odd row or column (which it drops); 0 or -1
int video_write(void* handle, const uint8_t* bgr, int64_t height, int64_t width, char* err,
                int64_t errlen) {
  Encoder& e = *static_cast<Encoder*>(handle);
  if ((height & ~int64_t(1)) != e.height || (width & ~int64_t(1)) != e.width) {
    set_error(err, errlen, "frame " + std::to_string(width) + "x" + std::to_string(height) +
                               " does not fit the writer's " + std::to_string(e.width) + "x" +
                               std::to_string(e.height));
    return -1;
  }
  try {
    encode_frame(e, bgr, 3 * width);
  } catch (const std::exception& ex) {
    set_error(err, errlen, std::string("cannot write ") + e.path + ": " + ex.what());
    return -1;
  }
  return 0;
}

// the last frame's reconstruction (what a decoder shows), planes of the
// coded size: y [h, w], u and v [h / 2, w / 2]
void video_recon(void* handle, uint8_t* y, uint8_t* u, uint8_t* v) {
  Encoder& e = *static_cast<Encoder*>(handle);
  uint8_t* out[3] = {y, u, v};
  for (int p = 0; p < 3; ++p) {
    const int w = p ? e.width / 2 : e.width, h = p ? e.height / 2 : e.height;
    for (int r = 0; r < h; ++r) std::memcpy(out[p] + (size_t)r * w, e.ref[p].at(0, r), w);
  }
}

// write moov, patch mdat's size, close the file and free the writer; 0 or -1
int video_close(void* handle, char* err, int64_t errlen) {
  Encoder* e = static_cast<Encoder*>(handle);
  bool ok = true;
  std::vector<uint8_t> box = moov(*e);
  ok = write_all(*e, box.data(), box.size());
  const uint64_t mdat = e->mdat_bytes + 8;
  std::vector<uint8_t> head;
  long at = 28 + 8;
  if (mdat <= 0xFFFFFFFFull) {
    put32(head, uint32_t(mdat));
  } else {  // the free box and mdat's header become a 64-bit mdat header
    at = 28;
    put32(head, 1), put_bytes(head, "mdat", 4);
    put32(head, uint32_t((mdat + 8) >> 32)), put32(head, uint32_t(mdat + 8));
  }
  ok = ok && std::fseek(e->file, at, SEEK_SET) == 0 && write_all(*e, head.data(), head.size());
  ok = (std::fclose(e->file) == 0) && ok;
  if (!ok) set_error(err, errlen, "cannot finish " + e->path);
  delete e;
  return ok ? 0 : -1;
}

// the numeric stages alone, for tests: BGR -> the coded size's planes
void video_bgr_to_yuv420(const uint8_t* bgr, int64_t height, int64_t width, uint8_t* y,
                         uint8_t* u, uint8_t* v) {
  const int w = int(width & ~int64_t(1)), h = int(height & ~int64_t(1));
  for (int r = 0; r < h / 2; ++r) bgr_to_yuv420_row(bgr, width * 3, w, r, y, w, u, v, w / 2);
}

// n blocks of 64 samples -> levels (natural order)
void video_forward_blocks(const int16_t* samples, int64_t n, int64_t intra, int64_t chroma,
                          int64_t q, int16_t* levels) {
  for (int64_t k = 0; k < n; ++k)
    forward_block(samples + 64 * k, intra != 0, chroma != 0, int(q), levels + 64 * k);
}

// n blocks of levels -> the IDCT's output before the clip
void video_inverse_blocks(const int16_t* levels, int64_t n, int64_t intra, int64_t chroma,
                          int64_t q, int32_t* out) {
  for (int64_t k = 0; k < n; ++k)
    inverse_block(levels + 64 * k, intra != 0, chroma != 0, int(q), out + 64 * k);
}

}  // extern "C"
