// Text and boxes of the PyTorch port, with no dependency, equal bit for bit
// to what cv2 5.0 draws:
//
//   * draw_text / text_extent: cv2.putText(img, text, org,
//     FONT_HERSHEY_SIMPLEX, scale, colour, thickness, lineType) and
//     cv2.getTextSize. cv2 5.0 no longer strokes Hershey glyphs: it maps
//     the Hershey face, scale and thickness onto a TrueType face, a pixel
//     size and a weight (drawing_text.cpp; the mapping is in vis/draw.py)
//     and renders the variable font it embeds (Rubik, committed beside this
//     package as vis/fonts/Rubik.ttf) with its own copy of stb_truetype,
//     extended for variable fonts. This file is that renderer:
//       - the font: cmap formats 4 and 12, loca / glyf (simple and
//         composite glyphs), fvar + avar normalisation to F2DOT14 with
//         rounded integer division, gvar deltas in OpenCV's fixed point (a
//         16.16 tuple scalar, 24.8 accumulators, floored), IUP on the
//         integer deltas, and the glyph box and advance moved by the
//         phantom points' deltas;
//       - stb_truetype v1.26's outline to vertices (stbtt__GetGlyphShapeTT,
//         int16 coordinates, implied on-curve points at (a + b) >> 1),
//         curve flattening (stbtt_FlattenCurves, 0.35 px) and the exact-area
//         scanline rasteriser (stbtt__rasterize, stbtt__sort_edges,
//         stbtt__rasterize_sorted_edges, stbtt__fill_active_edges_new), fed
//         as OpenCV feeds it: the bitmap padded by max((w + 9) / 10,
//         (h + 9) / 10) + 10 pixels with the padding added to the shift;
//       - the layout of drawing_text.cpp: scale = size / hhea.ascender, each
//         glyph rasterised at a whole pixel, the pen advanced by
//         cvRound(advance * scale * 64) >> 6, a newline down by
//         cvRound(line gap * scale) (ascender - descender when hhea's line
//         gap is 0); each glyph blended into the image in turn as
//         (bg * (255 - a) + colour * a + 127) / 255; no kerning (the font's
//         pair adjustments carry device tables, which stb_truetype skips).
//     A code point the font lacks is refused (cv2 would look in fonts the
//     repository does not hold).
//   * draw_rectangle: cv2.rectangle(img, p1, p2, colour, thickness) with
//     LINE_8: drawing.cpp's PolyLine -> ThickLine -> FillConvexPoly (16.16
//     fixed point) and Circle for the round joins, Line for thickness 1,
//     FillConvexPoly alone for a negative thickness.
//
// Built by streamyolo_torch/native/__init__.py with g++ (-ffp-contract=off:
// the rasteriser's float arithmetic must round as OpenCV's build, which has
// no fused multiply-add, rounds it) and bound with ctypes. Every entry point
// that can fail returns a negative value with a message in `err`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DrawError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// a code point the font has no glyph for (draw_text returns -2)
struct MissingGlyph : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DrawError(msg); }

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err == nullptr || errlen <= 0) return;
  std::strncpy(err, msg, (size_t)errlen - 1);
  err[errlen - 1] = 0;
}

// ---------------------------------------------------------------- font file

struct Bytes {
  const uint8_t* d;
  int64_t n;
  void need(int64_t o, int64_t len) const {
    if (o < 0 || len < 0 || o + len > n) fail("font: a table reads past the end of the file");
  }
  uint8_t u8(int64_t o) const { need(o, 1); return d[o]; }
  int8_t s8(int64_t o) const { return (int8_t)u8(o); }
  uint16_t u16(int64_t o) const { need(o, 2); return (uint16_t)(d[o] << 8 | d[o + 1]); }
  int16_t s16(int64_t o) const { return (int16_t)u16(o); }
  uint32_t u32(int64_t o) const {
    need(o, 4);
    return (uint32_t)d[o] << 24 | (uint32_t)d[o + 1] << 16 | (uint32_t)d[o + 2] << 8 | d[o + 3];
  }
  int32_t s32(int64_t o) const { return (int32_t)u32(o); }
};

struct Font {
  Bytes b;
  int64_t cmap = 0, glyf = 0, loca = 0, hmtx = 0, hhea = 0, head = 0, maxp = 0;
  int64_t fvar = 0, avar = 0, gvar = 0;
  int loca_long = 0, num_glyphs = 0, num_hmetrics = 0;
  int ascent = 0, descent = 0, line_gap = 0;
  std::vector<int> coords;  // normalised F2DOT14, one per fvar axis

  Font(const uint8_t* d, int64_t n) : b{d, n} {
    int tables = b.u16(4);
    for (int i = 0; i < tables; ++i) {
      int64_t rec = 12 + 16 * (int64_t)i;
      uint32_t tag = b.u32(rec), off = b.u32(rec + 8);
      switch (tag) {
        case 0x636d6170: cmap = off; break;  // 'cmap'
        case 0x676c7966: glyf = off; break;  // 'glyf'
        case 0x6c6f6361: loca = off; break;  // 'loca'
        case 0x686d7478: hmtx = off; break;  // 'hmtx'
        case 0x68686561: hhea = off; break;  // 'hhea'
        case 0x68656164: head = off; break;  // 'head'
        case 0x6d617870: maxp = off; break;  // 'maxp'
        case 0x66766172: fvar = off; break;  // 'fvar'
        case 0x61766172: avar = off; break;  // 'avar'
        case 0x67766172: gvar = off; break;  // 'gvar'
      }
    }
    if (!cmap || !glyf || !loca || !hmtx || !hhea || !head || !maxp)
      fail("font: not a TrueType font (a cmap, glyf, loca, hmtx, hhea, head or maxp table is missing)");
    loca_long = b.s16(head + 50);
    num_glyphs = b.u16(maxp + 4);
    ascent = b.s16(hhea + 4);
    descent = b.s16(hhea + 6);
    line_gap = b.s16(hhea + 8);
    num_hmetrics = b.u16(hhea + 34);
    if (ascent <= 0 || num_hmetrics == 0) fail("font: bad hhea table");
    // stbtt_InitFont: the last Unicode subtable (Microsoft BMP or full, or
    // any Unicode platform) is the one read
    int64_t map = 0;
    int subtables = b.u16(cmap + 2);
    for (int i = 0; i < subtables; ++i) {
      int64_t rec = cmap + 4 + 8 * (int64_t)i;
      int platform = b.u16(rec), encoding = b.u16(rec + 2);
      if (platform == 0 || (platform == 3 && (encoding == 1 || encoding == 10)))
        map = cmap + b.u32(rec + 4);
    }
    if (!map) fail("font: no Unicode cmap subtable");
    cmap = map;
    if (fvar) coords.assign(b.u16(fvar + 8), 0);
  }

  // stbtt_FindGlyphIndex for formats 4 and 12; 0 = no glyph
  int glyph_index(uint32_t c) const {
    int format = b.u16(cmap);
    if (format == 4) {
      if (c > 0xffff) return 0;
      int segx2 = b.u16(cmap + 6);
      int64_t ends = cmap + 14, starts = ends + segx2 + 2, deltas = starts + segx2,
              ranges = deltas + segx2;
      for (int s = 0; s < segx2; s += 2) {
        if (c > b.u16(ends + s)) continue;
        uint32_t start = b.u16(starts + s);
        if (c < start) return 0;
        int range = b.u16(ranges + s);
        if (range == 0) return (int)((c + b.u16(deltas + s)) & 0xffff);
        return b.u16(ranges + s + range + 2 * (int64_t)(c - start));
      }
      return 0;
    }
    if (format == 12) {
      uint32_t groups = b.u32(cmap + 12);
      for (uint32_t i = 0; i < groups; ++i) {
        int64_t g = cmap + 16 + 12 * (int64_t)i;
        uint32_t first = b.u32(g), last = b.u32(g + 4);
        if (c >= first && c <= last) return (int)(b.u32(g + 8) + (c - first));
      }
      return 0;
    }
    fail("font: cmap format " + std::to_string(format) + " is not read");
  }

  // offset of glyph g's data in the file, 0 for a glyph without outline
  int64_t glyph_data(int g) const {
    if (g < 0 || g >= num_glyphs) fail("font: glyph index out of range");
    int64_t a, e;
    if (loca_long) {
      a = b.u32(loca + 4 * (int64_t)g);
      e = b.u32(loca + 4 * (int64_t)g + 4);
    } else {
      a = 2 * (int64_t)b.u16(loca + 2 * (int64_t)g);
      e = 2 * (int64_t)b.u16(loca + 2 * (int64_t)g + 2);
    }
    return e > a ? glyf + a : 0;
  }

  int advance(int g) const { return b.u16(hmtx + 4 * (int64_t)std::min(g, num_hmetrics - 1)); }

  // the 'wght' axis at `weight` (others at their default): the user value
  // in 16.16 normalised with rounding to F2DOT14, then mapped through avar's
  // segment with rounded integer division
  void set_weight(int weight) {
    if (!fvar) return;
    int64_t axes = fvar + b.u16(fvar + 4);
    int count = (int)coords.size(), size = b.u16(fvar + 10);
    for (int i = 0; i < count; ++i) {
      int64_t axis = axes + (int64_t)size * i;
      if (b.u32(axis) != 0x77676874) continue;  // 'wght'
      int64_t lo = b.s32(axis + 4), def = b.s32(axis + 8), hi = b.s32(axis + 12);
      int64_t v = std::min(std::max((int64_t)weight << 16, lo), hi);
      int norm = 0;
      if (v < def) norm = -(int)(((def - v) * 16384 + (def - lo) / 2) / (def - lo));
      else if (v > def) norm = (int)(((v - def) * 16384 + (hi - def) / 2) / (hi - def));
      if (avar) {
        int64_t seg = avar + 8;
        for (int k = 0; k < i; ++k) seg += 2 + 4 * (int64_t)b.u16(seg);
        int pairs = b.u16(seg);
        seg += 2;
        for (int k = 1; k < pairs; ++k) {
          int f0 = b.s16(seg + 4 * (k - 1)), t0 = b.s16(seg + 4 * (k - 1) + 2);
          int f1 = b.s16(seg + 4 * k), t1 = b.s16(seg + 4 * k + 2);
          if (f1 <= f0 || t1 < t0) fail("font: avar map is not increasing");
          if (norm >= f0 && norm < f1) {
            norm = ((norm - f0) * (t1 - t0) + ((f1 - f0) >> 1)) / (f1 - f0) + t0;
            break;
          }
          if (k == pairs - 1 && norm == f1) norm = t1;
        }
      }
      coords[i] = norm;
    }
  }
};

// ---------------------------------------------------------------- gvar

// The integer offsets that the gvar tuples at the font's coordinates give
// the n points (phantom points included, the last four) of glyph g: each
// tuple's 16.16 scalar (truncating integer division), its int16 deltas
// (untouched outline points filled by IUP over `ends` when `iup`; else 0),
// scaled into 24.8 accumulators, floored to whole units at the end.
void gvar_offsets(const Font& f, int g, const std::vector<int>& px, const std::vector<int>& py,
                  const std::vector<int>& ends, bool iup, std::vector<int>& ox,
                  std::vector<int>& oy) {
  const Bytes& b = f.b;
  const int n = (int)px.size();
  ox.assign(n, 0);
  oy.assign(n, 0);
  if (!f.gvar) return;
  const int axes = b.u16(f.gvar + 4), shared_count = b.u16(f.gvar + 6);
  const int64_t shared = f.gvar + b.u32(f.gvar + 8);
  const int glyphs = b.u16(f.gvar + 12), flags = b.u16(f.gvar + 14);
  const int64_t array = f.gvar + b.u32(f.gvar + 16);
  if (g >= glyphs || axes != (int)f.coords.size()) return;
  int64_t o0, o1;
  if (flags & 1) {
    o0 = b.u32(f.gvar + 20 + 4 * (int64_t)g);
    o1 = b.u32(f.gvar + 24 + 4 * (int64_t)g);
  } else {
    o0 = 2 * (int64_t)b.u16(f.gvar + 20 + 2 * (int64_t)g);
    o1 = 2 * (int64_t)b.u16(f.gvar + 22 + 2 * (int64_t)g);
  }
  if (o1 <= o0) return;
  const int64_t var = array + o0;
  const int tuples = b.u16(var);
  int64_t data = var + b.u16(var + 2), header = var + 4;

  auto read_points = [&](int64_t& p, std::vector<int>& pts) {  // false: all points
    int count = b.u8(p++);
    if (count & 0x80) count = ((count & 0x7f) << 8) | b.u8(p++);
    pts.clear();
    int last = 0;
    while ((int)pts.size() < count) {
      int control = b.u8(p++);
      int run = (control & 0x7f) + 1;
      for (int k = 0; k < run && (int)pts.size() < count; ++k) {
        last += (control & 0x80) ? b.u16(p) : b.u8(p);
        p += (control & 0x80) ? 2 : 1;
        pts.push_back(last);
      }
    }
    return count != 0;
  };
  auto read_deltas = [&](int64_t& p, int count, std::vector<int>& out) {
    out.clear();
    while ((int)out.size() < count) {
      int control = b.u8(p++);
      int run = (control & 0x3f) + 1;
      for (int k = 0; k < run; ++k) {
        if (control & 0x80) {
          out.push_back(0);
        } else if (control & 0x40) {
          out.push_back(b.s16(p));
          p += 2;
        } else {
          out.push_back(b.s8(p));
          p += 1;
        }
      }
    }
  };

  std::vector<int> shared_points, points, xd, yd;
  bool shared_listed = false;
  if (tuples & 0x8000) shared_listed = read_points(data, shared_points);
  std::vector<int> peak(axes), start(axes), end(axes);
  // per-tuple deltas; the phantom points' entries persist from one tuple to
  // the next when a tuple does not list them, as in OpenCV's loop
  std::vector<int> dx(n, 0), dy(n, 0);
  std::vector<int32_t> ax(n, 0), ay(n, 0);
  const int outline = n - 4;
  const int kUnset = iup ? -32768 : 0;
  for (int t = 0; t < (tuples & 0xfff); ++t) {
    const int size = b.u16(header), index = b.u16(header + 2);
    header += 4;
    if (index & 0x8000) {
      for (int a = 0; a < axes; ++a) peak[a] = b.s16(header + 2 * a);
      header += 2 * axes;
    } else {
      if ((index & 0xfff) >= shared_count) fail("font: gvar shared tuple out of range");
      for (int a = 0; a < axes; ++a)
        peak[a] = b.s16(shared + 2 * ((int64_t)axes * (index & 0xfff) + a));
    }
    const bool intermediate = index & 0x4000;
    if (intermediate) {
      for (int a = 0; a < axes; ++a) start[a] = b.s16(header + 2 * a);
      for (int a = 0; a < axes; ++a) end[a] = b.s16(header + 2 * (axes + a));
      header += 4 * axes;
    }
    int64_t p = data;
    data += size;

    int64_t scalar = 0x10000;
    bool applies = true;
    for (int a = 0; a < axes && applies; ++a) {
      const int pk = peak[a], c = f.coords[a];
      if (pk == c || pk == 0) continue;
      if (c == 0) {
        applies = false;
      } else if (intermediate) {
        if (c < start[a] || c > end[a]) applies = false;
        else if (pk > c) scalar = scalar * (c - start[a]) / (pk - start[a]);
        else scalar = scalar * (end[a] - c) / (end[a] - pk);
      } else if (c > 0 ? c > pk : c < pk) {
        applies = false;
      } else {
        scalar = scalar * c / pk;
      }
    }
    if (!applies || scalar == 0) continue;

    bool listed;
    if (index & 0x2000) listed = read_points(p, points);
    else {
      listed = shared_listed;
      points = shared_points;
    }
    const int count = listed ? (int)points.size() : n;
    read_deltas(p, count, xd);
    read_deltas(p, count, yd);
    if (!listed) {
      for (int i = 0; i < n; ++i) {
        dx[i] = xd[i];
        dy[i] = yd[i];
      }
    } else {
      for (int i = 0; i < outline; ++i) dx[i] = dy[i] = kUnset;
      for (int k = 0; k < count; ++k) {
        if (points[k] >= n) continue;
        dx[points[k]] = xd[k];
        dy[points[k]] = yd[k];
      }
      if (iup && count < n) {
        // interpolate untouched points (IUP) contour by contour, on the
        // unscaled integer deltas, dividing with truncation
        int s = 0;
        for (int e : ends) {
          int first = -1;
          for (int i = s; i <= e; ++i) {
            if (dx[i] != kUnset) {
              first = i;
              break;
            }
          }
          if (first < 0) {
            for (int i = s; i <= e; ++i) dx[i] = dy[i] = 0;
            s = e + 1;
            continue;
          }
          auto next = [&](int i) { return i == e ? s : i + 1; };
          // OpenCV's walk: when the contour's first point is untouched, the
          // points after the last touched one take that point's delta (it
          // is their next touched point as well as their previous one)
          int last = e;
          while (dx[last] == kUnset) --last;
          const bool first_untouched = first != s;
          int prev = first;
          do {
            int touched = next(prev);
            while (dx[touched] == kUnset) touched = next(touched);
            for (int k = next(prev); k != touched; k = next(k)) {
              const int ref = first_untouched && prev == last && k > last ? last : touched;
              for (int axis = 0; axis < 2; ++axis) {
                const std::vector<int>& pos = axis ? py : px;
                std::vector<int>& d = axis ? dy : dx;
                int p1 = pos[prev], p2 = pos[ref], d1 = d[prev], d2 = d[ref], c = pos[k], r;
                if (p1 == p2) r = d1 == d2 ? d1 : 0;
                else if (p1 < p2)
                  r = c <= p1 ? d1 : c >= p2 ? d2 : ((c - p1) * (d2 - d1) + d1 * (p2 - p1)) / (p2 - p1);
                else
                  r = c <= p2 ? d2 : c >= p1 ? d1 : ((c - p2) * (d1 - d2) + d2 * (p1 - p2)) / (p1 - p2);
                d[k] = r;
              }
            }
            prev = touched;
          } while (prev != first);
          s = e + 1;
        }
      }
    }
    for (int i = 0; i < n; ++i) {
      ax[i] += (int32_t)((int32_t)(dx[i] * (int32_t)scalar) >> 8);
      ay[i] += (int32_t)((int32_t)(dy[i] * (int32_t)scalar) >> 8);
    }
  }
  for (int i = 0; i < n; ++i) {
    ox[i] = ax[i] >> 8;
    oy[i] = ay[i] >> 8;
  }
}

// ---------------------------------------------------------------- outlines

enum { kMove = 1, kLine = 2, kCurve = 3 };

struct Vertex {
  int16_t x, y, cx, cy;
  uint8_t type;
};

struct Shape {
  std::vector<Vertex> v;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // the glyph's box, font units
  int advance_delta = 0;               // phantom points' horizontal deltas
};

void set_vertex(std::vector<Vertex>& v, uint8_t type, int x, int y, int cx, int cy) {
  v.push_back({(int16_t)x, (int16_t)y, (int16_t)cx, (int16_t)cy, type});
}

// stbtt__close_shape
void close_shape(std::vector<Vertex>& v, bool was_off, bool start_off, int sx, int sy, int scx,
                 int scy, int cx, int cy) {
  if (start_off) {
    if (was_off) set_vertex(v, kCurve, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy);
    set_vertex(v, kCurve, sx, sy, scx, scy);
  } else {
    if (was_off) set_vertex(v, kCurve, sx, sy, cx, cy);
    else set_vertex(v, kLine, sx, sy, 0, 0);
  }
}

void glyph_shape(const Font& f, int g, Shape& out, int depth);

// stbtt__GetGlyphShapeTT for a simple glyph at `data`, its points moved by
// gvar first
void simple_shape(const Font& f, int g, int64_t data, int contours, Shape& out) {
  const Bytes& b = f.b;
  std::vector<int> ends(contours);
  for (int i = 0; i < contours; ++i) {
    ends[i] = b.u16(data + 10 + 2 * i);
    if (i > 0 && ends[i] <= ends[i - 1]) fail("font: contour ends are not increasing");
  }
  const int n = ends.back() + 1;
  int64_t p = data + 10 + 2 * (int64_t)contours;
  p += 2 + b.u16(p);  // instructions
  std::vector<uint8_t> flags(n);
  for (int i = 0; i < n;) {
    uint8_t fl = b.u8(p++);
    int repeat = (fl & 8) ? b.u8(p++) : 0;
    for (int k = 0; k <= repeat && i < n; ++k) flags[i++] = fl;
  }
  std::vector<int> px(n + 4, 0), py(n + 4, 0);
  int v = 0;
  for (int i = 0; i < n; ++i) {
    if (flags[i] & 2) {
      int d = b.u8(p++);
      v += (flags[i] & 16) ? d : -d;
    } else if (!(flags[i] & 16)) {
      v += b.s16(p);
      p += 2;
    }
    px[i] = (int16_t)v;
  }
  v = 0;
  for (int i = 0; i < n; ++i) {
    if (flags[i] & 4) {
      int d = b.u8(p++);
      v += (flags[i] & 32) ? d : -d;
    } else if (!(flags[i] & 32)) {
      v += b.s16(p);
      p += 2;
    }
    py[i] = (int16_t)v;
  }
  std::vector<int> ox, oy;
  gvar_offsets(f, g, px, py, ends, true, ox, oy);
  for (int i = 0; i < n; ++i) {
    px[i] = (int16_t)(px[i] + ox[i]);
    py[i] = (int16_t)(py[i] + oy[i]);
  }
  out.x0 += ox[n];
  out.x1 += ox[n + 1];
  out.y0 += oy[n + 2];
  out.y1 += oy[n + 3];
  out.advance_delta = ox[n + 1] - ox[n];

  std::vector<Vertex>& vs = out.v;
  int s = 0;
  for (int e : ends) {
    int sx, sy, scx = 0, scy = 0, cx = 0, cy = 0;
    bool start_off = !(flags[s] & 1), was_off = false;
    int i = s + 1;
    if (start_off) {
      // an off-curve start: begin at the midpoint with the next point, or
      // at the next point when it is on the curve
      scx = px[s];
      scy = py[s];
      if (s + 1 < n && !(flags[s + 1] & 1)) {
        sx = (px[s] + px[s + 1]) >> 1;
        sy = (py[s] + py[s + 1]) >> 1;
      } else {
        sx = px[std::min(s + 1, n - 1)];
        sy = py[std::min(s + 1, n - 1)];
        ++i;
      }
    } else {
      sx = px[s];
      sy = py[s];
    }
    set_vertex(vs, kMove, sx, sy, 0, 0);
    for (; i <= e; ++i) {
      if (!(flags[i] & 1)) {
        if (was_off) set_vertex(vs, kCurve, (cx + px[i]) >> 1, (cy + py[i]) >> 1, cx, cy);
        cx = px[i];
        cy = py[i];
        was_off = true;
      } else {
        if (was_off) set_vertex(vs, kCurve, px[i], py[i], cx, cy);
        else set_vertex(vs, kLine, px[i], py[i], 0, 0);
        was_off = false;
      }
    }
    close_shape(vs, was_off, start_off, sx, sy, scx, scy, cx, cy);
    s = e + 1;
  }
}

// stbtt__GetGlyphShapeTT for a composite glyph: each component's offset
// moved by gvar (no IUP), the component's own shape transformed in float
// and truncated to int16
void composite_shape(const Font& f, int g, int64_t data, Shape& out, int depth) {
  const Bytes& b = f.b;
  struct Component {
    int flags, glyph, dx, dy;
    float m[4];
  };
  std::vector<Component> parts;
  int64_t p = data + 10;
  for (bool more = true; more;) {
    Component c{};
    c.flags = b.u16(p);
    c.glyph = b.u16(p + 2);
    p += 4;
    if (!(c.flags & 2)) fail("font: composite glyph placed by matching points is not read");
    if (c.flags & 1) {
      c.dx = b.s16(p);
      c.dy = b.s16(p + 2);
      p += 4;
    } else {
      c.dx = b.s8(p);
      c.dy = b.s8(p + 1);
      p += 2;
    }
    c.m[0] = c.m[3] = 1.f;
    if (c.flags & (1 << 3)) {
      c.m[0] = c.m[3] = b.s16(p) / 16384.0f;
      p += 2;
    } else if (c.flags & (1 << 6)) {
      c.m[0] = b.s16(p) / 16384.0f;
      c.m[3] = b.s16(p + 2) / 16384.0f;
      p += 4;
    } else if (c.flags & (1 << 7)) {
      c.m[0] = b.s16(p) / 16384.0f;
      c.m[1] = b.s16(p + 2) / 16384.0f;
      c.m[2] = b.s16(p + 4) / 16384.0f;
      c.m[3] = b.s16(p + 6) / 16384.0f;
      p += 8;
    }
    parts.push_back(c);
    more = c.flags & (1 << 5);
  }
  // gvar reads at most 32 components
  const int n = std::min((int)parts.size(), 32);
  std::vector<int> px(n + 4, 0), py(n + 4, 0), ox, oy;
  gvar_offsets(f, g, px, py, {}, false, ox, oy);
  out.x0 += ox[n];
  out.x1 += ox[n + 1];
  out.y0 += oy[n + 2];
  out.y1 += oy[n + 3];
  out.advance_delta = ox[n + 1] - ox[n];
  for (int k = 0; k < (int)parts.size(); ++k) {
    const Component& c = parts[k];
    Shape part;
    glyph_shape(f, c.glyph, part, depth + 1);
    if (part.v.empty()) continue;
    const float tx = (float)(c.dx + (k < n ? (int16_t)ox[k] : 0));
    const float ty = (float)(c.dy + (k < n ? (int16_t)oy[k] : 0));
    const float* m = c.m;
    const float sx = std::sqrt(m[0] * m[0] + m[1] * m[1]);
    const float sy = std::sqrt(m[2] * m[2] + m[3] * m[3]);
    for (Vertex& v : part.v) {
      float x = v.x, y = v.y;
      v.x = (int16_t)(sx * (m[0] * x + m[2] * y + tx));
      v.y = (int16_t)(sy * (m[1] * x + m[3] * y + ty));
      x = v.cx;
      y = v.cy;
      v.cx = (int16_t)(sx * (m[0] * x + m[2] * y + tx));
      v.cy = (int16_t)(sy * (m[1] * x + m[3] * y + ty));
    }
    out.v.insert(out.v.end(), part.v.begin(), part.v.end());
  }
}

// the glyph's varied outline, box and advance delta (all zero for a glyph
// without outline)
void glyph_shape(const Font& f, int g, Shape& out, int depth) {
  if (depth > 8) fail("font: composite glyphs nest too deep");
  const int64_t data = f.glyph_data(g);
  out = Shape();
  if (!data) return;
  const Bytes& b = f.b;
  const int contours = b.s16(data);
  out.x0 = b.s16(data + 2);
  out.y0 = b.s16(data + 4);
  out.x1 = b.s16(data + 6);
  out.y1 = b.s16(data + 8);
  if (contours > 0) simple_shape(f, g, data, contours, out);
  else if (contours < 0) composite_shape(f, g, data, out, depth);
}

// ---------------------------------------------------------------- rasteriser
// stb_truetype v1.26, STBTT_RASTERIZER_VERSION 2

struct Point {
  float x, y;
};

// stbtt__tesselate_curve
void tesselate_curve(std::vector<Point>& pts, float x0, float y0, float x1, float y1, float x2,
                     float y2, float flatness_squared, int n) {
  float mx = (x0 + 2 * x1 + x2) / 4;
  float my = (y0 + 2 * y1 + y2) / 4;
  float dx = (x0 + x2) / 2 - mx;
  float dy = (y0 + y2) / 2 - my;
  if (n > 16) return;
  if (dx * dx + dy * dy > flatness_squared) {
    tesselate_curve(pts, x0, y0, (x0 + x1) / 2.0f, (y0 + y1) / 2.0f, mx, my, flatness_squared, n + 1);
    tesselate_curve(pts, mx, my, (x1 + x2) / 2.0f, (y1 + y2) / 2.0f, x2, y2, flatness_squared, n + 1);
  } else {
    pts.push_back({x2, y2});
  }
}

struct Edge {
  float x0, y0, x1, y1;
  int invert;
};

struct ActiveEdge {
  ActiveEdge* next;
  float fx, fdx, fdy;
  float direction;
  float sy, ey;
};

inline bool edge_less(const Edge* a, const Edge* b) { return a->y0 < b->y0; }

// stbtt__sort_edges_ins_sort
void sort_edges_ins(Edge* p, int n) {
  for (int i = 1; i < n; ++i) {
    Edge t = p[i];
    int j = i;
    while (j > 0 && edge_less(&t, &p[j - 1])) {
      p[j] = p[j - 1];
      --j;
    }
    if (i != j) p[j] = t;
  }
}

// stbtt__sort_edges_quicksort (the order of equal keys matters: it decides
// the order in which active edges sum into a scanline)
void sort_edges_quick(Edge* p, int n) {
  while (n > 12) {
    Edge t;
    int m = n >> 1;
    int c01 = edge_less(&p[0], &p[m]);
    int c12 = edge_less(&p[m], &p[n - 1]);
    if (c01 != c12) {
      int c = edge_less(&p[0], &p[n - 1]);
      int z = (c == c12) ? 0 : n - 1;
      t = p[z];
      p[z] = p[m];
      p[m] = t;
    }
    t = p[0];
    p[0] = p[m];
    p[m] = t;
    int i = 1, j = n - 1;
    for (;;) {
      for (;; ++i)
        if (!edge_less(&p[i], &p[0])) break;
      for (;; --j)
        if (!edge_less(&p[0], &p[j])) break;
      if (i >= j) break;
      t = p[i];
      p[i] = p[j];
      p[j] = t;
      ++i;
      --j;
    }
    if (j < (n - i)) {
      sort_edges_quick(p, j);
      p = p + i;
      n = n - i;
    } else {
      sort_edges_quick(p + i, n - i);
      n = j;
    }
  }
}

// stbtt__handle_clipped_edge
void handle_clipped_edge(float* scanline, int x, const ActiveEdge* e, float x0, float y0, float x1,
                         float y1) {
  if (y0 == y1) return;
  if (y0 > e->ey) return;
  if (y1 < e->sy) return;
  if (y0 < e->sy) {
    x0 += (x1 - x0) * (e->sy - y0) / (y1 - y0);
    y0 = e->sy;
  }
  if (y1 > e->ey) {
    x1 += (x1 - x0) * (e->ey - y1) / (y1 - y0);
    y1 = e->ey;
  }
  if (x0 <= x && x1 <= x) scanline[x] += e->direction * (y1 - y0);
  else if (x0 >= x + 1 && x1 >= x + 1) {
  } else scanline[x] += e->direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2);
}

inline float sized_trapezoid_area(float height, float top_width, float bottom_width) {
  return (top_width + bottom_width) / 2.0f * height;
}

inline float position_trapezoid_area(float height, float tx0, float tx1, float bx0, float bx1) {
  return sized_trapezoid_area(height, tx1 - tx0, bx1 - bx0);
}

inline float sized_triangle_area(float height, float width) { return height * width / 2; }

// stbtt__fill_active_edges_new
void fill_active_edges(float* scanline, float* scanline_fill, int len, ActiveEdge* e,
                       float y_top) {
  float y_bottom = y_top + 1;
  while (e) {
    if (e->fdx == 0) {
      float x0 = e->fx;
      if (x0 < len) {
        if (x0 >= 0) {
          handle_clipped_edge(scanline, (int)x0, e, x0, y_top, x0, y_bottom);
          handle_clipped_edge(scanline_fill - 1, (int)x0 + 1, e, x0, y_top, x0, y_bottom);
        } else {
          handle_clipped_edge(scanline_fill - 1, 0, e, x0, y_top, x0, y_bottom);
        }
      }
    } else {
      float x0 = e->fx;
      float dx = e->fdx;
      float xb = x0 + dx;
      float x_top, x_bottom;
      float sy0, sy1;
      float dy = e->fdy;
      // the edge's ends on this scanline
      if (e->sy > y_top) {
        x_top = x0 + dx * (e->sy - y_top);
        sy0 = e->sy;
      } else {
        x_top = x0;
        sy0 = y_top;
      }
      if (e->ey < y_bottom) {
        x_bottom = x0 + dx * (e->ey - y_top);
        sy1 = e->ey;
      } else {
        x_bottom = xb;
        sy1 = y_bottom;
      }
      if (x_top >= 0 && x_bottom >= 0 && x_top < len && x_bottom < len) {
        if ((int)x_top == (int)x_bottom) {
          // one pixel
          int x = (int)x_top;
          float height = (sy1 - sy0) * e->direction;
          scanline[x] += position_trapezoid_area(height, x_top, x + 1.0f, x_bottom, x + 1.0f);
          scanline_fill[x] += height;
        } else {
          // two or more pixels
          float y_crossing, y_final, step, sign, area;
          if (x_top > x_bottom) {
            // flip the scanline vertically; the signed area is the same
            float t;
            sy0 = y_bottom - (sy0 - y_top);
            sy1 = y_bottom - (sy1 - y_top);
            t = sy0, sy0 = sy1, sy1 = t;
            t = x_bottom, x_bottom = x_top, x_top = t;
            dx = -dx;
            dy = -dy;
            t = x0, x0 = xb, xb = t;
          }
          int x1 = (int)x_top;
          int x2 = (int)x_bottom;
          y_crossing = y_top + dy * (x1 + 1 - x0);
          y_final = y_top + dy * (x2 - x0);
          if (y_crossing > y_bottom) y_crossing = y_bottom;
          sign = e->direction;
          area = sign * (y_crossing - sy0);
          scanline[x1] += sized_triangle_area(area, x1 + 1 - x_top);
          if (y_final > y_bottom) {
            y_final = y_bottom;
            dy = (y_final - y_crossing) / (x2 - (x1 + 1));
          }
          step = sign * dy * 1;
          for (int x = x1 + 1; x < x2; ++x) {
            scanline[x] += area + step / 2;
            area += step;
          }
          scanline[x2] += area + sign * position_trapezoid_area(sy1 - y_final, (float)x2,
                                                                  x2 + 1.0f, x_bottom, x2 + 1.0f);
          scanline_fill[x2] += sign * (sy1 - sy0);
        }
      } else {
        // the edge leaves the bitmap: clip it pixel by pixel
        for (int x = 0; x < len; ++x) {
          float y0 = y_top;
          float x1 = (float)(x);
          float x2 = (float)(x + 1);
          float x3 = xb;
          float y3 = y_bottom;
          float y1 = (x - x0) / dx + y_top;
          float y2 = (x + 1 - x0) / dx + y_top;
          if (x0 < x1 && x3 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else if (x3 < x1 && x0 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x0 < x1 && x3 > x1) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x3 < x1 && x0 > x1) {
            handle_clipped_edge(scanline, x, e, x0, y0, x1, y1);
            handle_clipped_edge(scanline, x, e, x1, y1, x3, y3);
          } else if (x0 < x2 && x3 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else if (x3 < x2 && x0 > x2) {
            handle_clipped_edge(scanline, x, e, x0, y0, x2, y2);
            handle_clipped_edge(scanline, x, e, x2, y2, x3, y3);
          } else {
            handle_clipped_edge(scanline, x, e, x0, y0, x3, y3);
          }
        }
      }
    }
    e = e->next;
  }
}

// stbtt__rasterize_sorted_edges: e holds n edges and one sentinel
void rasterize_sorted_edges(uint8_t* out, int w, int h, Edge* e, int n, int off_x, int off_y) {
  std::vector<ActiveEdge> pool;
  pool.reserve(n);
  std::vector<float> buffer(2 * (size_t)w + 1);
  float* scanline = buffer.data();
  float* scanline2 = scanline + w;
  ActiveEdge* active = nullptr;
  int y = off_y;
  e[n].y0 = (float)(off_y + h) + 1;
  for (int j = 0; j < h; ++j, ++y) {
    float scan_y_top = y + 0.0f;
    float scan_y_bottom = y + 1.0f;
    std::memset(scanline, 0, w * sizeof(float));
    std::memset(scanline2, 0, (w + 1) * sizeof(float));
    // drop the edges that end above this scanline
    for (ActiveEdge** step = &active; *step;) {
      ActiveEdge* z = *step;
      if (z->ey <= scan_y_top) *step = z->next;
      else step = &z->next;
    }
    // insert the edges that start above its bottom, at the front
    while (e->y0 <= scan_y_bottom) {
      if (e->y0 != e->y1) {
        pool.push_back(ActiveEdge());
        ActiveEdge* z = &pool.back();
        float dxdy = (e->x1 - e->x0) / (e->y1 - e->y0);
        z->fdx = dxdy;
        z->fdy = dxdy != 0.0f ? (1.0f / dxdy) : 0.0f;
        z->fx = e->x0 + dxdy * (scan_y_top - e->y0);
        z->fx -= off_x;
        z->direction = e->invert ? 1.0f : -1.0f;
        z->sy = e->y0;
        z->ey = e->y1;
        if (j == 0 && off_y != 0 && z->ey < scan_y_top) z->ey = scan_y_top;
        z->next = active;
        active = z;
      }
      ++e;
    }
    if (active) fill_active_edges(scanline, scanline2 + 1, w, active, scan_y_top);
    float sum = 0;
    for (int i = 0; i < w; ++i) {
      sum += scanline2[i];
      float k = scanline[i] + sum;
      k = (float)std::fabs(k) * 255 + 0.5f;
      int m = (int)k;
      if (m > 255) m = 255;
      out[(size_t)j * w + i] = (uint8_t)m;
    }
    for (ActiveEdge* z = active; z; z = z->next) z->fx += z->fdx;
  }
}

// stbtt_Rasterize (flatness 0.35 px, y inverted) of `v` into a w x h
// bitmap whose pixel (0, 0) is at (off_x, off_y)
void rasterize(uint8_t* out, int w, int h, const std::vector<Vertex>& v, float scale,
               float shift_x, float shift_y, int off_x, int off_y) {
  const float flatness = 0.35f / scale;
  const float flatness_squared = flatness * flatness;
  // stbtt_FlattenCurves
  std::vector<Point> pts;
  std::vector<int> lengths;
  float x = 0, y = 0;
  int start = 0;
  for (const Vertex& t : v) {
    if (t.type == kMove) {
      if (!pts.empty()) lengths.push_back((int)pts.size() - start);
      start = (int)pts.size();
      x = t.x;
      y = t.y;
      pts.push_back({x, y});
    } else if (t.type == kLine) {
      x = t.x;
      y = t.y;
      pts.push_back({x, y});
    } else {
      tesselate_curve(pts, x, y, t.cx, t.cy, t.x, t.y, flatness_squared, 0);
      x = t.x;
      y = t.y;
    }
  }
  if (pts.empty()) return;
  lengths.push_back((int)pts.size() - start);
  // stbtt__rasterize: the windings as edges, horizontal ones dropped
  std::vector<Edge> edges;
  edges.reserve(pts.size() + 1);
  const float y_scale_inv = -scale;
  int m = 0;
  for (int len : lengths) {
    const Point* p = pts.data() + m;
    m += len;
    int j = len - 1;
    for (int k = 0; k < len; j = k++) {
      if (p[j].y == p[k].y) continue;
      Edge e;
      int a = k, b = j;
      e.invert = 0;
      if (p[j].y > p[k].y) {
        e.invert = 1;
        a = j;
        b = k;
      }
      e.x0 = p[a].x * scale + shift_x;
      e.y0 = (p[a].y * y_scale_inv + shift_y) * 1;
      e.x1 = p[b].x * scale + shift_x;
      e.y1 = (p[b].y * y_scale_inv + shift_y) * 1;
      edges.push_back(e);
    }
  }
  const int n = (int)edges.size();
  edges.push_back(Edge());
  sort_edges_quick(edges.data(), n);
  sort_edges_ins(edges.data(), n);
  rasterize_sorted_edges(out, w, h, edges.data(), n, off_x, off_y);
}

// ---------------------------------------------------------------- text

struct GlyphImage {
  std::vector<uint8_t> a;  // coverage, w x h
  int w = 0, h = 0;
  int left = 0, top = 0;   // pixel (0, 0) relative to the pen and the baseline
  int advance26 = 0;       // the pen's advance, 26.6 fixed point
  int ink_bottom = 0;      // below the baseline: the lowest inked row + 1, 0 without ink
};

// OpenCV's glyph bitmap: the box at the pen's whole pixel, padded by
// max((w + 9) / 10, (h + 9) / 10) + 10 with the padding added to the shift
GlyphImage render_glyph(const Font& f, int g, float scale) {
  Shape s;
  glyph_shape(f, g, s, 0);
  GlyphImage out;
  const float advance = (float)(f.advance(g) + s.advance_delta) * scale;
  out.advance26 = (int)std::nearbyint(advance * 64.0f);
  if (s.v.empty()) return out;
  const int ix0 = (int)std::floor(s.x0 * scale);
  const int iy0 = (int)std::floor(-s.y1 * scale);
  const int ix1 = (int)std::ceil(s.x1 * scale);
  const int iy1 = (int)std::ceil(-s.y0 * scale);
  const int bw = ix1 - ix0, bh = iy1 - iy0;
  const int pad = std::max((bw + 9) / 10, (bh + 9) / 10) + 10;
  out.w = bw + 2 * pad;
  out.h = bh + 2 * pad;
  out.left = ix0 - pad;
  out.top = iy0 - pad;
  out.a.assign((size_t)out.w * out.h, 0);
  rasterize(out.a.data(), out.w, out.h, s.v, scale, (float)pad, (float)pad, ix0, iy0);
  for (int r = out.h - 1; r >= 0; --r) {
    const uint8_t* row = out.a.data() + (size_t)r * out.w;
    if (std::any_of(row, row + out.w, [](uint8_t v) { return v != 0; })) {
      out.ink_bottom = out.top + r + 1;
      break;
    }
  }
  return out;
}

struct Placed {
  int glyph;
  int64_t x, y;
};

// the glyphs of `text` and where each goes (pen x and baseline y), laid out
// from (org_x, org_y); the rendered glyphs in `cache`
std::vector<Placed> layout(const Font& f, const int32_t* text, int64_t n, int64_t org_x,
                           int64_t org_y, float scale, std::map<int, GlyphImage>& cache) {
  std::vector<Placed> out;
  const int gap = f.line_gap ? f.line_gap : f.ascent - f.descent;
  const int line_step = (int)std::nearbyint((float)gap * scale);
  int64_t x = org_x, y = org_y;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t c = text[i];
    if (c == '\n') {
      // newlines before the first glyph are dropped
      if (!out.empty()) {
        x = org_x;
        y += line_step;
      }
      continue;
    }
    const int g = c < 0 ? 0 : f.glyph_index((uint32_t)c);
    if (g == 0) {
      char buf[96];
      std::snprintf(buf, sizeof buf, "U+%04X: the font has no glyph for this code point", (unsigned)c);
      throw MissingGlyph(buf);
    }
    auto it = cache.find(g);
    if (it == cache.end()) it = cache.emplace(g, render_glyph(f, g, scale)).first;
    out.push_back({g, x, y});
    x += it->second.advance26 >> 6;
  }
  return out;
}

void blend_glyph(uint8_t* img, int64_t h, int64_t w, int64_t channels, const GlyphImage& gi,
                 int64_t x, int64_t y, const int32_t* colour) {
  const int64_t x0 = x + gi.left, y0 = y + gi.top;
  const int64_t r0 = std::max<int64_t>(0, -y0), r1 = std::min<int64_t>(gi.h, h - y0);
  const int64_t c0 = std::max<int64_t>(0, -x0), c1 = std::min<int64_t>(gi.w, w - x0);
  for (int64_t r = r0; r < r1; ++r) {
    const uint8_t* a = gi.a.data() + r * gi.w;
    uint8_t* row = img + ((y0 + r) * w + x0) * channels;
    for (int64_t c = c0; c < c1; ++c) {
      const int alpha = a[c];
      if (!alpha) continue;
      uint8_t* px = row + c * channels;
      for (int64_t k = 0; k < channels; ++k)
        px[k] = (uint8_t)((px[k] * (255 - alpha) + colour[k] * alpha + 127) / 255);
    }
  }
}

// ---------------------------------------------------------------- rectangle
// drawing.cpp (OpenCV 4.x / 5.0), LINE_8 only

const int kShift = 16;
const int64_t kOne = (int64_t)1 << kShift;

// v << s for a v of either sign (OpenCV shifts negative coordinates)
inline int64_t shl(int64_t v, int s) { return v * ((int64_t)1 << s); }

struct Canvas {
  uint8_t* img;
  int64_t h, w, channels;
  const uint8_t* colour;
  void hline(int64_t y, int64_t x1, int64_t x2) const {  // x1 <= x2, inside
    uint8_t* p = img + (y * w + x1) * channels;
    for (int64_t x = x1; x <= x2; ++x, p += channels) std::memcpy(p, colour, channels);
  }
  void put(int64_t x, int64_t y) const {
    if (x >= 0 && x < w && y >= 0 && y < h)
      std::memcpy(img + (y * w + x) * channels, colour, channels);
  }
};

// Line with LINE_8 for a horizontal or vertical segment: every pixel from
// p0 to p1 inside the image
void axis_line(const Canvas& cv, int64_t x0, int64_t y0, int64_t x1, int64_t y1) {
  if (y0 == y1) {
    if (y0 < 0 || y0 >= cv.h) return;
    int64_t a = std::max<int64_t>(std::min(x0, x1), 0), b = std::min<int64_t>(std::max(x0, x1), cv.w - 1);
    if (a <= b) cv.hline(y0, a, b);
  } else {
    int64_t a = std::min(y0, y1), b = std::max(y0, y1);
    for (int64_t y = a; y <= b; ++y) cv.put(x0, y);
  }
}

struct LPoint {
  int64_t x, y;
};

// Line2: the 8-connected line between two 16.16 points, clipped
void line2(const Canvas& cv, LPoint p1, LPoint p2) {
  // clipLine on the scaled image rectangle
  const int64_t right = cv.w * kOne - 1, bottom = cv.h * kOne - 1;
  {
    int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      int64_t a;
      if (c1 & 12) {
        a = c1 < 8 ? 0 : bottom;
        x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
        y1 = a;
        c1 = (x1 < 0) + (x1 > right) * 2;
      }
      if (c2 & 12) {
        a = c2 < 8 ? 0 : bottom;
        x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
        y2 = a;
        c2 = (x2 < 0) + (x2 > right) * 2;
      }
      if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        if (c1) {
          a = c1 == 1 ? 0 : right;
          y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
          x1 = a;
          c1 = 0;
        }
        if (c2) {
          a = c2 == 1 ? 0 : right;
          y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
          x2 = a;
          c2 = 0;
        }
      }
    }
    if ((c1 | c2) != 0) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    p1.x ^= p2.x & j;
    p2.x ^= p1.x & j;
    p1.x ^= p2.x & j;
    p1.y ^= p2.y & j;
    p2.y ^= p1.y & j;
    p1.y ^= p2.y & j;
    x_step = kOne;
    y_step = shl(dy, kShift) / (ax | 1);
    ecount = (int)((p2.x - p1.x) >> kShift);
  } else {
    dx = (dx ^ i) - i;
    p1.x ^= p2.x & i;
    p2.x ^= p1.x & i;
    p1.x ^= p2.x & i;
    p1.y ^= p2.y & i;
    p2.y ^= p1.y & i;
    p1.y ^= p2.y & i;
    x_step = shl(dx, kShift) / (ay | 1);
    y_step = kOne;
    ecount = (int)((p2.y - p1.y) >> kShift);
  }
  p1.x += kOne >> 1;
  p1.y += kOne >> 1;
  cv.put((p2.x + (kOne >> 1)) >> kShift, (p2.y + (kOne >> 1)) >> kShift);
  if (ax > ay) {
    p1.x >>= kShift;
    for (; ecount >= 0; --ecount) {
      cv.put(p1.x, p1.y >> kShift);
      p1.x++;
      p1.y += y_step;
    }
  } else {
    p1.y >>= kShift;
    for (; ecount >= 0; --ecount) {
      cv.put(p1.x >> kShift, p1.y);
      p1.x += x_step;
      p1.y++;
    }
  }
}

// FillConvexPoly with LINE_8 of npts points in `shift`-bit fixed point
void fill_convex_poly(const Canvas& cv, const LPoint* v, int npts, int shift) {
  struct {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  const int64_t delta = ((int64_t)1 << shift) >> 1;
  const int64_t delta1 = kOne >> 1, delta2 = kOne >> 1;
  int imin = 0, edges = npts;
  LPoint p0 = v[npts - 1];
  p0.x = shl(p0.x, kShift - shift);
  p0.y = shl(p0.y, kShift - shift);
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  for (int i = 0; i < npts; ++i) {
    LPoint p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x = shl(p.x, kShift - shift);
    p.y = shl(p.y, kShift - shift);
    // the outline: Line for whole-pixel points (here always a box's
    // sides), Line2 for fixed-point ones
    if (shift == 0) axis_line(cv, p0.x >> kShift, p0.y >> kShift, p.x >> kShift, p.y >> kShift);
    else line2(cv, p0, p);
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || xmax < 0 || ymax < 0 || xmin >= cv.w || ymin >= cv.h) return;
  ymax = std::min<int64_t>(ymax, cv.h - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = (int)ymin;
  int64_t y = ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kOne;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          int64_t ty = (v[idx].y + delta) >> shift;
          if (ty > y) {
            int64_t xs = v[idx0].x, xe = v[idx].x;
            if (shift != kShift) {
              xs = shl(xs, kShift - shift);
              xe = shl(xe, kShift - shift);
            }
            edge[i].ye = (int)ty;
            edge[i].dx = ((xe - xs) * 2 + (ty - y)) / (2 * (ty - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int64_t xx1 = (edge[left].x + delta1) >> kShift;
      int64_t xx2 = (edge[right].x + delta2) >> kShift;
      if (xx2 >= 0 && xx1 < cv.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= cv.w) xx2 = cv.w - 1;
        if (xx1 <= xx2) cv.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= ymax);
}

// Circle, filled: the midpoint circle's spans
void fill_circle(const Canvas& cv, int64_t cx, int64_t cy, int64_t radius) {
  int64_t err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  while (dx >= dy) {
    const int64_t y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int64_t x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (x11 < cv.w && x12 >= 0 && y21 < cv.h && y22 >= 0) {
      x11 = std::max<int64_t>(x11, 0);
      x12 = std::min<int64_t>(x12, cv.w - 1);
      if (y11 >= 0 && y11 < cv.h) cv.hline(y11, x11, x12);
      if (y12 >= 0 && y12 < cv.h) cv.hline(y12, x11, x12);
      if (x21 < cv.w && x22 >= 0) {
        x21 = std::max<int64_t>(x21, 0);
        x22 = std::min<int64_t>(x22, cv.w - 1);
        if (y21 >= 0 && y21 < cv.h) cv.hline(y21, x21, x22);
        if (y22 >= 0 && y22 < cv.h) cv.hline(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int64_t mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// ThickLine between two whole-pixel points, the end capped by a filled
// circle (PolyLine of a closed shape caps every segment's end)
void thick_line(const Canvas& cv, LPoint p0, LPoint p1, int64_t thickness) {
  p0.x = shl(p0.x, kShift);
  p0.y = shl(p0.y, kShift);
  p1.x = shl(p1.x, kShift);
  p1.y = shl(p1.y, kShift);
  if (thickness <= 1) {
    axis_line(cv, (p0.x + (kOne >> 1)) >> kShift, (p0.y + (kOne >> 1)) >> kShift,
              (p1.x + (kOne >> 1)) >> kShift, (p1.y + (kOne >> 1)) >> kShift);
    return;
  }
  const double inv_one = 1. / kOne;
  double dx = (p0.x - p1.x) * inv_one, dy = (p1.y - p0.y) * inv_one;
  double r = dx * dx + dy * dy;
  const int64_t odd = thickness & 1;
  thickness = shl(thickness, kShift - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {  // DBL_EPSILON
    r = (thickness + odd * kOne * 0.5) / std::sqrt(r);
    LPoint d{(int64_t)std::nearbyint(dy * r), (int64_t)std::nearbyint(dx * r)};
    LPoint pt[4] = {{p0.x + d.x, p0.y + d.y},
                    {p0.x - d.x, p0.y - d.y},
                    {p1.x - d.x, p1.y - d.y},
                    {p1.x + d.x, p1.y + d.y}};
    fill_convex_poly(cv, pt, 4, kShift);
  }
  fill_circle(cv, (p1.x + (kOne >> 1)) >> kShift, (p1.y + (kOne >> 1)) >> kShift,
              (thickness + (kOne >> 1)) >> kShift);
}

}  // namespace

extern "C" {

// Draws `text` (n code points; '\n' starts a new line) into the [h, w,
// channels] uint8 image, its first baseline at org_y and its pen at org_x,
// from the TrueType font `font` (font_len bytes) at `size` pixels and
// `weight` (the 'wght' axis), colour[k] into channel k. Nothing is drawn
// unless every code point has a glyph. Returns 0; -2 with `err` naming the
// code point the font lacks; -1 with `err` set for a font it cannot read.
int draw_text(const uint8_t* font, int64_t font_len, uint8_t* img, int64_t h, int64_t w,
              int64_t channels, const int32_t* text, int64_t n, int64_t org_x, int64_t org_y,
              int64_t size, int64_t weight, const int32_t* colour, char* err, int64_t errlen) {
  try {
    Font f(font, font_len);
    f.set_weight((int)weight);
    const float scale = (float)size / (float)f.ascent;
    std::map<int, GlyphImage> cache;
    const std::vector<Placed> placed = layout(f, text, n, org_x, org_y, scale, cache);
    for (const Placed& p : placed) blend_glyph(img, h, w, channels, cache[p.glyph], p.x, p.y, colour);
    return 0;
  } catch (const MissingGlyph& e) {
    set_error(err, errlen, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// cv2.getTextSize of the text draw_text draws: out = {width, height,
// baseline}: the widest line's pen advance + 1, the pixel size, and the
// last line's baseline below the first plus the deepest ink below any
// line's baseline; {1, 0, 0} for newlines alone, {0, 0, 0} for no text.
// Returns 0, -2 or -1 as draw_text.
int text_extent(const uint8_t* font, int64_t font_len, const int32_t* text, int64_t n,
                int64_t size, int64_t weight, int64_t* out, char* err, int64_t errlen) {
  try {
    Font f(font, font_len);
    f.set_weight((int)weight);
    const float scale = (float)size / (float)f.ascent;
    std::map<int, GlyphImage> cache;
    const std::vector<Placed> placed = layout(f, text, n, 0, 0, scale, cache);
    out[0] = n > 0 ? 1 : 0;
    out[1] = out[2] = 0;
    if (placed.empty()) return 0;
    int descent = 0;
    for (const Placed& p : placed) {
      const GlyphImage& g = cache[p.glyph];
      out[0] = std::max<int64_t>(out[0], p.x + (g.advance26 >> 6) + 1);
      descent = std::max(descent, g.ink_bottom);
    }
    out[1] = size;
    out[2] = placed.back().y + descent;
    return 0;
  } catch (const MissingGlyph& e) {
    set_error(err, errlen, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// cv2.rectangle(img, (x1, y1), (x2, y2), colour, thickness) with LINE_8 on
// a [h, w, channels] uint8 image: the four sides as ThickLine with round
// joins (Line for thickness 0 or 1), the filled box for a negative one.
void draw_rectangle(uint8_t* img, int64_t h, int64_t w, int64_t channels, int64_t x1, int64_t y1,
                    int64_t x2, int64_t y2, const int32_t* colour, int64_t thickness) {
  uint8_t raw[4] = {0, 0, 0, 0};
  for (int64_t k = 0; k < channels && k < 4; ++k) raw[k] = (uint8_t)colour[k];
  const Canvas cv{img, h, w, channels, raw};
  const LPoint pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
  if (thickness < 0) {
    fill_convex_poly(cv, pt, 4, 0);
    return;
  }
  // PolyLine, closed: each side from the previous corner
  LPoint p0 = pt[3];
  for (int i = 0; i < 4; ++i) {
    thick_line(cv, p0, pt[i], thickness);
    p0 = pt[i];
  }
}

}  // extern "C"
