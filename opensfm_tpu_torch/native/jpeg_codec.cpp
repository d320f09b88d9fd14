// JPEG codec for opensfm_tpu_torch: decodes baseline and progressive Huffman
// JPEG and encodes baseline JPEG, with the arithmetic of libjpeg(-turbo) at
// the defaults OpenCV uses, so the port reads and writes the pixels
// cv2.imread / cv2.imwrite give without OpenCV or PIL installed.
//
// Decoder (jpeg_decode):
//   - SOF0/SOF1/SOF2, 8-bit samples, 1 (grey) or 3 (YCbCr) components, any
//     integral sampling factors; restart intervals; every DQT/DHT segment;
//     progressive spectral selection and successive approximation (DC and
//     AC, first and refinement scans).
//   - The slow integer IDCT (libjpeg's jidctint.c, with its range-limit
//     table), "fancy" triangle upsampling for h2v1, h1v2 and h2v2 (jdsample.c;
//     other integral factors replicate), and the fixed-point YCbCr->RGB
//     tables of jdcolor.c.  Grey output of a YCbCr file is its Y plane, as
//     libjpeg gives it for JCS_GRAYSCALE.
//   - Arithmetic coding, lossless and hierarchical frames, 12-bit samples,
//     2 or 4 components and RGB-transform files are reported unsupported
//     (return 1); so is a progressive file whose scans leave AC bits of the
//     first ten coefficients unsent (libjpeg smooths such blocks).
// Encoder (jpeg_encode): JFIF baseline, the standard quantisation tables
// scaled to quality 95 as jpeg_set_quality does, the standard Huffman tables,
// 4:2:0 for colour (libjpeg's rgb_ycc tables, its h2v2 downsampling with
// alternating bias, edge padding and dummy blocks), the slow integer forward
// DCT (jfdctint.c) and libjpeg-turbo's reciprocal quantisation.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see opensfm_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in a corrupt run (as libjpeg's table)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct DecodeError {
  int code;  // 1: unsupported variant, 2: malformed data
  std::string what;
};

[[noreturn]] void fail(int code, const std::string& what) {
  throw DecodeError{code, what};
}

// ---------------------------------------------------------------------------
// Huffman decoding
// ---------------------------------------------------------------------------

struct HuffTable {
  bool defined = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 if longer
  uint8_t look_val[512];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  // False for a table whose codes overflow their lengths.
  bool build(const uint8_t* bits, const uint8_t* huffval, int nvals) {
    std::memcpy(vals, huffval, nvals);
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      if (code + bits[l - 1] > (1 << l)) return false;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          int lo = code << (9 - l), n = 1 << (9 - l);
          for (int j = 0; j < n; ++j) {
            look_len[lo + j] = static_cast<uint8_t>(l);
            look_val[lo + j] = huffval[k];
          }
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  bool marker = false;  // hit a marker: feed zeros until restart()

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t b2 = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (b2 == 0) {
            pos += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  inline int get(int k) {  // k in 0..16
    if (k == 0) return 0;
    if (bits < k) fill();
    int v = static_cast<int>(acc >> (64 - k));
    acc <<= k;
    bits -= k;
    return v;
  }
  inline int get1() { return get(1); }
  inline int decode(const HuffTable& t) {
    if (bits < 16) fill();
    int look = static_cast<int>(acc >> 55);
    int l = t.look_len[look];
    if (l) {
      acc <<= l;
      bits -= l;
      return t.look_val[look];
    }
    int code = static_cast<int>(acc >> 54);  // 10 bits
    l = 10;
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) {  // corrupt: libjpeg warns and yields 0
        acc <<= 16;
        bits -= 16;
        return 0;
      }
      code = static_cast<int>(acc >> (64 - l));
    }
    acc <<= l;
    bits -= l;
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  // Skip to after the next RSTn marker and reset the bit buffer.
  void restart() {
    acc = 0;
    bits = 0;
    marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        return;
      }
      if (d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF) return;
      ++pos;
    }
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// A DC difference category (0..15; baseline files use 0..11).
inline int dc_category(int t) {
  if (t > 15) fail(2, "bad DC difference category");
  return t;
}

// ---------------------------------------------------------------------------
// Decoder state
// ---------------------------------------------------------------------------

struct Component {
  int id, h, v, tq;
  int bw, bh;          // blocks across/down, padded to whole MCUs
  int cw, ch;          // downsampled width/height (samples)
  std::vector<int16_t> coef;  // [bh * bw][64], natural order
  uint16_t q[64];
  bool latched = false;
  int coef_bits[64];   // progressive: -1 unsent, else next Al to refine
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, frame = false;
  bool adobe = false, jfif = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  std::vector<Component> comps;

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  void parse_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3 || p + (pq ? 128 : 64) > end) fail(2, "bad DQT segment");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? u16(p + 2 * k) : d[p + k];
        qt[tq][kZigzag[k]] = static_cast<uint16_t>(v);
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t p, size_t end) {
    while (p + 17 <= end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      const uint8_t* bits = d + p + 1;
      int nv = 0;
      for (int i = 0; i < 16; ++i) nv += bits[i];
      if (th > 3 || tc > 1 || nv > 256 || p + 17 + nv > end)
        fail(2, "bad DHT segment");
      if (!(tc ? ac[th] : dc[th]).build(bits, d + p + 17, nv))
        fail(2, "bad Huffman table");
      p += 17 + nv;
    }
  }

  void parse_sof(size_t p, size_t end, int marker) {
    if (frame) fail(2, "two SOF markers");
    if (p + 6 > end) fail(2, "truncated SOF segment");
    frame = true;
    if (d[p] != 8) fail(1, "sample precision " + std::to_string(d[p]));
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    progressive = marker == 0xC2;
    if (height == 0 || width == 0) fail(1, "zero or DNL-defined image size");
    if (ncomp != 1 && ncomp != 3)
      fail(1, std::to_string(ncomp) + " components");
    if (p + 6 + 3 * static_cast<size_t>(ncomp) > end)
      fail(2, "truncated SOF segment");
    comps.resize(ncomp);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(2, "bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      if (hmax % c.h || vmax % c.v) fail(1, "non-integral sampling factors");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = static_cast<int>((static_cast<long long>(width) * c.h + hmax - 1) / hmax);
      c.ch = static_cast<int>((static_cast<long long>(height) * c.v + vmax - 1) / vmax);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    if (ncomp == 3) {
      bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
      if ((!jfif && adobe && adobe_transform == 0) || (!jfif && !adobe && rgb_ids))
        fail(1, "RGB-transform JPEG");
    }
  }

  // Decode one scan starting at p (after the SOS header); returns the
  // position of the marker that ends it.
  size_t scan(size_t hdr, size_t p) {
    if (!frame) fail(2, "SOS before SOF");
    if (hdr >= p) fail(2, "bad scan header");
    int ns = d[hdr];
    if (ns < 1 || ns > 4 || hdr + 4 + 2 * static_cast<size_t>(ns) > p)
      fail(2, "bad scan header");
    std::vector<Component*> sc;
    std::vector<int> tdc, tac;
    for (int i = 0; i < ns; ++i) {
      int cid = d[hdr + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& cc : comps)
        if (cc.id == cid) c = &cc;
      if (!c) fail(2, "scan names an unknown component");
      sc.push_back(c);
      tdc.push_back(d[hdr + 2 + 2 * i] >> 4);
      tac.push_back(d[hdr + 2 + 2 * i] & 15);
      if (tdc.back() > 3 || tac.back() > 3) fail(2, "bad table id");
      if (!c->latched) {
        if (!qt_defined[c->tq]) fail(2, "undefined quantisation table");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
    }
    size_t q = hdr + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) ||
          al > 13)
        fail(2, "bad progressive scan parameters");
      for (Component* c : sc)
        for (int k = ss; k <= se; ++k) {
          int expected = ah ? ah : -1;
          if (c->coef_bits[k] != expected && !(ah == 0 && c->coef_bits[k] < 0))
            fail(2, "progressive scan out of order");
          c->coef_bits[k] = al;
        }
    }
    // Scan tables present
    for (int i = 0; i < ns; ++i) {
      bool need_dc = (!progressive) || (ss == 0 && ah == 0);
      bool need_ac = (!progressive) || ss > 0;
      if (need_dc && !dc[tdc[i]].defined) fail(2, "undefined DC table");
      if (need_ac && !ac[tac[i]].defined) fail(2, "undefined AC table");
    }
    // End of the entropy-coded segment
    size_t end = p;
    while (end + 1 < n) {
      if (d[end] == 0xFF && d[end + 1] != 0 && !(d[end + 1] >= 0xD0 && d[end + 1] <= 0xD7) &&
          d[end + 1] != 0xFF)
        break;
      ++end;
    }
    if (end + 1 >= n) end = n;
    BitReader br{d, end, p};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    bool single = ns == 1;
    int units_x, units_y;
    if (single) {
      units_x = (sc[0]->cw + 7) / 8;
      units_y = (sc[0]->ch + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long long total = static_cast<long long>(units_x) * units_y;
    int todo = restart_interval;
    for (long long u = 0; u < total; ++u) {
      if (restart_interval) {
        if (todo == 0) {
          br.restart();
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
          todo = restart_interval;
        }
        --todo;
      }
      int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
      for (int i = 0; i < ns; ++i) {
        Component* c = sc[i];
        int nbh = single ? 1 : c->h, nbv = single ? 1 : c->v;
        for (int by = 0; by < nbv; ++by)
          for (int bx = 0; bx < nbh; ++bx) {
            int row = single ? uy : uy * c->v + by;
            int col = single ? ux : ux * c->h + bx;
            int16_t* blk = &c->coef[(static_cast<size_t>(row) * c->bw + col) * 64];
            if (!progressive) {
              int t = dc_category(br.decode(dc[tdc[i]]));
              int diff = t ? extend(br.get(t), t) : 0;
              pred[i] += diff;
              blk[0] = static_cast<int16_t>(pred[i]);
              const HuffTable& at = ac[tac[i]];
              for (int k = 1; k < 64; ++k) {
                int rs = br.decode(at);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s));
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
            } else if (ss == 0) {
              if (ah == 0) {
                int t = dc_category(br.decode(dc[tdc[i]]));
                int diff = t ? extend(br.get(t), t) : 0;
                pred[i] += diff;
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[i]) << al);
              } else if (br.get1()) {
                blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              const HuffTable& at = ac[tac[i]];
              for (int k = ss; k <= se; ++k) {
                int rs = br.decode(at);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  k += r;
                  blk[kZigzag[k]] = static_cast<int16_t>(
                      static_cast<unsigned>(extend(br.get(s), s)) << al);
                } else {
                  if (r == 15) {
                    k += 15;
                  } else {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    --eobrun;
                    break;
                  }
                }
              }
            } else {
              const int p1 = 1 << al, m1 = -1 * (1 << al);
              const HuffTable& at = ac[tac[i]];
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = br.decode(at);
                  int r = rs >> 4, s = rs & 15;
                  if (s) {
                    s = br.get1() ? p1 : m1;
                  } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                  }
                  do {
                    int16_t* cf = blk + kZigzag[k];
                    if (*cf != 0) {
                      if (br.get1() && (*cf & p1) == 0)
                        *cf = static_cast<int16_t>(*cf >= 0 ? *cf + p1 : *cf + m1);
                    } else if (--r < 0) {
                      break;
                    }
                    ++k;
                  } while (k <= se);
                  if (s && k <= 63) blk[kZigzag[k]] = static_cast<int16_t>(s);
                }
              }
              if (eobrun > 0) {
                for (; k <= se; ++k) {
                  int16_t* cf = blk + kZigzag[k];
                  if (*cf != 0 && br.get1() && (*cf & p1) == 0)
                    *cf = static_cast<int16_t>(*cf >= 0 ? *cf + p1 : *cf + m1);
                }
                --eobrun;
              }
            }
          }
      }
    }
    return end;
  }

  // Walk the markers from SOI: to EOI, decoding every scan, or with
  // `header_only` to the end of the frame header.  jpeg_info and
  // jpeg_decode share this one walk, so the size that sizes the output is
  // the size of the frame that is decoded.
  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail(2, "not a JPEG file");
    size_t p = 2;
    while (p + 1 < n) {
      if (d[p] != 0xFF) {
        ++p;  // garbage between markers: libjpeg skips it with a warning
        continue;
      }
      int m = d[p + 1];
      if (m == 0xFF) {
        ++p;
        continue;
      }
      if (m == 0xD9) return;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        p += 2;
        continue;
      }
      if (p + 4 > n) fail(2, "truncated marker");
      size_t len = u16(p + 2);
      size_t body = p + 4, end = p + 2 + len;
      if (len < 2 || end > n) fail(2, "truncated segment");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        parse_sof(body, end, m);
        if (header_only) return;
        for (Component& c : comps) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      } else if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        fail(1, m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF
                    ? "lossless JPEG"
                    : m >= 0xC9 ? "arithmetic-coded JPEG" : "hierarchical JPEG");
      } else if (m == 0xCC) {
        fail(1, "arithmetic-coded JPEG");
      } else if (m == 0xC4) {
        parse_dht(body, end);
      } else if (m == 0xDB) {
        parse_dqt(body, end);
      } else if (m == 0xDD) {
        if (len < 4) fail(2, "bad DRI segment");
        restart_interval = u16(body);
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
      } else if (m == 0xDA) {
        p = scan(body, end);
        continue;
      }
      p = end;
    }
    if (!frame) fail(2, "no frame in the JPEG data");
  }
};

// ---------------------------------------------------------------------------
// Slow integer IDCT (jidctint.c jpeg_idct_islow) into a padded plane
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
}

// libjpeg's post-IDCT range limit: index & 1023, then 0..127 -> +128,
// 128..511 -> 255, 512..895 -> 0, 896..1023 -> -896.
inline uint8_t idct_limit(int32_t x) {
  int i = x & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int32_t dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int k = 0; k < 8; ++k) wp[8 * k] = dcval;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = idct_limit(descale(wp[0], PASS1_BITS + 3));
      for (int k = 0; k < 8; ++k) op[k] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// The component's samples [ch][cw] (downsampled size) from its blocks.
std::vector<uint8_t> component_plane(const Component& c) {
  int pw = c.bw * 8, ph = c.bh * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
  int rows = (c.ch + 7) / 8, cols = (c.cw + 7) / 8;
  for (int by = 0; by < rows; ++by)
    for (int bx = 0; bx < cols; ++bx)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.q,
                 &plane[static_cast<size_t>(by) * 8 * pw + bx * 8], pw);
  std::vector<uint8_t> out(static_cast<size_t>(c.cw) * c.ch);
  for (int y = 0; y < c.ch; ++y)
    std::memcpy(&out[static_cast<size_t>(y) * c.cw], &plane[static_cast<size_t>(y) * pw], c.cw);
  return out;
}

// Upsample a [ch][cw] plane by (fh, fv) as libjpeg's jdsample.c does with
// do_fancy_upsampling, into [height][width].
std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, int cw, int ch, int fh,
                              int fv, int width, int height) {
  if (fh == 1 && fv == 1) return in;
  int ow = cw * fh, oh = ch * fv;
  std::vector<uint8_t> out(static_cast<size_t>(ow) * oh);
  auto row = [&](int y) { return &in[static_cast<size_t>(std::min(std::max(y, 0), ch - 1)) * cw]; };
  if (fh == 2 && fv == 1 && cw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < ch; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* op = &out[static_cast<size_t>(y) * ow];
      op[0] = ip[0];
      op[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < cw - 1; ++x) {
        int v = ip[x] * 3;
        op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
      }
      op[2 * cw - 2] = static_cast<uint8_t>((ip[cw - 1] * 3 + ip[cw - 2] + 1) >> 2);
      op[2 * cw - 1] = ip[cw - 1];
    }
  } else if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < ch; ++y)
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(y);
        const uint8_t* i1 = row(v == 0 ? y - 1 : y + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t* op = &out[static_cast<size_t>(2 * y + v) * ow];
        for (int x = 0; x < cw; ++x) op[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
      }
  } else if (fh == 2 && fv == 2 && cw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < ch; ++y)
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(y);
        const uint8_t* i1 = row(v == 0 ? y - 1 : y + 1);
        uint8_t* op = &out[static_cast<size_t>(2 * y + v) * ow];
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        op[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
        op[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < cw - 1; ++x) {
          nextcol = i0[x + 1] * 3 + i1[x + 1];
          op[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * cw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * cw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      }
  } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replicate
    for (int y = 0; y < oh; ++y) {
      const uint8_t* ip = row(y / fv);
      uint8_t* op = &out[static_cast<size_t>(y) * ow];
      for (int x = 0; x < ow; ++x) op[x] = ip[x / fh];
    }
  }
  // Crop to [height][width] (ow >= width, oh >= height).
  std::vector<uint8_t> crop(static_cast<size_t>(width) * height);
  for (int y = 0; y < height; ++y)
    std::memcpy(&crop[static_cast<size_t>(y) * width], &out[static_cast<size_t>(y) * ow], width);
  return crop;
}

std::vector<uint8_t> crop_plane(const std::vector<uint8_t>& in, int cw, int width, int height) {
  std::vector<uint8_t> out(static_cast<size_t>(width) * height);
  for (int y = 0; y < height; ++y)
    std::memcpy(&out[static_cast<size_t>(y) * width], &in[static_cast<size_t>(y) * cw], width);
  return out;
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return static_cast<int32_t>(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = static_cast<int>((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ITU T.81 Annex K.3 tables
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int bits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (bits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      bits -= 8;
    }
    acc &= (1u << bits) - 1;
  }
  void flush() {
    if (bits) put(0x7F, 7);  // pad with ones (libjpeg's flush_bits)
    bits = 0;
    acc = 0;
  }
};

void put_marker(std::vector<uint8_t>& o, int m) {
  o.push_back(0xFF);
  o.push_back(static_cast<uint8_t>(m));
}
void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 255));
}

// jfdctint.c jpeg_fdct_islow on 8x8 samples already centred at zero.
void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* dp = data + 8 * r;
    int64_t tmp0 = dp[0] + dp[7], tmp7 = dp[0] - dp[7];
    int64_t tmp1 = dp[1] + dp[6], tmp6 = dp[1] - dp[6];
    int64_t tmp2 = dp[2] + dp[5], tmp5 = dp[2] - dp[5];
    int64_t tmp3 = dp[3] + dp[4], tmp4 = dp[3] - dp[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    dp[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
    dp[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    dp[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    dp[6] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    dp[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    dp[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    dp[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    dp[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* dp = data + c;
    int64_t tmp0 = dp[0] + dp[56], tmp7 = dp[0] - dp[56];
    int64_t tmp1 = dp[8] + dp[48], tmp6 = dp[8] - dp[48];
    int64_t tmp2 = dp[16] + dp[40], tmp5 = dp[16] - dp[40];
    int64_t tmp3 = dp[24] + dp[32], tmp4 = dp[24] - dp[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    dp[0] = descale(tmp10 + tmp11, PASS1_BITS);
    dp[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    dp[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    dp[48] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    dp[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    dp[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    dp[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    dp[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// libjpeg-turbo jcdctmgr.c compute_reciprocal (16-bit DCTELEM).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};
Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

inline int quantize(int32_t v, const Divisor& dv) {
  if (dv.shift == 0) return v;  // divisor 1
  uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
  uint32_t prod = (a + dv.corr) * dv.recip;  // UDCTELEM2 product
  int q = static_cast<int>(static_cast<uint16_t>(prod >> dv.shift));
  return v < 0 ? -q : q;
}

struct EncComponent {
  int h, v, tq, tdc, tac;
  int bw, bh;  // blocks across/down in the component, whole MCUs
  std::vector<uint8_t> plane;  // [bh*8][bw*8], edges replicated
  int pw;
};

}  // namespace

extern "C" {

// Header of a JPEG: info = {height, width, components, progressive}.
// Returns 0, 1 (unsupported variant) or 2 (malformed), with a message.
int jpeg_info(const uint8_t* data, long long n, int* info, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = static_cast<size_t>(n);
    dec.parse(true);
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = dec.ncomp;
    info[3] = dec.progressive;
    return 0;
  } catch (const DecodeError& e) {
    std::snprintf(err, errlen, "%s", e.what.c_str());
    return e.code;
  }
}

// Decode into `out`: grey = 1 writes the Y (or only) plane [h][w]; else a
// 3-component file writes RGB [h][w][3] and a 1-component file its grey
// plane [h][w].  `out` holds `cap` bytes, which must be h * w * (grey ? 1 :
// components) of the decoded frame, else the call fails (code 2).
int jpeg_decode(const uint8_t* data, long long n, int grey, uint8_t* out, long long cap,
                char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = static_cast<size_t>(n);
    dec.parse(false);
    const long long need = static_cast<long long>(dec.width) * dec.height *
                           (grey || dec.ncomp == 1 ? 1 : 3);
    if (need != cap) fail(2, "the output buffer does not fit the frame");
    if (dec.progressive)
      for (const Component& c : dec.comps)
        for (int k = 0; k < 10; ++k)
          if (c.coef_bits[k] != 0)
            fail(1, "progressive JPEG with coefficient bits left unsent");
    for (const Component& c : dec.comps)
      if (!c.latched) fail(2, "a component has no scan");
    const int w = dec.width, h = dec.height;
    const Component& c0 = dec.comps[0];
    std::vector<uint8_t> y0 = component_plane(c0);
    std::vector<uint8_t> Y = c0.h == dec.hmax && c0.v == dec.vmax
                                 ? crop_plane(y0, c0.cw, w, h)
                                 : upsample(y0, c0.cw, c0.ch, dec.hmax / c0.h, dec.vmax / c0.v, w, h);
    if (grey || dec.ncomp == 1) {
      std::memcpy(out, Y.data(), static_cast<size_t>(w) * h);
      return 0;
    }
    std::vector<uint8_t> planes[2];
    for (int i = 1; i < 3; ++i) {
      const Component& c = dec.comps[i];
      std::vector<uint8_t> p = component_plane(c);
      if (c.h == dec.hmax && c.v == dec.vmax)
        planes[i - 1] = crop_plane(p, c.cw, w, h);
      else
        planes[i - 1] = upsample(p, c.cw, c.ch, dec.hmax / c.h, dec.vmax / c.v, w, h);
    }
    static const YccTables t;
    const size_t np = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < np; ++i) {
      int yy = Y[i], cb = planes[0][i], cr = planes[1][i];
      out[3 * i] = clamp255(yy + t.cr_r[cr]);
      out[3 * i + 1] = clamp255(yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(yy + t.cb_b[cb]);
    }
    return 0;
  } catch (const DecodeError& e) {
    std::snprintf(err, errlen, "%s", e.what.c_str());
    return e.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "out of memory");
    return 2;
  }
}

// Encode [h][w][c] uint8 (c = 1 grey, 3 RGB) as a baseline JFIF JPEG at
// quality 95, chroma 4:2:0: what cv2.imwrite writes at its defaults.
// Returns a malloc'ed buffer (free with jpeg_free) and its size in *outlen,
// or nullptr.
uint8_t* jpeg_encode(const uint8_t* pix, int h, int w, int c, long long* outlen) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (c != 1 && c != 3)) return nullptr;
  constexpr int kQuality = 95;  // jpeg_quality_scaling: 200 - 2 * quality
  constexpr int scale = 200 - 2 * kQuality;
  uint16_t qt[2][64];
  for (int k = 0; k < 64; ++k) {
    long t0 = (static_cast<long>(kStdLumaQ[k]) * scale + 50) / 100;
    long t1 = (static_cast<long>(kStdChromaQ[k]) * scale + 50) / 100;
    qt[0][k] = static_cast<uint16_t>(t0 < 1 ? 1 : t0 > 255 ? 255 : t0);
    qt[1][k] = static_cast<uint16_t>(t1 < 1 ? 1 : t1 > 255 ? 255 : t1);
  }
  const int nc = c;
  const int hmax = nc == 3 ? 2 : 1, vmax = hmax;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax), mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  std::vector<EncComponent> comps(nc);
  for (int i = 0; i < nc; ++i) {
    EncComponent& e = comps[i];
    e.h = e.v = i == 0 ? hmax : 1;
    e.tq = e.tdc = e.tac = i == 0 ? 0 : 1;
    e.bw = mcux * e.h;
    e.bh = mcuy * e.v;
    e.pw = e.bw * 8;
    e.plane.assign(static_cast<size_t>(e.pw) * e.bh * 8, 0);
  }
  // Colour conversion (jccolor.c rgb_ycc_convert) into full-size planes
  // padded right to the Y blocks' width and down to an even row count.
  const int ycols = ((w + 7) / 8) * 8;  // Y width_in_blocks * 8
  const int ccols = nc == 3 ? ((w + 15) / 16) * 16 : ycols;  // chroma input width
  const int fullw = std::max(ycols, ccols);
  const int fullh = (h + vmax - 1) / vmax * vmax;
  std::vector<uint8_t> full[3];
  for (int i = 0; i < nc; ++i) full[i].assign(static_cast<size_t>(fullw) * fullh, 0);
  if (nc == 3) {
    int32_t tab[8 * 256];
    const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
    auto FIX = [](double x) { return static_cast<int32_t>(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      tab[i] = FIX(0.29900) * i;
      tab[i + 256] = FIX(0.58700) * i;
      tab[i + 512] = FIX(0.11400) * i + ONE_HALF;
      tab[i + 768] = (-FIX(0.16874)) * i;
      tab[i + 1024] = (-FIX(0.33126)) * i;
      tab[i + 1280] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
      tab[i + 1536] = (-FIX(0.41869)) * i;
      tab[i + 1792] = (-FIX(0.08131)) * i;
    }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = pix + (static_cast<size_t>(y) * w + x) * 3;
        int r = p[0], g = p[1], b = p[2];
        size_t o = static_cast<size_t>(y) * fullw + x;
        full[0][o] = static_cast<uint8_t>((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
        full[1][o] = static_cast<uint8_t>((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
        full[2][o] = static_cast<uint8_t>((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
      }
  } else {
    for (int y = 0; y < h; ++y)
      std::memcpy(&full[0][static_cast<size_t>(y) * fullw], pix + static_cast<size_t>(y) * w, w);
  }
  for (int i = 0; i < nc; ++i) {
    std::vector<uint8_t>& f = full[i];
    for (int y = 0; y < h; ++y) {  // expand_right_edge
      uint8_t* row = &f[static_cast<size_t>(y) * fullw];
      std::memset(row + w, row[w - 1], fullw - w);
    }
    for (int y = h; y < fullh; ++y)  // expand_bottom_edge to the row group
      std::memcpy(&f[static_cast<size_t>(y) * fullw], &f[static_cast<size_t>(h - 1) * fullw], fullw);
  }
  // Downsample (fullsize copy for Y, h2v2 with alternating bias for chroma),
  // then pad the rows down to the component's whole iMCU rows.
  for (int i = 0; i < nc; ++i) {
    EncComponent& e = comps[i];
    const bool sub = e.h != hmax;
    const int outcols = ((i == 0 ? w : (w + 1) / 2) + 7) / 8 * 8;  // width_in_blocks * 8
    const int outrows = sub ? fullh / 2 : fullh;
    for (int y = 0; y < outrows; ++y) {
      uint8_t* op = &e.plane[static_cast<size_t>(y) * e.pw];
      if (!sub) {
        std::memcpy(op, &full[i][static_cast<size_t>(y) * fullw], outcols);
      } else {
        const uint8_t* i0 = &full[i][static_cast<size_t>(2 * y) * fullw];
        const uint8_t* i1 = i0 + fullw;
        int bias = 1;
        for (int x = 0; x < outcols; ++x) {
          op[x] = static_cast<uint8_t>((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int y = outrows; y < e.bh * 8; ++y)
      std::memcpy(&e.plane[static_cast<size_t>(y) * e.pw],
                  &e.plane[static_cast<size_t>(outrows - 1) * e.pw], e.pw);
    e.bw = outcols / 8;  // real blocks across (dummy blocks fill the MCU)
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 64; ++k) div[t][k] = reciprocal(static_cast<uint32_t>(qt[t][k]) << 3);

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  put_marker(o, 0xD8);
  put_marker(o, 0xE0);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put16(o, 16);
  o.insert(o.end(), jfif, jfif + 14);
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    put_marker(o, 0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(qt[t][kZigzag[k]]));
  }
  put_marker(o, 0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, h);
  put16(o, w);
  o.push_back(static_cast<uint8_t>(nc));
  for (int i = 0; i < nc; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>((comps[i].h << 4) | comps[i].v));
    o.push_back(static_cast<uint8_t>(comps[i].tq));
  }
  auto dht = [&](int tc, int th, const uint8_t* bits, const uint8_t* vals) {
    int nv = 0;
    for (int i = 0; i < 16; ++i) nv += bits[i];
    put_marker(o, 0xC4);
    put16(o, 2 + 17 + nv);
    o.push_back(static_cast<uint8_t>((tc << 4) | th));
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + nv);
  };
  dht(0, 0, kDcLumaBits, kDcVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0, 1, kDcChromaBits, kDcVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  put_marker(o, 0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(static_cast<uint8_t>(nc));
  for (int i = 0; i < nc; ++i) {
    o.push_back(static_cast<uint8_t>(i + 1));
    o.push_back(static_cast<uint8_t>(i == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  static const HuffCodes hdc[2] = {HuffCodes(kDcLumaBits, kDcVals), HuffCodes(kDcChromaBits, kDcVals)};
  static const HuffCodes hac[2] = {HuffCodes(kAcLumaBits, kAcLumaVals),
                                   HuffCodes(kAcChromaBits, kAcChromaVals)};
  BitWriter bw(o);
  auto nbits = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    return n;
  };
  int last_dc[3] = {0, 0, 0};
  int32_t ws[64];
  int coef[64];
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx)
      for (int i = 0; i < nc; ++i) {
        EncComponent& e = comps[i];
        int prev_block_dc = 0;
        int row_last_dc = 0;
        for (int by = 0; by < e.v; ++by) {
          int row = my * e.v + by;
          const bool real_row = row < ((i == 0 ? h : (h + 1) / 2) + 7) / 8;
          for (int bx = 0; bx < e.h; ++bx) {
            int col = mx * e.h + bx;
            if (real_row && col < e.bw) {
              for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                  ws[8 * y + x] =
                      static_cast<int32_t>(e.plane[static_cast<size_t>(row * 8 + y) * e.pw + col * 8 + x]) - 128;
              fdct_islow(ws);
              for (int k = 0; k < 64; ++k) coef[k] = quantize(ws[k], div[e.tq][k]);
            } else {
              std::memset(coef, 0, sizeof(coef));
              // Dummy block: DC of the block before it (right edge: its left
              // neighbour; bottom rows: the last block of the row above).
              coef[0] = real_row ? prev_block_dc : row_last_dc;
            }
            prev_block_dc = coef[0];
            // Huffman-code the block
            int diff = coef[0] - last_dc[i];
            last_dc[i] = coef[0];
            int s = nbits(diff);
            const HuffCodes& dct = hdc[e.tdc];
            bw.put(dct.code[s], dct.size[s]);
            if (s) bw.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), s);
            const HuffCodes& act = hac[e.tac];
            int run = 0;
            for (int k = 1; k < 64; ++k) {
              int v = coef[kZigzag[k]];
              if (v == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                bw.put(act.code[0xF0], act.size[0xF0]);
                run -= 16;
              }
              int sz = nbits(v);
              int sym = (run << 4) | sz;
              bw.put(act.code[sym], act.size[sym]);
              bw.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), sz);
              run = 0;
            }
            if (run > 0) bw.put(act.code[0], act.size[0]);
          }
          row_last_dc = prev_block_dc;
        }
      }
  bw.flush();
  put_marker(o, 0xD9);
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(o.size()));
  if (!buf) return nullptr;
  std::memcpy(buf, o.data(), o.size());
  *outlen = static_cast<long long>(o.size());
  return buf;
}

void jpeg_free(uint8_t* buf) { std::free(buf); }

}  // extern "C"
