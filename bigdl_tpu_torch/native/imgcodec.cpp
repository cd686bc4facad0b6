// Host image codec of the port: sequential Huffman JPEG, PNG unfiltering
// and Pillow's bilinear resampling, written to give the pixels that
// libjpeg-turbo (through Pillow) and Pillow's ImagingResample give.
//
// JPEG follows libjpeg-turbo's decoder defaults: the integer "islow" IDCT
// (jidctint.c), fancy upsampling (jdsample.c: h2v1, h1v2, h2v2 with edge
// replication at the component's real size), and the fixed-point
// YCbCr->RGB tables (jdcolor.c). The resampler follows Pillow's
// Resample.c: the bilinear support scaled by the factor when reducing,
// coefficients normalised in double and put in 22-bit fixed point, a
// horizontal pass written as rounded uint8 before the vertical pass, and
// a pass skipped when its size does not change. Build with
// -ffp-contract=off so that the double arithmetic rounds as Pillow's does.
//
// Every entry point is a plain C function (ctypes releases the GIL for
// the call). Errors: 0 ok, 1 unsupported (the message names what), 2
// corrupt or truncated data, 3 bad arguments.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum { OK = 0, UNSUPPORTED = 1, CORRUPT = 2, BADARG = 3 };

struct Err {
  int code = OK;
  char msg[200] = {0};
  int set(int c, const char* m) {
    if (code == OK) {
      code = c;
      snprintf(msg, sizeof msg, "%s", m);
    }
    return c;
  }
};

void copy_err(const Err& e, char* out, int len) {
  if (out && len > 0) snprintf(out, len, "%s", e.msg);
}

// ------------------------------------------------------------------ JPEG

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  // 9-bit lookahead: (length << 8) | value, 0 when longer than 9 bits
  uint16_t look[512];

  // false for a table whose codes do not fit their lengths (the all-ones
  // code included), which jdhuff.c's jpeg_make_d_derived_tbl rejects too;
  // the lookahead fill below relies on every code fitting its length
  bool build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      if (code >= (1 << l)) return false;
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    memset(look, 0, sizeof look);
    code = 0;
    k = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 0; i < bits[l]; i++, k++) {
        int c = code++ << (9 - l);
        for (int j = 0; j < (1 << (9 - l)); j++)
          look[c + j] = (uint16_t)((l << 8) | vals[k]);
      }
      code <<= 1;
    }
    return true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // table selectors of the current scan
  int bw = 0, bh = 0;        // blocks across and down, MCU-padded
  int dw = 0, dh = 0;        // downsampled (real) size in samples
  int pred = 0;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
};

struct Jpeg {
  const uint8_t* p;
  size_t n, pos = 0;
  Err err;
  int width = 0, height = 0, ncomp = 0;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[3];

  // entropy bit reader
  uint64_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Jpeg(const uint8_t* d, size_t len) : p(d), n(len) {}

  int u8() {
    if (pos >= n) { err.set(CORRUPT, "JPEG truncated"); return 0; }
    return p[pos++];
  }
  int u16() { int a = u8(); return (a << 8) | u8(); }

  void fill() {
    while (bitcnt <= 56) {
      int b = 0;
      if (!hit_marker && pos < n) {
        b = p[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? p[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else if (nx == 0xFF) {
            pos += 1;       // fill byte before a marker
            continue;
          } else {
            hit_marker = true;   // a marker: feed zeros, as libjpeg does
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bitbuf |= (uint64_t)b << (56 - bitcnt);
      bitcnt += 8;
    }
  }
  inline int getbits(int k) {
    if (k == 0) return 0;
    if (bitcnt < k) fill();
    int v = (int)(bitbuf >> (64 - k));
    bitbuf <<= k;
    bitcnt -= k;
    return v;
  }
  inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  inline int decode(const Huff& h) {
    if (bitcnt < 16) fill();
    int peek = (int)(bitbuf >> (64 - 9));
    int e = h.look[peek];
    if (e) {
      int l = e >> 8;
      bitbuf <<= l;
      bitcnt -= l;
      return e & 0xFF;
    }
    int code = 0, l = 0;
    for (l = 1; l <= 16; l++) {
      code = (code << 1) | (int)(bitbuf >> 63);
      bitbuf <<= 1;
      bitcnt--;
      if (code <= h.maxcode[l]) break;
    }
    if (l > 16) { err.set(CORRUPT, "JPEG bad Huffman code"); return 0; }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  void reset_entropy() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }

  // Align to the next marker and expect RSTn; then clear the predictors.
  void read_restart() {
    reset_entropy();
    while (pos + 1 < n && !(p[pos] == 0xFF && p[pos + 1] >= 0xD0 &&
                            p[pos + 1] <= 0xD7)) {
      if (p[pos] == 0xFF && p[pos + 1] != 0 && p[pos + 1] != 0xFF) break;
      pos++;
    }
    if (pos + 1 < n && p[pos] == 0xFF && p[pos + 1] >= 0xD0 &&
        p[pos + 1] <= 0xD7)
      pos += 2;
    for (int c = 0; c < ncomp; c++) comp[c].pred = 0;
  }

  int read_tables(int marker) {
    int len = u16() - 2;
    size_t end = pos + len;
    if (len < 0 || end > n) return err.set(CORRUPT, "JPEG truncated segment");
    if (marker == 0xDB) {
      while (pos < end) {
        int pq = u8(), tq = pq & 15;
        if (tq > 3) return err.set(CORRUPT, "JPEG bad quant table id");
        for (int i = 0; i < 64; i++)
          qt[tq][kNatural[i]] = (uint16_t)((pq >> 4) ? u16() : u8());
        qt_defined[tq] = true;
      }
    } else if (marker == 0xC4) {
      while (pos < end) {
        int tc = u8(), th = tc & 15;
        tc >>= 4;
        if (th > 3 || tc > 1) return err.set(CORRUPT, "JPEG bad Huffman id");
        Huff& h = tc ? ac[th] : dc[th];
        int total = 0;
        h.bits[0] = 0;
        for (int l = 1; l <= 16; l++) { h.bits[l] = (uint8_t)u8(); total += h.bits[l]; }
        if (total > 256) return err.set(CORRUPT, "JPEG bad Huffman table");
        for (int i = 0; i < total; i++) {
          h.vals[i] = (uint8_t)u8();
          // a DC symbol is a bit count, at most 15 (as jdhuff.c checks)
          if (!tc && h.vals[i] > 15)
            return err.set(CORRUPT, "JPEG bad DC Huffman symbol");
        }
        if (err.code) return err.code;
        h.defined = false;
        if (!h.build()) return err.set(CORRUPT, "JPEG bad Huffman table");
        h.defined = true;
      }
    } else if (marker == 0xDD) {
      restart = u16();
    } else if (marker == 0xE0) {
      if (len >= 5 && memcmp(p + pos, "JFIF\0", 5) == 0) jfif = true;
    } else if (marker == 0xEE) {
      if (len >= 12 && memcmp(p + pos, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = p[pos + 11];
      }
    }
    pos = end;
    return err.code;
  }

  int read_frame(int marker) {
    int len = u16();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (err.code) return err.code;
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      return err.set(UNSUPPORTED, "progressive JPEG (SOF2) is not supported");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      return err.set(UNSUPPORTED, "lossless JPEG (SOF3) is not supported");
    if (marker == 0xC5)
      return err.set(UNSUPPORTED, "hierarchical JPEG (SOF5) is not supported");
    if (marker >= 0xC9)
      return err.set(UNSUPPORTED,
                     "arithmetic-coded JPEG is not supported");
    if (precision != 8)
      return err.set(UNSUPPORTED, "12-bit JPEG is not supported");
    if (ncomp == 4)
      return err.set(UNSUPPORTED, "CMYK/YCCK JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      return err.set(UNSUPPORTED, "JPEG with 2 components is not supported");
    if (height == 0)
      return err.set(UNSUPPORTED, "JPEG with a DNL height is not supported");
    if (width == 0 || len != 8 + 3 * ncomp)
      return err.set(CORRUPT, "JPEG bad frame header");
    for (int i = 0; i < ncomp; i++) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
          comp[i].tq > 3)
        return err.set(CORRUPT, "JPEG bad component");
    }
    if (ncomp == 1) comp[0].h = comp[0].v = 1;
    maxh = maxv = 1;
    for (int i = 0; i < ncomp; i++) {
      if (comp[i].h > maxh) maxh = comp[i].h;
      if (comp[i].v > maxv) maxv = comp[i].v;
    }
    for (int i = 0; i < ncomp; i++) {
      int rh = maxh / comp[i].h, rv = maxv / comp[i].v;
      if (maxh % comp[i].h || maxv % comp[i].v || rh > 2 || rv > 2)
        return err.set(UNSUPPORTED,
                       "JPEG sampling factors beyond 2x2 are not supported");
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long long)width * c.h + maxh - 1) / maxh);
      c.dh = (int)(((long long)height * c.v + maxv - 1) / maxv);
      c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    }
    frame = true;
    return err.code;
  }

  // jidctint.c: jpeg_idct_islow, with the same range-limit table
  void idct_block(const int16_t* coef, const uint16_t* q, uint8_t* out,
                  int stride, const uint8_t* range_limit) {
    const int CONST_BITS = 13, PASS1_BITS = 2;
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                  F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                  F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* in = coef + col;
      const uint16_t* qp = q + col;
      int* w = ws + col;
      if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
          in[40] == 0 && in[48] == 0 && in[56] == 0) {
        int dc = (int)((int64_t)in[0] * qp[0] * (1 << PASS1_BITS));
        for (int r = 0; r < 8; r++) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)in[16] * qp[16], z3 = (int64_t)in[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      z2 = (int64_t)in[0] * qp[0];
      z3 = (int64_t)in[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)in[56] * qp[56];
      tmp1 = (int64_t)in[40] * qp[40];
      tmp2 = (int64_t)in[24] * qp[24];
      tmp3 = (int64_t)in[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS - PASS1_BITS;
      w[0] = (int)DESCALE(tmp10 + tmp3, sh);
      w[56] = (int)DESCALE(tmp10 - tmp3, sh);
      w[8] = (int)DESCALE(tmp11 + tmp2, sh);
      w[48] = (int)DESCALE(tmp11 - tmp2, sh);
      w[16] = (int)DESCALE(tmp12 + tmp1, sh);
      w[40] = (int)DESCALE(tmp12 - tmp1, sh);
      w[24] = (int)DESCALE(tmp13 + tmp0, sh);
      w[32] = (int)DESCALE(tmp13 - tmp0, sh);
    }
    const int MASK = 1023;
    for (int row = 0; row < 8; row++) {
      const int* w = ws + 8 * row;
      uint8_t* o = out + (size_t)row * stride;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
          w[6] == 0 && w[7] == 0) {
        uint8_t dc = range_limit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & MASK];
        for (int i = 0; i < 8; i++) o[i] = dc;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * ((int64_t)1 << CONST_BITS);
      int64_t tmp1 = ((int64_t)w[0] - w[4]) * ((int64_t)1 << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CONST_BITS + PASS1_BITS + 3;
      o[0] = range_limit[(int)DESCALE(tmp10 + tmp3, sh) & MASK];
      o[7] = range_limit[(int)DESCALE(tmp10 - tmp3, sh) & MASK];
      o[1] = range_limit[(int)DESCALE(tmp11 + tmp2, sh) & MASK];
      o[6] = range_limit[(int)DESCALE(tmp11 - tmp2, sh) & MASK];
      o[2] = range_limit[(int)DESCALE(tmp12 + tmp1, sh) & MASK];
      o[5] = range_limit[(int)DESCALE(tmp12 - tmp1, sh) & MASK];
      o[3] = range_limit[(int)DESCALE(tmp13 + tmp0, sh) & MASK];
      o[4] = range_limit[(int)DESCALE(tmp13 - tmp0, sh) & MASK];
    }
#undef DESCALE
  }

  int decode_block(Component& c, int16_t* blk) {
    memset(blk, 0, 64 * sizeof(int16_t));
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int s = decode(hd);
    int diff = s ? extend(getbits(s), s) : 0;
    // a damaged file's DC sum may leave int: wrap as libjpeg's does, without
    // signed overflow
    c.pred = (int)((uint32_t)c.pred + (uint32_t)diff);
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(getbits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return err.code;
  }

  int read_scan(const uint8_t* range_limit) {
    if (!frame) return err.set(CORRUPT, "JPEG scan before frame");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns)
      return err.set(CORRUPT, "JPEG bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int cid = u8(), t = u8();
      Component* found = nullptr;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == cid) found = &comp[c];
      if (!found) return err.set(CORRUPT, "JPEG scan names no component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        return err.set(CORRUPT, "JPEG scan uses an undefined Huffman table");
      if (!qt_defined[found->tq])
        return err.set(CORRUPT, "JPEG component uses an undefined quant table");
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0)
      return err.set(UNSUPPORTED, "progressive JPEG scans are not supported");
    if (err.code) return err.code;
    for (int c = 0; c < ncomp; c++) comp[c].pred = 0;
    reset_entropy();
    alignas(16) int16_t blk[64];
    int counted = 0;
    if (ns == 1) {
      Component& c = *sc[0];
      int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      int stride = c.bw * 8;
      for (int y = 0; y < by; y++) {
        for (int x = 0; x < bx; x++) {
          if (restart && counted == restart) {
            read_restart();
            counted = 0;
          }
          if (decode_block(c, blk)) return err.code;
          idct_block(blk, qt[c.tq], &c.plane[(size_t)y * 8 * stride + x * 8],
                     stride, range_limit);
          counted++;
        }
      }
    } else {
      for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
          if (restart && counted == restart) {
            read_restart();
            counted = 0;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            int stride = c.bw * 8;
            for (int v = 0; v < c.v; v++) {
              for (int h = 0; h < c.h; h++) {
                if (decode_block(c, blk)) return err.code;
                int bx = mx * c.h + h, by = my * c.v + v;
                idct_block(blk, qt[c.tq],
                           &c.plane[(size_t)by * 8 * stride + bx * 8], stride,
                           range_limit);
              }
            }
          }
          counted++;
        }
      }
    }
    // skip to the next marker
    reset_entropy();
    while (pos + 1 < n) {
      if (p[pos] == 0xFF && p[pos + 1] != 0 &&
          !(p[pos + 1] >= 0xD0 && p[pos + 1] <= 0xD7) && p[pos + 1] != 0xFF)
        break;
      pos++;
    }
    return err.code;
  }

  int parse(bool header_only, const uint8_t* range_limit) {
    if (n < 4 || p[0] != 0xFF || p[1] != 0xD8)
      return err.set(CORRUPT, "not a JPEG file");
    pos = 2;
    bool scanned = false;
    while (pos < n) {
      int b = u8();
      if (b != 0xFF) continue;
      int m = u8();
      while (m == 0xFF) m = u8();
      if (err.code) break;
      if (m == 0xD9) break;            // EOI
      if (m == 0x00 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (frame) return err.set(UNSUPPORTED, "JPEG with several frames");
        if (read_frame(m)) return err.code;
        if (header_only) return OK;
      } else if (m == 0xCC) {
        return err.set(UNSUPPORTED, "arithmetic-coded JPEG is not supported");
      } else if (m == 0xDA) {
        if (read_scan(range_limit)) return err.code;
        scanned = true;
      } else if (m == 0xDC) {
        return err.set(UNSUPPORTED, "JPEG with a DNL height is not supported");
      } else {
        if (read_tables(m)) return err.code;
      }
    }
    if (err.code) return err.code;
    if (!frame) return err.set(CORRUPT, "JPEG without a frame header");
    if (!scanned) return err.set(CORRUPT, "JPEG without image data");
    return OK;
  }
};

// libjpeg's sample_range_limit; returns the IDCT's table
// (sample_range_limit + CENTERJSAMPLE).
struct RangeLimit {
  uint8_t table[5 * 256 + 128];
  RangeLimit() {
    uint8_t* t = table + 256;
    memset(table, 0, 256);
    for (int i = 0; i <= 255; i++) t[i] = (uint8_t)i;
    t += 128;
    for (int i = 128; i < 512; i++) t[i] = 255;
    memset(t + 512, 0, 512 - 128);
    memcpy(t + 1024 - 128, table + 256, 128);
  }
  const uint8_t* idct() const { return table + 256 + 128; }
};

const RangeLimit& range_limit() {
  static RangeLimit r;
  return r;
}

// jdsample.c's fancy upsamplers for one component, into a full-size plane
// (width W, height H). `in` has `stride` columns; rows [0, dh) are real.
void upsample(const Component& c, int maxh, int maxv, int W, int H,
              uint8_t* out) {
  const uint8_t* in = c.plane.data();
  const int stride = c.bw * 8;
  const int rh = maxh / c.h, rv = maxv / c.v;
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) {
    if (r < 0) r = 0;
    if (r > dh - 1) r = dh - 1;
    return in + (size_t)r * stride;
  };
  std::vector<uint8_t> line(2 * (size_t)dw + 2);
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + (size_t)y * W;
    if (rh == 1 && rv == 1) {
      memcpy(o, in + (size_t)y * stride, W);
    } else if (rh == 2 && rv == 1) {
      const uint8_t* ip = in + (size_t)y * stride;
      uint8_t* lp = line.data();
      if (dw > 2) {
        int iv = ip[0];
        lp[0] = (uint8_t)iv;
        lp[1] = (uint8_t)((iv * 3 + ip[1] + 2) >> 2);
        int k = 2;
        for (int x = 1; x < dw - 1; x++) {
          iv = ip[x] * 3;
          lp[k++] = (uint8_t)((iv + ip[x - 1] + 1) >> 2);
          lp[k++] = (uint8_t)((iv + ip[x + 1] + 2) >> 2);
        }
        iv = ip[dw - 1];
        lp[k++] = (uint8_t)((iv * 3 + ip[dw - 2] + 1) >> 2);
        lp[k++] = (uint8_t)iv;
      } else {
        for (int x = 0; x < dw; x++) lp[2 * x] = lp[2 * x + 1] = ip[x];
      }
      memcpy(o, lp, W);
    } else if (rh == 1 && rv == 2) {
      int r = y >> 1;
      const uint8_t* i0 = row(r);
      const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++)
        o[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
    } else {  // rh == 2 && rv == 2
      int r = y >> 1;
      if (dw > 2) {
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = (y & 1) ? row(r + 1) : row(r - 1);
        uint8_t* lp = line.data();
        int k = 0;
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        lp[k++] = (uint8_t)((thiscol * 4 + 8) >> 4);
        lp[k++] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 2; x < dw; x++) {
          nextcol = i0[x] * 3 + i1[x];
          lp[k++] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          lp[k++] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        lp[k++] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        lp[k++] = (uint8_t)((thiscol * 4 + 7) >> 4);
        memcpy(o, lp, W);
      } else {
        const uint8_t* ip = in + (size_t)r * stride;
        for (int x = 0; x < W; x++) o[x] = ip[x >> 1];
      }
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};

const ColorTables& color_tables() {
  static ColorTables t;
  return t;
}

int jpeg_decode_impl(Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  if (j.ncomp == 1) {
    const Component& c = j.comp[0];
    const int stride = c.bw * 8;
    for (int y = 0; y < H; y++) {
      const uint8_t* ip = c.plane.data() + (size_t)y * stride;
      uint8_t* o = out + (size_t)y * W * 3;
      for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = ip[x];
    }
    return OK;
  }
  std::vector<uint8_t> planes((size_t)3 * W * H);
  for (int c = 0; c < 3; c++)
    upsample(j.comp[c], j.maxh, j.maxv, W, H, planes.data() + (size_t)c * W * H);
  const uint8_t* p0 = planes.data();
  const uint8_t* p1 = p0 + (size_t)W * H;
  const uint8_t* p2 = p1 + (size_t)W * H;
  bool rgb;
  if (j.jfif) rgb = false;
  else if (j.adobe) rgb = j.adobe_transform == 0;
  else rgb = j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66;
  const size_t npx = (size_t)W * H;
  if (rgb) {
    for (size_t i = 0; i < npx; i++) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return OK;
  }
  const ColorTables& t = color_tables();
  const uint8_t* lim = range_limit().table + 256;  // sample_range_limit
  for (size_t i = 0; i < npx; i++) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = lim[y + t.cr_r[cr]];
    out[3 * i + 1] = lim[y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
    out[3 * i + 2] = lim[y + t.cb_b[cb]];
  }
  return OK;
}

// ------------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ------------------------------------------------------------- Resample

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // (xmin, xmax) per output
  std::vector<int32_t> kk;   // ksize per output, 22-bit fixed point
};

const int PRECISION_BITS = 32 - 8 - 2;

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Resample.c: precompute_coeffs + normalize_coeffs_8bpc, box (0, inSize)
Coeffs precompute(int inSize, int outSize) {
  Coeffs c;
  const float in0 = 0.0f, in1 = (float)inSize;
  const double support_1 = 1.0;   // bilinear
  double filterscale, scale;
  filterscale = scale = (double)(in1 - in0) / outSize;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = support_1 * filterscale;
  int ksize = (int)ceil(support) * 2 + 1;
  std::vector<double> kk((size_t)outSize * ksize);
  c.bounds.resize((size_t)outSize * 2);
  for (int xx = 0; xx < outSize; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > inSize) xmax = inSize;
    xmax -= xmin;
    double* k = &kk[(size_t)xx * ksize];
    int x;
    for (x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (; x < ksize; x++) k[x] = 0;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  c.ksize = ksize;
  c.kk.resize(kk.size());
  for (size_t i = 0; i < kk.size(); i++) {
    if (kk[i] < 0)
      c.kk[i] = (int32_t)(-0.5 + kk[i] * (1 << PRECISION_BITS));
    else
      c.kk[i] = (int32_t)(0.5 + kk[i] * (1 << PRECISION_BITS));
  }
  return c;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

}  // namespace

extern "C" {

// Header: size and component count; 0 ok, else an error code and message.
int bdl_jpeg_info(const uint8_t* data, int64_t n, int32_t* h, int32_t* w,
                  int32_t* comps, char* err, int errlen) {
  Jpeg j(data, (size_t)n);
  int rc = j.parse(true, range_limit().idct());
  if (rc == OK && !j.frame) rc = j.err.set(CORRUPT, "JPEG without a frame header");
  copy_err(j.err, err, errlen);
  *h = j.height;
  *w = j.width;
  *comps = j.ncomp;
  return rc;
}

// Decode into out (h, w, 3) uint8 RGB; h and w must be bdl_jpeg_info's.
int bdl_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t h,
                    int32_t w, char* err, int errlen) {
  Jpeg j(data, (size_t)n);
  int rc = j.parse(false, range_limit().idct());
  if (rc == OK && (j.height != h || j.width != w))
    rc = j.err.set(BADARG, "JPEG size differs from the header's");
  if (rc == OK) rc = jpeg_decode_impl(j, out);
  copy_err(j.err, err, errlen);
  return rc;
}

// Unfilter the inflated PNG stream `raw` and expand it to (h, w, 3) RGB.
// color: PNG colour type 0, 2, 3, 4 or 6; depth 1, 2, 4 (types 0 and 3)
// or 8. palette: 3 * npal bytes.
int bdl_png_unfilter(const uint8_t* raw, int64_t rawlen, uint8_t* out,
                     int32_t h, int32_t w, int32_t depth, int32_t color,
                     const uint8_t* palette, int32_t npal, char* err,
                     int errlen) {
  Err e;
  int chans;
  switch (color) {
    case 0: chans = 1; break;
    case 2: chans = 3; break;
    case 3: chans = 1; break;
    case 4: chans = 2; break;
    case 6: chans = 4; break;
    default: e.set(BADARG, "PNG colour type"); copy_err(e, err, errlen); return e.code;
  }
  const int bpp_bits = chans * depth;
  const int64_t rowbytes = ((int64_t)w * bpp_bits + 7) / 8;
  const int bpp = (bpp_bits + 7) / 8;
  if (rawlen < (rowbytes + 1) * h) {
    e.set(CORRUPT, "PNG image data is truncated");
    copy_err(e, err, errlen);
    return e.code;
  }
  std::vector<uint8_t> prev(rowbytes, 0), cur(rowbytes);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = raw + (size_t)y * (rowbytes + 1);
    int ft = src[0];
    src++;
    switch (ft) {
      case 0:
        memcpy(cur.data(), src, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++) cur[i] = (uint8_t)(src[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(src[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + paeth(a, prev[i], c));
        }
        break;
      default:
        e.set(CORRUPT, "PNG bad filter type");
        copy_err(e, err, errlen);
        return e.code;
    }
    uint8_t* o = out + (size_t)y * w * 3;
    if (depth == 8) {
      for (int x = 0; x < w; x++) {
        const uint8_t* px = cur.data() + (size_t)x * chans;
        if (color == 0 || color == 4) {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = px[0];
        } else if (color == 3) {
          int i = px[0];
          if (i < npal) {
            o[3 * x] = palette[3 * i];
            o[3 * x + 1] = palette[3 * i + 1];
            o[3 * x + 2] = palette[3 * i + 2];
          } else {
            o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = 0;
          }
        } else {
          o[3 * x] = px[0];
          o[3 * x + 1] = px[1];
          o[3 * x + 2] = px[2];
        }
      }
    } else {
      const int mask = (1 << depth) - 1;
      const int scale = color == 0 ? 255 / mask : 0;
      for (int x = 0; x < w; x++) {
        int64_t bit = (int64_t)x * depth;
        int v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
        if (color == 0) {
          uint8_t g = (uint8_t)(v * scale);
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g;
        } else if (v < npal) {
          o[3 * x] = palette[3 * v];
          o[3 * x + 1] = palette[3 * v + 1];
          o[3 * x + 2] = palette[3 * v + 2];
        } else {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = 0;
        }
      }
    }
    std::swap(prev, cur);
  }
  return OK;
}

// Pillow's bilinear ImagingResample on (h, w, c) uint8 into (oh, ow, c).
int bdl_resize_bilinear(const uint8_t* in, int32_t h, int32_t w, int32_t c,
                        uint8_t* out, int32_t oh, int32_t ow) {
  if (h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return BADARG;
  const bool need_h = ow != w, need_v = oh != h;
  Coeffs ch = precompute(w, ow), cv = precompute(h, oh);
  const int ybox_first = cv.bounds[0];
  const int ybox_last = cv.bounds[oh * 2 - 2] + cv.bounds[oh * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = w, row0 = 0;
  if (need_h) {
    const int th = need_v ? ybox_last - ybox_first : h;
    const int first = need_v ? ybox_first : 0;
    uint8_t* dst = need_v ? nullptr : out;
    if (need_v) {
      tmp.resize((size_t)th * ow * c);
      dst = tmp.data();
    }
    for (int yy = 0; yy < th; yy++) {
      const uint8_t* ip = in + (size_t)(yy + first) * w * c;
      uint8_t* op = dst + (size_t)yy * ow * c;
      for (int xx = 0; xx < ow; xx++) {
        const int xmin = ch.bounds[xx * 2], xmax = ch.bounds[xx * 2 + 1];
        const int32_t* k = &ch.kk[(size_t)xx * ch.ksize];
        for (int ci = 0; ci < c; ci++) {
          int32_t ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; x++) ss += ip[(size_t)(x + xmin) * c + ci] * k[x];
          op[(size_t)xx * c + ci] = clip8(ss);
        }
      }
    }
    if (!need_v) return OK;
    src = tmp.data();
    src_w = ow;
    row0 = ybox_first;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; yy++) {
      const int ymin = cv.bounds[yy * 2] - row0, ymax = cv.bounds[yy * 2 + 1];
      const int32_t* k = &cv.kk[(size_t)yy * cv.ksize];
      uint8_t* op = out + (size_t)yy * src_w * c;
      for (int xx = 0; xx < src_w * c; xx++) {
        int32_t ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++)
          ss += src[(size_t)(y + ymin) * src_w * c + xx] * k[y];
        op[xx] = clip8(ss);
      }
    }
    return OK;
  }
  memcpy(out, in, (size_t)h * w * c);
  return OK;
}

}  // extern "C"
