// Image decoder of the port's host library, with a plain C ABI (bound with
// ctypes in multi_modal_tracking_torch/native/__init__.py).
//
// JPEG to RGB uint8: what libjpeg-turbo computes with out_color_space =
// JCS_RGB and every other setting at its default, bit for bit
// (tests/test_torch_port_image_decode.py holds it against libjpeg-turbo and
// cv2):
//   * baseline and extended sequential Huffman (SOF0, SOF1) and progressive
//     Huffman (SOF2), 8-bit, with restart intervals;
//   * the accurate integer inverse DCT (jidctint.c jpeg_idct_islow) and its
//     post-IDCT range limit;
//   * "fancy" upsampling (jdsample.c): h2v1 and h2v2 by the triangle filter
//     where the component's downsampled width exceeds 2, else by
//     replication; h1v2 by the triangle filter; any other integral factor by
//     replication. Edges replicate the nearest sample, rows and columns.
//     The merged upsampler is used only with fancy upsampling off, so never;
//   * the fixed-point YCbCr->RGB tables of jdcolor.c; greyscale replicated
//     to three channels; 3-component RGB files (Adobe transform 0, or
//     component ids 'R','G','B') copied.
// A progressive file whose scans leave one of the first ten coefficients
// incomplete would be block-smoothed by libjpeg-turbo (jdcoefct.c
// smoothing_ok); such a file raises. So do arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, 2- and 4-component (CMYK/YCCK)
// files, fractional sampling factors, DNL heights and corrupt data: the
// message names the marker or the reason.
//
// PNG: the caller inflates the IDAT stream (Python's zlib); this file
// unfilters the scanlines (None, Sub, Up, Average, Paeth) and expands them:
// colour types 0, 2, 3, 4 and 6 at 8 bits and type 0 at 16 bits, to RGB
// uint8 as cv2.imread(IMREAD_COLOR) reads them (alpha dropped, 16 bits cut
// to their high byte, a palette looked up), or a grey image unchanged (the
// 16-bit depth maps).
//
// Nothing here touches Python objects, so each call runs with the
// interpreter lock released; mmt_decode_jpeg_batch decodes files on C++
// threads.
#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// jutils.c jpeg_natural_order: zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const char* marker_name(int m) {
  switch (m) {
    case 0xC3: return "SOF3 (lossless Huffman)";
    case 0xC5: return "SOF5 (differential sequential Huffman, hierarchical)";
    case 0xC6: return "SOF6 (differential progressive Huffman, hierarchical)";
    case 0xC7: return "SOF7 (differential lossless Huffman, hierarchical)";
    case 0xC9: return "SOF9 (extended sequential, arithmetic coding)";
    case 0xCA: return "SOF10 (progressive, arithmetic coding)";
    case 0xCB: return "SOF11 (lossless, arithmetic coding)";
    case 0xCC: return "DAC (arithmetic coding conditioning)";
    case 0xCD: return "SOF13 (differential sequential, arithmetic coding)";
    case 0xCE: return "SOF14 (differential progressive, arithmetic coding)";
    case 0xCF: return "SOF15 (differential lossless, arithmetic coding)";
    case 0xDC: return "DNL (height defined by a DNL marker)";
    case 0xDE: return "DHP (hierarchical progression)";
    case 0xDF: return "EXP (hierarchical expansion)";
    default: return nullptr;
  }
}

std::string hex_marker(int m) {
  char b[16];
  std::snprintf(b, sizeof b, "0xFF%02X", m);
  return b;
}

struct Huff {
  bool defined = false;
  uint8_t counts[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << 9] = {};  // (length << 8) | value of codes up to 9 bits
  // an AC code and its value bits within the 9 looked at, decoded at once:
  // (value << 8) | (run << 4) | bits used, 0 where they do not fit (or for
  // a value outside int8)
  int16_t fast_ac[1 << 9] = {};

  // jdhuff.c jpeg_make_d_derived_tbl
  void build(bool is_dc) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    const int numsymbols = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table (codes overflow their length)");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++p) {
        const int base = huffcode[p] << (9 - l);
        for (int k = 0; k < (1 << (9 - l)); ++k)
          look[base + k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < numsymbols; ++i)
        if (vals[i] > 15) fail("bad Huffman table (a DC symbol above 15)");
    for (int i = 0; i < (1 << 9); ++i) {
      fast_ac[i] = 0;
      if (!look[i]) continue;
      const int len = look[i] >> 8, rs = look[i] & 0xFF;
      const int run = rs >> 4, size = rs & 15;
      if (!size || len + size > 9) continue;
      int v = ((i << len) & 511) >> (9 - size);
      if (v < (1 << (size - 1))) v -= (1 << size) - 1;
      if (v >= -128 && v <= 127) fast_ac[i] = static_cast<int16_t>(v * 256 + run * 16 + len + size);
    }
    defined = true;
  }
};

// Entropy-coded segment reader: byte stuffing undone, stops at a marker.
// Past a marker (or the end of the data) it feeds zero bits, as libjpeg
// does, but a decode that consumes one raises: the data ended early.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int cnt = 0;   // valid bits at the top of buf
  int fake = 0;  // how many of them were fed past the segment's end
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    // fast path: the next bytes that fit hold no 0xFF (no stuffing, no
    // marker), so they enter the buffer in one load
    if (!at_marker && cnt < 16 && pos + 8 <= n) {
      const int nb = (64 - cnt) >> 3;
      uint64_t w;
      std::memcpy(&w, d + pos, 8);
      const uint64_t x = ~w;  // a 0xFF byte is a zero byte of x
      const uint64_t zero = (x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL;
      const uint64_t mask = nb >= 8 ? ~0ULL : (1ULL << (8 * nb)) - 1;
      if (!(zero & mask)) {
        const uint64_t be = __builtin_bswap64(w);  // the file's first byte on top
        buf |= (be >> (64 - 8 * nb)) << (64 - cnt - 8 * nb);
        cnt += 8 * nb;
        pos += nb;
        return;
      }
    }
    while (cnt <= 56) {
      uint32_t b = 0;
      if (at_marker || pos >= n) {
        fake += 8;
      } else if (d[pos] != 0xFF) {
        b = d[pos++];
      } else if (pos + 1 < n && d[pos + 1] == 0x00) {
        b = 0xFF;
        pos += 2;
      } else {
        at_marker = true;
        fake += 8;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }

  void consume(int k) {
    buf <<= k;
    cnt -= k;
    if (cnt < fake) fail("corrupt data: the entropy-coded segment ends early");
  }

  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    const int v = static_cast<int>(buf >> (64 - k));
    consume(k);
    return v;
  }

  int bit() { return get(1); }

  int decode(const Huff& h) {
    if (cnt < 16) fill();
    const uint16_t e = h.look[buf >> (64 - 9)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      const int32_t code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[(h.valoffset[l] + code) & 0xFF];
      }
    }
    fail("corrupt data: a Huffman code that is in no table");
  }

  // jdhuff.h HUFF_EXTEND
  static int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }

  int receive_extend(int s) {
    if (s > 15) fail("corrupt data: a coefficient of more than 15 bits");
    return extend(get(s), s);
  }

  // drop the leftover bits and return the position of the next marker
  size_t to_marker() {
    buf = 0;
    cnt = fake = 0;
    at_marker = false;
    return pos;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // blocks per row / column, padded to whole MCUs
  int wib = 0, hib = 0;  // blocks the component itself covers
  int dw = 0, dh = 0;    // its downsampled width and height in samples
  int td = 0, ta = 0;
  int pred = 0;
  bool latched = false;
  uint16_t q[64] = {};
  int coef_bits[64];
  std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
  std::vector<uint8_t> plane; // (bh * 8) x (bw * 8) samples
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0;
  int frame_type = -1;  // 0, 1 or 2 (SOF marker - 0xC0)
  bool progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int eobrun = 0;
  bool qdefined[4] = {};
  uint16_t qt[4][64] = {};
  Huff dc[4], ac[4];
  std::vector<Component> comps;

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("truncated file");
    return d[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  // next marker code; fill bytes and stray data before it are skipped
  int next_marker() {
    for (;;) {
      if (pos + 1 >= n) fail("truncated file (no EOI marker)");
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) {
        const int m = d[pos + 1];
        pos += 2;
        return m;
      }
      pos++;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad DQT marker");
      for (int k = 0; k < 64; ++k) qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qdefined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT marker");
      Huff& h = tc ? ac[th] : dc[th];
      int total = 0;
      h.counts[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.counts[l] = static_cast<uint8_t>(u8());
        total += h.counts[l];
      }
      if (total > 256) fail("bad Huffman table (more than 256 symbols)");
      for (int i = 0; i < total; ++i) h.vals[i] = static_cast<uint8_t>(u8());
      h.build(tc == 0);
    }
  }

  void read_sof(int marker, size_t end) {
    if (frame_type >= 0) fail("a second frame (SOF) marker");
    frame_type = marker - 0xC0;
    progressive = marker == 0xC2;
    const int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (only 8-bit JPEG is decoded)");
    height = u16();
    width = u16();
    const int nf = u8();
    if (height == 0) fail("height 0 (defined by a DNL marker, which is not decoded)");
    if (width == 0) fail("width 0");
    if (nf == 4) fail("4 components (CMYK or YCCK)");
    if (nf != 1 && nf != 3) fail(std::to_string(nf) + " components (only 1 or 3 are decoded)");
    comps.resize(nf);
    for (auto& c : comps) {
      c.id = u8();
      const int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
      if (c.tq > 3) fail("bad quantisation table selector");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (pos != end) fail("bad SOF marker length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("fractional sampling factors (" + std::to_string(c.h) + "x" +
             std::to_string(c.v) + " under " + std::to_string(hmax) + "x" +
             std::to_string(vmax) + ")");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
  }

  void read_app(int marker, size_t end) {
    const size_t len = end - pos;
    if (marker == 0xE0 && len >= 5 && std::memcmp(d + pos, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  // ---------------------------------------------------------- block decoders
  void block_sequential(Component& c, int16_t* blk, BitReader& br) {
    const int s = br.decode(dc[c.td]);
    c.pred += br.receive_extend(s);
    blk[0] = static_cast<int16_t>(c.pred);
    const Huff& h = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      if (br.cnt < 16) br.fill();
      const int fast = h.fast_ac[br.buf >> (64 - 9)];
      if (fast) {
        k += (fast >> 4) & 15;
        if (k > 63) fail("corrupt data: a run past the block's end");
        br.consume(fast & 15);
        blk[kNatural[k]] = static_cast<int16_t>(fast >> 8);
        continue;
      }
      const int rs = br.decode(h);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) fail("corrupt data: a run past the block's end");
        blk[kNatural[k]] = static_cast<int16_t>(br.receive_extend(sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first / DC_refine / AC_first / AC_refine
  void block_dc_first(Component& c, int16_t* blk, BitReader& br, int al) {
    const int s = br.decode(dc[c.td]);
    c.pred += br.receive_extend(s);
    blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(c.pred) << al));
  }

  void block_dc_refine(int16_t* blk, BitReader& br, int al) {
    if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void block_ac_first(Component& c, int16_t* blk, BitReader& br, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& h = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(h);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt data: a run past the block's end");
        const int v = br.receive_extend(s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        eobrun--;
        break;
      }
    }
  }

  void block_ac_refine(Component& c, int16_t* blk, BitReader& br, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const Huff& h = ac[c.ta];
      for (; k <= se; ++k) {
        const int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt data: a refinement value of more than one bit");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) {
          if (k > 63) fail("corrupt data: a run past the block's end");
          blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun--;
    }
  }

  // ------------------------------------------------------------------- scans
  void read_scan(size_t end) {
    if (frame_type < 0) fail("SOS before the frame (SOF) marker");
    const int ns = u8();
    if (ns < 1 || ns > 4) fail("bad SOS marker");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int cid = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found) fail("SOS names a component that is not in the frame");
      if (std::find(sc.begin(), sc.end(), found) != sc.end()) fail("SOS names a component twice");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) fail("bad Huffman table selector");
      sc.push_back(found);
    }
    const int ss = u8(), se = u8(), a = u8();
    const int ah = a >> 4, al = a & 15;
    if (pos != end) fail("bad SOS marker length");
    if (progressive) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
        fail("bad progressive scan (spectral selection)");
      if (al > 13 || (ah != 0 && al != ah - 1)) fail("bad progressive scan (successive approximation)");
      for (Component* c : sc) {
        for (int k = ss; k <= se; ++k) {
          const int prev = c->coef_bits[k];
          if (ss > 0 && c->coef_bits[0] < 0) fail("progressive AC scan before the DC scan");
          if (ah != (prev < 0 ? 0 : prev)) fail("bad progressive scan (Ah does not follow)");
          c->coef_bits[k] = al;
        }
      }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("bad sequential scan parameters");
    }
    int blocks_in_mcu = 0;
    for (Component* c : sc) {
      if (!qdefined[c->tq]) fail("a quantisation table is used before it is defined");
      if (!c->latched) {  // jdinput.c latch_quant_tables: at the component's first scan
        std::memcpy(c->q, qt[c->tq], sizeof c->q);
        c->latched = true;
      }
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss > 0;
      if (need_dc && !dc[c->td].defined) fail("a Huffman table is used before it is defined");
      if (need_ac && !ac[c->ta].defined) fail("a Huffman table is used before it is defined");
      c->pred = 0;
      blocks_in_mcu += c->h * c->v;
    }
    if (ns > 1 && blocks_in_mcu > 10) fail("too many blocks in an MCU");
    eobrun = 0;

    BitReader br(d, n, pos);
    const auto decode_block = [&](Component& c, int bx, int by) {
      int16_t* blk = c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
      if (!progressive) block_sequential(c, blk, br);
      else if (ss == 0 && ah == 0) block_dc_first(c, blk, br, al);
      else if (ss == 0) block_dc_refine(blk, br, al);
      else if (ah == 0) block_ac_first(c, blk, br, ss, se, al);
      else block_ac_refine(c, blk, br, ss, se, al);
    };
    int restarts_to_go = restart_interval;
    int next_rst = 0;
    const auto mcu_start = [&](bool first) {
      if (!restart_interval) return;
      if (!first && restarts_to_go == 0) {
        size_t p = br.to_marker();
        while (p + 1 < n && d[p] == 0xFF && d[p + 1] == 0xFF) p++;
        if (p + 1 >= n || d[p] != 0xFF || d[p + 1] != 0xD0 + next_rst)
          fail("corrupt data: expected restart marker RST" + std::to_string(next_rst));
        br = BitReader(d, n, p + 2);
        next_rst = (next_rst + 1) & 7;
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      restarts_to_go--;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx) {
          mcu_start(by == 0 && bx == 0);
          decode_block(c, bx, by);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          mcu_start(my == 0 && mx == 0);
          for (Component* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x) decode_block(*c, mx * c->h + x, my * c->v + y);
        }
    }
    pos = br.to_marker();
  }

  // header_only: stop after the frame (SOF) marker
  void parse(bool header_only = false) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    bool scans = false;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) fail("a restart marker outside a scan");
      if (m == 0xD8) fail("a second SOI marker");
      if (m == 0x01) continue;  // TEM: no length
      const size_t start = pos;
      const int len = u16();
      if (len < 2 || start + len > n) fail("bad length of marker " + hex_marker(m));
      const size_t end = start + len;
      if (const char* name = marker_name(m)) fail(std::string("marker ") + name + " is not decoded");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m, end);
        if (header_only) return;
      }
      else if (m == 0xC4) read_dht(end);
      else if (m == 0xDB) read_dqt(end);
      else if (m == 0xDD) restart_interval = u16();
      else if (m == 0xDA) { read_scan(end); scans = true; continue; }
      else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) read_app(m, end);
      else fail("unknown marker " + hex_marker(m));
      if (pos != end) fail("bad length of marker " + hex_marker(m));
    }
    if (frame_type < 0 || !scans) fail("no image data (no SOF or SOS marker)");
    if (progressive) check_smoothing();
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo smooths a progressive image whose
  // first ten coefficients are not all fully coded; this decoder does not
  void check_smoothing() {
    for (auto& c : comps) {
      if (c.coef_bits[0] < 0) return;
      for (int k = 0; k < 10; ++k)
        if (c.q[kNatural[k]] == 0) return;
    }
    for (auto& c : comps)
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          fail("progressive scans leave coefficients incomplete (libjpeg would smooth blocks)");
  }

  // ------------------------------------------------------------------- IDCT
  static uint8_t range_limit(int64_t x) {
    // jdmaster.c prepare_range_limit_table, read through RANGE_MASK (1023)
    int t = static_cast<int>(x & 1023);
    if (t >= 512) t -= 1024;
    return static_cast<uint8_t>(std::min(std::max(t + 128, 0), 255));
  }

  // jidctint.c jpeg_idct_islow
  // q: the dct_table, quantisation values held as short (ISLOW_MULT_TYPE)
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    constexpr int CONST_BITS = 13, PASS1_BITS = 2;
    constexpr int64_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                      F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                      F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;
    auto descale = [](int64_t x, int nb) { return (x + (int64_t{1} << (nb - 1))) >> nb; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const int16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dcval = static_cast<int>(static_cast<unsigned>(ip[0] * qp[0]) << PASS1_BITS);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = int64_t{ip[16]} * qp[16], z3 = int64_t{ip[48]} * qp[48];
      int64_t z1 = (z2 + z3) * F_0_541;
      int64_t tmp2 = z1 + z3 * -F_1_847;
      int64_t tmp3 = z1 + z2 * F_0_765;
      z2 = int64_t{ip[0]} * qp[0];
      z3 = int64_t{ip[32]} * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t{ip[56]} * qp[56];
      tmp1 = int64_t{ip[40]} * qp[40];
      tmp2 = int64_t{ip[24]} * qp[24];
      tmp3 = int64_t{ip[8]} * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F_1_175;
      tmp0 *= F_0_298;
      tmp1 *= F_2_053;
      tmp2 *= F_3_072;
      tmp3 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 *= -F_1_961;
      z4 *= -F_0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int sh = CONST_BITS - PASS1_BITS;
      wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
      wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
      wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
      wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
      wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
      wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
      wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
      wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + static_cast<size_t>(r) * stride;
      constexpr int sh = CONST_BITS + PASS1_BITS + 3;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t dcval = range_limit(descale(wp[0], PASS1_BITS + 3));
        std::memset(op, dcval, 8);
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F_0_541;
      int64_t tmp2 = z1 + z3 * -F_1_847;
      int64_t tmp3 = z1 + z2 * F_0_765;
      int64_t tmp0 = (int64_t{wp[0]} + wp[4]) * (int64_t{1} << CONST_BITS);
      int64_t tmp1 = (int64_t{wp[0]} - wp[4]) * (int64_t{1} << CONST_BITS);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F_1_175;
      tmp0 *= F_0_298;
      tmp1 *= F_2_053;
      tmp2 *= F_3_072;
      tmp3 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 *= -F_1_961;
      z4 *= -F_0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      op[0] = range_limit(descale(tmp10 + tmp3, sh));
      op[7] = range_limit(descale(tmp10 - tmp3, sh));
      op[1] = range_limit(descale(tmp11 + tmp2, sh));
      op[6] = range_limit(descale(tmp11 - tmp2, sh));
      op[2] = range_limit(descale(tmp12 + tmp1, sh));
      op[5] = range_limit(descale(tmp12 - tmp1, sh));
      op[3] = range_limit(descale(tmp13 + tmp0, sh));
      op[4] = range_limit(descale(tmp13 - tmp0, sh));
    }
  }

  void inverse_dct() {
    for (auto& c : comps) {
      int16_t q[64];
      for (int k = 0; k < 64; ++k) q[k] = static_cast<int16_t>(c.q[k]);
      const int stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(c.bh) * 8 * stride, 0);
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, q,
                     c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    }
  }

  // ------------------------------------------------------------- upsampling
  // one output row of component c at full resolution (width samples);
  // tmp and sum: scratch of at least 2 * dw + 2 samples
  void upsample_row(const Component& c, int y, uint8_t* out, uint8_t* tmp, int* sum) const {
    const int rh = hmax / c.h, rv = vmax / c.v;
    const int stride = c.bw * 8;
    auto row = [&](int r) {
      return c.plane.data() + static_cast<size_t>(std::min(std::max(r, 0), c.dh - 1)) * stride;
    };
    const bool wide = c.dw > 2;
    if (rh == 1 && rv == 1) {
      std::memcpy(out, row(y), width);
    } else if (rh == 2 && rv == 1 && wide) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      tmp[0] = in[0];
      tmp[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int j = 1; j < c.dw - 1; ++j) {
        const int v = in[j] * 3;
        tmp[2 * j] = static_cast<uint8_t>((v + in[j - 1] + 1) >> 2);
        tmp[2 * j + 1] = static_cast<uint8_t>((v + in[j + 1] + 2) >> 2);
      }
      const int j = c.dw - 1;
      tmp[2 * j] = static_cast<uint8_t>((in[j] * 3 + in[j - 1] + 1) >> 2);
      tmp[2 * j + 1] = in[j];
      std::memcpy(out, tmp, width);
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      const int r = y / 2;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(y % 2 ? r + 1 : r - 1);
      const int bias = y % 2 ? 2 : 1;
      for (int x = 0; x < width; ++x) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (rh == 2 && rv == 2 && wide) {  // h2v2_fancy_upsample
      const int r = y / 2;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(y % 2 ? r + 1 : r - 1);
      for (int j = 0; j < c.dw; ++j) sum[j] = in0[j] * 3 + in1[j];
      for (int j = 0; j < c.dw; ++j) {
        const int last = j ? sum[j - 1] : sum[j];
        const int next = j + 1 < c.dw ? sum[j + 1] : sum[j];
        tmp[2 * j] = static_cast<uint8_t>((sum[j] * 3 + last + 8) >> 4);
        tmp[2 * j + 1] = static_cast<uint8_t>((sum[j] * 3 + next + 7) >> 4);
      }
      std::memcpy(out, tmp, width);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const uint8_t* in = row(y / rv);
      for (int x = 0; x < width; ++x) out[x] = in[x / rh];
    }
  }

  void write_rgb(uint8_t* out, int pitch) const {
    const int nc = static_cast<int>(comps.size());
    bool ycc = true;
    if (nc == 3) {
      if (saw_jfif) ycc = true;
      else if (saw_adobe) ycc = adobe_transform != 0;
      else ycc = !(comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
    }
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    static const struct Tables {
      int cr_r[256], cb_b[256];
      int32_t cr_g[256], cb_g[256];
      Tables() {
        const int32_t half = 1 << 15;
        auto fix = [](double v) { return static_cast<int32_t>(v * 65536.0 + 0.5); };
        for (int i = 0; i < 256; ++i) {
          const int32_t x = i - 128;
          cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
          cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
          cr_g[i] = -fix(0.71414) * x;
          cb_g[i] = -fix(0.34414) * x + half;
        }
      }
    } T;
    auto clamp = [](int v) { return static_cast<uint8_t>(std::min(std::max(v, 0), 255)); };
    std::vector<uint8_t> rows(static_cast<size_t>(nc) * width);
    std::vector<uint8_t> tmp(2 * static_cast<size_t>(width) + 16);
    std::vector<int> sum(static_cast<size_t>(width) + 8);
    for (int y = 0; y < height; ++y) {
      for (int c = 0; c < nc; ++c)
        upsample_row(comps[c], y, rows.data() + static_cast<size_t>(c) * width, tmp.data(),
                     sum.data());
      uint8_t* o = out + static_cast<size_t>(y) * pitch;
      const uint8_t* r0 = rows.data();
      if (nc == 1) {
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
        continue;
      }
      const uint8_t* r1 = r0 + width;
      const uint8_t* r2 = r1 + width;
      if (!ycc) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + T.cr_r[cr]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((T.cb_g[cb] + T.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + T.cb_b[cb]);
      }
    }
  }
};

void copy_error(const std::string& msg, char* err, int errlen) {
  if (!err || errlen <= 0) return;
  const size_t k = std::min(msg.size(), static_cast<size_t>(errlen - 1));
  std::memcpy(err, msg.data(), k);
  err[k] = '\0';
}

// 0 ok, 1 decode error (err holds the reason), 3 larger than the buffer
int decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int cap_h, int cap_w, int* h,
                int* w, char* err, int errlen) {
  try {
    Jpeg j(data, size);
    j.parse();
    *h = j.height;
    *w = j.width;
    if (j.height > cap_h || j.width > cap_w) {
      copy_error("image of " + std::to_string(j.height) + "x" + std::to_string(j.width) +
                     " does not fit the buffer of " + std::to_string(cap_h) + "x" +
                     std::to_string(cap_w),
                 err, errlen);
      return 3;
    }
    j.inverse_dct();
    j.write_rgb(out, cap_w * 3);
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return 1;
  }
}

bool read_file(const char* path, std::vector<uint8_t>& buf, char* err, int errlen) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    copy_error(std::string("cannot open the file: ") + std::strerror(errno), err, errlen);
    return false;
  }
  buf.clear();
  uint8_t chunk[1 << 16];
  size_t k;
  while ((k = std::fread(chunk, 1, sizeof chunk, f)) > 0) buf.insert(buf.end(), chunk, chunk + k);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  if (!ok) copy_error("read error", err, errlen);
  return ok;
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// The frame size of a JPEG in memory, read from its header: 0 ok, 1 error
// (err holds the reason).
int mmt_jpeg_size(const uint8_t* data, size_t size, int* h, int* w, char* err, int errlen) {
  try {
    Jpeg j(data, size);
    j.parse(true);
    if (j.frame_type < 0) fail("no frame (SOF) marker");
    *h = j.height;
    *w = j.width;
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  }
}

// Decode a JPEG in memory into out (cap_h x cap_w x 3, rows of cap_w * 3
// bytes): 0 ok, 1 decode error, 3 larger than the buffer; (h, w) written.
int mmt_decode_jpeg(const uint8_t* data, size_t size, uint8_t* out, int cap_h, int cap_w, int* h,
                    int* w, char* err, int errlen) {
  return decode_jpeg(data, size, out, cap_h, cap_w, h, w, err, errlen);
}

// The same from a file: 2 if the file cannot be read.
int mmt_decode_jpeg_file(const char* path, uint8_t* out, int cap_h, int cap_w, int* h, int* w,
                         char* err, int errlen) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf, err, errlen)) return 2;
  return decode_jpeg(buf.data(), buf.size(), out, cap_h, cap_w, h, w, err, errlen);
}

// n files into one (n, cap_h, cap_w, 3) buffer on num_threads threads (the
// caller's included): per file its size, status and message (errlen bytes
// each in errs).
void mmt_decode_jpeg_batch(const char** paths, int n, uint8_t* out, int cap_h, int cap_w, int* hs,
                           int* ws, int* rc, char* errs, int errlen, int num_threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      rc[i] = mmt_decode_jpeg_file(paths[i], out + static_cast<size_t>(i) * cap_h * cap_w * 3,
                                   cap_h, cap_w, &hs[i], &ws[i],
                                   errs + static_cast<size_t>(i) * errlen, errlen);
    }
  };
  const int t = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t - 1);
  for (int k = 1; k < t; ++k) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

// Unfilter the inflated scanlines of a non-interlaced PNG (h rows of 1 +
// rowbytes bytes, in place) and expand them. mode 0: RGB uint8 (h, w, 3);
// mode 1: a grey image unchanged, uint8 (h, w) or uint16 (h, w) in the
// machine's byte order. palette: npal RGB triples. Returns 0, or 1 with
// the reason in err.
int mmt_png_expand(uint8_t* raw, size_t rawlen, int h, int w, int color_type, int bit_depth,
                   const uint8_t* palette, int npal, int mode, void* out, char* err, int errlen) {
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: copy_error("bad colour type " + std::to_string(color_type), err, errlen); return 1;
  }
  const int bytes = bit_depth / 8;
  const size_t bpp = static_cast<size_t>(channels) * bytes;
  const size_t rowbytes = bpp * w;
  if (rawlen < static_cast<size_t>(h) * (rowbytes + 1)) {
    copy_error("the image data is shorter than its size", err, errlen);
    return 1;
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* line = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const int filter = line[0];
    uint8_t* p = line + 1;
    switch (filter) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) p[i] = static_cast<uint8_t>(p[i] + p[i - bpp]);
        break;
      case 2:
        if (prev)
          for (size_t i = 0; i < rowbytes; ++i) p[i] = static_cast<uint8_t>(p[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? p[i - bpp] : 0, b = prev ? prev[i] : 0;
          p[i] = static_cast<uint8_t>(p[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? p[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          p[i] = static_cast<uint8_t>(p[i] + paeth(a, b, c));
        }
        break;
      default:
        copy_error("bad filter type " + std::to_string(filter) + " in row " + std::to_string(y),
                   err, errlen);
        return 1;
    }
    prev = p;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* p = raw + static_cast<size_t>(y) * (rowbytes + 1) + 1;
    if (mode == 1) {
      if (bytes == 2) {
        uint16_t* o = static_cast<uint16_t*>(out) + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) o[x] = static_cast<uint16_t>((p[2 * x] << 8) | p[2 * x + 1]);
      } else {
        std::memcpy(static_cast<uint8_t*>(out) + static_cast<size_t>(y) * w, p, w);
      }
      continue;
    }
    uint8_t* o = static_cast<uint8_t*>(out) + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const uint8_t* s = p + x * bpp;  // the high byte of each sample first
      if (color_type == 3) {
        if (s[0] >= npal) {
          copy_error("palette index " + std::to_string(s[0]) + " past the palette's " +
                         std::to_string(npal) + " entries",
                     err, errlen);
          return 1;
        }
        std::memcpy(o + 3 * x, palette + 3 * s[0], 3);
      } else if (color_type == 0 || color_type == 4) {
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[0];
      } else {
        o[3 * x] = s[0];
        o[3 * x + 1] = s[bytes];
        o[3 * x + 2] = s[2 * bytes];
      }
    }
  }
  return 0;
}

}  // extern "C"
