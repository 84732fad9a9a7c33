// The port's native host data engine: the JAX package's C++/OpenMP loader
// (native/dataio.cpp) with its own PNG decoder, so that it builds with g++
// and OpenMP alone, without libpng's or zlib's headers.
//
// Plain C ABI, bound with ctypes by ipoke_tpu_torch/data/native.py:
//   ipoke_load_npy_flow  : .npy (<f4 or <f8, C order) -> float32 buffer
//   ipoke_load_png       : PNG -> bilinear (align_corners) resize -> RGB [-1, 1]
//   ipoke_simulate_pokes : batched poke simulation (threshold ladder,
//                          zero-poke background placement), OpenMP over the batch
//   ipoke_load_frames    : ipoke_load_png over (example, frame), OpenMP
// and, for its tests and checks:
//   ipoke_decode_png     : PNG -> (H, W, 3) uint8 RGB
//   ipoke_inflate        : a zlib stream (RFC 1950/1951) -> bytes
//
// The four ipoke_load_* / ipoke_simulate_* functions take the arguments of
// the JAX package's and return its codes; their float arithmetic is the
// JAX engine's expressions, compiled with its flags.  The decoder converts to
// RGB as the JAX engine's libpng transforms do (png_set_strip_16 keeps the
// high byte, palette and grey become RGB, grey below 8 bits is scaled to 8,
// alpha is dropped).  Where that engine's pixels are not the image's, the
// decoder refuses with a code of its own (see the codes below).
//
// Build: ipoke_tpu_torch/data/native.py::build()
//        (g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <random>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// inflate (RFC 1950 zlib wrapper around RFC 1951 deflate)
// ---------------------------------------------------------------------------

// inflate's codes; ipoke_load_png returns 10 + these
enum InflateCode {
  kInflateOk = 0,
  kBadHeader = 1,      // not a zlib header of deflate, or a preset dictionary
  kTruncated = 2,      // the input ends inside the stream
  kBadBlockType = 3,   // block type 3
  kBadStored = 4,      // a stored block's LEN and NLEN disagree
  kBadLengths = 5,     // code lengths: over-subscribed, incomplete or repeat overflow
  kBadSymbol = 6,      // a code not in the table, or a length/distance symbol out of range
  kTooFar = 7,         // a distance before the start of the output
  kBadAdler = 8,       // the Adler-32 of the output is not the stream's
  kTooLong = 9,        // the output would pass the caller's limit
};

// LSB-first bit reader; past the end it reads zeros and counts them, so a
// read into them shows as overrun()
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int pad = 0;  // zero bytes appended past the end

  Bits(const uint8_t* b, const uint8_t* e) : p(b), end(e) {}
  void refill() {
    while (cnt <= 56) {
      uint64_t byte = 0;
      if (p < end) {
        byte = *p++;
      } else {
        pad++;
      }
      buf |= byte << cnt;
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) refill();
    return (uint32_t)(buf & ((1ull << n) - 1));
  }
  void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  uint32_t get(int n) {
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
  bool overrun() const { return cnt < pad * 8; }
};

constexpr int kFastBits = 10;

// canonical Huffman code: codes per length, symbols in code order, and a
// table of the codes of up to kFastBits bits (entry = len << 9 | symbol)
struct Huff {
  int16_t count[16];
  int16_t symbol[320];
  uint16_t fast[1 << kFastBits];
};

// 0: complete; < 0: over-subscribed; > 0: incomplete (puff's convention)
int build_huff(Huff& h, const uint8_t* len, int n) {
  std::memset(h.count, 0, sizeof(h.count));
  for (int s = 0; s < n; s++) h.count[len[s]]++;
  std::memset(h.fast, 0, sizeof(h.fast));
  if (h.count[0] == n) return 0;
  int left = 1;
  for (int l = 1; l < 16; l++) {
    left <<= 1;
    left -= h.count[l];
    if (left < 0) return left;
  }
  int offs[16];
  offs[1] = 0;
  for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + h.count[l];
  for (int s = 0; s < n; s++)
    if (len[s] != 0) h.symbol[offs[len[s]]++] = (int16_t)s;
  int code = 0, k = 0;
  for (int l = 1; l < 16; l++) {
    for (int j = 0; j < h.count[l]; j++, code++) {
      int sym = h.symbol[k++];
      if (l > kFastBits) continue;
      int rev = 0;
      for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
      for (int r = rev; r < (1 << kFastBits); r += 1 << l) h.fast[r] = (uint16_t)(l << 9 | sym);
    }
    code <<= 1;
  }
  return left;
}

// the next symbol, or -1 for a code not in the table
int decode(Bits& s, const Huff& h) {
  uint16_t e = h.fast[s.peek(kFastBits)];
  if (e != 0) {
    s.drop(e >> 9);
    return e & 511;
  }
  int code = 0, first = 0, index = 0;
  for (int l = 1; l < 16; l++) {
    code |= (int)s.get(1);
    int count = h.count[l];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

// the output: grows up to limit bytes
struct Out {
  std::vector<uint8_t>& v;
  size_t pos = 0;
  size_t limit;
  Out(std::vector<uint8_t>& buf, size_t lim) : v(buf), limit(lim) {}
  bool room(size_t n) {
    if (pos + n > limit) return false;
    if (pos + n > v.size()) v.resize(std::min(limit, std::max(pos + n, 2 * v.size() + 4096)));
    return true;
  }
};

const uint16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

int codes(Bits& s, Out& o, const Huff& lit, const Huff& dist) {
  for (;;) {
    int sym = decode(s, lit);
    if (s.overrun()) return kTruncated;
    if (sym < 0) return kBadSymbol;
    if (sym < 256) {
      if (!o.room(1)) return kTooLong;
      o.v[o.pos++] = (uint8_t)sym;
    } else if (sym == 256) {
      return kInflateOk;
    } else {
      sym -= 257;
      if (sym >= 29) return kBadSymbol;
      size_t len = kLenBase[sym] + s.get(kLenExtra[sym]);
      int ds = decode(s, dist);
      if (ds < 0 || ds >= 30) return s.overrun() ? kTruncated : kBadSymbol;
      size_t d = kDistBase[ds] + s.get(kDistExtra[ds]);
      if (s.overrun()) return kTruncated;
      if (d > o.pos) return kTooFar;
      if (!o.room(len)) return kTooLong;
      uint8_t* w = o.v.data() + o.pos;
      const uint8_t* r = w - d;
      for (size_t i = 0; i < len; i++) w[i] = r[i];
      o.pos += len;
    }
  }
}

int stored(Bits& s, Out& o) {
  s.drop(s.cnt & 7);  // to the byte boundary
  uint32_t len = s.get(16), nlen = s.get(16);
  if (s.overrun()) return kTruncated;
  if (len != (~nlen & 0xffff)) return kBadStored;
  if (!o.room(len)) return kTooLong;
  for (uint32_t i = 0; i < len; i++) o.v[o.pos++] = (uint8_t)s.get(8);
  return s.overrun() ? kTruncated : kInflateOk;
}

const Huff& fixed_lit() {
  static const Huff h = [] {
    Huff t;
    uint8_t len[288];
    for (int i = 0; i < 144; i++) len[i] = 8;
    for (int i = 144; i < 256; i++) len[i] = 9;
    for (int i = 256; i < 280; i++) len[i] = 7;
    for (int i = 280; i < 288; i++) len[i] = 8;
    build_huff(t, len, 288);
    return t;
  }();
  return h;
}

const Huff& fixed_dist() {
  static const Huff h = [] {
    Huff t;
    uint8_t len[30];
    for (int i = 0; i < 30; i++) len[i] = 5;
    build_huff(t, len, 30);
    return t;
  }();
  return h;
}

int dynamic(Bits& s, Out& o) {
  int nlen = (int)s.get(5) + 257, ndist = (int)s.get(5) + 1, ncode = (int)s.get(4) + 4;
  if (nlen > 286 || ndist > 30) return kBadLengths;
  static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  uint8_t lengths[320] = {0};
  for (int i = 0; i < ncode; i++) lengths[order[i]] = (uint8_t)s.get(3);
  if (s.overrun()) return kTruncated;
  Huff lencode, lit, dist;
  if (build_huff(lencode, lengths, 19) != 0) return kBadLengths;  // a complete code
  int idx = 0;
  while (idx < nlen + ndist) {
    int sym = decode(s, lencode);
    if (s.overrun()) return kTruncated;
    if (sym < 0) return kBadLengths;
    if (sym < 16) {
      lengths[idx++] = (uint8_t)sym;
      continue;
    }
    uint8_t len = 0;
    int rep;
    if (sym == 16) {
      if (idx == 0) return kBadLengths;
      len = lengths[idx - 1];
      rep = 3 + (int)s.get(2);
    } else if (sym == 17) {
      rep = 3 + (int)s.get(3);
    } else {
      rep = 11 + (int)s.get(7);
    }
    if (idx + rep > nlen + ndist) return kBadLengths;
    while (rep--) lengths[idx++] = len;
  }
  if (lengths[256] == 0) return kBadLengths;  // no end-of-block code
  // an incomplete code only where it is one code of one bit (zlib's rule)
  int err = build_huff(lit, lengths, nlen);
  if (err < 0 || (err > 0 && nlen - lit.count[0] != 1)) return kBadLengths;
  err = build_huff(dist, lengths + nlen, ndist);
  if (err < 0 || (err > 0 && ndist - dist.count[0] != 1)) return kBadLengths;
  return codes(s, o, lit, dist);
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n > 0) {
    size_t k = std::min<size_t>(n, 5552);
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return b << 16 | a;
}

// a zlib stream -> out[0 .. *out_len); at most limit bytes
int inflate_zlib(const uint8_t* in, size_t n, std::vector<uint8_t>& buf, size_t limit,
                 size_t* out_len) {
  if (n < 2) return kTruncated;
  unsigned cmf = in[0], flg = in[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
    return kBadHeader;
  Bits s(in + 2, in + n);
  Out o(buf, limit);
  int last;
  do {
    last = (int)s.get(1);
    int type = (int)s.get(2);
    int err = type == 0   ? stored(s, o)
              : type == 1 ? codes(s, o, fixed_lit(), fixed_dist())
              : type == 2 ? dynamic(s, o)
                          : kBadBlockType;
    if (s.overrun()) return kTruncated;
    if (err != kInflateOk) return err;
  } while (!last);
  s.drop(s.cnt & 7);
  uint32_t want = 0;
  for (int i = 0; i < 4; i++) want = want << 8 | s.get(8);
  if (s.overrun()) return kTruncated;
  if (want != adler32(buf.data(), o.pos)) return kBadAdler;
  *out_len = o.pos;
  return kInflateOk;
}

// ---------------------------------------------------------------------------
// PNG decode -> uint8 RGB
// ---------------------------------------------------------------------------

// ipoke_load_png's and ipoke_decode_png's codes (the JAX engine's 1 and 2,
// then the decoder's refusals; 10 + k for inflate's code k)
enum PngCode {
  kPngOk = 0,
  kOpen = 1,          // the file cannot be opened or read
  kMalformed = 2,     // not a PNG libpng reads: signature, chunks, CRC, IHDR, filters, data
  kNoMemory = 5,      // the image's buffers cannot be allocated
  kInterlaced = 6,    // Adam7: the JAX engine reads it without interlace handling
  kPaletteTrns = 7,   // palette + tRNS: the JAX engine expands to RGBA and copies 3 bytes
  kTooSmall = 8,      // under 2 pixels high or wide: the JAX resize reads outside the image
  kBufferSmall = 9,   // ipoke_decode_png: the caller's buffer is smaller than H*W*3
  kInflateBase = 10,
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

uint32_t crc32(const uint8_t* p, size_t n) {
  static const std::vector<uint32_t> table = [] {
    std::vector<uint32_t> t(256);
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

bool read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0) data.insert(data.end(), chunk, chunk + got);
  bool ok = !ferror(f);
  fclose(f);
  return ok;
}

struct Png {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  std::vector<uint8_t> palette;  // 3 bytes per entry
  bool trns = false;             // a tRNS that libpng accepts on a palette image
  std::vector<uint8_t> idat;
};

bool valid_depth(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// the chunks up to the end of the first run of IDATs, as libpng's
// png_read_info and png_read_row see them
int parse(const std::vector<uint8_t>& d, Png& png) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (d.size() < 8 || std::memcmp(d.data(), sig, 8) != 0) return kMalformed;
  size_t pos = 8;
  bool ihdr = false, in_idat = false;
  while (pos + 12 <= d.size()) {
    uint32_t len = be32(&d[pos]);
    if (len > 0x7fffffffu || pos + 12 + (size_t)len > d.size()) return kMalformed;
    const uint8_t* type = &d[pos + 4];
    const uint8_t* body = type + 4;
    bool critical = !(type[0] & 0x20);
    bool is_idat = std::memcmp(type, "IDAT", 4) == 0;
    if (in_idat && !is_idat) break;  // the image data is one run of IDATs
    if (!ihdr && std::memcmp(type, "IHDR", 4) != 0) return kMalformed;  // IHDR comes first
    if (crc32(type, (size_t)len + 4) != be32(body + len)) {
      if (critical) return kMalformed;  // libpng: error on a critical chunk,
      pos += 12 + (size_t)len;          // drops an ancillary one
      continue;
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (ihdr || len != 13) return kMalformed;
      ihdr = true;
      png.w = be32(body);
      png.h = be32(body + 4);
      png.depth = body[8];
      png.ctype = body[9];
      png.interlace = body[12];
      // png_check_IHDR, with libpng's default user limit of 1e6 per side
      if (png.w == 0 || png.h == 0 || png.w > 1000000 || png.h > 1000000 ||
          !valid_depth(png.ctype, png.depth) || body[10] != 0 || body[11] != 0 ||
          png.interlace > 1)
        return kMalformed;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (png.ctype == 3) {
        if (len == 0 || len > 768 || len % 3 != 0 || !png.palette.empty()) return kMalformed;
        png.palette.assign(body, body + len);
      }  // ignored on other colour types, as the JAX engine's transforms ignore it
    } else if (std::memcmp(type, "tRNS", 4) == 0) {
      // png_handle_tRNS on a palette image: kept when it follows PLTE and has
      // 1..num_palette entries, else dropped with a warning
      if (png.ctype == 3 && !png.palette.empty() && len > 0 && len <= png.palette.size() / 3)
        png.trns = true;
    } else if (is_idat) {
      if (png.ctype == 3 && png.palette.empty()) return kMalformed;  // PLTE before IDAT
      in_idat = true;
      png.idat.insert(png.idat.end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      return kMalformed;  // an unknown critical chunk
    }
    pos += 12 + (size_t)len;
  }
  if (!ihdr || png.idat.empty()) return kMalformed;
  return kPngOk;
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  return (uint8_t)(pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
}

// decode path into RGB (h x w x 3); cap > 0 bounds the RGB bytes the
// caller can take (kBufferSmall with w, h set otherwise)
int decode_png(const char* path, std::vector<uint8_t>& rgb, uint32_t* w_out, uint32_t* h_out,
               size_t cap) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return kOpen;
  Png png;
  int rc = parse(data, png);
  if (rc != kPngOk) return rc;
  const uint32_t w = png.w, h = png.h;
  *w_out = w;
  *h_out = h;
  if (png.interlace) return kInterlaced;
  if (png.trns) return kPaletteTrns;
  if (cap > 0 && (size_t)w * h * 3 > cap) return kBufferSmall;
  static const int channels[7] = {1, 0, 3, 1, 2, 0, 4};
  const int ch = channels[png.ctype], depth = png.depth;
  const size_t rowbytes = ((size_t)w * ch * depth + 7) / 8;
  const size_t bpp = std::max<size_t>(1, (size_t)ch * depth / 8);
  const size_t need = (size_t)h * (rowbytes + 1);
  // grown as the stream yields data, so a header that claims a huge image
  // over a short stream fails as "not enough image data", not by its size
  std::vector<uint8_t> raw(std::min<size_t>(need, 1 << 22));
  size_t got = 0;
  // libpng warns on image data past the rows and goes on: so does this
  rc = inflate_zlib(png.idat.data(), png.idat.size(), raw, 2 * need + 65536, &got);
  if (rc != kInflateOk) return kInflateBase + rc;
  if (got < need) return kMalformed;  // not enough image data
  // undo the row filters in place
  std::vector<uint8_t> zeros(rowbytes, 0);
  for (uint32_t y = 0; y < h; y++) {
    uint8_t* row = &raw[(size_t)y * (rowbytes + 1)];
    uint8_t* cur = row + 1;
    const uint8_t* up = y ? row - rowbytes : zeros.data();
    switch (row[0]) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; i++) cur[i] = (uint8_t)(cur[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(cur[i] + (((i >= bpp ? cur[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(cur[i] + paeth(i >= bpp ? cur[i - bpp] : 0, up[i],
                                            i >= bpp ? up[i - bpp] : 0));
        break;
      default: return kMalformed;  // libpng: "bad adaptive filter value"
    }
  }
  // to RGB as libpng's strip_16, palette_to_rgb, gray_to_rgb and strip_alpha
  rgb.resize((size_t)w * h * 3);
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  uint8_t pal[256 * 3] = {0};  // libpng's palette: 256 entries, the unset ones 0
  std::memcpy(pal, png.palette.data(), png.palette.size());
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = &raw[(size_t)y * (rowbytes + 1) + 1];
    uint8_t* dst = &rgb[(size_t)y * w * 3];
    for (uint32_t x = 0; x < w; x++, dst += 3) {
      if (depth < 8) {  // grey or palette, one sample per pixel
        size_t bit = (size_t)x * depth;
        int v = (src[bit >> 3] >> (8 - depth - (int)(bit & 7))) & ((1 << depth) - 1);
        if (png.ctype == 3) {
          std::memcpy(dst, &pal[v * 3], 3);
        } else {
          dst[0] = dst[1] = dst[2] = (uint8_t)(v * scale);
        }
        continue;
      }
      const int step = depth / 8;  // bytes per sample; the high byte first
      const uint8_t* px = src + (size_t)x * ch * step;
      switch (png.ctype) {
        case 0: case 4: dst[0] = dst[1] = dst[2] = px[0]; break;
        case 2: case 6: dst[0] = px[0]; dst[1] = px[step]; dst[2] = px[2 * step]; break;
        case 3: std::memcpy(dst, &pal[px[0] * 3], 3); break;
      }
    }
  }
  return kPngOk;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// .npy reader (float32/float64, C-order; minimal parser for the flow files)
// ---------------------------------------------------------------------------

// Returns 0 on success; fills dims (up to 4) and ndim; copies data (as f32)
// into out (caller-allocated with capacity cap floats).  The JAX engine's
// parser and codes: 1 open, 2 not .npy, 3 dtype / order / shape, 4 over
// cap, 5 short data.
int ipoke_load_npy_flow(const char* path, float* out, int64_t cap, int64_t* dims, int* ndim) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return 2;
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major >= 2) {
    if (fread(&header_len, 4, 1, f) != 1) { fclose(f); return 2; }
  } else {
    uint16_t hl16;
    if (fread(&hl16, 2, 1, f) != 1) { fclose(f); return 2; }
    header_len = hl16;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) { fclose(f); return 2; }
  bool f8 = header.find("<f8") != std::string::npos;
  if (!f8 && header.find("<f4") == std::string::npos) { fclose(f); return 3; }
  if (header.find("'fortran_order': True") != std::string::npos) { fclose(f); return 3; }
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) { fclose(f); return 3; }
  sp += 10;
  int nd = 0;
  int64_t total = 1;
  while (nd < 4) {
    size_t end = header.find_first_of(",)", sp);
    std::string tok = header.substr(sp, end - sp);
    if (!tok.empty() && tok.find_first_of("0123456789") != std::string::npos) {
      dims[nd] = atoll(tok.c_str());
      total *= dims[nd];
      nd++;
    }
    if (header[end] == ')') break;
    sp = end + 1;
  }
  *ndim = nd;
  if (total > cap) { fclose(f); return 4; }
  if (f8) {
    std::vector<double> tmp(total);
    if (fread(tmp.data(), 8, total, f) != (size_t)total) { fclose(f); return 5; }
    for (int64_t i = 0; i < total; i++) out[i] = (float)tmp[i];
  } else {
    if (fread(out, 4, total, f) != (size_t)total) { fclose(f); return 5; }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG -> float32 RGB [-1, 1], bilinear resize
// ---------------------------------------------------------------------------

// decode_png with no exception past the C ABI: a header that asks for more
// memory than there is returns kNoMemory
int decode_png_noexcept(const char* path, std::vector<uint8_t>& rgb, uint32_t* w, uint32_t* h,
                        size_t cap) {
  try {
    return decode_png(path, rgb, w, h, cap);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  } catch (const std::length_error&) {
    return kNoMemory;
  }
}

int ipoke_decode_png(const char* path, uint8_t* out, int64_t cap, int* h_out, int* w_out) {
  std::vector<uint8_t> img;
  uint32_t w = 0, h = 0;
  int rc = decode_png_noexcept(path, img, &w, &h, cap > 0 ? (size_t)cap : 1);
  *h_out = (int)h;
  *w_out = (int)w;
  if (rc != kPngOk) return rc;
  std::memcpy(out, img.data(), img.size());
  return 0;
}

int ipoke_load_png(const char* path, float* out, int out_h, int out_w) {
  std::vector<uint8_t> img;
  uint32_t w = 0, h = 0;
  int rc = decode_png_noexcept(path, img, &w, &h, 0);
  if (rc != kPngOk) return rc;
  if (w < 2 || h < 2) return kTooSmall;
  // bilinear resize (align_corners) to (out_h, out_w) + [-1,1] normalize:
  // the JAX engine's expressions, h and w unsigned as its png_uint_32
  for (int oy = 0; oy < out_h; oy++) {
    float sy = out_h == 1 ? 0.f : (float)oy * (h - 1) / (out_h - 1);
    int y0 = std::min((int)sy, (int)h - 2);
    float fy = sy - y0;
    for (int ox = 0; ox < out_w; ox++) {
      float sx = out_w == 1 ? 0.f : (float)ox * (w - 1) / (out_w - 1);
      int x0 = std::min((int)sx, (int)w - 2);
      float fx = sx - x0;
      for (int c = 0; c < 3; c++) {
        float v00 = img[((size_t)y0 * w + x0) * 3 + c];
        float v01 = img[((size_t)y0 * w + x0 + 1) * 3 + c];
        float v10 = img[((size_t)(y0 + 1) * w + x0) * 3 + c];
        float v11 = img[((size_t)(y0 + 1) * w + x0 + 1) * 3 + c];
        float v = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
                  v10 * fy * (1 - fx) + v11 * fy * fx;
        out[((size_t)oy * out_w + ox) * 3 + c] = v / 127.5f - 1.0f;
      }
    }
  }
  return 0;
}

int ipoke_inflate(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, int64_t* out_len) {
  std::vector<uint8_t> buf;
  size_t got = 0;
  int rc;
  try {
    rc = inflate_zlib(in, (size_t)n, buf, (size_t)cap, &got);
  } catch (const std::bad_alloc&) {
    return kTooLong;
  }
  if (rc != kInflateOk) return rc;
  std::memcpy(out, buf.data(), got);
  *out_len = (int64_t)got;
  return 0;
}

// ---------------------------------------------------------------------------
// poke simulation (semantics of data/base_dataset.py:507-648), the JAX
// engine's simulate_one step for step
// ---------------------------------------------------------------------------

struct PokeParams {
  int poke_size;
  int n_pokes_max;
  int fix_n_pokes;
  int equal_poke_val;
  int zero_poke;
};

static void simulate_one(const float* flow, int h, int w, const PokeParams& pp,
                         uint64_t seed, float* poke, int64_t* centers) {
  std::mt19937_64 rng(seed);
  const int ps = pp.poke_size;
  const int vh0 = ps, vh1 = h - ps, vw0 = ps, vw1 = w - ps;
  const int vh = vh1 - vh0, vw = vw1 - vw0;
  std::vector<float> amp((size_t)vh * vw);
  float amin = 1e30f, amax = -1e30f;
  for (int y = 0; y < vh; y++)
    for (int x = 0; x < vw; x++) {
      const float* px = &flow[(((size_t)(y + vh0)) * w + (x + vw0)) * 2];
      float a = std::sqrt(px[0] * px[0] + px[1] * px[1]);
      amp[(size_t)y * vw + x] = a;
      amin = std::min(amin, a);
      amax = std::max(amax, a);
    }
  float range = std::max(amax - amin, 1e-12f);
  double sum = 0, sum2 = 0;
  for (auto& a : amp) {
    a = (a - amin) / range;
    sum += a;
    sum2 += (double)a * a;
  }
  const size_t n = amp.size();
  float mean = (float)(sum / n);
  float stdv = (float)std::sqrt(std::max(sum2 / n - (double)mean * mean, 0.0));

  auto collect = [&](float thresh, std::vector<int>& out_idx) {
    out_idx.clear();
    for (size_t i = 0; i < n; i++)
      if (amp[i] > thresh) out_idx.push_back((int)i);
  };
  std::vector<int> cand;
  collect(mean + 2.f * stdv, cand);
  if (cand.empty()) collect(mean + stdv, cand);
  if (cand.empty()) collect(mean, cand);

  std::vector<int> place;
  std::vector<int> mgn;
  if (pp.zero_poke) {
    // placement on background (lowest 5% amplitude), magnitudes from movers
    std::vector<float> sorted(amp.begin(), amp.end());
    std::nth_element(sorted.begin(), sorted.begin() + n / 20, sorted.end());
    float p5 = sorted[n / 20];
    for (size_t i = 0; i < n; i++)
      if (amp[i] < p5) place.push_back((int)i);
    if (place.empty()) place.push_back(0);
    collect(mean + stdv, mgn);
    if (mgn.empty()) collect(mean, mgn);
    if (mgn.empty()) mgn.push_back(0);
  } else {
    place = cand;
  }
  if (place.empty()) {
    for (int i = 0; i < pp.n_pokes_max; i++) centers[i * 2] = centers[i * 2 + 1] = -1;
    return;
  }

  int n_pokes = pp.n_pokes_max;
  if (!pp.fix_n_pokes && pp.n_pokes_max > 1) {
    int hi = std::min<int>(pp.n_pokes_max, (int)place.size());
    n_pokes = 1 + (int)(rng() % (uint64_t)hi);
  }
  memset(poke, 0, (size_t)h * w * 2 * sizeof(float));
  for (int i = 0; i < pp.n_pokes_max; i++) centers[i * 2] = centers[i * 2 + 1] = -1;
  int half = ps / 2;
  for (int k = 0; k < n_pokes; k++) {
    int pi = place[rng() % place.size()];
    int r = pi / vw + vh0, c = pi % vw + vw0;
    int vr = r, vc = c;
    if (pp.zero_poke) {
      int mi = mgn[rng() % mgn.size()];
      vr = mi / vw + vh0;
      vc = mi % vw + vw0;
    }
    for (int dy = -half; dy <= half; dy++)
      for (int dx = -half; dx <= half; dx++) {
        int yy = r + dy, xx = c + dx;
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        const float* src = pp.equal_poke_val
                               ? &flow[(((size_t)vr) * w + vc) * 2]
                               : &flow[(((size_t)std::clamp(vr + dy, 0, h - 1)) * w +
                                        std::clamp(vc + dx, 0, w - 1)) * 2];
        poke[(((size_t)yy) * w + xx) * 2] = src[0];
        poke[(((size_t)yy) * w + xx) * 2 + 1] = src[1];
      }
    centers[k * 2] = r;
    centers[k * 2 + 1] = c;
  }
}

void ipoke_simulate_pokes(const float* flows, int batch, int h, int w,
                          int poke_size, int n_pokes_max, int fix_n_pokes,
                          int equal_poke_val, int zero_poke, uint64_t seed,
                          float* pokes, int64_t* centers) {
  PokeParams pp{poke_size, n_pokes_max, fix_n_pokes, equal_poke_val, zero_poke};
#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; b++) {
    simulate_one(&flows[(size_t)b * h * w * 2], h, w, pp, seed + (uint64_t)b * 7919,
                 &pokes[(size_t)b * h * w * 2], &centers[(size_t)b * n_pokes_max * 2]);
  }
}

// ---------------------------------------------------------------------------
// batched frame loading (OpenMP over (example, frame))
// ---------------------------------------------------------------------------

// paths: batch*t C strings; out: (batch, t, h, w, 3) float32.  Returns 0, or
// the code of a frame that failed (the last to store one).
int ipoke_load_frames(const char** paths, int batch, int t, int h, int w, float* out) {
  std::atomic<int> err{0};
#pragma omp parallel for collapse(2) schedule(dynamic)
  for (int b = 0; b < batch; b++) {
    for (int i = 0; i < t; i++) {
      int rc = ipoke_load_png(paths[b * t + i], &out[(((size_t)b * t + i) * h * w * 3)], h, w);
      if (rc != 0) err.store(rc);
    }
  }
  return err.load();
}

}  // extern "C"
