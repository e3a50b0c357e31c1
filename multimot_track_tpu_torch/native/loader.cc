// Native KITTI-sequence loader with threaded prefetch, without libpng or zlib.
//
// The port's copy of multimot_track_tpu/native/loader.cc.  Frames decode on
// worker threads ahead of the consumer; io/native_loader.py binds the C API
// through ctypes, which releases the GIL for each call, so the Python
// consumer runs while the workers decode.
//
// PNG files are read here, with nothing beyond the C++ standard library:
// the chunk walk with the CRC checks of io/png._chunks, the zlib stream
// inflated by the decoder below (RFC 1950 / 1951: stored, fixed-Huffman and
// dynamic-Huffman blocks, the Adler-32 check), the rows unfiltered by
// png_unfilter.h.  Formats: what io/png.read_png takes, 8- and 16-bit gray,
// 8-bit RGB and RGBA, non-interlaced; anything else fails the decode.  The
// rest is the JAX package's loader: gray with the weights 0.299 / 0.587 /
// 0.114 in float32, depth as the raw 16-bit values, the Middlebury .flo
// layout, and the whitespace-int semantic masks with the driver's
// `v > 0 && v < max_label` clamp (Examples/RGB-D/rgbd_tum.cc:335).
//
// Two differences from the JAX package's loader:
//  * a frame that a consumer waits for is pinned in the cache until it has
//    been copied out, so that a worker's eviction cannot take it from under
//    the waiter (there, mmt_get can wait forever with a small cache and a
//    deep prefetch);
//  * a missing semantic/ file gives a zero mask, as io/kitti.KittiSequence
//    does (there, the frame fails).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "png_unfilter.h"

namespace {

// ------------------------------------------------------------------ inflate

constexpr int kFastBits = 10;     // codes up to this length decode by one lookup

struct Huffman {
  uint16_t count[16];             // codes of each length
  uint16_t symbol[288];           // symbols in canonical code order
  uint16_t fast[1 << kFastBits];  // next kFastBits stream bits -> (symbol << 4) | length, 0: longer
};

// Builds the canonical code of `length[0..n)`.  Returns 0 for a complete
// code, > 0 for an incomplete one, < 0 for an over-subscribed one.
int construct(Huffman& h, const uint8_t* length, int n) {
  std::memset(h.count, 0, sizeof h.count);
  std::memset(h.fast, 0, sizeof h.fast);
  for (int s = 0; s < n; ++s) h.count[length[s]]++;
  if (h.count[0] == n) return 0;  // no codes: complete, but any decode fails
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return left;
  }
  uint16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int s = 0; s < n; ++s)
    if (length[s]) h.symbol[offs[length[s]]++] = uint16_t(s);
  // the stream carries each code from its most significant bit on, packed
  // from the least significant bit of each byte: index the table reversed
  int code = 0, index = 0;
  for (int len = 1; len <= kFastBits; ++len) {
    for (int i = 0; i < h.count[len]; ++i, ++code) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      const uint16_t entry = uint16_t((h.symbol[index++] << 4) | len);
      for (int fill = rev; fill < (1 << kFastBits); fill += 1 << len) h.fast[fill] = entry;
    }
    code <<= 1;
  }
  return left;
}

struct Bits {
  const uint8_t* in;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;                    // bits in buf
  int pad = 0;                    // zero bytes added past the end of the input

  Bits(const uint8_t* in_, size_t n_) : in(in_), n(n_) {}

  void refill() {
    while (cnt <= 56) {
      if (pos < n) {
        buf |= uint64_t(in[pos++]) << cnt;
      } else {
        ++pad;
      }
      cnt += 8;
    }
  }
  uint32_t peek(int k) {
    if (cnt < k) refill();
    return uint32_t(buf & ((uint64_t(1) << k) - 1));
  }
  void drop(int k) {
    buf >>= k;
    cnt -= k;
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    drop(k);
    return v;
  }
  bool overran() const { return cnt < 8 * pad; }   // consumed bits past the input
  void align() { drop(cnt & 7); }
};

int decode(Bits& s, const Huffman& h) {
  const uint16_t e = h.fast[s.peek(kFastBits)];
  if (e) {
    s.drop(e & 15);
    return e >> 4;
  }
  int code = 0, first = 0, index = 0;   // canonical decode, one bit at a time
  for (int len = 1; len < 16; ++len) {
    code |= int(s.get(1));
    const int count = h.count[len];
    if (code - count < first) return h.symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

bool codes(Bits& s, std::vector<uint8_t>& out, const Huffman& lit, const Huffman& dist,
           std::string& err) {
  for (;;) {
    int sym = decode(s, lit);
    if (s.overran()) return err = "deflate: stream ends inside a block", false;
    if (sym < 0) return err = "deflate: invalid literal/length code", false;
    if (sym < 256) {
      out.push_back(uint8_t(sym));
      continue;
    }
    if (sym == 256) return true;
    sym -= 257;
    if (sym >= 29) return err = "deflate: invalid length symbol", false;
    const size_t len = kLenBase[sym] + s.get(kLenExtra[sym]);
    const int dsym = decode(s, dist);
    if (dsym < 0 || dsym >= 30) return err = "deflate: invalid distance code", false;
    const size_t d = kDistBase[dsym] + s.get(kDistExtra[dsym]);
    if (s.overran()) return err = "deflate: stream ends inside a block", false;
    if (d > out.size()) return err = "deflate: distance reaches before the output", false;
    const size_t from = out.size() - d;
    for (size_t i = 0; i < len; ++i) {
      const uint8_t v = out[from + i];   // may be a byte this copy wrote
      out.push_back(v);
    }
  }
}

const Huffman* fixed_codes() {
  static Huffman tables[2];
  static std::once_flag once;
  std::call_once(once, [] {
    uint8_t len[288];
    int s = 0;
    for (; s < 144; ++s) len[s] = 8;
    for (; s < 256; ++s) len[s] = 9;
    for (; s < 280; ++s) len[s] = 7;
    for (; s < 288; ++s) len[s] = 8;
    construct(tables[0], len, 288);
    for (s = 0; s < 30; ++s) len[s] = 5;
    construct(tables[1], len, 30);
  });
  return tables;
}

bool dynamic(Bits& s, std::vector<uint8_t>& out, std::string& err) {
  static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                    11, 4, 12, 3, 13, 2, 14, 1, 15};
  const int nlen = int(s.get(5)) + 257, ndist = int(s.get(5)) + 1, ncode = int(s.get(4)) + 4;
  if (nlen > 286 || ndist > 30) return err = "deflate: too many length or distance codes", false;
  uint8_t lengths[320] = {0};
  for (int i = 0; i < ncode; ++i) lengths[order[i]] = uint8_t(s.get(3));
  Huffman lencode, distcode;
  if (construct(lencode, lengths, 19) != 0)
    return err = "deflate: incomplete or over-subscribed code-length code", false;
  int index = 0;
  while (index < nlen + ndist) {
    int sym = decode(s, lencode);
    if (s.overran()) return err = "deflate: stream ends inside a block header", false;
    if (sym < 0) return err = "deflate: invalid code-length code", false;
    if (sym < 16) {
      lengths[index++] = uint8_t(sym);
      continue;
    }
    uint8_t len = 0;
    if (sym == 16) {
      if (index == 0) return err = "deflate: repeat with no previous length", false;
      len = lengths[index - 1];
      sym = 3 + int(s.get(2));
    } else if (sym == 17) {
      sym = 3 + int(s.get(3));
    } else {
      sym = 11 + int(s.get(7));
    }
    if (index + sym > nlen + ndist) return err = "deflate: too many code lengths", false;
    while (sym--) lengths[index++] = len;
  }
  if (lengths[256] == 0) return err = "deflate: no end-of-block code", false;
  // an incomplete code is allowed only as a single code of length 1
  int left = construct(lencode, lengths, nlen);
  if (left < 0 || (left > 0 && nlen != lencode.count[0] + lencode.count[1]))
    return err = "deflate: invalid literal/length code lengths", false;
  left = construct(distcode, lengths + nlen, ndist);
  if (left < 0 || (left > 0 && ndist != distcode.count[0] + distcode.count[1]))
    return err = "deflate: invalid distance code lengths", false;
  return codes(s, out, lencode, distcode, err);
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    const size_t k = n < 5552 ? n : 5552;   // the most bytes before b can overflow
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      b += a;
    }
    a %= 65521;
    b %= 65521;
    p += k;
    n -= k;
  }
  return (b << 16) | a;
}

// Inflates a zlib stream (RFC 1950 around RFC 1951) and appends to `out`.
bool inflate_zlib(const uint8_t* in, size_t n, std::vector<uint8_t>& out, std::string& err) {
  if (n < 6) return err = "zlib: stream too short", false;
  const int cmf = in[0], flg = in[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7) return err = "zlib: not a deflate stream", false;
  if (((cmf << 8) | flg) % 31) return err = "zlib: header check failed", false;
  if (flg & 0x20) return err = "zlib: preset dictionary", false;
  const size_t start = out.size();
  Bits s(in + 2, n - 2);
  for (int last = 0; !last;) {
    last = int(s.get(1));
    const int type = int(s.get(2));
    if (type == 0) {
      s.align();
      const uint32_t len = s.get(16), nlen = s.get(16);
      if (len != (~nlen & 0xffff)) return err = "deflate: stored block length check failed", false;
      for (uint32_t i = 0; i < len; ++i) out.push_back(uint8_t(s.get(8)));
      if (s.overran()) return err = "deflate: stream ends inside a stored block", false;
    } else if (type == 1) {
      const Huffman* f = fixed_codes();
      if (!codes(s, out, f[0], f[1], err)) return false;
    } else if (type == 2) {
      if (!dynamic(s, out, err)) return false;
    } else {
      return err = "deflate: invalid block type", false;
    }
  }
  s.align();
  uint32_t want = 0;
  for (int i = 0; i < 4; ++i) want = (want << 8) | s.get(8);
  if (s.overran()) return err = "zlib: no Adler-32 check", false;
  if (adler32(out.data() + start, out.size() - start) != want)
    return err = "zlib: Adler-32 mismatch", false;
  return true;
}

// ---------------------------------------------------------------------- PNG

uint32_t crc32(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  });
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

struct Image {
  int W = 0, H = 0, channels = 0, depth = 0;
  std::vector<uint16_t> px;     // H * W * channels sample values
};

bool read_file(const std::string& path, std::vector<uint8_t>& data, std::string& err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return err = path + ": cannot open", false;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  data.resize(sz > 0 ? size_t(sz) : 0);
  const bool ok = sz >= 0 && std::fread(data.data(), 1, data.size(), f) == data.size();
  std::fclose(f);
  if (!ok) err = path + ": read failed";
  return ok;
}

// The chunk walk of io/png._chunks and the header checks of io/png._ihdr;
// with `pixels` false it stops after the walk and fills the header alone.
bool decode_png(const std::vector<uint8_t>& data, Image& img, bool pixels, std::string& err) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  const size_t n = data.size();
  const uint8_t* d = data.data();
  if (n < 8 || std::memcmp(d, sig, 8) != 0) return err = "not a PNG file", false;
  bool ihdr = false, iend = false;
  std::vector<uint8_t> idat;
  for (size_t pos = 8; pos + 12 <= n;) {
    const uint32_t len = be32(d + pos);
    const uint8_t* kind = d + pos + 4;
    const std::string name(reinterpret_cast<const char*>(kind), 4);
    if (len > n - pos - 12) return err = "truncated " + name + " chunk", false;
    if (crc32(kind, size_t(len) + 4) != be32(d + pos + 8 + len))
      return err = "CRC mismatch in " + name + " chunk", false;
    const uint8_t* body = d + pos + 8;
    if (name == "IHDR") {
      if (len != 13) return err = "bad IHDR", false;
      const uint32_t w = be32(body), h = be32(body + 4);
      const int depth = body[8], ctype = body[9];
      if (ctype != 0 && ctype != 2 && ctype != 6)
        return err = "colour type " + std::to_string(ctype) + " is not supported", false;
      if (body[12]) return err = "interlaced PNG is not supported", false;
      if (body[10] || body[11]) return err = "unknown compression or filter method", false;
      if ((depth != 8 && depth != 16) || (depth == 16 && ctype != 0))
        return err = std::to_string(depth) + "-bit colour type " + std::to_string(ctype) +
                     " is not supported", false;
      if (w == 0 || h == 0 || uint64_t(w) * h > (uint64_t(1) << 28))
        return err = "implausible size", false;
      img.W = int(w);
      img.H = int(h);
      img.depth = depth;
      img.channels = ctype == 0 ? 1 : ctype == 2 ? 3 : 4;
      ihdr = true;
    } else if (name == "IDAT") {
      if (pixels) idat.insert(idat.end(), body, body + len);
    } else if (name == "IEND") {
      iend = true;
      break;
    }
    pos += 12 + size_t(len);
  }
  if (!iend) return err = "no IEND chunk", false;
  if (!ihdr) return err = "no IHDR chunk", false;
  if (!pixels) return true;
  if (idat.empty()) return err = "no IDAT chunk", false;
  std::vector<uint8_t> raw;
  const int bpp = img.channels * img.depth / 8;
  const size_t rb = size_t(img.W) * bpp;
  raw.reserve(size_t(img.H) * (rb + 1));
  if (!inflate_zlib(idat.data(), idat.size(), raw, err)) return false;
  if (raw.size() < size_t(img.H) * (rb + 1)) return err = "image data too short", false;
  std::vector<uint8_t> rows(size_t(img.H) * rb);
  const int rc = mmt_png::unfilter(raw.data(), rows.data(), img.H, int(rb), bpp);
  if (rc) return err = "unknown PNG filter type in row " + std::to_string(-rc - 1), false;
  img.px.resize(size_t(img.H) * img.W * img.channels);
  if (img.depth == 16) {
    for (size_t i = 0; i < img.px.size(); ++i)
      img.px[i] = uint16_t((rows[2 * i] << 8) | rows[2 * i + 1]);   // stored big-endian
  } else {
    std::copy(rows.begin(), rows.end(), img.px.begin());
  }
  return true;
}

bool read_png(const std::string& path, Image& img, std::string& err) {
  std::vector<uint8_t> data;
  if (!read_file(path, data, err)) return false;
  if (!decode_png(data, img, true, err)) return err = path + ": " + err, false;
  return true;
}

// ------------------------------------------------------------ frame files

bool file_exists(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (f) std::fclose(f);
  return f != nullptr;
}

bool load_gray(const std::string& path, int& H, int& W, std::vector<float>& g, std::string& err) {
  Image img;
  if (!read_png(path, img, err)) return false;
  H = img.H;
  W = img.W;
  const int c = img.channels;
  const uint16_t* px = img.px.data();
  g.resize(size_t(H) * W);
  if (c >= 3) {
    for (size_t i = 0; i < g.size(); ++i)   // OpenCV RGB2GRAY weights, as io/kitti._rgb_to_gray
      g[i] = 0.299f * px[i * c] + 0.587f * px[i * c + 1] + 0.114f * px[i * c + 2];
  } else {
    for (size_t i = 0; i < g.size(); ++i) g[i] = float(px[i]);
  }
  return true;
}

bool load_depth(const std::string& path, int H, int W, std::vector<float>& d, std::string& err) {
  Image img;
  if (!read_png(path, img, err)) return false;
  if (img.H != H || img.W != W) return err = path + ": size differs from the image's", false;
  d.resize(size_t(H) * W);
  for (size_t i = 0; i < d.size(); ++i) d[i] = float(img.px[i * img.channels]);
  return true;
}

// A missing file gives zeros (the sequence's last frame has no flow).
bool load_flo(const std::string& path, int H, int W, std::vector<float>& fl, std::string& err) {
  fl.assign(size_t(H) * W * 2, 0.f);
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return true;
  float magic = 0;
  int32_t w = 0, h = 0;
  bool ok = std::fread(&magic, 4, 1, f) == 1 && magic >= 202021.0f && magic <= 202022.0f &&
            std::fread(&w, 4, 1, f) == 1 && std::fread(&h, 4, 1, f) == 1 && w == W && h == H;
  if (ok) ok = std::fread(fl.data(), 4, fl.size(), f) == fl.size();
  std::fclose(f);
  if (!ok) err = path + ": bad magic, size or payload";
  return ok;
}

// Whitespace-separated integers, one a pixel; a missing file gives zeros.
bool load_mask(const std::string& path, int H, int W, std::vector<int32_t>& m, int max_label,
               std::string& err) {
  m.assign(size_t(H) * W, 0);
  if (!file_exists(path)) return true;
  std::vector<uint8_t> buf;
  if (!read_file(path, buf, err)) return false;
  const auto space = [](uint8_t ch) { return ch == ' ' || (ch >= '\t' && ch <= '\r'); };
  const size_t total = m.size(), n = buf.size();
  size_t count = 0, p = 0;
  for (;;) {
    while (p < n && space(buf[p])) ++p;
    if (p == n) break;
    if (count == total) return err = path + ": more values than pixels", false;
    const bool neg = buf[p] == '-';
    if (buf[p] == '-' || buf[p] == '+') ++p;
    const size_t digits = p;
    int64_t v = 0;
    while (p < n && buf[p] >= '0' && buf[p] <= '9' && v < (int64_t(1) << 32))
      v = v * 10 + (buf[p++] - '0');
    if (p == digits || (p < n && !space(buf[p])) || v > INT32_MAX)
      return err = path + ": not an int32 at byte " + std::to_string(digits), false;
    if (neg) v = -v;
    m[count++] = (v > 0 && v < max_label) ? int32_t(v) : 0;
  }
  if (count != total)
    return err = path + ": " + std::to_string(count) + " values for " +
                 std::to_string(total) + " pixels", false;
  return true;
}

// -------------------------------------------------------------------- loader

struct Frame {
  int H = 0, W = 0;
  std::vector<float> gray;       // H*W, 0..255
  std::vector<float> depth_raw;  // H*W raw png values (disparity*256)
  std::vector<float> flow;       // H*W*2
  std::vector<int32_t> sem;      // H*W
  bool ok = false;
  std::string err;
};

struct Loader {
  std::string root;
  int n_frames = 0, H = 0, W = 0, max_label = 4, cache_cap = 8;
  std::map<int, Frame> cache;
  std::deque<int> order;         // cached frames in insertion order, for eviction
  std::deque<int> queue;         // frames awaiting a worker
  std::set<int> pending;         // frames queued or being decoded
  std::map<int, int> waiting;    // frame -> consumers waiting for it: pinned in the cache
  int consumers = 0;             // calls inside mmt_get
  std::mutex mu;
  std::condition_variable cv_ready, cv_work;
  std::vector<std::thread> workers;
  bool stop = false;

  std::string path(const char* sub, int i, const char* ext) const {
    char b[64];
    std::snprintf(b, sizeof b, "/%s/%06d.%s", sub, i, ext);
    return root + b;
  }

  void decode_into(int idx, Frame& fr) const {
    int h = 0, w = 0;
    fr.ok = load_gray(path("image", idx, "png"), h, w, fr.gray, fr.err);
    fr.H = h;
    fr.W = w;
    if (fr.ok) fr.ok = load_depth(path("depth", idx, "png"), h, w, fr.depth_raw, fr.err);
    if (fr.ok) fr.ok = load_flo(path("flow", idx, "flo"), h, w, fr.flow, fr.err);
    if (fr.ok)
      fr.ok = load_mask(path("semantic", idx, "txt"), h, w, fr.sem, max_label, fr.err);
    if (fr.ok && (h != H || w != W) && H) {
      fr.ok = false;
      fr.err = path("image", idx, "png") + ": size differs from frame 0's";
    }
  }

  // Under mu: cache the frame, then evict the oldest frames nobody waits for.
  void insert(int idx, Frame&& fr) {
    pending.erase(idx);
    cache[idx] = std::move(fr);
    order.push_back(idx);
    for (auto it = order.begin(); it != order.end() && int(cache.size()) > cache_cap;) {
      if (waiting.count(*it)) {
        ++it;
      } else {
        cache.erase(*it);
        it = order.erase(it);
      }
    }
  }

  void worker() {
    for (;;) {
      int idx = -1;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !queue.empty(); });
        if (stop) return;
        idx = queue.front();
        queue.pop_front();
      }
      Frame fr;
      decode_into(idx, fr);
      {
        std::unique_lock<std::mutex> lk(mu);
        insert(idx, std::move(fr));
      }
      cv_ready.notify_all();
    }
  }
};

void set_err(char* buf, int n, const std::string& msg) {
  if (!buf || n <= 0) return;
  std::snprintf(buf, size_t(n), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Opens the sequence under `root` and decodes frame 0 for its size.
// Returns nullptr, with the reason in `err`, when frame 0 does not decode.
void* mmt_open(const char* root, int n_frames, int max_label, int n_threads, int cache_cap,
               char* err, int err_len) {
  auto* L = new Loader();
  L->root = root;
  L->n_frames = n_frames;
  L->max_label = max_label;
  L->cache_cap = cache_cap > 0 ? cache_cap : 8;
  Frame probe;
  if (n_frames > 0) {
    L->decode_into(0, probe);
  } else {
    probe.err = std::string(root) + ": no frames";
  }
  if (!probe.ok) {
    set_err(err, err_len, probe.err);
    delete L;
    return nullptr;
  }
  L->H = probe.H;
  L->W = probe.W;
  L->insert(0, std::move(probe));
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

void mmt_dims(void* h, int* H, int* W) {
  auto* L = static_cast<Loader*>(h);
  *H = L->H;
  *W = L->W;
}

// Queues frames idx .. idx + depth - 1 that are neither cached nor pending.
void mmt_prefetch(void* h, int idx, int depth) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  for (int i = std::max(idx, 0); i < idx + depth && i < L->n_frames; ++i) {
    if (!L->cache.count(i) && !L->pending.count(i)) {
      L->pending.insert(i);
      L->queue.push_back(i);
    }
  }
  L->cv_work.notify_all();
}

// Blocks until frame idx is decoded and copies it into the caller's buffers
// (H*W floats gray and depth, H*W*2 floats flow, H*W int32 mask).  The frame
// is pinned in the cache while this waits.  Returns 1, or 0 with the reason
// in `err` when the frame does not decode.
int mmt_get(void* h, int idx, float* gray, float* depth_raw, float* flow, int32_t* sem,
            char* err, int err_len) {
  auto* L = static_cast<Loader*>(h);
  if (idx < 0 || idx >= L->n_frames) {
    set_err(err, err_len, "frame " + std::to_string(idx) + " is out of range");
    return 0;
  }
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->stop) {
    set_err(err, err_len, "the loader is closed");
    return 0;
  }
  L->consumers++;
  L->waiting[idx]++;
  if (!L->cache.count(idx)) {
    const auto it = std::find(L->queue.begin(), L->queue.end(), idx);
    const bool queued = it != L->queue.end();
    if (queued) L->queue.erase(it);                    // move it to the front
    if (queued || !L->pending.count(idx)) {
      L->pending.insert(idx);
      L->queue.push_front(idx);
      L->cv_work.notify_all();
    }
    L->cv_ready.wait(lk, [&] { return L->cache.count(idx) > 0 || L->stop; });
  }
  const auto hit = L->cache.find(idx);
  const int ok = hit != L->cache.end() && hit->second.ok ? 1 : 0;
  if (ok) {
    const Frame& fr = hit->second;
    const size_t n = size_t(L->H) * L->W;
    std::memcpy(gray, fr.gray.data(), n * 4);
    std::memcpy(depth_raw, fr.depth_raw.data(), n * 4);
    std::memcpy(flow, fr.flow.data(), n * 8);
    std::memcpy(sem, fr.sem.data(), n * 4);
  } else {
    set_err(err, err_len, hit != L->cache.end() ? hit->second.err : "the loader is closed");
  }
  if (--L->waiting[idx] == 0) L->waiting.erase(idx);
  L->consumers--;
  L->cv_ready.notify_all();
  return ok;
}

// Stops the workers; a consumer still waiting in mmt_get returns 0.
void mmt_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_work.notify_all();
    L->cv_ready.notify_all();
    L->cv_ready.wait(lk, [&] { return L->consumers == 0; });
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

// The decoder's parts on their own, for tests and timing.

// Inflates the zlib stream src[0..n) into dst (cap bytes).  Returns 1 with
// the output's length in *out_len, or 0 with the reason in `err` (*out_len
// is then the length needed when only the buffer was too small).
int mmt_inflate(const uint8_t* src, long long n, uint8_t* dst, long long cap, long long* out_len,
                char* err, int err_len) {
  std::vector<uint8_t> out;
  std::string msg;
  if (!inflate_zlib(src, size_t(n), out, msg)) {
    set_err(err, err_len, msg);
    *out_len = 0;
    return 0;
  }
  *out_len = (long long)out.size();
  if ((long long)out.size() > cap) {
    set_err(err, err_len, "output larger than the buffer");
    return 0;
  }
  std::memcpy(dst, out.data(), out.size());
  return 1;
}

// Decodes the PNG file at `path`: dims = {width, height, channels, bit
// depth}; the samples go to out (cap values, native uint16) unless out is
// nullptr, which reads the header alone.  Returns 1, or 0 with the reason.
int mmt_png_read(const char* path, int* dims, uint16_t* out, long long cap, char* err,
                 int err_len) {
  std::vector<uint8_t> data;
  std::string msg;
  Image img;
  if (!read_file(path, data, msg)) {
    set_err(err, err_len, msg);
    return 0;
  }
  if (!decode_png(data, img, out != nullptr, msg)) {
    set_err(err, err_len, std::string(path) + ": " + msg);
    return 0;
  }
  dims[0] = img.W;
  dims[1] = img.H;
  dims[2] = img.channels;
  dims[3] = img.depth;
  if (!out) return 1;
  if ((long long)img.px.size() > cap) {
    set_err(err, err_len, "output larger than the buffer");
    return 0;
  }
  std::memcpy(out, img.px.data(), img.px.size() * 2);
  return 1;
}

}  // extern "C"
