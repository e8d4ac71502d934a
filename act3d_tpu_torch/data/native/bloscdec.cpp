// Portable blosc1 container codec for the episode loader.
//
// A copy of act3d_tpu/data/native/bloscdec.cpp for the PyTorch port, which
// keeps its own copy of every host module it needs.  It replaces the
// reference's dependency on python-blosc (reference: datasets/utils.py:16-37
// reads `blosc.decompress(f.read())`; data_preprocessing/data_gen.py:136
// writes `blosc.compress(pickle.dumps(x))`).  The episode files are blosc1
// containers, typically blosclz-coded with byte-shuffle (python-blosc
// defaults).
//
// Implements:
//   * header parsing (16-byte blosc1 header)
//   * memcpy-mode containers (flag 0x2) — also what our packager writes,
//     giving bit-exact interop with python-blosc in both directions
//   * blosclz-coded blocks with split streams + byte unshuffle
//
// Build: g++ -O3 -shared -fPIC at first use (act3d_tpu_torch/data/native/
// __init__.py).  Exposed via ctypes.  Validated in tests against the system
// libblosc and the JAX package's decoder (tests/test_torch_data.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

constexpr int kHeaderSize = 16;
constexpr int kFlagShuffle = 0x1;
constexpr int kFlagMemcpy = 0x2;
constexpr int kFlagBitShuffle = 0x4;
constexpr int kMaxSplits = 16;
constexpr int kMinBufferSize = 128;

inline uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // blosc writes little-endian; assume LE host
}

// ---------------------------------------------------------------- blosclz
// Decompressor for blosclz streams (FastLZ-family LZ77), matching
// c-blosc 1.x blosclz.c `blosclz_decompress`.
int blosclz_decompress(const uint8_t* input, int length, uint8_t* output,
                       int maxout) {
  const uint8_t* ip = input;
  const uint8_t* ip_limit = input + length;
  uint8_t* op = output;
  uint8_t* op_limit = output + maxout;

  if (length <= 0) return 0;
  uint32_t ctrl = (*ip++) & 31;

  while (true) {
    if (ctrl >= 32) {
      // match
      int32_t len = (ctrl >> 5) - 1;
      int32_t ofs = (ctrl & 31) << 8;
      const uint8_t* ref = op - ofs - 1;

      if (len == 7 - 1) {
        // long match length: add bytes until != 255
        uint8_t code;
        do {
          if (ip >= ip_limit) return -1;
          code = *ip++;
          len += code;
        } while (code == 255);
      }
      if (ip >= ip_limit) return -1;
      uint8_t code = *ip++;
      len += 3;
      ref -= code;

      // far match: 16-bit extended distance
      if (code == 255 && ofs == (31 << 8)) {
        if (ip + 1 >= ip_limit) return -1;
        ofs = (*ip++) << 8;
        ofs += *ip++;
        ref = op - ofs - 8191 - 1;
      }

      if (op + len > op_limit) return -2;
      if (ref < output) return -3;
      // byte-wise copy: references may overlap the output cursor
      for (int32_t i = 0; i < len; i++) op[i] = ref[i];
      op += len;
    } else {
      // literal run of ctrl + 1 bytes
      int32_t run = ctrl + 1;
      if (op + run > op_limit) return -2;
      if (ip + run > ip_limit) return -1;
      std::memcpy(op, ip, run);
      op += run;
      ip += run;
    }
    if (ip >= ip_limit) break;
    ctrl = *ip++;
  }
  return static_cast<int>(op - output);
}

// ---------------------------------------------------------------- shuffle
// Byte-transpose inverse: shuffled lane-major -> original element-major.
void unshuffle(int typesize, int blocksize, const uint8_t* src, uint8_t* dst) {
  int nelem = blocksize / typesize;
  int leftover = blocksize % typesize;
  for (int j = 0; j < typesize; j++) {
    const uint8_t* s = src + j * nelem;
    for (int i = 0; i < nelem; i++) {
      dst[i * typesize + j] = s[i];
    }
  }
  if (leftover) {
    std::memcpy(dst + nelem * typesize, src + nelem * typesize, leftover);
  }
}

}  // namespace

extern "C" {

// Parse the header; returns 0 on success.
int blosc_portable_info(const uint8_t* src, int64_t srclen, int64_t* nbytes,
                        int64_t* cbytes, int* flags, int* typesize,
                        int64_t* blocksize) {
  if (srclen < kHeaderSize) return -1;
  *flags = src[2];
  *typesize = src[3];
  *nbytes = load_u32(src + 4);
  *blocksize = load_u32(src + 8);
  *cbytes = load_u32(src + 12);
  if (*cbytes > srclen) return -2;
  return 0;
}

// Decompress a full blosc1 container into dst (dstlen == nbytes).
// Returns 0 on success, negative error codes otherwise.
int blosc_portable_decompress(const uint8_t* src, int64_t srclen, uint8_t* dst,
                              int64_t dstlen) {
  int64_t nbytes, cbytes, blocksize;
  int flags, typesize;
  int rc = blosc_portable_info(src, srclen, &nbytes, &cbytes, &flags,
                               &typesize, &blocksize);
  if (rc != 0) return rc;
  if (dstlen < nbytes) return -3;
  if (nbytes == 0) return 0;

  if (flags & kFlagMemcpy) {
    if (srclen < kHeaderSize + nbytes) return -4;
    std::memcpy(dst, src + kHeaderSize, nbytes);
    return 0;
  }

  int codec = (flags >> 5) & 0x7;
  if (codec != 0 /* blosclz */) return -10 - codec;
  if (flags & kFlagBitShuffle) return -20;

  bool doshuffle = (flags & kFlagShuffle) && typesize > 1;
  int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  const uint8_t* bstarts = src + kHeaderSize;
  if (srclen < kHeaderSize + 4 * nblocks) return -5;

  uint8_t* tmp = static_cast<uint8_t*>(std::malloc(blocksize));
  if (!tmp) return -6;

  for (int64_t b = 0; b < nblocks; b++) {
    int64_t boffset = load_u32(bstarts + 4 * b);
    if (boffset + 4 > srclen) { std::free(tmp); return -7; }
    const uint8_t* bsrc = src + boffset;
    int64_t bsize = blocksize;
    bool leftoverblock = false;
    if ((b + 1) * blocksize > nbytes) {
      bsize = nbytes - b * blocksize;
      leftoverblock = true;
    }

    // split policy must mirror the compressor (c-blosc 1.x blosc_d):
    // one stream per typesize byte-lane when the block is full,
    // small-typed and big enough — regardless of shuffle — unless the
    // header's dont-split bit (0x10, c-blosc >= 1.14) is set.
    bool dont_split = (flags & 0x10) != 0;
    int nsplits = 1;
    if (!dont_split && typesize <= kMaxSplits &&
        blocksize / typesize >= kMinBufferSize && !leftoverblock) {
      nsplits = typesize;
    }
    int64_t neblock = bsize / nsplits;
    // shuffled blocks decode into tmp first, then unshuffle into dst;
    // this applies to EVERY block incl. the leftover one (the compressor
    // shuffles per-block before the split decision)
    uint8_t* out = doshuffle ? tmp : dst + b * blocksize;

    int64_t produced = 0;
    for (int s = 0; s < nsplits; s++) {
      if (bsrc + 4 > src + srclen) { std::free(tmp); return -7; }
      int32_t sc = static_cast<int32_t>(load_u32(bsrc));
      bsrc += 4;
      if (bsrc + sc > src + srclen) { std::free(tmp); return -7; }
      if (sc == 0) {
        // all-zeros split (c-blosc run-length special case)
        std::memset(out + produced, 0, neblock);
      } else if (sc == neblock) {
        std::memcpy(out + produced, bsrc, neblock);
      } else {
        int dec = blosclz_decompress(bsrc, sc, out + produced, neblock);
        if (dec != neblock) { std::free(tmp); return -8; }
      }
      bsrc += sc;
      produced += neblock;
    }

    if (doshuffle) {
      unshuffle(typesize, bsize, tmp, dst + b * blocksize);
    }
  }
  std::free(tmp);
  return 0;
}

// Write a memcpy-mode blosc1 container (readable by python-blosc).
// dst must have room for 16 + srclen bytes.  Returns total bytes written.
int64_t blosc_portable_pack_memcpy(const uint8_t* src, int64_t srclen,
                                   int typesize, uint8_t* dst) {
  dst[0] = 2;   // format version
  dst[1] = 1;   // blosclz version (unused in memcpy mode)
  dst[2] = kFlagMemcpy;
  dst[3] = static_cast<uint8_t>(typesize);
  uint32_t nbytes = static_cast<uint32_t>(srclen);
  uint32_t blocksize = nbytes;
  uint32_t cbytes = nbytes + kHeaderSize;
  std::memcpy(dst + 4, &nbytes, 4);
  std::memcpy(dst + 8, &blocksize, 4);
  std::memcpy(dst + 12, &cbytes, 4);
  std::memcpy(dst + kHeaderSize, src, srclen);
  return kHeaderSize + srclen;
}

}  // extern "C"
