// Host-side parse of the chunk program's bundle rows
// (fastpath.FastChunkPipeline._decode_segments).
//
// A row is ROW_BYTES = 40 bytes: 36 bytes of the kind's packed sections
// (most significant bit first), flags (kind in bits 0-1, okA bit 2, okB
// bit 3, valid bit 4), delta, carrier low byte, carrier high byte. One
// pass expands each row to the canonical 408-byte payload (A 268 | B 124
// | BBK 14 | 2 bytes left 0), one byte a bit, and splits the trailer.
#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the bit table stores a byte's bits as a little-endian word");

namespace {

constexpr int kSecBytes = 36;
constexpr int kRowBytes = 40;
constexpr int kPayload = 408;

// byte -> its 8 bits, most significant first, one 0/1 byte each (the
// order of numpy's unpackbits)
struct BitTable {
  uint64_t w[256];
  constexpr BitTable() : w() {
    for (int v = 0; v < 256; ++v) {
      uint64_t x = 0;
      for (int j = 0; j < 8; ++j)
        x |= uint64_t((v >> (7 - j)) & 1) << (8 * j);
      w[v] = x;
    }
  }
};
constexpr BitTable kBits;

// Unpack the first Bytes section bytes of a row to sec, one byte a bit.
template <int Bytes>
inline void unpack(const uint8_t* r, uint8_t* sec) {
  for (int b = 0; b < Bytes; ++b) std::memcpy(sec + 8 * b, &kBits.w[r[b]], 8);
}

// One row's payload: the kind's packed sections to their places in the
// canonical layout (A at 0, B at 268, BBK at 392), every other byte 0.
// Constant offsets and lengths let the compiler inline each copy.
inline void expand(int k, const uint8_t* r, uint8_t* out) {
  alignas(8) uint8_t sec[kSecBytes * 8];
  switch (k) {
    case 0:  // SYNC: SB1 60, SB2 124, BBK 14
      unpack<25>(r, sec);
      std::memcpy(out, sec, 60);
      std::memset(out + 60, 0, 208);
      std::memcpy(out + 268, sec + 60, 124);
      std::memcpy(out + 392, sec + 184, 14);
      break;
    case 1:  // SCH/F 268, BBK 14
      unpack<36>(r, sec);
      std::memcpy(out, sec, 268);
      std::memset(out + 268, 0, 124);
      std::memcpy(out + 392, sec + 268, 14);
      break;
    case 2:  // NDB: both halves 124 each, BBK 14
      unpack<33>(r, sec);
      std::memcpy(out, sec, 124);
      std::memset(out + 124, 0, 144);
      std::memcpy(out + 268, sec + 124, 124);
      std::memcpy(out + 392, sec + 248, 14);
      break;
    default:
      std::memset(out, 0, 406);
  }
  out[406] = out[407] = 0;
}

}  // namespace

// Parse n contiguous rows into payload [n, 408] and the per-row int32
// fields; every byte of the outputs is written. Returns the number of
// rows whose valid bit is clear (the caller raises if it is not 0).
extern "C" int64_t tt_parse_rows(const uint8_t* rows, int64_t n,
                                 uint8_t* payload, int32_t* carrier,
                                 int32_t* ok_a, int32_t* ok_b,
                                 int32_t* kind, int32_t* delta) {
  int64_t invalid = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* r = rows + i * kRowBytes;
    const int f = r[kSecBytes];
    const int k = f & 3;
    expand(k, r, payload + i * kPayload);
    carrier[i] = r[kSecBytes + 2] | (r[kSecBytes + 3] << 8);
    ok_a[i] = (f >> 2) & 1;
    ok_b[i] = (f >> 3) & 1;
    kind[i] = k;
    delta[i] = r[kSecBytes + 1];
    invalid += !(f & 16);
  }
  return invalid;
}
