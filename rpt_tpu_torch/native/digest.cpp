// The content hash of the scene digest's large leaves (mesh vertices and
// normals, an HDRI map): MurmurHash3_x64_128 with seed 0, Austin Appleby's
// public-domain algorithm (SMHasher), one contiguous buffer in, 16 bytes out
// (h1 then h2, each a little-endian 64-bit word, as the original writes
// them). It reads the caller's buffer in place, at memory speed; the
// Python side feeds the 16 bytes into the digest's blake2b stream.

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, sizeof v);  // unaligned-safe; one load at -O3
    return v;
}

}  // namespace

extern "C" void rpt_murmur3_x64_128(const void* key, int64_t len, void* out) {
    const uint8_t* data = static_cast<const uint8_t*>(key);
    const int64_t nblocks = len / 16;
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;
    uint64_t h1 = 0, h2 = 0;  // seed 0

    for (int64_t i = 0; i < nblocks; ++i) {
        uint64_t k1 = load64(data + 16 * i);
        uint64_t k2 = load64(data + 16 * i + 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }

    const uint8_t* tail = data + 16 * nblocks;
    uint64_t k1 = 0, k2 = 0;
    switch (len & 15) {
        case 15: k2 ^= uint64_t(tail[14]) << 48; [[fallthrough]];
        case 14: k2 ^= uint64_t(tail[13]) << 40; [[fallthrough]];
        case 13: k2 ^= uint64_t(tail[12]) << 32; [[fallthrough]];
        case 12: k2 ^= uint64_t(tail[11]) << 24; [[fallthrough]];
        case 11: k2 ^= uint64_t(tail[10]) << 16; [[fallthrough]];
        case 10: k2 ^= uint64_t(tail[9]) << 8; [[fallthrough]];
        case 9:
            k2 ^= uint64_t(tail[8]);
            k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
            [[fallthrough]];
        case 8: k1 ^= uint64_t(tail[7]) << 56; [[fallthrough]];
        case 7: k1 ^= uint64_t(tail[6]) << 48; [[fallthrough]];
        case 6: k1 ^= uint64_t(tail[5]) << 40; [[fallthrough]];
        case 5: k1 ^= uint64_t(tail[4]) << 32; [[fallthrough]];
        case 4: k1 ^= uint64_t(tail[3]) << 24; [[fallthrough]];
        case 3: k1 ^= uint64_t(tail[2]) << 16; [[fallthrough]];
        case 2: k1 ^= uint64_t(tail[1]) << 8; [[fallthrough]];
        case 1:
            k1 ^= uint64_t(tail[0]);
            k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }

    h1 ^= uint64_t(len);
    h2 ^= uint64_t(len);
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    h1 += h2;
    h2 += h1;
    std::memcpy(out, &h1, 8);
    std::memcpy(static_cast<uint8_t*>(out) + 8, &h2, 8);
}
