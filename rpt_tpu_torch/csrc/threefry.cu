// threefry2x32, the port's PRNG (rpt_tpu_torch/random.py), for NVIDIA Hopper
// (sm_90a).
//
// No TPU kernel stands behind this one: the JAX package draws through
// jax.random, whose threefry XLA fuses into the surrounding computation by
// itself. Eager PyTorch ran the same hash as some 120 separate int64
// elementwise kernels per draw (20 rounds of add, rotate and xor, each
// masked to 32 bits), which made the PRNG the largest share of a render's
// device time. Here one thread hashes one counter in 32-bit registers and
// writes its result once.
//
// What it computes: under the key (k1, k2), the threefry2x32 hash of the
// counter pairs (0, c + i) for i < n, c = c0 + *counter (the counter is
// optional and lives in device memory, so a CUDA graph that advances it draws
// a new sample's numbers on every replay; the key may be read from device
// memory for the same reason). Six ways to write it, as
// random.threefry_plain does:
//   kKeys    both words, (n, 2) int64: split / fold_in of a tensor key;
//   kBits    their xor, (n,) int64: 32 random bits per element;
//   kUniform those bits as float32 in [lo, lo + span): the 23 high bits as a
//            mantissa under exponent 0, minus one, then floats * span + lo in
//            ONE rounding (__fmaf_rn, which -fmad=false leaves alone), as XLA
//            contracts it and as the plain version gets it through an f64 add;
//            then max(., lo);
//   kRandint jax.random.randint's int32: the key split in two (counters
//            (0, 0) and (0, 1)), one bit stream under each, combined modulo
//            the span in uint32 arithmetic;
//   kUniform64  jax.random.uniform's float64 (under jax_enable_x64): the 64
//            bits x1 << 32 | x2, their top 52 as a mantissa under exponent 0,
//            minus one, then floats * span + lo in one rounding (__fma_rn, as
//            XLA contracts it; the plain version emulates it exactly), then
//            max(., lo);
//   kRandint64  jax.random.randint's int64: as kRandint with 64-bit streams
//            x1 << 32 | x2 and uint64 arithmetic, the span anywhere in
//            [1, 2^64). Its key split is hashed once per block, and its
//            remainders are taken by a multiply-high (below).
// lo and span come in as doubles; the float32 mode rounds them to float (the
// wrapper passes float32 values, so the rounding is exact).
//
// What bounds it on this card: 72 32-bit integer operations per hash (the
// third key word is one three-way xor; x1 starts at 0, so its first key
// injection is a move; 20 steps of add, rotate (one funnel shift) and xor;
// the other key injections are one add for x1 and one three-input add for
// x2), against 4-16 bytes written per element, so the integer rate bounds a
// large draw, not the memory; a small draw (a key) is all launch. kBits adds
// an xor, kUniform an xor, a shift and an or, and three float32 operations.
// kRandint hashes twice per element, plus the two hashes of its key split,
// which are the same in every thread. kUniform64 writes 8 bytes per element
// and adds a shift, two ors and three float64 operations (the FP64 rate is
// half the FP32 rate, still far above what 72 integer operations take);
// kRandint64 hashes twice per element, as kRandint, with three 64-bit
// remainders (its key split: below). The
// kernel keeps the words in registers and writes each output once,
// coalesced.
//
// kRandint64's design. The card has no 64-bit divide: a 64-bit `%` by a
// span known only at run time is a called routine of several dozen
// instructions with branches, and the mode took three, beside the two
// hashes of its key split that every thread made again (1.45x kRandint's
// time, PERF.md). Here threads 0 and 1 of each block hash one half of the
// split each into shared memory, before any thread of the block leaves;
// and each remainder is x - q * span, q = x / span by the multiply-high of
// Granlund and Montgomery ("Division by invariant integers using
// multiplication", PLDI 1994, Figure 4.1): with l = ceil(log2 span),
// m = floor(2^64 (2^l - span) / span) + 1 < 2^64, t = umulhi(x, m),
// q = (t + ((x - t) >> min(l, 1))) >> max(l - 1, 0) is exact for every
// 64-bit x and every span in [1, 2^64) (span 1: m = 1, q = x; a power of
// two: m = 1, q = x >> l). The host computes (m, min(l, 1), max(l - 1, 0))
// once per draw (random.py `_reciprocal`). kRandint keeps its own code.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown mode, a span of 0 or shifts out of range). (magic, sh1, sh2) is
// the reciprocal of rspan, read by kRandint64 alone. The kernel adds one to
// `launches` when it runs, unless it is null (count.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"  // count_launch

namespace {

constexpr int kBlock = 256;
enum Mode { kKeys = 0, kBits = 1, kUniform = 2, kRandint = 3, kUniform64 = 4, kRandint64 = 5 };

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) { return (v << r) | (v >> (32 - r)); }

__device__ __forceinline__ void mix4(uint32_t& x1, uint32_t& x2, int a, int b, int c, int d) {
  x1 += x2; x2 = rotl(x2, a); x2 ^= x1;
  x1 += x2; x2 = rotl(x2, b); x2 ^= x1;
  x1 += x2; x2 = rotl(x2, c); x2 ^= x1;
  x1 += x2; x2 = rotl(x2, d); x2 ^= x1;
}

// jax/_src/prng.py `_threefry2x32_lowering`: 20 rounds, a key injection
// after every four.
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x1, uint32_t& x2) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x1 += k1; x2 += k2;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k2; x2 += k3 + 1u;
  mix4(x1, x2, 17, 29, 16, 24); x1 += k3; x2 += k1 + 2u;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k1; x2 += k2 + 3u;
  mix4(x1, x2, 17, 29, 16, 24); x1 += k2; x2 += k3 + 4u;
  mix4(x1, x2, 13, 15, 26, 6);  x1 += k3; x2 += k1 + 5u;
}

__device__ __forceinline__ uint32_t bits(uint32_t k1, uint32_t k2, uint32_t c) {
  uint32_t x1 = 0u, x2 = c;
  threefry(k1, k2, x1, x2);
  return x1 ^ x2;
}

// The 64 random bits of counter c: both words, the first high
// (`_threefry_random_bits_partitionable` with bit_width 64).
__device__ __forceinline__ uint64_t bits64(uint32_t k1, uint32_t k2, uint32_t c) {
  uint32_t x1 = 0u, x2 = c;
  threefry(k1, k2, x1, x2);
  return ((uint64_t)x1 << 32) | x2;
}

// x % d by the multiply-high reciprocal (m, sh1, sh2) of d (above).
__device__ __forceinline__ uint64_t urem(uint64_t x, uint64_t d, uint64_t m, int sh1, int sh2) {
  const uint64_t t = __umul64hi(x, m);
  return x - ((t + ((x - t) >> sh1)) >> sh2) * d;
}

template <int kMode>
__global__ void __launch_bounds__(kBlock)
threefry_kernel(const int64_t* __restrict__ key, uint32_t k1, uint32_t k2, const int64_t* __restrict__ counter,
                uint32_t c0, int64_t n, void* __restrict__ out, double lo, double span, int64_t minval,
                uint64_t rspan, uint64_t mult, uint64_t magic, int sh1, int sh2, unsigned long long* launches) {
  count_launch(launches);
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if constexpr (kMode == kRandint64) {
    // The key split: thread s < 2 hashes the counter pair (0, s) into
    // split[2s], split[2s + 1], before any thread of the block leaves.
    __shared__ uint32_t split[4];
    if (threadIdx.x < 2) {
      if (key != nullptr) {
        k1 = (uint32_t)key[0];
        k2 = (uint32_t)key[1];
      }
      uint32_t x1 = 0u, x2 = threadIdx.x;
      threefry(k1, k2, x1, x2);
      split[2 * threadIdx.x] = x1;
      split[2 * threadIdx.x + 1] = x2;
    }
    __syncthreads();
    if (i >= n) return;
    const uint32_t c = c0 + (counter != nullptr ? (uint32_t)*counter : 0u) + (uint32_t)i;
    uint64_t off = urem(bits64(split[0], split[1], c), rspan, magic, sh1, sh2) * mult;
    off += urem(bits64(split[2], split[3], c), rspan, magic, sh1, sh2);
    off = urem(off, rspan, magic, sh1, sh2);
    reinterpret_cast<int64_t*>(out)[i] = (int64_t)((uint64_t)minval + off);
    return;
  }
  if (i >= n) return;
  if (key != nullptr) {
    k1 = (uint32_t)key[0];
    k2 = (uint32_t)key[1];
  }
  const uint32_t c = c0 + (counter != nullptr ? (uint32_t)*counter : 0u) + (uint32_t)i;
  if constexpr (kMode == kKeys) {
    uint32_t x1 = 0u, x2 = c;
    threefry(k1, k2, x1, x2);
    reinterpret_cast<longlong2*>(out)[i] = make_longlong2((long long)x1, (long long)x2);
  } else if constexpr (kMode == kBits) {
    reinterpret_cast<int64_t*>(out)[i] = (int64_t)bits(k1, k2, c);
  } else if constexpr (kMode == kUniform) {
    const float lo_f = (float)lo;
    const float f = __uint_as_float((bits(k1, k2, c) >> 9) | 0x3F800000u) - 1.0f;
    reinterpret_cast<float*>(out)[i] = fmaxf(__fmaf_rn(f, (float)span, lo_f), lo_f);
  } else if constexpr (kMode == kUniform64) {
    const double f = __longlong_as_double((long long)((bits64(k1, k2, c) >> 12) | 0x3FF0000000000000ull)) - 1.0;
    reinterpret_cast<double*>(out)[i] = fmax(__fma_rn(f, span, lo), lo);
  } else if constexpr (kMode == kRandint) {
    const uint32_t rs = (uint32_t)rspan;
    uint32_t h1 = 0u, h2 = 0u, l1 = 0u, l2 = 1u;
    threefry(k1, k2, h1, h2);
    threefry(k1, k2, l1, l2);
    uint32_t off = (bits(h1, h2, c) % rs) * (uint32_t)mult;
    off += bits(l1, l2, c) % rs;
    off %= rs;
    reinterpret_cast<int32_t*>(out)[i] = (int32_t)((uint32_t)minval + off);
  }
}

}  // namespace

extern "C" {

int rpt_threefry(int mode, const int64_t* key, uint32_t k1, uint32_t k2, const int64_t* counter, uint32_t c0,
                 int64_t n, void* out, double lo, double span, int64_t minval, uint64_t rspan, uint64_t mult,
                 uint64_t magic, int sh1, int sh2, unsigned long long* launches, void* stream) {
  if (n <= 0) return 0;
  if (rspan == 0u || sh1 < 0 || sh1 > 1 || sh2 < 0 || sh2 > 63) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto kernel) {
    kernel<<<grid, kBlock, 0, s>>>(key, k1, k2, counter, c0, n, out, lo, span, minval, rspan, mult, magic, sh1,
                                   sh2, launches);
  };
  switch (mode) {
    case kKeys: go(threefry_kernel<kKeys>); break;
    case kBits: go(threefry_kernel<kBits>); break;
    case kUniform: go(threefry_kernel<kUniform>); break;
    case kRandint: go(threefry_kernel<kRandint>); break;
    case kUniform64: go(threefry_kernel<kUniform64>); break;
    case kRandint64: go(threefry_kernel<kRandint64>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
