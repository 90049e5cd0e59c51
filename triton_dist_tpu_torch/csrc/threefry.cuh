// JAX's threefry2x32 key stream on the card: the hash, the key of a seed,
// fold_in, split and the random bits of a draw, bitwise the JAX
// package's (jax/_src/prng.py threefry2x32 with jax_threefry_partitionable
// on: a draw's element i is hashed at the counter (hi(i), lo(i)), its bits
// the xor of the two words) and the port's plain version
// (kernels/sample.py threefry2x32). Pure 32-bit integer code.

#pragma once

#include <stdint.h>

namespace threefry {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The hash of the counter (x0, x1) under the key (k0, k1): 20 rounds in
// five groups of four, a key injection after each group.
__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t& x0,
                                     uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
}

// fold_in(key, d) and split(key)[d] alike: the hash of the counter (0, d).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  hash(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// The 32 random bits of element i of a draw under (k0, k1).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint64_t i) {
  uint32_t x0 = uint32_t(i >> 32), x1 = uint32_t(i);
  hash(k0, k1, x0, x1);
  return x0 ^ x1;
}

}  // namespace threefry
