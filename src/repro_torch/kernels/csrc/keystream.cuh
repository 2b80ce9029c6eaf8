// Counter-mode keystream shared by the port's cipher kernels (seal_bits.cu,
// seal_q8.cu). Port of keystream_u32 in src/repro/kernels/seal.py: an ARX
// mix of (key, counter, element index) in native uint32_t arithmetic, bit
// for bit the JAX function and the port's plain version
// (src/repro_torch/kernels/seal.py). Callers pass the flat row-major index
// computed in 64 bits and cast to uint32_t, which is JAX's uint32
// `row * cols + col` wrapped modulo 2**32.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t keystream_u32(uint32_t key, uint32_t ctr,
                                                  uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u;
  x ^= key + ctr * 0x85EBCA6Bu;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  x ^= x >> 16;
  // second squares round for diffusion
  x = x * (key | 1u) + ctr;
  x = (x ^ (x >> 15)) * 0x9E3779B9u;
  return x ^ (x >> 17);
}
