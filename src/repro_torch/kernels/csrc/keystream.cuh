// Counter-mode keystream shared by the port's cipher kernels (seal_bits.cu,
// seal_q8.cu). Port of keystream_u32 in src/repro/kernels/seal.py: an ARX
// mix of (key, counter, element index) in native uint32_t arithmetic, bit
// for bit the JAX function and the port's plain version
// (src/repro_torch/kernels/seal.py). Callers pass the flat row-major index
// taken modulo 2**32, which is JAX's uint32 `row * cols + col`.
//
// The mix is written in an equivalent form with fewer instructions per
// element, by exact uint32 identities (tests/test_torch_cipher_mix.py holds
// a numpy transcription of this form against both packages' functions):
//   - x = idx * M1 ^ K, then x ^ (x >> 16), with K = key + ctr * M2, is
//     a ^ (a >> 16) ^ K', with a = idx * M1 and K' = K ^ (K >> 16) hoisted
//     (shifts distribute over XOR): one SHF and one 3-input LOP3;
//   - a caller that walks consecutive indices forms a = idx0 * M1 + j * M1
//     with j * M1 a compile-time constant;
//   - the last step x ^ (x >> 17) is left to the caller, which folds it
//     into its own XOR with the data (one LOP3), or drops it where only the
//     top byte is used: (x ^ (x >> 17)) >> 24 == x >> 24, since x >> 17
//     has no bit at or above bit 15.
#pragma once
#include <stdint.h>

constexpr uint32_t kM1 = 0x9E3779B9u;  // golden-ratio odd constants
constexpr uint32_t kM2 = 0x85EBCA6Bu;
constexpr uint32_t kM3 = 0xC2B2AE35u;

// Per-launch constants of the mix. Each block forms them itself from the key
// and counter it loads from device memory (`load_keystream_consts`), as the
// Pallas kernels read `key_ref[0]` / `ctr_ref[0]`: a launch captured in a CUDA
// graph then ciphers under whatever key and counter the buffers hold when it
// is replayed.
struct KeystreamConsts {
  uint32_t k1;    // K ^ (K >> 16), K = key + ctr * M2
  uint32_t kmul;  // key | 1
  uint32_t ctr;
};

__host__ __device__ __forceinline__ KeystreamConsts keystream_consts(
    uint32_t key, uint32_t ctr) {
  const uint32_t k = key + ctr * kM2;
  return {k ^ (k >> 16), key | 1u, ctr};
}

// Key and counter as the kernels take them: one int64 each in device memory
// (the wrappers' one-element int64 tensors), truncated to uint32 as the
// reference takes its uint32 key and counter. One load each (all threads of a
// warp read one address), then the three integer operations of
// keystream_consts.
__device__ __forceinline__ KeystreamConsts load_keystream_consts(
    const long long* __restrict__ key, const long long* __restrict__ ctr) {
  return keystream_consts((uint32_t)__ldg(key), (uint32_t)__ldg(ctr));
}

// The mix from a = idx * M1 up to, not including, its last xorshift:
// keystream_u32(key, ctr, idx) == p ^ (p >> 17) with p this value.
__device__ __forceinline__ uint32_t keystream_pre(const KeystreamConsts& c,
                                                  uint32_t a) {
  uint32_t x = (a ^ (a >> 16) ^ c.k1) * kM2;
  x = (x ^ (x >> 13)) * kM3;
  x ^= x >> 16;
  // second squares round for diffusion
  x = x * c.kmul + c.ctr;
  return (x ^ (x >> 15)) * kM1;
}
