// Lossless page cipher (seal_bits / unseal_bits) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bits_kernel` (via `_bits_pallas`,
// `seal_bits_pallas`, `unseal_bits_pallas`) in src/repro/kernels/seal.py.
// Each element's float bits (f32 -> u32, bf16 -> u16) are XORed with
// keystream_u32(key, counter, flat_index) truncated to the element width.
// XOR is an involution, so one kernel both seals and unseals, bit-exactly.
//
// What bounds it on this card: bytes. Every element is read once and
// written once; the ARX mix is ~18 32-bit integer operations per element,
// which the SMs' INT32 lanes retire faster than HBM delivers f32 data and
// about as fast as it delivers bf16 data.
//
// Design. A grid-stride loop in which each thread moves 16 bytes (four u32
// or eight u16 elements) with one vector load and one vector store, so
// neighbouring threads touch neighbouring 16-byte chunks; a scalar loop
// covers the tail (and the whole array when a pointer is not 16-byte
// aligned). The flat index is computed in 64 bits and cast to uint32_t
// before the mix, which is exactly JAX's uint32 `row * cols + col`
// wrapped modulo 2**32: the same bits in any tiling, and the same bits as
// the reference, so payloads seal in one package and unseal in the other.
#include <cuda_runtime.h>
#include <stdint.h>

#include "keystream.cuh"

namespace {

template <typename T>
__global__ void bits_xor_kernel(const T* __restrict__ in, T* __restrict__ out,
                                long long n, long long n_vec, uint32_t key,
                                uint32_t ctr) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = tid; v < n_vec; v += stride) {
    uint4 raw = reinterpret_cast<const uint4*>(in)[v];
    T* e = reinterpret_cast<T*>(&raw);
    const long long base = v * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e[j] ^= (T)keystream_u32(key, ctr, (uint32_t)(base + j));
    reinterpret_cast<uint4*>(out)[v] = raw;
  }
  for (long long i = n_vec * VEC + tid; i < n; i += stride)
    out[i] = in[i] ^ (T)keystream_u32(key, ctr, (uint32_t)i);
}

}  // namespace

// Plain C entry (loaded with ctypes). `in` and `out` hold n contiguous
// elements of elem_bytes (2 or 4) each; vec_ok != 0 promises both pointers
// are 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int repro_bits_xor(const void* in, void* out, long long n,
                              unsigned int key, unsigned int ctr,
                              int elem_bytes, int vec_ok, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = 16 / elem_bytes;
  const long long n_vec = vec_ok ? n / vec : 0;
  const long long work = n_vec + (n - n_vec * vec);
  const int threads = 256;
  long long blocks = (work + threads - 1) / threads;
  // grid-stride beyond 16 blocks per SM of an H100 (132 SMs)
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (elem_bytes == 4) {
    bits_xor_kernel<uint32_t><<<(unsigned)blocks, threads, 0, s>>>(
        (const uint32_t*)in, (uint32_t*)out, n, n_vec, key, ctr);
  } else if (elem_bytes == 2) {
    bits_xor_kernel<uint16_t><<<(unsigned)blocks, threads, 0, s>>>(
        (const uint16_t*)in, (uint16_t*)out, n, n_vec, key, ctr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
