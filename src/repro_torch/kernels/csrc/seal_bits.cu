// Lossless page cipher (seal_bits / unseal_bits) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bits_kernel` (via `_bits_pallas`,
// `seal_bits_pallas`, `unseal_bits_pallas`) in src/repro/kernels/seal.py.
// Each element's float bits (f32 -> u32, bf16 -> u16) are XORed with
// keystream_u32(key, counter, flat_index) truncated to the element width.
// XOR is an involution, so one kernel both seals and unseals, bit-exactly.
//
// What bounds it on this card. At the swap path's [10, 131072] bf16 the
// bytes (2.6 MB each way, found in L2: the pages were just gathered) take
// less time than the integer work, one 32-bit ARX mix per 2-byte element,
// and both less than a launch. The mix is bound by instruction issue (one
// warp instruction per cycle per SM sub-partition), not by one pipe: moving
// shifts from the ALU pipe to the FMA pipe (IMAD.HI) made it no faster, so
// what counts is the total number of instructions per element. The earlier
// design evaluated the plain mix element by element with 64-bit indexing.
//
// Design.
//   - The mix runs in the form of keystream.cuh, with its constants
//     formed by each thread from the key and counter it loads from device
//     memory (two loads issued beside the data's, then three integer
//     operations): a = idx0 * M1 + j * M1 per lane j, the key
//     folded in one LOP3, the last xorshift folded into the data XOR. For
//     bf16 the low halves of two lanes' words are packed by PRMT (two per
//     pair: the words and their >> 17) and XORed into the data word with
//     one LOP3. Indices are 32-bit. Per element this is 5 SHF, 4 IMAD,
//     4.5 LOP3, 1 PRMT and an add in bf16.
//   - One 16-byte vector (4 u32 or 8 u16 elements) per thread, neighbouring
//     threads on neighbouring vectors; the data load issues beside the key
//     and counter loads, and the keystream, which depends on the index and
//     the key, never on the data, is computed while the data is in flight. Two or four vectors per thread, with
//     their chains interleaved, measured no faster: fewer warps per SM
//     hide less of each chain's latency.
//   - The launch plan (threads per block, blocks) comes from the wrapper
//     (`ops._cipher_plan`): blocks of 256 threads, measured faster at the
//     swap path's size than 128 or 512.
//   - The element index is (uint32_t)item * VEC + j, exactly JAX's uint32
//     `row * cols + col` wrapped modulo 2**32: the same bits in any tiling
//     and the same bits as the reference, so payloads seal in one package
//     and unseal in the other.
//   - Up to VEC - 1 tail elements past the last whole vector go to the
//     first threads, one each. When a pointer is not 16-byte aligned the
//     item is one element (scalar loads) and there is no tail.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "keystream.cuh"

namespace {

// Bits of element `idx`'s keystream word that XOR into an element of T.
template <typename T>
__device__ __forceinline__ T keystream_elem(const KeystreamConsts& kc,
                                            uint32_t idx) {
  const uint32_t p = keystream_pre(kc, idx * kM1);
  return (T)(p ^ (p >> 17));
}

// One 16-byte vector of elements starting at index idx0, XORed in place.
template <typename T>
__device__ __forceinline__ void xor_vector(const KeystreamConsts& kc,
                                           uint32_t idx0, uint4& v) {
  const uint32_t a0 = idx0 * kM1;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      const uint32_t p = keystream_pre(kc, a0 + (uint32_t)j * kM1);
      w[j] ^= p ^ (p >> 17);
    } else {
      const uint32_t p0 = keystream_pre(kc, a0 + (uint32_t)(2 * j) * kM1);
      const uint32_t p1 =
          keystream_pre(kc, a0 + (uint32_t)(2 * j + 1) * kM1);
      // low halves of p0 ^ (p0 >> 17) and p1 ^ (p1 >> 17), packed
      w[j] ^= __byte_perm(p0, p1, 0x5410) ^
              __byte_perm(p0 >> 17, p1 >> 17, 0x5410);
    }
  }
}

// Thread g XORs item g (a 16-byte vector when VEC, else one element) and,
// when g < tail, tail element items * VEC + g.
template <typename T, bool VEC>
__global__ void bits_xor_kernel(const T* __restrict__ in, T* __restrict__ out,
                                int items, int tail,
                                const long long* __restrict__ key,
                                const long long* __restrict__ ctr) {
  constexpr uint32_t kPer = VEC ? 16 / sizeof(T) : 1;  // elements per item
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < items) {
    if constexpr (VEC) {
      uint4 v = reinterpret_cast<const uint4*>(in)[g];
      const KeystreamConsts kc = load_keystream_consts(key, ctr);
      xor_vector<T>(kc, (uint32_t)g * kPer, v);
      reinterpret_cast<uint4*>(out)[g] = v;
    } else {
      const T x = in[g];
      out[g] = x ^ keystream_elem<T>(load_keystream_consts(key, ctr),
                                     (uint32_t)g);
    }
  }
  if (g < tail) {
    const long long i = (long long)items * kPer + g;
    out[i] = in[i] ^ keystream_elem<T>(load_keystream_consts(key, ctr),
                                       (uint32_t)i);
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, int items, int tail,
                   const long long* key, const long long* ctr, bool vec,
                   int threads, int blocks, cudaStream_t s) {
  if (vec)
    bits_xor_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)in, (T*)out, items, tail, key, ctr);
  else
    bits_xor_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)in, (T*)out, items, tail, key, ctr);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (loaded with ctypes). `in` and `out` hold n contiguous
// elements of elem_bytes (2 or 4) each; `key` and `ctr` each point at one
// int64 in device memory, read by the kernel (its low 32 bits); vec_ok != 0
// promises both data pointers are 16-byte aligned. The plan (threads per block, blocks) must give a
// thread to every item and tail element, with fewer than 2**31 threads; it
// is checked here. Returns the launch's cudaError_t.
extern "C" int repro_bits_xor(const void* in, void* out, long long n,
                              const void* key, const void* ctr,
                              int elem_bytes, int vec_ok, int threads,
                              int blocks, void* stream) {
  if (n <= 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  if (!key || !ctr || (uintptr_t)key % 8 || (uintptr_t)ctr % 8)
    return (int)cudaErrorInvalidValue;
  const long long* k = (const long long*)key;
  const long long* c = (const long long*)ctr;
  const int per = vec_ok ? 16 / elem_bytes : 1;
  const long long items = n / per;
  const int tail = (int)(n - items * per);
  const long long grid = (long long)blocks * threads;
  if (threads <= 0 || blocks <= 0 || grid < items || grid < tail ||
      grid > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return (int)launch<uint32_t>(in, out, (int)items, tail, k, c, vec_ok != 0,
                                 threads, blocks, s);
  return (int)launch<uint16_t>(in, out, (int)items, tail, k, c, vec_ok != 0,
                               threads, blocks, s);
}
