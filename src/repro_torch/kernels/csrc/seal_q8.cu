// Quantizing activation seal (seal / unseal) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_seal_kernel` (via `seal_pallas`) and
// `_unseal_kernel` (via `unseal_pallas`) in src/repro/kernels/seal.py.
// seal: per-row absmax int8 quantization, scale = max(absmax, 1e-6) / 127,
// q = clip(round_half_even(x / scale), -127, 127), then the low byte of q
// XORed with the top byte of keystream_u32(key, counter, flat_index); the
// f32 row scales go out beside the cipher as [rows, 1]. unseal: XOR back,
// sign-extend the byte, multiply by the row scale in f32, and cast to the
// output type with round-to-nearest-even.
//
// Matching the reference bit for bit: the quotient is IEEE division (the
// library builds without --use_fast_math, so `/` is correctly rounded, and
// there is no reciprocal multiply); rounding is rintf, half to even like
// jnp.round (roundf would round ties away from zero); the absmax is a max,
// exact in any reduction order. The flat index is taken in 64 bits and cast
// to uint32_t, as in seal_bits.cu, so the keystream is the reference's.
//
// What bounds it on this card: at the pipeline boundary's shape ([4, 2048]
// bf16: 16 KB in, 8 KB + 16 B out) neither bytes (about 7 ns at 3.35 TB/s)
// nor integer operations (about 12 ns) — a launch costs microseconds, so
// latency does. The design is the simple one: one block per row, a
// block-wide absmax (warp shuffles, then shared memory) and a second pass
// over the row, which the first pass left in L1/L2. unseal is elementwise,
// grid-stride.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keystream.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <typename T>
__global__ void seal_q8_kernel(const T* __restrict__ x,
                               uint8_t* __restrict__ cipher,
                               float* __restrict__ scales, int cols,
                               uint32_t key, uint32_t ctr) {
  __shared__ float partial[32];
  __shared__ float row_scale;
  const int row = blockIdx.x;
  const long long base = (long long)row * cols;
  const T* xr = x + base;

  float m = 0.f;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    m = fmaxf(m, fabsf(to_f32(xr[c])));
  m = warp_max(m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    m = warp_max(lane < n_warps ? partial[lane] : 0.f);
    if (lane == 0) {
      const float s = fmaxf(m, 1e-6f) / 127.f;
      row_scale = s;
      scales[row] = s;
    }
  }
  __syncthreads();
  const float scale = row_scale;

  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const float q = fminf(fmaxf(rintf(to_f32(xr[c]) / scale), -127.f), 127.f);
    const uint32_t ks = keystream_u32(key, ctr, (uint32_t)(base + c));
    cipher[base + c] = (uint8_t)(((uint32_t)(int)q & 0xFFu) ^ (ks >> 24));
  }
}

template <typename T>
__global__ void unseal_q8_kernel(const uint8_t* __restrict__ cipher,
                                 const float* __restrict__ scales,
                                 T* __restrict__ out, long long n, int cols,
                                 uint32_t key, uint32_t ctr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t ks = keystream_u32(key, ctr, (uint32_t)i);
    const int q = (int)(int8_t)(uint8_t)(cipher[i] ^ (uint8_t)(ks >> 24));
    out[i] = from_f32<T>((float)q * scales[i / cols]);
  }
}

constexpr int kThreads = 256;

}  // namespace

// Plain C entries (loaded with ctypes). x / out hold rows*cols contiguous
// elements of elem_bytes (4: f32, 2: bf16); cipher is uint8 [rows, cols],
// scales f32 [rows, 1]. Each returns the launch's cudaError_t.
extern "C" int repro_seal_q8(const void* x, void* cipher, void* scales,
                             int rows, int cols, unsigned int key,
                             unsigned int ctr, int elem_bytes, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    seal_q8_kernel<float><<<rows, kThreads, 0, s>>>(
        (const float*)x, (uint8_t*)cipher, (float*)scales, cols, key, ctr);
  } else if (elem_bytes == 2) {
    seal_q8_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (uint8_t*)cipher, (float*)scales, cols, key,
        ctr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_unseal_q8(const void* cipher, const void* scales,
                               void* out, int rows, int cols,
                               unsigned int key, unsigned int ctr,
                               int out_elem_bytes, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)rows * cols;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond that
  if (out_elem_bytes == 4) {
    unseal_q8_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)cipher, (const float*)scales, (float*)out, n, cols,
        key, ctr);
  } else if (out_elem_bytes == 2) {
    unseal_q8_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)cipher, (const float*)scales, (__nv_bfloat16*)out, n,
        cols, key, ctr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
