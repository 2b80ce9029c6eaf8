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
// exact in any reduction order. The flat index is row * cols + col modulo
// 2**32, as in seal_bits.cu, so the keystream is the reference's.
//
// What bounds it on this card: at the pipeline boundary's shape ([4, 2048]
// bf16: 16 KB in, 8 KB + 16 B out, and the reverse for unseal) neither
// bytes (about 7 ns at 3.35 TB/s) nor integer operations (about 11 ns): a
// launch costs microseconds, and past it the latency of one block's chain
// decides (seal: load, block-wide max, divide, store; unseal: load, XOR,
// multiply, store). The earlier seal read each row twice with 2-byte
// loads, 8 elements a thread in series, around two barriers.
//
// seal's design, to shorten that chain:
//   - one block per row; each thread holds 4 consecutive elements in
//     registers from one 8-byte (bf16) or 16-byte (f32) load, so the row
//     is read once (512 threads for the boundary's 2048 columns: 8
//     elements a thread with 256 threads measured slower); the threads per
//     block come from the wrapper (`ops._seal_threads`);
//   - the keystream's top bytes are computed while the loads are in flight
//     (they depend on the index and the key only; each thread forms the
//     mix's constants from the key and counter it loads from device memory
//     beside the row's data), packed into a word by PRMT;
//   - the block absmax takes warp shuffles, one shared-memory exchange and
//     one __syncthreads; every warp then reduces the warps' maxima itself;
//   - the cipher bytes go out in one 4-byte store per thread;
//   - a row not so aligned, or whose width is not a multiple of 4, takes
//     scalar loads and byte stores with the same ownership; a row wider
//     than one tile (threads x 4) reads its later tiles again.
// unseal's design, with no reduction to wait for:
//   - a 2-D grid: blockIdx.y (and z past 65535 rows) is the row, blockIdx.x
//     a tile of threads x 4 columns (plan from `ops._unseal_plan`); each
//     thread owns 4 consecutive columns, found from the block indices in
//     32-bit arithmetic: no loop and no division;
//   - one 4-byte load of cipher bytes, one XOR with the same packed
//     keystream top bytes as the seal's, four sign-extended bytes, four
//     f32 multiplies by the row's scale (one load, one address per block),
//     one 8-byte (bf16) or 16-byte (f32) store;
//   - an unaligned cipher view, or a width not a multiple of 4, takes byte
//     loads and element stores with the same ownership;
//   - what is left on an H100 is the launch: at [4, 2048] bf16 unseal
//     takes about 0.2 us more than a one-element zero_() (PERF.md).
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

constexpr int kEpt = 4;  // elements a thread holds

// kEpt elements of one row at columns c .. c + 3, as f32; zero past the
// row's end. VEC: the row is 16-byte aligned (f32) or 8-byte aligned
// (bf16) and cols is a multiple of 4, so a thread's elements are one 16-
// or 8-byte load and lie wholly inside or wholly past the row.
template <typename T, bool VEC>
__device__ __forceinline__ void load_elems(const T* __restrict__ xr, int c,
                                           int cols, float (&v)[kEpt]) {
  if constexpr (VEC) {
    if (c >= cols) {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    } else if constexpr (sizeof(T) == 2) {
      // bf16 -> f32 is exact: the bits shifted up by 16
      const uint2 r = *reinterpret_cast<const uint2*>(xr + c);
      v[0] = __uint_as_float(r.x << 16);
      v[1] = __uint_as_float(r.x & 0xFFFF0000u);
      v[2] = __uint_as_float(r.y << 16);
      v[3] = __uint_as_float(r.y & 0xFFFF0000u);
    } else {
      const float4 r = *reinterpret_cast<const float4*>(xr + c);
      v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kEpt; ++e)
      v[e] = c + e < cols ? to_f32(xr[c + e]) : 0.f;
  }
}

// Top bytes of the keystream words of indices idx0 .. idx0 + 3, byte e of
// the result for index idx0 + e; the mix's last xorshift is dropped
// (keystream.cuh: it leaves the top byte as it is).
__device__ __forceinline__ uint32_t keystream_top_bytes(
    const KeystreamConsts& kc, uint32_t idx0) {
  const uint32_t a0 = idx0 * kM1;
  uint32_t p[kEpt];
#pragma unroll
  for (int e = 0; e < kEpt; ++e)
    p[e] = keystream_pre(kc, a0 + (uint32_t)e * kM1);
  return __byte_perm(__byte_perm(p[0], p[1], 0x0073),
                     __byte_perm(p[2], p[3], 0x0073), 0x5410);
}

// q = clip(rint(v / scale), -127, 127) by IEEE division (no reciprocal);
// the low bytes of q XOR the keystream bytes go to columns c .. c + 3 of
// the row (one 4-byte store when VEC).
template <bool VEC>
__device__ __forceinline__ void quantize_store(const float (&v)[kEpt],
                                               uint32_t ks, float scale,
                                               uint8_t* __restrict__ cr,
                                               int c, int cols) {
  int q[kEpt];
#pragma unroll
  for (int e = 0; e < kEpt; ++e)
    q[e] = (int)fminf(fmaxf(rintf(v[e] / scale), -127.f), 127.f);
  const uint32_t w = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                                 __byte_perm(q[2], q[3], 0x0040), 0x5410) ^
                     ks;
  if constexpr (VEC) {
    if (c < cols) *reinterpret_cast<uint32_t*>(cr + c) = w;
  } else {
#pragma unroll
    for (int e = 0; e < kEpt; ++e)
      if (c + e < cols) cr[c + e] = (uint8_t)(w >> (8 * e));
  }
}

// One block per row; thread t owns columns t * 4 .. t * 4 + 3 of each tile
// of blockDim.x * 4 columns. The first tile stays in registers from its
// one read to its store; a row wider than one tile reads its later tiles
// again for the second pass.
template <typename T, bool VEC>
__global__ void __launch_bounds__(1024)
    seal_q8_kernel(const T* __restrict__ x, uint8_t* __restrict__ cipher,
                   float* __restrict__ scales, int cols,
                   const long long* __restrict__ key,
                   const long long* __restrict__ ctr) {
  __shared__ float partial[32];
  const int row = blockIdx.x;
  const long long base = (long long)row * cols;
  const T* xr = x + base;
  uint8_t* cr = cipher + base;
  const int tile = blockDim.x * kEpt;
  const int c = threadIdx.x * kEpt;

  float v[kEpt];
  load_elems<T, VEC>(xr, c, cols, v);
  const KeystreamConsts kc = load_keystream_consts(key, ctr);
  // keystream bytes while the loads are in flight
  uint32_t ks = keystream_top_bytes(kc, (uint32_t)base + (uint32_t)c);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < kEpt; ++e) m = fmaxf(m, fabsf(v[e]));
  for (int t0 = tile; t0 < cols; t0 += tile) {
    float w[kEpt];
    load_elems<T, VEC>(xr, t0 + c, cols, w);
#pragma unroll
    for (int e = 0; e < kEpt; ++e) m = fmaxf(m, fabsf(w[e]));
  }
  // block absmax: warp shuffles, one shared exchange, one barrier; every
  // warp then reduces the warps' maxima itself
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) partial[warp] = m;
  __syncthreads();
  m = warp_max(lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f);
  const float scale = fmaxf(m, 1e-6f) / 127.f;
  if (threadIdx.x == 0) scales[row] = scale;

  quantize_store<VEC>(v, ks, scale, cr, c, cols);
  for (int t0 = tile; t0 < cols; t0 += tile) {
    load_elems<T, VEC>(xr, t0 + c, cols, v);
    ks = keystream_top_bytes(kc, (uint32_t)base + (uint32_t)(t0 + c));
    quantize_store<VEC>(v, ks, scale, cr, t0 + c, cols);
  }
}

// kEpt elements of one row at columns c .. c + 3 to out, from f32 by
// round-to-nearest-even; none past the row's end. VEC: out is 8-byte
// (bf16) or 16-byte (f32) aligned and cols a multiple of 4, so the
// thread's elements are one store.
template <typename T, bool VEC>
__device__ __forceinline__ void store_elems(T* __restrict__ orow, unsigned c,
                                            unsigned cols,
                                            const float (&v)[kEpt]) {
  if constexpr (VEC) {
    if constexpr (sizeof(T) == 2) {
      // cvt.rn.bf16x2.f32: each half rounded as __float2bfloat16_rn
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(orow + c) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kEpt; ++e)
      if (c + e < cols) orow[c + e] = from_f32<T>(v[e]);
  }
}

// Rows per z-slice of unseal's grid: gridDim.y is at most 65535.
constexpr unsigned kGridRows = 65535;

// Thread t of block (x, y, z) owns columns (x * blockDim.x + t) * 4 .. + 3
// of row z * 65535 + y: no loop, no division. The cipher bytes come in as
// one 4-byte load (VEC: cipher 4-byte aligned, cols a multiple of 4) or as
// byte loads, packed into a word, byte e for column c + e; one XOR with the
// keystream's top bytes, computed while the loads are in flight, opens all
// four. The flat index is row * cols + c modulo 2**32; the pointer offset
// is 64-bit.
template <typename T, bool VEC>
__global__ void __launch_bounds__(1024)
    unseal_q8_kernel(const uint8_t* __restrict__ cipher,
                     const float* __restrict__ scales, T* __restrict__ out,
                     unsigned rows, unsigned cols,
                     const long long* __restrict__ key,
                     const long long* __restrict__ ctr) {
  const unsigned row = blockIdx.z * kGridRows + blockIdx.y;
  const unsigned c = (blockIdx.x * blockDim.x + threadIdx.x) * kEpt;
  if (row >= rows || c >= cols) return;
  const long long base = (long long)row * cols;
  const uint8_t* cr = cipher + base;
  uint32_t w;
  if constexpr (VEC) {
    w = *reinterpret_cast<const uint32_t*>(cr + c);
  } else {
    w = 0;
#pragma unroll
    for (int e = 0; e < kEpt; ++e)
      if (c + e < cols) w |= (uint32_t)cr[c + e] << (8 * e);
  }
  const float scale = scales[row];  // one address for the whole block
  w ^= keystream_top_bytes(load_keystream_consts(key, ctr),
                           (uint32_t)base + c);
  // sign-extend each byte, then one correctly rounded f32 multiply (no FMA)
  float v[kEpt];
#pragma unroll
  for (int e = 0; e < kEpt; ++e)
    v[e] = __fmul_rn((float)(int8_t)(w >> (8 * e)), scale);
  store_elems<T, VEC>(out + base, c, cols, v);
}

template <typename T>
cudaError_t launch_seal(const void* x, void* cipher, void* scales, int rows,
                        int cols, const long long* key, const long long* ctr,
                        bool vec, int threads, cudaStream_t s) {
  if (vec)
    seal_q8_kernel<T, true><<<rows, threads, 0, s>>>(
        (const T*)x, (uint8_t*)cipher, (float*)scales, cols, key, ctr);
  else
    seal_q8_kernel<T, false><<<rows, threads, 0, s>>>(
        (const T*)x, (uint8_t*)cipher, (float*)scales, cols, key, ctr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_unseal(const void* cipher, const void* scales, void* out,
                          int rows, int cols, const long long* key,
                          const long long* ctr, bool vec, int threads,
                          int tiles, cudaStream_t s) {
  const unsigned r = (unsigned)rows;
  const dim3 grid((unsigned)tiles, r < kGridRows ? r : kGridRows,
                  (r + kGridRows - 1) / kGridRows);
  if (vec)
    unseal_q8_kernel<T, true><<<grid, threads, 0, s>>>(
        (const uint8_t*)cipher, (const float*)scales, (T*)out, r,
        (unsigned)cols, key, ctr);
  else
    unseal_q8_kernel<T, false><<<grid, threads, 0, s>>>(
        (const uint8_t*)cipher, (const float*)scales, (T*)out, r,
        (unsigned)cols, key, ctr);
  return cudaGetLastError();
}

}  // namespace

// Plain C entries (loaded with ctypes). x / out hold rows*cols contiguous
// elements of elem_bytes (4: f32, 2: bf16); cipher is uint8 [rows, cols],
// scales f32 [rows, 1]; `key` and `ctr` each point at one int64 in device
// memory, read by the kernel (its low 32 bits). Each returns the launch's
// cudaError_t.
//
// seal takes its threads per block from the wrapper (`ops._seal_threads`:
// a multiple of 32, at most 1024) and vec_ok != 0 where x is 16-byte
// aligned, cipher 4-byte aligned and cols a multiple of 4 (checked here).
extern "C" int repro_seal_q8(const void* x, void* cipher, void* scales,
                             int rows, int cols, const void* key,
                             const void* ctr, int elem_bytes, int vec_ok,
                             int threads, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vec_ok != 0;
  if (threads < 32 || threads > 1024 || threads % 32 || !key || !ctr ||
      (uintptr_t)key % 8 || (uintptr_t)ctr % 8 ||
      (vec && (cols % 4 || (uintptr_t)x % 16 || (uintptr_t)cipher % 4)))
    return (int)cudaErrorInvalidValue;
  const long long* k = (const long long*)key;
  const long long* c = (const long long*)ctr;
  if (elem_bytes == 4)
    return (int)launch_seal<float>(x, cipher, scales, rows, cols, k, c, vec,
                                   threads, s);
  if (elem_bytes == 2)
    return (int)launch_seal<__nv_bfloat16>(x, cipher, scales, rows, cols, k,
                                           c, vec, threads, s);
  return (int)cudaErrorInvalidValue;
}

// unseal takes its plan from the wrapper (`ops._unseal_plan`): threads per
// block (a multiple of 32, at most 1024) and column tiles of threads * 4
// that cover the row with none empty; vec_ok != 0 where cipher is 4-byte
// aligned, out 8-byte (bf16) or 16-byte (f32) aligned and cols a multiple
// of 4 (checked here).
extern "C" int repro_unseal_q8(const void* cipher, const void* scales,
                               void* out, int rows, int cols,
                               const void* key, const void* ctr,
                               int out_elem_bytes, int vec_ok, int threads,
                               int tiles, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (out_elem_bytes != 2 && out_elem_bytes != 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = vec_ok != 0;
  const long long tile = (long long)threads * kEpt;
  if (threads < 32 || threads > 1024 || threads % 32 || tiles <= 0 ||
      tiles * tile < cols || (tiles - 1) * tile >= cols || !key || !ctr ||
      (uintptr_t)key % 8 || (uintptr_t)ctr % 8 ||
      (vec && (cols % 4 || (uintptr_t)cipher % 4 ||
               (uintptr_t)out % (4 * out_elem_bytes))))
    return (int)cudaErrorInvalidValue;
  const long long* k = (const long long*)key;
  const long long* c = (const long long*)ctr;
  if (out_elem_bytes == 4)
    return (int)launch_unseal<float>(cipher, scales, out, rows, cols, k, c,
                                     vec, threads, tiles, s);
  return (int)launch_unseal<__nv_bfloat16>(cipher, scales, out, rows, cols,
                                           k, c, vec, threads, tiles, s);
}
