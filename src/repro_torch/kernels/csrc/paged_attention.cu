// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `paged_attention_pallas`
// in src/repro/kernels/paged_attention.py. One decode token per batch row
// attends over KV pages named by the row's block table, with an f32 online
// softmax, scale 1/sqrt(D), and positions >= seq_lens[b] masked.
//
// What bounds it on an H100 SXM (data sheet, 700 W): latency, not bytes
// or arithmetic. At the serving shapes (B = 8 slots, KVH = 8, rep = 4,
// D = 64, page 16) a step moves at most a few MB of K/V (about a
// microsecond at the H100's 3.35 TB/s) and does a few tens of MFLOP,
// while B*KVH = 64 blocks cannot fill the H100's 132 SMs and every page is
// a dependent load -> reduce -> accumulate round.
//
// Design. The TPU grid (B, KVH, MP) carried (m, l, acc) in VMEM across a
// sequential page dimension; CUDA blocks run in no order, so the page loop
// lives inside the block instead. One block per (b, kv_head) reads each
// page once for all `rep` query heads that share it (GQA): the block loads
// the page's K and V into shared memory as f32 (K rows padded to D+1 floats
// so the per-token dot products are bank-conflict free), then warp r scores
// query head r against the page's tokens (lane t owns token t), updates its
// running max / sum with warp shuffles, and accumulates P.V with lane-owned
// output dims held in registers. The block reads its own page ids from the
// block table (CUDA has no scalar prefetch) and loops only over
// ceil(seq_len / page) pages, not the table's full width. Rows with
// seq_len == 0 (idle engine slots) write zeros. Accumulation is f32; the
// output is written in the query's type. Split-K over pages, TMA and wgmma
// are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (KVH, B); block rep warps. D is compile-time so each lane's slice
// of the output accumulator lives in registers (DJ = ceil(D / 32) values).
template <typename T, int D>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, T* __restrict__ out, int KVH, int rep,
    int N, int Pg, int MP, float scale) {
  constexpr int DJ = (D + 31) / 32;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                       // [rep][D], pre-scaled
  float* k_s = q_s + rep * D;              // [Pg][D + 1]
  float* v_s = k_s + Pg * (D + 1);         // [Pg][D]

  const size_t head0 = ((size_t)b * KVH + g) * rep;
  const T* qb = q + head0 * D;
  T* ob = out + head0 * D;
  const int seq = seq_lens[b];
  if (seq <= 0) {
    for (int i = threadIdx.x; i < rep * D; i += blockDim.x)
      ob[i] = from_f32<T>(0.f);
    return;
  }
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x)
    q_s[i] = to_f32(qb[i]) * scale;

  float m = kNegInf, l = 0.f;
  float acc[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) acc[j] = 0.f;

  int n_pages = (seq + Pg - 1) / Pg;
  if (n_pages > MP) n_pages = MP;
  const int* bt = block_tables + (size_t)b * MP;
  const int page_elems = Pg * D;
  for (int p = 0; p < n_pages; ++p) {
    int pid = bt[p];
    if (pid < 0 || pid >= N) pid = 0;      // never read outside the pool
    const size_t base = ((size_t)pid * KVH + g) * page_elems;
    __syncthreads();                        // previous page fully consumed
    for (int i = threadIdx.x; i < page_elems; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      k_s[t * (D + 1) + d] = to_f32(k_pages[base + i]);
      v_s[i] = to_f32(v_pages[base + i]);
    }
    __syncthreads();
    const int tok = p * Pg + lane;
    const bool valid = lane < Pg && tok < seq;
    float s = kNegInf;
    if (valid) {
      const float* qr = q_s + warp * D;
      const float* kt = k_s + lane * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
      s = dot;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float pr = valid ? expf(s - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(pr);
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[j] *= corr;
    for (int t = 0; t < Pg; ++t) {
      const float pt = __shfl_sync(0xffffffffu, pr, t);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(pt, v_s[t * D + d], acc[j]);
      }
    }
    m = m_new;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int d = lane + 32 * j;
    if (d < D) ob[(size_t)warp * D + d] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* bt, const int* sl, void* out, int B,
                         int KVH, int rep, int D, int N, int Pg, int MP,
                         float scale, cudaStream_t stream) {
  dim3 grid(KVH, B);
  dim3 block(32 * rep);
  const size_t smem = sizeof(float) * (rep * D + Pg * (D + 1) + Pg * D);
#define REPRO_PAGED_CASE(DD)                                               \
  case DD:                                                                 \
    paged_attention_kernel<T, DD><<<grid, block, smem, stream>>>(          \
        (const T*)q, (const T*)k, (const T*)v, bt, sl, (T*)out, KVH, rep,  \
        N, Pg, MP, scale);                                                 \
    break;
  switch (D) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_CASE
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (loaded with ctypes). dtype_code: 0 = float32, 1 = bfloat16
// for q, both pools and the output. Shapes: q/out [B, KVH, rep, D], pools
// [N, KVH, Pg, D], block_tables [B, MP] int32, seq_lens [B] int32, all
// contiguous. Requires rep <= 32, Pg <= 32, D in {16, 32, 64, 128} (the
// wrapper checks). Returns the launch's cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const int* block_tables,
                                     const int* seq_lens, void* out, int B,
                                     int KVH, int rep, int D, int N, int Pg,
                                     int MP, float scale, int dtype_code,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (dtype_code == 0)
    return (int)launch_typed<float>(q, k_pages, v_pages, block_tables,
                                    seq_lens, out, B, KVH, rep, D, N, Pg, MP,
                                    scale, s);
  if (dtype_code == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k_pages, v_pages,
                                            block_tables, seq_lens, out, B,
                                            KVH, rep, D, N, Pg, MP, scale, s);
  return (int)cudaErrorInvalidValue;
}
