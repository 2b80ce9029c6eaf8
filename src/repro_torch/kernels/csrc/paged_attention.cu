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
// microsecond at the H100's 3.35 TB/s) and does a few tens of MFLOP. What
// costs time is the chain of dependent rounds a block walks through, one
// per page, and how many SMs have a block at all.
//
// Design. The TPU grid (B, KVH, MP) carried (m, l, acc) in VMEM across a
// sequential page dimension; CUDA blocks run in no order. Here the pages
// of each (row, KV head) are split over `splits` blocks (grid (splits,
// KVH, B)), chosen by the wrapper's `_page_splits` so that the grid has
// up to eight blocks per SM and no split covers fewer than two pages of
// the table's width MP. Split s takes table pages [s * ceil(MP / splits), ...)
// up to the row's live pages; a split that starts at or past the row's
// length writes the empty marker (m = -inf, l = 0). Each block reads each
// of its page ids once and serves every query head that shares the KV
// head (GQA): warp r is query head r. A K or V page of one KV head is
// Pg * D contiguous elements; it moves as 16-byte cp.async copies (one per
// thread for a bf16 page at Pg = 16, D = 64, rep = 4) into a two-page
// ring, so page p + 1 loads while page p is scored. Scoring keeps every
// lane busy: 32 / Pg (rounded to a power of two) lanes share a token, each
// summing its 16-byte chunks of D, then one shuffle round per halving
// (one at Pg = 16). K rows are stored with their chunks XOR-swizzled by
// token, so the lanes of a wavefront read distinct banks. P.V reads P from
// shared memory and each lane accumulates a pair of output dims in
// registers. With splits > 1 every split writes its (m, l, acc) in f32 to
// scratch, and the last split of each (row, KV head) to finish (a
// __threadfence and an atomic counter, reset by that split) merges all
// splits in split order, so the result does not depend on which finished
// last. Rows with seq_len == 0 (idle engine slots) write zeros.
// Accumulation is f32; the output is written in the query's type.
//
// A rank of a tensor-parallel model axis whose query heads read KV heads
// that stayed whole (more ranks than KV heads) attends with its G = H /
// rep query groups over KV heads [kv0, kv0 + G) of pools that hold all
// KVP of them: the pools are read in place at those heads (no copy of a
// pool, no strided view), grid (splits, G, B). The default (KVP = KVH, kv0
// = 0) is the one-card launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a pair of output dims in the query's type
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// grid (splits, KVH, B); block rep warps. Shared memory: a two-page ring
// of K and V pages in T, the pre-scaled queries [rep][D] in f32, and each
// warp's page of probabilities [rep][32].
template <typename T, int D>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counters, int KVH, int rep, int N, int Pg, int MP,
    int KVP, int kv0, float scale, int splits) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per token row
  constexpr int DP = (D + 63) / 64;    // output dim pairs per lane
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int page_elems = Pg * D;

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);        // [2][K, V][Pg * D]
  float* q_s = reinterpret_cast<float*>(ring + 4 * page_elems);
  float* p_s = q_s + rep * D;                   // [rep][32]

  const size_t head0 = ((size_t)b * KVH + g) * rep;
  T* ob = out + head0 * D;
  const int seq = seq_lens[b];
  if (seq <= 0) {  // idle row: zeros, from one split, no merge
    if (split == 0)
      for (int i = threadIdx.x; i < rep * D; i += blockDim.x)
        ob[i] = T(0.f);
    return;
  }
  const int live_pages = min((seq + Pg - 1) / Pg, MP);
  const int per = (MP + splits - 1) / splits;  // table pages per split
  const int p0 = split * per;
  const int p1 = min(live_pages, p0 + per);

  // lanes per token: the largest power of two with lpt * Pg <= 32
  int lpt = 32;
  while (lpt * Pg > 32) lpt >>= 1;
  const int tk = lane / lpt, sub = lane % lpt;
  const int* bt = block_tables + (size_t)b * MP;

  // chunk c of token t of a K page sits at chunk c ^ swz(t)
  auto swz = [&](int t) { return (t * lpt) & (CPR - 1); };
  auto issue = [&](int p, int st) {
    int pid = bt[p];
    if (pid < 0 || pid >= N) pid = 0;  // never read outside the pool
    const size_t base = ((size_t)pid * KVP + kv0 + g) * page_elems;
    T* ks = ring + (2 * st) * page_elems;
    T* vs = ks + page_elems;
    for (int i = threadIdx.x; i < 2 * Pg * CPR; i += blockDim.x) {
      const int kv = i / (Pg * CPR), j = i - kv * Pg * CPR;
      const int t = j / CPR, c = j - t * CPR;
      if (kv == 0)
        cp_async16(ks + t * D + (c ^ swz(t)) * EPC,
                   k_pages + base + t * D + c * EPC);
      else
        cp_async16(vs + j * EPC, v_pages + base + j * EPC);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float m = kNegInf, l = 0.f;
  float acc[DP][2];
#pragma unroll
  for (int j = 0; j < DP; ++j) acc[j][0] = acc[j][1] = 0.f;

  if (p0 < p1) {
    issue(p0, 0);
    const T* qb = q + head0 * D;
    for (int i = threadIdx.x; i < rep * D; i += blockDim.x)
      q_s[i] = to_f32(qb[i]) * scale;
  }
  const float* qr = q_s + warp * D;
  float* pw = p_s + warp * 32;
  for (int p = p0; p < p1; ++p) {
    const int st = (p - p0) & 1;
    if (p + 1 < p1) {
      issue(p + 1, st ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const T* ks = ring + (2 * st) * page_elems;
    const T* vs = ks + page_elems;

    // score: lane (tk, sub) sums chunks sub, sub + lpt, ... of token tk
    float dot = 0.f;
    if (tk < Pg) {
      const T* kt = ks + tk * D;
      for (int c = sub; c < CPR; c += lpt) {
        const float4 raw =
            *reinterpret_cast<const float4*>(kt + (c ^ swz(tk)) * EPC);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          dot = fmaf(qr[c * EPC + e], to_f32(kv[e]), dot);
      }
    }
    for (int o = lpt >> 1; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const int tok = p * Pg + tk;
    const bool valid = tk < Pg && tok < seq;
    const float s = valid ? dot : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float pr = valid ? __expf(s - m_new) : 0.f;
    const float corr = __expf(m - m_new);
    l = l * corr + warp_sum(sub == 0 ? pr : 0.f);
    if (sub == 0 && tk < Pg) pw[tk] = pr;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = 2 * lane + 64 * j;
      acc[j][0] *= corr;
      acc[j][1] *= corr;
      if (d < D) {
        for (int t = 0; t < Pg; ++t) {
          const float pt = pw[t];
          const float2 vv = load_pair(vs + t * D + d);
          acc[j][0] = fmaf(pt, vv.x, acc[j][0]);
          acc[j][1] = fmaf(pt, vv.y, acc[j][1]);
        }
      }
    }
    m = m_new;
    __syncthreads();  // stage st and pw are free for the next page
  }

  T* orow = ob + (size_t)warp * D;
  if (splits == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = 2 * lane + 64 * j;
      if (d < D) store_pair(orow + d, acc[j][0] * inv, acc[j][1] * inv);
    }
    return;
  }

  // split pages: publish this split; the last split of (b, g) merges
  const int bg = b * KVH + g;
  const size_t part = ((size_t)bg * splits + split) * rep + warp;
  // an empty split publishes m = -inf, l = 0, acc = 0: weight 0
  if (lane == 0) {
    part_ml[2 * part] = p0 < p1 ? m : -INFINITY;
    part_ml[2 * part + 1] = l;
  }
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    const int d = 2 * lane + 64 * j;
    if (d < D) store_pair(part_acc + part * D + d, acc[j][0], acc[j][1]);
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (threadIdx.x == 0)
    is_last = atomicAdd(counters + bg, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (threadIdx.x == 0) counters[bg] = 0;  // ready for the next call

  // warp r merges query head r, splits in order: lane s fetches split
  // s's (m, l) (splits <= 32), the weights go round by shuffles
  const size_t first = (size_t)bg * splits * rep + warp;  // split 0
  float2 msl = make_float2(-INFINITY, 0.f);
  if (lane < splits)
    msl = __ldcg(reinterpret_cast<const float2*>(
        part_ml + 2 * (first + (size_t)lane * rep)));
  const float mm = warp_max(msl.x);
  const float wl = msl.x == -INFINITY ? 0.f : __expf(msl.x - mm);
  const float ll = warp_sum(wl * msl.y);
  float ax[DP][2];
#pragma unroll
  for (int j = 0; j < DP; ++j) ax[j][0] = ax[j][1] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = __shfl_sync(0xffffffffu, wl, s);
    const float* ap = part_acc + (first + (size_t)s * rep) * D;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = 2 * lane + 64 * j;
      if (d < D) {
        const float2 a = __ldcg(reinterpret_cast<const float2*>(ap + d));
        ax[j][0] += w * a.x;
        ax[j][1] += w * a.y;
      }
    }
  }
  const float inv = 1.f / fmaxf(ll, 1e-30f);
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    const int d = 2 * lane + 64 * j;
    if (d < D) store_pair(orow + d, ax[j][0] * inv, ax[j][1] * inv);
  }
}

template <typename T>
size_t smem_bytes(int rep, int D, int Pg) {
  return 4 * (size_t)Pg * D * sizeof(T) + sizeof(float) * (rep * D + rep * 32);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* bt, const int* sl, void* out, float* part_ml,
                     float* part_acc, int* counters, int B, int KVH, int rep,
                     int N, int Pg, int MP, int KVP, int kv0, float scale,
                     int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(rep, D, Pg);
  static size_t attr = 48 * 1024;  // one per instantiation
  if (smem > attr) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr = smem;
  }
  dim3 grid(splits, KVH, B);
  paged_attention_kernel<T, D><<<grid, 32 * rep, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bt, sl, (T*)out, part_ml,
      part_acc, counters, KVH, rep, N, Pg, MP, KVP, kv0, scale, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* bt, const int* sl, void* out,
                         float* part_ml, float* part_acc, int* counters,
                         int B, int KVH, int rep, int D, int N, int Pg,
                         int MP, int KVP, int kv0, float scale, int splits,
                         cudaStream_t stream) {
  switch (D) {
#define REPRO_PAGED_CASE(DD)                                                \
  case DD:                                                                  \
    return launch_d<T, DD>(q, k, v, bt, sl, out, part_ml, part_acc,         \
                           counters, B, KVH, rep, N, Pg, MP, KVP, kv0,     \
                           scale, splits, stream);
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(32)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(128)
#undef REPRO_PAGED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry (loaded with ctypes). dtype_code: 0 = float32, 1 = bfloat16
// for q, both pools and the output. Shapes: q/out [B, KVH, rep, D], pools
// [N, KVP, Pg, D] read at heads [kv0, kv0 + KVH) (KVP = KVH, kv0 = 0 on
// one card), block_tables [B, MP] int32, seq_lens [B] int32, all
// contiguous and 16-byte aligned. Requires rep <= 32, Pg <= 32, D in
// {16, 32, 64, 128} (the wrapper checks). splits in 1 .. 32; with
// splits > 1: part_ml (f32, B * KVH * splits * rep * 2), part_acc (f32,
// B * KVH * splits * rep * D) and counters (int32, B * KVH, zero); with
// splits = 1 they may be null.
// Returns the launch's cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const int* block_tables,
                                     const int* seq_lens, void* out,
                                     void* part_ml, void* part_acc,
                                     void* counters, int B, int KVH, int rep,
                                     int D, int N, int Pg, int MP, int KVP,
                                     int kv0, float scale, int splits,
                                     int dtype_code, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return 0;
  if (splits < 1 || splits > 32 || rep < 1 || rep > 32 || Pg < 1 || Pg > 32 ||
      kv0 < 0 || kv0 + KVH > KVP)
    return (int)cudaErrorInvalidValue;
  float* ml = (float*)part_ml;
  float* acc = (float*)part_acc;
  int* ctr = (int*)counters;
  if (dtype_code == 0)
    return (int)launch_typed<float>(q, k_pages, v_pages, block_tables,
                                    seq_lens, out, ml, acc, ctr, B, KVH, rep,
                                    D, N, Pg, MP, KVP, kv0, scale, splits, s);
  if (dtype_code == 1)
    return (int)launch_typed<__nv_bfloat16>(
        q, k_pages, v_pages, block_tables, seq_lens, out, ml, acc, ctr, B,
        KVH, rep, D, N, Pg, MP, KVP, kv0, scale, splits, s);
  return (int)cudaErrorInvalidValue;
}
