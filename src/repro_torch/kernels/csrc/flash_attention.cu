// Blocked prefill attention (flash attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention.py:28-104, and with it the GQA
// wrapper `ops.flash_attention` (src/repro/kernels/ops.py:67-87). It
// computes the same function: f32 scores q.k / sqrt(D), masked positions at
// -1e30, an online softmax with a running max, sum and accumulator per
// query, and a final acc / max(l, 1e-30), rounded once to q's type. Beyond
// the TPU kernel it takes `q_offset`: query i sits at absolute position
// q_offset + i and the keys at 0 .. Sk-1, which is the function of the JAX
// package's `layers.chunked_attention(q_offset=...)`, so one kernel serves
// one-shot, packed and chunked prefill. Optional causal and sliding-window
// (k_pos > q_pos - window) masks, as in the TPU kernel.
//
// Layout: the model's own, with no transposes and no repeated KV heads:
// q/out [B, Sq, H, D], k/v [B, Sk, KVH, D], contiguous, query head h reads
// KV head h / (H / KVH) (the mapping of the reference's jnp.repeat).
//
// What bounds it on an H100 SXM (700 W data sheet: 3.35 TB/s, 989 TFLOP/s
// bf16 dense on the tensor cores, 67 TFLOP/s f32 outside them): operations.
// At the one-shot prefill shape (B=1, S=512, H=32, D=64, causal) the call
// moves about 5 MB (1.6 us at 3.35 TB/s) but does about 1.1 GFLOP; this
// kernel runs on the f32 FMA pipes, not the tensor cores, so it sits at
// least an order of magnitude above the tensor-core bound (16 us at the
// f32 rate alone).
//
// Design (simple first; tensor cores, TMA and wgmma are a later change).
// The TPU grid (BH, q_blocks) carried (m, l, acc) across a sequential KV
// loop inside the program; here the KV loop also lives inside the block.
// One block of 128 threads per (query tile of 64, head, batch row). The
// block stages its pre-scaled query tile and each 64-key K and V tile in
// shared memory as f32 (rows of the query tile padded to D + 4 floats, so
// the float4 reads of 8 neighbouring rows hit distinct banks). Thread
// (r, half) owns query row r: it scores keys [32*half, 32*half + 32) of the
// tile against row r (each K read is a warp-wide broadcast), writes the
// masked scores to a padded [64][65] tile, then both threads of the row
// read the whole row back, take the same running max and sum, and each
// accumulates P.V into its own half of the output dims, in registers. The
// KV loop stops at the causal bound computed from absolute positions
// (q_offset included) and starts at the window's bound; ragged tails of Sq
// and Sk are masked (keys past Sk contribute exactly 0, rows past Sq are
// not written), so no length need be a power of two. Shared memory is
// 65 KB (D = 64) to 113 KB (D = 128) per block, dynamic, with the opt-in
// attribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kThreads = 128;      // two threads per query row
constexpr int kSS = kBK + 1;       // padded score-row stride

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

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 4) + 2 * (size_t)kBK * D + (size_t)kBQ * kSS;
}

// grid (ceil(Sq / 64), H, B); block 128 threads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int KVH, int causal, int window,
                       int q_offset, float scale) {
  constexpr int QS = D + 4;   // padded query-row stride
  constexpr int DH = D / 2;   // output dims per thread
  constexpr int KH = kBK / 2; // keys scored per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][QS], pre-scaled
  float* k_s = q_s + kBQ * QS;                   // [kBK][D]
  float* v_s = k_s + kBK * D;                    // [kBK][D]
  float* s_s = v_s + kBK * D;                    // [kBQ][kSS]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int t = threadIdx.x;
  const int r = t & (kBQ - 1);
  const int half = t / kBQ;  // uniform across a warp
  const int rows = min(kBQ, Sq - q0);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KVH * D;
  const T* qb = q + ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)g * D;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)g * D;

  for (int i = t; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i - rr * D;
    q_s[rr * QS + d] =
        rr < rows ? to_f32(qb[(size_t)rr * q_stride + d]) * scale : 0.f;
  }

  // absolute positions of this tile's queries: [qp_lo, qp_hi)
  const int qp_lo = q_offset + q0;
  const int qp_hi = qp_lo + rows;
  const int k_end = causal ? min(Sk, qp_hi) : Sk;
  const int kt_lo = window > 0 ? max(0, qp_lo - window + 1) / kBK : 0;
  const int kt_hi = (k_end + kBK - 1) / kBK;
  const int qp = qp_lo + r;
  const bool row_live = r < rows;

  float m = kNegInf, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) acc[j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and scores are consumed
    for (int i = t; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < Sk;
      const size_t off = (size_t)(k0 + j) * kv_stride + d;
      k_s[i] = in ? to_f32(kb[off]) : 0.f;
      v_s[i] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    // scores of row r against keys [KH * half, KH * half + KH)
    float s[KH];
#pragma unroll
    for (int j = 0; j < KH; ++j) s[j] = 0.f;
    const float* qr = q_s + r * QS;
    const float* kh = k_s + half * KH * D;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int j = 0; j < KH; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kh + j * D + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    float* sr = s_s + r * kSS;
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      const int kp = k0 + half * KH + j;
      float val = s[j];
      if (!row_live || kp >= Sk)
        val = -INFINITY;  // absent: contributes exactly 0
      else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
        val = kNegInf;    // masked, as the reference masks
      sr[half * KH + j] = val;
    }
    __syncthreads();

    // online softmax over the whole tile row (both threads of the row
    // compute the same m and l), then P.V into this thread's output dims
    float tmax = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < kBK; ++j) tmax = fmaxf(tmax, sr[j]);
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int j = 0; j < DH; ++j) acc[j] *= corr;
    const float* vh = v_s + half * DH;
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(sr[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vh + j * D + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (!row_live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* ob = out + ((size_t)b * Sq + q0 + r) * q_stride + (size_t)h * D +
          half * DH;
#pragma unroll
  for (int j = 0; j < DH; ++j) ob[j] = from_f32<T>(acc[j] * inv);
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KVH, int causal,
                     int window, int q_offset, float scale,
                     cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static bool attr_set = false;  // one instantiation per (T, D)
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, KVH, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KVH,
                         int D, int causal, int window, int q_offset,
                         float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window,
                             q_offset, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window,
                             q_offset, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, Sq, Sk, H, KVH, causal, window,
                             q_offset, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, Sq, Sk, H, KVH, causal,
                              window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry (loaded with ctypes). dtype_code: 0 = float32, 1 = bfloat16
// for q, k, v and out. Shapes: q/out [B, Sq, H, D], k/v [B, Sk, KVH, D],
// contiguous; H % KVH == 0, D in {16, 32, 64, 128} (the wrapper checks).
// causal: 0 or 1; window: 0 = none. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KVH, int D,
                                     int causal, int window, int q_offset,
                                     float scale, int dtype_code,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return (int)launch_typed<float>(q, k, v, out, B, Sq, Sk, H, KVH, D,
                                    causal, window, q_offset, scale, s);
  if (dtype_code == 1)
    return (int)launch_typed<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KVH,
                                            D, causal, window, q_offset,
                                            scale, s);
  return (int)cudaErrorInvalidValue;
}
