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
// (k_pos > q_pos - window) masks, as in the TPU kernel. Keys past Sk score
// -inf and contribute exactly 0, so no length need be a power of two.
//
// Layout: the model's own, with no transposes and no repeated KV heads:
// q/out [B, Sq, H, D], k/v [B, Sk, KVH, D], contiguous, query head h reads
// KV head h / (H / KVH) (the mapping of the reference's jnp.repeat).
//
// What bounds it on an H100 SXM (700 W data sheet: 3.35 TB/s, 989 TFLOP/s
// bf16 dense on the tensor cores, 67 TFLOP/s f32 outside them): at the
// one-shot prefill shape (B=1, S=512, H=32, D=64, causal) the call moves
// about 5 MB (1.6 us at 3.35 TB/s) and does about 1.1 GFLOP (1.1 us on the
// bf16 tensor cores, 16 us on the f32 pipes). So bf16 must run on the
// tensor cores, and at the path's small shapes a launch is short enough
// that latency and filling 132 SMs matter as much as either rate.
//
// Two designs, one per type:
//
// bf16: `flash_wgmma_kernel`, on the tensor cores. One warpgroup (128
// threads) owns 64 query rows of one head; the last query tiles, which
// read the most keys when causal, are scheduled first. Q and a two-stage
// ring of 64-key K and V tiles sit in shared memory as bf16, in the
// swizzled layout the wgmma descriptors name for the row width (128 B
// rows and the 128-byte swizzle at D = 64; two such column blocks at
// D = 128; 64 B and 32 B swizzles at D = 32 and 16). Tiles arrive by
// 16-byte cp.async copies that zero-fill rows past Sq and Sk; tile k + 1
// is in flight while tile k is computed. S = Q.K^T is D/16 wgmma
// m64n64k16 (K is operand B, K-major, its natural layout). The online
// softmax runs on the accumulator fragment in registers: row max and sum
// across the four threads of a row by shuffles, masks from absolute
// positions per element, skipped for tiles every row sees whole. P goes
// to P.V from registers, where the accumulator layout is already the
// A-operand layout, as two bf16 parts hi = bf16(P) and lo = bf16(P - hi):
// P rounded once to bf16 puts errors of 2**-9 of each term into rows that
// see few keys, more than the bf16 output tolerance, while hi + lo keeps
// about 16 bits. O += P.V is then eight wgmma m64nDk16 per tile with V as
// operand B from shared memory, MN-major (the transpose flag). The KV
// loop starts at the window's bound and stops at the causal bound. One
// block walks the whole KV range of its query tile: cutting the range
// into parts merged by the last one to finish was tried at the chunk
// shape (64 blocks) and was no faster than one part on the card (PERF.md
// section 6), so the kernel has no split.
//
// f32: `flash_attention_kernel`, the first design, on the FMA pipes: full
// f32 products, which neither the bf16 nor the TF32 tensor cores give, and
// which the f32 serving path needs to match the CPU's greedy streams. One
// block of 128 threads per (query tile of 64, head, batch row) stages the
// pre-scaled query tile and each 64-key K and V tile in shared memory as
// f32 (query rows padded to D + 4 floats, so the float4 reads of 8
// neighbouring rows hit distinct banks). Thread (r, half) owns query row
// r: it scores keys [32*half, 32*half + 32) of the tile against row r,
// writes the masked scores to a padded [64][65] tile, then both threads of
// the row read the row back, take the same running max and sum, and each
// accumulates P.V into its own half of the output dims, in registers.
// 65 KB (D = 64) to 113 KB (D = 128) of dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32 on the FMA pipes
// ---------------------------------------------------------------------------
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per K/V tile
constexpr int kThreads = 128;      // two threads per query row
constexpr int kSS = kBK + 1;       // padded score-row stride

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kStages = 2;     // K/V tiles in the shared-memory ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared memory written by the generic proxy (cp.async) becomes visible
// to the async proxy that wgmma reads it through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the fence / wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The shared-memory tile of 64 rows x D bf16: column blocks of W bytes
// (W = min(2 D, 128)), each 64 rows x W bytes, rows of a block contiguous,
// 16-byte chunks swizzled as the wgmma descriptor's layout type expects
// (CuTe's Swizzle<log2(W / 16), 4, 3>: address bits [4, 4 + b) ^= bits
// [7, 7 + b)).
template <int D>
struct TileLayout {
  static constexpr int W = 2 * D < 128 ? 2 * D : 128;  // bytes per row
  static constexpr int CPR = W / 16;                    // chunks per row
  static constexpr int BLOCK = 64 * W;                  // bytes per block
  static constexpr int BYTES = 64 * 2 * D;              // bytes per tile
  // wgmma layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t TYPE = W == 128 ? 1 : (W == 64 ? 2 : 3);
  // byte offset of 16-byte chunk c (0 .. D/8 - 1) of row r
  __device__ static __forceinline__ uint32_t offset(int r, int c) {
    const uint32_t lin = r * W + (c % CPR) * 16;
    return (c / CPR) * BLOCK + (lin ^ ((lin >> 3) & ((CPR - 1) << 4)));
  }
};

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t type) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (type << 62);
}

// Copy 64 rows of one head, rows `stride` elements apart from `src` on,
// into a tile; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int rows) {
  constexpr int C = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < C / 2; ++it) {  // 64 C chunks over 128 threads
    const int i = threadIdx.x + 128 * it;
    const int r = i / C, c = i % C;
    const bool in = r < rows;
    const __nv_bfloat16* g = src + (size_t)(in ? r : 0) * stride + c * 8;
    cp_async16(dst + TileLayout<D>::offset(r, c), g, in ? 16 : 0);
  }
}

// Two probabilities (x in the low half) as two bf16 pairs whose sum
// carries about 16 bits of each: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (+)= A * B, m64n64k16: A and B from shared memory, both K-major.
// scale_d = 0 overwrites d, 1 accumulates into it.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A * B, m64n16k16: A (P, bf16) from registers, B from shared
// memory, MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A * B, m64n32k16: A (P, bf16) from registers, B from shared
// memory, MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A * B, m64n64k16: A (P, bf16) from registers, B from shared
// memory, MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A * B, m64n128k16: A (P, bf16) from registers, B from shared
// memory, MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// grid (ceil(Sq / 64), H, B); block 128 threads (one warpgroup), query
// tiles in reverse order.
template <int D>
__global__ void __launch_bounds__(128)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int KVH, int causal, int window, int q_offset,
                   float scale) {
  using TL = TileLayout<D>;
  constexpr int NO = D / 2;  // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // tiles start on 1024-byte boundaries, as the swizzle patterns require
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base;
  // ring stage s: K at base + (1 + 2 s) * BYTES, V right after it
  auto k_s = [&](int s) { return base + (1 + 2 * s) * TL::BYTES; };
  auto v_s = [&](int s) { return base + (2 + 2 * s) * TL::BYTES; };

  const int nqt = (Sq + 63) / 64;
  // the last query tiles, which read the most keys when causal, first
  const int qt = nqt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int q0 = qt * 64;
  const int rows = min(64, Sq - q0);

  const size_t q_stride = (size_t)H * D;
  const size_t kv_stride = (size_t)KVH * D;
  const __nv_bfloat16* qb =
      q + ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kv_stride + (size_t)g * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kv_stride + (size_t)g * D;

  // this tile's KV tiles [kt_lo, kt_lo + n) from absolute positions
  const int qp_lo = q_offset + q0;
  const int k_end = causal ? min(Sk, qp_lo + rows) : Sk;
  const int kt_lo = window > 0 ? max(0, qp_lo - window + 1) / 64 : 0;
  const int n = max(0, (k_end + 63) / 64 - kt_lo);

  // thread's two rows: r0 = 16 warp + lane / 4 and r0 + 8; its columns
  // 8 j + 2 (lane % 4) + {0, 1} of every 8-column group j
  const int r0 = 16 * warp + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;

  // K/V tile j of this query tile -> ring stage j % kStages; one commit group
  // per tile (empty past the last), so wait_group<kStages - 2> means the
  // tile being computed has landed while the next ones are in flight
  auto load_kv = [&](int j) {
    if (j < n) {
      const int kt = kt_lo + j, st = j % kStages;
      const size_t off = (size_t)kt * 64 * kv_stride;
      load_tile<D>(k_s(st), kb + off, kv_stride, Sk - kt * 64);
      load_tile<D>(v_s(st), vb + off, kv_stride, Sk - kt * 64);
    }
    cp_async_commit();
  };
  if (n > 0) {
    load_tile<D>(q_s, qb, q_stride, rows);  // in tile 0's group
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) load_kv(j);
  }
  for (int i = 0; i < n; ++i) {
    const int kt = kt_lo + i, st = i % kStages;
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i is in; every thread is done with tile i - 1
    load_kv(i + kStages - 1);  // into tile i - 1's stage

    // S = Q K^T over D / 16 steps of 16
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t koff = (kk * 32 / TL::W) * TL::BLOCK + (kk * 32) % TL::W;
      wgmma_ss_n64(s, desc(q_s + koff, 16, 8 * TL::W, TL::TYPE),
                   desc(k_s(st) + koff, 16, 8 * TL::W, TL::TYPE), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // masks and the online softmax, on the fragment
    const int k0 = kt * 64;
    // a tile that every live row sees whole takes no masks (rows past Sq
    // then score zero-filled queries: finite, and never written)
    const bool whole = k0 + 64 <= Sk && (!causal || k0 + 63 <= qp_lo) &&
                       (window == 0 || k0 > qp_lo + rows - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
    if (whole) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] *= scale;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = e >> 2, ri = (e >> 1) & 1, c = e & 1;
        const int r = r0 + 8 * ri;
        const int kp = k0 + 8 * j + c0 + c;
        const int qp = qp_lo + r;
        float val = s[e] * scale;
        if (r >= rows || kp >= Sk)
          val = -INFINITY;  // absent: contributes exactly 0
        else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
          val = kNegInf;    // masked, as the reference masks
        s[e] = val;
        mx[ri] = fmaxf(mx[ri], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      corr[ri] = __expf(m[ri] - m_new);
      m[ri] = m_new;
      l[ri] *= corr[ri];  // this thread's share of the row sum
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int ri = (e >> 1) & 1;
      s[e] = __expf(s[e] - m[ri]);
      l[ri] += s[e];
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= corr[(e >> 1) & 1];

    // O += P V: P from registers as bf16 hi + lo parts, so it keeps about
    // 16 bits (k-step kk covers keys 16 kk .. +15, accumulator groups
    // j = 2 kk and 2 kk + 1)
    uint32_t hi[4][4], lo[4][4];  // all of P's registers before the fence
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        split_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], hi[kk][x],
                   lo[kk][x]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = desc(v_s(st) + kk * 16 * TL::W, TL::BLOCK,
                               8 * TL::W, TL::TYPE);
      wgmma_rs(o, hi[kk], vd);
      wgmma_rs(o, lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
  const size_t o_stride = q_stride;
  __nv_bfloat16* ob = out + ((size_t)b * Sq + q0) * o_stride + (size_t)h * D;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = r0 + 8 * ri;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[ri], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 4 * j + 2 * ri;
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * o_stride + 8 * j +
                                         c0) =
          __floats2bfloat162_rn(o[e] * inv, o[e + 1] * inv);
    }
  }
}

template <int D>
constexpr size_t wgmma_smem_bytes() {  // Q, kStages x (K, V), alignment
  return (1 + 2 * kStages) * (size_t)TileLayout<D>::BYTES + 1024;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Sk, int H, int KVH,
                       int causal, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, KVH, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KVH,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<D>();
  static bool attr_set = false;  // one per instantiation
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((Sq + 63) / 64, H, B);
  flash_wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Sk, H, KVH, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry (loaded with ctypes). dtype_code: 0 = float32, 1 = bfloat16
// for q, k, v and out. Shapes: q/out [B, Sq, H, D], k/v [B, Sk, KVH, D],
// contiguous, 16-byte aligned; H % KVH == 0, D in {16, 32, 64, 128} (the
// wrapper checks). causal: 0 or 1; window: 0 = none. Returns the launch's
// cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KVH, int D, int causal,
                                     int window, int q_offset, float scale,
                                     int dtype_code, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0) {
    switch (D) {
#define REPRO_F32_CASE(DD)                                                  \
  case DD:                                                                  \
    return (int)launch_f32<DD>(q, k, v, out, B, Sq, Sk, H, KVH, causal,     \
                               window, q_offset, scale, s);
      REPRO_F32_CASE(16)
      REPRO_F32_CASE(32)
      REPRO_F32_CASE(64)
      REPRO_F32_CASE(128)
#undef REPRO_F32_CASE
    }
  } else if (dtype_code == 1) {
    switch (D) {
#define REPRO_BF16_CASE(DD)                                                 \
  case DD:                                                                  \
    return (int)launch_bf16<DD>(q, k, v, out, B, Sq, Sk, H, KVH, causal,    \
                                window, q_offset, scale, s);
      REPRO_BF16_CASE(16)
      REPRO_BF16_CASE(32)
      REPRO_BF16_CASE(64)
      REPRO_BF16_CASE(128)
#undef REPRO_BF16_CASE
    }
  }
  return (int)cudaErrorInvalidValue;
}
