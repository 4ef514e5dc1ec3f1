// K1: paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` of
// src/repro/kernels/paged_attention.py (reached through its
// `paged_attention`). One query token per sequence attends to that
// sequence's KV, read through its block table from the shared physical
// page pool (KV, P, page, D); a physical page may sit in many tables.
//
// Bound: device-memory bytes. Per sequence the kernel must read
// ctx * KV * D * 2 (K and V) elements once; the arithmetic is 4 flops
// per element read, far below the card's ~295 flops/byte balance.
//
// Design: one block of 256 threads per (sequence b, kv head h). On the
// TPU the table and lengths arrive by scalar prefetch; here each thread
// reads the table slots of its own tokens, and no slot at or past
// ceil(ctx / page) is read. The block's eight warps walk the sequence in
// chunks of 32 tokens, chunk c going to warp c % 8, so each warp runs its
// own f32 online softmax without block barriers; the warps in flight are
// what hides the load latency, since a batch gives only B * KV blocks.
// In a chunk, lane t scores token t for all G = H / KV grouped query rows
// (the GQA reuse: one read of K serves G rows) with a full dot product
// over D, so scores need no cross-lane sums; the softmax of the chunk is
// a few warp shuffles; for P.V, lane t owns D/32 output columns and reads
// each token's V row coalesced. The 32 tokens of a chunk may span pages of
// any size. At the end the eight warps' (max, sum, accumulator) states
// are merged through shared memory. What is still left: splitting a long
// sequence across blocks, and TMA/cp.async pipelines.
//
// Semantics follow the TPU kernel: positions >= ctx are masked to
// -1e30, no page wholly past ctx is read, ctx <= 0 gives zeros, and the
// output is acc / max(l, 1e-30) in q's dtype.
#include "common.cuh"

namespace repro {

constexpr int K1_MAX_G = 8;     // grouped query rows per kv head
constexpr int K1_WARPS = 8;
constexpr int K1_THREADS = K1_WARPS * 32;

// Load N consecutive elements of T (N * sizeof(T) a multiple of 4, the
// address aligned to it) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const T* src) {
  constexpr int BYTES = N * (int)sizeof(T);
  static_assert(BYTES % 4 == 0, "whole 32-bit words only");
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) dst[i * PER + k] = to_f32(e[k]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = to_f32(e[k]);
  } else {
    const unsigned raw = *reinterpret_cast<const unsigned*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = to_f32(e[k]);
  }
}

// DPL = D / 32: output columns per lane. GB >= G is the size of the
// register arrays, a power of two, so that a kernel built for G = 2 keeps 2 rows.
template <typename T, int DPL, int GB>
__global__ void __launch_bounds__(K1_THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ context_lens, T* __restrict__ out, int H,
                       int KV, int P, int page, int pps, float sm_scale) {
  constexpr int D = DPL * 32;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load of a K row
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                         // (G, D), pre-scaled
  float* m_s = q_s + G * D;                  // (K1_WARPS, G) per-warp running max
  float* l_s = m_s + K1_WARPS * G;           // (K1_WARPS, G) per-warp running sum
  float* acc_s = l_s + K1_WARPS * G;         // (K1_WARPS, G, D) per-warp accumulators

  const int ctx = context_lens[b];
  const int n_tok = ctx <= 0 ? 0 : min(ctx, pps * page);
  const long long q_off = ((long long)b * H + (long long)h * G) * D;
  const int* table = block_tables + (long long)b * pps;

  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = to_f32(q[q_off + i]) * sm_scale;
  __syncthreads();

  float m_run[GB], l_run[GB], acc[GB][DPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.f;
#pragma unroll
    for (int k = 0; k < DPL; ++k) acc[g][k] = 0.f;
  }

  for (int t0 = warp * 32; t0 < n_tok; t0 += K1_WARPS * 32) {
    const int tok = t0 + lane;
    const bool valid = tok < n_tok;
    // element offset of this lane's token row in the (KV, P, page, D) pool
    long long row = 0;
    if (valid) row = (((long long)h * P + table[tok / page]) * page + tok % page) * D;

    // s[g] = (q_g * scale) . k_tok, a full dot product per lane
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
    if (valid) {
#pragma unroll 4
      for (int d = 0; d < D; d += VEC) {
        float kv[VEC];
        load_f32<T, VEC>(kv, k_pages + row + d);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) s[g] = fmaf(q_s[g * D + d + k], kv[k], s[g]);
          }
        }
      }
    }

    // online softmax over this chunk's 32 tokens, per query row
    float p[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      p[g] = 0.f;
      if (g < G) {
        const float sg = valid ? s[g] : NEG_INF;
        const float m_new = fmaxf(m_run[g], warp_max(sg));
        p[g] = expf(sg - m_new);
        const float alpha = expf(m_run[g] - m_new);
        l_run[g] = l_run[g] * alpha + warp_sum(p[g]);
        m_run[g] = m_new;
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[g][k] *= alpha;
      }
    }

    // acc[g, lane cols] += sum_j p_j[g] v_j[lane cols]
    const int n = min(32, n_tok - t0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long rj = __shfl_sync(0xffffffffu, row, j);
      float vv[DPL];
      load_f32<T, DPL>(vv, v_pages + rj + lane * DPL);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[g][k] = fmaf(pj, vv[k], acc[g][k]);
        }
      }
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp * G + g] = m_run[g];
        l_s[warp * G + g] = l_run[g];
      }
#pragma unroll
      for (int k = 0; k < DPL; ++k) acc_s[(warp * G + g) * D + lane * DPL + k] = acc[g][k];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) m = fmaxf(m, m_s[w * G + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < K1_WARPS; ++w) {
      const float e = expf(m_s[w * G + g] - m);
      l = fmaf(l_s[w * G + g], e, l);
      o = fmaf(acc_s[(w * G + g) * D + d], e, o);
    }
    out[q_off + idx] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

inline size_t k1_smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + 2 * (size_t)K1_WARPS * G + (size_t)K1_WARPS * G * D);
}

template <typename T, int DPL, int GB>
cudaError_t launch_k1(const void* q, const void* k_pages, const void* v_pages,
                      const int* block_tables, const int* context_lens, void* out, int B,
                      int H, int KV, int P, int page, int pps, float sm_scale,
                      cudaStream_t stream) {
  const size_t smem = k1_smem_bytes(H / KV, DPL * 32);
  cudaError_t err = prepare_smem(paged_attention_kernel<T, DPL, GB>, smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<T, DPL, GB><<<dim3(B, KV), K1_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      block_tables, context_lens, static_cast<T*>(out), H, KV, P, page, pps, sm_scale);
  return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t launch_k1_g(const void* q, const void* k_pages, const void* v_pages,
                        const int* block_tables, const int* context_lens, void* out, int B,
                        int H, int KV, int P, int page, int pps, float sm_scale,
                        cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch_k1<T, DPL, 1>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                KV, P, page, pps, sm_scale, stream);
  if (G <= 2)
    return launch_k1<T, DPL, 2>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                KV, P, page, pps, sm_scale, stream);
  if (G <= 4)
    return launch_k1<T, DPL, 4>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                KV, P, page, pps, sm_scale, stream);
  return launch_k1<T, DPL, K1_MAX_G>(q, k_pages, v_pages, block_tables, context_lens, out, B,
                                     H, KV, P, page, pps, sm_scale, stream);
}

template <typename T>
cudaError_t launch_k1_d(const void* q, const void* k_pages, const void* v_pages,
                        const int* block_tables, const int* context_lens, void* out, int B,
                        int H, int KV, int D, int P, int page, int pps, float sm_scale,
                        cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_k1_g<T, 2>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                               KV, P, page, pps, sm_scale, stream);
    case 128:
      return launch_k1_g<T, 4>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                               KV, P, page, pps, sm_scale, stream);
    case 256:
      return launch_k1_g<T, 8>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                               KV, P, page, pps, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int repro_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const int* block_tables, const int* context_lens,
                                     void* out, int B, int H, int KV, int D, int P, int page,
                                     int pps, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || H / KV > repro::K1_MAX_G || page <= 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  switch (dtype) {
    case repro::F32:
      return repro::launch_k1_d<float>(q, k_pages, v_pages, block_tables, context_lens, out, B,
                                       H, KV, D, P, page, pps, sm_scale, s);
    case repro::BF16:
      return repro::launch_k1_d<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                               context_lens, out, B, H, KV, D, P, page, pps,
                                               sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
