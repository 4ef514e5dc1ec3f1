// K2: shared-prefix ("object sharing") attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefix_kernel` of
// src/repro/kernels/shared_prefix_attention.py (reached through its
// `shared_prefix_attention`). All M requests of a prefix group attend to
// the group's one physical copy of the prefix KV, up to prefix_lens[p],
// and the kernel returns (out, lse) for the LSE merge with each request's
// own suffix.
//
// Bound: device-memory bytes at small M. The prefix K/V is read
// S * KV * D * 2 elements once per group, and each element serves the
// M * G query rows of its kv head (4 flops per row); the work only turns
// compute-bound once M * G rows outweigh the card's ~295 flops/byte.
//
// Design: one block of 128 threads per (prefix p, kv head h, tile of 16
// of the M * G query rows). The block walks S in block_s (<= 128) steps up
// to the valid length and stages each (block_s, D) K and V block in shared
// memory once, as f32, for all rows of its tile: that reuse is the point
// of the kernel, and the tile is what lets the group share one read.
// Rows of K/V at or past the valid length are never read and are zeroed
// in shared memory before P.V, as the TPU kernel zeroes its padded V
// rows. Each warp owns 4 rows of the tile. For the scores a lane holds a
// 4 x 4 register tile (its warp's 4 rows x keys lane + 32c), for P.V the
// 4 rows x columns lane + 32c: 16 FMAs per 8 shared-memory loads, in
// independent chains. The softmax runs on those registers with warp
// shuffles; running max/sum and accumulators stay in registers. Tensor-core
// (wgmma) tiles for the M * G rows and TMA loads are later work.
//
// Semantics follow the TPU kernel: out = acc / max(l, 1e-30) in q's
// dtype, lse = m + log(max(l, 1e-30)) in f32, so a zero-length prefix
// gives out = 0 and lse = -1e30.
#include "common.cuh"

namespace repro {

constexpr int K2_ROWS = 16;                      // query rows per block ...
constexpr int K2_WARP_ROWS = K2_ROWS / WARPS;    // ... 4 per warp
constexpr int K2_MAX_KEYS = 128;                 // keys staged per step: 4 per lane
constexpr int K2_LANE_KEYS = K2_MAX_KEYS / 32;
constexpr int K2_MAX_COLS = 8;                   // output columns per lane: D <= 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
shared_prefix_kernel(const T* __restrict__ q, const T* __restrict__ prefix_k,
                     const T* __restrict__ prefix_v, const int* __restrict__ prefix_lens,
                     T* __restrict__ out, float* __restrict__ lse, int M, int H, int KV, int D,
                     int S, int block_s, float sm_scale) {
  const int p = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * K2_ROWS;
  const int G = H / KV;
  const int R = M * G;               // rows of this (p, h): row r = m * G + g
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp * K2_WARP_ROWS;   // this warp's first row in the tile
  const int n_cols = D / 32;            // output columns d = lane + 32 * c

  extern __shared__ float smem[];
  float* q_s = smem;                       // (K2_ROWS, D), pre-scaled
  float* k_s = q_s + K2_ROWS * D;          // (block_s, D + 1): padded against bank conflicts
  float* v_s = k_s + block_s * (D + 1);    // (block_s, D)
  float* p_s = v_s + block_s * D;          // (K2_ROWS, block_s): each warp its own rows

  // offset of row r (< R) in q / out (P, M, H, D), divided by D
  auto row_off = [&](int r) -> long long {
    const int m = r / G, g = r - (r / G) * G;
    return ((long long)p * M + m) * H + (long long)h * G + g;
  };

  const int valid = min(max(prefix_lens[p], 0), S);
  const int n_blocks = (valid + block_s - 1) / block_s;

  for (int i = tid; i < K2_ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    q_s[i] = (r0 + r < R) ? to_f32(q[row_off(r0 + r) * D + d]) * sm_scale : 0.f;
  }
  // key rows this lane scores; rows past block_s are clamped and masked
  int k_off[K2_LANE_KEYS];
#pragma unroll
  for (int c = 0; c < K2_LANE_KEYS; ++c) k_off[c] = min(lane + 32 * c, block_s - 1) * (D + 1);

  // running max / sum of the warp's rows (the same in every lane) and the
  // accumulators of its rows at this lane's columns
  float m_run[K2_WARP_ROWS], l_run[K2_WARP_ROWS], acc[K2_WARP_ROWS][K2_MAX_COLS];
#pragma unroll
  for (int rr = 0; rr < K2_WARP_ROWS; ++rr) {
    m_run[rr] = NEG_INF;
    l_run[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < K2_MAX_COLS; ++c) acc[rr][c] = 0.f;
  }

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int s0 = blk * block_s;
    const int rows = min(block_s, valid - s0);
    const long long base = (((long long)p * S + s0) * KV + h) * D;
    __syncthreads();   // the previous block's tiles are no longer read
    load_rows_f32(k_s, D + 1, prefix_k + base, (long long)KV * D, block_s, rows, D);
    load_rows_f32(v_s, D, prefix_v + base, (long long)KV * D, block_s, rows, D);
    __syncthreads();

    // s[rr, c] = (q_rr * scale) . k_(lane + 32 c): a 4 x 4 register tile
    float sc[K2_WARP_ROWS][K2_LANE_KEYS];
#pragma unroll
    for (int rr = 0; rr < K2_WARP_ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < K2_LANE_KEYS; ++c) sc[rr][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[K2_WARP_ROWS], kv[K2_LANE_KEYS];
#pragma unroll
      for (int rr = 0; rr < K2_WARP_ROWS; ++rr) qv[rr] = q_s[(rw + rr) * D + d];
#pragma unroll
      for (int c = 0; c < K2_LANE_KEYS; ++c) kv[c] = k_s[k_off[c] + d];
#pragma unroll
      for (int rr = 0; rr < K2_WARP_ROWS; ++rr)
#pragma unroll
        for (int c = 0; c < K2_LANE_KEYS; ++c) sc[rr][c] = fmaf(qv[rr], kv[c], sc[rr][c]);
    }

    // online softmax of the warp's rows, keys at or past the valid length
    // masked; probabilities go to the warp's rows of p_s
#pragma unroll
    for (int rr = 0; rr < K2_WARP_ROWS; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < K2_LANE_KEYS; ++c) {
        if (lane + 32 * c >= rows) sc[rr][c] = NEG_INF;
        mx = fmaxf(mx, sc[rr][c]);
      }
      const float m_new = fmaxf(m_run[rr], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < K2_LANE_KEYS; ++c) {
        sc[rr][c] = expf(sc[rr][c] - m_new);
        sum += sc[rr][c];
        if (lane + 32 * c < block_s) p_s[(rw + rr) * block_s + lane + 32 * c] = sc[rr][c];
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < K2_MAX_COLS; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();

    // acc[rr, c] += sum_j p[rr, j] v[j, lane + 32 c]; p = 0 and V = 0 past `rows`
    for (int j = 0; j < rows; ++j) {
      float pv[K2_WARP_ROWS];
#pragma unroll
      for (int rr = 0; rr < K2_WARP_ROWS; ++rr) pv[rr] = p_s[(rw + rr) * block_s + j];
#pragma unroll
      for (int c = 0; c < K2_MAX_COLS; ++c) {
        if (c < n_cols) {
          const float vv = v_s[j * D + lane + 32 * c];
#pragma unroll
          for (int rr = 0; rr < K2_WARP_ROWS; ++rr) acc[rr][c] = fmaf(pv[rr], vv, acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < K2_WARP_ROWS; ++rr) {
    const int r = r0 + rw + rr;
    if (r < R) {
      const float l = fmaxf(l_run[rr], 1e-30f);
      const long long o = row_off(r);
#pragma unroll
      for (int c = 0; c < K2_MAX_COLS; ++c)
        if (c < n_cols) out[o * D + lane + 32 * c] = from_f32<T>(acc[rr][c] / l);
      if (lane == 0) lse[o] = m_run[rr] + logf(l);
    }
  }
}

inline size_t k2_smem_bytes(int D, int block_s) {
  return sizeof(float) * ((size_t)K2_ROWS * D + (size_t)block_s * (D + 1) +
                          (size_t)block_s * D + (size_t)K2_ROWS * block_s);
}

template <typename T>
cudaError_t launch_k2(const void* q, const void* prefix_k, const void* prefix_v,
                      const int* prefix_lens, void* out, float* lse, int P, int M, int H,
                      int KV, int D, int S, int block_s, float sm_scale, cudaStream_t stream) {
  const size_t smem = k2_smem_bytes(D, block_s);
  cudaError_t err = prepare_smem(shared_prefix_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (M * (H / KV) + K2_ROWS - 1) / K2_ROWS;
  shared_prefix_kernel<T><<<dim3(P, KV, tiles), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(prefix_k),
      static_cast<const T*>(prefix_v), prefix_lens, static_cast<T*>(out), lse, M, H, KV, D, S,
      block_s, sm_scale);
  return cudaGetLastError();
}

}  // namespace repro

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int repro_shared_prefix_attention(const void* q, const void* prefix_k,
                                             const void* prefix_v, const int* prefix_lens,
                                             void* out, float* lse, int P, int M, int H, int KV,
                                             int D, int S, int block_s, float sm_scale,
                                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || D % 32 != 0 || D > 32 * repro::K2_MAX_COLS ||
      block_s <= 0 || block_s > repro::K2_MAX_KEYS)
    return cudaErrorInvalidValue;
  if (P == 0 || M == 0) return cudaSuccess;
  switch (dtype) {
    case repro::F32:
      return repro::launch_k2<float>(q, prefix_k, prefix_v, prefix_lens, out, lse, P, M, H, KV,
                                     D, S, block_s, sm_scale, s);
    case repro::BF16:
      return repro::launch_k2<__nv_bfloat16>(q, prefix_k, prefix_v, prefix_lens, out, lse, P,
                                             M, H, KV, D, S, block_s, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
