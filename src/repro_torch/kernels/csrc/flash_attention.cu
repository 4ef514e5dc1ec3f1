// K3: flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (reached through its
// `flash_attention`). q (B, T, H, D) attends to k/v (B, S, KV, D), query
// head h reading kv head h / G (G = H / KV). The causal mask is aligned
// top-left (key s is seen by query t when s <= t, with no S - T offset),
// keys at or past S are masked and their V rows are zeroed, and the
// output is acc / max(l, 1e-30) in q's dtype, as in the TPU kernel.
//
// Bound: operations. A causal prefill does 4 * D flops for each of the
// T (T + 1) / 2 (query, key) pairs of each head, and reads each q, k, v
// element once: at T = 1280, D = 128 that is about 430 flops per byte,
// above the card's ~295 (bf16 tensor cores against HBM).
//
// The TPU grid (B, H, n_q, n_kv) runs in order and carries (m, l, acc)
// in VMEM across the kv axis; Hopper blocks run in no order, so here one
// block owns a query tile and loops over the kv tiles itself, stopping at
// the last tile that meets the diagonal (the TPU kernel's `run` test).
// Query tiles are handed out heaviest first (the last tiles of a causal
// prefill see the most keys).
//
// Two paths, by input type:
//
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//   f32 accumulation. A block of four warps owns 64 query rows of one
//   (b, h); each warp 16 rows. K and V tiles (BK, D) are copied into
//   shared memory with cp.async, two stages deep, so the next tile's loads
//   run under this tile's arithmetic; rows are padded by 8 elements so
//   that the ldmatrix reads of 8 rows hit distinct banks. Fragments come
//   out of shared memory through ldmatrix (V's transposed on the way, so
//   V is stored as it lies in memory). S = Q K^T stays in registers, the
//   online softmax (base 2) runs on the accumulator fragments with two
//   quad shuffles per row, and P is repacked in registers as the A operand
//   of P V. A warp skips the tiles wholly above its rows' diagonal. Left
//   for later: TMA and wgmma, and one K/V tile shared by the G heads of a
//   group.
// * f32 (held to 2e-5): f32 FMA on CUDA cores, never TF32, as in K1 and
//   K2. A block owns 16 rows (t, g) of one (b, kv head): the G heads of
//   a group share each staged K/V tile. The layout is K2's: each warp 4
//   rows, each lane 2 keys for the scores and D/32 columns for P V.
#include "common.cuh"

#include <cstdint>

namespace repro {

// ---------------------------------------------------------------------------
// f32 path
// ---------------------------------------------------------------------------
constexpr int K3F_ROWS = 16;                     // rows (t, g) per block ...
constexpr int K3F_WARP_ROWS = K3F_ROWS / WARPS;  // ... 4 per warp
constexpr int K3F_KEYS = 64;                     // keys staged per step: 2 per lane
constexpr int K3F_LANE_KEYS = K3F_KEYS / 32;
constexpr int K3F_MAX_COLS = 8;                  // output columns per lane: D <= 256

__global__ void __launch_bounds__(THREADS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int Tq, int S, int H,
                 int KV, int D, int causal, float sm_scale) {
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * K3F_ROWS;   // heaviest tiles first
  const int G = H / KV;
  const int R = Tq * G;               // rows of this (b, kvh): r = t * G + g
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp * K3F_WARP_ROWS;
  const int n_cols = D / 32;

  extern __shared__ float smem[];
  float* q_s = smem;                          // (K3F_ROWS, D), pre-scaled
  float* k_s = q_s + K3F_ROWS * D;            // (K3F_KEYS, D + 1): padded against bank conflicts
  float* v_s = k_s + K3F_KEYS * (D + 1);      // (K3F_KEYS, D)
  float* p_s = v_s + K3F_KEYS * D;            // (K3F_ROWS, K3F_KEYS)

  // offset of row r (< R) in q / out (B, T, H, D), divided by D
  auto row_off = [&](int r) -> long long {
    const int t = r / G, g = r - (r / G) * G;
    return ((long long)b * Tq + t) * H + (long long)kvh * G + g;
  };

  for (int i = tid; i < K3F_ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    q_s[i] = (r0 + r < R) ? q[row_off(r0 + r) * D + d] * sm_scale : 0.f;
  }
  const int t_last = (min(r0 + K3F_ROWS, R) - 1) / G;
  const int kv_end = causal ? min(S, t_last + 1) : S;
  const int n_blocks = (kv_end + K3F_KEYS - 1) / K3F_KEYS;

  int t_row[K3F_WARP_ROWS];
#pragma unroll
  for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) t_row[rr] = (r0 + rw + rr) / G;
  int k_off[K3F_LANE_KEYS];
#pragma unroll
  for (int c = 0; c < K3F_LANE_KEYS; ++c) k_off[c] = (lane + 32 * c) * (D + 1);

  float m_run[K3F_WARP_ROWS], l_run[K3F_WARP_ROWS], acc[K3F_WARP_ROWS][K3F_MAX_COLS];
#pragma unroll
  for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) {
    m_run[rr] = NEG_INF;
    l_run[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < K3F_MAX_COLS; ++c) acc[rr][c] = 0.f;
  }

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int s0 = blk * K3F_KEYS;
    const int rows = min(K3F_KEYS, S - s0);       // keys < S: staged; the rest zero
    const int used = min(K3F_KEYS, kv_end - s0);  // keys any row of the tile may see
    const long long base = (((long long)b * S + s0) * KV + kvh) * D;
    __syncthreads();   // the previous block's tiles are no longer read
    load_rows_f32(k_s, D + 1, k + base, (long long)KV * D, K3F_KEYS, rows, D);
    load_rows_f32(v_s, D, v + base, (long long)KV * D, K3F_KEYS, rows, D);
    __syncthreads();

    float sc[K3F_WARP_ROWS][K3F_LANE_KEYS];
#pragma unroll
    for (int rr = 0; rr < K3F_WARP_ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < K3F_LANE_KEYS; ++c) sc[rr][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[K3F_WARP_ROWS], kv[K3F_LANE_KEYS];
#pragma unroll
      for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) qv[rr] = q_s[(rw + rr) * D + d];
#pragma unroll
      for (int c = 0; c < K3F_LANE_KEYS; ++c) kv[c] = k_s[k_off[c] + d];
#pragma unroll
      for (int rr = 0; rr < K3F_WARP_ROWS; ++rr)
#pragma unroll
        for (int c = 0; c < K3F_LANE_KEYS; ++c) sc[rr][c] = fmaf(qv[rr], kv[c], sc[rr][c]);
    }

    // online softmax; key j is masked past S and, if causal, past the row's t
#pragma unroll
    for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < K3F_LANE_KEYS; ++c) {
        const int j = lane + 32 * c;
        if (j >= rows || (causal && s0 + j > t_row[rr])) sc[rr][c] = NEG_INF;
        mx = fmaxf(mx, sc[rr][c]);
      }
      const float m_new = fmaxf(m_run[rr], warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < K3F_LANE_KEYS; ++c) {
        sc[rr][c] = expf(sc[rr][c] - m_new);
        sum += sc[rr][c];
        p_s[(rw + rr) * K3F_KEYS + lane + 32 * c] = sc[rr][c];
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * alpha + sum;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < K3F_MAX_COLS; ++c) acc[rr][c] *= alpha;
    }
    __syncwarp();

    // acc[rr, c] += sum_j p[rr, j] v[j, lane + 32 c]; p = 0 past `used`
    for (int j = 0; j < used; ++j) {
      float pv[K3F_WARP_ROWS];
#pragma unroll
      for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) pv[rr] = p_s[(rw + rr) * K3F_KEYS + j];
#pragma unroll
      for (int c = 0; c < K3F_MAX_COLS; ++c) {
        if (c < n_cols) {
          const float vv = v_s[j * D + lane + 32 * c];
#pragma unroll
          for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) acc[rr][c] = fmaf(pv[rr], vv, acc[rr][c]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) {
    const int r = r0 + rw + rr;
    if (r < R) {
      const float l = fmaxf(l_run[rr], 1e-30f);
      const long long o = row_off(r);
#pragma unroll
      for (int c = 0; c < K3F_MAX_COLS; ++c)
        if (c < n_cols) out[o * D + lane + 32 * c] = acc[rr][c] / l;
    }
  }
}

inline size_t k3f_smem_bytes(int D) {
  return sizeof(float) * ((size_t)K3F_ROWS * D + (size_t)K3F_KEYS * (D + 1) +
                          (size_t)K3F_KEYS * D + (size_t)K3F_ROWS * K3F_KEYS);
}

// ---------------------------------------------------------------------------
// bf16 path: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------
constexpr int K3M_WARPS = 4;
constexpr int K3M_THREADS = K3M_WARPS * 32;
constexpr int K3M_BQ = 16 * K3M_WARPS;   // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l names row l % 8 of
// matrix l / 8. With .trans each lane receives a column pair instead.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without passing through registers; with
// `valid` false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async_16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round two f32 to bf16 (nearest even) and pack them, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int BK>
struct K3MLayout {
  static constexpr int RS = D + 8;    // row stride (elements) of Q, K and V in shared memory
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * ((size_t)K3M_BQ * RS + 4 * (size_t)BK * RS);   // Q + 2 x (K, V)
};

// Stage `rows` rows of D bf16 (row r from src + r * stride) into shared
// memory rows of stride RS with cp.async; rows at or past n_valid are
// zeroed and not read.
template <int D, int RS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride, int rows, int n_valid) {
  constexpr int VEC = 8;   // bf16 per 16 bytes
  for (int i = threadIdx.x; i < rows * (D / VEC); i += K3M_THREADS) {
    const int r = i / (D / VEC), c = (i - r * (D / VEC)) * VEC;
    const bool valid = r < n_valid;
    cp_async_16(dst + r * RS + c, src + (valid ? r : 0) * stride + c, valid);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(K3M_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Tq,
                 int S, int H, int KV, int causal, float sm_scale) {
  constexpr int RS = K3MLayout<D, BK>::RS;
  constexpr int NT = BK / 8;          // score n-tiles of 8 keys
  constexpr int ND = D / 8;           // output n-tiles of 8 columns
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * K3M_BQ;   // heaviest tiles first
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BQ, RS)
  __nv_bfloat16* kv_s = q_s + K3M_BQ * RS;         // stage st: K at st * 2 BK RS, V after it

  const long long q_stride = (long long)H * D;       // between query positions
  const long long kv_stride = (long long)KV * D;     // between key positions
  const __nv_bfloat16* kb = k + ((long long)b * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * S * KV + kvh) * D;

  const int q_last = min(q0 + K3M_BQ, Tq) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  auto stage_kv = [&](int tile) {
    __nv_bfloat16* ks = kv_s + (tile & 1) * 2 * BK * RS;
    const int s0 = tile * BK, rows = min(BK, S - s0);   // rows past S: zeros, V included
    stage_rows<D, RS>(ks, kb + s0 * kv_stride, kv_stride, BK, rows);
    stage_rows<D, RS>(ks + BK * RS, vb + s0 * kv_stride, kv_stride, BK, rows);
  };
  stage_rows<D, RS>(q_s, q + ((long long)b * Tq * H + h) * D + q0 * q_stride, q_stride, K3M_BQ,
                    Tq - q0);
  if (n_tiles > 0) stage_kv(0);
  cp_async_commit();

  const int row_a = q0 + warp * 16 + g;   // this thread's two rows
  const int row_b = row_a + 8;
  const float scale2 = sm_scale * LOG2E;  // softmax in base 2: exp2(s log2e) = exp(s)
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;   // l: this thread's columns only
  // ldmatrix lane addressing: row (l % 8) + 8 ((l / 8) % 2), column block l / 16
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {   // the next tile's loads overlap this tile's arithmetic
      stage_kv(tile + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* k_s = kv_s + (tile & 1) * 2 * BK * RS;
    const __nv_bfloat16* v_s = k_s + BK * RS;
    const int s0 = tile * BK;
    const bool needed = !causal || s0 <= q0 + warp * 16 + 15;   // else wholly above the diagonal
    if (needed) {
      // S = Q K^T for the warp's 16 rows: NT fragments of 16 x 8
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, q_s + (warp * 16 + lr) * RS + kc * 16 + lc);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {   // B fragments of key tiles n and n + 1
          uint32_t bk[4];
          ldmatrix_x4(bk, k_s + (n * 8 + (lane & 7) + (lane >> 4) * 8) * RS + kc * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[n], a, bk[0], bk[1]);
          mma_bf16_16816(s[n + 1], a, bk[2], bk[3]);
        }
      }

      // online softmax of rows a (fragment elements 0, 1) and b (2, 3),
      // keys past S and, if causal, past the row masked
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = s0 + n * 8 + tig * 2 + e;
          const bool in = key < S;
          s[n][e] = (in && !(causal && key > row_a)) ? s[n][e] * scale2 : NEG_INF;
          s[n][2 + e] = (in && !(causal && key > row_b)) ? s[n][2 + e] * scale2 : NEG_INF;
          mx_a = fmaxf(mx_a, s[n][e]);
          mx_b = fmaxf(mx_b, s[n][2 + e]);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the 4 lanes of a quad share a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] = exp2f(s[n][e] - mn_a);
          s[n][2 + e] = exp2f(s[n][2 + e] - mn_b);
          sum_a += s[n][e];
          sum_b += s[n][2 + e];
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= al_a;
        o[n][1] *= al_a;
        o[n][2] *= al_b;
        o[n][3] *= al_b;
      }

      // O += P V: P's accumulator fragments, repacked as bf16, are the A
      // operand; V's B fragments come transposed out of ldmatrix
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int n = 0; n < ND; n += 2) {   // B fragments of column tiles n and n + 1
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, v_s + (kc * 16 + lr) * RS + n * 8 + lc);
          mma_bf16_16816(o[n], a, bv[0], bv[1]);
          mma_bf16_16816(o[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // no copy outlives the block (S = 0 issues Q's alone)

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = out + ((long long)b * Tq * H + h) * D;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + tig * 2;
    if (row_a < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_a * q_stride + col) =
          __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    if (row_b < Tq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_b * q_stride + col) =
          __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D, int BK>
cudaError_t launch_k3_mma(const void* q, const void* k, const void* v, void* out, int B, int T,
                          int S, int H, int KV, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = K3MLayout<D, BK>::smem_bytes;
  cudaError_t err = prepare_smem(flash_mma_kernel<D, BK>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + K3M_BQ - 1) / K3M_BQ, H, B);
  flash_mma_kernel<D, BK><<<grid, K3M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T, S, H, KV,
      causal, sm_scale);
  return cudaGetLastError();
}

inline cudaError_t launch_k3_fma(const void* q, const void* k, const void* v, void* out, int B,
                                 int T, int S, int H, int KV, int D, int causal, float sm_scale,
                                 cudaStream_t stream) {
  const size_t smem = k3f_smem_bytes(D);
  cudaError_t err = prepare_smem(flash_fma_kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T * (H / KV) + K3F_ROWS - 1) / K3F_ROWS;
  flash_fma_kernel<<<dim3(tiles, KV, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), T, S, H, KV, D, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace repro

// Plain C entry point, bound with ctypes. q (B, T, H, D), k/v (B, S, KV, D)
// and out (B, T, H, D), contiguous. Returns the cudaError_t of the launch
// (0 on success); it does not synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int T, int S, int H, int KV, int D, int causal,
                                     float sm_scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || S < 0) return cudaErrorInvalidValue;
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  switch (dtype) {
    case repro::F32:
      return repro::launch_k3_fma(q, k, v, out, B, T, S, H, KV, D, causal, sm_scale, st);
    case repro::BF16:
      if (D == 64) return repro::launch_k3_mma<64, 64>(q, k, v, out, B, T, S, H, KV, causal,
                                                       sm_scale, st);
      if (D == 128) return repro::launch_k3_mma<128, 64>(q, k, v, out, B, T, S, H, KV, causal,
                                                         sm_scale, st);
      return repro::launch_k3_mma<256, 32>(q, k, v, out, B, T, S, H, KV, causal, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
