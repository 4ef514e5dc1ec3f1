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
// A window (window > 0) keeps only the keys s > t - window, the mask of the
// reference's `_chunk_bias` (src/repro/models/attention.py:41), whose
// `_flash_fwd` (:56, XLA) runs it for the local blocks (recurrentgemma's
// window of 2048): with causal, the last `window` keys up to t; without,
// every key past t - window. Each block starts at the first tile its first
// row's window reaches and each warpgroup at its own: recurrentgemma's
// T = 4096 at window 2048 attends 6.29 M pairs a head against the causal
// mask's 8.39 M (0.162 against 0.197 ms on an H100, chip_smoke.py). Rows of one
// block no longer share their first key: a tile can lie wholly before the
// window of a block's later rows, which must take nothing from it, so masked
// scores are -inf, not the reference's -1e30: a row that has seen no key
// yet (m = -1e30) then adds exp(-inf) = 0, not exp(0) = 1, and its (m, l)
// stay as they were. No row that sees a key differs from a -1e30 mask, and
// a window of at least T is the causal kernel bit for bit.
//
// Bound: operations. A causal prefill does 4 * D flops for each of the
// T (T + 1) / 2 (query, key) pairs of each head, and reads each q, k, v
// element once: at T = 1280, D = 128 that is about 430 flops per byte,
// above the card's ~295 (bf16 tensor cores against HBM). wgmma is the only
// way to the tensor cores' full rate.
//
// The TPU grid (B, H, n_q, n_kv) runs in order and carries (m, l, acc)
// in VMEM across the kv axis; Hopper blocks run in no order, so here one
// block owns a query tile and loops over the kv tiles itself, stopping at
// the last tile that meets the diagonal (the TPU kernel's `run` test).
//
// Two paths, by input type:
//
// * bf16 (the serving path), D in {64, 128, 256}: warp-specialised, in
//   the shape of FlashAttention-3. A block of 384 threads owns 128 query
//   rows of one (b, h): one producer warpgroup, whose one thread keeps TMA
//   loads of the K and V tiles (128 keys; 64 at D = 256) in flight into a
//   ring of three stages (two at D = 256) behind mbarriers, and two
//   consumer warpgroups of 64 rows each (chosen over one consumer
//   warpgroup and over 64-key tiles at D = 128, by measurement). Q comes in
//   once by TMA. Tiles land with the 128-byte swizzle that wgmma reads.
//   S = Q K^T runs as wgmma with both operands K-major in shared memory;
//   the online softmax (base 2; exp2 on the MUFU unit, the score scale
//   folded into one FMA) runs on the accumulator registers, masking only
//   the tiles that reach past S or the diagonal; O += P V runs as wgmma
//   with P from registers (bf16, the accumulator layout is already the A
//   fragment layout) and V MN-major from shared memory as it lies (the
//   descriptor transposes it). Within a warpgroup S of tile i + 1 and P V
//   of tile i go to the tensor cores together, and the softmax of tile
//   i + 1 runs while P V of tile i does. The producer drops its registers
//   to 40 and the consumers take 232 (setmaxnreg). The tensor maps are
//   per batch (4-D: D, heads, rows, batch), so a box never runs from batch
//   b into b + 1 and rows past T or S arrive as zeros, V's included. The
//   query tile is the grid's slowest axis, heaviest (last, causal) tiles
//   first across all heads; a warpgroup skips the tiles wholly above its
//   rows' diagonal.
// * f32 (held to 2e-5): f32 FMA on CUDA cores, never TF32, as in K1 and
//   K2. A block owns 16 rows (t, g) of one (b, kv head): the G heads of
//   a group share each staged K/V tile. The layout is K2's: each warp 4
//   rows, each lane 2 keys for the scores and D/32 columns for P V.
//
// Training asks for the rows' log-sum-exp as well (the residual the
// backward, flash_attention_bwd.cu, recomputes P from): given a non-null
// `lse` (B, H, T) f32, both paths write lse = m + log(max(l, 1e-30)) in
// natural units, the bf16 path from the row's (m, l) once its quad of
// lanes has summed l. A null `lse` writes nothing (every serving launch).
#include "common.cuh"
#include "hopper.cuh"

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
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Tq, int S, int H, int KV, int D, int causal,
                 int window, float sm_scale) {
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
  // a window starts the keys at the first row's (rows r = t G + g rise in t)
  const int kv_begin = window > 0 ? max(0, r0 / G - window + 1) / K3F_KEYS * K3F_KEYS : 0;
  const float masked = __int_as_float(0xff800000u);   // -inf: adds exp(-inf) = 0 to any row

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

  for (int s0 = kv_begin; s0 < kv_end; s0 += K3F_KEYS) {
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

    // online softmax; key j is masked past S, if causal past the row's t,
    // and with a window at or before t - window
#pragma unroll
    for (int rr = 0; rr < K3F_WARP_ROWS; ++rr) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < K3F_LANE_KEYS; ++c) {
        const int j = lane + 32 * c;
        if (j >= rows || (causal && s0 + j > t_row[rr]) ||
            (window > 0 && s0 + j <= t_row[rr] - window))
          sc[rr][c] = masked;
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
      if (lse != nullptr && lane == 0) {
        const int t = r / G, h = kvh * G + (r - t * G);
        lse[((long long)b * H + h) * Tq + t] = m_run[rr] + logf(l);
      }
    }
  }
}

inline size_t k3f_smem_bytes(int D) {
  return sizeof(float) * ((size_t)K3F_ROWS * D + (size_t)K3F_KEYS * (D + 1) +
                          (size_t)K3F_KEYS * D + (size_t)K3F_ROWS * K3F_KEYS);
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------
template <int D, int BK, int NC>
struct K3TLayout {
  static constexpr int NB = D / 64;                              // 64-column boxes (128 B rows)
  static constexpr int THREADS = 128 * (NC + 1);                 // NC consumer warpgroups + producer
  static constexpr int BQ = 64 * NC;                             // query rows per block
  static constexpr size_t Q_BYTES = (size_t)BQ * D * 2;
  static constexpr size_t KV_TILE = (size_t)BK * D * 2;          // one K or V tile
  static constexpr size_t MAX_SMEM = 232448;                     // per block on an H100
  // K/V ring depth: three stages where they fit beside Q, else two
  static constexpr int NS = Q_BYTES + 6 * KV_TILE + 2048 <= MAX_SMEM ? 3 : 2;
  static constexpr size_t BAR = Q_BYTES + 2 * NS * KV_TILE;
  static constexpr size_t smem_bytes = 1024 + BAR + 8 * (1 + 3 * NS);
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BK, int NC>
__global__ void __launch_bounds__(K3TLayout<D, BK, NC>::THREADS, 1)
flash_tma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int Tq, int S, int H, int KV, int causal,
                 int window, float scale2) {
  using L = K3TLayout<D, BK, NC>;
  constexpr int NS = L::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);   // warpgroup c: NB boxes (64, 64)
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base + L::Q_BYTES);   // NS x NB boxes (BK, 64)
  __nv_bfloat16* v_s = k_s + NS * (size_t)BK * D;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + NS;
  uint64_t* empty = bars + 1 + 2 * NS;

  // the query tile is the grid's slowest axis, heaviest (last) tiles first
  // across all heads: the first wave takes the longest causal rows
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::BQ;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + L::BQ, Tq) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  // tiles [tb, tb + n_tiles): a window starts them at the first row's
  // first key; the ring's stages and parities count from tile tb
  const int tb = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = (kv_end + BK - 1) / BK - tb;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 4 * NC);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: one thread keeps the ring's TMA loads in flight
    if constexpr (NC > 1) setmaxnreg_dec40();
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(q_full, (uint32_t)L::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load_4d(q_s + (c * L::NB + bx) * 64 * 64, &tm_q, q_full, bx * 64, h, q0 + 64 * c, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % NS;
        if (i >= NS) mbar_wait(&empty[st], ((i / NS) - 1) & 1);   // consumers done with it
        __nv_bfloat16* ks = k_s + (size_t)st * BK * D;
        __nv_bfloat16* vs = v_s + (size_t)st * BK * D;
        mbar_expect_tx(&k_full[st], (uint32_t)L::KV_TILE);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load_4d(ks + bx * BK * 64, &tm_k, &k_full[st], bx * 64, kvh, (tb + i) * BK, b);
        mbar_expect_tx(&v_full[st], (uint32_t)L::KV_TILE);
        for (int bx = 0; bx < L::NB; ++bx)
          tma_load_4d(vs + bx * BK * 64, &tm_v, &v_full[st], bx * 64, kvh, (tb + i) * BK, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    if constexpr (NC > 1) setmaxnreg_inc232();
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31, tq = lane & 3;
    const int row_base = q0 + 64 * wg;
    const int row_a = row_base + 16 * w + (lane >> 2), row_b = row_a + 8;
    const __nv_bfloat16* qw = q_s + (size_t)wg * 64 * D;
    // the tiles [lo, n_wg) this warpgroup reads (counted from tb): the rest
    // lie wholly above its diagonal or before its first row's window (a
    // warpgroup of rows past T only keeps one, which it reads and drops)
    const int n_wg =
        causal ? min(n_tiles, (min(S, row_base + 64) + BK - 1) / BK - tb) : n_tiles;
    const int lo = window > 0 ? min(max(0, row_base - window + 1) / BK - tb, n_wg - 1) : 0;
    const float masked = __int_as_float(0xff800000u);   // -inf: adds exp(-inf) = 0 to any row

    float o[D / 2];        // O (64 x D), f32
    float s[BK / 2];       // S = Q K^T of one tile, then its probabilities
    uint32_t pa[BK / 16][4];   // P in bf16 as the A operand of P V, 16 keys per step
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;   // m in log2 units; l: own columns

    auto issue_s = [&](int i) {   // S = Q K_i^T, both K-major and 128-byte swizzled
      const __nv_bfloat16* ks = k_s + (size_t)(i % NS) * BK * D;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wgmma_ss<BK>(s, gmma_desc(qw + (kc / 4) * 64 * 64 + (kc % 4) * 16, 16, 1024),
                     gmma_desc(ks + (kc / 4) * BK * 64 + (kc % 4) * 16, 16, 1024), kc > 0);
      wgmma_commit();
    };
    // online softmax (base 2) of tile i in s: rows a (elements 4j, 4j + 1)
    // and b (4j + 2, 4j + 3). Keys past S, if causal past the row, and with
    // a window before the row's first key are masked to -inf, so a row
    // that sees none of the tile keeps its m and l. Leaves exp2 values in s
    // and returns the factors by which the older O rows shrink.
    auto softmax = [&](int i, float& al_a, float& al_b) {
      const int s0 = (tb + i) * BK;
      // key s0 + 2 tq + c (c = 8 j + e) is masked for row a when c > lim_a
      // (past S, or past the row if causal) or c < first_a (before its
      // window); interior tiles mask nothing. Selects, not branches: s is
      // a wgmma operand.
      const int last_a = causal ? min(S - 1, row_a) : S - 1;
      const int last_b = causal ? min(S - 1, row_b) : S - 1;
      const int lim_a = last_a - s0 - 2 * tq, lim_b = last_b - s0 - 2 * tq;
      const int first_a = window > 0 ? row_a - window + 1 - s0 - 2 * tq : -BK;
      const int first_b = window > 0 ? row_b - window + 1 - s0 - 2 * tq : -BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + e;
          s[4 * j + e] = c > lim_a || c < first_a ? masked : s[4 * j + e];
          s[4 * j + 2 + e] = c > lim_b || c < first_b ? masked : s[4 * j + 2 + e];
        }
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the 4 lanes of a quad share a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a * scale2), mn_b = fmaxf(m_b, mx_b * scale2);
      al_a = ex2(m_a - mn_a);
      al_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = ex2(fmaf(s[4 * j + e], scale2, -mn_a));
          s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], scale2, -mn_b));
          sum_a += s[4 * j + e];
          sum_b += s[4 * j + 2 + e];
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
    };
    auto pack_p = [&]() {   // two accumulator tiles of 8 keys make one A fragment of 16
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
        pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
        pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
        pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
      }
    };

    // P_i V_i on the tensor cores: V (BK x D) is MN-major as it lies, 16 key
    // rows (2048 B) per k-step and BK * 128 B between its 64-column boxes
    auto issue_pv = [&](int i) {
      const __nv_bfloat16* vs = v_s + (size_t)(i % NS) * BK * D;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
        wgmma_rs<D>(o, pa[kc], gmma_desc(vs + kc * 16 * 64, BK * 128, 1024));
      wgmma_commit();
    };
    for (int i = 0; i < lo; ++i) {   // before this warpgroup's window: loaded for the other
      const int st = i % NS;
      mbar_wait(&k_full[st], (i / NS) & 1);
      mbar_wait(&v_full[st], (i / NS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // S > 0 here, so the warpgroup reads one tile at least (lo < n_wg). No
    // wgmma and no register it touches sits under a branch: the compiler
    // would serialise the wgmmas.
    float al_a, al_b;
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[lo % NS], (lo / NS) & 1);
    wgmma_fence();
    issue_s(lo);
    wgmma_wait<0>();
    fence_regs(s);
    softmax(lo, al_a, al_b);   // O is still zero
    pack_p();
    // Tile i: S of tile i + 1 and O += P_i V_i go to the tensor cores
    // together, and the softmax of tile i + 1 runs while P_i V_i does.
    for (int i = lo; i + 1 < n_wg; ++i) {
      const int st = i % NS;
      mbar_wait(&k_full[(i + 1) % NS], ((i + 1) / NS) & 1);
      mbar_wait(&v_full[st], (i / NS) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_s(i + 1);
      issue_pv(i);
      wgmma_wait<1>();   // S of tile i + 1 is in
      fence_regs(s);
      softmax(i + 1, al_a, al_b);
      wgmma_wait<0>();   // P_i V_i is in: stage st and pa are free
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
      pack_p();
    }
    {  // the last tile: P V only
      const int i = n_wg - 1, st = i % NS;
      mbar_wait(&v_full[st], (i / NS) & 1);
      fence_regs(o);
      wgmma_fence();
      issue_pv(i);
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    for (int i = n_wg; i < n_tiles; ++i) {   // loaded for the other warpgroup only
      const int st = i % NS;
      mbar_wait(&k_full[st], (i / NS) & 1);
      mbar_wait(&v_full[st], (i / NS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    if (lse != nullptr && tq == 0) {   // m is in log2 units: lse = m ln 2 + log(l)
      float* lb = lse + ((long long)b * H + h) * Tq;
      if (row_a < Tq) lb[row_a] = m_a * LN2 + logf(fmaxf(l_a, 1e-30f));
      if (row_b < Tq) lb[row_b] = m_b * LN2 + logf(fmaxf(l_b, 1e-30f));
    }
    const long long q_stride = (long long)H * D;
    __nv_bfloat16* ob = out + ((long long)b * Tq * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tq * 2;
      if (row_a < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_a * q_stride + col) =
            __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
      if (row_b < Tq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row_b * q_stride + col) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
    }
  }
}

template <int D, int BK, int NC>
void k3t_plan(int (&v)[5]) {
  using L = K3TLayout<D, BK, NC>;
  v[0] = L::THREADS;
  v[1] = L::BQ;
  v[2] = BK;
  v[3] = L::NS;
  v[4] = (int)L::smem_bytes;
}

template <int D, int BK, int NC>
cudaError_t launch_k3_tma(const void* q, const void* k, const void* v, void* out, float* lse,
                          int B, int T, int S, int H, int KV, int causal, int window,
                          float sm_scale, cudaStream_t stream) {
  using L = K3TLayout<D, BK, NC>;
  CUtensorMap tm_q, tm_k, tm_v;
  // per batch (4-D): a box never runs from batch b into b + 1, and rows
  // past T or S arrive as zeros
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2, (uint64_t)T * H * D * 2};
  const uint32_t qbox[4] = {64, 1, 64, 1};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)KV, (uint64_t)S, (uint64_t)B};
  const uint64_t kst[3] = {(uint64_t)D * 2, (uint64_t)KV * D * 2, (uint64_t)S * KV * D * 2};
  const uint32_t kbox[4] = {64, 1, (uint32_t)BK, 1};
  cudaError_t err = make_tensor_map_bf16(&tm_q, q, 4, qd, qs, qbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_k, k, 4, kd, kst, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_v, v, 4, kd, kst, kbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = allow_smem_once<flash_tma_kernel<D, BK, NC>>(L::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (T + L::BQ - 1) / L::BQ);
  flash_tma_kernel<D, BK, NC><<<grid, L::THREADS, L::smem_bytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, T, S, H, KV, causal, window,
      sm_scale * LOG2E);
  return cudaGetLastError();
}

inline cudaError_t launch_k3_fma(const void* q, const void* k, const void* v, void* out,
                                 float* lse, int B, int T, int S, int H, int KV, int D,
                                 int causal, int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = k3f_smem_bytes(D);
  cudaError_t err = prepare_smem(flash_fma_kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T * (H / KV) + K3F_ROWS - 1) / K3F_ROWS;
  flash_fma_kernel<<<dim3(tiles, KV, B), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, T, S, H, KV, D, causal, window, sm_scale);
  return cudaGetLastError();
}

__global__ void fill_kernel(float* __restrict__ x, long long n, float value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    x[i] = value;
}

}  // namespace repro

// Plain C entry point, bound with ctypes. q (B, T, H, D), k/v (B, S, KV, D)
// and out (B, T, H, D), contiguous; lse (B, H, T) f32 or null (not
// written); window 0 (none) or the keys s > t - window (then T <= S, so
// that every row sees a key). Returns the cudaError_t of the launch (0 on
// success); it does not synchronise.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse_, int B, int T, int S, int H, int KV, int D,
                                     int causal, int window, float sm_scale, int dtype,
                                     void* stream) {
  float* lse = static_cast<float*>(lse_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || S < 0) return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && T > S)) return cudaErrorInvalidValue;
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  switch (dtype) {
    case repro::F32:
      return repro::launch_k3_fma(q, k, v, out, lse, B, T, S, H, KV, D, causal, window,
                                  sm_scale, st);
    case repro::BF16:
      if (S == 0) {   // no key: out = acc / max(l, 1e-30) = 0, lse = -1e30 + log(1e-30)
        cudaError_t err =
            cudaMemsetAsync(out, 0, (size_t)B * T * H * D * sizeof(__nv_bfloat16), st);
        if (err != cudaSuccess || lse == nullptr) return err;
        repro::fill_kernel<<<64, 256, 0, st>>>(lse, (long long)B * H * T, repro::NEG_INF);
        return cudaGetLastError();
      }
      if (D == 64)
        return repro::launch_k3_tma<64, 128, 2>(q, k, v, out, lse, B, T, S, H, KV, causal,
                                                window, sm_scale, st);
      if (D == 128)
        return repro::launch_k3_tma<128, 128, 2>(q, k, v, out, lse, B, T, S, H, KV, causal,
                                                 window, sm_scale, st);
      return repro::launch_k3_tma<256, 64, 2>(q, k, v, out, lse, B, T, S, H, KV, causal,
                                              window, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch a call of head size D and this dtype gets: out = {threads per
// block, query rows per block, keys per tile, K/V stages, dynamic shared
// memory in bytes}. Returns 0, or cudaErrorInvalidValue for a size or type
// the kernels do not take.
extern "C" int repro_flash_attention_plan(int D, int dtype, int* out) {
  int v[5];
  if (dtype == repro::F32 && (D == 64 || D == 128 || D == 256)) {
    const int f[5] = {repro::THREADS, repro::K3F_ROWS, repro::K3F_KEYS, 1,
                      (int)repro::k3f_smem_bytes(D)};
    for (int i = 0; i < 5; ++i) v[i] = f[i];
  } else if (dtype == repro::BF16 && D == 64) {
    repro::k3t_plan<64, 128, 2>(v);
  } else if (dtype == repro::BF16 && D == 128) {
    repro::k3t_plan<128, 128, 2>(v);
  } else if (dtype == repro::BF16 && D == 256) {
    repro::k3t_plan<256, 64, 2>(v);
  } else {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return cudaSuccess;
}
