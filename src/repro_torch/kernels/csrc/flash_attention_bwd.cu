// K3-bwd: the backward of flash attention (K3) for Hopper (sm_90a).
//
// Replaces `_flash_grouped_bwd` of src/repro/models/attention.py, the
// custom VJP of the reference's training attention (XLA there: its Pallas
// kernel has no backward). Given q (B, T, H, D), k/v (B, S, KV, D), the
// forward's output o (B, T, H, D), its row log-sum-exp lse (B, H, T) f32
// (K3 writes it when asked) and the output's gradient dO, it computes
// what the reference does, FA2's backward:
//
//   delta = rowsum(dO * O)                 (f32)
//   P     = exp(scale * Q K^T - lse)       recomputed, never stored
//   dV    = P^T dO
//   dS    = P * (dO V^T - delta)
//   dQ    = scale * dS K,   dK = scale * dS^T Q
//
// with the forward's masks: the top-left causal rule (key s is seen by
// query t when s <= t), keys at or past S and, with a window (window > 0,
// the reference's `_chunk_bias`: recurrentgemma's local blocks), only the
// keys s > t - window. Query head h reads kv head h / G; dK and dV sum
// over the G heads of a group. A window bounds both loops: a key tile's
// queries end at the last that still sees one of its keys (s0 + 127 +
// window - 1), a query tile's keys start at its first row's window.
//
// The reference takes delta from its f32 output; K3 returns O in q's
// dtype, so in bf16 delta is read from the bf16 output. That gap (one
// bf16 rounding of O, 2^-9 relative) lies inside the bf16 bound.
//
// Bound: operations. A causal backward does 2.5 times the forward's
// matmul work (S, dP, dV, dK, dQ: five products of the (t, s) pairs
// against the forward's two); with bytes read once it is far above the
// card's ~295 flops per byte in bf16 (qwen3-1.7b's training shape: 4.3e10
// flop, 0.0435 ms at 989 TFLOP/s, against 0.030 ms for its bytes).
//
// Layout, deterministic and free of atomics: three launches.
// 1. delta: a row's D elements read 16 bytes a lane (a warp takes 32 / (D
//    / 8) rows in bf16), summed by shuffles. It stays a launch of its own:
//    it reads O and dO once, 0.013 of 0.164 ms at qwen3's shape (below),
//    near the card's memory rate; folded into the dQ kernel, which holds
//    dO already, it would save one read of dO, about 0.004 ms.
// 2. dK/dV: a block per (kv head, b, key tile) owns the tile's keys and
//    loops over the query tiles of all G heads of its group, so GQA's sum
//    over heads is a sum in the block's registers. Causal: the loop starts
//    at the tile's own diagonal.
// 3. dQ: a block per (head, b, query tile) loops over the key tiles up
//    to its diagonal.
// The pair (2, 3) computes S and dP in both kernels: seven products where
// FA2 does five. Five need dQ summed across key tiles (atomics, which are
// not deterministic, or a semaphore-ordered or cluster reduction): that
// is a later redesign, so the design's own floor is 7/5 of the bound.
//
// Two paths, by input type:
// * bf16, D = 64, 128 and 256: warp-specialised, in the shape of K3's
//   forward (flash_attention.cu). A block of 384 threads: two consumer
//   warpgroups of 64 own rows each (keys in 2, queries in 3) and a
//   producer warpgroup. The own side's two tiles (K and V; Q and dO) come
//   in once by TMA; the producer's one thread keeps TMA loads of the
//   other side's two tiles (Q and dO of one head; K and V) in flight,
//   STEP rows a step, into a ring behind mbarriers; in 2 a second
//   producer warp stages each step's lse (times log2 e) and delta into the
//   same stage. Tiles land with the 128-byte swizzle through per-batch
//   4-D tensor maps (D, heads, rows, batch): a box never runs from batch
//   b into b + 1, and rows past T or S arrive as zeros. The own rows sit
//   on wgmma's M: S^T = K Q^T and dP^T = V dO^T in 2 (S = Q K^T and dP =
//   dO V^T in 3) run as wgmma with both operands K-major as they lie; P =
//   exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) are
//   computed in the accumulator registers (masks as selects, not
//   branches: ptxas serialises wgmma under branches, C7520), rounded to
//   bf16 and fed back as the A operands of dV += P^T dO and dK += dS^T Q
//   in 2 (dQ += dS K in 3), whose B (dO and Q; K) is read MN-major from
//   the same swizzled tiles (the descriptor transposes them). The
//   producer drops its registers to 24 and the consumers take 240
//   (setmaxnreg): 64 keys of dK and dV are 128 f32 registers a thread at
//   D = 128. Key tile 0 (2) and the last query tile (3), the heaviest
//   when causal, are launched first. D = 64 and 128: steps of 64 rows,
//   four stages. D = 256 (MLA's padded width): the own tiles alone take
//   128 KB, so steps of 32 rows and three stages (231 KB in all), and
//   since 64 keys of dK and dV over 256 columns would take 256 registers
//   a thread, a dK/dV block accumulates 128 of the columns (a grid axis;
//   each chunk computes S^T and dP^T again) where holding dV in shared
//   memory would cost a round trip through it every step.
// * f32: f32 FMA on CUDA cores, never TF32 (held to 2e-4): 16 x 16
//   tiles staged in shared memory, each thread two (row, column) pairs
//   of the scores and D/8 output elements.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/time_flash_attention_bwd.py,
// flushed, B = 4, bf16): qwen3-1.7b's shape (T = 1024, H = 16, KV = 8, D =
// 128, causal) 0.164 ms against 0.46 for the mma.sync form it replaces:
// delta 0.013, dK/dV 0.081 and dQ 0.059 ms, each near 480 TFLOP/s on the
// products it issues (3.8x the bound; the seven products and the
// diagonal tiles' masked half are 1.6x of it). D = 64 0.107 ms (0.26);
// MLA's 256 3.57 ms (6.9); ptxas: no spills at any D. recurrentgemma's
// windowed shape (B = 1, T = 4096, H = 10, KV = 1, D = 256, window 2048;
// chip_smoke.py): 1.32 ms against its bound 0.163 (2.25 ms without the
// window): at MQA the dK/dV grid is 32 key tiles x 2 column chunks, 64
// blocks on 132 SMs, each walking all 10 heads.
//
// The outputs are written in the input dtype, as the reference casts its
// f32 gradients back.
#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

namespace repro {

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), f32, (B, H, T)
// ---------------------------------------------------------------------------
// A row of D elements is read 16 bytes a lane by LPR lanes (the rest of
// the warp takes the next rows), summed across them by shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int Tq, int H, long long rows) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = D / VEC;
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;        // lanes a row
  constexpr int RPW = 32 / LPR;                         // rows a warp
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const long long row = (blockIdx.x * (long long)WARPS + (threadIdx.x >> 5)) * RPW + lane / LPR;
  float s = 0.f;
  if (row < rows) {                                     // (b T + t) H + h
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + row * D);
#pragma unroll
    for (int c = sub; c < CHUNKS; c += LPR) {
      const uint4 ov = orow[c], dv = drow[c];
      const T* oe = reinterpret_cast<const T*>(&ov);
      const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s = fmaf(to_f32(de[j]), to_f32(oe[j]), s);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && sub == 0) {
    const long long h = row % H, bt = row / H, t = bt % Tq, b = bt / Tq;
    delta[(b * H + h) * Tq + t] = s;
  }
}

// ---------------------------------------------------------------------------
// f32 path
// ---------------------------------------------------------------------------
constexpr int BF = 16;   // rows of each side per tile

// rows [r0, r0 + BF) of a (rows, heads, D) slab at head `hd`, zeros past n
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, int r0, int n,
                                          int heads, int hd, int D) {
  for (int i = threadIdx.x; i < BF * D; i += blockDim.x) {
    const int r = i / D, d = i - (i / D) * D;
    dst[r * ld + d] = r0 + r < n ? src[((long long)(r0 + r) * heads + hd) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, int Tq, int S, int H, int KV,
                    int causal, int window, float scale) {
  constexpr int LD = D + 1, PER = BF * D / THREADS;
  extern __shared__ float smem[];
  float* k_s = smem;                // (BF, LD) keys of the block
  float* v_s = k_s + BF * LD;
  float* q_s = v_s + BF * LD;       // (BF, LD) queries of the step
  float* do_s = q_s + BF * LD;
  float* p_s = do_s + BF * LD;      // (BF keys, BF + 1 queries)
  float* ds_s = p_s + BF * (BF + 1);
  float* lse_s = ds_s + BF * (BF + 1);
  float* dl_s = lse_s + BF;
  const int b = blockIdx.z, kvh = blockIdx.y, s0 = blockIdx.x * BF, tid = threadIdx.x;
  const int G = H / KV;
  stage_f32(k_s, LD, k + (long long)b * S * KV * D, s0, S, KV, kvh, D);
  stage_f32(v_s, LD, v + (long long)b * S * KV * D, s0, S, KV, kvh, D);
  float acc_k[PER], acc_v[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) acc_k[m] = acc_v[m] = 0.f;

  // with a window, the last query that sees a key of the block
  const int t_end = window > 0 ? min(Tq, s0 + BF - 1 + window) : Tq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t0 = causal ? s0 : 0; t0 < t_end; t0 += BF) {
      __syncthreads();   // the previous step's tiles are no longer read
      stage_f32(q_s, LD, q + (long long)b * Tq * H * D, t0, Tq, H, h, D);
      stage_f32(do_s, LD, dout + (long long)b * Tq * H * D, t0, Tq, H, h, D);
      if (tid < BF) {
        const long long o = ((long long)b * H + h) * Tq + t0 + tid;
        lse_s[tid] = t0 + tid < Tq ? lse[o] : 0.f;
        dl_s[tid] = t0 + tid < Tq ? delta[o] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < BF * BF; e += THREADS) {
        const int j = e / BF, i = e - (e / BF) * BF;   // key j, query i
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(k_s[j * LD + d], q_s[i * LD + d], s);
          dp = fmaf(v_s[j * LD + d], do_s[i * LD + d], dp);
        }
        const int key = s0 + j, t = t0 + i;
        const bool ok = key < S && t < Tq && (!causal || key <= t) &&
                        (window == 0 || key > t - window);
        const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
        p_s[j * (BF + 1) + i] = p;
        ds_s[j * (BF + 1) + i] = p * (dp - dl_s[i]);
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int e = tid + m * THREADS, j = e / D, d = e - (e / D) * D;
        float av = acc_v[m], ak = acc_k[m];
#pragma unroll
        for (int i = 0; i < BF; ++i) {
          av = fmaf(p_s[j * (BF + 1) + i], do_s[i * LD + d], av);
          ak = fmaf(ds_s[j * (BF + 1) + i], q_s[i * LD + d], ak);
        }
        acc_v[m] = av;
        acc_k[m] = ak;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, j = e / D, d = e - (e / D) * D;
    if (s0 + j < S) {
      const long long o = (((long long)b * S + s0 + j) * KV + kvh) * D + d;
      dk[o] = acc_k[m] * scale;
      dv[o] = acc_v[m];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int Tq, int S, int H, int KV, int causal, int window,
                  float scale) {
  constexpr int LD = D + 1, PER = BF * D / THREADS;
  extern __shared__ float smem[];
  float* q_s = smem;                // (BF, LD) queries of the block
  float* do_s = q_s + BF * LD;
  float* k_s = do_s + BF * LD;      // (BF, LD) keys of the step
  float* v_s = k_s + BF * LD;
  float* ds_s = v_s + BF * LD;      // (BF queries, BF + 1 keys)
  float* lse_s = ds_s + BF * (BF + 1);
  float* dl_s = lse_s + BF;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * BF, tid = threadIdx.x;
  const int kvh = h / (H / KV);
  stage_f32(q_s, LD, q + (long long)b * Tq * H * D, t0, Tq, H, h, D);
  stage_f32(do_s, LD, dout + (long long)b * Tq * H * D, t0, Tq, H, h, D);
  if (tid < BF) {
    const long long o = ((long long)b * H + h) * Tq + t0 + tid;
    lse_s[tid] = t0 + tid < Tq ? lse[o] : 0.f;
    dl_s[tid] = t0 + tid < Tq ? delta[o] : 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) acc[m] = 0.f;
  const int kv_end = causal ? min(S, min(t0 + BF, Tq)) : S;
  const int kv_begin = window > 0 ? max(0, t0 - window + 1) / BF * BF : 0;
  for (int s0 = kv_begin; s0 < kv_end; s0 += BF) {
    __syncthreads();
    stage_f32(k_s, LD, k + (long long)b * S * KV * D, s0, S, KV, kvh, D);
    stage_f32(v_s, LD, v + (long long)b * S * KV * D, s0, S, KV, kvh, D);
    __syncthreads();
    for (int e = tid; e < BF * BF; e += THREADS) {
      const int i = e / BF, j = e - (e / BF) * BF;   // query i, key j
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(q_s[i * LD + d], k_s[j * LD + d], s);
        dp = fmaf(do_s[i * LD + d], v_s[j * LD + d], dp);
      }
      const int key = s0 + j, t = t0 + i;
      const bool ok = key < S && t < Tq && (!causal || key <= t) &&
                      (window == 0 || key > t - window);
      const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
      ds_s[i * (BF + 1) + j] = p * (dp - dl_s[i]);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + m * THREADS, i = e / D, d = e - (e / D) * D;
      float a = acc[m];
#pragma unroll
      for (int j = 0; j < BF; ++j) a = fmaf(ds_s[i * (BF + 1) + j], k_s[j * LD + d], a);
      acc[m] = a;
    }
  }
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, i = e / D, d = e - (e / D) * D;
    if (t0 + i < Tq) dq[(((long long)b * Tq + t0 + i) * H + h) * D + d] = acc[m] * scale;
  }
}

template <int D>
inline size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (4 * BF * (D + 1) + 2 * BF * (BF + 1) + 2 * BF);
}

// ---------------------------------------------------------------------------
// bf16 path: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Both kernels: a block of 384 threads, two consumer warpgroups of 64 rows
// of the block's own side (keys for dK/dV, queries for dQ) and a producer
// warpgroup. The own side's two tiles (K and V; Q and dO) come in once by
// TMA; the producer streams the other side's two tiles, STEP rows a step,
// into a ring of NS stages behind mbarriers. Every tile is a set of
// (rows, 64) boxes with the 128-byte swizzle, each 1024-byte aligned; TMA
// boxes are STEP rows, an own tile's 64-row boxes two of them at D = 256.
template <int D>
struct BwdTLayout {
  static constexpr int NB = D / 64;                          // 64-column boxes
  static constexpr int THREADS = 384;
  static constexpr int TILE = 128;                           // own rows a block
  static constexpr int STEP = D > 128 ? 32 : 64;             // streamed rows a step
  static constexpr int NS = D > 128 ? 3 : 4;                 // ring stages
  static constexpr int DC = D > 128 ? 128 : D;               // dK/dV columns a block
  static constexpr size_t OWN = (size_t)TILE * D * 2;        // K or V; Q or dO
  static constexpr size_t RING = (size_t)STEP * D * 2;       // one streamed tile
  static constexpr size_t ROWS = 2 * NS * STEP * sizeof(float);   // lse, delta a stage
  static constexpr size_t A_RING = 2 * OWN;                  // offsets from the base
  static constexpr size_t B_RING = A_RING + NS * RING;
  static constexpr size_t ROW_OFF = B_RING + NS * RING;
  static constexpr size_t BAR = ROW_OFF + ROWS;
  static constexpr size_t smem_bytes = 1024 + BAR + 8 * (1 + 2 * NS);
  static_assert(smem_bytes <= 232448, "the ring does not fit the block's shared memory");
};

__device__ __forceinline__ float ex2_sel(bool keep, float x) {
  return keep ? ex2_approx(x) : 0.f;
}

// A fragments of 16 columns from pairs of 8-column accumulator tiles
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    f[kc][0] = pack_bf16(x[8 * kc], x[8 * kc + 1]);
    f[kc][1] = pack_bf16(x[8 * kc + 2], x[8 * kc + 3]);
    f[kc][2] = pack_bf16(x[8 * kc + 4], x[8 * kc + 5]);
    f[kc][3] = pack_bf16(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// C (64 x N) = A (64 x D, K-major, a warpgroup's NB boxes of (64, 64))
// times B^T, B (N x D, K-major, NB boxes of (N, 64)): both operands as
// they lie, D / 16 wgmmas, one commit group
template <int D, int N>
__device__ __forceinline__ void issue_abt(float (&c)[N / 2], const __nv_bfloat16* a,
                                          const __nv_bfloat16* b) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss<N>(c, gmma_desc(a + (kc / 4) * 64 * 64 + (kc % 4) * 16, 16, 1024),
                gmma_desc(b + (kc / 4) * N * 64 + (kc % 4) * 16, 16, 1024), kc > 0);
  wgmma_commit();
}

// C (64 x D) += X (64 x K, A fragments in registers) times B (K x D), B
// the K rows of a tile of NB boxes (K, 64) read MN-major: 16 rows (2048 B)
// a k-step, K * 128 B between boxes
template <int D, int K>
__device__ __forceinline__ void issue_xb(float (&c)[D / 2], const uint32_t (&x)[K / 16][4],
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc)
    wgmma_rs<D>(c, x[kc], gmma_desc(b + kc * 16 * 64, K * 128, 1024));
}

// dK/dV: block (kv head, b, key tile x column chunk), key tile 0 first
// (when causal it sees every query). Step i is query tile j0 + i %
// per_head of head kvh G + i / per_head: the G heads of the group in
// turn, from the tile's diagonal on when causal, up to the last query
// tile its window reaches. The producer's warp 0 issues the TMA loads;
// its warp 1 stages the step's lse (times log2 e) and delta. WIN: built
// apart for a window (its per-key upper bounds take registers that the
// windowless kernel, at D = 128 on the edge of its 168, spills for).
template <int D, bool WIN>
__global__ void __launch_bounds__(384, 1)
bwd_dkdv_tma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq, int S,
                    int H, int KV, int causal, int window, float scale) {
  using L = BwdTLayout<D>;
  constexpr int NS = L::NS, NB = L::NB, BQ = L::STEP, DC = L::DC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base);   // warpgroup c: NB boxes (64, 64)
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(base + L::OWN);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base + L::A_RING);   // NS x NB boxes (BQ, 64)
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(base + L::B_RING);
  float* rows_s = reinterpret_cast<float*>(base + L::ROW_OFF);   // stage: lse log2(e) [BQ], delta [BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int s0 = blockIdx.z / (D / DC) * L::TILE, c0 = blockIdx.z % (D / DC) * DC;
  const int G = H / KV;
  const int n_t = (Tq + BQ - 1) / BQ;
  const int j0 = causal ? min(s0 / BQ, n_t) : 0;
  // with a window, the last query that sees a key of the tile is
  // s0 + TILE - 1 + window - 1
  const int j1 = WIN ? min(n_t, (s0 + L::TILE + window - 2) / BQ + 1) : n_t;
  const int per_head = max(j1 - j0, 0);
  const int n_steps = G * per_head;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform to the compiler

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1 + 32);   // the TMA thread's and warp 1's lanes' arrivals
      mbar_init(&empty[i], 8);       // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec24();
    const int pw = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0), lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0 && n_steps > 0) {
      mbar_expect_tx(own_full, (uint32_t)(2 * L::OWN));
      for (int c = 0; c < 2; ++c)
        for (int bx = 0; bx < NB; ++bx)
          for (int r = 0; r < 64; r += BQ) {
            const int o = (c * NB + bx) * 64 * 64 + r * 64, row = s0 + 64 * c + r;
            tma_load_4d(k_s + o, &tm_k, own_full, bx * 64, kvh, row, b);
            tma_load_4d(v_s + o, &tm_v, own_full, bx * 64, kvh, row, b);
          }
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % NS, g = i / per_head;
        const int h = kvh * G + g, t0 = (j0 + i - g * per_head) * BQ;
        if (i >= NS) mbar_wait(&empty[st], ((i / NS) - 1) & 1);
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::RING));
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(q_s + ((size_t)st * NB + bx) * BQ * 64, &tm_q, &full[st], bx * 64, h, t0, b);
          tma_load_4d(do_s + ((size_t)st * NB + bx) * BQ * 64, &tm_do, &full[st], bx * 64, h, t0, b);
        }
      }
    } else if (pw == 1) {
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % NS, g = i / per_head;
        const int h = kvh * G + g, t0 = (j0 + i - g * per_head) * BQ;
        if (i >= NS) mbar_wait(&empty[st], ((i / NS) - 1) & 1);
        float* r = rows_s + st * 2 * BQ;
        const long long o = ((long long)b * H + h) * Tq + t0;
        for (int e = lane; e < BQ; e += 32) {
          const bool ok = t0 + e < Tq;
          r[e] = ok ? lse[o + e] * LOG2E : 0.f;
          r[BQ + e] = ok ? delta[o + e] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: keys s0 + 64 wg .. + 63
    setmaxnreg_inc240();
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31, tq = lane & 3;
    const int key_a = s0 + 64 * wg + 16 * w + (lane >> 2), key_b = key_a + 8;
    const __nv_bfloat16* kw = k_s + (size_t)wg * 64 * D;
    const __nv_bfloat16* vw = v_s + (size_t)wg * 64 * D;
    const float scale2 = scale * LOG2E;
    constexpr int BIG = 1 << 30;

    float acc_v[DC / 2], acc_k[DC / 2];   // dV, dK (64 keys x DC columns from c0), f32
    float s[BQ / 2], dp[BQ / 2];        // S^T, dP^T (64 keys x BQ queries), then P^T, dS^T
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc_v[i] = acc_k[i] = 0.f;
    if (n_steps > 0) mbar_wait(own_full, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % NS, g = i / per_head;
      const int t0 = (j0 + i - g * per_head) * BQ;
      const __nv_bfloat16* qs = q_s + (size_t)st * BQ * D;
      const __nv_bfloat16* dos = do_s + (size_t)st * BQ * D;
      const float* lr = rows_s + st * 2 * BQ;
      mbar_wait(&full[st], (i / NS) & 1);
      wgmma_fence();
      issue_abt<D, BQ>(s, kw, qs);     // S^T = K Q^T
      issue_abt<D, BQ>(dp, vw, dos);   // dP^T = V dO^T
      // query t0 + 2 tq + c (c = 8 j + e) is kept for key k when c >= lo
      // (causal: k <= t) and c <= hi (t < T and, with a window, t < k +
      // window); a key at or past S keeps nothing. Selects, not branches:
      // s and dp are wgmma operands.
      const int hi = Tq - 1 - t0 - 2 * tq;
      const int hi_a = WIN ? min(hi, key_a + window - 1 - t0 - 2 * tq) : hi;
      const int hi_b = WIN ? min(hi, key_b + window - 1 - t0 - 2 * tq) : hi;
      const int lo_a = key_a >= S ? BIG : causal ? key_a - t0 - 2 * tq : -BIG;
      const int lo_b = key_b >= S ? BIG : causal ? key_b - t0 - 2 * tq : -BIG;
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lr + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          const float le = e ? l2.y : l2.x;
          s[4 * j + e] = ex2_sel(c >= lo_a && c <= hi_a, fmaf(s[4 * j + e], scale2, -le));
          s[4 * j + 2 + e] = ex2_sel(c >= lo_b && c <= hi_b, fmaf(s[4 * j + 2 + e], scale2, -le));
        }
      }
      pack_frags<BQ>(pa, s);
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(lr + BQ + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float de = e ? d2.y : d2.x;
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - de);
          dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - de);
        }
      }
      pack_frags<BQ>(da, dp);
      fence_regs(acc_v);
      fence_regs(acc_k);
      wgmma_fence();
      issue_xb<DC, BQ>(acc_v, pa, dos + c0 * BQ);   // dV += P^T dO (its columns from c0)
      issue_xb<DC, BQ>(acc_k, da, qs + c0 * BQ);    // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();                   // stage st and the fragments are free
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    const long long row_stride = (long long)KV * D;
    __nv_bfloat16* dkb = dk + ((long long)b * S * KV + kvh) * D;
    __nv_bfloat16* dvb = dv + ((long long)b * S * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = c0 + j * 8 + tq * 2;
      if (key_a < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_a * row_stride + col) =
            __floats2bfloat162_rn(acc_k[4 * j] * scale, acc_k[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_a * row_stride + col) =
            __floats2bfloat162_rn(acc_v[4 * j], acc_v[4 * j + 1]);
      }
      if (key_b < S) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key_b * row_stride + col) =
            __floats2bfloat162_rn(acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key_b * row_stride + col) =
            __floats2bfloat162_rn(acc_v[4 * j + 2], acc_v[4 * j + 3]);
      }
    }
  }
}

// dQ: block (head, b, query tile), the last query tile first (when causal
// it sees every key). The producer's one thread streams the K and V tiles
// up to the block's last diagonal, from its first row's window on; a
// warpgroup skips the tiles wholly past its rows' diagonal or before its
// rows' window (it still frees their stages).
template <int D>
__global__ void __launch_bounds__(384, 1)
bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, int KV, int causal,
                  int window, float scale) {
  using L = BwdTLayout<D>;
  constexpr int NS = L::NS, NB = L::NB, BK = L::STEP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base);   // warpgroup c: NB boxes (64, 64)
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(base + L::OWN);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(base + L::A_RING);   // NS x NB boxes (BK, 64)
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(base + L::B_RING);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + NS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * L::TILE;
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + L::TILE, Tq) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  // key tiles [tb, tb + n_tiles); the ring counts from tb
  const int tb = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = (kv_end + BK - 1) / BK - tb;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec24();
    if (threadIdx.x == 256) {
      mbar_expect_tx(own_full, (uint32_t)(2 * L::OWN));
      for (int c = 0; c < 2; ++c)
        for (int bx = 0; bx < NB; ++bx)
          for (int r = 0; r < 64; r += BK) {
            const int o = (c * NB + bx) * 64 * 64 + r * 64, row = q0 + 64 * c + r;
            tma_load_4d(q_s + o, &tm_q, own_full, bx * 64, h, row, b);
            tma_load_4d(do_s + o, &tm_do, own_full, bx * 64, h, row, b);
          }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % NS;
        if (i >= NS) mbar_wait(&empty[st], ((i / NS) - 1) & 1);
        mbar_expect_tx(&full[st], (uint32_t)(2 * L::RING));
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(k_s + ((size_t)st * NB + bx) * BK * 64, &tm_k, &full[st], bx * 64, kvh,
                      (tb + i) * BK, b);
          tma_load_4d(v_s + ((size_t)st * NB + bx) * BK * 64, &tm_v, &full[st], bx * 64, kvh,
                      (tb + i) * BK, b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    setmaxnreg_inc240();
    const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31, tq = lane & 3;
    const int row_base = q0 + 64 * wg;
    const int row_a = row_base + 16 * w + (lane >> 2), row_b = row_a + 8;
    const float* lb = lse + ((long long)b * H + h) * Tq;
    const float* db = delta + ((long long)b * H + h) * Tq;
    const float lse_a = row_a < Tq ? lb[row_a] * LOG2E : 0.f;
    const float lse_b = row_b < Tq ? lb[row_b] * LOG2E : 0.f;
    const float dl_a = row_a < Tq ? db[row_a] : 0.f;
    const float dl_b = row_b < Tq ? db[row_b] : 0.f;
    const float scale2 = scale * LOG2E;
    const __nv_bfloat16* qw = q_s + (size_t)wg * 64 * D;
    const __nv_bfloat16* dow = do_s + (size_t)wg * 64 * D;
    // the tiles [lo, n_wg) (counted from tb) this warpgroup reads
    const int n_wg =
        causal ? min(n_tiles, (min(S, row_base + 64) + BK - 1) / BK - tb) : n_tiles;
    const int lo = window > 0 ? min(max(0, row_base - window + 1) / BK - tb, n_wg) : 0;
    const int last_a = causal ? min(S - 1, row_a) : S - 1;
    const int last_b = causal ? min(S - 1, row_b) : S - 1;
    constexpr int BIG = 1 << 30;
    const int first_a = window > 0 ? row_a - window + 1 : -BIG;
    const int first_b = window > 0 ? row_b - window + 1 : -BIG;

    float acc[D / 2];                // dQ (64 queries x D), f32
    float s[BK / 2], dp[BK / 2];     // S, dP (64 queries x BK keys), then P, dS
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(own_full, 0);
    for (int i = 0; i < lo; ++i) {   // before the rows' window: loaded for the other warpgroup
      const int st = i % NS;
      mbar_wait(&full[st], (i / NS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    for (int i = lo; i < n_wg; ++i) {
      const int st = i % NS;
      const __nv_bfloat16* ks = k_s + (size_t)st * BK * D;
      const __nv_bfloat16* vs = v_s + (size_t)st * BK * D;
      mbar_wait(&full[st], (i / NS) & 1);
      wgmma_fence();
      issue_abt<D, BK>(s, qw, ks);     // S = Q K^T
      issue_abt<D, BK>(dp, dow, vs);   // dP = dO V^T
      // key s0 + 2 tq + c (c = 8 j + e) is kept for a row when lo_ <= c
      // <= lim: before S, (causal) at or before the row, and (window) past
      // the row's t - window
      const int s0 = (tb + i) * BK;
      const int lim_a = last_a - s0 - 2 * tq, lim_b = last_b - s0 - 2 * tq;
      const int lo_a = first_a - s0 - 2 * tq, lo_b = first_b - s0 - 2 * tq;
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          s[4 * j + e] = ex2_sel(c <= lim_a && c >= lo_a, fmaf(s[4 * j + e], scale2, -lse_a));
          s[4 * j + 2 + e] =
              ex2_sel(c <= lim_b && c >= lo_b, fmaf(s[4 * j + 2 + e], scale2, -lse_b));
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - dl_a);
          dp[4 * j + 2 + e] = s[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl_b);
        }
      pack_frags<BK>(da, dp);
      fence_regs(acc);
      wgmma_fence();
      issue_xb<D, BK>(acc, da, ks);    // dQ += dS K
      wgmma_commit();
      wgmma_wait<0>();                 // stage st and the fragments are free
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    for (int i = n_wg; i < n_tiles; ++i) {   // loaded for the other warpgroup only
      const int st = i % NS;
      mbar_wait(&full[st], (i / NS) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    const long long q_stride = (long long)H * D;
    __nv_bfloat16* qb = dq + ((long long)b * Tq * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + tq * 2;
      if (row_a < Tq)
        *reinterpret_cast<__nv_bfloat162*>(qb + row_a * q_stride + col) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (row_b < Tq)
        *reinterpret_cast<__nv_bfloat162*>(qb + row_b * q_stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int Tq, int H,
                         cudaStream_t st) {
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;
  constexpr int RPW = CHUNKS < 32 ? 32 / CHUNKS : 1;   // rows a warp
  const long long rows = (long long)B * Tq * H;
  const long long per_block = (long long)WARPS * RPW;
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  bwd_delta_kernel<T, D><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(o),
                                                     static_cast<const T*>(dout), delta, Tq, H,
                                                     rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int Tq, int H,
                         int D, cudaStream_t st) {
  if (D == 64) return launch_delta<T, 64>(o, dout, delta, B, Tq, H, st);
  if (D == 128) return launch_delta<T, 128>(o, dout, delta, B, Tq, H, st);
  return launch_delta<T, 256>(o, dout, delta, B, Tq, H, st);
}

template <int D>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, float* dq, float* dk, float* dv,
                           int B, int T, int S, int H, int KV, int causal, int window,
                           float scale, cudaStream_t st) {
  const size_t smem = bwd_f32_smem_bytes<D>();
  cudaError_t err = prepare_smem(bwd_dkdv_f32_kernel<D>, smem);
  if (err == cudaSuccess) err = prepare_smem(bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_f32_kernel<D><<<dim3((S + BF - 1) / BF, KV, B), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, S, H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_f32_kernel<D><<<dim3((T + BF - 1) / BF, H, B), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dq, T, S, H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_tma(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, __nv_bfloat16* dq,
                           __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int T, int S, int H,
                           int KV, int causal, int window, float scale, cudaStream_t st) {
  using L = BwdTLayout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  // per batch (4-D: D, heads, rows, batch): a box never runs from batch b
  // into b + 1, and rows past T or S arrive as zeros; every box is (64, STEP)
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2, (uint64_t)T * H * D * 2};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)KV, (uint64_t)S, (uint64_t)B};
  const uint64_t kst[3] = {(uint64_t)D * 2, (uint64_t)KV * D * 2, (uint64_t)S * KV * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)L::STEP, 1};
  cudaError_t err = make_tensor_map_bf16(&tm_q, q, 4, qd, qs, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_do, dout, 4, qd, qs, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_k, k, 4, kd, kst, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_v, v, 4, kd, kst, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess) err = allow_smem_once<bwd_dkdv_tma_kernel<D, false>>(L::smem_bytes);
  if (err == cudaSuccess) err = allow_smem_once<bwd_dkdv_tma_kernel<D, true>>(L::smem_bytes);
  if (err == cudaSuccess) err = allow_smem_once<bwd_dq_tma_kernel<D>>(L::smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(KV, B, (S + L::TILE - 1) / L::TILE * (D / L::DC));
  if (window > 0)
    bwd_dkdv_tma_kernel<D, true><<<grid, L::THREADS, L::smem_bytes, st>>>(
        tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, T, S, H, KV, causal, window, scale);
  else
    bwd_dkdv_tma_kernel<D, false><<<grid, L::THREADS, L::smem_bytes, st>>>(
        tm_q, tm_k, tm_v, tm_do, lse, delta, dk, dv, T, S, H, KV, causal, 0, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_tma_kernel<D><<<dim3(H, B, (T + L::TILE - 1) / L::TILE), L::THREADS, L::smem_bytes,
                         st>>>(tm_q, tm_k, tm_v, tm_do, lse, delta, dq, T, S, H, KV, causal,
                               window, scale);
  return cudaGetLastError();
}

// The launches of the bf16 path at head size D (see the entry point's plan).
template <int D>
void bwd_tma_plan(int (&v)[13]) {
  using L = BwdTLayout<D>;
  const int p[13] = {2, L::THREADS, L::TILE, L::STEP, L::NS, (int)L::smem_bytes, L::DC,
                     L::THREADS, L::TILE, L::STEP, L::NS, (int)L::smem_bytes, D};
  for (int i = 0; i < 13; ++i) v[i] = p[i];
}

}  // namespace repro

// Plain C entry point, bound with ctypes. q, o, dout and dq (B, T, H, D);
// k, v, dk and dv (B, S, KV, D), all contiguous in one dtype; lse and the
// scratch delta (B, H, T) f32; window 0 (none) or the forward's (then T <=
// S). Writes dq, dk and dv (and delta); returns the cudaError_t of the
// launches (0 on success); it does not synchronise.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse_, const void* dout,
                                         void* delta_, void* dq, void* dk, void* dv, int B,
                                         int T, int S, int H, int KV, int D, int causal,
                                         int window, float sm_scale, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse = static_cast<const float*>(lse_);
  float* delta = static_cast<float*>(delta_);
  if (KV <= 0 || H % KV != 0 || S < 0 || T < 0) return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && T > S)) return cudaErrorInvalidValue;
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  if (dtype != F32 && dtype != BF16) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || (T == 0 && S == 0)) return cudaSuccess;
  const size_t es = dtype == F32 ? 4 : 2;
  if (T == 0) {   // no query: dK = dV = 0
    cudaError_t err = cudaMemsetAsync(dk, 0, (size_t)B * S * KV * D * es, st);
    return err == cudaSuccess ? cudaMemsetAsync(dv, 0, (size_t)B * S * KV * D * es, st) : err;
  }
  if (S == 0)   // no key: dQ = 0
    return cudaMemsetAsync(dq, 0, (size_t)B * T * H * D * es, st);
  cudaError_t err = dtype == F32 ? launch_delta<float>(o, dout, delta, B, T, H, D, st)
                                 : launch_delta<__nv_bfloat16>(o, dout, delta, B, T, H, D, st);
  if (err != cudaSuccess) return err;
  if (dtype == F32) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    float *dqf = static_cast<float*>(dq), *dkf = static_cast<float*>(dk),
          *dvf = static_cast<float*>(dv);
    if (D == 64)
      return launch_bwd_f32<64>(qf, kf, vf, df, lse, delta, dqf, dkf, dvf, B, T, S, H, KV,
                                causal, window, sm_scale, st);
    if (D == 128)
      return launch_bwd_f32<128>(qf, kf, vf, df, lse, delta, dqf, dkf, dvf, B, T, S, H, KV,
                                 causal, window, sm_scale, st);
    return launch_bwd_f32<256>(qf, kf, vf, df, lse, delta, dqf, dkf, dvf, B, T, S, H, KV,
                               causal, window, sm_scale, st);
  }
  using bf = __nv_bfloat16;
  bf *dqb = static_cast<bf*>(dq), *dkb = static_cast<bf*>(dk), *dvb = static_cast<bf*>(dv);
  if (D == 64)
    return launch_bwd_tma<64>(q, k, v, dout, lse, delta, dqb, dkb, dvb, B, T, S, H, KV, causal,
                              window, sm_scale, st);
  if (D == 128)
    return launch_bwd_tma<128>(q, k, v, dout, lse, delta, dqb, dkb, dvb, B, T, S, H, KV, causal,
                               window, sm_scale, st);
  return launch_bwd_tma<256>(q, k, v, dout, lse, delta, dqb, dkb, dvb, B, T, S, H, KV, causal,
                             window, sm_scale, st);
}

// The launches a call of head size D and this dtype gets: out = {tensor
// cores (0: none, f32 FMA; 2: wgmma), then for the dK/dV kernel and for
// the dQ kernel each: threads a block, rows of the block's own side (keys;
// queries), rows of the other side a step (queries; keys), stages of the
// ring, dynamic shared memory in bytes, output columns a block}. Returns
// 0, or cudaErrorInvalidValue for a size or type the kernels do not take.
extern "C" int repro_flash_attention_bwd_plan(int D, int dtype, int* out) {
  using namespace repro;
  int v[13];
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  if (dtype == F32) {
    const int smem = (int)(D == 64    ? bwd_f32_smem_bytes<64>()
                           : D == 128 ? bwd_f32_smem_bytes<128>()
                                      : bwd_f32_smem_bytes<256>());
    const int f[13] = {0, THREADS, BF, BF, 1, smem, D, THREADS, BF, BF, 1, smem, D};
    for (int i = 0; i < 13; ++i) v[i] = f[i];
  } else if (dtype == BF16 && D == 64) {
    bwd_tma_plan<64>(v);
  } else if (dtype == BF16 && D == 128) {
    bwd_tma_plan<128>(v);
  } else if (dtype == BF16) {
    bwd_tma_plan<256>(v);
  } else {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return cudaSuccess;
}
