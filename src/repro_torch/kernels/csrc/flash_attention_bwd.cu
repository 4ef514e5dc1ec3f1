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
// query t when s <= t) and keys at or past S. Query head h reads kv head
// h / G; dK and dV sum over the G heads of a group.
//
// The reference takes delta from its f32 output; K3 returns O in q's
// dtype, so in bf16 delta is read from the bf16 output. That gap (one
// bf16 rounding of O, 2^-9 relative) lies inside the bf16 bound.
//
// Bound: operations. A causal backward does 2.5 times the forward's
// matmul work (S, dP, dV, dK, dQ: five products of the (t, s) pairs
// against the forward's two); with bytes read once it is far above the
// card's ~295 flops per byte in bf16.
//
// Layout, deterministic and free of atomics: three launches.
// 1. delta: one warp per row (b, t, h).
// 2. dK/dV: a block per (b, kv head, key tile, column chunk) owns the
//    tile's keys and loops over the query tiles of all G heads of its
//    group, so GQA's sum over heads is a sum in the block's registers.
//    Causal: the loop starts at the tile's own diagonal.
// 3. dQ: a block per (b, head, query tile) loops over the key tiles up
//    to its diagonal.
// The pair (2, 3) recomputes S and P once more than FA2's atomic dQ
// (seven products where FA2 does five), the price of no atomics.
//
// Two paths, by input type:
// * bf16: tensor cores through mma.sync m16n8k16 (mma.cuh) with f32
//   accumulation; a warp owns 16 rows of its block's side (keys in 2,
//   queries in 3) and keeps their f32 accumulators in registers. Tiles
//   come in by cp.async into shared memory rows padded by 16 bytes (so
//   ldmatrix reads 8 rows without bank conflicts); operands that the
//   products need transposed are read with ldmatrix.trans as they lie.
//   P and dS are rounded to bf16 as the A operands of the next products
//   (as K3 rounds P for P V). At D = 256 the dK/dV accumulators of 16
//   rows would take 256 registers a thread, so that kernel takes the
//   output columns 128 at a time (a grid axis; each chunk recomputes S
//   and dP), and dQ's key tiles are 32 wide. No wgmma or TMA yet: that
//   is a later redesign.
// * f32: f32 FMA on CUDA cores, never TF32 (held to 2e-4): 16 x 16
//   tiles staged in shared memory, each thread two (row, column) pairs
//   of the scores and D/8 output elements.
// The outputs are written in the input dtype, as the reference casts its
// f32 gradients back.
#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace repro {

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), f32, (B, H, T)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int Tq, int H, int D, long long rows) {
  const long long row = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);   // (b T + t) H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;   // the whole warp: row is per warp
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(to_f32(drow[d]), to_f32(orow[d]), s);
  s = warp_sum(s);
  if (lane == 0) {
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
                    int causal, float scale) {
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

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t0 = causal ? s0 : 0; t0 < Tq; t0 += BF) {
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
        const bool ok = key < S && t < Tq && (!causal || key <= t);
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
                  float* __restrict__ dq, int Tq, int S, int H, int KV, int causal, float scale) {
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
  for (int s0 = 0; s0 < kv_end; s0 += BF) {
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
      const bool ok = key < S && t < Tq && (!causal || key <= t);
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
// bf16 path: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------
constexpr int BR = 16 * WARPS;   // rows of the block's own side: 16 a warp

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + rows) of a (rows, heads, D) bf16 slab at head `hd` into
// shared memory rows of `ld` elements by cp.async, zeros past n
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           int r0, int rows, int n, int heads, int hd) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i - (i / CH) * CH) * 8;
    const bool ok = r0 + r < n;
    cp_async_16(dst + r * ld + c,
                ok ? src + ((long long)(r0 + r) * heads + hd) * D + c : src, ok);
  }
}

// shared-memory element offsets of the mma fragments (ldmatrix addressing):
// an A fragment (16 rows x 16) of a row-major tile, and the B fragments of
// two 8-column blocks read from the tile that holds B^T row-major (n, k)
__device__ __forceinline__ int a_off(int ld, int row0, int k0, int lane) {
  return (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int bt_off(int ld, int n0, int k0, int lane) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8;
}
// ... and of two 8-column blocks of B read from B row-major (k, n), transposed
__device__ __forceinline__ int b_trans_off(int ld, int k0, int n0, int lane) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// C (16 x 8N) += A (16 rows at a_row of tile `a`, all D columns) times the
// transposes of N * 8 rows of tile `bt` (B^T row-major): a warp's scores
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N][4], const __nv_bfloat16* a, int a_row,
                                        const __nv_bfloat16* bt, int ld, int lane) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_off(ld, a_row, kc * 16, lane));
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bt + bt_off(ld, n * 8, kc * 16, lane));
      mma_bf16_16816(c[n], af, bf[0], bf[1]);
      mma_bf16_16816(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

// C (16 x NC) += X (16 x 8N, f32 accumulator layout, rounded to bf16 as
// A fragments) times rows 0 .. 8N of tile `b` (row-major, k = row),
// columns c0 .. c0 + NC
template <int N, int NC>
__device__ __forceinline__ void mma_xb(float (&c)[NC / 8][4], const float (&x)[N][4],
                                       const __nv_bfloat16* b, int ld, int c0, int lane) {
#pragma unroll
  for (int kc = 0; kc < N / 2; ++kc) {
    const uint32_t af[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                            pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                            pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int n = 0; n < NC / 8; n += 2) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + b_trans_off(ld, kc * 16, c0 + n * 8, lane));
      mma_bf16_16816(c[n], af, bf[0], bf[1]);
      mma_bf16_16816(c[n + 1], af, bf[2], bf[3]);
    }
  }
}

template <int D, int DC, int BQ>
struct DkdvLayout {
  static constexpr int LD = D + 8;                   // padded row, elements
  static constexpr size_t smem_bytes =
      2 * (size_t)(2 * BR + 2 * BQ) * LD + 2 * sizeof(float) * BQ;
};

// dK/dV: block (key tile x column chunk, kv head, b); warp w owns keys
// s0 + 16 w .. + 15 and output columns c0 .. c0 + DC
template <int D, int DC, int BQ>
__global__ void __launch_bounds__(THREADS)
bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                     int S, int H, int KV, int causal, float scale) {
  using L = DkdvLayout<D, DC, BQ>;
  constexpr int LD = L::LD, NQ = BQ / 8, NC = DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BR, LD)
  __nv_bfloat16* v_s = k_s + BR * LD;
  __nv_bfloat16* q_s = v_s + BR * LD;                                // (BQ, LD)
  __nv_bfloat16* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);           // lse log2(e)
  float* dl_s = lse_s + BQ;

  const int n_chunks = D / DC;
  const int s0 = (blockIdx.x / n_chunks) * BR, c0 = (blockIdx.x % n_chunks) * DC;
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g8 = lane >> 2, tq = lane & 3;
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* qb = q + (long long)b * Tq * H * D;
  const __nv_bfloat16* dob = dout + (long long)b * Tq * H * D;
  stage_bf16<D>(k_s, LD, k + (long long)b * S * KV * D, s0, BR, S, KV, kvh);
  stage_bf16<D>(v_s, LD, v + (long long)b * S * KV * D, s0, BR, S, KV, kvh);
  cp_async_commit();
  cp_async_wait<0>();   // (the first step's barrier publishes them)

  float acc_k[NC][4], acc_v[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int key_a = s0 + 16 * w + g8;   // this lane's keys: key_a, key_a + 8

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int t0 = causal ? s0 : 0; t0 < Tq; t0 += BQ) {
      __syncthreads();   // the previous step's tiles are no longer read
      stage_bf16<D>(q_s, LD, qb, t0, BQ, Tq, H, h);
      stage_bf16<D>(do_s, LD, dob, t0, BQ, Tq, H, h);
      cp_async_commit();
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const long long o = ((long long)b * H + h) * Tq + t0 + i;
        lse_s[i] = t0 + i < Tq ? lse[o] * LOG2E : 0.f;
        dl_s[i] = t0 + i < Tq ? delta[o] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // a warp whose keys all lie past the step's last query sees nothing
      if (causal && s0 + 16 * w > t0 + BQ - 1) continue;

      float st[NQ][4], dp[NQ][4];   // S^T and dP^T (16 keys x BQ queries)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dp[n][e] = 0.f;
      mma_abt<D, NQ>(st, k_s, 16 * w, q_s, LD, lane);
      mma_abt<D, NQ>(dp, v_s, 16 * w, do_s, LD, lane);
      // P^T = exp(scale s - lse) where attendable, dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 8 + 2 * tq + (e & 1), t = t0 + i, key = key_a + (e >> 1) * 8;
          const bool ok = key < S && t < Tq && (!causal || key <= t);
          const float p = ok ? ex2_approx(fmaf(st[n][e], scale2, -lse_s[i])) : 0.f;
          st[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dl_s[i]);
        }
      mma_xb<NQ, DC>(acc_v, st, do_s, LD, c0, lane);   // dV += P^T dO
      mma_xb<NQ, DC>(acc_k, dp, q_s, LD, c0, lane);    // dK += dS^T Q
    }
  }
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = key_a + 8 * hf, col = c0 + n * 8 + 2 * tq;
      if (key < S) {
        const long long o = (((long long)b * S + key) * KV + kvh) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(acc_k[n][2 * hf] * scale, acc_k[n][2 * hf + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
      }
    }
}

template <int D, int BK>
struct DqLayout {
  static constexpr int LD = D + 8;
  static constexpr size_t smem_bytes =
      2 * (size_t)(2 * BR + 2 * BK) * LD + 2 * sizeof(float) * BR;
};

// dQ: block (query tile, head, b); warp w owns queries t0 + 16 w .. + 15
template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, int KV, int causal,
                   float scale) {
  using L = DqLayout<D, BK>;
  constexpr int LD = L::LD, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // (BR, LD)
  __nv_bfloat16* do_s = q_s + BR * LD;
  __nv_bfloat16* k_s = do_s + BR * LD;                               // (BK, LD)
  __nv_bfloat16* v_s = k_s + BK * LD;
  float* lse_s = reinterpret_cast<float*>(v_s + BK * LD);            // lse log2(e)
  float* dl_s = lse_s + BR;

  const int t0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g8 = lane >> 2, tq = lane & 3;
  const float scale2 = scale * LOG2E;
  const __nv_bfloat16* kb = k + (long long)b * S * KV * D;
  const __nv_bfloat16* vb = v + (long long)b * S * KV * D;
  stage_bf16<D>(q_s, LD, q + (long long)b * Tq * H * D, t0, BR, Tq, H, h);
  stage_bf16<D>(do_s, LD, dout + (long long)b * Tq * H * D, t0, BR, Tq, H, h);
  cp_async_commit();
  cp_async_wait<0>();
  for (int i = threadIdx.x; i < BR; i += THREADS) {
    const long long o = ((long long)b * H + h) * Tq + t0 + i;
    lse_s[i] = t0 + i < Tq ? lse[o] * LOG2E : 0.f;
    dl_s[i] = t0 + i < Tq ? delta[o] : 0.f;
  }
  __syncthreads();
  const int r_a = 16 * w + g8, t_a = t0 + r_a;   // this lane's rows: r_a, r_a + 8
  const float lse_a = lse_s[r_a], lse_b = lse_s[r_a + 8];
  const float dl_a = dl_s[r_a], dl_b = dl_s[r_a + 8];

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int kv_end = causal ? min(S, min(t0 + BR, Tq)) : S;
  for (int s0 = 0; s0 < kv_end; s0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    stage_bf16<D>(k_s, LD, kb, s0, BK, S, KV, kvh);
    stage_bf16<D>(v_s, LD, vb, s0, BK, S, KV, kvh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // a warp whose queries all lie before the tile's first key sees nothing
    if (causal && s0 > t0 + 16 * w + 15) continue;

    float s[NK][4], dp[NK][4];   // S and dP (16 queries x BK keys)
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, NK>(s, q_s, 16 * w, k_s, LD, lane);
    mma_abt<D, NK>(dp, do_s, 16 * w, v_s, LD, lane);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = s0 + n * 8 + 2 * tq + (e & 1), t = t_a + (e >> 1) * 8;
        const bool ok = key < S && t < Tq && (!causal || key <= t);
        const float p = ok ? ex2_approx(fmaf(s[n][e], scale2, e < 2 ? -lse_a : -lse_b)) : 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? dl_a : dl_b));
      }
    mma_xb<NK, D>(acc, dp, k_s, LD, 0, lane);   // dQ += dS K
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = t_a + 8 * hf, col = n * 8 + 2 * tq;
      if (t < Tq)
        *reinterpret_cast<__nv_bfloat162*>(dq + (((long long)b * Tq + t) * H + h) * D + col) =
            __floats2bfloat162_rn(acc[n][2 * hf] * scale, acc[n][2 * hf + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int Tq, int H,
                         int D, cudaStream_t st) {
  const long long rows = (long long)B * Tq * H;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  bwd_delta_kernel<T><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(o),
                                                  static_cast<const T*>(dout), delta, Tq, H, D,
                                                  rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           const float* lse, const float* delta, float* dq, float* dk, float* dv,
                           int B, int T, int S, int H, int KV, int causal, float scale,
                           cudaStream_t st) {
  const size_t smem = bwd_f32_smem_bytes<D>();
  cudaError_t err = prepare_smem(bwd_dkdv_f32_kernel<D>, smem);
  if (err == cudaSuccess) err = prepare_smem(bwd_dq_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_f32_kernel<D><<<dim3((S + BF - 1) / BF, KV, B), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, S, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_f32_kernel<D><<<dim3((T + BF - 1) / BF, H, B), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dq, T, S, H, KV, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                            const __nv_bfloat16* v, const __nv_bfloat16* dout, const float* lse,
                            const float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
                            __nv_bfloat16* dv, int B, int T, int S, int H, int KV, int causal,
                            float scale, cudaStream_t st) {
  constexpr int DC = D > 128 ? 128 : D;        // dK/dV output columns a block
  constexpr int BQ = DC > 64 ? 32 : 64;        // queries a dK/dV step
  constexpr int BK = D > 128 ? 32 : 64;        // keys a dQ step
  using LK = DkdvLayout<D, DC, BQ>;
  using LQ = DqLayout<D, BK>;
  cudaError_t err = prepare_smem(bwd_dkdv_bf16_kernel<D, DC, BQ>, LK::smem_bytes);
  if (err == cudaSuccess) err = prepare_smem(bwd_dq_bf16_kernel<D, BK>, LQ::smem_bytes);
  if (err != cudaSuccess) return err;
  bwd_dkdv_bf16_kernel<D, DC, BQ>
      <<<dim3((S + BR - 1) / BR * (D / DC), KV, B), THREADS, LK::smem_bytes, st>>>(
          q, k, v, dout, lse, delta, dk, dv, T, S, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_bf16_kernel<D, BK><<<dim3((T + BR - 1) / BR, H, B), THREADS, LQ::smem_bytes, st>>>(
      q, k, v, dout, lse, delta, dq, T, S, H, KV, causal, scale);
  return cudaGetLastError();
}

}  // namespace repro

// Plain C entry point, bound with ctypes. q, o, dout and dq (B, T, H, D);
// k, v, dk and dv (B, S, KV, D), all contiguous in one dtype; lse and the
// scratch delta (B, H, T) f32. Writes dq, dk and dv (and delta); returns
// the cudaError_t of the launches (0 on success); it does not synchronise.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse_, const void* dout,
                                         void* delta_, void* dq, void* dk, void* dv, int B,
                                         int T, int S, int H, int KV, int D, int causal,
                                         float sm_scale, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse = static_cast<const float*>(lse_);
  float* delta = static_cast<float*>(delta_);
  if (KV <= 0 || H % KV != 0 || S < 0 || T < 0) return cudaErrorInvalidValue;
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
                                causal, sm_scale, st);
    if (D == 128)
      return launch_bwd_f32<128>(qf, kf, vf, df, lse, delta, dqf, dkf, dvf, B, T, S, H, KV,
                                 causal, sm_scale, st);
    return launch_bwd_f32<256>(qf, kf, vf, df, lse, delta, dqf, dkf, dvf, B, T, S, H, KV,
                               causal, sm_scale, st);
  }
  using bf = __nv_bfloat16;
  const bf *qb = static_cast<const bf*>(q), *kb = static_cast<const bf*>(k),
           *vb = static_cast<const bf*>(v), *db = static_cast<const bf*>(dout);
  bf *dqb = static_cast<bf*>(dq), *dkb = static_cast<bf*>(dk), *dvb = static_cast<bf*>(dv);
  if (D == 64)
    return launch_bwd_bf16<64>(qb, kb, vb, db, lse, delta, dqb, dkb, dvb, B, T, S, H, KV, causal,
                               sm_scale, st);
  if (D == 128)
    return launch_bwd_bf16<128>(qb, kb, vb, db, lse, delta, dqb, dkb, dvb, B, T, S, H, KV,
                                causal, sm_scale, st);
  return launch_bwd_bf16<256>(qb, kb, vb, db, lse, delta, dqb, dkb, dvb, B, T, S, H, KV, causal,
                              sm_scale, st);
}
