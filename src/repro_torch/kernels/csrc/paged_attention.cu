// K1: paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` of
// src/repro/kernels/paged_attention.py (reached through its
// `paged_attention`). One query token per sequence attends to that
// sequence's KV, read through its block table from the shared physical
// page pool (KV, P, page, D); a physical page may sit in many tables.
//
// Bound: device-memory bytes. The arithmetic is 4 flops per K/V element
// and query row, about G flops per byte, far below the card's ~295. Two
// byte counts frame it: reading every sequence's pages (ctx * KV * D * 2
// elements per sequence: 335 MB at the serving shape, B = 64, ctx = 1280,
// KV = 8, D = 128, bf16) and reading each distinct page once (155 MB
// there, since tenants share prompt pages). Only the L2 cache can bring
// the kernel below the first: a page that many tables hold is fetched from
// device memory once if the blocks that read it run close together.
//
// bf16 (the serving path; D in {64, 128, 256}, any G = H / KV):
// * Split. The grid is (split, kv head, sequence x row pass), folded into
//   x with the split fastest (at most 2^31 - 1 blocks). The splits of one
//   (sequence, kv head, pass) are contiguous ranges of the sequence's
//   stages and run as one thread-block cluster. Their count comes from
//   B * KV, the allocated table length and the SM count: about one wave at
//   two blocks per SM, 1 to 8 splits, and no more than let every cluster
//   fit on the card at once (the blocks of a cluster share a GPC: an H100
//   holds 30 clusters of 8 of these blocks, not 33, so B = 4, KV = 8 takes
//   clusters of 7). A small batch with a long context then still fills the
//   card. A split past ctx reads nothing and leaves an empty partial
//   (m = -1e30, l = 0, acc = 0).
// * Ring. One producer warp reads its split's table slots and keeps K and
//   V in flight by TMA into a ring of 3 stages behind full / empty
//   mbarriers; four consumer warps compute on the stages that have
//   arrived. A stage holds 64 tokens (32 at D = 256): whole pages, each a
//   box of the 4-D tensor map over the pool (D, page, P, KV) with the page
//   coordinate from the table, or a slice of a larger page. A page's box is
//   its rows rounded up to 8, so every box starts 1024-byte aligned and the
//   128-byte swizzle lets ldmatrix read 8 rows without bank conflicts; the
//   rows past the page arrive as zeros. A box slot past ctx is asked for at
//   page coordinate P, outside the tensor: it arrives as zeros without
//   reading the table or device memory.
// * Tensor cores. The keys are the M side and the G query rows of the kv
//   head the N = 8 side of mma.sync m16n8k16: S^T = K q^T, then
//   O^T = V^T P^T with D as M and the keys as k, V^T through
//   ldmatrix.trans. movmatrix turns the score accumulator (rows of keys)
//   into P^T's B fragment (rows of queries) in registers. P is rounded to
//   bf16, as in K2 and K3; everything accumulates in f32, softmax in base 2.
//   G <= 8 takes one n-tile, G <= 16 two; a larger G takes passes of 16
//   rows, each its own cluster, each reading the pages again.
// * Merge. Each consumer warp keeps its own (m, l, acc) over the 16-key
//   tiles it takes; at the end they fold into one slot per row in the
//   block's shared memory (over the ring), and after cluster.sync() the
//   blocks of the cluster merge the slots through distributed shared
//   memory, each block its share of (row, 4 columns) items; a second
//   cluster.sync() keeps every block resident until the others have read
//   it. One launch per call.
// What is left: whether the L2 serves a page shared across sequences
// depends on which blocks run together (the grid runs kv heads fastest,
// then sequences); splits of one sequence never share a page. At a large
// batch the grid is about two waves of whole sequences (one split). A
// launch with nothing to read costs about 4 us on the card (the cluster
// launch, barriers and merge), a fifth of the small-batch bound.
//
// f32 (held to 2e-5, so no TF32): one block of 256 threads per (sequence,
// kv head, pass of 8 rows) walks the sequence on CUDA cores, warp w taking
// chunks of 32 tokens c with c % 8 == w, lane t scoring token t for the
// pass's rows with a full f32 dot product; the warps' states merge through
// shared memory. It is not on the serving path.
//
// Semantics follow the TPU kernel: positions >= ctx are masked to -1e30,
// no table slot at or past ceil(ctx / page) is read, ctx is clamped to
// pps * page, ctx <= 0 gives zeros, and the output is acc / max(l, 1e-30)
// in q's dtype.
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace repro {

constexpr size_t K1_MAX_SMEM = 232448;   // shared memory per block on an H100

// ---------------------------------------------------------------------------
// f32 path: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int K1_MAX_G = 8;     // query rows per pass of the f32 kernel
constexpr int K1_WARPS = 8;
constexpr int K1_THREADS = K1_WARPS * 32;

// Load N consecutive floats (N a multiple of 4 or N <= 2, the address
// aligned to 4 N bytes).
template <int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 raw = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = raw.x;
      dst[4 * i + 1] = raw.y;
      dst[4 * i + 2] = raw.z;
      dst[4 * i + 3] = raw.w;
    }
  } else if constexpr (N == 2) {
    const float2 raw = *reinterpret_cast<const float2*>(src);
    dst[0] = raw.x;
    dst[1] = raw.y;
  } else {
    dst[0] = *src;
  }
}

// DPL = D / 32: output columns per lane. GB >= the pass's rows is the size
// of the register arrays, a power of two.
template <int DPL, int GB>
__global__ void __launch_bounds__(K1_THREADS)
paged_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                           const float* __restrict__ v_pages, const int* __restrict__ block_tables,
                           const int* __restrict__ context_lens, float* __restrict__ out, int H,
                           int KV, int P, int page, int pps, float sm_scale) {
  constexpr int D = DPL * 32;
  constexpr int VEC = 4;   // floats per 16-byte load of a K row
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g0 = blockIdx.z * K1_MAX_G;            // this pass's first row of the kv head
  const int G = min(K1_MAX_G, H / KV - g0);        // rows of this pass
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                         // (G, D), pre-scaled
  float* m_s = q_s + G * D;                  // (K1_WARPS, G) per-warp running max
  float* l_s = m_s + K1_WARPS * G;           // (K1_WARPS, G) per-warp running sum
  float* acc_s = l_s + K1_WARPS * G;         // (K1_WARPS, G, D) per-warp accumulators

  const int ctx = context_lens[b];
  const int n_tok = ctx <= 0 ? 0 : min(ctx, pps * page);
  const long long q_off = ((long long)b * H + (long long)h * (H / KV) + g0) * D;
  const int* table = block_tables + (long long)b * pps;

  for (int i = tid; i < G * D; i += blockDim.x) q_s[i] = q[q_off + i] * sm_scale;
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
        load_f32<VEC>(kv, k_pages + row + d);
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
      load_f32<DPL>(vv, v_pages + rj + lane * DPL);
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
    out[q_off + idx] = o / fmaxf(l, 1e-30f);
  }
}

inline size_t k1_f32_smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + 2 * (size_t)K1_WARPS * G + (size_t)K1_WARPS * G * D);
}

template <int DPL, int GB>
cudaError_t launch_k1_f32_gb(const float* q, const float* k_pages, const float* v_pages,
                             const int* block_tables, const int* context_lens, float* out, int B,
                             int H, int KV, int P, int page, int pps, float sm_scale,
                             cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = k1_f32_smem_bytes(std::min(G, K1_MAX_G), DPL * 32);
  cudaError_t err = prepare_smem(paged_attention_f32_kernel<DPL, GB>, smem);
  if (err != cudaSuccess) return err;
  const int n_pass = (G + K1_MAX_G - 1) / K1_MAX_G;
  paged_attention_f32_kernel<DPL, GB><<<dim3(B, KV, n_pass), K1_THREADS, smem, stream>>>(
      q, k_pages, v_pages, block_tables, context_lens, out, H, KV, P, page, pps, sm_scale);
  return cudaGetLastError();
}

template <int DPL>
cudaError_t launch_k1_f32(const float* q, const float* k_pages, const float* v_pages,
                          const int* block_tables, const int* context_lens, float* out, int B,
                          int H, int KV, int P, int page, int pps, float sm_scale,
                          cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1)
    return launch_k1_f32_gb<DPL, 1>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                    KV, P, page, pps, sm_scale, stream);
  if (G <= 2)
    return launch_k1_f32_gb<DPL, 2>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                    KV, P, page, pps, sm_scale, stream);
  if (G <= 4)
    return launch_k1_f32_gb<DPL, 4>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                    KV, P, page, pps, sm_scale, stream);
  return launch_k1_f32_gb<DPL, K1_MAX_G>(q, k_pages, v_pages, block_tables, context_lens, out, B,
                                         H, KV, P, page, pps, sm_scale, stream);
}

// ---------------------------------------------------------------------------
// bf16 path: split sequences over a cluster, TMA ring, tensor cores
// ---------------------------------------------------------------------------
constexpr int K1T_CWARPS = 4;                        // consumer warps
constexpr int K1T_THREADS = 32 * (K1T_CWARPS + 1);   // + one producer warp
constexpr int K1T_STAGES = 3;
constexpr int K1T_MAX_SPLITS = 8;                    // blocks of a cluster (the portable maximum)

// The launch of the bf16 kernel for one call. A stage holds `tok` rows:
// `nseg` segments of `br` rows each, a segment being a whole page (spp = 1;
// br = page rounded up to 8) or the slice of a page (spp slices of br =
// tok rows). `tiles` 16-key tiles per stage cover its nseg * br rows.
struct K1TPlan {
  int tok, br, nseg, spp, tiles, nt, n_pass, n_split, sps, n_stages;
  size_t smem;
};

// Shared-memory carve-up, the same on the host and in the kernel. The ring
// (stage s: K, then V, each D / 64 boxes of (tok, 64)) starts at offset 0;
// after the last stage the consumer warps' partials (wacc, wm, wl) and the
// block's slot (sacc, sm, sl) lie over it. q and the barriers lie past it.
struct K1TSmem {
  size_t wacc, wm, wl, sacc, sm, sl, q, bar, total;
  __host__ __device__ K1TSmem(int D, int tok, int n_stages, int rows) {
    const size_t ring = (size_t)4 * D * tok * n_stages;
    wacc = 0;                                            // (warps, D, rows) f32
    wm = wacc + (size_t)K1T_CWARPS * D * rows * 4;       // (warps, rows)
    wl = wm + (size_t)K1T_CWARPS * rows * 4;
    sacc = wl + (size_t)K1T_CWARPS * rows * 4;           // (rows, D) f32
    sm = sacc + (size_t)rows * D * 4;                    // (rows,) m, log2 units
    sl = sm + (size_t)rows * 4;                          // (rows,) l
    const size_t merge = sl + (size_t)rows * 4;
    q = ring > merge ? ring : merge;                     // (rows, D + 8) bf16
    bar = (q + (size_t)rows * (D + 8) * 2 + 7) & ~(size_t)7;
    total = bar + 2 * K1T_STAGES * 8 + 1024;             // + the slack of aligning the base
  }
};

template <int D, int NT>
__global__ void __launch_bounds__(K1T_THREADS)
paged_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ q, const int* __restrict__ block_tables,
                          const int* __restrict__ context_lens, __nv_bfloat16* __restrict__ out,
                          int H, int KV, int P, int page, int pps, int tok, int br, int nseg,
                          int spp, int tiles, int sps, int n_pass, float scale2) {
  constexpr int R = 8 * NT;     // query rows of a pass
  constexpr int QS = D + 8;     // q row stride in shared memory
  constexpr int NB = D / 64;    // 64-column boxes of a row
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  // blockIdx.x = split + n_split * (kv head + KV * (sequence * n_pass + pass))
  const int cid = blockIdx.x / n_split;
  const int h = cid % KV, bp = cid / KV, b = bp / n_pass, pass = bp - b * n_pass;
  const int G = H / KV;
  const int g0 = pass * R;                    // this pass's first row of the kv head
  const int rows = min(R, G - g0);            // rows of this pass
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int gg = lane >> 2, t4 = lane & 3;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const K1TSmem lay(D, tok, K1T_STAGES, R);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base + lay.q);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bar);
  uint64_t* empty = full + K1T_STAGES;
  const size_t stage_elems = (size_t)2 * tok * D;

  const int ctx = context_lens[b];
  const int n_tok = ctx <= 0 ? 0 : min(ctx, pps * page);
  // segments below ctx: those that begin before token n_tok
  int need = 0;
  if (n_tok > 0) {
    const int last = n_tok - 1;
    need = (last / page) * spp + (last % page) / br + 1;
  }
  const int s_begin = split * sps;                       // this split's first stage
  const int s_end = min(s_begin + sps, (need + nseg - 1) / nseg);
  const int n_my = max(0, s_end - s_begin);
  const int* table = block_tables + (long long)b * pps;

  if (tid == 0) {
    for (int i = 0; i < K1T_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], K1T_CWARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  float o[NT][D / 16][4];    // O^T: (d = 16 mt + gg (+ 8), row = 8 nt + 2 t4 (+ 1))
  float m_r[NT][2], l_r[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m_r[nt][0] = m_r[nt][1] = NEG_INF;
    l_r[nt][0] = l_r[nt][1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) o[nt][mt][0] = o[nt][mt][1] = o[nt][mt][2] = o[nt][mt][3] = 0.f;
  }

  const int seg_rows = nseg * br;
  if (warp == K1T_CWARPS) {
    // producer: segment k (< nseg <= 8) of a stage goes to lane k, which
    // reads its table slot one stage ahead and asks for its K and V boxes;
    // slots past ctx ask for page P (outside the pool), which arrives as
    // zeros and reads nothing
    const CUtensorMap* map_k = &tm_k;
    const CUtensorMap* map_v = &tm_v;
    const uint32_t stage_bytes = 4u * seg_rows * D;
    int pg = P, r0 = 0;
    auto slot = [&](int i) {   // lane's segment of stage i: page and first row
      const int gs = (s_begin + i) * nseg + lane;
      pg = P;
      r0 = 0;
      if (lane < nseg && gs < need) {
        pg = table[gs / spp];
        r0 = (gs % spp) * br;
      }
    };
    if (n_my > 0) slot(0);
    for (int i = 0; i < n_my; ++i) {
      const int st = i % K1T_STAGES;
      if (i >= K1T_STAGES) mbar_wait(&empty[st], (i / K1T_STAGES - 1) & 1);
      if (lane == 0) mbar_expect_tx(&full[st], stage_bytes);
      __syncwarp();
      if (lane < nseg) {
        __nv_bfloat16* ks = ring + st * stage_elems + lane * br * 64;
        __nv_bfloat16* vs = ks + (size_t)tok * D;
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) {
          tma_load_4d(ks + (size_t)bx * tok * 64, map_k, &full[st], bx * 64, r0, pg, h);
          tma_load_4d(vs + (size_t)bx * tok * 64, map_v, &full[st], bx * 64, r0, pg, h);
        }
      }
      if (i + 1 < n_my) slot(i + 1);
    }
  } else {
    // consumers: the q rows of this pass (rows past G zeroed) by cp.async,
    // off the producer's path; rows of a stage past its nseg * br segment
    // rows, up to the last tile, are never written by TMA: zero them once
    // (V rows there meet p = 0)
    for (int i = tid; i < R * (D / 8); i += 32 * K1T_CWARPS) {
      const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
      const long long src = ((long long)b * H + (long long)h * G + g0 + min(r, rows - 1)) * D + c;
      cp_async_16(q_s + r * QS + c, q + src, r < rows);
    }
    cp_async_commit();
    const int pad_rows = tiles * 16 - seg_rows;
    for (int i = tid; i < K1T_STAGES * 2 * NB * pad_rows * 8; i += 32 * K1T_CWARPS) {
      const int chunk = i & 7, rest = i >> 3;
      const int r = seg_rows + rest % pad_rows, box = rest / pad_rows;   // box: stage, K/V, column box
      *reinterpret_cast<uint4*>(ring + (size_t)box * tok * 64 + r * 64 + chunk * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait<0>();
    named_barrier_sync(1, 32 * K1T_CWARPS);
    // then warp w takes the 16-key tiles j of the split with j % 4 == w
    const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;   // ldmatrix, non-trans
    const int vr = (lane >> 4) * 8 + (lane & 7), vc = ((lane >> 3) & 1) * 8;   // ldmatrix.trans
    for (int i = 0; i < n_my; ++i) {
      const int st = i % K1T_STAGES;
      mbar_wait(&full[st], (i / K1T_STAGES) & 1);
      __nv_bfloat16* ks = ring + st * stage_elems;
      __nv_bfloat16* vs = ks + (size_t)tok * D;
      for (int tt = (K1T_CWARPS + warp - (i * tiles) % K1T_CWARPS) % K1T_CWARPS; tt < tiles;
           tt += K1T_CWARPS) {
        // the tokens of this lane's keys gg and gg + 8; rows past ctx or past
        // their page are masked
        bool valid[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tt * 16 + gg + 8 * e;
          const int seg = r / br, rin = r - seg * br;
          const int gs = (s_begin + i) * nseg + seg;
          const int off = (gs % spp) * br + rin;
          valid[e] = seg < nseg && off < page && (gs / spp) * page + off < n_tok;
        }
        if (!__any_sync(0xffffffffu, valid[0] || valid[1])) continue;
        // S^T = K q^T: 16 keys x 8 rows per n-tile
        float sc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; kc += 2) {
          uint32_t a0[4], a1[4];
          ldmatrix_x4(a0, sw128(ks, tok, tt * 16 + lr, kc * 16 + lc));
          ldmatrix_x4(a1, sw128(ks, tok, tt * 16 + lr, kc * 16 + 16 + lc));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bq[4];   // q rows 8 nt.., columns 16 kc .. 16 kc + 31
            ldmatrix_x4(bq, q_s + (nt * 8 + (lane & 7)) * QS + kc * 16 + (lane >> 3) * 8);
            mma_bf16_16816(sc[nt], a0, bq[0], bq[1]);
            mma_bf16_16816(sc[nt], a1, bq[2], bq[3]);
          }
        }
        // online softmax (base 2) of rows 8 nt + 2 t4 (elements 0, 2) and
        // + 1 (elements 1, 3) over the tile's keys
        uint32_t pb[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = valid[e >> 1] ? sc[nt][e] * scale2 : NEG_INF;
          float mx0 = fmaxf(sc[nt][0], sc[nt][2]), mx1 = fmaxf(sc[nt][1], sc[nt][3]);
#pragma unroll
          for (int o_ = 4; o_ <= 16; o_ <<= 1) {   // the 8 lanes of a row pair share t4
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
          }
          const float mn0 = fmaxf(m_r[nt][0], mx0), mn1 = fmaxf(m_r[nt][1], mx1);
          const float al0 = exp2f(m_r[nt][0] - mn0), al1 = exp2f(m_r[nt][1] - mn1);
          m_r[nt][0] = mn0;
          m_r[nt][1] = mn1;
          const float p0 = exp2f(sc[nt][0] - mn0), p1 = exp2f(sc[nt][1] - mn1);
          const float p2 = exp2f(sc[nt][2] - mn0), p3 = exp2f(sc[nt][3] - mn1);
          l_r[nt][0] = l_r[nt][0] * al0 + (p0 + p2);   // this lane's keys only
          l_r[nt][1] = l_r[nt][1] * al1 + (p1 + p3);
#pragma unroll
          for (int mt = 0; mt < D / 16; ++mt) {
            o[nt][mt][0] *= al0;
            o[nt][mt][1] *= al1;
            o[nt][mt][2] *= al0;
            o[nt][mt][3] *= al1;
          }
          // P^T's B fragment: keys 0-7 and 8-15 transposed to rows of queries
          pb[nt][0] = movmatrix_trans(pack_bf16(p0, p1));
          pb[nt][1] = movmatrix_trans(pack_bf16(p2, p3));
        }
        // O^T += V^T P^T: D / 16 tiles of 16 columns, keys as k
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          uint32_t av[4];
          ldmatrix_x4_trans(av, sw128(vs, tok, tt * 16 + vr, mt * 16 + vc));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(o[nt][mt], av, pb[nt][0], pb[nt][1]);
        }
      }
      mbar_arrive_warp(&empty[st]);
    }
  }
  __syncthreads();   // every stage read: the ring becomes the merge area

  // 1. each consumer warp's partial into shared memory: m (log2 units),
  //    l and acc unnormalised
  float* wacc = reinterpret_cast<float*>(base + lay.wacc);
  float* wm = reinterpret_cast<float*>(base + lay.wm);
  float* wl = reinterpret_cast<float*>(base + lay.wl);
  float* sacc = reinterpret_cast<float*>(base + lay.sacc);
  float* sm = reinterpret_cast<float*>(base + lay.sm);
  float* sl = reinterpret_cast<float*>(base + lay.sl);
  if (warp < K1T_CWARPS) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float l0 = l_r[nt][0], l1 = l_r[nt][1];
#pragma unroll
      for (int o_ = 4; o_ <= 16; o_ <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
      }
      const int r = nt * 8 + 2 * t4;
      if (gg == 0) {
        wm[warp * R + r] = m_r[nt][0];
        wm[warp * R + r + 1] = m_r[nt][1];
        wl[warp * R + r] = l0;
        wl[warp * R + r + 1] = l1;
      }
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
        const int d = mt * 16 + gg;
        *reinterpret_cast<float2*>(wacc + ((size_t)warp * D + d) * R + r) =
            make_float2(o[nt][mt][0], o[nt][mt][1]);
        *reinterpret_cast<float2*>(wacc + ((size_t)warp * D + d + 8) * R + r) =
            make_float2(o[nt][mt][2], o[nt][mt][3]);
      }
    }
  }
  __syncthreads();
  // 2. the warps' partials folded into the block's slot, one row each
  for (int it = tid; it < rows * D; it += K1T_THREADS) {
    const int r = it / D, d = it - r * D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < K1T_CWARPS; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < K1T_CWARPS; ++w) {
      const float wt = exp2f(wm[w * R + r] - mx);   // 1 for every warp where all are empty
      l += wt * wl[w * R + r];
      a += wt * wacc[((size_t)w * D + d) * R + r];
    }
    sacc[r * D + d] = a;
    if (d == 0) {
      sm[r] = mx;
      sl[r] = l;
    }
  }
  cluster.sync();   // every block's slot is written
  // 3. (row, 4 columns) items, dealt over the blocks of the cluster: read
  //    the row's slot from every block, merge, normalise and write out
  for (int it = split * K1T_THREADS + tid; it < rows * (D / 4); it += n_split * K1T_THREADS) {
    const int r = it / (D / 4), c4 = (it - r * (D / 4)) * 4;
    float mc[K1T_MAX_SPLITS], mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < K1T_MAX_SPLITS; ++c) {
      mc[c] = c < n_split ? *cluster.map_shared_rank(sm + r, c) : NEG_INF;
      mx = fmaxf(mx, mc[c]);
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < K1T_MAX_SPLITS; ++c) {
      if (c < n_split) {
        const float w = exp2f(mc[c] - mx);   // 0 for an empty split beside a real one
        const float4 a4 =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(sacc + r * D + c4, c));
        l += w * *cluster.map_shared_rank(sl + r, c);
        acc.x += w * a4.x;
        acc.y += w * a4.y;
        acc.z += w * a4.z;
        acc.w += w * a4.w;
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + ((long long)b * H + (long long)h * G + g0 + r) * D + c4);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
  }
  cluster.sync();   // no block leaves while another still reads its shared memory
}

// The bf16 kernel for (D, NT), as the host names it.
inline const void* k1t_kernel(int D, int nt) {
  if (D == 64) return nt == 1 ? (const void*)paged_attention_tc_kernel<64, 1>
                              : (const void*)paged_attention_tc_kernel<64, 2>;
  if (D == 128) return nt == 1 ? (const void*)paged_attention_tc_kernel<128, 1>
                               : (const void*)paged_attention_tc_kernel<128, 2>;
  return nt == 1 ? (const void*)paged_attention_tc_kernel<256, 1>
                 : (const void*)paged_attention_tc_kernel<256, 2>;
}

// How many clusters of `size` blocks of the (D, nt) kernel the card holds
// at once (blocks of a cluster share a GPC, so clusters of 8 at two blocks
// per SM fill 30 of an H100's 33 slots of 8). Asked of the runtime once
// per (device, D, nt, size); 0 if it cannot say.
inline int k1t_max_clusters(int D, int nt, int size, size_t smem) {
  static int cache[64][3][2][K1T_MAX_SPLITS + 1];   // + 1: 0 is unknown
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& slot = cache[dev & 63][D == 64 ? 0 : (D == 128 ? 1 : 2)][nt - 1][size];
  if (slot == 0) {
    const void* fn = k1t_kernel(D, nt);
    int n = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K1_MAX_SMEM) == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(size, 1, 1);
      cfg.blockDim = dim3(K1T_THREADS);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = size;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) n = 0;
    }
    slot = n + 1;
  }
  return slot - 1;
}

// The card's SM count, asked of the runtime once per device.
inline int k1t_sm_count() {
  static int cache[64];   // 0 is unknown
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  int& slot = cache[dev & 63];
  if (slot == 0 && cudaDeviceGetAttribute(&slot, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    slot = 0;
  return slot > 0 ? slot : 132;
}

inline K1TPlan k1t_plan(int B, int H, int KV, int D, int page, int pps) {
  K1TPlan pl;
  const int G = H / KV;
  pl.tok = D == 256 ? 32 : 64;                    // a stage of 32 KiB of K + V (16 KiB at D = 64)
  const int pr8 = (page + 7) / 8 * 8;
  if (pr8 <= pl.tok) {                            // whole pages
    pl.br = pr8;
    pl.spp = 1;
    pl.nseg = pl.tok / pr8;
  } else {                                        // slices of a page
    pl.br = pl.tok;
    pl.spp = (page + pl.tok - 1) / pl.tok;
    pl.nseg = 1;
  }
  pl.tiles = (pl.nseg * pl.br + 15) / 16;
  pl.nt = G <= 8 ? 1 : 2;
  pl.n_pass = (G + 8 * pl.nt - 1) / (8 * pl.nt);
  pl.n_stages = K1T_STAGES;
  pl.smem = K1TSmem(D, pl.tok, K1T_STAGES, 8 * pl.nt).total;
  // splits: at most the block slots left over per (sequence, kv head,
  // pass) at two blocks per SM, 1 to 8, each at least one stage, and no
  // more than let every cluster run in the first wave
  const int n_stage = (pps * pl.spp + pl.nseg - 1) / pl.nseg;
  const int sms = k1t_sm_count();
  const long long pairs = (long long)B * KV * pl.n_pass;
  int n = (int)std::min<long long>(std::min<long long>(K1T_MAX_SPLITS, n_stage),
                                   std::max(1LL, 2LL * sms / std::max(1LL, pairs)));
  while (n > 1 && pairs > k1t_max_clusters(D, pl.nt, n, pl.smem)) --n;
  pl.sps = (n_stage + n - 1) / n;
  pl.n_split = (n_stage + pl.sps - 1) / pl.sps;
  return pl;
}

// The K and V tensor maps of one pool, encoded once for each (device, K and
// V pointers, pool shape, box rows) and kept in a small per-thread cache:
// the serving path calls the kernel over one pool, and an encoding costs
// host time on every call otherwise.
struct K1TMaps {
  const void* k = nullptr;
  const void* v = nullptr;
  int dev = -1, D = 0, page = 0, P = 0, KV = 0, br = 0;
  CUtensorMap tm_k, tm_v;
};

inline cudaError_t k1t_maps(const void* k_pages, const void* v_pages, int D, int page, int P,
                            int KV, int br, const K1TMaps** found) {
  constexpr int N = 4;
  thread_local K1TMaps cache[N];
  thread_local int next = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const K1TMaps& m : cache)
    if (m.k == k_pages && m.v == v_pages && m.dev == dev && m.D == D && m.page == page &&
        m.P == P && m.KV == KV && m.br == br) {
      *found = &m;
      return cudaSuccess;
    }
  K1TMaps& m = cache[next];
  m.k = nullptr;                           // invalid until both maps are encoded
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)page, (uint64_t)P, (uint64_t)KV};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)page * D * 2, (uint64_t)P * page * D * 2};
  const uint32_t box[4] = {64, (uint32_t)br, 1, 1};
  err = make_tensor_map_bf16(&m.tm_k, k_pages, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&m.tm_v, v_pages, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  m.k = k_pages;
  m.v = v_pages;
  m.dev = dev;
  m.D = D;
  m.page = page;
  m.P = P;
  m.KV = KV;
  m.br = br;
  next = (next + 1) % N;
  *found = &m;
  return cudaSuccess;
}

template <int D, int NT>
cudaError_t launch_k1_tc_nt(const K1TPlan& pl, const void* q, const void* k_pages,
                            const void* v_pages, const int* block_tables, const int* context_lens,
                            void* out, int B, int H, int KV, int P, int page, int pps,
                            float sm_scale, cudaStream_t stream) {
  if (pl.smem > K1_MAX_SMEM) return cudaErrorInvalidConfiguration;
  // one grid dimension, x, holds every block: at most 2^31 - 1 of them
  const long long blocks = (long long)pl.n_split * KV * B * pl.n_pass;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const K1TMaps* maps = nullptr;
  cudaError_t err = k1t_maps(k_pages, v_pages, D, page, P, KV, pl.br, &maps);
  if (err == cudaSuccess) err = allow_smem_once<paged_attention_tc_kernel<D, NT>>(K1_MAX_SMEM);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(K1T_THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.n_split;   // the splits of one (sequence, kv head, pass)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_attention_tc_kernel<D, NT>, maps->tm_k, maps->tm_v,
                           static_cast<const __nv_bfloat16*>(q), block_tables, context_lens,
                           static_cast<__nv_bfloat16*>(out), H, KV, P, page, pps, pl.tok, pl.br,
                           pl.nseg, pl.spp, pl.tiles, pl.sps, pl.n_pass, sm_scale * LOG2E);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k1_tc(const void* q, const void* k_pages, const void* v_pages,
                         const int* block_tables, const int* context_lens, void* out, int B, int H,
                         int KV, int P, int page, int pps, float sm_scale, cudaStream_t stream) {
  const K1TPlan pl = k1t_plan(B, H, KV, D, page, pps);
  if (pl.nt == 1)
    return launch_k1_tc_nt<D, 1>(pl, q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                 KV, P, page, pps, sm_scale, stream);
  return launch_k1_tc_nt<D, 2>(pl, q, k_pages, v_pages, block_tables, context_lens, out, B, H, KV,
                               P, page, pps, sm_scale, stream);
}

}  // namespace repro

// Plain C entry point, bound with ctypes. Returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int repro_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const int* block_tables, const int* context_lens,
                                     void* out, int B, int H, int KV, int D, int P, int page,
                                     int pps, float sm_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0 || page <= 0 || pps <= 0 || P <= 0) return cudaErrorInvalidValue;
  if (D != 64 && D != 128 && D != 256) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (dtype == repro::F32) {
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k_pages);
    const float* vf = static_cast<const float*>(v_pages);
    float* of = static_cast<float*>(out);
    if (D == 64)
      return repro::launch_k1_f32<2>(qf, kf, vf, block_tables, context_lens, of, B, H, KV, P,
                                     page, pps, sm_scale, s);
    if (D == 128)
      return repro::launch_k1_f32<4>(qf, kf, vf, block_tables, context_lens, of, B, H, KV, P,
                                     page, pps, sm_scale, s);
    return repro::launch_k1_f32<8>(qf, kf, vf, block_tables, context_lens, of, B, H, KV, P, page,
                                   pps, sm_scale, s);
  }
  if (dtype != repro::BF16) return cudaErrorInvalidValue;
  if (D == 64)
    return repro::launch_k1_tc<64>(q, k_pages, v_pages, block_tables, context_lens, out, B, H, KV,
                                   P, page, pps, sm_scale, s);
  if (D == 128)
    return repro::launch_k1_tc<128>(q, k_pages, v_pages, block_tables, context_lens, out, B, H,
                                    KV, P, page, pps, sm_scale, s);
  return repro::launch_k1_tc<256>(q, k_pages, v_pages, block_tables, context_lens, out, B, H, KV,
                                  P, page, pps, sm_scale, s);
}

// The launch a call with these sizes gets: out = {cluster size (splits of
// a sequence), tokens per stage, ring stages, dynamic shared memory in
// bytes, threads per block, row passes, stages per split, clusters of that
// size the card holds at once}. The f32 kernel reports one split, 32 * 8
// tokens a step (its eight warps' chunks), no ring, its shared memory, 256
// threads, its passes of 8 rows and 0 for the last two. Returns 1, or 0
// for sizes the kernels do not take (out untouched).
extern "C" int repro_paged_attention_plan(int B, int H, int KV, int D, int page, int pps,
                                          int dtype, int* out) {
  if (KV <= 0 || H % KV != 0 || page <= 0 || pps <= 0 || (D != 64 && D != 128 && D != 256))
    return 0;
  if (dtype == repro::F32) {
    const int G = H / KV;
    const int vals[8] = {1, 32 * repro::K1_WARPS, 0,
                         (int)repro::k1_f32_smem_bytes(std::min(G, repro::K1_MAX_G), D),
                         repro::K1_THREADS, (G + repro::K1_MAX_G - 1) / repro::K1_MAX_G, 0, 0};
    for (int i = 0; i < 8; ++i) out[i] = vals[i];
    return 1;
  }
  if (dtype != repro::BF16) return 0;
  const repro::K1TPlan pl = repro::k1t_plan(B, H, KV, D, page, pps);
  const int vals[8] = {pl.n_split, pl.tok, pl.n_stages, (int)pl.smem, repro::K1T_THREADS,
                       pl.n_pass, pl.sps, repro::k1t_max_clusters(D, pl.nt, pl.n_split, pl.smem)};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 1;
}
