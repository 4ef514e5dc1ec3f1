// K2: shared-prefix ("object sharing") attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_prefix_kernel` of
// src/repro/kernels/shared_prefix_attention.py (reached through its
// `shared_prefix_attention`). All M requests of a prefix group attend to
// the group's one physical copy of the prefix KV, up to prefix_lens[p],
// and the kernel returns (out, lse) for the LSE merge with each request's
// own suffix.
//
// Bound: device-memory bytes. Each prefix K/V element serves the R = M * G
// query rows of its kv head (4 flops per row and element, about R flops
// per byte), far below the card's ~295 until R reaches the hundreds. So the
// design reads every prefix K/V element from device memory once, and puts
// enough blocks in flight to reach the memory rate.
//
// bf16 (the serving path; D in {64, 128, 256}):
// * One block of eight warps owns (prefix p, kv head h, chunk of S) and all
//   R rows of (p, h): the TPU kernel's own blocking (one (M * G, D) block
//   of q per (p, h)). Each staged K/V tile serves every row tile of 16
//   before it is dropped, so a prefix element is read from device memory
//   once. A block holds 128 rows in registers (256 below D = 256 with two
//   row tiles a warp); a group with more rows takes further passes, each
//   its own cluster, and each pass reads the prefix again.
// * S is split into chunks, chosen on the host from the allocated S and the
//   card's SM count (never from prefix_lens, which lie on the device): as
//   many chunks per (p, h) as leave about one block per SM, 1 to 8. At
//   P = 8, KV = 8, S = 1024: 2 chunks of 4 tiles, 128 blocks. A chunk that
//   begins at or past prefix_lens[p] reads nothing and leaves an empty
//   partial (m = -1e30, l = 0, acc = 0).
// * K/V tiles of block_s rows (rounded up to 32; at most 64 at D = 256, so
//   that two stages fit) arrive by TMA into a ring of up to three stages
//   behind mbarriers: thread 0 keeps the next tiles
//   in flight under this tile's arithmetic, and no thread spends an
//   instruction on the copy. TMA rather than cp.async.bulk: one request per
//   32-column box instead of one per 2 * D-byte row, zeros for the rows past
//   S for free, and the 64-byte swizzle that lets ldmatrix read rows of 8
//   without bank conflicts. Tiles stay bf16 in shared memory.
// * Scores and P V run on tensor cores (mma.sync m16n8k16, f32
//   accumulation, fragments through ldmatrix; V through ldmatrix.trans as
//   it lies). P is rounded to bf16 for P V, as in K3. With fewer than eight
//   row tiles the warps also split each tile's keys 32 at a time (up to 4
//   slices), so more warps work; each keeps its own (m, l, acc) per row.
// * The chunks of one (p, h) run as one thread-block cluster, and the
//   partials never pass through device memory: after the last tile the
//   key slices of each row fold, one after the other, into the row's one
//   slot (m, l, acc) in the block's shared memory (over the freed stages).
//   After cluster.sync() the block that owns row r (block r % chunks) reads
//   the row's slot from every block of the cluster through distributed
//   shared memory, merges them and writes out and lse; a second
//   cluster.sync() keeps each block resident until the others have read
//   it. One launch. Shared memory holds one slot per row of the pass, so
//   every pass size fits (the host checks, and refuses a launch that would
//   not).
// * V rows at or past the valid length are zeroed in shared memory before
//   P V (the TPU kernel zeroes its padded V rows) and their keys masked.
//
// f32 (held to 2e-5, so no TF32) and the other head sizes keep the
// earlier CUDA-core kernel below: one block of 128 threads per (p, h, tile
// of 16 rows) walks S in block_s steps (64 at D = 256, where 128 rows of
// f32 K and V do not fit), staging K/V as f32, 4 x 4 register tiles per
// lane. It is not on the serving path.
//
// Semantics follow the TPU kernel: out = acc / max(l, 1e-30) in q's
// dtype, lse = m + log(max(l, 1e-30)) in f32, so a zero-length prefix
// gives out = 0 and lse = -1e30.
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace repro {

// ---------------------------------------------------------------------------
// f32 path (and bf16 at other head sizes): CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int K2_ROWS = 16;                      // query rows per block ...
constexpr int K2_WARP_ROWS = K2_ROWS / WARPS;    // ... 4 per warp
constexpr int K2_MAX_KEYS = 128;                 // keys staged per step: 4 per lane
constexpr int K2_LANE_KEYS = K2_MAX_KEYS / 32;
constexpr int K2_MAX_COLS = 8;                   // output columns per lane: D <= 256
constexpr size_t K2_MAX_SMEM = 232448;           // shared memory per block on an H100

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
  // stage fewer rows where block_s rows of f32 K and V do not fit (D = 256)
  while (block_s > 32 && k2_smem_bytes(D, block_s) > K2_MAX_SMEM) block_s /= 2;
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

// ---------------------------------------------------------------------------
// bf16 path: split-S tensor-core kernel with a cluster merge
// ---------------------------------------------------------------------------
constexpr int K2T_WARPS = 8;
constexpr int K2T_THREADS = 32 * K2T_WARPS;
constexpr int K2T_GROUP = 32;        // keys per online-softmax step of a warp
constexpr int K2T_MAX_KSF = 4;       // key slices per row tile
constexpr int K2T_MAX_CHUNKS = 8;    // blocks of a cluster (the portable maximum)
constexpr int K2T_MAX_STAGES = 3;

template <int D, int RTW_>
struct K2T {
  static constexpr int ND = D / 8;                        // output n-tiles of 8 columns
  static constexpr int RTW = RTW_;                        // row tiles of 16 a warp holds
  static constexpr int PASS_ROWS = 16 * K2T_WARPS * RTW;  // rows a block holds
  static constexpr int QS = D + 8;                        // q row stride in shared memory
};

// Key slices per row tile: the warps a pass's n_rt row tiles leave free
// split each tile's keys (4 at most, one group of 32 keys per warp and tile).
__host__ __device__ inline int k2t_ksf(int n_rt) {
  const int k = K2T_WARPS / n_rt;
  return k < 1 ? 1 : (k > K2T_MAX_KSF ? K2T_MAX_KSF : k);
}

// Shared-memory carve-up, the same on the host and in the kernel, for a
// pass of `rows` rows (a multiple of 16). After the last tile the K/V
// stages (from offset 0) hold each row's partial acc, rows padded to D + 8
// floats; q, and m and l of each row, lie past them.
struct K2TSmem {
  size_t q, pm, pl, bar, total;
  __host__ __device__ K2TSmem(int D, int BS, int n_stages, int rows) {
    const size_t stages = (size_t)4 * D * BS * n_stages;
    const size_t merge = (size_t)rows * (D + 8) * 4;
    q = stages > merge ? stages : merge;
    pm = q + (size_t)rows * (D + 8) * 2;
    pl = pm + (size_t)rows * 4;
    bar = (pl + (size_t)rows * 4 + 7) & ~(size_t)7;
    total = bar + K2T_MAX_STAGES * 8 + 1024;   // + the slack of aligning the base
  }
};

// Element (r, c) of a (rows, D) bf16 tile staged by TMA as D / 32 boxes of
// (rows, 32) with the 64-byte swizzle: 16-byte chunk (c % 32) / 8 of row r
// sits at chunk ((c % 32) / 8) ^ ((r / 2) % 4). c is a multiple of 8.
__device__ __forceinline__ __nv_bfloat16* sw64(__nv_bfloat16* tile, int rows, int r, int c) {
  return tile + (c >> 5) * rows * 32 + r * 32 + ((((c >> 3) & 3) ^ ((r >> 1) & 3)) << 3);
}

template <int D, int RTW>
__global__ void __launch_bounds__(K2T_THREADS)
shared_prefix_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __nv_bfloat16* __restrict__ q, const int* __restrict__ prefix_lens,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int M, int H,
                        int KV, int S, int BS, int tiles_per_chunk, int n_stages, int n_pass,
                        float scale2) {
  using L = K2T<D, RTW>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = static_cast<int>(cluster.block_rank());
  const int n_chunks = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.y, p = blockIdx.z / n_pass, pass = blockIdx.z - p * n_pass;
  const int G = H / KV, R = M * G;
  const int r0 = pass * L::PASS_ROWS;            // this pass's first row of (p, h)
  const int nr = min(L::PASS_ROWS, R - r0);
  const int n_rt = (nr + 15) / 16;               // row tiles of 16
  const int ksf = k2t_ksf(n_rt);                 // key slices per row tile
  const int q_rows = min(L::PASS_ROWS, (R + 15) / 16 * 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const K2TSmem lay(D, BS, n_stages, q_rows);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(base);   // stage st: K, then V
  // (q_rows, D) partial acc of each row, rows padded to D + 8 floats: the
  // float2 stores of a quad's 8 rows then fall on distinct banks
  float* pacc = reinterpret_cast<float*>(base);
  constexpr int PS = D + 8;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(base + lay.q);   // (q_rows, QS)
  float* pm = reinterpret_cast<float*>(base + lay.pm);   // m of each row, log2 units
  float* pl = reinterpret_cast<float*>(base + lay.pl);   // l of each row
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bar);

  // offset of row r (< R) of (p, h) in q / out (P, M, H, D), divided by D
  auto row_off = [&](int r) -> long long {
    const int m = r / G, gg = r - (r / G) * G;
    return ((long long)p * M + m) * H + (long long)h * G + gg;
  };

  const int valid = min(max(prefix_lens[p], 0), S);
  const int t_begin = chunk * tiles_per_chunk;
  const int t_end = min(t_begin + tiles_per_chunk, (valid + BS - 1) / BS);
  const int n_my = max(0, t_end - t_begin);      // tiles of this chunk below the valid length
  const uint32_t stage_bytes = 4u * D * BS;

  const CUtensorMap* map_k = &tm_k;   // the maps stay in parameter space
  const CUtensorMap* map_v = &tm_v;
  auto issue = [&](int i) {   // tile i of this chunk into stage i % n_stages
    const int st = i % n_stages, s0 = (t_begin + i) * BS;
    __nv_bfloat16* ks = kv_s + (size_t)st * 2 * BS * D;
    __nv_bfloat16* vs = ks + (size_t)BS * D;
    mbar_expect_tx(&full[st], stage_bytes);
#pragma unroll
    for (int bx = 0; bx < D / 32; ++bx) {
      tma_load_4d(ks + bx * BS * 32, map_k, &full[st], bx * 32, h, s0, p);
      tma_load_4d(vs + bx * BS * 32, map_v, &full[st], bx * 32, h, s0, p);
    }
  };
  // q rows of this pass, bf16 as they lie, by cp.async (rows past R zeroed)
  for (int i = tid; i < n_rt * 16 * (D / 8); i += K2T_THREADS) {
    const int r = i / (D / 8), c = (i - r * (D / 8)) * 8;
    cp_async_16(q_s + r * L::QS + c, q + row_off(r0 + min(r, nr - 1)) * D + c, r < nr);
  }
  cp_async_commit();
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) mbar_init(&full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(n_stages, n_my); ++i) issue(i);
  cp_async_wait<0>();

  // this warp's row tiles (slots j) and key slice
  int rt_of[L::RTW];
  int nslots = 0, ks = 0;
#pragma unroll
  for (int j = 0; j < L::RTW; ++j) rt_of[j] = 0;
  if (ksf > 1) {
    if (warp < n_rt * ksf) {
      rt_of[0] = warp % n_rt;
      ks = warp / n_rt;
      nslots = 1;
    }
  } else {
#pragma unroll
    for (int j = 0; j < L::RTW; ++j)
      if (warp + K2T_WARPS * j < n_rt) {
        rt_of[j] = warp + K2T_WARPS * j;
        nslots = j + 1;
      }
  }
  float m_a[L::RTW], m_b[L::RTW], l_a[L::RTW], l_b[L::RTW], o[L::RTW][L::ND][4];
#pragma unroll
  for (int j = 0; j < L::RTW; ++j) {
    m_a[j] = m_b[j] = NEG_INF;
    l_a[j] = l_b[j] = 0.f;
#pragma unroll
    for (int n = 0; n < L::ND; ++n) o[j][n][0] = o[j][n][1] = o[j][n][2] = o[j][n][3] = 0.f;
  }
  // ldmatrix lane addressing: row (l % 8) + 8 ((l / 8) % 2), column block l / 16
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  __syncthreads();   // q_s written

  for (int i = 0; i < n_my; ++i) {
    const int st = i % n_stages;
    mbar_wait(&full[st], (i / n_stages) & 1);
    const int s0 = (t_begin + i) * BS;
    const int rows = min(BS, valid - s0);         // keys below the valid length, >= 1
    __nv_bfloat16* k_s = kv_s + (size_t)st * 2 * BS * D;
    __nv_bfloat16* v_s = k_s + (size_t)BS * D;
    if (rows < BS) {   // zero V rows at or past the valid length (block-uniform test)
      for (int e = tid; e < (BS - rows) * (D / 8); e += K2T_THREADS) {
        const int r = rows + e / (D / 8), c = (e - (e / (D / 8)) * (D / 8)) * 8;
        *reinterpret_cast<uint4*>(sw64(v_s, BS, r, c)) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();   // before TMA refills this stage
      __syncthreads();
    }
    const int n_groups = (rows + K2T_GROUP - 1) / K2T_GROUP;
#pragma unroll
    for (int j = 0; j < L::RTW; ++j) {
      if (j < nslots) {
        const int rt = rt_of[j];
        for (int grp = ks; grp < n_groups; grp += ksf) {
          const int kb = grp * K2T_GROUP;
          // S = (q K^T) for the tile's 16 rows x 32 keys: 4 fragments of 16 x 8
          float sc[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
          for (int kc = 0; kc < D / 16; ++kc) {
            uint32_t a[4];
            ldmatrix_x4(a, q_s + (rt * 16 + lr) * L::QS + kc * 16 + lc);
#pragma unroll
            for (int n = 0; n < 4; n += 2) {   // B fragments of key tiles n and n + 1
              uint32_t bk[4];
              ldmatrix_x4(bk, sw64(k_s, BS, kb + n * 8 + (lane & 7) + (lane >> 4) * 8,
                                   kc * 16 + ((lane >> 3) & 1) * 8));
              mma_bf16_16816(sc[n], a, bk[0], bk[1]);
              mma_bf16_16816(sc[n + 1], a, bk[2], bk[3]);
            }
          }
          // online softmax (base 2) of rows g (elements 0, 1) and g + 8 (2, 3);
          // keys at or past the valid length masked
          float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = kb + n * 8 + tq * 2 + e < rows;
              sc[n][e] = in ? sc[n][e] * scale2 : NEG_INF;
              sc[n][2 + e] = in ? sc[n][2 + e] * scale2 : NEG_INF;
              mx_a = fmaxf(mx_a, sc[n][e]);
              mx_b = fmaxf(mx_b, sc[n][2 + e]);
            }
          }
#pragma unroll
          for (int o_ = 1; o_ <= 2; o_ <<= 1) {   // the 4 lanes of a quad share a row
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
          }
          const float mn_a = fmaxf(m_a[j], mx_a), mn_b = fmaxf(m_b[j], mx_b);
          const float al_a = exp2f(m_a[j] - mn_a), al_b = exp2f(m_b[j] - mn_b);
          m_a[j] = mn_a;
          m_b[j] = mn_b;
          float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[n][e] = exp2f(sc[n][e] - mn_a);
              sc[n][2 + e] = exp2f(sc[n][2 + e] - mn_b);
              sum_a += sc[n][e];
              sum_b += sc[n][2 + e];
            }
          }
          l_a[j] = l_a[j] * al_a + sum_a;
          l_b[j] = l_b[j] * al_b + sum_b;
#pragma unroll
          for (int n = 0; n < L::ND; ++n) {
            o[j][n][0] *= al_a;
            o[j][n][1] *= al_a;
            o[j][n][2] *= al_b;
            o[j][n][3] *= al_b;
          }
          // O += P V over the group's keys, two steps of 16
#pragma unroll
          for (int kc = 0; kc < 2; ++kc) {
            const uint32_t a[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                                   pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                                   pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                                   pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
            for (int n = 0; n < L::ND; n += 2) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, sw64(v_s, BS, kb + kc * 16 + lr, n * 8 + lc));
              mma_bf16_16816(o[j][n], a, bv[0], bv[1]);
              mma_bf16_16816(o[j][n + 1], a, bv[2], bv[3]);
            }
          }
        }
      }
    }
    __syncthreads();   // stage st is no longer read
    if (tid == 0 && i + n_stages < n_my) issue(i + n_stages);
  }

  // 1. each row's partial into its slot in this block's shared memory
  //    (over the stages): m and l in log2 units, acc unnormalised. The key
  //    slices of a row tile fold into the tile's slots one after the other.
  for (int s = 0; s < ksf; ++s) {
    if (ks == s) {
#pragma unroll
      for (int j = 0; j < L::RTW; ++j) {
        if (j < nslots) {
          float la = l_a[j], lb = l_b[j];
#pragma unroll
          for (int o_ = 1; o_ <= 2; o_ <<= 1) {
            la += __shfl_xor_sync(0xffffffffu, la, o_);
            lb += __shfl_xor_sync(0xffffffffu, lb, o_);
          }
          const int sa = rt_of[j] * 16 + g, sb = sa + 8;
          float ma = m_a[j], mb = m_b[j];
          float wa = 1.f, wb = 1.f, ua = 0.f, ub = 0.f;   // weights of this slice, of the slot
          if (s > 0) {   // the slot holds the earlier slices: rescale both to the joint max
            const float oa = pm[sa], ob = pm[sb];
            const float na = fmaxf(ma, oa), nb = fmaxf(mb, ob);
            wa = exp2f(ma - na);
            ua = exp2f(oa - na);
            wb = exp2f(mb - nb);
            ub = exp2f(ob - nb);
            la = la * wa + pl[sa] * ua;
            lb = lb * wb + pl[sb] * ub;
            ma = na;
            mb = nb;
            __syncwarp();   // every lane of the quad has read m and l
          }
          if (tq == 0) {
            pm[sa] = ma;
            pl[sa] = la;
            pm[sb] = mb;
            pl[sb] = lb;
          }
#pragma unroll
          for (int n = 0; n < L::ND; ++n) {
            float2* da = reinterpret_cast<float2*>(pacc + (size_t)sa * PS + n * 8 + tq * 2);
            float2* db = reinterpret_cast<float2*>(pacc + (size_t)sb * PS + n * 8 + tq * 2);
            const float2 pa = s > 0 ? *da : make_float2(0.f, 0.f);
            const float2 pb = s > 0 ? *db : make_float2(0.f, 0.f);
            *da = make_float2(o[j][n][0] * wa + pa.x * ua, o[j][n][1] * wa + pa.y * ua);
            *db = make_float2(o[j][n][2] * wb + pb.x * ub, o[j][n][3] * wb + pb.y * ub);
          }
        }
      }
    }
    __syncthreads();
  }
  cluster.sync();   // every block's slots are written
  // 2. rows chunk, chunk + n_chunks, ...: read the row's slot from every
  //    block of the cluster, merge, and write out and lse, four columns per
  //    thread and step
  const int my_rows = (nr - chunk + n_chunks - 1) / n_chunks;
  for (int it = tid; it < my_rows * (D / 4); it += K2T_THREADS) {
    const int k = it / (D / 4), c4 = (it - k * (D / 4)) * 4;
    const int r = chunk + k * n_chunks;
    float mc[K2T_MAX_CHUNKS], mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < K2T_MAX_CHUNKS; ++c) {
      mc[c] = c < n_chunks ? *cluster.map_shared_rank(pm + r, c) : NEG_INF;
      mx = fmaxf(mx, mc[c]);
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < K2T_MAX_CHUNKS; ++c) {
      if (c < n_chunks) {
        const float w = exp2f(mc[c] - mx);   // 0 for an empty chunk beside a real one
        const float4 a4 =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc + (size_t)r * PS + c4, c));
        l += w * *cluster.map_shared_rank(pl + r, c);
        acc.x += w * a4.x;
        acc.y += w * a4.y;
        acc.z += w * a4.z;
        acc.w += w * a4.w;
      }
    }
    const float lc_ = fmaxf(l, 1e-30f), inv = 1.f / lc_;
    const long long off = row_off(r0 + r);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + off * D + c4);
    dst[0] = __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    dst[1] = __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
    // no valid key anywhere: m stays -1e30, as the TPU kernel leaves it
    if (c4 == 0) lse[off] = mx <= 0.5f * NEG_INF ? NEG_INF : mx * LN2 + logf(lc_);
  }
  cluster.sync();   // no block leaves while another still reads its shared memory
}

// The launch of the tensor-core kernel for one call: tile, passes, chunks
// (the cluster size), stages and shared memory.
struct K2TPlan {
  int rtw, BS, n_pass, q_rows, n_chunks, tpc, n_stages;
  size_t smem;
};

// Row tiles per warp: one up to 128 rows, else two below D = 256.
inline int k2t_rtw(int D, int R) { return D <= 128 && R > 16 * K2T_WARPS ? 2 : 1; }

inline K2TPlan k2t_plan(int P, int M, int H, int KV, int D, int S, int block_s) {
  K2TPlan pl;
  const int R = M * (H / KV);
  pl.rtw = k2t_rtw(D, R);
  const int pass_rows = 16 * K2T_WARPS * pl.rtw;
  pl.BS = std::min({128, (block_s + 31) / 32 * 32, 16384 / D});   // a stage of 64 KiB at most
  pl.n_pass = (R + pass_rows - 1) / pass_rows;
  pl.q_rows = (std::min(R, pass_rows) + 15) / 16 * 16;
  const int n_tiles = (S + pl.BS - 1) / pl.BS;
  // about one block per SM, each streaming several tiles: the chunks of a
  // (p, h) are as many as the SMs left over per (p, h, pass), 1 to 8
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long pairs = (long long)P * KV * pl.n_pass;
  pl.n_chunks = (int)std::max<long long>(
      1, std::min<long long>(std::min<long long>(K2T_MAX_CHUNKS, sms / pairs), n_tiles));
  pl.tpc = (n_tiles + pl.n_chunks - 1) / pl.n_chunks;
  pl.n_chunks = (n_tiles + pl.tpc - 1) / pl.tpc;
  // as many stages (up to three) as fit; one always does (a pass of 256
  // rows at D = 128 takes 212 KB), and the launch checks it
  pl.n_stages = std::min(K2T_MAX_STAGES, pl.tpc);
  while (pl.n_stages > 1 && K2TSmem(D, pl.BS, pl.n_stages, pl.q_rows).total > K2_MAX_SMEM)
    --pl.n_stages;
  pl.smem = K2TSmem(D, pl.BS, pl.n_stages, pl.q_rows).total;
  return pl;
}

template <int D, int RTW>
cudaError_t launch_k2_tc_rtw(const K2TPlan& pl, const void* q, const void* prefix_k,
                             const void* prefix_v, const int* prefix_lens, void* out, float* lse,
                             int P, int M, int H, int KV, int S, float sm_scale,
                             cudaStream_t stream) {
  if (pl.smem > K2_MAX_SMEM) return cudaErrorInvalidConfiguration;
  CUtensorMap tm_k, tm_v;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)KV, (uint64_t)S, (uint64_t)P};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)KV * D * 2, (uint64_t)S * KV * D * 2};
  const uint32_t box[4] = {32, 1, (uint32_t)pl.BS, 1};
  cudaError_t err = make_tensor_map_bf16(&tm_k, prefix_k, 4, dims, strides, box,
                                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = make_tensor_map_bf16(&tm_v, prefix_v, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = allow_smem_once<shared_prefix_tc_kernel<D, RTW>>(K2_MAX_SMEM);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.n_chunks, KV, P * pl.n_pass);
  cfg.blockDim = dim3(K2T_THREADS);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.n_chunks;   // the chunks of one (p, h, pass)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, shared_prefix_tc_kernel<D, RTW>, tm_k, tm_v,
                           static_cast<const __nv_bfloat16*>(q), prefix_lens,
                           static_cast<__nv_bfloat16*>(out), lse, M, H, KV, S, pl.BS, pl.tpc,
                           pl.n_stages, pl.n_pass, sm_scale * LOG2E);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k2_tc(const void* q, const void* prefix_k, const void* prefix_v,
                         const int* prefix_lens, void* out, float* lse, int P, int M, int H,
                         int KV, int S, int block_s, float sm_scale, cudaStream_t stream) {
  const K2TPlan pl = k2t_plan(P, M, H, KV, D, S, block_s);
  if (pl.rtw == 2)
    return launch_k2_tc_rtw<D, (D <= 128 ? 2 : 1)>(pl, q, prefix_k, prefix_v, prefix_lens, out,
                                                   lse, P, M, H, KV, S, sm_scale, stream);
  return launch_k2_tc_rtw<D, 1>(pl, q, prefix_k, prefix_v, prefix_lens, out, lse, P, M, H, KV, S,
                                sm_scale, stream);
}

// Which kernel a bf16 call takes: the tensor-core one at the head sizes it
// is built for, with a prefix to read.
inline bool k2_uses_tc(int D, int S) { return S > 0 && (D == 64 || D == 128 || D == 256); }

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
      if (repro::k2_uses_tc(D, S)) {
        if (D == 64)
          return repro::launch_k2_tc<64>(q, prefix_k, prefix_v, prefix_lens, out, lse, P, M, H,
                                         KV, S, block_s, sm_scale, s);
        if (D == 128)
          return repro::launch_k2_tc<128>(q, prefix_k, prefix_v, prefix_lens, out, lse, P, M, H,
                                          KV, S, block_s, sm_scale, s);
        return repro::launch_k2_tc<256>(q, prefix_k, prefix_v, prefix_lens, out, lse, P, M, H,
                                        KV, S, block_s, sm_scale, s);
      }
      return repro::launch_k2<__nv_bfloat16>(q, prefix_k, prefix_v, prefix_lens, out, lse, P,
                                             M, H, KV, D, S, block_s, sm_scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The launch a bf16 call with these sizes gets from the tensor-core kernel:
// out = {cluster size (chunks of S), tiles per chunk, stages, row passes,
// dynamic shared memory in bytes, keys per tile}. Returns 1 if that kernel
// takes the call, 0 if the CUDA-core kernel does (out untouched).
extern "C" int repro_shared_prefix_attention_plan(int P, int M, int H, int KV, int D, int S,
                                                  int block_s, int* out) {
  if (KV <= 0 || H % KV != 0 || !repro::k2_uses_tc(D, S)) return 0;
  const repro::K2TPlan pl = repro::k2t_plan(P, M, H, KV, D, S, block_s);
  const int vals[6] = {pl.n_chunks, pl.tpc, pl.n_stages, pl.n_pass, (int)pl.smem, pl.BS};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 1;
}

