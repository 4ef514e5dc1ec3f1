// The lane engine on the card: one block per lane. Its warp 0 (the
// walker) takes the lane's chunk of requests through lane_engine.cuh's
// step, in order; the other warps feed it. This is the serial form of the
// reference's XLA lane engine (core/fastsim_jax.py:138 and :364); one
// launch advances every lane by one chunk, and the state stays in device
// memory between launches, in the reference's layout. See lane_engine.cuh
// for the semantics.
//
// What bounds a lane: its steps form one chain, each waiting on the last,
// so a lane runs at the latency of that chain and never at a rate of bytes
// or operations. On an H100 the chain is mostly the walker's own
// instructions: a Table I lane in shared memory runs only about 1.2 times
// as fast as the same lane in the L2 (scripts/time_lane_engine.py). The
// design shortens the chain where it can:
//
//  - the walker is a whole warp (the team Warp below): list j's entries of
//    the J-wide arrays live in lane j's registers, so the step's J-wide
//    loops are one instruction a lane and a vote, and head[i], tail[i] or
//    vlen[i] is a shuffle, not a load and a store;
//  - the requests come through NBUF tiles of TILE in shared memory: while
//    the walker takes tile t, the other warps load tile t + NBUF - 1, so
//    the walker never waits on device memory for a request.
//
// Two routes, chosen by the host from a lane's shared-memory words
// (lane_engine.cuh shared_words) against the card's opt-in limit per
// block, one route per launch:
//
//  1. Shared memory (WHOLE = true), for lanes that fit (the Table I system,
//     J=3, N=1000: 90 KB with the tiles, two blocks an SM). The block
//     copies the lane's arrays into shared memory at launch start,
//     coalesced, and back at the end (about 0.08 ms a launch); every access
//     of the walk is then a shared-memory access. Only the evictions
//     histogram stays in device memory (a miss touches it once).
//  2. Device memory (WHOLE = false), for larger lanes (the Fig. 2 system,
//     J=9, N=1e6: 200 MB a lane). The arrays stay where they are. The
//     walker posts the request it takes, and warp 1 follows it: it brings
//     into the L2 the lines of the requests up to PREFETCH ahead, one
//     request a lane: hold, nxt, prv and res_since at
//     i*N + k, length, hcnt and isghost at k, and k's holder column. No
//     value is loaded early, because the walker rewrites those lines. An
//     eviction's tail victim is known only when the eviction runs, so its
//     lines cannot be prefetched: each eviction still waits on the memory
//     that holds it. (A prefetch issued by the walker itself stalled it and
//     cost a Fig. 2 lane 40%.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_engine.cuh"

namespace {

using namespace lane_engine;

constexpr int THREADS = 128;   // warp 0 walks; warps 1-3 load tiles (route 2: warp 1 prefetches)

// Requests ahead of the walker whose lines route 2's prefetch warp brings
// into the L2. Found on an H100 with scripts/time_lane_engine.py, which
// builds copies with -DLE_PREFETCH=<d>: the Fig. 2 lanes gain about 5% at
// any distance from 4 to 32 over no prefetch warp, the Table I lanes nothing.
#ifndef LE_PREFETCH
#define LE_PREFETCH 8
#endif
constexpr int PREFETCH = LE_PREFETCH;
static_assert(PREFETCH >= 1 && PREFETCH <= TILE, "prefetch distance out of [1, TILE]");

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

constexpr unsigned FULL = 0xffffffffu;
// The walker's warp as lane_engine.cuh's team: list j's entries of the
// J-wide arrays live in lane j's registers (j + 32 in its second), so the
// step's J-wide loops are one instruction a lane and a vote, and reading
// head[i], tail[i] or vlen[i] is a shuffle from lane i. All 32 lanes run
// the rest of the step together on the same values, so their stores to
// the lane's other arrays agree. The warp is not assumed to run in step:
// one lane may run ahead of another between the warp's votes and shuffles.
// A cell that the step reads and then rewrites with no vote between would
// then be read by a late lane after an early one rewrote it, so those
// three sites go through add_to and swap: swap has every lane load before
// any lane stores (__syncwarp); add_to does the same in shared memory, and
// in device memory lets lane 0 alone add atomically (no lane of the step
// reads such a cell, and the walker does not wait on device memory for a
// victim's residence total: a Fig. 2 lane ran 6% slower with __syncwarp
// there). The step rewrites no other cell it has read since its last
// vote; that is the only ordering the team relies on.
struct Warp {
  struct Vec {
    int32_t lo, hi;   // entries l and l + 32 of lane l
  };
  __device__ __forceinline__ static int lane() { return threadIdx.x & 31; }
  __device__ __forceinline__ static int32_t at(const Vec& v, int j) {
    return __shfl_sync(FULL, j < 32 ? v.lo : v.hi, j & 31);
  }
  __device__ __forceinline__ static void put(Vec& v, int j, int32_t x) {
    if (lane() == (j & 31)) {
      if (j < 32) v.lo = x;
      else v.hi = x;
    }
  }
  __device__ __forceinline__ static void add(Vec& v, int j, int32_t x) {
    if (lane() == (j & 31)) {
      if (j < 32) v.lo += x;
      else v.hi += x;
    }
  }
  __device__ __forceinline__ static void add_to(int32_t* p, int32_t d) {
    if (__isShared(p)) {   // each such cell of a route lies in one space
      const int32_t v = *p;
      __syncwarp();
      *p = v + d;
    } else if (lane() == 0) {
      atomicAdd(p, d);
    }
  }
  __device__ __forceinline__ static int32_t swap(int32_t* p, int32_t x) {
    const int32_t v = *p;
    __syncwarp();
    *p = x;
    return v;
  }
  __device__ __forceinline__ static void add_mask(Vec& v, int, uint64_t mask, int32_t x) {
    const int l = lane();
    if ((mask >> l) & 1) v.lo += x;
    if ((mask >> (l + 32)) & 1) v.hi += x;
  }
  __device__ __forceinline__ static uint64_t column(const int32_t* hold, int J, int32_t N,
                                                    int32_t k) {
    const int l = lane();
    const unsigned lo = __ballot_sync(FULL, l < J && hold[l * N + k] != 0);
    const unsigned hi = __ballot_sync(FULL, l + 32 < J && hold[(l + 32) * N + k] != 0);
    return (uint64_t)hi << 32 | lo;
  }
  __device__ __forceinline__ static int worst(const Vec& vlen, const Vec& b, const Vec& bhat,
                                              int J, int32_t i) {
    const int l = lane();
    const int32_t o0 = l < J ? vlen.lo - (l == i ? b.lo : bhat.lo) : INT32_MIN;
    const int32_t o1 = l + 32 < J ? vlen.hi - (l + 32 == i ? b.hi : bhat.hi) : INT32_MIN;
    const int32_t best = __reduce_max_sync(FULL, max(o0, o1));
    const unsigned lo = __ballot_sync(FULL, o0 == best);
    const unsigned hi = __ballot_sync(FULL, o1 == best);
    return best <= 0 ? -1 : lo ? __ffs(lo) - 1 : 31 + __ffs(hi);
  }
  // Lane l's entries of a J-wide array in device memory, and back.
  __device__ __forceinline__ static Vec load(const int32_t* g, int J) {
    const int l = lane();
    return {l < J ? g[l] : 0, l + 32 < J ? g[l + 32] : 0};
  }
  __device__ __forceinline__ static void store(int32_t* g, const Vec& v, int J) {
    const int l = lane();
    if (l < J) g[l] = v.lo;
    if (l + 32 < J) g[l + 32] = v.hi;
  }
};

// The lines of request (i, k)'s step that can be known ahead of it.
__device__ __forceinline__ void prefetch_request(const Lane& g, int J, int32_t N, int32_t i,
                                                 int32_t k) {
  const int32_t ik = i * N + k;
  prefetch_l2(g.nxt + ik);
  prefetch_l2(g.prv + ik);
  prefetch_l2(g.res_since + ik);
  prefetch_l2(g.length + k);
  prefetch_l2(g.hcnt + k);
  prefetch_l2(g.isghost + k);
  for (int j = 0; j < J; ++j) prefetch_l2(g.hold + j * N + k);
}

// Copy n words between device and shared memory with the whole block.
__device__ __forceinline__ void block_copy(int32_t* dst, const int32_t* src, int64_t n) {
  for (int64_t x = threadIdx.x; x < n; x += THREADS) dst[x] = src[x];
}

template <bool WHOLE>
__global__ void __launch_bounds__(THREADS) lane_engine_kernel(const Args a) {
  extern __shared__ int32_t sm[];
  const int r = blockIdx.x;
  const int J = a.J;
  const int32_t N = a.N;
  const int64_t JN = (int64_t)J * N;
  const Lane g = lane_load(a, r);     // the lane in device memory

  // -- stage the lane into shared memory ---------------------------------
  int32_t* p = sm;
  int32_t* big[10] = {g.nxt, g.prv, g.hold, g.res_since, g.tot_time,
                      g.hcnt, g.length, g.gnxt, g.gprv, g.isghost};
  if (WHOLE) {
#pragma unroll
    for (int f = 0; f < 10; ++f) {
      const int64_t n = f < 5 ? JN : N;
      block_copy(p, big[f], n);
      big[f] = p;
      p += n;
    }
  }
  Args la = a;                        // the walker's arguments: constants in shared memory
  block_copy(p, a.share, J + 2);
  la.share = p;
  p += J + 2;
  if (WHOLE) {
    block_copy(p, a.lengths, N);
    la.lengths = p;
    p += N;
  }
  volatile int32_t* walker_at = p++;  // the request the walker takes (route 2's prefetch)
  int32_t* tiles = p;                 // NBUF x (TILE proxies, TILE objects)

  // -- the walker's view of the lane ----------------------------------------
  LaneT<Warp> s;
  s.nxt = big[0]; s.prv = big[1]; s.hold = big[2]; s.res_since = big[3]; s.tot_time = big[4];
  s.hcnt = big[5]; s.length = big[6]; s.gnxt = big[7]; s.gprv = big[8]; s.isghost = big[9];
  s.hist = g.hist;
  s.phys = g.phys; s.ghead = g.ghead; s.gtail = g.gtail; s.t_start = g.t_start;
  s.n_hit_list = g.n_hit_list; s.n_hit_cache = g.n_hit_cache; s.n_miss = g.n_miss;
  s.n_sets = g.n_sets; s.n_prim = g.n_prim; s.n_rip = g.n_rip;
  const bool walker = threadIdx.x < 32;
  if (walker) {
    s.head = Warp::load(g.head, J);
    s.tail = Warp::load(g.tail, J);
    s.vlen = Warp::load(g.vlen, J);
    s.hits_p = Warp::load(g.hits_p, J);
    s.reqs_p = Warp::load(g.reqs_p, J);
    s.b = Warp::load(g.b, J);
    s.bhat = Warp::load(g.bhat, J);
  }

  // -- the walk: tile t is walked while tile t + NBUF - 1 loads ----------
  const int m = a.m;
  const int32_t* P = a.P + (int64_t)r * m;
  const int32_t* O = a.O + (int64_t)r * m;
  const int ntiles = (m + TILE - 1) / TILE;
  auto load_tile = [&](int t, int first, int nthreads) {
    int32_t* dst = tiles + (t % NBUF) * 2 * TILE;
    const int b0 = t * TILE, n = min(TILE, m - b0);
    for (int x = (int)threadIdx.x - first; x < n; x += nthreads) {
      dst[x] = P[b0 + x];
      dst[TILE + x] = O[b0 + x];
    }
  };
  auto req = [&](int off, int w) {
    return tiles[(off / TILE) % NBUF * 2 * TILE + w * TILE + off % TILE];
  };
  // Route 2's prefetch warp (warp 1) follows the walker: the walker posts
  // the request it takes, and the prefetch warp issues the lines of the
  // requests up to PREFETCH ahead of it, one request a lane.
  const bool prefetcher = !WHOLE && threadIdx.x >= 32 && threadIdx.x < 64;
  const int first_loader = WHOLE ? 32 : 64;
  if (threadIdx.x == 0) *walker_at = -1;
  for (int t = 0; t < NBUF - 1 && t < ntiles; ++t) load_tile(t, 0, THREADS);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int b0 = t * TILE, e = min(m, b0 + TILE);
    const int ahead = min(m, (t + NBUF - 1) * TILE);   // requests loaded so far
    if (walker) {
      const int32_t* tp = tiles + (t % NBUF) * 2 * TILE;   // this tile's proxies, objects
      const int n = e - b0;
      int32_t i = tp[0], k = tp[TILE];
      for (int x = 0; x < n; ++x) {
        const int32_t i_next = x + 1 < n ? tp[x + 1] : 0;   // read a step ahead
        const int32_t k_next = x + 1 < n ? tp[TILE + x + 1] : 0;
        if (!WHOLE && threadIdx.x == 0) *walker_at = b0 + x;
        lane_step(s, la, a.idx0 + b0 + x, i, k);
        i = i_next;
        k = k_next;
      }
    } else if (prefetcher) {
      for (int done = b0;;) {
        const int at = *walker_at;
        const int upto = min(ahead, max(at, b0 - 1) + 1 + PREFETCH);
        for (int x = done + (threadIdx.x & 31); x < upto; x += 32)
          prefetch_request(g, J, N, req(x, 0), req(x, 1));
        done = max(done, upto);
        if (at >= e - 1 || done >= m) break;
        __nanosleep(200);
      }
    } else if (t + NBUF - 1 < ntiles) {
      load_tile(t + NBUF - 1, first_loader, THREADS - first_loader);
    }
    __syncthreads();
  }

  // -- write the lane back ------------------------------------------------
  if (walker) {
    Warp::store(g.head, s.head, J);
    Warp::store(g.tail, s.tail, J);
    Warp::store(g.vlen, s.vlen, J);
    Warp::store(g.hits_p, s.hits_p, J);
    Warp::store(g.reqs_p, s.reqs_p, J);
    if (threadIdx.x == 0) lane_store(a, r, s);
  }
  if (WHOLE) {
    const int32_t* from[10] = {big[0], big[1], big[2], big[3], big[4],
                               big[5], big[6], big[7], big[8], big[9]};
    int32_t* back[10] = {g.nxt, g.prv, g.hold, g.res_since, g.tot_time,
                         g.hcnt, g.length, g.gnxt, g.gprv, g.isghost};
#pragma unroll
    for (int f = 0; f < 10; ++f) block_copy(back[f], from[f], f < 5 ? JN : N);
  }
}

template <bool WHOLE>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t bytes = 4 * shared_words(a.J, a.N, WHOLE);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > limit) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(lane_engine_kernel<WHOLE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lane_engine_kernel<WHOLE><<<a.R, THREADS, (size_t)bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Load the kernels' module without launching them (asking for a kernel's
// attributes loads a lazily loaded module). Returns the cudaError_t.
extern "C" int repro_lane_engine_load() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, lane_engine_kernel<true>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, lane_engine_kernel<false>);
  return static_cast<int>(err);
}

// The card's opt-in shared memory per block, in bytes (what route 1 may
// take), or -1 with the error in *err.
extern "C" int repro_lane_engine_shared_limit(int device, int* err) {
  int limit = 0;
  *err = static_cast<int>(
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  return *err == 0 ? limit : -1;
}

// Words of shared memory a block takes on route 1 (whole = 1) or 2.
extern "C" int64_t repro_lane_engine_shared_words(int J, int N, int whole) {
  return lane_engine::shared_words(J, N, whole != 0);
}

// Advance R lanes by one chunk of m requests each on route 1 (whole = 1:
// the lane in shared memory) or route 2 (whole = 0: in device memory,
// prefetched PREFETCH requests ahead). Returns the launch's cudaError_t; a lane
// too large for route 1 is refused (cudaErrorInvalidValue), never moved.
extern "C" int repro_lane_engine(const uint64_t* fields, const int32_t* P, const int32_t* O,
                                 const int32_t* lengths, const int32_t* share, int R, int J,
                                 int N, int m, int idx0, int B, int warmup, int ripple_from,
                                 int ghost, int whole, void* stream) {
  if (lane_engine::check_shape(R, J, N, m) != 0) return cudaErrorInvalidValue;
  const lane_engine::Args a = lane_engine::make_args(fields, P, O, lengths, share, R, J, N, m,
                                                     idx0, B, warmup, ripple_from, ghost);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return whole ? launch<true>(a, st) : launch<false>(a, st);
}
