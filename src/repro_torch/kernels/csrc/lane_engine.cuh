// The lane engine: one request of one lane of the flat shared-LRU cache,
// written once as plain serial C++ and compiled twice — by nvcc into the
// CUDA kernels of lane_engine.cu (one block per lane, its warp 0 walking
// the requests), and by g++ into the host library of
// lane_engine_host.cpp (the kernels' plain version, which the CPU tests
// hold to the reference package).
//
// It replaces the XLA programs of the reference's core/fastsim_jax.py:
// `_drive_impl` (one lane, fastsim_jax.py:138) and `_drive_batched_impl`
// (R lanes with per-lane (b, b_hat) sweep points, :364). Those are
// branch-free because XLA wants them so; on CUDA each lane simply runs its
// own nested loops, so the step below is the serial form of the same
// computation (the serial C of _fastsim_c.c drive_chunk computes it too,
// over a sparse slot layout). Every value is read as _drive_impl reads it,
// so a lane's state stays equal to the XLA state array for array, not only
// in the outputs:
//  - the holder column is read before i's bit is set (attach), and after
//    the victim's bit is cleared (eviction);
//  - the head of list i is read after a list hit has unlinked k;
//  - argmax(vlen - lim) takes the lowest index among equal maxima
//    (a strict `>` from 0, as the XLA argmax and the C trim loop do);
//  - a predicated scatter of the XLA program is a branch here, so no
//    index -1 is ever dereferenced;
//  - lengths are read live inside evictions: with ghosts evictions never
//    change them; without ghosts a consensus eviction zeroes the length.
//
// State is the dense int32 layout of fastsim_jax._init_state, lane-major:
// (R, J*N) list links, holder bits, residence starts and residence totals
// (index i*N + k), (R, N) holder counts, lengths and the ghost list,
// (R, J) heads, tails, virtual lengths and post-warmup counters, (R, 1024)
// the evictions-per-set histogram and (R, LE_NSC) scalars. All arithmetic
// is int32, exact inside fastsim._xla_applicable's envelope, which also
// keeps J*N < 2^31: indices inside a lane are int32.
//
// What bounds it: a lane is one chain of dependent steps, so it runs at
// the latency of that chain, never at a rate of bytes or operations. The
// step is written to keep the chain short: everything it reads before its
// first store (hold[ik], length[k], hcnt[k], isghost[k], prv/nxt of k,
// k's holder column and head[i]) is read at once, from cells that no
// earlier part of the step writes, so a list hit is one level of loads and
// then stores, an attach adds share[hcnt[k]], and each eviction two levels
// (the victim's cells and holder column at once, then share[hcnt[v]])
// after the argmax that picks its list. The J-wide arrays
// and loops go through a team (Serial here; the kernels' walker warp keeps
// them in registers, lane_engine.cu), and so do the three cells the step
// reads and rewrites in place (a residence total, a histogram bucket and
// an evicted ghost's length: T::add_to, T::swap). The walker's own
// instructions, not the memory, take most of a step on an H100
// (lane_engine.cu).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define LE_FN __host__ __device__ __forceinline__
#else
#define LE_FN inline
#endif

namespace lane_engine {

constexpr int HIST = 1024;   // fastsim.HIST_BUCKETS: the last bucket clamps
constexpr int32_t NIL = -1;
constexpr int MAX_J = 62;    // the holder column is a 64-bit mask

// Requests a block holds in shared memory: NBUF tiles of TILE proxies and
// TILE objects (lane_engine.cu walks tile t while tile t + NBUF - 1 loads,
// and looks up to TILE requests ahead into tile t + 1).
constexpr int TILE = 256;
constexpr int NBUF = 3;

// Scalars of a lane, in the order of the (R, NSC) tensor.
enum Scalar : int {
  PHYS = 0, GHEAD, GTAIL, T_START, N_HIT_LIST, N_HIT_CACHE, N_MISS, N_SETS, N_PRIM, N_RIP,
  NSC
};

// The state tensors, in the order of the pointer table the host passes.
enum Field : int {
  NXT = 0, PRV, HOLD, RES_SINCE, TOT_TIME,   // (R, J*N)
  HCNT, LENGTH, GNXT, GPRV, ISGHOST,         // (R, N)
  HEAD, TAIL, VLEN, HITS_P, REQS_P,          // (R, J)
  B_LIM, BHAT_LIM,                           // (R, J) b * M and b_hat * M per lane
  HISTOGRAM,                                 // (R, HIST)
  SCALARS,                                   // (R, NSC)
  NFIELDS
};

// Words of shared memory a block takes on each route of lane_engine.cu.
// Route 1 (the whole lane): the five J*N arrays, the five N arrays,
// lengths, share, the walker's position and the request tiles. Route 2:
// share, the position and the tiles. The histogram stays in device memory
// on both (a miss touches it once); the J-wide arrays and the scalars live
// in the walker's registers.
LE_FN int64_t shared_words(int J, int N, bool whole_lane) {
  const int64_t small = (J + 2) + 1 + 2 * (int64_t)NBUF * TILE;
  return whole_lane ? small + 5 * (int64_t)J * N + 6 * (int64_t)N : small;
}

struct Args {
  int32_t* f[NFIELDS];
  const int32_t* P;        // (R, m) proxies of this chunk
  const int32_t* O;        // (R, m) objects of this chunk
  const int32_t* lengths;  // (N,)
  const int32_t* share;    // (J + 2,): [0, M/1, ..., M/J, 0]
  int R, J, N, m;
  int32_t idx0, B, warmup, ripple_from;
  int ghost;               // ghost retention on
};

// How the step reaches a lane's J-wide arrays (head, tail, vlen, hits_p,
// reqs_p, b, b_hat), runs its J-wide loops and rewrites a cell it has just
// read. Serial: one thread, the arrays in memory; lane_engine.cu's kernels
// pass a team of their own with the same members (the walker's warp, list
// j in lane j's registers).
struct Serial {
  using Vec = int32_t*;
  // *p += d, and *p = x returning the old value: the step's only writes to
  // a cell of the lane's arrays that it read since its last J-wide vote.
  LE_FN static void add_to(int32_t* p, int32_t d) { *p += d; }
  LE_FN static int32_t swap(int32_t* p, int32_t x) {
    const int32_t v = *p;
    *p = x;
    return v;
  }
  LE_FN static int32_t at(const Vec& v, int j) { return v[j]; }
  LE_FN static void put(Vec& v, int j, int32_t x) { v[j] = x; }
  LE_FN static void add(Vec& v, int j, int32_t x) { v[j] += x; }
  // v[j] += x for every list j of mask.
  LE_FN static void add_mask(Vec& v, int J, uint64_t mask, int32_t x) {
    for (int j = 0; j < J; ++j)
      if ((mask >> j) & 1) v[j] += x;
  }
  // Object k's holder column as a bit mask (bit j: list j holds k).
  LE_FN static uint64_t column(const int32_t* hold, int J, int32_t N, int32_t k) {
    uint64_t m = 0;
    for (int j = 0; j < J; ++j) m |= (uint64_t)(hold[j * N + k] != 0) << j;
    return m;
  }
  // The list furthest over its threshold (b for the triggering list i,
  // b_hat else): the lowest index among equal maxima, -1 when none is over.
  LE_FN static int worst(const Vec& vlen, const Vec& b, const Vec& bhat, int J, int32_t i) {
    int w = -1;
    int32_t over = 0;
    for (int j = 0; j < J; ++j) {
      const int32_t o = vlen[j] - (j == i ? b[j] : bhat[j]);
      if (o > over) { over = o; w = j; }
    }
    return w;
  }
};

// Lane r's slice of every state tensor.
template <class T>
struct LaneT {
  int32_t *nxt, *prv, *hold, *res_since, *tot_time;
  int32_t *hcnt, *length, *gnxt, *gprv, *isghost;
  typename T::Vec head, tail, vlen, hits_p, reqs_p, b, bhat;
  int32_t *hist;
  int32_t phys, ghead, gtail, t_start;
  int32_t n_hit_list, n_hit_cache, n_miss, n_sets, n_prim, n_rip;
};
using Lane = LaneT<Serial>;

LE_FN Lane lane_load(const Args& a, int r) {
  const int64_t JN = (int64_t)a.J * a.N, N = a.N, J = a.J;
  Lane s;
  s.nxt = a.f[NXT] + r * JN;
  s.prv = a.f[PRV] + r * JN;
  s.hold = a.f[HOLD] + r * JN;
  s.res_since = a.f[RES_SINCE] + r * JN;
  s.tot_time = a.f[TOT_TIME] + r * JN;
  s.hcnt = a.f[HCNT] + r * N;
  s.length = a.f[LENGTH] + r * N;
  s.gnxt = a.f[GNXT] + r * N;
  s.gprv = a.f[GPRV] + r * N;
  s.isghost = a.f[ISGHOST] + r * N;
  s.head = a.f[HEAD] + r * J;
  s.tail = a.f[TAIL] + r * J;
  s.vlen = a.f[VLEN] + r * J;
  s.hits_p = a.f[HITS_P] + r * J;
  s.reqs_p = a.f[REQS_P] + r * J;
  s.b = a.f[B_LIM] + r * J;
  s.bhat = a.f[BHAT_LIM] + r * J;
  s.hist = a.f[HISTOGRAM] + (int64_t)r * HIST;
  const int32_t* sc = a.f[SCALARS] + (int64_t)r * NSC;
  s.phys = sc[PHYS];
  s.ghead = sc[GHEAD];
  s.gtail = sc[GTAIL];
  s.t_start = sc[T_START];
  s.n_hit_list = sc[N_HIT_LIST];
  s.n_hit_cache = sc[N_HIT_CACHE];
  s.n_miss = sc[N_MISS];
  s.n_sets = sc[N_SETS];
  s.n_prim = sc[N_PRIM];
  s.n_rip = sc[N_RIP];
  return s;
}

template <class T>
LE_FN void lane_store(const Args& a, int r, const LaneT<T>& s) {
  int32_t* sc = a.f[SCALARS] + (int64_t)r * NSC;
  sc[PHYS] = s.phys;
  sc[GHEAD] = s.ghead;
  sc[GTAIL] = s.gtail;
  sc[T_START] = s.t_start;
  sc[N_HIT_LIST] = s.n_hit_list;
  sc[N_HIT_CACHE] = s.n_hit_cache;
  sc[N_MISS] = s.n_miss;
  sc[N_SETS] = s.n_sets;
  sc[N_PRIM] = s.n_prim;
  sc[N_RIP] = s.n_rip;
}

// Evict the head (oldest) ghost: it leaves the physical cache.
template <class T>
LE_FN void ghost_evict_head(LaneT<T>& s) {
  const int32_t g = s.ghead;
  const int32_t gn = s.gnxt[g];
  s.ghead = gn;
  if (gn == NIL) s.gtail = NIL;
  else s.gprv[gn] = NIL;
  s.isghost[g] = 0;
  s.phys -= T::swap(s.length + g, 0);
}

// One request (proxy i, object k) at absolute index idx.
template <class T>
LE_FN void lane_step(LaneT<T>& s, const Args& a, int32_t idx, int32_t i, int32_t k) {
  const int32_t N = a.N;
  const int J = a.J;
  const int32_t* share = a.share;
  const int32_t base = i * N, ik = base + k;
  const bool post = idx >= a.warmup;

  // Every cell the step reads before its first store, loaded at once. None
  // is written before the serial form reads it: a miss's ghost evictions
  // touch only ghosts, and k is no ghost when it misses (a ghost is
  // resident); the attach touches vlen, the ghost list, hold[ik] and
  // hcnt[k]; a list hit's unlink never moves head[i] (k is not the head).
  const int32_t hold_ik = s.hold[ik];
  const int32_t len_k = s.length[k];
  const int32_t p_old = s.hcnt[k];
  const int32_t ghost_k = s.isghost[k];
  const int32_t prv_ik = s.prv[ik], nxt_ik = s.nxt[ik];
  const uint64_t holders = T::column(s.hold, J, N, k);   // i's bit is 0 when it attaches
  const int32_t head_i = T::at(s.head, i);

  const bool held = hold_ik == 1;
  const bool resident = len_k > 0;
  const bool att = !held;                 // a cache hit or a miss attaches k to list i
  const bool miss = !held && !resident;
  s.n_hit_list += held;                   // counters without branches
  s.n_hit_cache += att && resident;
  s.n_miss += miss;
  T::add(s.hits_p, i, held && post);

  // miss: make physical room among the ghosts, become resident
  int32_t l = len_k;
  if (miss) {
    l = a.lengths[k];
    while (s.phys + l > a.B && s.ghead != NIL) ghost_evict_head(s);
    s.length[k] = l;
    s.phys += l;
  }

  if (att) {
    // attach bookkeeping: the share re-apportionment of eq. (5)
    const int32_t sh1 = share[p_old + 1];
    const int32_t delta = l * (sh1 - share[p_old]);
    T::add_mask(s.vlen, J, holders, delta);  // holders before i joins
    T::add(s.vlen, i, l * sh1);
    if (p_old == 0 && ghost_k == 1) {     // a ghost comes back: unlink it
      const int32_t gp = s.gprv[k], gn = s.gnxt[k];
      if (gp == NIL) s.ghead = gn;
      else s.gnxt[gp] = gn;
      if (gn == NIL) s.gtail = gp;
      else s.gprv[gn] = gp;
      s.isghost[k] = 0;
    }
    s.hold[ik] = 1;
    s.hcnt[k] = p_old + 1;
  }

  // list hit: unlink k from its place (k is not the head, so nx != NIL)
  const bool rem = held && head_i != k;
  if (rem) {
    if (prv_ik == NIL) T::put(s.tail, i, nxt_ik);
    else s.nxt[base + prv_ik] = nxt_ik;
    s.prv[base + nxt_ik] = prv_ik;
  }
  // insert k at the head of list i
  if (rem || att) {
    if (head_i == NIL) T::put(s.tail, i, k);   // only an attach finds list i empty
    else s.nxt[base + head_i] = k;
    s.prv[ik] = head_i;
    s.nxt[ik] = NIL;
    T::put(s.head, i, k);
  }
  if (att) s.res_since[ik] = idx;

  // eviction loop: RRE thresholds, b for the triggering list i, b_hat else
  int32_t n_ev = 0, n_rip = 0;
  if (att) {
    for (;;) {
      const int worst = T::worst(s.vlen, s.b, s.bhat, J, i);
      if (worst < 0) break;
      const int32_t wbase = worst * N;
      const int32_t v = T::at(s.tail, worst);
      const int32_t wv = wbase + v;
      // the tail victim's cells, all at once (its prv is NIL)
      const int32_t nv = s.nxt[wv];
      const int32_t since = s.res_since[wv];
      const int32_t vl = s.length[v];
      const int32_t vp_old = s.hcnt[v];
      const uint64_t vholders = T::column(s.hold, J, N, v) & ~((uint64_t)1 << worst);
      // unlink it
      T::put(s.tail, worst, nv);
      if (nv == NIL) T::put(s.head, worst, NIL);
      else s.prv[wbase + nv] = NIL;
      // close its residence interval
      if (since >= 0) T::add_to(s.tot_time + wv, idx - (since > s.t_start ? since : s.t_start));
      s.res_since[wv] = NIL;
      // share re-apportionment: the remaining holders inflate
      const int32_t sh_old = share[vp_old];
      T::add(s.vlen, worst, -(vl * sh_old));
      s.hold[wv] = 0;
      s.hcnt[v] = vp_old - 1;
      T::add_mask(s.vlen, J, vholders, vl * (share[vp_old - 1] - sh_old));
      if (vp_old == 1) {                  // consensus eviction
        if (a.ghost) {
          const int32_t gt = s.gtail;
          if (gt == NIL) s.ghead = v;
          else s.gnxt[gt] = v;
          s.gprv[v] = gt;
          s.gnxt[v] = NIL;
          s.gtail = v;
          s.isghost[v] = 1;
        } else {
          s.phys -= vl;
          s.length[v] = 0;
        }
      }
      n_ev++;
      if (worst != i) n_rip++;
    }
  }

  // miss: reconcile a transient physical overshoot, then record the set
  if (miss) {
    while (s.phys > a.B && s.ghead != NIL) ghost_evict_head(s);
    if (idx >= a.ripple_from) {
      s.n_sets++;
      T::add_to(s.hist + (n_ev < HIST - 1 ? n_ev : HIST - 1), 1);
      s.n_rip += n_rip;
      s.n_prim += n_ev - n_rip;
    }
  }
  T::add(s.reqs_p, i, post);
}

// Lane r walks its m requests of this chunk (the host build's loop; the
// kernels walk the same steps from tiles in shared memory).
LE_FN void lane_run(const Args& a, int r) {
  Lane s = lane_load(a, r);
  const int32_t* P = a.P + (int64_t)r * a.m;
  const int32_t* O = a.O + (int64_t)r * a.m;
  for (int off = 0; off < a.m; ++off) lane_step(s, a, a.idx0 + off, P[off], O[off]);
  lane_store(a, r, s);
}

// The C entry points' shared argument unpacking (same signature for the
// CUDA launch and the host build).
inline Args make_args(const uint64_t* fields, const int32_t* P, const int32_t* O,
                      const int32_t* lengths, const int32_t* share, int R, int J, int N, int m,
                      int idx0, int B, int warmup, int ripple_from, int ghost) {
  Args a;
  for (int f = 0; f < NFIELDS; ++f) a.f[f] = reinterpret_cast<int32_t*>(fields[f]);
  a.P = P;
  a.O = O;
  a.lengths = lengths;
  a.share = share;
  a.R = R;
  a.J = J;
  a.N = N;
  a.m = m;
  a.idx0 = idx0;
  a.B = B;
  a.warmup = warmup;
  a.ripple_from = ripple_from;
  a.ghost = ghost;
  return a;
}

// The entry points' argument check: 0 when the kernels take the lane
// shape (J lists of at most MAX_J, J*N inside int32 indices).
inline int check_shape(int R, int J, int N, int m) {
  if (R < 1 || J < 1 || J > MAX_J || N < 1 || m < 0) return 1;
  if ((int64_t)J * N >= ((int64_t)1 << 31)) return 1;
  return 0;
}

}  // namespace lane_engine
