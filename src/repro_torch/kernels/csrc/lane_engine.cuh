// The lane engine: one request of one lane of the flat shared-LRU cache,
// written once as plain serial C++ and compiled twice — by nvcc into the
// CUDA kernel of lane_engine.cu (one thread per lane), and by g++ into the
// host library of lane_engine_host.cpp (the kernel's plain version, which
// the CPU tests hold to the reference package).
//
// It replaces the XLA programs of the reference's core/fastsim_jax.py:
// `_drive_impl` (one lane, fastsim_jax.py:138) and `_drive_batched_impl`
// (R lanes with per-lane (b, b_hat) sweep points, :364). Those are
// branch-free because XLA wants them so; on CUDA each lane simply runs its
// own nested loops, so the step below is the serial form of the same
// computation (the serial C of _fastsim_c.c drive_chunk computes it too,
// over a sparse slot layout). Every read and write happens in
// _drive_impl's order, so a lane's state stays equal to the XLA state
// array for array, not only in the outputs:
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
// is int32, exact inside fastsim._xla_applicable's envelope.
//
// What bounds it on the card: each lane is a chain of dependent loads (a
// hit step reads hold[ik], head[i] and prv/nxt of k, then writes the links
// of its neighbours), so a lane runs at the memory latency of its state —
// L1/L2 for the Table I system's 80 KB per lane, device memory for the
// Fig. 2 system's 200 MB. One thread per lane leaves the card mostly idle
// when lanes are few; a warp per lane over the J-wide updates, and state
// in shared memory for small N, are the next designs.
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

// Lane r's slice of every state tensor.
struct Lane {
  int32_t *nxt, *prv, *hold, *res_since, *tot_time;
  int32_t *hcnt, *length, *gnxt, *gprv, *isghost;
  int32_t *head, *tail, *vlen, *hits_p, *reqs_p;
  const int32_t *b, *bhat;
  int32_t *hist;
  int32_t phys, ghead, gtail, t_start;
  int32_t n_hit_list, n_hit_cache, n_miss, n_sets, n_prim, n_rip;
};

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

LE_FN void lane_store(const Args& a, int r, const Lane& s) {
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
LE_FN void ghost_evict_head(Lane& s) {
  const int32_t g = s.ghead;
  const int32_t gn = s.gnxt[g];
  s.ghead = gn;
  if (gn == NIL) s.gtail = NIL;
  else s.gprv[gn] = NIL;
  s.isghost[g] = 0;
  s.phys -= s.length[g];
  s.length[g] = 0;
}

// One request (proxy i, object k) at absolute index idx.
LE_FN void lane_step(Lane& s, const Args& a, int32_t idx, int32_t i, int32_t k) {
  const int64_t N = a.N;
  const int J = a.J;
  const int32_t* share = a.share;
  const int64_t base = i * N, ik = base + k;
  const bool post = idx >= a.warmup;

  const bool held = s.hold[ik] == 1;
  const bool resident = s.length[k] > 0;
  const bool att = !held;                 // a cache hit or a miss attaches k to list i
  const bool miss = !held && !resident;
  if (held) s.n_hit_list++;
  else if (resident) s.n_hit_cache++;
  else s.n_miss++;
  if (held && post) s.hits_p[i]++;

  // miss: make physical room among the ghosts, become resident
  if (miss) {
    const int32_t l_new = a.lengths[k];
    while (s.phys + l_new > a.B && s.ghead != NIL) ghost_evict_head(s);
    s.length[k] = l_new;
    s.phys += l_new;
  }

  if (att) {
    // attach bookkeeping: the share re-apportionment of eq. (5)
    const int32_t l = s.length[k];
    const int32_t p_old = s.hcnt[k];
    const int32_t delta = l * (share[p_old + 1] - share[p_old]);
    for (int j = 0; j < J; ++j)           // holders before i joins
      if (s.hold[j * N + k]) s.vlen[j] += delta;
    s.vlen[i] += l * share[p_old + 1];
    if (p_old == 0 && s.isghost[k] == 1) {  // a ghost comes back: unlink it
      const int32_t gp = s.gprv[k], gn = s.gnxt[k];
      if (gp == NIL) s.ghead = gn;
      else s.gnxt[gp] = gn;
      if (gn == NIL) s.gtail = gp;
      else s.gprv[gn] = gp;
      s.isghost[k] = 0;
    }
    s.hold[ik] = 1;
    s.hcnt[k] += 1;
  }

  // list hit: unlink k from its place (k is not the head, so nx != NIL)
  const bool rem = held && s.head[i] != k;
  if (rem) {
    const int32_t p = s.prv[ik], nx = s.nxt[ik];
    if (p == NIL) s.tail[i] = nx;
    else s.nxt[base + p] = nx;
    s.prv[base + nx] = p;
  }
  // insert k at the head of list i
  if (rem || att) {
    const int32_t h = s.head[i];
    if (h == NIL) s.tail[i] = k;      // only an attach finds list i empty
    else s.nxt[base + h] = k;
    s.prv[ik] = h;
    s.nxt[ik] = NIL;
    s.head[i] = k;
  }
  if (att) s.res_since[ik] = idx;

  // eviction loop: RRE thresholds, b for the triggering list i, b_hat else
  int32_t n_ev = 0, n_rip = 0;
  if (att) {
    for (;;) {
      int worst = -1;
      int32_t over = 0;
      for (int j = 0; j < J; ++j) {
        const int32_t o = s.vlen[j] - (j == i ? s.b[j] : s.bhat[j]);
        if (o > over) { over = o; worst = j; }
      }
      if (worst < 0) break;
      const int64_t wbase = worst * N;
      const int32_t v = s.tail[worst];
      const int64_t wv = wbase + v;
      // unlink the tail victim (its prv is NIL)
      const int32_t nv = s.nxt[wv];
      s.tail[worst] = nv;
      if (nv == NIL) s.head[worst] = NIL;
      else s.prv[wbase + nv] = NIL;
      // close its residence interval
      const int32_t since = s.res_since[wv];
      if (since >= 0) s.tot_time[wv] += idx - (since > s.t_start ? since : s.t_start);
      s.res_since[wv] = NIL;
      // share re-apportionment: the remaining holders inflate
      const int32_t vl = s.length[v];
      const int32_t vp_old = s.hcnt[v];
      s.vlen[worst] -= vl * share[vp_old];
      s.hold[wv] = 0;
      s.hcnt[v] -= 1;
      const int32_t vdelta = vl * (share[vp_old - 1] - share[vp_old]);
      for (int j = 0; j < J; ++j)
        if (s.hold[j * N + v]) s.vlen[j] += vdelta;
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
      s.hist[n_ev < HIST - 1 ? n_ev : HIST - 1]++;
      s.n_rip += n_rip;
      s.n_prim += n_ev - n_rip;
    }
  }
  if (post) s.reqs_p[i]++;
}

// Lane r walks its m requests of this chunk.
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

}  // namespace lane_engine
