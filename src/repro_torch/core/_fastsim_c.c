/* C hot loop of the shared-LRU array simulation engine.
 *
 * A line-for-line port of the (slower, equivalent) pure-Python loops in
 * repro_torch/core/fastsim.py — which are themselves proven equivalent,
 * event for event, to the reference SharedLRUCache by
 * tests/test_fastsim.py. Same struct-of-arrays layout: intrusive
 * doubly-linked lists, holder bitmasks, exact lcm-scaled virtual
 * lengths, ghost list, inline residence-time (PASTA) occupancy
 * accumulation.
 *
 * Streaming + sparse layout (Section VI-C scale): the per-(proxy,
 * object) vectors (list pointers and occupancy accumulators) are NOT
 * dense (J, N) arrays. Objects get a slot in a touched-set the first
 * time they enter any list; per-slot state is indexed slot*J + proxy.
 * Untouched objects cost nothing beyond the N-sized id->slot map and
 * contribute exactly zero occupancy. drive_chunk() consumes one chunk
 * of the request stream and keeps all engine state resident across
 * calls (counters live in the in/out scalar block), so a trace can be
 * streamed through without ever being materialized; it returns early
 * when the slot capacity is exhausted so the caller can grow the slot
 * arrays and resume mid-chunk.
 *
 * Built on demand by repro_torch/core/fastsim_c.py with the system C compiler
 * (cc -O2 -shared -fPIC); if that fails the Python loops take over.
 */

#include <stdint.h>
#include <string.h>

#define NIL (-1)

/* out_scalars layout (in/out) — must match fastsim_c.py */
enum {
    SC_PHYS = 0,
    SC_GHEAD,
    SC_GTAIL,
    SC_NGHOSTS,
    SC_TSTART,
    SC_NHITLIST,
    SC_NHITCACHE,
    SC_NMISS,
    SC_NSETS,
    SC_NPRIM,
    SC_NRIP,
    SC_NBATCH,
    SC_NSLOTS,
    SC_SETSSINCE,
    SC_COUNT
};

/* Data contracts the `cbounds` analyzer rule (tools/analyze/cbounds.py)
 * uses to prove every array subscript in this file in bounds. Each line
 * is an invariant of the binding layer (fastsim_c.py) or of the list
 * structures themselves; the prover treats them as axioms and checks
 * everything else. Keep them true.
 */
/* cbounds: P[] < J  -- binding layer validates proxy ids before the call */
/* cbounds: O[] < N  -- binding layer validates object ids before the call */
/* cbounds: slot[] < slot_cap  -- id->slot map only ever holds allocated
 *            slots (or -1); a slot is assigned only under the
 *            n_slots == slot_cap capacity guard below */
/* cbounds: head[] < N  -- list heads hold object ids or NIL */
/* cbounds: tail[] < N  -- list tails hold object ids or NIL */
/* cbounds: nxt[] < N   -- intrusive links hold object ids or NIL */
/* cbounds: prv[] < N   -- intrusive links hold object ids or NIL */
/* cbounds: gnxt[] < N  -- ghost links hold object ids or NIL */
/* cbounds: gprv[] < N  -- ghost links hold object ids or NIL */
/* cbounds: __builtin_ctzll() < J  -- holder masks only set bits < J */
/* cbounds: __builtin_popcountll() <= J  -- holder masks have at most J
 *            set bits */

/* One full trim loop: repeatedly evict the lowest-rank object of the
 * list with the largest overflow until none remains (the paper's
 * operator loop). The limit of list j is b_scaled[j] when j == trig,
 * else lim_other[j]; pass lim_other = b_scaled with trig = -1 for the
 * RRE delayed-batch trim. Returns the eviction count; *n_rip_out gets
 * the number with worst != trig (ignored when NULL). Static + few call
 * sites, so the compiler inlines it back into the drive loop. */
static int64_t trim_loop(
    int64_t J, int64_t trig,
    const int64_t *b_scaled, const int64_t *lim_other,  /* (J)   */
    const int64_t *share,                 /* (J+2) */
    int64_t ghost_retention,
    int64_t now, int64_t t_start,
    const int64_t *slot,                  /* (N)   */
    int64_t *nxt, int64_t *prv,           /* (slot_cap*J) */
    int64_t *head, int64_t *tail,         /* (J)   */
    uint64_t *hmask,                      /* (N)   */
    int64_t *length,                      /* (N)   */
    int64_t *vlen,                        /* (J)   */
    int64_t *gnxt, int64_t *gprv,         /* (N)   */
    uint8_t *isghost,                     /* (N)   */
    int64_t *res_since, int64_t *tot_time,/* (slot_cap*J) */
    int64_t *phys, int64_t *ghead, int64_t *gtail, int64_t *n_ghosts,
    int64_t *n_rip_out)
{
    /* cbounds: *gtail < N  -- the ghost tail holds an object id whenever
     *            it is dereferenced as an index (NIL-guarded) */
    int64_t n_ev = 0, n_rp = 0;
    for (;;) {
        int64_t worst = -1, worst_over = 0;
        for (int64_t j = 0; j < J; j++) {
            int64_t over = vlen[j] - (j == trig ? b_scaled[j] : lim_other[j]);
            if (over > worst_over) { worst = j; worst_over = over; }
        }
        if (worst < 0) break;
        int64_t v = tail[worst], wv = slot[v] * J + worst;
        int64_t nv = nxt[wv];
        tail[worst] = nv;
        if (nv == NIL) head[worst] = NIL; else prv[slot[nv] * J + worst] = NIL;
        int64_t since = res_since[wv];
        if (since >= 0) {
            tot_time[wv] += now - (since > t_start ? since : t_start);
            res_since[wv] = -1;
        }
        uint64_t mv = hmask[v];
        int64_t lv = length[v];
        int64_t p_old = (int64_t)__builtin_popcountll(mv);
        mv &= ~(1ull << worst);
        hmask[v] = mv;
        vlen[worst] -= lv * share[p_old];
        if (mv) {
            int64_t delta = lv * share[p_old - 1] - lv * share[p_old];
            while (mv) {
                vlen[__builtin_ctzll(mv)] += delta;  /* inflation */
                mv &= mv - 1;
            }
        } else if (ghost_retention) {
            if (*gtail == NIL) *ghead = v; else gnxt[*gtail] = v;
            gprv[v] = *gtail; gnxt[v] = NIL; *gtail = v;
            isghost[v] = 1; (*n_ghosts)++;
        } else {
            *phys -= lv; length[v] = 0;
        }
        n_ev++;
        if (worst != trig) n_rp++;
    }
    if (n_rip_out) *n_rip_out = n_rp;
    return n_ev;
}

/* Drive one chunk [idx0, idx0 + n_chunk) of the request stream through
 * the flat shared-LRU engine. All state (dense N-sized vectors, the
 * slot map, per-slot vectors, counters in sc) is caller-owned and
 * persists across calls. Returns the number of requests consumed:
 * == n_chunk normally, less when a new object needs a slot and
 * slot_cap is exhausted (the caller grows the slot arrays and calls
 * again with idx0 advanced). Finalization of open residence intervals
 * is the caller's job (vectorized numpy) once the stream ends. */
int64_t drive_chunk(
    int64_t idx0, int64_t n_chunk,
    int64_t J, int64_t N,
    const int32_t *P, const int64_t *O,   /* (n_chunk) request chunk   */
    const int64_t *lengths,       /* (N)   l_k                         */
    const int64_t *b_scaled,      /* (J)   primary allocations * M     */
    const int64_t *bhat_scaled,   /* (J)   RRE ripple allocations * M  */
    const int64_t *share,         /* (J+2) [0, M/1, ..., M/J, 0]       */
    int64_t scale, int64_t B, int64_t ghost_retention,
    int64_t warmup, int64_t ripple_from, int64_t batch_interval,
    /* dense per-object state, preallocated + initialised by caller: */
    int64_t *head, int64_t *tail,         /* (J)   */
    uint64_t *hmask,                      /* (N)   */
    int64_t *length,                      /* (N)   */
    int64_t *vlen,                        /* (J)   */
    int64_t *gnxt, int64_t *gprv,         /* (N)   */
    uint8_t *isghost,                     /* (N)   */
    /* sparse touched-set state: */
    int64_t *slot,                        /* (N) object -> slot, -1    */
    int64_t *slot_key,                    /* (slot_cap) slot -> object */
    int64_t slot_cap,
    int64_t *nxt, int64_t *prv,           /* (slot_cap*J), slot-major  */
    int64_t *res_since, int64_t *tot_time,/* (slot_cap*J), slot-major  */
    /* outputs: */
    int64_t *sc,                          /* (SC_COUNT) scalars, in/out */
    int64_t *hits_p, int64_t *reqs_p,     /* (J) post-warmup counters   */
    int64_t *hist, int64_t hist_len)      /* (hist_len) evictions-per-set */
{
    /* cbounds: ghead < N  -- the ghost head holds an object id whenever
     *            it is read as an index (NIL-guarded) */
    int64_t phys = sc[SC_PHYS], ghead = sc[SC_GHEAD], gtail = sc[SC_GTAIL];
    int64_t n_ghosts = sc[SC_NGHOSTS], t_start = sc[SC_TSTART];
    int64_t n_hit_list = sc[SC_NHITLIST], n_hit_cache = sc[SC_NHITCACHE];
    int64_t n_miss = sc[SC_NMISS];
    int64_t n_sets = sc[SC_NSETS], n_prim = sc[SC_NPRIM];
    int64_t n_rip = sc[SC_NRIP], n_batch = sc[SC_NBATCH];
    int64_t n_slots = sc[SC_NSLOTS], sets_since_batch = sc[SC_SETSSINCE];

#define FLUSH_SCALARS() do { \
        sc[SC_PHYS] = phys; sc[SC_GHEAD] = ghead; sc[SC_GTAIL] = gtail; \
        sc[SC_NGHOSTS] = n_ghosts; sc[SC_TSTART] = t_start; \
        sc[SC_NHITLIST] = n_hit_list; sc[SC_NHITCACHE] = n_hit_cache; \
        sc[SC_NMISS] = n_miss; \
        sc[SC_NSETS] = n_sets; sc[SC_NPRIM] = n_prim; sc[SC_NRIP] = n_rip; \
        sc[SC_NBATCH] = n_batch; sc[SC_NSLOTS] = n_slots; \
        sc[SC_SETSSINCE] = sets_since_batch; \
    } while (0)

    for (int64_t off = 0; off < n_chunk; off++) {
        int64_t idx = idx0 + off;
        if (idx == warmup) {
            memset(tot_time, 0, (size_t)(n_slots * J) * sizeof(int64_t));
            t_start = idx;
        }
        int64_t i = (int64_t)P[off];
        int64_t k = O[off];
        uint64_t m = hmask[k];
        if ((m >> i) & 1u) {
            /* ---- HIT_LIST: promote to head of list i ---- */
            n_hit_list++;
            if (head[i] != k) {
                int64_t ik = slot[k] * J + i;
                int64_t p = prv[ik], nx = nxt[ik];
                if (p == NIL) tail[i] = nx; else nxt[slot[p] * J + i] = nx;
                prv[slot[nx] * J + i] = p;   /* nx != NIL: k is not the head */
                int64_t h = head[i];
                nxt[slot[h] * J + i] = k;
                prv[ik] = h; nxt[ik] = NIL; head[i] = k;
            }
            if (idx >= warmup) { reqs_p[i]++; hits_p[i]++; }
            continue;
        }
        int64_t l = length[k];
        int64_t is_set;
        if (l > 0) {
            /* ---- HIT_CACHE: attach to list i (slot exists: k entered
             * some list when it was first set) ---- */
            n_hit_cache++;
            if (m) {
                int64_t p_old = (int64_t)__builtin_popcountll(m);
                int64_t delta = l * share[p_old + 1] - l * share[p_old];
                uint64_t mm = m;
                while (mm) {
                    vlen[__builtin_ctzll(mm)] += delta;  /* deflation */
                    mm &= mm - 1;
                }
                hmask[k] = m | (1ull << i);
                vlen[i] += l * share[p_old + 1];
            } else {
                /* resurrected ghost */
                hmask[k] = 1ull << i;
                vlen[i] += l * scale;
                int64_t gp = gprv[k], gn = gnxt[k];
                if (gp == NIL) ghead = gn; else gnxt[gp] = gn;
                if (gn == NIL) gtail = gp; else gprv[gn] = gp;
                isghost[k] = 0; n_ghosts--;
            }
            is_set = 0;
        } else {
            /* ---- MISS -> fetch + set(k, l_k) ---- */
            if (slot[k] < 0) {
                if (n_slots == slot_cap) {
                    /* out of touched-set capacity: hand back to the
                     * caller BEFORE mutating anything for this request */
                    FLUSH_SCALARS();
                    return off;
                }
                slot[k] = n_slots;
                slot_key[n_slots++] = k;
            }
            n_miss++;
            l = lengths[k];
            while (phys + l > B && ghead != NIL) {
                int64_t g = ghead;
                ghead = gnxt[g];
                if (ghead == NIL) gtail = NIL; else gprv[ghead] = NIL;
                isghost[g] = 0; n_ghosts--;
                phys -= length[g]; length[g] = 0;
            }
            length[k] = l; phys += l;
            hmask[k] = 1ull << i;
            vlen[i] += l * scale;
            is_set = 1;
        }
        /* link k at head of list i (+ occupancy attach) */
        {
            int64_t ik = slot[k] * J + i;
            int64_t h = head[i];
            if (h == NIL) tail[i] = k; else nxt[slot[h] * J + i] = k;
            prv[ik] = h; nxt[ik] = NIL; head[i] = k;
            res_since[ik] = idx;
        }
        /* ---- eviction loop (RRE thresholds; trigger = i) ---- */
        int64_t n_rp;
        int64_t n_ev = trim_loop(
            J, i, b_scaled, bhat_scaled, share, ghost_retention,
            idx, t_start, slot, nxt, prv, head, tail, hmask, length, vlen,
            gnxt, gprv, isghost, res_since, tot_time,
            &phys, &ghead, &gtail, &n_ghosts, &n_rp);
        if (is_set) {
            /* reconcile transient physical overshoot */
            while (phys > B && ghead != NIL) {
                int64_t g = ghead;
                ghead = gnxt[g];
                if (ghead == NIL) gtail = NIL; else gprv[ghead] = NIL;
                isghost[g] = 0; n_ghosts--;
                phys -= length[g]; length[g] = 0;
            }
            if (batch_interval > 0 && ++sets_since_batch >= batch_interval) {
                /* delayed batch trim to primary allocations (RRE) */
                sets_since_batch = 0;
                n_batch += trim_loop(
                    J, -1, b_scaled, b_scaled, share, ghost_retention,
                    idx, t_start, slot, nxt, prv, head, tail, hmask,
                    length, vlen, gnxt, gprv, isghost, res_since, tot_time,
                    &phys, &ghead, &gtail, &n_ghosts, (int64_t *)0);
            }
            if (idx >= ripple_from) {
                n_sets++;
                hist[n_ev < hist_len ? n_ev : hist_len - 1]++;
                n_rip += n_rp;
                n_prim += n_ev - n_rp;
            }
        }
        if (idx >= warmup) reqs_p[i]++;
    }

    FLUSH_SCALARS();
#undef FLUSH_SCALARS
    return n_chunk;
}

/* J independent full-length-charging LRUs (the Table-III "not shared"
 * baseline), driven with get_autofetch semantics. Chunk-fed like
 * drive_chunk (state persists across calls, counters in sc); the
 * per-(proxy, object) state stays dense (J*N) — the baseline has no
 * sharing mask to piggyback a touched-set on, and it is only run at
 * Section-V scale. Caller finalizes open residence intervals. */
int64_t noshare_chunk(
    int64_t idx0, int64_t n_chunk,
    int64_t J, int64_t N,
    const int32_t *P, const int64_t *O,   /* (n_chunk) request chunk */
    const int64_t *lengths,               /* (N)   */
    const int64_t *b,                     /* (J)   */
    int64_t warmup,
    int64_t *nxt, int64_t *prv,           /* (J*N) */
    int64_t *head, int64_t *tail,         /* (J)   */
    uint8_t *inlist,                      /* (J*N) */
    int64_t *used,                        /* (J)   */
    int64_t *res_since, int64_t *tot_time,/* (J*N) */
    int64_t *sc,                          /* (3) [t_start, n_hit, n_miss] */
    int64_t *hits_p, int64_t *reqs_p)     /* (J) */
{
    int64_t t_start = sc[0], n_hit = sc[1], n_miss = sc[2];
    for (int64_t off = 0; off < n_chunk; off++) {
        int64_t idx = idx0 + off;
        if (idx == warmup) {
            memset(tot_time, 0, (size_t)(J * N) * sizeof(int64_t));
            t_start = idx;
        }
        int64_t i = (int64_t)P[off];
        int64_t k = O[off];
        int64_t base = i * N, ik = base + k;
        if (inlist[ik]) {
            n_hit++;
            if (head[i] != k) {
                int64_t p = prv[ik], nx = nxt[ik];
                if (p == NIL) tail[i] = nx; else nxt[base + p] = nx;
                prv[base + nx] = p;
                int64_t h = head[i];
                nxt[base + h] = k; prv[ik] = h; nxt[ik] = NIL; head[i] = k;
            }
            if (idx >= warmup) { reqs_p[i]++; hits_p[i]++; }
            continue;
        }
        n_miss++;
        inlist[ik] = 1;
        used[i] += lengths[k];
        int64_t h = head[i];
        if (h == NIL) tail[i] = k; else nxt[base + h] = k;
        prv[ik] = h; nxt[ik] = NIL; head[i] = k;
        res_since[ik] = idx;
        while (used[i] > b[i]) {
            int64_t v = tail[i], iv = base + v;
            int64_t nv = nxt[iv];
            tail[i] = nv;
            if (nv == NIL) head[i] = NIL; else prv[base + nv] = NIL;
            inlist[iv] = 0;
            used[i] -= lengths[v];
            int64_t since = res_since[iv];
            if (since >= 0) {
                tot_time[iv] += idx - (since > t_start ? since : t_start);
                res_since[iv] = -1;
            }
        }
        if (idx >= warmup) reqs_p[i]++;
    }
    sc[0] = t_start; sc[1] = n_hit; sc[2] = n_miss;
    return n_chunk;
}
