// Shared pieces of the contention kernels (K7 victim_step, K8
// reclaim_solve, K9 preempt_solve, K10 preempt_rounds): their argument
// block, the per-launch setup that groups the victim pool by node, and the
// victim core of one preemptor attempt as device functions.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:118-181 (`_seg_cumsum`,
// `_orders_drf`, `_orders_prop`, `_orders_evict`) and :184-355
// (`_victim_core`).  The JAX code sorts the whole pool by (node, key...) and
// takes segment sums as one global float32 cumulative sum minus each
// segment's base; here every order is a per-node list, built once per launch
// by ranking each row among its node's rows (the pool holds about
// max_tasks rows a node), and every segment sum is a sequential float64 sum
// along the node's list, rounded to float32 once.  Requests are whole
// numbers, so the float64 sums are exact and the result does not depend on
// the order of terms (see scheduler/victim_kernels.py).
//
// In the storm solves (K8-K10, K15a-c) the setup runs once per solve.  K8
// and K9 run the attempts on one thread-block cluster (vtt_walk_cluster,
// below): a thread a node walks its lists (base and veto flags, the DRF
// and proportion admission passes, the eviction-order prefix with its
// do-while first victim, the node total), then lexicographic minima over
// the cluster give the first covered and the first valid node of the walk,
// and rank 0's thread 0 applies an attempt that is assigned and clean.  K7,
// K12b and K15a / K15b's block cores (victim_step.cu) run the same node walk
// a thread a node over the whole card.
#pragma once

#include "common.cuh"

#define VTT_VICTIM_THREADS 1024

// row flags (scratch `flag`, one byte per pool row)
#define VF_BASE 1
#define VF_CAND 2
#define VF_INPRE 4
#define VF_ADMIT 8

// ctl words
enum {
  VC_ATT = 0,        // ok attempts (rec.att)
  VC_ABORT = 1,      // clean=False seen (or the iteration cap hit)
  VC_ATT_TOTAL = 2,  // ok attempts, rollbacks included / committed tasks
  VC_LAST_V = 3,     // victims of the last phase-1 ok attempt / round
  VC_ANY = 4,        // any phase-1 ok attempt / any commit
  VC_ITERS = 5,      // loop iterations / rounds
  VC_ERROR = 6,      // 1: undo journal overflow
  VC_ACTIVE = 7,     // rounds: active jobs at the round's start
  VC_PROGRESS = 8,   // rounds: the last round progressed
  VC_ANY_WIN = 9,    // rounds: this round had a winner
  VC_NVICT = 10,     // rounds: victims of this round
  VC_WALK = 11,      // walks on node blocks: 1 while an attempt waits for its node
};

// Every kernel and non-inline device function here is static: each kernel
// source includes this header and links into one library.
//
// Mirror of victim_kernels.VictimArgs (ctypes): pointers, then int64 sizes
// and flags, then the two score weights.  State arrays are the wrapper's
// working copies, updated in place.
struct VttVictimArgs {
  // consts
  const float* run_req;
  const int32_t* run_node;
  const int32_t* run_job;
  const int32_t* run_prio;
  const int32_t* run_rank;
  const uint8_t* run_evictable;
  const int32_t* job_queue;
  const int32_t* job_min;
  const float* node_alloc;
  const int32_t* node_max_tasks;
  const uint8_t* node_valid;
  const uint8_t* class_mask;
  const float* class_score;
  const float* queue_deserved;
  const float* total;
  const float* eps;
  // state
  uint8_t* run_live;
  float* releasing;
  float* used;
  int32_t* task_count;
  float* job_alloc;
  int32_t* job_occupied;
  float* queue_alloc;
  // tasks and jobs
  const float* task_req;
  const int32_t* task_class;
  const uint8_t* task_attempt;
  const int32_t* job_start;   // reclaim: job_first
  const int32_t* job_ntasks;
  const int32_t* job_prio;
  const int32_t* under_request;
  const int32_t* queues_order;
  const int32_t* rows_packed;
  const int32_t* job_pstart;
  const int32_t* job_pcount;
  uint8_t* job_avail;   // reclaim javail / preempt job_avail / rounds job_avail0
  uint8_t* queue_live;  // reclaim
  int32_t* pipe;
  int32_t* cursor;
  uint8_t* dropped;
  // records
  int32_t* evict_att;
  int32_t* pipe_node;
  int32_t* pipe_att;
  int32_t* ctl;
  // scratch: pool grouped by node
  int32_t* node_off;   // [N + 1]
  int32_t* node_fill;  // [N]: counts, then next free slots (zeroed by the build)
  int32_t* bucket;     // [V x 8]: the grouped rows' keys by node (VttGroupKey)
  int32_t* l_vidx;     // [V] per node: pool order
  int32_t* l_ev;       // [V] per node: eviction order
  int32_t* l_drf;      // [V] per node: (job, pool index)
  int32_t* l_prop;     // [V] per node: (queue, pool index)
  uint8_t* flag;       // [V]
  // scratch: undo journal (K9)
  unsigned long long* jr_addr;
  uint32_t* jr_old;
  // scratch: rounds (K10)
  int32_t* job_off;     // [J + 1] the pool's rows by job
  int32_t* job_fill;    // [3J], zeroed by the wrapper: rows, live rows, counters
  int32_t* job_bucket;  // [V] per job: its live rows first
  unsigned long long* job_key;  // [V, 2] each bucket entry's eviction-order key
  int32_t* item_off;    // [J + 1] the within-job count's work items by job
  int32_t* cnt_in_job;  // [V], zeroed by the wrapper
  float* cap_flat;      // [N * Q, R]
  float* cons_flat;     // [N * Q, R]
  double* cons_node;    // [N, R]
  int32_t* placed;      // [N]
  int32_t* act_q;       // [Q]
  int32_t* ls_q;        // [Q] ordered-int float bits
  uint8_t* job_active;  // [J]
  float* job_keys;      // [J, 4]
  int32_t* sel;         // [M]
  float* c_key;         // [nC, M, 4] the select's chunk lists (common.cuh VttSel)
  int32_t* c_job;       // [nC, M]
  int32_t* c_rank;      // [nC, M]
  int32_t* c_cnt;       // [nC]
  int32_t* p_node;      // [F]
  int32_t* p_t;         // [F]
  int32_t* p_job;       // [F]
  uint8_t* p_flags;     // [F]
  float* t_val;         // [M, TB, K] tile candidates: values
  int32_t* t_idx;       // [M, TB, K] tile candidates: node rows
  uint8_t* t_any;       // [M, TB] a feasible node in the tile
  // on node blocks (K15a-c; one block is the case S = 1 of K15c)
  unsigned char* walk;  // K15a / K15b: the walk's state (VttWalk), replicated
  int32_t* send;        // a block's record slot (K15a / b: VTT_VB_WORDS; K15c: [M, K, W])
  const int32_t* recv;  // the exchanged records of the S blocks, in block order
  int32_t* p_rec;       // K15c: [F, W] each proposal's node record
  unsigned long long* p_key;  // K15c: [F] the accept's (cell, rank) order
  double* part;         // K15c: a block's partial sums and victim mask [W2]; the
                        // base's: the S blocks' exchanged [S, W2]
  int64_t* x_split;     // K8 / K9: the timed walk's split [32] (null: the untimed kernel)
  int64_t V, N, R, T, J, Q, C, nu, nq, M, P, K, F, jr_cap, TB, TILE;
  int64_t use_gang, use_drf, use_prop, use_conformance, order_by_priority;
  int64_t has_proportion, gang_pipelined, n_keys, key0, key1, key2;
  // K12b, K15a-c: the node planes are rows [n0, n0 + N) of NT (0: all NT = N rows)
  int64_t n0, NT;
  // K15a-c: blocks over the mesh, K15c's record words and partial words;
  // K10 / K15c: the select's chunks
  int64_t S, W, W2, nC;
  // K8 / K9: the cluster size asked for (0: the largest the card admits)
  int64_t cluster;
  float w_least, w_balanced;
};

__device__ __forceinline__ int vtt_clamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// queue of pool row v, or -1 (a job whose queue is missing)
__device__ __forceinline__ int vtt_row_queue(const VttVictimArgs& a, int v) {
  return a.job_queue[a.run_job[v]];
}

// ---- setup: the pool grouped by node ------------------------------------

// the node `node` (a run_node value) as a row of these node planes, or -1
// when it lies in another block; out-of-range nodes clamp into [0, NT) as
// in K7
__device__ __forceinline__ int vtt_node_row(const VttVictimArgs& a, int node) {
  const int nt = a.NT > 0 ? (int)a.NT : (int)a.N;
  const int n = vtt_clamp(node, 0, nt - 1) - (int)a.n0;
  return n >= 0 && n < a.N ? n : -1;
}

// eviction-order key kinds
enum { VTT_EV_RECLAIM = 0, VTT_EV_PREEMPT = 1, VTT_EV_ROUNDS = 2 };

// exclusive scan of cnt[0..n) into off[0..n]; one CTA (each thread's
// chunk sum, a Hillis-Steele block scan of the sums), then cnt := 0 (K10's
// pool by job; the groups by node are vtt_group_kernel's, below)
static __global__ void vtt_v_scan(int32_t* cnt, int32_t* off, int n) {
  __shared__ int s_part[VTT_VICTIM_THREADS];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int chunk = (n + nthr - 1) / nthr;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  s_part[tid] = sum;
  __syncthreads();
  for (int d = 1; d < nthr; d <<= 1) {
    const int x = tid >= d ? s_part[tid - d] : 0;
    __syncthreads();
    s_part[tid] += x;
    __syncthreads();
  }
  if (tid == nthr - 1) off[n] = s_part[tid];
  int acc = s_part[tid] - sum;
  for (int i = lo; i < hi; ++i) {
    off[i] = acc;
    acc += cnt[i];
    cnt[i] = 0;
  }
}

// ---- the victim core ----------------------------------------------------

// one preemptor attempt
struct VttAttempt {
  float req[VTT_MAX_R];
  int cls, jt, qt, t;
  int mode;  // 0 queue (same queue, other jobs), 1 job (own job), 2 reclaim
  float ls;  // DRF share of the preemptor's job with the request added
};

// rows of a node list whose loads the apply issues together
#define VTT_ROW_CHUNK 4

// the list positions [i0, i0 + VTT_ROW_CHUNK) of l[.., end) as pool rows;
// past the end the last row again (read, never written)
__device__ __forceinline__ void vtt_chunk_rows(const int32_t* l, int i0, int end, int* v) {
#pragma unroll
  for (int k = 0; k < VTT_ROW_CHUNK; ++k) v[k] = l[min(i0 + k, end - 1)];
}

__device__ __forceinline__ bool vtt_row_base(const VttVictimArgs& a,
                                             const VttAttempt& at, int v) {
  if (!a.run_live[v]) return false;
  const int j = a.run_job[v];
  const int rq = a.job_queue[j];
  if (at.mode == 0) return rq == at.qt && j != at.jt;
  if (at.mode == 1) return j == at.jt;
  return rq != at.qt;
}

// The flags of one node's rows for this attempt (base, the vetoes, the
// eviction-order prefix), from the node's lists [off, end): pool order,
// (job, row), (queue, row) and eviction order.  Returns the candidate count
// and their total in acc[] (float64, exact: whole-number requests).
static __device__ __forceinline__ int vtt_node_flags(const VttVictimArgs& a,
                                                     const VttAttempt& at, int off, int end,
                                                     const int32_t* l_vidx, const int32_t* l_drf,
                                                     const int32_t* l_prop, const int32_t* l_ev,
                                                     double* acc) {
  const int R = (int)a.R, Q = (int)a.Q;
  // base and the plain vetoes
  for (int i = off; i < end; ++i) {
    const int v = l_vidx[i];
    uint8_t f = 0;
    if (vtt_row_base(a, at, v)) {
      f = VF_BASE;
      bool c = true;
      if (a.use_conformance) c = c && a.run_evictable[v];
      if (a.use_gang) {
        const int j = a.run_job[v];
        const int vmin = a.job_min[j];
        c = c && (vmin <= a.job_occupied[j] - 1 || vmin == 1);
      }
      if (c) f |= VF_CAND;
    }
    a.flag[v] = f;
  }
  float part[VTT_MAX_R];
  if (a.use_drf) {
    // hypothetical transfer per (node, job): every base row subtracts
    int pj = -1;
    for (int i = off; i < end; ++i) {
      const int v = l_drf[i];
      const int j = a.run_job[v];
      if (j != pj) {
        for (int r = 0; r < R; ++r) acc[r] = 0.0;
        pj = j;
      }
      const uint8_t f = a.flag[v];
      if (f & VF_BASE)
        for (int r = 0; r < R; ++r) acc[r] += (double)a.run_req[(size_t)v * R + r];
      if (!(f & VF_CAND)) continue;
      for (int r = 0; r < R; ++r)
        part[r] = a.job_alloc[(size_t)j * R + r] - (float)acc[r];
      const float rs = vtt_dominant_share(part, a.total, R);
      if (!(at.ls < rs || fabsf(at.ls - rs) <= 1e-6f)) a.flag[v] = f & ~VF_CAND;
    }
  }
  if (a.use_prop) {
    // per (node, queue): queues stay at or above deserved
    int pq = -1;
    for (int i = off; i < end; ++i) {
      const int v = l_prop[i];
      const int rq = vtt_row_queue(a, v);
      const int q = vtt_clamp(rq, 0, Q - 1);
      if (q != pq) {
        for (int r = 0; r < R; ++r) acc[r] = 0.0;
        pq = q;
      }
      const uint8_t f = a.flag[v];
      if ((f & VF_BASE) && rq >= 0)
        for (int r = 0; r < R; ++r) acc[r] += (double)a.run_req[(size_t)v * R + r];
      if (!(f & VF_CAND)) continue;
      for (int r = 0; r < R; ++r)
        part[r] = a.queue_alloc[(size_t)q * R + r] - (float)acc[r];
      if (!(rq >= 0 && vtt_less_equal(&a.queue_deserved[(size_t)q * R], part, a.eps, R)))
        a.flag[v] = f & ~VF_CAND;
    }
  }
  // eviction-order prefix: the first candidate unconditionally (do-while),
  // then each candidate whose predecessors do not yet cover the request
  for (int r = 0; r < R; ++r) acc[r] = 0.0;
  int cnt = 0;
  for (int i = off; i < end; ++i) {
    const int v = l_ev[i];
    const uint8_t f = a.flag[v];
    if (!(f & VF_CAND)) continue;
    ++cnt;
    for (int r = 0; r < R; ++r) {
      const float q = a.run_req[(size_t)v * R + r];
      acc[r] += (double)q;
      part[r] = (float)acc[r] - q;
    }
    if (cnt == 1 || !vtt_less_equal(at.req, part, a.eps, R)) a.flag[v] = f | VF_INPRE;
  }
  return cnt;
}

// The flags of node n's rows and the node's verdict for this attempt:
// valid (predicates, an admitted candidate, validateVictims) and covered
// (the candidates' total covers the request); key is the walk key.
static __device__ __forceinline__ void vtt_core_node(const VttVictimArgs& a,
                                                     const VttAttempt& at, int n, bool& valid,
                                                     bool& covered, float& key) {
  const int N = (int)a.N, R = (int)a.R;
  valid = covered = false;
  key = 0.0f;
  const int off = a.node_off[n], end = a.node_off[n + 1];
  if (off == end || !a.node_valid[n] || !a.class_mask[(size_t)at.cls * N + n] ||
      !((long long)a.task_count[n] + 1 <= (long long)a.node_max_tasks[n]))
    return;
  double acc[VTT_MAX_R];
  if (vtt_node_flags(a, at, off, end, a.l_vidx, a.l_drf, a.l_prop, a.l_ev, acc) == 0) return;
  float part[VTT_MAX_R];
  bool all_below = true;
  for (int r = 0; r < R; ++r) {
    part[r] = (float)acc[r];
    all_below = all_below && part[r] < at.req[r];
  }
  valid = !all_below;
  covered = valid && vtt_less_equal(at.req, part, a.eps, R);
  if (!valid) return;
  if (at.mode == 2) {
    // reclaim walks the snapshot order: the global node row
    key = (float)(a.n0 + n);
  } else {
    key = -vtt_score_node(at.req, &a.used[(size_t)n * R], &a.node_alloc[(size_t)n * R],
                          a.class_score[(size_t)at.cls * N + n], a.w_least,
                          a.w_balanced);
  }
}

// (key, index) lexicographic minimum; idx < 0 marks an empty entry
__device__ __forceinline__ bool vtt_kmin_better(float ka, int ia, float kb, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  return ka < kb || (ka == kb && ia < ib);
}

// A CTA's or a warp's (key, node) minima over its covered and its valid
// nodes (node -1: none): one 16-byte word, so it can be pushed into another
// CTA's shared memory with vtt_cluster_store.
struct alignas(16) VttWalkRec {
  float kc;
  int ic;
  float kv;
  int iv;
};

__device__ __forceinline__ void vtt_rec_take(VttWalkRec& r, const VttWalkRec& o) {
  if (vtt_kmin_better(o.kc, o.ic, r.kc, r.ic)) {
    r.kc = o.kc;
    r.ic = o.ic;
  }
  if (vtt_kmin_better(o.kv, o.iv, r.kv, r.iv)) {
    r.kv = o.kv;
    r.iv = o.iv;
  }
}

// warp-wide minima by an xor butterfly (vtt_kmin_better is a total order
// on distinct nodes, so both lanes of a pair agree); every lane returns them
__device__ __forceinline__ void vtt_warp_rec_min(VttWalkRec& r) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    VttWalkRec o;
    o.kc = __shfl_xor_sync(0xffffffffu, r.kc, off);
    o.ic = __shfl_xor_sync(0xffffffffu, r.ic, off);
    o.kv = __shfl_xor_sync(0xffffffffu, r.kv, off);
    o.iv = __shfl_xor_sync(0xffffffffu, r.iv, off);
    vtt_rec_take(r, o);
  }
}

// nstar (-1 when no node is covered) and clean from merged minima, as the
// reference's walk defines them: the first covered node, and no valid node
// before it
__device__ __forceinline__ void vtt_rec_decide(const VttWalkRec& r, int& nstar, bool& clean) {
  nstar = r.ic;
  clean = r.ic >= 0 ? (r.kv == r.kc && r.iv == r.ic) : r.iv < 0;
}

// ---- state writes, optionally recorded in the undo journal -------------

// tag of a one-byte entry (device addresses stay below 2^63)
#define VTT_JR_BYTE (1ull << 63)

struct VttJournal {
  bool on;
  int len;
};

__device__ __forceinline__ void vtt_jpush(const VttVictimArgs& a, VttJournal& jr,
                                          void* p, uint32_t old, int bytes) {
  if (!jr.on) return;
  if (jr.len >= a.jr_cap) {
    a.ctl[VC_ERROR] = 1;
    return;
  }
  a.jr_addr[jr.len] = (unsigned long long)p | (bytes == 1 ? VTT_JR_BYTE : 0ull);
  a.jr_old[jr.len] = old;
  ++jr.len;
}

// *p := x, journalled with its old value `old`, which the caller loaded:
// an apply loads all the words it is about to write first, so the loads
// are in flight together rather than one after each journal store
__device__ __forceinline__ void vtt_wf(const VttVictimArgs& a, VttJournal& jr, float* p,
                                       float old, float x) {
  vtt_jpush(a, jr, p, __float_as_uint(old), 4);
  *p = x;
}

__device__ __forceinline__ void vtt_wi(const VttVictimArgs& a, VttJournal& jr, int32_t* p,
                                       int32_t old, int32_t x) {
  vtt_jpush(a, jr, p, (uint32_t)old, 4);
  *p = x;
}

__device__ __forceinline__ void vtt_wb(const VttVictimArgs& a, VttJournal& jr, uint8_t* p,
                                       uint8_t old, uint8_t x) {
  vtt_jpush(a, jr, p, (uint32_t)old, 1);
  *p = x;
}

// undo every journalled write, newest first
__device__ __forceinline__ void vtt_jrestore(const VttVictimArgs& a, VttJournal& jr) {
  for (int i = jr.len - 1; i >= 0; --i) {
    const unsigned long long p = a.jr_addr[i];
    if (p & VTT_JR_BYTE)
      *(uint8_t*)(p & ~VTT_JR_BYTE) = (uint8_t)a.jr_old[i];
    else
      *(uint32_t*)p = a.jr_old[i];
  }
  jr.len = 0;
}

// victims of one apply staged at a time (vtt_evict_prefix)
#define VTT_VICT_BATCH 16

// The in-prefix rows of l_ev[p, q) whose job (by_queue: whose queue) is
// key: their count, their requests added to s (when given).
static __device__ __forceinline__ int vtt_prefix_rows(const VttVictimArgs& a,
                                                      const int32_t* l_ev, int p, int q,
                                                      bool by_queue, int key, double* s) {
  const int R = (int)a.R;
  int n = 0;
  for (int i = p; i < q; ++i) {
    const int u = l_ev[i];
    if (!(a.flag[u] & VF_INPRE)) continue;
    const int j = a.run_job[u];
    if ((by_queue ? a.job_queue[j] : j) != key) continue;
    ++n;
    if (s)
      for (int r = 0; r < R; ++r) s[r] += (double)a.run_req[(size_t)u * R + r];
  }
  return n;
}

// Evict the in-prefix candidates of one node's eviction list l_ev[off,
// end) (one thread): the victims' per-job and per-queue sums, run_live and
// evict_att.  Returns the victim count and their total in vs[] (float64).
// One pass over the list stages the victims VTT_VICT_BATCH at a time
// (rows, jobs, queues, the old words of their rows), so a victim's
// first-of-its-job test and its job's sum read the staged victims, and the
// list again only where a job's victims span batches.  Each batch's writes
// go to distinct words, so their order in the journal does not change what
// a discard restores.
static __device__ __forceinline__ int vtt_evict_prefix(const VttVictimArgs& a,
                                                       const int32_t* l_ev, int off, int end,
                                                       VttJournal& jr, double* vs) {
  constexpr int CH = VTT_ROW_CHUNK, B = VTT_VICT_BATCH;
  const int R = (int)a.R, Q = (int)a.Q;
  const int att = a.ctl[VC_ATT];
  for (int r = 0; r < R; ++r) vs[r] = 0.0;
  int nv = 0;
  for (int p = off; p < end;) {
    const int p0 = p;
    int bv[B], bj[B], bq[B], bea[B];
    uint8_t blive[B];
    int nb = 0;
    while (p < end && nb < B) {
      int v[CH];
      uint8_t f[CH], live[CH];
      int32_t ea[CH];
      vtt_chunk_rows(l_ev, p, end, v);
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        f[k] = a.flag[v[k]];
        live[k] = a.run_live[v[k]];
        ea[k] = a.evict_att[v[k]];
      }
      int taken = 0;  // the chunk's entries scanned before the batch filled
#pragma unroll
      for (int k = 0; k < CH; ++k) {
        if (p + k >= end || nb == B) continue;
        taken = k + 1;
        if (!(f[k] & VF_INPRE)) continue;
        bv[nb] = v[k];
        blive[nb] = live[k];
        bea[nb] = ea[k];
        ++nb;
      }
      p += taken;
    }
    for (int b = 0; b < nb; ++b) bj[b] = a.run_job[bv[b]];
    for (int b = 0; b < nb; ++b) bq[b] = a.job_queue[bj[b]];
    for (int b = 0; b < nb; ++b)
      for (int r = 0; r < R; ++r) vs[r] += (double)a.run_req[(size_t)bv[b] * R + r];
    nv += nb;
    // per job and per queue of the victims: one rounded sum each, applied
    // at the job's / queue's first victim in eviction order
    for (int b = 0; b < nb; ++b) {
      const int j = bj[b], rq = bq[b];
      bool first_j = true, first_q = true;
      for (int c = 0; c < b; ++c) {
        first_j = first_j && bj[c] != j;
        first_q = first_q && bq[c] != rq;
      }
      first_j = first_j && vtt_prefix_rows(a, l_ev, off, p0, false, j, nullptr) == 0;
      first_q = first_q && vtt_prefix_rows(a, l_ev, off, p0, true, rq, nullptr) == 0;
      if (first_j) {
        double js[VTT_MAX_R];
        for (int r = 0; r < R; ++r) js[r] = 0.0;
        int jc = 0;
        for (int c = b; c < nb; ++c) {
          if (bj[c] != j) continue;
          ++jc;
          for (int r = 0; r < R; ++r) js[r] += (double)a.run_req[(size_t)bv[c] * R + r];
        }
        jc += vtt_prefix_rows(a, l_ev, p, end, false, j, js);
        float* ja = &a.job_alloc[(size_t)j * R];
        float o[VTT_MAX_R];
        for (int r = 0; r < R; ++r) o[r] = ja[r];
        const int oc = a.job_occupied[j];
        for (int r = 0; r < R; ++r) vtt_wf(a, jr, &ja[r], o[r], o[r] - (float)js[r]);
        vtt_wi(a, jr, &a.job_occupied[j], oc, oc - jc);
      }
      if (first_q && rq >= 0) {
        double qs[VTT_MAX_R];
        for (int r = 0; r < R; ++r) qs[r] = 0.0;
        for (int c = b; c < nb; ++c) {
          if (bq[c] != rq) continue;
          for (int r = 0; r < R; ++r) qs[r] += (double)a.run_req[(size_t)bv[c] * R + r];
        }
        vtt_prefix_rows(a, l_ev, p, end, true, rq, qs);
        float* qa = &a.queue_alloc[(size_t)vtt_clamp(rq, 0, Q - 1) * R];
        float o[VTT_MAX_R];
        for (int r = 0; r < R; ++r) o[r] = qa[r];
        for (int r = 0; r < R; ++r) vtt_wf(a, jr, &qa[r], o[r], o[r] - (float)qs[r]);
      }
    }
    // the batch's rows and records
    for (int b = 0; b < nb; ++b) {
      vtt_wb(a, jr, &a.run_live[bv[b]], blive[b], 0);
      vtt_wi(a, jr, &a.evict_att[bv[b]], bea[b], att);
    }
  }
  return nv;
}

// Apply an ok attempt on a node (one thread): evict the in-prefix
// candidates of its eviction list l_ev[off, end), pipeline the preemptor.
// rel / used / tc are the node's rows (null when another process owns the
// node: its rows are left to that process); n_glob is the node's row of
// the whole cluster.  Returns the victim count.
static __device__ __forceinline__ int vtt_apply_on(const VttVictimArgs& a,
                                                   const VttAttempt& at, const int32_t* l_ev,
                                                   int off, int end, float* rel, float* used,
                                                   int32_t* tc, int n_glob, VttJournal& jr) {
  const int R = (int)a.R, Q = (int)a.Q;
  const int att = a.ctl[VC_ATT];
  double vs[VTT_MAX_R];
  const int nv = vtt_evict_prefix(a, l_ev, off, end, jr, vs);
  // the preemptor's words, loaded together (after the victims' writes,
  // which may touch its job's and queue's rows)
  float* ja = &a.job_alloc[(size_t)at.jt * R];
  float* qa = at.qt >= 0 ? &a.queue_alloc[(size_t)min(at.qt, Q - 1) * R] : nullptr;
  float o_rel[VTT_MAX_R], o_used[VTT_MAX_R], o_ja[VTT_MAX_R], o_qa[VTT_MAX_R];
  for (int r = 0; r < R; ++r) {
    if (rel) {
      o_rel[r] = rel[r];
      o_used[r] = used[r];
    }
    o_ja[r] = ja[r];
    if (qa) o_qa[r] = qa[r];
  }
  const int o_tc = tc ? *tc : 0, o_pipe = a.pipe[at.jt];
  const int o_pn = a.pipe_node[at.t], o_pa = a.pipe_att[at.t];
  for (int r = 0; r < R; ++r) {
    if (rel) {
      vtt_wf(a, jr, &rel[r], o_rel[r], o_rel[r] + ((float)vs[r] - at.req[r]));
      vtt_wf(a, jr, &used[r], o_used[r], o_used[r] + at.req[r]);
    }
    vtt_wf(a, jr, &ja[r], o_ja[r], o_ja[r] + at.req[r]);
    if (qa) vtt_wf(a, jr, &qa[r], o_qa[r], o_qa[r] + at.req[r]);
  }
  if (tc) vtt_wi(a, jr, tc, o_tc, o_tc + 1);
  vtt_wi(a, jr, &a.pipe[at.jt], o_pipe, o_pipe + 1);
  vtt_wi(a, jr, &a.pipe_node[at.t], o_pn, n_glob);
  vtt_wi(a, jr, &a.pipe_att[at.t], o_pa, att);
  a.ctl[VC_ATT] = att + 1;
  return nv;
}

// Apply an ok attempt on node n of these planes (one thread).
static __device__ __forceinline__ int vtt_apply(const VttVictimArgs& a, const VttAttempt& at,
                                                int n, VttJournal& jr) {
  const size_t nr = (size_t)n * a.R;
  return vtt_apply_on(a, at, a.l_ev, a.node_off[n], a.node_off[n + 1], a.releasing + nr,
                      a.used + nr, a.task_count + n, (int)a.n0 + n, jr);
}

// the attempt's inputs for task t of job jt
__device__ __forceinline__ void vtt_attempt_init(const VttVictimArgs& a, VttAttempt& at,
                                                 int t, int jt, int mode) {
  const int R = (int)a.R;
  at.t = t;
  at.jt = jt;
  at.qt = a.job_queue[jt];
  at.mode = mode;
  at.cls = a.task_class[t];
  for (int r = 0; r < R; ++r) at.req[r] = a.task_req[(size_t)t * R + r];
  at.ls = 0.0f;
  // the preemptor's share feeds the drf veto, keyed on the flag alone in
  // any mode (victim_kernels.py:229)
  if (a.use_drf) {
    float sum[VTT_MAX_R];
    for (int r = 0; r < R; ++r) sum[r] = a.job_alloc[(size_t)jt * R + r] + at.req[r];
    at.ls = vtt_dominant_share(sum, a.total, R);
  }
}

// The timed walk's sums, kept by one thread: clock64 cycles by stage
// (VTT_TM_*: the advance with its job selects, the selects alone, the node
// scan, the reduce and record exchange, the cluster barriers, the apply
// with the walk's bookkeeping), attempts and job selects.  The wall
// (%globaltimer ns) and the total cycles scale the stages to time.
enum { VTT_TM_ADVANCE = 0, VTT_TM_SELECT, VTT_TM_SCAN, VTT_TM_REDUCE, VTT_TM_BARRIER,
       VTT_TM_APPLY, VTT_TM_STAGES };
struct VttWalkTm {
  long long st[VTT_TM_STAGES];
  long long attempts, selects;
  unsigned long long g0;
  long long k0;
};

__device__ __forceinline__ void vtt_tm_start(VttWalkTm& tm) {
  for (int i = 0; i < VTT_TM_STAGES; ++i) tm.st[i] = 0;
  tm.attempts = tm.selects = 0;
  tm.g0 = vtt_globaltimer();
  tm.k0 = clock64();
}

// the split buffer [32]: wall ns, cycles, the stages' cycles at 2..7,
// attempts, selects, and at 12 the cluster size, at 13 threads a CTA
__device__ __forceinline__ void vtt_tm_write(const VttWalkTm& tm, int64_t* s, int C) {
  s[0] = (int64_t)(vtt_globaltimer() - tm.g0);
  s[1] = clock64() - tm.k0;
  for (int i = 0; i < VTT_TM_STAGES; ++i) s[2 + i] = tm.st[i];
  s[8] = tm.attempts;
  s[9] = tm.selects;
  s[12] = C;
  s[13] = blockDim.x;
}

// ---- job selection: the session job order as a block-wide argmin -------

struct VttVJobKey {
  float k[3];
  int j;
};

__device__ __forceinline__ bool vtt_vkey_less(const VttVJobKey& x, const VttVJobKey& y,
                                              int nk) {
  if (x.j < 0) return false;
  if (y.j < 0) return true;
  for (int i = 0; i < nk; ++i) {
    if (x.k[i] < y.k[i]) return true;
    if (x.k[i] > y.k[i]) return false;
  }
  return x.j < y.j;
}

__device__ __forceinline__ float vtt_vjob_key(const VttVictimArgs& a, int code, int j) {
  if (code == VTT_KEY_PRIORITY) return -(float)a.job_prio[j];
  if (code == VTT_KEY_GANG) return a.job_occupied[j] >= a.job_min[j] ? 1.0f : 0.0f;
  return vtt_dominant_share(&a.job_alloc[(size_t)j * a.R], a.total, (int)a.R);
}

// best job among those with job_avail[j] and job_queue[j] == q, or -1;
// every thread returns it
static __device__ __forceinline__ int vtt_select_job(const VttVictimArgs& a, int q,
                                                    VttVJobKey* s_key) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nk = (int)a.n_keys;
  const int codes[3] = {(int)a.key0, (int)a.key1, (int)a.key2};
  VttVJobKey best;
  best.j = -1;
  for (int j = tid; j < a.J; j += nthr) {
    if (!a.job_avail[j] || a.job_queue[j] != q) continue;
    VttVJobKey kj;
    for (int i = 0; i < nk; ++i) kj.k[i] = vtt_vjob_key(a, codes[i], j);
    kj.j = j;
    if (vtt_vkey_less(kj, best, nk)) best = kj;
  }
  s_key[tid] = best;
  __syncthreads();
  for (int s = nthr / 2; s > 0; s >>= 1) {
    if (tid < s && vtt_vkey_less(s_key[tid + s], s_key[tid], nk)) s_key[tid] = s_key[tid + s];
    __syncthreads();
  }
  const int out = s_key[0].j;
  __syncthreads();
  return out;
}

// vtt_select_job, thread 0 adding its cycles and one select to *tm when
// given (the timed walk)
static __device__ __forceinline__ int vtt_select_job(const VttVictimArgs& a, int q,
                                                    VttVJobKey* s_key, VttWalkTm* tm) {
  const long long t0 = tm && threadIdx.x == 0 ? clock64() : 0;
  const int j = vtt_select_job(a, q, s_key);
  if (tm && threadIdx.x == 0) {
    tm->st[VTT_TM_SELECT] += clock64() - t0;
    tm->selects += 1;
  }
  return j;
}

// ---- K8 and K9 as walks, and their attempts on node blocks (K15a, K15b) --

// A walk's state between attempts: rank 0's shared memory in the cluster
// solves; global memory (the base's `walk`, replicated on every process) on
// node blocks, where each attempt is one launch of the blocks' cores, the
// exchange of their records, and one launch that applies the attempt and
// advances the walk to the next one.
struct VttWalk {
  int go, do_att, iters;
  int phase, qpos, cur, j2pos;                          // K9
  int assigned, last_v, any_p1, att_total, ck_att, qm;  // K9
  int t, jt;                                            // K9: the drained task
  int qstar, over, job;                                 // K8
  VttJournal jr;
  VttAttempt at;  // the attempt the last advance left
};

// a block's record of a core scan: kmin_cov bits, nstar_cov, kmin_val bits,
// nstar_val (global rows, -1 for none), any covered, any valid
#define VTT_VB_WORDS 6

// The minimum of the S blocks' records (one thread): nstar (-1 when no
// node is covered) and clean, exactly as the one-block walk defines them.
static __device__ void vtt_merge_records(const int32_t* recv, int S, int& nstar, bool& clean) {
  VttWalkRec m{0.0f, -1, 0.0f, -1};
  for (int b = 0; b < S; ++b) {
    const int32_t* r = recv + (size_t)b * VTT_VB_WORDS;
    vtt_rec_take(m, VttWalkRec{__int_as_float(r[0]), r[4] ? r[1] : -1, __int_as_float(r[2]),
                               r[5] ? r[3] : -1});
  }
  vtt_rec_decide(m, nstar, clean);
}

// The pending attempt w.at of a walk on node blocks, after the exchange
// filled a.recv with the S blocks' records (thread 0; `a` is the
// process's replicated base with the groups of the whole pool, `blocks`
// its local blocks in device memory).  The merge gives nstar and clean; an
// ok attempt reruns the flag pass of nstar's rows from the replicated pool
// and state (the node may lie on another process) and applies, journalled
// as the one-block apply, writing node rows only where a local block owns
// nstar.  Returns nstar, clean and the victims.
static __device__ void vtt_wb_apply(const VttVictimArgs& a, const VttVictimArgs* blocks,
                                    int L, VttWalk& w, int& nstar, bool& clean, int& nv) {
  vtt_merge_records(a.recv, (int)a.S, nstar, clean);
  nv = 0;
  if (nstar < 0 || !clean) return;
  const int off = a.node_off[nstar], end = a.node_off[nstar + 1];
  double acc[VTT_MAX_R];
  vtt_node_flags(a, w.at, off, end, a.l_vidx, a.l_drf, a.l_prop, a.l_ev, acc);
  float *rel = nullptr, *used = nullptr;
  int32_t* tc = nullptr;
  for (int b = 0; b < L; ++b) {
    const int n = nstar - (int)blocks[b].n0;
    if (n >= 0 && n < blocks[b].N) {
      rel = blocks[b].releasing + (size_t)n * a.R;
      used = blocks[b].used + (size_t)n * a.R;
      tc = blocks[b].task_count + n;
    }
  }
  nv = vtt_apply_on(a, w.at, a.l_ev, off, end, rel, used, tc, nstar, w.jr);
}

// the walk's pending flag on the host, once the stream has drained
static inline int vtt_walk_pending(const VttVictimArgs& a, int* pending, cudaStream_t s) {
  int err = (int)cudaMemcpyAsync(pending, a.ctl + VC_WALK, sizeof(int),
                                 cudaMemcpyDeviceToHost, s);
  if (!err) err = (int)cudaStreamSynchronize(s);
  return err ? err : (int)cudaGetLastError();
}

static inline bool vtt_walk_ok(const VttVictimArgs& a) {
  return a.R >= 2 && a.R <= VTT_MAX_R && a.n_keys <= 3 && a.S >= 1;
}

// ---- K8 and K9 on one thread-block cluster ------------------------------
//
// One launch of C CTAs (16, 8, 4, 2 or 1: the largest the card admits
// unless the caller names one) runs the whole walk.  CTA `rank` owns the
// whole nodes [vtt_walk_bound(rank), vtt_walk_bound(rank + 1)), balanced by
// pool rows, one node a thread.  An attempt:
//   1. rank 0 advances the state machine (its whole CTA, for the job
//      select) and pushes the attempt into every CTA's shared memory;
//   2. cluster barrier A: the attempt, and every global write rank 0 made
//      since the last one (the apply, the journal, cursor, job_avail,
//      queue_live), reach every CTA;
//   3. every CTA scans its nodes (vtt_core_node, flags in the global byte a
//      row), reduces them to its record with warp shuffles and pushes it
//      into rank 0's shared memory;
//   4. cluster barrier B: the records and the scans' flags reach rank 0;
//   5. rank 0 merges the records in rank order (vtt_rec_take: the minimum
//      does not depend on how the nodes were split), and its thread 0
//      applies an ok attempt (vtt_apply_on) and runs the walk's after-step.
// Only rank 0 decides; the others follow the `go` of the attempt it
// pushed, so every CTA crosses the same barriers.

#define VTT_WALK_MAX_CLUSTER 16

// the attempt rank 0 hands every CTA (whole 16-byte words)
struct alignas(16) VttWalkMsg {
  VttAttempt at;
  int go;
};

// The first node of CTA `rank`'s range among C: the lowest n whose rows
// start at or past rank / C of the grouped rows (node_off [N + 1]).  The
// ranges hold whole nodes; nodes without rows past the last node with
// rows fall in no range (they are never valid).
__device__ __forceinline__ int vtt_walk_bound(const VttVictimArgs& a, int rank, int C) {
  const long long want = ((long long)a.node_off[a.N] * rank + C - 1) / C;
  int lo = 0, hi = (int)a.N;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.node_off[mid] >= want)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The whole walk on one cluster (see above).  W: the walk's state machine,
// with static device functions init(w); advance(a, w, s_key, tm), all of
// rank 0's threads, true with w.at set or false when the walk ended;
// after(a, w, nstar, clean), one thread, which applies an ok attempt; and
// finish(a, w).  TM: the timed instantiation, rank 0's thread 0 summing the
// stages into a.x_split.
template <class W, bool TM>
static __device__ __forceinline__ void vtt_walk_cluster(const VttVictimArgs& a) {
  __shared__ VttWalkRec s_rec[VTT_WALK_MAX_CLUSTER];  // the CTAs' records (rank 0's)
  __shared__ VttWalkRec s_warp[VTT_VICTIM_THREADS / 32];
  __shared__ VttWalkMsg s_msg;
  __shared__ VttVJobKey s_key[VTT_VICTIM_THREADS];
  __shared__ VttWalk w;
  __shared__ VttWalkTm tm;
  __shared__ int s_range[2];
  // the node walk runs at the register cap (64 at 1024 threads), so the
  // CTA's rank, size and range are re-read where they are used rather than
  // held across it
  const bool tm0 = TM && vtt_cluster_rank() == 0 && threadIdx.x == 0;
  if (threadIdx.x == 0) {
    const int rank = vtt_cluster_rank(), C = vtt_cluster_size();
    s_range[0] = vtt_walk_bound(a, rank, C);
    s_range[1] = vtt_walk_bound(a, rank + 1, C);
    if (rank == 0) W::init(w);
  }
  if (tm0) vtt_tm_start(tm);
  __syncthreads();
  long long c0 = 0, c1 = 0;
  for (;;) {
    if (vtt_cluster_rank() == 0) {
      if (TM) c0 = clock64();
      const bool more = W::advance(a, w, s_key, TM ? &tm : nullptr);
      // thread c hands the attempt to CTA c
      if ((int)threadIdx.x < vtt_cluster_size())
        vtt_cluster_store(&s_msg, (int)threadIdx.x, VttWalkMsg{w.at, more ? 1 : 0});
      if (TM) c1 = clock64();
    }
    vtt_cluster_arrive();
    vtt_cluster_wait();
    const long long c2 = TM ? clock64() : 0;
    if (!s_msg.go) {
      if (tm0) {
        tm.st[VTT_TM_ADVANCE] += c1 - c0;
        tm.st[VTT_TM_BARRIER] += c2 - c1;
      }
      break;
    }
    VttWalkRec r{0.0f, -1, 0.0f, -1};
    for (int n = s_range[0] + threadIdx.x; n < s_range[1]; n += blockDim.x) {
      bool valid, covered;
      float key;
      vtt_core_node(a, s_msg.at, n, valid, covered, key);
      if (valid && vtt_kmin_better(key, n, r.kv, r.iv)) {
        r.kv = key;
        r.iv = n;
      }
      if (covered && vtt_kmin_better(key, n, r.kc, r.ic)) {
        r.kc = key;
        r.ic = n;
      }
    }
    vtt_warp_rec_min(r);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = r;
    __syncthreads();
    const long long c3 = TM ? clock64() : 0;
    if (threadIdx.x < 32) {
      VttWalkRec m = threadIdx.x < (blockDim.x >> 5) ? s_warp[threadIdx.x]
                                                     : VttWalkRec{0.0f, -1, 0.0f, -1};
      vtt_warp_rec_min(m);
      if (threadIdx.x == 0) vtt_cluster_store(&s_rec[vtt_cluster_rank()], 0, m);
    }
    const long long c4 = TM ? clock64() : 0;
    vtt_cluster_arrive();
    vtt_cluster_wait();
    if (vtt_cluster_rank() == 0) {
      if (threadIdx.x == 0) {
        const long long c5 = TM ? clock64() : 0;
        VttWalkRec m{0.0f, -1, 0.0f, -1};
        const int C = vtt_cluster_size();
        for (int c = 0; c < C; ++c) vtt_rec_take(m, s_rec[c]);
        int nstar;
        bool clean;
        vtt_rec_decide(m, nstar, clean);
        const long long c6 = TM ? clock64() : 0;
        W::after(a, w, nstar, clean);
        if (tm0) {
          tm.st[VTT_TM_ADVANCE] += c1 - c0;
          tm.st[VTT_TM_SCAN] += c3 - c2;
          tm.st[VTT_TM_REDUCE] += (c4 - c3) + (c6 - c5);
          tm.st[VTT_TM_BARRIER] += (c2 - c1) + (c5 - c4);
          tm.st[VTT_TM_APPLY] += clock64() - c6;
          tm.attempts += 1;
        }
      }
      __syncthreads();
    }
  }
  if (vtt_cluster_rank() == 0 && threadIdx.x == 0) W::finish(a, w);
  if (tm0) vtt_tm_write(tm, a.x_split, vtt_cluster_size());
}

// Launch one cluster of `kernel`: `want` names its size (0: the largest of
// 16, 8, 4, 2, 1 the card admits; a named size the card refuses is an
// error, never a smaller cluster).
static inline int vtt_cluster_launch(void (*kernel)(VttVictimArgs), const VttVictimArgs& a,
                                     int64_t want, cudaStream_t s) {
  if (want != 0 && want != 1 && want != 2 && want != 4 && want != 8 && want != 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int sizes[5] = {16, 8, 4, 2, 1};
  for (int k = 0; k < 5; ++k) {
    const int C = sizes[k];
    if (want && want != C) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(VTT_VICTIM_THREADS, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess || n_clusters < 1) {
      cudaGetLastError();  // a refused size is not an error of the stream
      if (want) return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
      continue;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  return (int)cudaErrorInvalidConfiguration;
}

// Launch one cluster of a walk kernel: a.cluster names its size.
static inline int vtt_walk_launch(void (*kernel)(VttVictimArgs), const VttVictimArgs& a,
                                  cudaStream_t s) {
  return vtt_cluster_launch(kernel, a, a.cluster, s);
}

// ---- the group build: the pool grouped by node, one launch ---------------
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:131-182 (`_orders_drf`,
// `_orders_prop`, `_orders_evict`): node_off [N + 1] and the four per-node
// lists l_vidx, l_ev, l_drf, l_prop of the rows of a.run_live (pool order,
// the eviction order of kind EV, (job, row), (queue, row)), -1 past the
// grouped rows.  The node planes are rows [n0, n0 + N) of NT: a row whose
// clamped node lies outside them is not grouped (a block's build, K10 /
// K15c).  K7g (victim_groups), and the setup of K8, K9, K10, K15a, K15b and
// K15c, once a solve.
//
// What bounds it on the H100: latency.  The bytes (the pool's five int32
// columns and the mask read once, the lists and offsets written once) take
// about 1.3 us at 3.35 TB/s at config 4; four launches of the count, a
// one-CTA scan over the nodes, the bucket and the rank took 0.094 ms.
// Design: one launch of one thread-block cluster (the largest the card
// admits: 16 CTAs x 1024 threads) in place of four launches; five cluster
// barriers stand where launches and a zeroed workspace stood:
//   0. the cluster zeroes the node counts (node_fill), so no build depends
//      on another's end;
//   1. every row of the mask adds one to its node's count (global
//      atomics; a thread takes four rows at a time, one load a column,
//      vtt_group_rows);
//   2. CTA r scans the counts of its nodes [r * nc, (r + 1) * nc) (a chunk
//      a thread, warp shuffles) and stores its total into every CTA's
//      shared memory; after the barrier each CTA knows its base and writes
//      its nodes' offsets (node_off) and next free slots (node_fill);
//   3. every row takes a slot of its node (a global atomic) and writes its
//      sort keys there (VttGroupKey: gathered once, so no comparison reads
//      through run_job -> job_queue); rows past the grouped ones write -1
//      into the lists;
//   4. a thread a bucket slot ranks its row among its node's slots by full
//      comparison under every order, four slots' keys loaded ahead: the
//      order in which the atomics filled a bucket cannot change a list.
// The counts in the CTAs' distributed shared memory instead, added to with
// remote atomics, and each CTA reading every row to count its own nodes'
// rows with local atomics, both ran slower on the H100 (PERF.md section 6).
// What is left is bound by the 16 SMs' scattered stores and loads: the
// keys' slots, the rank's reads of each node's keys.

// A grouped row's sort keys, gathered once into its bucket slot: the row,
// its node of these planes, its job, its job's queue clamped into [0, Q),
// its priority (0 when order_by_priority is off) and its rank.
struct alignas(16) VttGroupKey {
  int v, node, job, queue, prio, rank, pad0, pad1;
};

// u before w in their node's eviction order of kind EV
template <int EV>
__device__ __forceinline__ bool vtt_ev_less(const VttGroupKey& u, const VttGroupKey& w) {
  if (EV == VTT_EV_ROUNDS && u.queue != w.queue) return u.queue < w.queue;
  if (EV != VTT_EV_RECLAIM) {
    if (u.prio != w.prio) return u.prio < w.prio;
    const int ru = -u.rank, rw = -w.rank;
    if (ru != rw) return ru < rw;
  }
  return u.v < w.v;
}

__device__ __forceinline__ void vtt_cluster_sync() {
  vtt_cluster_arrive();
  vtt_cluster_wait();
}

// Four consecutive pool rows v .. v + 3: each one's node row (-1 when it is
// not in the mask or lies on another block's nodes) and, when a pass asks
// for them (KEYS), its job, priority and rank.
struct VttQuad {
  int n[4], job[4], prio[4], rank[4];
};

__device__ __forceinline__ void vtt_unpack4(const int4 x, int* out) {
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// f(v, quad) for the rows [0, V) of the pool four at a time over the
// cluster's threads: one 4-byte load of the mask and one 16-byte load of
// each column a quad needs, issued together, where the columns are aligned
// for it; row by row past the last whole quad or when they are not.
template <bool KEYS, class F>
__device__ __forceinline__ void vtt_group_rows(const VttVictimArgs& a, F f) {
  const int V = (int)a.V;
  const int gt = vtt_cluster_rank() * blockDim.x + threadIdx.x;
  const int gs = vtt_cluster_size() * blockDim.x;
  const bool vec = ((uintptr_t)a.run_live & 3) == 0 &&
                   (((uintptr_t)a.run_node | (uintptr_t)a.run_job | (uintptr_t)a.run_prio |
                     (uintptr_t)a.run_rank) & 15) == 0;
  const int v0 = vec ? V & ~3 : 0;
  for (int q = gt; q < v0 / 4; q += gs) {
    const uint32_t l4 = reinterpret_cast<const uint32_t*>(a.run_live)[q];
    int ns[4];
    VttQuad x;
    vtt_unpack4(reinterpret_cast<const int4*>(a.run_node)[q], ns);
    if (KEYS) {
      vtt_unpack4(reinterpret_cast<const int4*>(a.run_job)[q], x.job);
      vtt_unpack4(reinterpret_cast<const int4*>(a.run_prio)[q], x.prio);
      vtt_unpack4(reinterpret_cast<const int4*>(a.run_rank)[q], x.rank);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) x.n[j] = (l4 >> (8 * j)) & 0xffu ? vtt_node_row(a, ns[j]) : -1;
    f(4 * q, x);
  }
  for (int v = v0 + gt; v < V; v += gs) {
    VttQuad x;
    x.n[0] = a.run_live[v] ? vtt_node_row(a, a.run_node[v]) : -1;
    x.n[1] = x.n[2] = x.n[3] = -1;
    if (KEYS) {
      x.job[0] = a.run_job[v];
      x.prio[0] = a.run_prio[v];
      x.rank[0] = a.run_rank[v];
    }
    f(v, x);
  }
}

template <int EV>
static __global__ void __launch_bounds__(VTT_VICTIM_THREADS) vtt_group_kernel(VttVictimArgs a) {
  __shared__ int s_tot[VTT_WALK_MAX_CLUSTER];  // each CTA's grouped rows
  __shared__ int s_warp[VTT_VICTIM_THREADS / 32];
  const int tid = threadIdx.x, T = blockDim.x;
  const int rank = vtt_cluster_rank(), C = vtt_cluster_size();
  const int N = (int)a.N, V = (int)a.V;
  const int gt = rank * T + tid, gs = C * T;
  for (int n = gt; n < N; n += gs) a.node_fill[n] = 0;
  vtt_cluster_sync();
  vtt_group_rows<false>(a, [&](int, const VttQuad& x) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x.n[j] >= 0) atomicAdd(&a.node_fill[x.n[j]], 1);
  });
  vtt_cluster_sync();
  // CTA r's nodes [lo, lo + mine): a chunk of k a thread, the chunks' sums
  // scanned, the CTA's total into every CTA's shared memory
  const int nc = (N + C - 1) / C;
  const int lo = min(N, rank * nc), mine = min(N, lo + nc) - lo;
  const int k = (mine + T - 1) / T;
  const int c0 = lo + min(mine, tid * k), c1 = lo + min(mine, (tid + 1) * k);
  int sum = 0;
  for (int n = c0; n < c1; ++n) sum += a.node_fill[n];
  const int lane = tid & 31, wid = tid >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) s_warp[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int w = lane < (T >> 5) ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += x;
    }
    if (lane < (T >> 5)) s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int excl = (wid ? s_warp[wid - 1] : 0) + incl - sum;
  if (tid < C) vtt_cluster_store_u32(&s_tot[rank], tid, s_warp[(T >> 5) - 1]);
  vtt_cluster_sync();
  int base = 0, total = 0;
  for (int r = 0; r < C; ++r) {
    base += r < rank ? s_tot[r] : 0;
    total += s_tot[r];
  }
  int off = base + excl;
  for (int n = c0; n < c1; ++n) {
    const int cnt = a.node_fill[n];
    a.node_off[n] = off;
    a.node_fill[n] = off;
    off += cnt;
  }
  if (rank == 0 && tid == 0) a.node_off[N] = total;
  vtt_cluster_sync();
  VttGroupKey* keys = reinterpret_cast<VttGroupKey*>(a.bucket);
  const int Q = (int)a.Q;
  vtt_group_rows<true>(a, [&](int v, const VttQuad& x) {
    int slot[4], queue[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the quad's atomics and gathers together
      if (x.n[j] < 0) continue;
      slot[j] = atomicAdd(&a.node_fill[x.n[j]], 1);
      queue[j] = a.job_queue[x.job[j]];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (x.n[j] < 0) continue;
      VttGroupKey key;
      key.v = v + j;
      key.node = x.n[j];
      key.job = x.job[j];
      key.queue = vtt_clamp(queue[j], 0, Q - 1);
      key.prio = a.order_by_priority ? x.prio[j] : 0;
      key.rank = x.rank[j];
      key.pad0 = key.pad1 = 0;
      keys[slot[j]] = key;
    }
  });
  for (int v = total + gt; v < V; v += gs)
    a.l_vidx[v] = a.l_ev[v] = a.l_drf[v] = a.l_prop[v] = -1;
  vtt_cluster_sync();
  // a thread a bucket slot: a warp's threads mostly share a node, so they
  // read the same keys, four slots' keys loaded ahead of their compares
  for (int p = gt; p < total; p += gs) {
    const VttGroupKey key = keys[p];
    const int off = a.node_off[key.node], end = a.node_off[key.node + 1];
    int p_vidx = 0, p_ev = 0, p_drf = 0, p_prop = 0;
    for (int i = off; i < end; i += 4) {
      VttGroupKey u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < end) u[j] = keys[i + j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j >= end || i + j == p) continue;
        p_vidx += u[j].v < key.v;
        p_ev += vtt_ev_less<EV>(u[j], key);
        p_drf += u[j].job < key.job || (u[j].job == key.job && u[j].v < key.v);
        p_prop += u[j].queue < key.queue || (u[j].queue == key.queue && u[j].v < key.v);
      }
    }
    a.l_vidx[off + p_vidx] = key.v;
    a.l_ev[off + p_ev] = key.v;
    a.l_drf[off + p_drf] = key.v;
    a.l_prop[off + p_prop] = key.v;
  }
}

// Launch the group build of a.run_live over a's node planes with eviction
// order ev_kind; the cluster size is the largest the card admits.
static inline int vtt_group_launch(const VttVictimArgs& a, int ev_kind, cudaStream_t s) {
  if (a.V < 1 || a.N < 1 || !a.run_live || !a.node_fill || ev_kind < 0 || ev_kind > 2)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(VttVictimArgs) = ev_kind == VTT_EV_RECLAIM   ? vtt_group_kernel<VTT_EV_RECLAIM>
                                  : ev_kind == VTT_EV_PREEMPT ? vtt_group_kernel<VTT_EV_PREEMPT>
                                                              : vtt_group_kernel<VTT_EV_ROUNDS>;
  return vtt_cluster_launch(kernel, a, 0, s);
}

// each local block's pool grouped by node, once a solve
static inline int vtt_blocks_setup(const VttVictimArgs* blocks, int L, int ev_kind,
                                   cudaStream_t s) {
  for (int b = 0; b < L; ++b) {
    const int err = vtt_group_launch(blocks[b], ev_kind, s);
    if (err) return err;
  }
  return 0;
}
