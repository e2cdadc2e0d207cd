// K2: the exact sequential allocate solve on ONE thread-block cluster.
//
// Replaces volcano_tpu/scheduler/kernels.py:185 `allocate_solve` (with
// portsel=None, volsel=None) — a jitted lax.while_loop whose body is either
// a select step (queue by proportion share, overuse drop, job by the
// lexicographic tier key; `select_step`, :256-296) or a place step (head-
// task fit, predicates, score, first-max argmax, state update;
// `place_step`, :298-462).
//
// What bounds it on the H100: latency, not bytes or operations.  Each step
// depends on the one before it, so the solve is a chain of about T + J
// steps, and a step's time is its critical path: reading the head task,
// scanning the nodes, reducing to one winner and applying it.  Design: one
// launch of C CTAs (a cluster of 16, 8, 4, 2 or 1, the largest the card
// admits unless the caller names one), each owning a slice of ns node rows
// (32-row chunks dealt round-robin, so that the valid rows of a padded
// bucket spread evenly), a thread owning the slice's rows tid, tid + NT, ...
//
// * The node state (idle, releasing, used, allocatable, pod count and cap,
//   the class row of the current class; K5's port and match words; K6's
//   capacity columns) is read once into shared memory, structure of
//   arrays, and written back once at the end: a step reads no L2 for it.
//   A slice larger than the shared memory keeps its remainder in the
//   working copies in global memory, in the same loop (any N runs).
// * A place step reduces its slice to a first-max (value, node) with warp
//   shuffles and one pass over the warps' results, pushes the CTA's record
//   into every CTA's shared memory (distributed shared memory stores,
//   double-buffered by exchange parity) and crosses ONE cluster barrier;
//   every thread then reads the C records from its own shared memory and
//   takes the same winner (first max, lowest node: independent of C).  The
//   owner thread of the winning node applies its update, as the reference
//   orders it; no second barrier is needed.
// * The scalar state (the current job, its cursor and ready count) is kept
//   identically by every thread, each applying the same update from the
//   same winner.  A job's mutable state (cursor, ready, dropped, its
//   allocation) belongs to one thread of the cluster (job j: thread
//   (j / C) mod NT of CTA j mod C), which alone reads and writes it, in its
//   CTA's shared memory with the job's static fields when the CTA's jobs
//   fit; each CTA keeps its own copy of the queue state (allocation,
//   deserved, active-job count, dropped), a queue's updates belonging to
//   thread q mod NT, updated identically everywhere.
// * A select step takes the queue in every warp alike (a lane a queue, a
//   warp reduction: no exchange), drops an overused queue and repeats, then
//   takes the job over the cluster's threads with the same record exchange
//   as a place step, with `vtt_key_less` unchanged.
// * The next head task of a job that stays current is read a step ahead.
//
// Float operations are the reference's, one for one (vtt_score_node,
// __fmaf_rn where XLA fuses, --fmad=false), in the same order: the outputs
// equal the plain version's bit for bit at every cluster size.
//
// K5 in K2 (PS): replaces the portsel branches of the same function,
// kernels.py:308-322 (port, required- and anti-selector feasibility),
// :356-361 (the interpod score term) and :398-405 (the placed pod's ports
// and labels join its node).  The inputs stay packed u32 words: each
// node's test is four port-word ANDs and two ANDs against its "selector
// matched" words, both resident beside the node state; the score reads the
// node's counts of the task's own selector bits from global memory
// (node_selcnt, 256 bytes a node, touched only by the node's owner thread).
//
// K6 in K2 (VS): replaces the volsel branches, kernels.py:323-342 (the
// task's feasible-node bitset, and per claim the assumed node or the
// group's remaining capacity), :406-423 (the first idle-fit placement of
// each claim assumes a volume there and takes one PV off its group's
// count: the whole row for a global pool, the taken node's column for a
// pinned one; a pipelined placement assumes nothing) and the initial state
// at :455-462.  Thread 0 of each CTA lists the task's claims (at most 64)
// in shared memory from the CTA's copy of the claims' nodes; the capacity
// columns of the slice are resident, and each node owner folds a global
// pool's decrement into its own nodes.
//
// A third template flag (TM) compiles in %globaltimer and clock64 reads
// kept by rank 0's thread 0, written to x_split: the stages of a step (the
// class-row read, scan, reduce, cluster barrier, apply; a select step
// whole) and the step counts.  The main path's instantiations compile none
// of it.
#include "common.cuh"

#ifndef VTT_EXACT_THREADS
#define VTT_EXACT_THREADS 512
#endif
#define VTT_EXACT_WARPS (VTT_EXACT_THREADS / 32)
#define VTT_EXACT_MAX_CLUSTER 16
// the queue state (allocation, deserved, count, dropped: Q * (2R + 2)
// words) stays in each CTA's shared memory up to this many bytes
#define VTT_EXACT_QSMEM 16384
// so does the state of a CTA's jobs ((8 + R) words a job)
#define VTT_EXACT_JSMEM 32768
__host__ __device__ inline size_t vtt_exact_job_bytes(int R) { return (size_t)(7 + R) * 4 + 1; }

// A select step's candidate: the job's keys (job_key_order), its index
// (-1: none) and what the place steps need of it.
struct alignas(16) VttJobRec {
  float k[3];
  int j;
  int start, ntasks, min, cursor, ready;
  int pad[3];  // whole 16-byte words: read by other CTAs with vector loads
};

__device__ __forceinline__ bool vtt_key_less(const VttJobRec& a, const VttJobRec& b, int nk) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (i < nk) {
      if (a.k[i] < b.k[i]) return true;
      if (a.k[i] > b.k[i]) return false;
    }
  }
  return a.j < b.j;
}

// a beats b in the job argmin (either may be none)
__device__ __forceinline__ bool vtt_job_better(const VttJobRec& a, const VttJobRec& b, int nk) {
  return a.j >= 0 && (b.j < 0 || vtt_key_less(a, b, nk));
}

__device__ __forceinline__ void vtt_warp_job_min(VttJobRec& r, int nk) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    VttJobRec o;
#pragma unroll
    for (int i = 0; i < 3; ++i) o.k[i] = __shfl_xor_sync(0xffffffffu, r.k[i], off);
    o.j = __shfl_xor_sync(0xffffffffu, r.j, off);
    o.start = __shfl_xor_sync(0xffffffffu, r.start, off);
    o.ntasks = __shfl_xor_sync(0xffffffffu, r.ntasks, off);
    o.min = __shfl_xor_sync(0xffffffffu, r.min, off);
    o.cursor = __shfl_xor_sync(0xffffffffu, r.cursor, off);
    o.ready = __shfl_xor_sync(0xffffffffu, r.ready, off);
    if (vtt_job_better(o, r, nk)) r = o;
  }
}

// The fixed part of a CTA's shared memory.
struct VttExactHdr {
  // every CTA's place and select records, pushed here by their CTAs, by
  // exchange parity
  VttArgRec nrec[2][VTT_EXACT_MAX_CLUSTER];
  VttJobRec jrec[2][VTT_EXACT_MAX_CLUSTER];
  VttArg warps[VTT_EXACT_WARPS];      // place reduction: a slot a warp
  VttJobRec jwarps[VTT_EXACT_WARPS];  // job reduction
  int claim_node[VTT_CLAIMS];         // K6: the CTA's copy of the claims' nodes
  VttVsTask vs[2];                    // K6: the task's claims, by exchange parity
  long long tm[16];                   // the timed solve's sums (rank 0, thread 0)
};

// Byte offsets of the rest: the state of the CTA's JL jobs (when it fits;
// JL = 0 otherwise), the queue state (when it fits), then the resident node
// rows, NR of them, structure of arrays.
struct VttExactLayout {
  size_t jcur, jrdy, jdrop, jq, jnt, jst, jmin, jprio, jalloc;
  size_t qalloc, qdes, qcnt, qdrop;
  size_t idle, rel, used, alloc, cscore, cnt, mx, ports, match, vcap, cmask;
  size_t total;
};

__host__ __device__ inline size_t vtt_al16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline VttExactLayout vtt_exact_layout(int R, int Q, bool qsmem, int JL,
                                                           int NR, bool ps, bool vs, int G) {
  VttExactLayout L;
  size_t o = vtt_al16(sizeof(VttExactHdr));
  const size_t nr = (size_t)NR, jl = (size_t)JL;
#define VTT_TAKE(field, bytes) \
  L.field = o;                 \
  o = vtt_al16(o + (bytes))
  VTT_TAKE(jcur, jl * 4);
  VTT_TAKE(jrdy, jl * 4);
  VTT_TAKE(jdrop, jl);
  VTT_TAKE(jq, jl * 4);
  VTT_TAKE(jnt, jl * 4);
  VTT_TAKE(jst, jl * 4);
  VTT_TAKE(jmin, jl * 4);
  VTT_TAKE(jprio, jl * 4);
  VTT_TAKE(jalloc, jl * R * 4);
  VTT_TAKE(qalloc, qsmem ? (size_t)Q * R * 4 : 0);
  VTT_TAKE(qdes, qsmem ? (size_t)Q * R * 4 : 0);
  VTT_TAKE(qcnt, qsmem ? (size_t)Q * 4 : 0);
  VTT_TAKE(qdrop, qsmem ? (size_t)Q * 4 : 0);
  VTT_TAKE(idle, nr * R * 4);
  VTT_TAKE(rel, nr * R * 4);
  VTT_TAKE(used, nr * R * 4);
  VTT_TAKE(alloc, nr * R * 4);
  VTT_TAKE(cscore, nr * 4);
  VTT_TAKE(cnt, nr * 4);
  VTT_TAKE(mx, nr * 4);
  VTT_TAKE(ports, ps ? nr * VTT_PW * 4 : 0);
  VTT_TAKE(match, ps ? nr * VTT_SW * 4 : 0);
  VTT_TAKE(vcap, vs ? (size_t)G * nr * 4 : 0);
  VTT_TAKE(cmask, nr);
#undef VTT_TAKE
  L.total = o;
  return L;
}

// One head task's words: request, class and (K5) its packed port and
// selector words, loaded together (a step ahead where possible).
struct VttTaskW {
  float req[VTT_MAX_R];
  int cls;
  uint32_t port[VTT_PW], aff[VTT_SW], anti[VTT_SW], self_[VTT_SW];
};

template <bool PS>
__device__ __forceinline__ void vtt_load_task(const VttSolveArgs& a, int t, int R, VttTaskW& w) {
#pragma unroll
  for (int r = 0; r < VTT_MAX_R; ++r) w.req[r] = r < R ? a.task_req[(size_t)t * R + r] : 0.0f;
  w.cls = a.task_class[t];
  if (PS) {
#pragma unroll
    for (int i = 0; i < VTT_PW; ++i) w.port[i] = (uint32_t)a.task_ports[(size_t)t * VTT_PW + i];
#pragma unroll
    for (int i = 0; i < VTT_SW; ++i) {
      w.aff[i] = (uint32_t)a.task_aff[(size_t)t * VTT_SW + i];
      w.anti[i] = (uint32_t)a.task_anti[(size_t)t * VTT_SW + i];
      w.self_[i] = (uint32_t)a.task_self[(size_t)t * VTT_SW + i];
    }
  }
}

__device__ __forceinline__ VttPs vtt_ps_of(const VttTaskW& w) {
  VttPs p;
  uint32_t ports = 0, sel = 0;
#pragma unroll
  for (int i = 0; i < VTT_PW; ++i) {
    p.port[i] = w.port[i];
    ports |= w.port[i];
  }
#pragma unroll
  for (int i = 0; i < VTT_SW; ++i) {
    p.aff[i] = w.aff[i];
    p.anti[i] = w.anti[i];
    p.self_[i] = w.self_[i];
    sel |= w.aff[i] | w.anti[i];
  }
  p.any_port = ports != 0;
  p.any_sel = sel != 0;
  return p;
}

// What a step needs: the arguments, the CTA's resident rows and the task.
struct VttExactCtx {
  const VttSolveArgs* a;
  float *idle, *rel, *used;
  const float *alloc, *cscore;
  int* cnt;
  const int* mx;
  uint32_t *ports, *match;
  int* vcap;
  uint8_t* cmask;
  int NR, N, R;
  float eps[VTT_MAX_R];
};

// Node n (slice row li) for the current task: fits, predicates and score;
// keeps the first max in (bv, bc), bc = 2 n + (idle fit).  RES: the row is
// resident in shared memory, and the test runs without branches (the
// loads and the score of a thread's rows overlap), else it lives in the
// working copies and each test returns early.
template <bool PS, bool VS, bool RES>
__device__ __forceinline__ void vtt_exact_eval(const VttExactCtx& x, int li, int n,
                                               const VttTaskW& tw, const VttPs& ps,
                                               const VttVsTask& vs, uint32_t vmask_w,
                                               const uint8_t* gmask, const float* gscore,
                                               float& bv, int& bc) {
  const VttSolveArgs& a = *x.a;
  const int R = x.R, NR = x.NR;
  bool ok;
  if (RES) {
    ok = (x.cmask[li] != 0) & (x.cnt[li] < x.mx[li]);
  } else {
    ok = a.node_valid[n] && gmask[n] && a.task_count[n] < a.node_max_tasks[n];
    if (!ok) return;
  }
  bool fit_i = true, fit_r = true;
#pragma unroll
  for (int r = 0; r < VTT_MAX_R; ++r) {
    if (r < R) {
      const float iv = RES ? x.idle[r * NR + li] : a.idle[(size_t)n * R + r];
      const float rv = RES ? x.rel[r * NR + li] : a.releasing[(size_t)n * R + r];
      fit_i = fit_i & (tw.req[r] < iv + x.eps[r]);
      fit_r = fit_r & (tw.req[r] < rv + x.eps[r]);
    }
  }
  if (!RES && !fit_i && !fit_r) return;
  bool feas = ok & (fit_i | fit_r);
  if (PS) {
    if (ps.any_port) {
#pragma unroll
      for (int w = 0; w < VTT_PW; ++w) {
        const uint32_t nw =
            RES ? x.ports[w * NR + li] : (uint32_t)a.node_ports[(size_t)n * VTT_PW + w];
        feas = feas & ((nw & ps.port[w]) == 0);
      }
    }
    if (ps.any_sel) {
#pragma unroll
      for (int w = 0; w < VTT_SW; ++w) {
        const uint32_t mw =
            RES ? x.match[w * NR + li] : (uint32_t)a.node_match[(size_t)n * VTT_SW + w];
        feas = feas & ((ps.aff[w] & ~mw) == 0) & ((ps.anti[w] & mw) == 0);
      }
    }
  }
  if (VS && (!feas || !vtt_vs_feasible(vmask_w, n, vs, [&](int g) {
               return RES ? x.vcap[g * NR + li] : a.vol_cap[(size_t)g * x.N + n];
             })))
    return;
  float used2[2], cap2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    used2[r] = RES ? x.used[r * NR + li] : a.used[(size_t)n * R + r];
    cap2[r] = RES ? x.alloc[r * NR + li] : a.node_alloc[(size_t)n * R + r];
  }
  float sc = vtt_score_node(tw.req, used2, cap2, RES ? x.cscore[li] : gscore[n], a.w_least,
                            a.w_balanced);
  if (!feas) return;
  if (PS) sc = vtt_ps_score(a, n, ps, sc);
  const int code = 2 * n + (fit_i ? 1 : 0);
  if (vtt_better(sc, code, bv, bc)) {
    bv = sc;
    bc = code;
  }
}

// The owner thread of node n (slice row li) places the task there: idle or
// releasing, used and the pod count (K2's order of operations); K5's ports
// and selector counts; K6's pinned decrements of the fresh claims.
template <bool PS, bool VS, bool RES>
__device__ __forceinline__ void vtt_exact_place(const VttExactCtx& x, int li, int n,
                                                const VttTaskW& tw, const VttPs& ps,
                                                const VttVsTask& vs, bool use_idle) {
  const VttSolveArgs& a = *x.a;
  const int R = x.R, NR = x.NR;
#pragma unroll
  for (int r = 0; r < VTT_MAX_R; ++r) {
    if (r < R) {
      float* nid = RES ? &x.idle[r * NR + li] : &a.idle[(size_t)n * R + r];
      float* nrel = RES ? &x.rel[r * NR + li] : &a.releasing[(size_t)n * R + r];
      float* nu = RES ? &x.used[r * NR + li] : &a.used[(size_t)n * R + r];
      if (use_idle)
        *nid = *nid - tw.req[r];
      else
        *nrel = *nrel - tw.req[r];
      *nu = *nu + tw.req[r];
    }
  }
  if (RES)
    x.cnt[li] += 1;
  else
    a.task_count[n] += 1;
  if (PS) {
    // the placed pod is resident now, pipelined or not
#pragma unroll
    for (int w = 0; w < VTT_PW; ++w) {
      if (RES)
        x.ports[w * NR + li] |= ps.port[w];
      else
        a.node_ports[(size_t)n * VTT_PW + w] =
            (int32_t)((uint32_t)a.node_ports[(size_t)n * VTT_PW + w] | ps.port[w]);
    }
    int32_t* cnt = a.node_selcnt + (size_t)n * VTT_S;
#pragma unroll
    for (int w = 0; w < VTT_SW; ++w) {
      uint32_t mw = RES ? x.match[w * NR + li] : (uint32_t)a.node_match[(size_t)n * VTT_SW + w];
      for (uint32_t b = ps.self_[w]; b; b &= b - 1) {
        const int bit = __ffs(b) - 1;
        const int c = cnt[w * 32 + bit] + 1;
        cnt[w * 32 + bit] = c;
        mw = c > 0 ? (mw | (1u << bit)) : (mw & ~(1u << bit));
      }
      if (RES)
        x.match[w * NR + li] = mw;
      else
        a.node_match[(size_t)n * VTT_SW + w] = (int32_t)mw;
    }
  }
  if (VS && use_idle) {
    // the claims' first allocation assumes a volume here: a pinned pool's
    // count drops at n, one per claim
    for (int i = 0; i < vs.n; ++i) {
      if (vs.node[i] >= 0 || vs.glob[i]) continue;
      if (RES)
        x.vcap[vs.g[i] * NR + li] -= 1;
      else
        a.vol_cap[(size_t)vs.g[i] * x.N + n] -= 1;
    }
  }
}

template <bool PS, bool VS, bool TM>
__global__ void __launch_bounds__(VTT_EXACT_THREADS, 1)
    vtt_allocate_solve_kernel(VttSolveArgs a) {
  VTT_DYN_SMEM(unsigned char, smem);
  VttExactHdr& h = *reinterpret_cast<VttExactHdr*>(smem);
  constexpr int NT = VTT_EXACT_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = vtt_cluster_rank(), C = vtt_cluster_size();
  const int N = (int)a.N, R = (int)a.R, T = (int)a.T, J = (int)a.J, Q = (int)a.Q;
  const int ns = (int)a.x_ns, NR = (int)a.x_nres, G = (int)a.G;
  // slice row li holds node ((li / 32) * C + rank) * 32 + li % 32: 32-row
  // chunks dealt round-robin, so that the CTAs share the valid rows of a
  // padded bucket evenly and a warp reads 32 consecutive nodes
  auto node_of = [&](int li) { return (((li >> 5) * C + rank) << 5) | (li & 31); };
  // the CTA's rows that hold a node: its chunks, the last one of the
  // N / 32 cut short
  const int n_chunks = (N + 31) >> 5;
  const int own = rank < n_chunks ? (n_chunks - 1 - rank) / C + 1 : 0;
  int nmine = own << 5;
  if (own && rank + (own - 1) * C == n_chunks - 1 && (N & 31)) nmine -= 32 - (N & 31);
  const int nres = min(nmine, NR);
  const int JL = (int)a.x_jl;
  const VttExactLayout L = vtt_exact_layout(R, Q, a.x_qsmem != 0, JL, NR, PS, VS, G);
  // job j belongs to thread (j / C) % NT of CTA j % C, which alone reads
  // and writes its mutable state: in this CTA's shared memory at row j / C
  // when the CTA's JL rows fit, else in the working copies at row j
  int* s_jq = reinterpret_cast<int*>(smem + L.jq);
  int* s_jnt = reinterpret_cast<int*>(smem + L.jnt);
  int* s_jst = reinterpret_cast<int*>(smem + L.jst);
  int* s_jmin = reinterpret_cast<int*>(smem + L.jmin);
  int* s_jprio = reinterpret_cast<int*>(smem + L.jprio);
  int* jcur = JL ? reinterpret_cast<int*>(smem + L.jcur) : a.cursor;
  int* jrdy = JL ? reinterpret_cast<int*>(smem + L.jrdy) : a.packed + 3 * T;
  uint8_t* jdrop = JL ? smem + L.jdrop : a.dropped;
  float* jalloc = JL ? reinterpret_cast<float*>(smem + L.jalloc) : a.job_alloc;
  const int* jnt = JL ? s_jnt : a.job_ntasks;
  const int* jst = JL ? s_jst : a.job_start;
  const int* jmin = JL ? s_jmin : a.job_min;
  const int* jprio = JL ? s_jprio : a.job_prio;
  auto jx = [&](int j) { return JL ? j / C : j; };
  auto ax = [&](int j, int r) { return JL ? r * JL + j / C : j * R + r; };
  float* qalloc;
  const float* qdes;
  int* qcnt;
  int* qdrop;
  if (a.x_qsmem) {
    qalloc = reinterpret_cast<float*>(smem + L.qalloc);
    qdes = reinterpret_cast<float*>(smem + L.qdes);
    qcnt = reinterpret_cast<int*>(smem + L.qcnt);
    qdrop = reinterpret_cast<int*>(smem + L.qdrop);
  } else {
    int32_t* g = a.x_qstate + (size_t)rank * Q * (R + 2);
    qalloc = reinterpret_cast<float*>(g);
    qdes = a.queue_deserved;
    qcnt = g + (size_t)Q * R;
    qdrop = qcnt + Q;
  }
  VttExactCtx x;
  x.a = &a;
  x.idle = reinterpret_cast<float*>(smem + L.idle);
  x.rel = reinterpret_cast<float*>(smem + L.rel);
  x.used = reinterpret_cast<float*>(smem + L.used);
  x.alloc = reinterpret_cast<float*>(smem + L.alloc);
  x.cscore = reinterpret_cast<float*>(smem + L.cscore);
  x.cnt = reinterpret_cast<int*>(smem + L.cnt);
  x.mx = reinterpret_cast<int*>(smem + L.mx);
  x.ports = reinterpret_cast<uint32_t*>(smem + L.ports);
  x.match = reinterpret_cast<uint32_t*>(smem + L.match);
  x.vcap = reinterpret_cast<int*>(smem + L.vcap);
  x.cmask = smem + L.cmask;
  x.NR = NR;
  x.N = N;
  x.R = R;
#pragma unroll
  for (int r = 0; r < VTT_MAX_R; ++r) x.eps[r] = r < R ? a.eps[r] : 0.0f;
  float* s_alloc = reinterpret_cast<float*>(smem + L.alloc);
  float* s_cscore = reinterpret_cast<float*>(smem + L.cscore);
  int* s_mx = reinterpret_cast<int*>(smem + L.mx);
  int32_t* task_node = a.packed;
  int32_t* task_kind = a.packed + T;
  int32_t* task_seq = a.packed + 2 * T;
  int32_t* ready = a.packed + 3 * T;
  const int codes[3] = {(int)a.key0, (int)a.key1, (int)a.key2};
  const int nk = (int)a.n_keys;
  const int span = C * NT;
  // the select step's tier keys of job j (its state at row i), as
  // kernels.py:_job_keys computes them
  auto job_key = [&](int code, int j, int i) -> float {
    if (code == VTT_KEY_PRIORITY) return -(float)jprio[i];
    if (code == VTT_KEY_GANG) return jrdy[i] >= jmin[i] ? 1.0f : 0.0f;
    float sh = VTT_NEG_INF;
#pragma unroll
    for (int r = 0; r < VTT_MAX_R; ++r)
      if (r < R) sh = fmaxf(sh, vtt_safe_share(jalloc[ax(j, r)], __ldg(&a.total[r])));
    return sh;
  };

  // the timed solve's sums, kept by rank 0's thread 0: stage cycles
  // (0-4 a place step's, 5 select steps whole, 6-10 a select step's
  // parts), place steps, select steps, queue drops, and a sink that makes
  // the class-row stage wait for the task's words
  long long* tm = h.tm;
  const bool tm0 = TM && rank == 0 && tid == 0;
  enum { TM_PLACE = 11, TM_SELECT = 12, TM_QDROP = 13, TM_SINK = 14 };
  long long k_start = 0;
  unsigned long long g_start = 0;
  if (tm0) {
    for (int i = 0; i < 16; ++i) tm[i] = 0;
    g_start = vtt_globaltimer();
    k_start = clock64();
  }

  // ---- load: the CTA's queue copy, the claims' nodes, the resident rows
  for (int q = tid; q < Q; q += NT) {
    for (int r = 0; r < R; ++r) {
      qalloc[(size_t)q * R + r] = a.queue_alloc[(size_t)q * R + r];
      if (a.x_qsmem)
        const_cast<float*>(qdes)[(size_t)q * R + r] = a.queue_deserved[(size_t)q * R + r];
    }
    qcnt[q] = 0;
    qdrop[q] = 0;
  }
  if (VS)
    for (int c = tid; c < VTT_CLAIMS; c += NT) h.claim_node[c] = c < (int)a.CL ? a.claim_node[c] : -1;
  for (int li = tid; li < nmine; li += NT) {
    const int n = node_of(li);
    if (li < NR) {
      for (int r = 0; r < R; ++r) {
        x.idle[r * NR + li] = a.idle[(size_t)n * R + r];
        x.rel[r * NR + li] = a.releasing[(size_t)n * R + r];
        x.used[r * NR + li] = a.used[(size_t)n * R + r];
        s_alloc[r * NR + li] = a.node_alloc[(size_t)n * R + r];
      }
      x.cnt[li] = a.task_count[n];
      s_mx[li] = a.node_valid[n] ? a.node_max_tasks[n] : (int)0x80000000;
      if (PS) {
        for (int w = 0; w < VTT_PW; ++w)
          x.ports[w * NR + li] = (uint32_t)a.node_ports[(size_t)n * VTT_PW + w];
        const int32_t* cnt = a.node_selcnt + (size_t)n * VTT_S;
        for (int w = 0; w < VTT_SW; ++w) {
          uint32_t mw = 0;
          for (int b = 0; b < 32; ++b) mw |= (cnt[w * 32 + b] > 0 ? 1u : 0u) << b;
          x.match[w * NR + li] = mw;
        }
      }
      if (VS)
        for (int g = 0; g < G; ++g) x.vcap[g * NR + li] = a.vol_cap[(size_t)g * N + n];
    } else if (PS) {
      vtt_ps_init_node(a, n);
    }
  }
  if (JL)
    for (int j = rank + C * tid; j < J; j += span) {
      const int i = j / C;
      jcur[i] = a.cursor[j];
      jrdy[i] = a.packed[3 * T + j];
      jdrop[i] = a.dropped[j];
      s_jq[i] = a.job_schedulable[j] ? a.job_queue[j] : -1;
      s_jnt[i] = a.job_ntasks[j];
      s_jst[i] = a.job_start[j];
      s_jmin[i] = a.job_min[j];
      s_jprio[i] = a.job_prio[j];
      for (int r = 0; r < R; ++r) jalloc[r * JL + i] = a.job_alloc[(size_t)j * R + r];
    }
  __syncthreads();
  // each CTA counts the active jobs of every queue (clamped as the
  // reference clamps them), all alike
  for (int j = tid; j < J; j += NT) {
    const int q = a.job_queue[j];
    if (q >= 0 && a.job_schedulable[j] && !a.dropped[j] && a.cursor[j] < a.job_ntasks[j])
      atomicAdd(&qcnt[q >= Q ? Q - 1 : q], 1);
  }

  int cur = -1, j_start = 0, j_ntasks = 0, j_min = 0, j_q = 0, j_cursor = 0, j_ready = 0;
  int counter = 0;
  unsigned xc = 0;  // record exchanges so far: the slot parity
  int cached_cls = -1;
  int pf_t = -1;  // the head task read a step ahead, or -1
  VttTaskW pf;
  for (;;) {
    if (cur < 0) {
      // ---- select step
      const long long ts = TM ? clock64() : 0;
      // the queue owners' updates of the last place step become visible
      __syncthreads();
      // every warp takes the queue alike, with no barrier: the least share
      // among the queues holding an active job, lowest queue first among
      // equals (a max of -share); an overused one drops and it repeats
      int qstar;
      for (;;) {
        float bv = VTT_POS_INF;
        int bq = 0x7fffffff;
        for (int q = lane; q < Q; q += 32) {
          if (qcnt[q] <= 0 || qdrop[q]) continue;
          const float share =
              a.use_proportion
                  ? vtt_dominant_share(&qalloc[(size_t)q * R], &qdes[(size_t)q * R], R)
                  : 0.0f;
          if (share < bv) {
            bv = share;
            bq = q;
          }
        }
        float nv = -bv;
        vtt_warp_argmax(nv, bq);
        qstar = bq;
        if (qstar == 0x7fffffff) break;
        if (a.use_proportion &&
            vtt_less_equal(&qdes[(size_t)qstar * R], &qalloc[(size_t)qstar * R], a.eps, R)) {
          // overused: out for the cycle; every warp writes the same flag
          // for itself
          if (lane == (qstar & 31)) qdrop[qstar] = 1;
          __syncwarp();
          if (tm0) tm[TM_QDROP] += 1;
          continue;
        }
        break;
      }
      if (qstar == 0x7fffffff) break;  // no active job anywhere: done
      long long ts1 = 0;
      if (TM) ts1 = clock64();
      // the job: its owners' candidates, all loads in flight together
      VttJobRec best;
      best.j = -1;
      for (int j = rank + C * tid; j < J; j += span) {
        const int i = jx(j);
        const int q = JL ? s_jq[i] : (a.job_schedulable[j] ? a.job_queue[j] : -1);
        const int nt = jnt[i];
        VttJobRec r;
        r.j = j;
        r.start = jst[i];
        r.ntasks = nt;
        r.min = jmin[i];
        r.cursor = jcur[i];
        r.ready = jrdy[i];
        const bool drop = jdrop[i] != 0;
#pragma unroll
        for (int k = 0; k < 3; ++k) r.k[k] = k < nk ? job_key(codes[k], j, i) : 0.0f;
        if (q == qstar && !drop && r.cursor < nt && vtt_job_better(r, best, nk)) best = r;
      }
      long long ts2 = 0;
      if (TM) ts2 = clock64();
      // warps without a candidate skip their butterfly
      if (__any_sync(0xffffffffu, best.j >= 0)) vtt_warp_job_min(best, nk);
      if (lane == 0) h.jwarps[warp] = best;
      __syncthreads();
      const int par = xc & 1;
      if (warp == 0) {
        VttJobRec r = h.jwarps[lane < VTT_EXACT_WARPS ? lane : 0];
        if (lane >= VTT_EXACT_WARPS) r.j = -1;
        if (__any_sync(0xffffffffu, r.j >= 0)) vtt_warp_job_min(r, nk);
        // lane c pushes the CTA's record into CTA c
        if (lane < C) vtt_cluster_store(&h.jrec[par][rank], lane, r);
      }
      long long ts3 = 0;
      if (TM) ts3 = clock64();
      vtt_cluster_arrive();
      vtt_cluster_wait();
      long long ts4 = 0;
      if (TM) ts4 = clock64();
      // lane c < C takes CTA c's record, the others none
      VttJobRec w = h.jrec[par][lane < C ? lane : 0];
      if (lane >= C) w.j = -1;
      vtt_warp_job_min(w, nk);
      ++xc;
      if (tm0) {
        const long long ts5 = clock64();
        tm[5] += ts5 - ts;
        tm[6] += ts1 - ts;
        tm[7] += ts2 - ts1;
        tm[8] += ts3 - ts2;
        tm[9] += ts4 - ts3;
        tm[10] += ts5 - ts4;
        tm[TM_SELECT] += 1;
      }
      if (w.j < 0) continue;
      cur = w.j;
      j_start = w.start;
      j_ntasks = w.ntasks;
      j_min = w.min;
      j_q = qstar;
      j_cursor = w.cursor;
      j_ready = w.ready;
      continue;
    }

    // ---- place step: head task of the current job
    const long long t0 = TM ? clock64() : 0;
    const int j = cur;
    const int t = j_start + j_cursor;
    VttTaskW tw;
    if (pf_t == t)
      tw = pf;
    else
      vtt_load_task<PS>(a, t, R, tw);
    if (t + 1 < j_start + j_ntasks) {
      vtt_load_task<PS>(a, t + 1, R, pf);
      pf_t = t + 1;
    } else {
      pf_t = -1;
    }
    const int par = xc & 1;
    if (VS) {
      if (tid == 0) vtt_vs_task(a, t, h.claim_node, h.vs[par]);
      __syncthreads();
    }
    const VttVsTask& vs = h.vs[par];
    const int cls = tw.cls;
    if (cls != cached_cls) {
      // the class row of the resident rows, kept while the class stays
      for (int li = tid; li < nres; li += NT) {
        const int n = node_of(li);
        x.cmask[li] = a.class_mask[(size_t)cls * N + n];
        s_cscore[li] = a.class_score[(size_t)cls * N + n];
      }
      cached_cls = cls;
    }
    const uint8_t* gmask = a.class_mask + (size_t)cls * N;
    const float* gscore = a.class_score + (size_t)cls * N;
    VttPs ps{};
    if (PS) ps = vtt_ps_of(tw);
    long long t1 = 0;
    if (tm0) {
      tm[TM_SINK] ^= __float_as_uint(tw.req[0]) ^ (unsigned)cls;
      t1 = clock64();
    }
    float bv = VTT_NEG_INF;
    int bc = 0x7fffffff;
#pragma unroll 2
    for (int li = tid; li < nres; li += NT) {
      const int n = node_of(li);
      const uint32_t vw = VS ? (uint32_t)a.task_volmask[(size_t)t * a.VW + (n >> 5)] : 0u;
      vtt_exact_eval<PS, VS, true>(x, li, n, tw, ps, vs, vw, gmask, gscore, bv, bc);
    }
    for (int li = nres + ((tid - nres) % NT + NT) % NT; li < nmine; li += NT) {
      const int n = node_of(li);
      const uint32_t vw = VS ? (uint32_t)a.task_volmask[(size_t)t * a.VW + (n >> 5)] : 0u;
      vtt_exact_eval<PS, VS, false>(x, li, n, tw, ps, vs, vw, gmask, gscore, bv, bc);
    }
    long long t2 = 0;
    if (TM) t2 = clock64();
    {
      const VttArg r = vtt_cta_argmax(bv, bc, h.warps);
      // lane c of warp 0 pushes the CTA's record into CTA c
      if (warp == 0 && lane < C) vtt_cluster_store(&h.nrec[par][rank], lane, VttArgRec{r, {0, 0}});
    }
    long long t3 = 0;
    if (TM) t3 = clock64();
    vtt_cluster_arrive();
    vtt_cluster_wait();
    long long t4 = 0;
    if (TM) t4 = clock64();
    VttArg win{VTT_NEG_INF, 0x7fffffff};
    if (lane < C) win = h.nrec[par][lane].a;
    vtt_warp_argmax(win.v, win.i);
    ++xc;
    const bool job_owner = rank == j % C && tid == (j / C) % NT;
    if (win.i == 0x7fffffff) {
      // head task unschedulable -> job dropped this cycle
      if (job_owner) jdrop[jx(j)] = 1;
      if (tid == j_q % NT) qcnt[j_q] -= 1;
      cur = -1;
    } else {
      const int n = win.i >> 1;
      const bool use_idle = (win.i & 1) != 0;
      const int chunk = n >> 5;
      const int li = ((chunk / C) << 5) | (n & 31);
      if (chunk % C == rank && li % NT == tid) {
        if (li < NR)
          vtt_exact_place<PS, VS, true>(x, li, n, tw, ps, vs, use_idle);
        else
          vtt_exact_place<PS, VS, false>(x, li, n, tw, ps, vs, use_idle);
      }
      if (VS && use_idle) {
        // each newly assumed claim of a global group takes one PV off every
        // node's count of its group: each thread its own rows
        for (int i = 0; i < vs.n; ++i) {
          if (vs.node[i] >= 0 || !vs.glob[i]) continue;
          const int g = vs.g[i];
          for (int l = tid; l < nmine; l += NT) {
            const int m = node_of(l);
            if (l < NR)
              x.vcap[g * NR + l] -= 1;
            else
              a.vol_cap[(size_t)g * N + m] -= 1;
          }
        }
        if (tid == 0)
          for (int i = 0; i < vs.n; ++i)
            if (vs.node[i] < 0) h.claim_node[vs.c[i]] = n;
      }
      const int new_ready = j_ready + (use_idle ? 1 : 0);
      const bool now_ready = a.use_gang_ready ? new_ready >= j_min : true;
      const bool exhausted = j_cursor + 1 >= j_ntasks;
      if (job_owner) {
#pragma unroll
        for (int r = 0; r < VTT_MAX_R; ++r)
          if (r < R) jalloc[ax(j, r)] = jalloc[ax(j, r)] + tw.req[r];
        jrdy[jx(j)] = new_ready;
        jcur[jx(j)] = j_cursor + 1;
      }
      if (tid == j_q % NT) {
#pragma unroll
        for (int r = 0; r < VTT_MAX_R; ++r)
          if (r < R) qalloc[(size_t)j_q * R + r] = qalloc[(size_t)j_q * R + r] + tw.req[r];
        if (exhausted) qcnt[j_q] -= 1;
      }
      if (rank == 0 && tid == 0) {
        task_node[t] = n;
        task_kind[t] = use_idle ? 1 : 2;
        task_seq[t] = counter;
      }
      j_ready = new_ready;
      j_cursor += 1;
      counter += 1;
      cur = (now_ready || exhausted) ? -1 : j;
    }
    if (tm0) {
      const long long t5 = clock64();
      tm[0] += t1 - t0;
      tm[1] += t2 - t1;
      tm[2] += t3 - t2;
      tm[3] += t4 - t3;
      tm[4] += t5 - t4;
      tm[TM_PLACE] += 1;
    }
  }

  // ---- write the resident rows back into the working copies
  __syncthreads();
  for (int li = tid; li < nres; li += NT) {
    const int n = node_of(li);
    for (int r = 0; r < R; ++r) {
      a.idle[(size_t)n * R + r] = x.idle[r * NR + li];
      a.releasing[(size_t)n * R + r] = x.rel[r * NR + li];
      a.used[(size_t)n * R + r] = x.used[r * NR + li];
    }
    a.task_count[n] = x.cnt[li];
    if (PS)
      for (int w = 0; w < VTT_PW; ++w)
        a.node_ports[(size_t)n * VTT_PW + w] = (int32_t)x.ports[w * NR + li];
    if (VS)
      for (int g = 0; g < G; ++g) a.vol_cap[(size_t)g * N + n] = x.vcap[g * NR + li];
  }
  if (JL)
    for (int j = rank + C * tid; j < J; j += span) {
      const int i = j / C;
      a.dropped[j] = jdrop[i];
      ready[j] = jrdy[i];
      for (int r = 0; r < R; ++r) a.job_alloc[(size_t)j * R + r] = jalloc[r * JL + i];
    }
  if (rank == 0) {
    for (int q = tid; q < Q; q += NT)
      for (int r = 0; r < R; ++r) a.queue_alloc[(size_t)q * R + r] = qalloc[(size_t)q * R + r];
    if (VS)
      for (int c = tid; c < (int)a.CL; c += NT) a.claim_node[c] = h.claim_node[c];
    if (tid == 0) {
      a.ctl[0] = counter;
      a.ctl[1] = C;
    }
  }
  if (tm0) {
    const unsigned long long g_end = vtt_globaltimer();
    int64_t* s = a.x_split;
    s[0] = (int64_t)(g_end - g_start);
    s[1] = clock64() - k_start;
    for (int i = 0; i < 6; ++i) s[2 + i] = tm[i];
    s[8] = tm[TM_PLACE];
    s[9] = tm[TM_SELECT];
    s[10] = tm[TM_QDROP];
    s[11] = tm[TM_SINK];
    s[12] = C;
    s[13] = NR;
    s[14] = ns;
    for (int i = 0; i < 5; ++i) s[16 + i] = tm[6 + i];
  }
  // no CTA leaves while another may still read its records
  vtt_cluster_arrive();
  vtt_cluster_wait();
}

// Launch one cluster of the kernel; a.cluster names the size (0: the
// largest of 16, 8, 4, 2, 1 the card admits at this shape's shared
// memory).  Fills the layout fields and writes back the size launched.
template <bool PS, bool VS, bool TM>
static int vtt_exact_launch(VttSolveArgs& a, cudaStream_t s) {
  void (*kernel)(VttSolveArgs) = vtt_allocate_solve_kernel<PS, VS, TM>;
  int dev = 0, smax = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smax, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smax);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int N = (int)a.N, R = (int)a.R, Q = (int)a.Q, G = (int)a.G;
  const bool qsmem = (size_t)Q * (2 * R + 2) * 4 <= VTT_EXACT_QSMEM;
  if (!qsmem && !a.x_qstate) return (int)cudaErrorInvalidValue;
  const int sizes[5] = {16, 8, 4, 2, 1};
  for (int k = 0; k < 5; ++k) {
    const int C = sizes[k];
    if (a.cluster && a.cluster != C) continue;
    // 32-row chunks dealt round-robin: ceil(chunks / C) a CTA
    const int ns = (((N + 31) / 32 + C - 1) / C) * 32;
    int JL = ((int)a.J + C - 1) / C;
    if ((size_t)JL * vtt_exact_job_bytes(R) > VTT_EXACT_JSMEM) JL = 0;
    const size_t fixed = vtt_exact_layout(R, Q, qsmem, JL, 0, PS, VS, G).total;
    const size_t per = vtt_exact_layout(R, Q, qsmem, JL, 1024, PS, VS, G).total - fixed;
    int NR = 0;
    if ((size_t)smax > fixed + 16 * 16) {
      NR = (int)(((size_t)smax - fixed - 16 * 16) * 1024 / per);
      if (NR > ns) NR = ns;
      while (NR > 0 && vtt_exact_layout(R, Q, qsmem, JL, NR, PS, VS, G).total > (size_t)smax)
        --NR;
    }
    const size_t dyn = vtt_exact_layout(R, Q, qsmem, JL, NR, PS, VS, G).total;
    if (dyn > (size_t)smax) continue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, 1, 1);
    cfg.blockDim = dim3(VTT_EXACT_THREADS, 1, 1);
    cfg.dynamicSmemBytes = dyn;
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
      if (a.cluster) return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
      continue;
    }
    a.cluster = C;
    a.x_ns = ns;
    a.x_nres = NR;
    a.x_qsmem = qsmem ? 1 : 0;
    a.x_jl = JL;
    e = cudaLaunchKernelEx(&cfg, kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidConfiguration;
}

template <bool TM>
static int vtt_exact_dispatch(VttSolveArgs& a, cudaStream_t s) {
  if (a.has_portsel && a.has_volsel) return vtt_exact_launch<true, true, TM>(a, s);
  if (a.has_volsel) return vtt_exact_launch<false, true, TM>(a, s);
  if (a.has_portsel) return vtt_exact_launch<true, false, TM>(a, s);
  return vtt_exact_launch<false, false, TM>(a, s);
}

extern "C" int vtt_allocate_solve(VttSolveArgs* args, void* stream) {
  VttSolveArgs& a = *args;
  const int64_t c = a.cluster;
  if (a.R < 2 || a.R > VTT_MAX_R || a.Q < 1 || a.n_keys > 3 || a.N >= (1ll << 30) ||
      (c != 0 && c != 1 && c != 2 && c != 4 && c != 8 && c != 16) ||
      (a.has_volsel && (a.CL < 1 || a.CL > VTT_CLAIMS || a.VW * 32 < a.N)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return a.x_split ? vtt_exact_dispatch<true>(a, s) : vtt_exact_dispatch<false>(a, s);
}
