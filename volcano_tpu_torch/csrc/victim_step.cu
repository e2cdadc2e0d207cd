// K7: one preemptor's victim solve over all nodes, as one launch, over the
// pool grouped by node once per constants.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:362 `victim_step` (core
// :184-355; orders :131-182), the standalone victim solve that the object
// path's preempt and reclaim drive once per preemptor
// (tensor_actions._VictimDriver): the base mask by mode (0 queue: same
// queue, other jobs; 1 job: own job; 2 reclaim: other queues), the
// per-node drf / proportion / eviction orders, the gang, drf, proportion
// and conformance vetoes, the DO-while victim prefix, the best node of the
// walk and the state update.
//
// What bounds it on the H100: latency.  The bound is the bytes, about
// 1.5 us at 3.35 TB/s (the pool and the state read once, the new state
// written once); what is left above it is one launch, the slowest node's
// serial walk and the host's round trip per attempt.  Design:
//   * the groups (vtt_victim_groups, victim_kernels.victim_groups; one
//     cluster launch, vtt_group_kernel in victim_common.cuh): node_off
//     [N + 1] and four per-node lists of the pool rows (pool order, (job,
//     row), (queue, row), the preempt eviction order), each node's list the
//     JAX global lexsort restricted to that node and to the rows of a live
//     mask.  They read only the constants and that mask, so the object
//     path builds them once per snapshot (its live rows), as the JAX package
//     hoists its orders out of the storm loops; reclaim's eviction order is
//     the pool order, the list l_vidx.  Rows that die later stay in the
//     lists and the core skips them (vtt_row_base reads run_live);
//   * the core spread over the card: CTAs of VTT_STEP_THREADS threads, one
//     node a thread, because a node's float64 sums are one serial chain in
//     list order.  Each CTA copies its slice of the input state into the
//     output state (the input is never written), reduces its nodes to a
//     record (the (walk key, row) minima over covered and over valid nodes)
//     and takes a ticket; the last CTA merges the records (the minimum does
//     not depend on how nodes are split), applies the decision to the
//     output state with vtt_apply_on (whenever a node is covered, clean or
//     not, as the JAX function returns its updated state either way), and
//     packs assigned, nstar (0 when unassigned), clean, the victim count and
//     the victim mask as ceil(V / 32) words.
//
// K12b: the same solve with the node planes of the constants and state in
// blocks of rows.  Replaces volcano_tpu/parallel/sharded.py:202
// `make_sharded_victim_step` (K7 with `_VICTIM_SPECS`: node planes split
// over the mesh's node axis, the [V] pool replicated).  Per preemptor:
//   1. vtt_vb_step_core, one launch over every local block's CTAs: K7's
//      core over the block's rows with the block's constant planes from
//      device memory; the last CTA of a block writes the block's record of
//      VTT_VB_WORDS int32;
//   2. the caller exchanges the records (the records buffer itself on one
//      device, an all-gather over a process group);
//   3. vtt_vb_step_apply, one CTA: the minimum of the S records (assigned,
//      nstar, clean exactly as K7 defines them), nstar's flag pass again
//      from the replicated pool and state (the node may lie on another
//      process), the apply into the replicated state and, where a local
//      block owns nstar, its node rows, and the pack.
// The groups of the whole pool serve every block: a block's lists are the
// slice of its node rows.  The same lists and float64 sums as K7 make every
// block count give K7's outputs bit for bit, state included.
#include "victim_common.cuh"

// threads of a K7 / K12b core CTA, one node a thread (a power of two)
#define VTT_STEP_THREADS 128
// most local blocks a K12b launch takes (parallel/sharded.MAX_LOCAL_BLOCKS)
#define VTT_VB_MAX 64
// ctl word of K7's ticket; K12b's, one a local block, follow it
#define VTT_STEP_TICKET 12

// the preemptor's attempt: request task_req[0], class, job, queue, mode,
// and its DRF share keyed on the drf flag alone
__device__ __forceinline__ void vtt_step_attempt(const VttVictimArgs& a, VttAttempt& at,
                                                 int t_cls, int jt, int qt, int mode) {
  const int R = (int)a.R;
  at.t = 0;
  at.jt = jt;
  at.qt = qt;
  at.mode = mode;
  at.cls = t_cls;
  for (int r = 0; r < R; ++r) at.req[r] = a.task_req[r];
  at.ls = 0.0f;
  if (a.use_drf) {
    float sum[VTT_MAX_R];
    for (int r = 0; r < R; ++r) sum[r] = a.job_alloc[(size_t)jt * R + r] + at.req[r];
    at.ls = vtt_dominant_share(sum, a.total, R);
  }
}

static inline bool vtt_vb_ok(const VttVictimArgs& a, int t_cls, int jt, int mode) {
  return a.R >= 2 && a.R <= VTT_MAX_R && mode >= 0 && mode <= 2 && jt >= 0 && jt < a.J &&
         t_cls >= 0 && t_cls < a.C;
}

// ---- the groups: the pool grouped by node, once per constants ------------

// The groups of the pool rows in `live` (vtt_group_kernel, one launch) into
// node_off [N + 1] and l_vidx, l_ev, l_drf, l_prop [V] (-1 past the grouped
// rows) with eviction order ev_kind, over node rows [n0, n0 + N) of NT;
// bucket [V] scratch.
extern "C" int vtt_victim_groups(const VttVictimArgs* args, const void* live, int ev_kind,
                                 void* stream) {
  VttVictimArgs a = *args;
  a.run_live = (uint8_t*)live;
  return vtt_group_launch(a, ev_kind, (cudaStream_t)stream);
}

// ---- the pieces of K7 and K12b -------------------------------------------

// The state a solve returns, in fresh buffers (the input state is only
// read), and its packed decision.  The node rows are K7's N rows, or the
// local blocks' rows in block order (K12b).
struct VttStepOut {
  uint8_t* run_live;
  float* job_alloc;
  int32_t* job_occupied;
  float* queue_alloc;
  float* releasing;
  float* used;
  int32_t* task_count;
  int32_t* packed;  // [4 + ceil(V / 32)]
};

// K12b: each local block's input node rows (the input state's blocks)
struct VttVbIn {
  const float* releasing[VTT_VB_MAX];
  const float* used[VTT_VB_MAX];
  const int32_t* task_count[VTT_VB_MAX];
};

// K12b: a local block's constant node planes and first row
struct VttVbConst {
  const float* node_alloc;
  const int32_t* node_max_tasks;
  const uint8_t* node_valid;
  const uint8_t* class_mask;
  const float* class_score;
  int64_t n0;
};

struct VttStepShared {
  float kc[VTT_STEP_THREADS], kv[VTT_STEP_THREADS];
  int ic[VTT_STEP_THREADS], iv[VTT_STEP_THREADS];
  VttAttempt at;
  int last;
};

// bytes [0, n) of src into dst: this CTA's part of `parts` (16-byte words
// where both are aligned)
static __device__ __forceinline__ void vtt_copy_part(void* dst, const void* src, size_t n,
                                                     int part, int parts) {
  const bool wide = ((((size_t)dst) | ((size_t)src)) & 15) == 0;
  const size_t nu = wide ? n / 16 : n;
  const size_t lo = nu * part / parts, hi = nu * (part + 1) / parts;
  if (wide) {
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
      ((int4*)dst)[i] = ((const int4*)src)[i];
    if (part == parts - 1)
      for (size_t i = nu * 16 + threadIdx.x; i < n; i += blockDim.x)
        ((uint8_t*)dst)[i] = ((const uint8_t*)src)[i];
  } else {
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
      ((uint8_t*)dst)[i] = ((const uint8_t*)src)[i];
  }
}

// the replicated state (run_live, job_alloc, job_occupied, queue_alloc)
// copied into `o`: this CTA's part
static __device__ __forceinline__ void vtt_copy_replicated(const VttVictimArgs& a,
                                                           const VttStepOut& o, int part,
                                                           int parts) {
  const size_t R = (size_t)a.R;
  vtt_copy_part(o.run_live, a.run_live, (size_t)a.V, part, parts);
  vtt_copy_part(o.job_alloc, a.job_alloc, (size_t)a.J * R * 4, part, parts);
  vtt_copy_part(o.job_occupied, a.job_occupied, (size_t)a.J * 4, part, parts);
  vtt_copy_part(o.queue_alloc, a.queue_alloc, (size_t)a.Q * R * 4, part, parts);
}

// node rows [0, nb) of the input planes into the output planes' rows
// [row, row + nb): this CTA's part
static __device__ __forceinline__ void vtt_copy_rows(const VttStepOut& o, const float* rel,
                                                     const float* used, const int32_t* tc,
                                                     size_t row, size_t nb, size_t R, int part,
                                                     int parts) {
  vtt_copy_part(o.releasing + row * R, rel, nb * R * 4, part, parts);
  vtt_copy_part(o.used + row * R, used, nb * R * 4, part, parts);
  vtt_copy_part(o.task_count + row, tc, nb * 4, part, parts);
}

// the CTA's (key, row) minima of its threads' entries into sh.*[0]
static __device__ void vtt_step_reduce(VttStepShared& sh, float kc, int ic, float kv, int iv) {
  const int tid = threadIdx.x;
  sh.kc[tid] = kc;
  sh.ic[tid] = ic;
  sh.kv[tid] = kv;
  sh.iv[tid] = iv;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      if (vtt_kmin_better(sh.kc[tid + s], sh.ic[tid + s], sh.kc[tid], sh.ic[tid])) {
        sh.kc[tid] = sh.kc[tid + s];
        sh.ic[tid] = sh.ic[tid + s];
      }
      if (vtt_kmin_better(sh.kv[tid + s], sh.iv[tid + s], sh.kv[tid], sh.iv[tid])) {
        sh.kv[tid] = sh.kv[tid + s];
        sh.iv[tid] = sh.iv[tid + s];
      }
    }
    __syncthreads();
  }
}

// One node a thread: node n of the planes in `a` (global row n0 + n), its
// verdict for the attempt reduced over the CTA into sh.*[0] (global rows).
static __device__ void vtt_step_nodes(const VttVictimArgs& a, VttStepShared& sh, int n) {
  float kc = 0.0f, kv = 0.0f;
  int ic = -1, iv = -1;
  if (n < a.N) {
    bool valid, covered;
    float key;
    vtt_core_node(a, sh.at, n, valid, covered, key);
    if (valid) {
      kv = key;
      iv = (int)a.n0 + n;
    }
    if (covered) {
      kc = key;
      ic = (int)a.n0 + n;
    }
  }
  vtt_step_reduce(sh, kc, ic, kv, iv);
}

// thread 0: the CTA's minima as a record of VTT_VB_WORDS words
static __device__ void vtt_step_record(const VttStepShared& sh, int32_t* rec) {
  rec[0] = __float_as_int(sh.kc[0]);
  rec[1] = sh.ic[0];
  rec[2] = __float_as_int(sh.kv[0]);
  rec[3] = sh.iv[0];
  rec[4] = sh.ic[0] >= 0;
  rec[5] = sh.iv[0] >= 0;
}

// Whether this CTA is the last of `count` to take a ticket at *ticket
// (every thread returns it).  Each thread's writes are fenced before the
// ticket, and the last CTA fences after it, so it reads every other CTA's
// records and copies.
static __device__ bool vtt_last_cta(int32_t* ticket, int count, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  const bool last = *s_last != 0;
  if (last) __threadfence();
  return last;
}

// The (key, row) minima of `count` records into sh.*[0] (all threads), as
// vtt_merge_records takes them
static __device__ void vtt_records_min(const int32_t* recs, int count, VttStepShared& sh) {
  float kc = 0.0f, kv = 0.0f;
  int ic = -1, iv = -1;
  for (int b = threadIdx.x; b < count; b += blockDim.x) {
    const volatile int32_t* r = recs + (size_t)b * VTT_VB_WORDS;
    const float k0 = __int_as_float(r[0]), k2 = __int_as_float(r[2]);
    const int r1 = r[1], r3 = r[3];
    if (r[4] && vtt_kmin_better(k0, r1, kc, ic)) {
      kc = k0;
      ic = r1;
    }
    if (r[5] && vtt_kmin_better(k2, r3, kv, iv)) {
      kv = k2;
      iv = r3;
    }
  }
  vtt_step_reduce(sh, kc, ic, kv, iv);
}

// nstar (-1 when no node is covered) and clean from the merged minima
static __device__ __forceinline__ bool vtt_step_clean(const VttStepShared& sh) {
  const int nstar = sh.ic[0];
  return nstar >= 0 ? (sh.kv[0] == sh.kc[0] && sh.iv[0] == nstar) : sh.iv[0] < 0;
}

// The decision's apply and pack by one CTA.  Thread 0 evicts the in-prefix
// rows of nstar's eviction list l_ev[off, end) and pipelines the preemptor
// into the output state (rel / used / tc: nstar's output node rows, null
// where another process owns the node); the CTA writes the packed header
// and the victim mask.
static __device__ void vtt_step_finish(const VttVictimArgs& a, const VttStepOut& o,
                                       const VttAttempt& at, int nstar, bool clean, int off,
                                       int end, float* rel, float* used, int32_t* tc) {
  const int nw = (int)((a.V + 31) / 32);
  if (threadIdx.x == 0) {
    int nv = 0;
    if (nstar >= 0) {
      VttVictimArgs ao = a;
      ao.run_live = o.run_live;
      ao.job_alloc = o.job_alloc;
      ao.job_occupied = o.job_occupied;
      ao.queue_alloc = o.queue_alloc;
      VttJournal jr{false, 0};
      nv = vtt_apply_on(ao, at, a.l_ev, off, end, rel, used, tc, nstar, jr);
    }
    o.packed[0] = nstar >= 0;
    o.packed[1] = nstar >= 0 ? nstar : 0;
    o.packed[2] = clean;
    o.packed[3] = nv;
  }
  for (int w = threadIdx.x; w < nw; w += blockDim.x) o.packed[4 + w] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t* words = (uint32_t*)(o.packed + 4);
    for (int i = off; i < end; ++i) {
      const int v = a.l_ev[i];
      if (a.flag[v] & VF_INPRE) words[v / 32] |= 1u << (v % 32);
    }
  }
}

// ---- K7 ------------------------------------------------------------------

// K7: ceil(N / VTT_STEP_THREADS) CTAs (`a`: the input state, the groups,
// the records a.send [grid, VTT_VB_WORDS], the ticket in a.ctl)
__global__ void __launch_bounds__(VTT_STEP_THREADS)
    vtt_step_kernel(VttVictimArgs a, VttStepOut o, int t_cls, int jt, int qt, int mode) {
  __shared__ VttStepShared sh;
  const int tid = threadIdx.x;
  if (tid == 0) vtt_step_attempt(a, sh.at, t_cls, jt, qt, mode);
  vtt_copy_replicated(a, o, blockIdx.x, gridDim.x);
  vtt_copy_rows(o, a.releasing, a.used, a.task_count, 0, (size_t)a.N, (size_t)a.R, blockIdx.x,
                gridDim.x);
  __syncthreads();
  vtt_step_nodes(a, sh, blockIdx.x * blockDim.x + tid);
  if (tid == 0) vtt_step_record(sh, a.send + (size_t)blockIdx.x * VTT_VB_WORDS);
  int32_t* ticket = a.ctl + VTT_STEP_TICKET;
  if (!vtt_last_cta(ticket, gridDim.x, &sh.last)) return;
  vtt_records_min(a.send, gridDim.x, sh);
  const int nstar = sh.ic[0];
  const bool clean = vtt_step_clean(sh);
  const int off = nstar >= 0 ? a.node_off[nstar] : 0;
  const int end = nstar >= 0 ? a.node_off[nstar + 1] : 0;
  const size_t row = nstar >= 0 ? (size_t)nstar : 0;
  vtt_step_finish(a, o, sh.at, nstar, clean, off, end, o.releasing + row * a.R,
                  o.used + row * a.R, o.task_count + row);
  if (tid == 0) *ticket = 0;
}

// One K7 solve: `args` the input state and constants, the groups (node_off,
// l_*), the scratch (flag [V], ctl, send [ceil(N / VTT_STEP_THREADS),
// VTT_VB_WORDS], and evict_att [V], pipe [J], pipe_node / pipe_att [1],
// which the apply writes and nothing reads); `out` the output state and
// the packed decision.
extern "C" int vtt_victim_step(const VttVictimArgs* args, const VttStepOut* out, int t_cls,
                               int jt, int qt, int mode, void* stream) {
  VttVictimArgs a = *args;
  if (!vtt_vb_ok(a, t_cls, jt, mode) || a.N < 1) return (int)cudaErrorInvalidValue;
  if (mode == 2) a.l_ev = a.l_vidx;  // reclaim evicts in pool order
  const int grid = (int)((a.N + VTT_STEP_THREADS - 1) / VTT_STEP_THREADS);
  VTT_LAUNCH(vtt_step_kernel, grid, VTT_STEP_THREADS, 0, (cudaStream_t)stream)(
      a, *out, t_cls, jt, qt, mode);
  return (int)cudaGetLastError();
}

// ---- K12b: the victim solve on node blocks -------------------------------

// K12b's cores: `cpb` CTAs a local block (`a`: the replicated inputs with
// N the block's rows, the groups of the whole pool, scratch; `blk` the
// blocks' constant planes in device memory; `in` their input node rows).
// The last CTA of block b writes its record into send[b].
__global__ void __launch_bounds__(VTT_STEP_THREADS)
    vtt_vb_step_core(VttVictimArgs a, const VttVbConst* blk, VttVbIn in, VttStepOut o, int cpb,
                     int32_t* send, int t_cls, int jt, int qt, int mode) {
  __shared__ VttStepShared sh;
  __shared__ VttVictimArgs s_a;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / cpb, part = blockIdx.x % cpb;
  if (tid == 0) {
    const VttVbConst bc = blk[b];
    s_a = a;
    s_a.node_alloc = bc.node_alloc;
    s_a.node_max_tasks = bc.node_max_tasks;
    s_a.node_valid = bc.node_valid;
    s_a.class_mask = bc.class_mask;
    s_a.class_score = bc.class_score;
    s_a.n0 = bc.n0;
    s_a.node_off = a.node_off + bc.n0;
    s_a.releasing = (float*)in.releasing[b];
    s_a.used = (float*)in.used[b];
    s_a.task_count = (int32_t*)in.task_count[b];
    vtt_step_attempt(a, sh.at, t_cls, jt, qt, mode);
  }
  vtt_copy_replicated(a, o, blockIdx.x, gridDim.x);
  vtt_copy_rows(o, in.releasing[b], in.used[b], in.task_count[b], (size_t)b * a.N, (size_t)a.N,
                (size_t)a.R, part, cpb);
  __syncthreads();
  vtt_step_nodes(s_a, sh, part * blockDim.x + tid);
  if (tid == 0) vtt_step_record(sh, a.send + (size_t)blockIdx.x * VTT_VB_WORDS);
  int32_t* ticket = a.ctl + VTT_STEP_TICKET + b;
  if (!vtt_last_cta(ticket, cpb, &sh.last)) return;
  vtt_records_min(a.send + (size_t)b * cpb * VTT_VB_WORDS, cpb, sh);
  if (tid == 0) {
    vtt_step_record(sh, send + (size_t)b * VTT_VB_WORDS);
    *ticket = 0;
  }
}

// K12b's apply, one CTA after the exchange (`recv` [S, VTT_VB_WORDS]; `a`
// the replicated inputs and the groups, N the mesh's rows; the output node
// rows [row0, row0 + rows) are the local blocks')
__global__ void __launch_bounds__(VTT_STEP_THREADS)
    vtt_vb_step_apply(VttVictimArgs a, VttStepOut o, const int32_t* recv, int S,
                      long long row0, long long rows, int t_cls, int jt, int qt, int mode) {
  __shared__ VttStepShared sh;
  if (threadIdx.x == 0) vtt_step_attempt(a, sh.at, t_cls, jt, qt, mode);
  vtt_records_min(recv, S, sh);
  const int nstar = sh.ic[0];
  const bool clean = vtt_step_clean(sh);
  const int off = nstar >= 0 ? a.node_off[nstar] : 0;
  const int end = nstar >= 0 ? a.node_off[nstar + 1] : 0;
  if (nstar >= 0 && threadIdx.x == 0) {
    // nstar's flags again from the replicated pool and state
    double acc[VTT_MAX_R];
    vtt_node_flags(a, sh.at, off, end, a.l_vidx, a.l_drf, a.l_prop, a.l_ev, acc);
  }
  const long long local = (long long)nstar - row0;
  const bool own = nstar >= 0 && local >= 0 && local < rows;
  const size_t row = own ? (size_t)local : 0;
  vtt_step_finish(a, o, sh.at, nstar, clean, off, end, own ? o.releasing + row * a.R : nullptr,
                  own ? o.used + row * a.R : nullptr, own ? o.task_count + row : nullptr);
}

// First half of a K12b solve: every local block's cores in one launch, the
// state copied into `out`, block b's record into send[b] ([n_blocks,
// VTT_VB_WORDS]).  `base`: N the block's rows, NT the mesh's, the groups
// of the whole pool, scratch (flag [V], ctl with n_blocks tickets, send
// [n_blocks * ceil(N / VTT_STEP_THREADS), VTT_VB_WORDS]).
extern "C" int vtt_victim_blocks_core(const VttVictimArgs* base, const void* dblk,
                                      const VttVbIn* in, const VttStepOut* out, int n_blocks,
                                      int t_cls, int jt, int qt, int mode, void* send,
                                      void* stream) {
  VttVictimArgs a = *base;
  if (!vtt_vb_ok(a, t_cls, jt, mode) || a.N < 1 || n_blocks < 1 || n_blocks > VTT_VB_MAX)
    return (int)cudaErrorInvalidValue;
  if (mode == 2) a.l_ev = a.l_vidx;
  const int cpb = (int)((a.N + VTT_STEP_THREADS - 1) / VTT_STEP_THREADS);
  VTT_LAUNCH(vtt_vb_step_core, n_blocks * cpb, VTT_STEP_THREADS, 0, (cudaStream_t)stream)(
      a, (const VttVbConst*)dblk, *in, *out, cpb, (int32_t*)send, t_cls, jt, qt, mode);
  return (int)cudaGetLastError();
}

// Second half, after the exchange filled `recv` [S, VTT_VB_WORDS]: the
// merge, the replicated apply, the owner's node rows and the pack into
// `out`, whose node rows are the local blocks' [row0, row0 + rows).
extern "C" int vtt_victim_blocks_apply(const VttVictimArgs* base, const VttStepOut* out,
                                       const void* recv, int S, long long row0, long long rows,
                                       int t_cls, int jt, int qt, int mode, void* stream) {
  VttVictimArgs a = *base;
  if (!vtt_vb_ok(a, t_cls, jt, mode) || S < 1) return (int)cudaErrorInvalidValue;
  if (mode == 2) a.l_ev = a.l_vidx;
  VTT_LAUNCH(vtt_vb_step_apply, 1, VTT_STEP_THREADS, 0, (cudaStream_t)stream)(
      a, *out, (const int32_t*)recv, S, row0, rows, t_cls, jt, qt, mode);
  return (int)cudaGetLastError();
}

// ---- K15a / K15b: a walk's pending attempt, several CTAs a block --------

// K12b's core for a walk's pending attempt: `cpb` CTAs a local block, one
// node a thread (`blocks` in device memory: each block's node planes, its
// slice of the base's node_off over the whole pool's groups, the walk).
// Each CTA's record goes into cta_rec; the last CTA of block b to take its
// ticket merges the block's records into the block's send slot.
__global__ void __launch_bounds__(VTT_STEP_THREADS)
    vtt_wb_core(const VttVictimArgs* blocks, int cpb, int32_t* cta_rec, int32_t* tickets) {
  __shared__ VttStepShared sh;
  __shared__ VttVictimArgs s_a;
  const int b = blockIdx.x / cpb, part = blockIdx.x % cpb;
  if (threadIdx.x == 0) {
    s_a = blocks[b];
    sh.at = ((const VttWalk*)s_a.walk)->at;
  }
  __syncthreads();
  vtt_step_nodes(s_a, sh, part * blockDim.x + threadIdx.x);
  if (threadIdx.x == 0) vtt_step_record(sh, cta_rec + (size_t)blockIdx.x * VTT_VB_WORDS);
  if (!vtt_last_cta(&tickets[b], cpb, &sh.last)) return;
  vtt_records_min(cta_rec + (size_t)b * cpb * VTT_VB_WORDS, cpb, sh);
  if (threadIdx.x == 0) {
    vtt_step_record(sh, s_a.send);
    tickets[b] = 0;
  }
}

// The cores of the pending attempt of a K15a / K15b walk: every local
// block's record into its slot of the send buffer (`dblk`: the L blocks'
// arguments in device memory, nb rows each; cta_rec [L * ceil(nb /
// VTT_STEP_THREADS), VTT_VB_WORDS] scratch; tickets [L], zero between
// launches).
extern "C" int vtt_walk_blocks_core(const VttVictimArgs* dblk, int n_blocks, int nb,
                                    void* cta_rec, void* tickets, void* stream) {
  if (n_blocks < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  const int cpb = (nb + VTT_STEP_THREADS - 1) / VTT_STEP_THREADS;
  VTT_LAUNCH(vtt_wb_core, n_blocks * cpb, VTT_STEP_THREADS, 0, (cudaStream_t)stream)(
      dblk, cpb, (int32_t*)cta_rec, (int32_t*)tickets);
  return (int)cudaGetLastError();
}
