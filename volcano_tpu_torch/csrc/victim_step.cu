// K7: one preemptor's victim solve over all nodes, as one launch.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:362 `victim_step` (core
// :118-355), the standalone victim solve that the object path's preempt and
// reclaim drive once per preemptor (tensor_actions._VictimDriver): the base
// mask by mode (0 queue: same queue, other jobs; 1 job: own job; 2
// reclaim: other queues), the per-node drf / proportion / eviction orders,
// the gang, drf, proportion and conformance vetoes, the DO-while victim
// prefix, the best node of the walk and the state update.
//
// What bounds it on the H100: latency.  The work is a few passes over the
// pool (about 30 bytes a row) and a score per node, microseconds of
// traffic at 3.35 TB/s; the launch chain (four setup kernels, the core, the
// pack) and the host's one fetch per attempt dominate.  Design: the setup
// kernels of victim_common.cuh group the pool by node and rank each row in
// its node's orders (recomputed every call, as the JAX function does); one
// 1024-thread CTA runs vtt_core (threads own strided nodes; block-wide
// lexicographic argmins give the first covered and first valid node), and
// thread 0 applies the decision with vtt_apply to the wrapper's copy of the
// state whenever a node is covered, clean or not, as the JAX function
// returns its updated state either way.  The last kernel packs the result
// into one int32 buffer: assigned, nstar (0 when unassigned), clean, the
// victim count, then the victim mask as ceil(V / 32) words.
//
// K12b: the same solve with the node planes of the constants and state in
// blocks of rows.  Replaces volcano_tpu/parallel/sharded.py:202
// `make_sharded_victim_step` (K7 with `_VICTIM_SPECS`: node planes split
// over the mesh's node axis, the [V] pool replicated).  Per preemptor:
//   1. vtt_victim_blocks_core, for each of this process's blocks: the setup
//      kernels group the pool rows whose node lies in the block (offsets for
//      the block's own rows only), and one CTA runs the core over them and
//      writes a record of VTT_VB_WORDS int32: the (walk key, global row)
//      lexicographic minimum over the block's covered nodes and over its
//      valid nodes, and the two any-flags;
//   2. the caller exchanges the records (the records buffer itself on one
//      device, an all-gather over a process group);
//   3. vtt_victim_blocks_apply: one CTA takes the minimum of the S records
//      (assigned, nstar, clean exactly as the one-block core defines them),
//      then gathers nstar's live pool rows itself, ranks them in the node's
//      four orders, reruns the node's flag pass and evicts the prefix into
//      the replicated state (run_live, job, queue); the block that owns nstar
//      adds the preemptor and the victims' total to its node rows.
// Every block recomputes nstar's victims rather than receiving the owner's
// mask words in a second exchange: what the flag pass reads (the pool,
// run_live, the job and queue state) is replicated, nstar's rows are a few
// dozen, and one exchange a preemptor is one host round trip fewer over a
// process group.  The same per-node lists and float64 sums as K7 make every
// block count give the one-block outputs bit for bit, state included.
#include "victim_common.cuh"

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

__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_victim_step_kernel(VttVictimArgs a, int t_cls, int jt, int qt, int mode,
                           int32_t* out) {
  __shared__ VttCoreShared sh;
  __shared__ VttAttempt s_at;
  const int tid = threadIdx.x;
  if (tid == 0) vtt_step_attempt(a, s_at, t_cls, jt, qt, mode);
  __syncthreads();
  int nstar;
  bool clean;
  vtt_core(a, s_at, sh, nstar, clean);
  if (tid == 0) {
    VttJournal jr{false, 0};
    const int nv = nstar >= 0 ? vtt_apply(a, s_at, nstar, jr) : 0;
    out[0] = nstar >= 0;
    out[1] = nstar >= 0 ? nstar : 0;
    out[2] = clean;
    out[3] = nv;
  }
}

// victim mask words: bit v % 32 of word v / 32 is row v's eviction
static __global__ void vtt_victim_step_pack(VttVictimArgs a, int32_t* out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int nw = (int)((a.V + 31) / 32);
  if (w >= nw) return;
  uint32_t bits = 0;
  for (int b = 0; b < 32; ++b) {
    const long long v = (long long)w * 32 + b;
    if (v < a.V && a.evict_att[v] >= 0) bits |= 1u << b;
  }
  out[4 + w] = (int32_t)bits;
}

extern "C" int vtt_victim_step(const VttVictimArgs* args, int t_cls, int jt, int qt,
                               int mode, void* out, void* stream) {
  const VttVictimArgs a = *args;
  if (a.R < 2 || a.R > VTT_MAX_R || mode < 0 || mode > 2 || jt < 0 || jt >= a.J ||
      t_cls < 0 || t_cls >= a.C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_victim_setup(a, mode == 2 ? VTT_EV_RECLAIM : VTT_EV_PREEMPT, s);
  if (err) return err;
  int32_t* o = (int32_t*)out;
  VTT_LAUNCH(vtt_victim_step_kernel, 1, VTT_VICTIM_THREADS, 0, s)(a, t_cls, jt, qt, mode, o);
  const int nw = (int)((a.V + 31) / 32);
  VTT_LAUNCH(vtt_victim_step_pack, (nw + 255) / 256, 256, 0, s)(a, o);
  return (int)cudaGetLastError();
}

// ---- K12b: the victim solve on node blocks -------------------------------

// one block's core over its own rows, as a record
__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_vb_core(VttVictimArgs a, int t_cls, int jt, int qt, int mode, int32_t* rec) {
  __shared__ VttCoreShared sh;
  __shared__ VttAttempt s_at;
  if (threadIdx.x == 0) vtt_step_attempt(a, s_at, t_cls, jt, qt, mode);
  __syncthreads();
  vtt_core_scan(a, s_at, sh);
  if (threadIdx.x == 0) vtt_core_record(a, sh, rec);
}

// the replicated merge and apply over the S exchanged records (`a`: the
// process's replicated arguments, N the mesh's rows)
__global__ void __launch_bounds__(VTT_VICTIM_THREADS)
    vtt_vb_merge(VttVictimArgs a, int t_cls, int jt, int qt, int mode, const int32_t* recv,
                 int S, int32_t* out, float* vsum) {
  __shared__ VttAttempt s_at;
  __shared__ int s_nstar, s_clean, s_m;
  const int tid = threadIdx.x;
  const int R = (int)a.R, Q = (int)a.Q;
  if (tid == 0) {
    vtt_step_attempt(a, s_at, t_cls, jt, qt, mode);
    int ic;
    bool clean;
    vtt_merge_records(recv, S, ic, clean);
    s_nstar = ic;
    s_clean = clean;
  }
  __syncthreads();
  const int nstar = s_nstar;
  int nv = 0;
  if (nstar >= 0) {
    // nstar's live rows, then their ranks in the node's orders
    const int m = vtt_gather_node(a, nstar, mode == 2 ? VTT_EV_RECLAIM : VTT_EV_PREEMPT, &s_m);
    if (tid == 0) {
      double acc[VTT_MAX_R], vs[VTT_MAX_R];
      vtt_node_flags(a, s_at, 0, m, a.l_vidx, a.l_drf, a.l_prop, a.l_ev, acc);
      VttJournal jr{false, 0};
      nv = vtt_evict_prefix(a, a.l_ev, 0, m, jr, vs);
      for (int r = 0; r < R; ++r) {
        const size_t jr_ = (size_t)jt * R + r;
        a.job_alloc[jr_] = a.job_alloc[jr_] + s_at.req[r];
        if (qt >= 0) {
          const size_t qr = (size_t)min(qt, Q - 1) * R + r;
          a.queue_alloc[qr] = a.queue_alloc[qr] + s_at.req[r];
        }
        vsum[r] = (float)vs[r];
      }
    }
  }
  if (tid == 0) {
    out[0] = nstar >= 0;
    out[1] = nstar >= 0 ? nstar : 0;
    out[2] = s_clean;
    out[3] = nv;
  }
}

// the owner block's node rows: the preemptor pipelined on nstar
static __global__ void vtt_vb_own(VttVictimArgs a, const int32_t* out, const float* vsum) {
  if (!out[0]) return;
  const int n = out[1] - (int)a.n0;
  if (n < 0 || n >= a.N) return;
  const int R = (int)a.R;
  for (int r = 0; r < R; ++r) {
    const size_t nr = (size_t)n * R + r;
    a.releasing[nr] = a.releasing[nr] + (vsum[r] - a.task_req[r]);
    a.used[nr] = a.used[nr] + a.task_req[r];
  }
  a.task_count[n] = a.task_count[n] + 1;
}

static inline bool vtt_vb_ok(const VttVictimArgs& a, int t_cls, int jt, int mode) {
  return a.R >= 2 && a.R <= VTT_MAX_R && mode >= 0 && mode <= 2 && jt >= 0 && jt < a.J &&
         t_cls >= 0 && t_cls < a.C;
}

// First half of a K12b solve: each local block's setup and core, its record
// into `send` [n_blocks, VTT_VB_WORDS].  Each block's node_fill must be zero.
extern "C" int vtt_victim_blocks_core(const VttVictimArgs* blocks, int n_blocks, int t_cls,
                                      int jt, int qt, int mode, void* send, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* rec = (int32_t*)send;
  for (int b = 0; b < n_blocks; ++b) {
    const VttVictimArgs& a = blocks[b];
    if (!vtt_vb_ok(a, t_cls, jt, mode)) return (int)cudaErrorInvalidValue;
    int err = vtt_victim_setup(a, mode == 2 ? VTT_EV_RECLAIM : VTT_EV_PREEMPT, s);
    if (err) return err;
    VTT_LAUNCH(vtt_vb_core, 1, VTT_VICTIM_THREADS, 0, s)(a, t_cls, jt, qt, mode,
                                                          rec + (size_t)b * VTT_VB_WORDS);
  }
  return (int)cudaGetLastError();
}

// Second half, after the exchange filled `recv` [S, VTT_VB_WORDS]: the
// replicated merge and apply, the owner's node rows, the packed decision
// into `out` [4 + ceil(V / 32)]; `vsum` is [R] float scratch.
extern "C" int vtt_victim_blocks_apply(const VttVictimArgs* base, const VttVictimArgs* blocks,
                                       int n_blocks, int t_cls, int jt, int qt, int mode,
                                       const void* recv, int S, void* out, void* vsum,
                                       void* stream) {
  const VttVictimArgs& a = *base;
  if (!vtt_vb_ok(a, t_cls, jt, mode) || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* o = (int32_t*)out;
  float* vf = (float*)vsum;
  VTT_LAUNCH(vtt_vb_merge, 1, VTT_VICTIM_THREADS, 0, s)(a, t_cls, jt, qt, mode,
                                                        (const int32_t*)recv, S, o, vf);
  for (int b = 0; b < n_blocks; ++b) VTT_LAUNCH(vtt_vb_own, 1, 1, 0, s)(blocks[b], o, vf);
  const int nw = (int)((a.V + 31) / 32);
  VTT_LAUNCH(vtt_victim_step_pack, (nw + 255) / 256, 256, 0, s)(a, o);
  return (int)cudaGetLastError();
}

// ---- K15a / K15b: a walk's pending attempt, one core per block -----------

// One CTA a local block (`blocks` in device memory): the block's core over
// its own rows for the attempt the walk left, as a record into its slot.
__global__ void __launch_bounds__(VTT_VICTIM_THREADS) vtt_wb_core(const VttVictimArgs* blocks) {
  __shared__ VttCoreShared sh;
  __shared__ VttAttempt s_at;
  __shared__ VttVictimArgs s_a;
  if (threadIdx.x == 0) {
    s_a = blocks[blockIdx.x];
    s_at = ((const VttWalk*)s_a.walk)->at;
  }
  __syncthreads();
  vtt_core_scan(s_a, s_at, sh);
  if (threadIdx.x == 0) vtt_core_record(s_a, sh, s_a.send);
}

// The cores of the pending attempt of a K15a / K15b walk: every local
// block's record into its slot of the send buffer (`dblk`: the L blocks'
// arguments in device memory).
extern "C" int vtt_walk_blocks_core(const VttVictimArgs* dblk, int n_blocks, void* stream) {
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  VTT_LAUNCH(vtt_wb_core, n_blocks, VTT_VICTIM_THREADS, 0, (cudaStream_t)stream)(dblk);
  return (int)cudaGetLastError();
}
