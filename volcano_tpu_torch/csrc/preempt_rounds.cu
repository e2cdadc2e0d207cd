// K10: batched preempt rounds; K15c: the same rounds with the node planes
// in blocks.  One code path: K10 is the case of one block.
//
// Replaces volcano_tpu/scheduler/victim_kernels.py:830 `preempt_rounds`
// (exact top-K at :1062): rounds of parallel victim-capacity placement for
// storms wider than fast_victims.CONTENTION_BATCH_THRESHOLD.  Each round:
// candidate analysis over the pool (conformance, gang eviction budgets, the
// DRF test at each queue's largest preemptor share), per-(node, queue)
// capacity curves, the top-M jobs proposing their next P tasks over their
// K best nodes, (node, queue, rank) prefix checks, gang all-or-nothing
// commit, and victims materialised at round end.  K15c replaces it under a
// mesh with solveMode: batch (volcano_tpu/scheduler/fast_victims.py:148-163:
// node planes in S blocks of rows, the [V] pool replicated).
//
// What bounds it on the H100: no stage comes near the card's rates.  Once a
// solve, the gang budgets' within-job count compares each live row with
// every row of its job's bucket, sum over jobs of (bucket rows x live rows)
// compares, spread over the card; per round, the [M, N] score pass (M = 128
// jobs x N nodes, ~40 bytes and ~40 flops a cell from L2) and the accept's
// one-CTA sort of F = M * P proposals; the rest is launches, barriers and
// the host's read of the control block between rounds, so a round is bound
// by its launches and the solve by its round count.  Design:
//   * the host runs the round loop: vtt_rounds_candidates, the exchange of
//     the blocks' records, vtt_rounds_decide, the exchange of the blocks'
//     victim sums, vtt_rounds_finish, which leaves a 48-byte control block
//     on the host (active jobs, progress, round count);
//   * once a solve: each block's pool rows grouped by node
//     (victim_common.cuh); the whole pool bucketed by job, padding rows
//     included as the reference counts them (vtt_r_job_count, vtt_v_scan,
//     vtt_r_job_bucket, warp-aggregated atomics), each job's live rows first
//     and each entry's eviction-order key gathered once into two 64-bit
//     words (node, queue | priority, -rank; the pool index last), so no
//     comparison reads through run_job -> job_queue; then the within-job
//     count: work items of (tile of VTT_CNT_TILE bucket entries) x (chunk of
//     VTT_CNT_ROWS live rows) per job (vtt_r_count_items, vtt_v_scan into
//     item_off), which vtt_r_count_tiles deals to warps over the card: the
//     tile in registers, each live row broadcast in turn, the entries before
//     it counted by ballots, the partial counts added with integer atomics
//     (exact in any order).  No thread walks more than one tile of a
//     bucket, so a padded job-0 bucket or a large gang spreads over many
//     warps instead of one thread's chain of dependent loads;
//   * per block, over its own rows: vtt_r_analysis and vtt_r_victims give
//     each node to one thread, which walks the node's rows in (queue,
//     priority, rank) order with float64 running sums per (node, queue)
//     cell; vtt_r_tiles runs one CTA per (selected job, tile of TILE
//     nodes) and keeps the tile's exact top-K in lax.top_k's order;
//     vtt_r_pack merges a job's tiles into the block's top-K and packs each
//     as a record (value, node, predicate bit, task count, pod cap and the
//     (node, queue) cell's capacity): the union of the blocks' top-Ks holds
//     the global one (PR 6's tile argument);
//   * replicated, on the gathered records: the select is K3's top-M by
//     chunks (common.cuh vtt_sel_*: vtt_r_sel_chunk sorts each chunk of
//     VTT_SEL_CHUNK jobs in shared memory, vtt_r_sel_merge ranks each kept
//     job by binary searches, vtt_r_sel_place writes sel), on the float keys
//     and the job index, as the count over all pairs of jobs it replaces
//     ordered them; vtt_r_propose merges the S blocks' records into the
//     job's top-K and writes its P proposals, each with its node's record;
//     vtt_r_accept is one CTA: a bitonic sort of the proposals by (cell,
//     rank), one thread per cell for the running sums against the records,
//     one per job for the prefix and gang commit, a warp per queue for the
//     queue sums;
//   * vtt_r_grant: each block takes the granted capacity of its own cells
//     from the accept's order; vtt_r_victims evicts on its own nodes.
//   Cross-node sums (victims per job and queue, their count, the evicted
//   rows) are per block: float64 atomics of whole numbers, exact in any
//   order, into the block's partial row [W2]; the rows travel in a second
//   exchange a round and vtt_r_finish adds them in block order, so every
//   block count gives the one-block outputs bit for bit.  On one device
//   both exchanges are the buffers the blocks wrote.
#include <atomic>

#include "victim_common.cuh"

#define VTT_R_PROPOSE_THREADS 256
#define VTT_R_ACCEPT_THREADS 1024
#define VTT_R_WIDE_THREADS 256
#define VTT_R_MAX_PK 32
#define VTT_CNT_TILE 256  // bucket entries a count item holds (8 a lane;
                          // victim_kernels.ROUNDS_COUNT_TILE)
#define VTT_CNT_ROWS 32   // live rows a count item counts (one a lane)
#define VTT_CNT_THREADS 256
#define VTT_CNT_CTAS_PER_SM 8
#define VTT_MAX_DEVICES 64  // devices whose SM count is kept

// p_flags bits
#define RF_VALID 1
#define RF_WIN0 2
#define RF_WIN 4

__device__ __forceinline__ int vtt_f2ord(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float vtt_ord2f(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

#define FULL_MASK 0xffffffffu

// The lanes of a warp whose `key` (>= 0) is equal take consecutive slots
// of the counter ctr(key) with one atomicAdd; a lane with key < 0 takes
// none.  Every lane of the warp calls it.
template <class Ctr>
__device__ __forceinline__ int vtt_warp_slot(int key, Ctr ctr) {
  const unsigned peers = __match_any_sync(FULL_MASK, key);
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == leader) base = atomicAdd(ctr(key), __popc(peers));
  base = __shfl_sync(FULL_MASK, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// per job: its pool rows (job_fill[j]) and its live rows (job_fill[J + j])
__global__ void vtt_r_job_count(VttVictimArgs a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int J = (int)a.J;
  const bool in = v < a.V;
  const int j = in ? vtt_clamp(a.run_job[v], 0, J - 1) : -1;
  vtt_warp_slot(j, [&](int k) { return &a.job_fill[k]; });
  vtt_warp_slot(in && a.run_live[v] ? j : -1, [&](int k) { return &a.job_fill[J + k]; });
}

// Each pool row into its job's bucket, the live rows first (job_fill[j],
// zeroed by the scan, counts them from the front; job_fill[2J + j] the
// others from the back), with its key in the global eviction order
// (node, queue, priority, -rank) as two words that compare as unsigned
// integers: each field's sign bit flipped, the queue clamped as the
// per-node order clamps it, the priority 0 when order_by_priority is off.
// The pool index, the last key, is the bucket entry itself.
__global__ void vtt_r_job_bucket(VttVictimArgs a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  const int J = (int)a.J;
  const bool in = v < a.V;
  const int j = in ? vtt_clamp(a.run_job[v], 0, J - 1) : -1;
  const bool live = in && a.run_live[v];
  const int slot = vtt_warp_slot(!in ? -1 : live ? j : J + j, [&](int k) {
    return k < J ? &a.job_fill[k] : &a.job_fill[J + k];
  });
  if (!in) return;
  const int pos = live ? a.job_off[j] + slot : a.job_off[j + 1] - 1 - slot;
  const uint32_t q = (uint32_t)vtt_clamp(vtt_row_queue(a, v), 0, (int)a.Q - 1);
  const uint32_t prio = a.order_by_priority ? (uint32_t)a.run_prio[v] : 0u;
  const uint32_t neg_rank = 0u - (uint32_t)a.run_rank[v];
  a.job_key[2 * (size_t)pos] =
      ((unsigned long long)((uint32_t)a.run_node[v] ^ 0x80000000u) << 32) | q;
  a.job_key[2 * (size_t)pos + 1] =
      ((unsigned long long)(prio ^ 0x80000000u) << 32) | (neg_rank ^ 0x80000000u);
  a.job_bucket[pos] = v;
}

// The within-job count's work items of job j: (tile of VTT_CNT_TILE
// bucket entries) x (chunk of VTT_CNT_ROWS live rows), none without live
// rows; into job_fill[2J + j], which vtt_v_scan turns into item_off.
__global__ void vtt_r_count_items(VttVictimArgs a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int J = (int)a.J;
  if (j >= J) return;
  const int B = a.job_off[j + 1] - a.job_off[j], L = a.job_fill[J + j];
  a.job_fill[2 * J + j] = L ? ((B + VTT_CNT_TILE - 1) / VTT_CNT_TILE) *
                                  ((L + VTT_CNT_ROWS - 1) / VTT_CNT_ROWS)
                            : 0;
}

// Each live row's rank within its job in the global eviction order,
// counted over every pool row of the job (padding rows included, as the
// reference counts them).  A warp takes one work item at a time over the
// card: the item's tile of the job's bucket in registers (8 entries a
// lane), each of its up to 32 live rows in turn broadcast from the lane
// that holds it, the entries before it counted by ballots; the row's lane
// adds the count into cnt_in_job (integer atomics, exact in any order).
// No lane compares more than one tile's entries against a row.
__global__ void __launch_bounds__(VTT_CNT_THREADS) vtt_r_count_tiles(VttVictimArgs a) {
  constexpr int PER_LANE = VTT_CNT_TILE / 32;
  const int J = (int)a.J, lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * (blockDim.x >> 5);
  const int total = a.item_off[J];
  for (int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < total; w += n_warps) {
    // the item's job: the last j with item_off[j] <= w
    int lo = 0, hi = J - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.item_off[mid] <= w)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int j = lo;
    const int off = a.job_off[j], B = a.job_off[j + 1] - off, L = a.job_fill[J + j];
    const int n_chunks = (L + VTT_CNT_ROWS - 1) / VTT_CNT_ROWS;
    const int item = w - a.item_off[j], t = item / n_chunks, c = item - t * n_chunks;
    const int e0 = off + t * VTT_CNT_TILE, e1 = off + min(B, (t + 1) * VTT_CNT_TILE);
    // past the tile: a key above every real one (a real queue word is < 2^31)
    unsigned long long k0[PER_LANE], k1[PER_LANE];
    int kv[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = e0 + i * 32 + lane;
      const bool in = e < e1;
      k0[i] = in ? a.job_key[2 * (size_t)e] : ~0ull;
      k1[i] = in ? a.job_key[2 * (size_t)e + 1] : ~0ull;
      kv[i] = in ? a.job_bucket[e] : 0x7fffffff;
    }
    const int r = c * VTT_CNT_ROWS + lane, rows = min(VTT_CNT_ROWS, L - c * VTT_CNT_ROWS);
    const bool mine = lane < rows;
    const unsigned long long r0 = mine ? a.job_key[2 * (size_t)(off + r)] : 0ull;
    const unsigned long long r1 = mine ? a.job_key[2 * (size_t)(off + r) + 1] : 0ull;
    const int rv = mine ? a.job_bucket[off + r] : 0;
    int cnt = 0;
    for (int x = 0; x < rows; ++x) {
      const unsigned long long x0 = __shfl_sync(FULL_MASK, r0, x);
      const unsigned long long x1 = __shfl_sync(FULL_MASK, r1, x);
      const int xv = __shfl_sync(FULL_MASK, rv, x);
      int n = 0;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const bool before =
            k0[i] < x0 || (k0[i] == x0 && (k1[i] < x1 || (k1[i] == x1 && kv[i] < xv)));
        n += __popc(__ballot_sync(FULL_MASK, before));
      }
      if (lane == x) cnt = n;
    }
    if (mine && cnt) atomicAdd(&a.cnt_in_job[rv], cnt);
  }
}

__global__ void vtt_r_init(VttVictimArgs a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < a.Q) {
    a.act_q[q] = 0;
    a.ls_q[q] = vtt_f2ord(VTT_NEG_INF);
  }
  if (q == 0) {
    for (int i = 0; i < 16; ++i) a.ctl[i] = 0;
    a.ctl[VC_PROGRESS] = 1;
  }
}

// round start: active jobs, their rank keys, act_q and ls_q
__global__ void vtt_r_start(VttVictimArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int J = (int)a.J, Q = (int)a.Q, T = (int)a.T, R = (int)a.R;
  if (idx < a.M) a.sel[idx] = -1;
  if (idx >= J) return;
  const int j = idx;
  const bool active = a.job_avail[j] && !a.dropped[j] && a.cursor[j] < a.job_pcount[j];
  a.job_active[j] = active ? 1 : 0;
  const int codes[3] = {(int)a.key0, (int)a.key1, (int)a.key2};
  for (int i = 0; i < a.n_keys; ++i) a.job_keys[(size_t)j * 4 + i] = vtt_vjob_key(a, codes[i], j);
  if (!active) return;
  atomicAdd(&a.ctl[VC_ACTIVE], 1);
  const int jq = a.job_queue[j];
  const int qc = vtt_clamp(jq, 0, Q - 1);
  if (jq >= 0) atomicOr(&a.act_q[qc], 1);
  if (a.use_drf) {
    const int head = vtt_clamp(a.rows_packed[vtt_clamp(a.job_pstart[j] + a.cursor[j], 0, T - 1)],
                               0, T - 1);
    float sum[VTT_MAX_R];
    for (int r = 0; r < R; ++r)
      sum[r] = a.job_alloc[(size_t)j * R + r] + a.task_req[(size_t)head * R + r];
    atomicMax(&a.ls_q[qc], vtt_f2ord(vtt_dominant_share(sum, a.total, R)));
  }
}

// one thread per node: candidate flags and the (node, queue) capacity curve
__global__ void vtt_r_analysis(VttVictimArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = (int)a.N, Q = (int)a.Q, R = (int)a.R;
  if (n >= N) return;
  for (int i = 0; i < Q * R; ++i) {
    a.cap_flat[(size_t)n * Q * R + i] = 0.0f;
    a.cons_flat[(size_t)n * Q * R + i] = 0.0f;
  }
  for (int r = 0; r < R; ++r) a.cons_node[(size_t)n * R + r] = 0.0;
  a.placed[n] = 0;
  const int off = a.node_off[n], end = a.node_off[n + 1];
  double acc[VTT_MAX_R];
  float part[VTT_MAX_R];
  if (a.use_drf) {
    // hypothetical transfer per (node, job) against the queue's largest
    // preemptor share (conservative)
    int pj = -1;
    for (int i = off; i < end; ++i) {
      const int v = a.l_drf[i];
      const int j = a.run_job[v];
      const int rq = a.job_queue[j];
      const int q = vtt_clamp(rq, 0, Q - 1);
      if (j != pj) {
        for (int r = 0; r < R; ++r) acc[r] = 0.0;
        pj = j;
      }
      if (a.run_live[v] && a.act_q[q] && rq >= 0)
        for (int r = 0; r < R; ++r) acc[r] += (double)a.run_req[(size_t)v * R + r];
      for (int r = 0; r < R; ++r) part[r] = a.job_alloc[(size_t)j * R + r] - (float)acc[r];
      const float rs = vtt_dominant_share(part, a.total, R);
      const bool admit = rq >= 0 && vtt_ord2f(a.ls_q[q]) < rs + 1e-6f;
      a.flag[v] = admit ? VF_ADMIT : 0;
    }
  }
  int pq = -1;
  for (int i = off; i < end; ++i) {
    const int v = a.l_ev[i];
    const int j = a.run_job[v];
    const int rq = a.job_queue[j];
    const int q = vtt_clamp(rq, 0, Q - 1);
    if (q != pq) {
      for (int r = 0; r < R; ++r) acc[r] = 0.0;
      pq = q;
    }
    bool c = a.run_live[v] && a.act_q[q] && rq >= 0 && !a.job_avail[j];
    if (a.use_conformance) c = c && a.run_evictable[v];
    if (a.use_gang) {
      const int jm = a.job_min[j];
      const long long budget = jm > 1 ? (long long)a.job_occupied[j] - jm : 2147483647LL;
      c = c && (long long)a.cnt_in_job[v] < budget;
    }
    if (a.use_drf) c = c && (a.flag[v] & VF_ADMIT);
    a.flag[v] = c ? VF_CAND : 0;
    if (c)
      for (int r = 0; r < R; ++r) acc[r] += (double)a.run_req[(size_t)v * R + r];
    if (i + 1 == end || vtt_clamp(vtt_row_queue(a, a.l_ev[i + 1]), 0, Q - 1) != q)
      for (int r = 0; r < R; ++r) a.cap_flat[((size_t)n * Q + q) * R + r] = (float)acc[r];
  }
}

// The select (common.cuh vtt_sel_*): sel[r] = the active job of rank r < M
// in the session order (n_keys float keys, then the job index).
__device__ __forceinline__ VttSel vtt_r_sel(const VttVictimArgs& a) {
  return VttSel{a.job_active, a.job_keys, a.sel, a.c_key, a.c_job, a.c_rank, a.c_cnt,
                nullptr, (int)a.J, (int)a.M, (int)a.n_keys, (int)a.nC};
}

__global__ void __launch_bounds__(VTT_SEL_THREADS) vtt_r_sel_chunk(VttVictimArgs a) {
  vtt_sel_chunk(vtt_r_sel(a));
}

__global__ void __launch_bounds__(VTT_R_WIDE_THREADS) vtt_r_sel_merge(VttVictimArgs a) {
  vtt_sel_merge(vtt_r_sel(a));
}

__global__ void __launch_bounds__(VTT_R_WIDE_THREADS) vtt_r_sel_place(VttVictimArgs a) {
  vtt_sel_place(vtt_r_sel(a));
}

// The selected job m's head task row, its request, class and queue.
struct VttRHead {
  int j, cur, head, cls, q;
  float req[VTT_MAX_R];
};

__device__ __forceinline__ VttRHead vtt_r_head(const VttVictimArgs& a, int m) {
  VttRHead h;
  h.j = a.sel[m];
  if (h.j < 0) return h;
  const int T = (int)a.T;
  h.cur = a.cursor[h.j];
  h.head = vtt_clamp(a.rows_packed[vtt_clamp(a.job_pstart[h.j] + h.cur, 0, T - 1)], 0, T - 1);
  for (int r = 0; r < a.R; ++r) h.req[r] = a.task_req[(size_t)h.head * a.R + r];
  h.cls = a.task_class[h.head];
  h.q = vtt_clamp(a.job_queue[h.j], 0, (int)a.Q - 1);
  return h;
}

// one CTA per (selected job, tile of TILE of the block's nodes): the head
// task's scores over the tile in shared memory, the tile's exact top-K
// (global node rows)
__global__ void __launch_bounds__(VTT_R_PROPOSE_THREADS) vtt_r_tiles(VttVictimArgs a) {
  VTT_DYN_SMEM(float, s_val);
  __shared__ float s_v[VTT_R_PROPOSE_THREADS];
  __shared__ int s_i[VTT_R_PROPOSE_THREADS];
  __shared__ int s_p[VTT_R_PROPOSE_THREADS];
  __shared__ int s_pos[VTT_R_MAX_PK];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int m = blockIdx.x, tb = blockIdx.y;
  const VttRHead h = vtt_r_head(a, m);
  if (h.j < 0) return;
  const int N = (int)a.N, R = (int)a.R, Q = (int)a.Q, K = (int)a.K, TB = (int)a.TB;
  const int lo = tb * (int)a.TILE, hi = min(N, lo + (int)a.TILE);
  const uint8_t* cmask = a.class_mask + (size_t)h.cls * N;
  const float* cscore = a.class_score + (size_t)h.cls * N;
  const uint32_t jh = (uint32_t)h.j * 2654435761u;
  const float jscale = (float)(1e-4 / 65535.0);
  bool any_local = false;
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    const float* capn = &a.cap_flat[((size_t)n * Q + h.q) * R];
    bool feasible = cmask[n] && a.task_count[n] < a.node_max_tasks[n] && a.node_valid[n];
    for (int r = 0; r < R; ++r) feasible = feasible && h.req[r] < capn[r] + a.eps[r];
    float v = VTT_NEG_INF;
    if (feasible) {
      const float sc = vtt_score_node(h.req, &a.used[(size_t)n * R], &a.node_alloc[(size_t)n * R],
                                      cscore[n], a.w_least, a.w_balanced);
      uint32_t hh = (jh ^ ((uint32_t)(n + a.n0) * 40503u)) * 2246822519u;
      hh ^= hh >> 15;
      v = __fmaf_rn((float)(hh & 0xFFFFu), jscale, sc);
      any_local = true;
    }
    s_val[n - lo] = v;
  }
  const bool any = vtt_block_any(any_local, &s_flag);
  const size_t at = ((size_t)m * TB + tb) * K;
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        v = s_val[c];
        i = (int)a.n0 + lo + c;
      },
      hi - lo, K, s_v, s_i, s_p, a.t_val + at, a.t_idx + at, s_pos);
  if (tid == 0) a.t_any[(size_t)m * TB + tb] = any ? 1 : 0;
}

// record words (W = 5 + R): value bits, global node (INT_MAX: none), flags
// (bit 0: class mask, pod cap and validity admit; bit 1: the block has a
// feasible node for the job), task count, pod cap, the (node, job's queue)
// cell's capacity [R]
#define RR_PRED 1
#define RR_ANY 2

// one CTA per selected job, per block: the block's top-K from its tiles'
// candidates, as records into its send slot [M, K, W]
__global__ void __launch_bounds__(VTT_R_PROPOSE_THREADS) vtt_r_pack(VttVictimArgs a) {
  __shared__ float s_v[VTT_R_PROPOSE_THREADS];
  __shared__ int s_i[VTT_R_PROPOSE_THREADS];
  __shared__ int s_p[VTT_R_PROPOSE_THREADS];
  __shared__ float s_kv[VTT_R_MAX_PK];
  __shared__ int s_top[VTT_R_MAX_PK];
  __shared__ int s_kp[VTT_R_MAX_PK];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int N = (int)a.N, R = (int)a.R, Q = (int)a.Q, K = (int)a.K, TB = (int)a.TB,
            W = (int)a.W;
  int32_t* rec = a.send + (size_t)m * K * W;
  const VttRHead h = vtt_r_head(a, m);
  if (h.j < 0) {
    for (int i = tid; i < K * W; i += blockDim.x) rec[i] = 0;
    return;
  }
  bool any_local = false;
  for (int tb = tid; tb < TB; tb += blockDim.x) any_local |= a.t_any[(size_t)m * TB + tb] != 0;
  const bool any = vtt_block_any(any_local, &s_flag);
  const float* tv = a.t_val + (size_t)m * TB * K;
  const int* ti = a.t_idx + (size_t)m * TB * K;
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        v = tv[c];
        i = ti[c];
      },
      TB * K, K, s_v, s_i, s_p, s_kv, s_top, s_kp);
  if (tid < K) {
    int32_t* r = rec + (size_t)tid * W;
    const int node = s_top[tid];
    const bool real = s_kp[tid] >= 0 && node != 0x7fffffff;
    r[0] = __float_as_int(real ? s_kv[tid] : VTT_NEG_INF);
    r[1] = real ? node : 0x7fffffff;
    int flags = any ? RR_ANY : 0;
    for (int k = 3; k < W; ++k) r[k] = 0;
    if (real) {
      const int n = node - (int)a.n0;
      if (a.class_mask[(size_t)h.cls * N + n] && a.task_count[n] < a.node_max_tasks[n] &&
          a.node_valid[n])
        flags |= RR_PRED;
      r[3] = a.task_count[n];
      r[4] = a.node_max_tasks[n];
      const float* capn = &a.cap_flat[((size_t)n * Q + h.q) * R];
      for (int rr = 0; rr < R; ++rr) r[5 + rr] = __float_as_int(capn[rr]);
    }
    r[2] = flags;
  }
}

// one CTA per selected job, replicated: the job's top-K from the S blocks'
// records (a.recv [S, M, K, W]), per-target counts, its P proposals, each
// with its node's record in p_rec
__global__ void __launch_bounds__(VTT_R_PROPOSE_THREADS) vtt_r_propose(VttVictimArgs a) {
  __shared__ float s_v[VTT_R_PROPOSE_THREADS];
  __shared__ int s_i[VTT_R_PROPOSE_THREADS];
  __shared__ int s_p[VTT_R_PROPOSE_THREADS];
  __shared__ float s_kv[VTT_R_MAX_PK];
  __shared__ int s_top[VTT_R_MAX_PK];
  __shared__ int s_kp[VTT_R_MAX_PK];
  __shared__ int s_knode[VTT_R_MAX_PK];
  __shared__ int s_kpos[VTT_R_MAX_PK];
  __shared__ float s_cnt[VTT_R_MAX_PK];
  __shared__ float s_cum[VTT_R_MAX_PK];
  __shared__ int s_flag;
  const int tid = threadIdx.x;
  const int m = blockIdx.x;
  const int R = (int)a.R, T = (int)a.T, P = (int)a.P, K = (int)a.K, M = (int)a.M,
            S = (int)a.S, W = (int)a.W;
  const VttRHead h = vtt_r_head(a, m);
  if (h.j < 0) {
    for (int p = tid; p < P; p += blockDim.x) {
      const int f = m * P + p;
      a.p_flags[f] = 0;
      a.p_node[f] = 0;
      a.p_t[f] = 0;
      a.p_job[f] = -1;
    }
    return;
  }
  const int j = h.j;
  // record c of this job: block c / K, slot c % K
  auto recp = [&](int c) {
    return a.recv + (((size_t)(c / K) * M + m) * K + (size_t)(c % K)) * W;
  };
  bool any_local = false;
  for (int b = tid; b < S; b += blockDim.x) any_local |= (recp(b * K)[2] & RR_ANY) != 0;
  const bool job_ok = vtt_block_any(any_local, &s_flag);
  vtt_block_topk(
      [&](int c, float& v, int& i) {
        const int32_t* r = recp(c);
        v = __int_as_float(r[0]);
        i = r[1];
      },
      S * K, K, s_v, s_i, s_p, s_kv, s_top, s_kp);
  if (tid < K) {
    const int k = tid;
    const int c = s_kp[(k + m % K) % K];
    const int32_t* r = recp(c >= 0 ? c : 0);
    const float* capk = (const float*)(r + 5);
    bool ok = c >= 0 && (r[2] & RR_PRED);
    for (int rr = 0; rr < R; ++rr) ok = ok && h.req[rr] < capk[rr] + a.eps[rr];
    float cn = VTT_POS_INF;
    for (int rr = 0; rr < R; ++rr)
      if (h.req[rr] > 0.0f)
        cn = fminf(cn, floorf((capk[rr] + a.eps[rr]) / fmaxf(h.req[rr], 1e-30f)));
    s_knode[k] = r[1];
    s_kpos[k] = c >= 0 ? c : 0;
    s_cnt[k] = ok ? fmaxf(cn, 0.0f) : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {
    float cum = 0.0f;
    for (int k = 0; k < K; ++k) {
      cum = k == 0 ? s_cnt[0] : cum + s_cnt[k];
      s_cum[k] = cum;
    }
  }
  __syncthreads();
  if (tid < P) {
    const int p = tid;
    const int f = m * P + p;
    int slot = 0;
    for (int k = 0; k < K; ++k) slot += ((float)p >= s_cum[k]) ? 1 : 0;
    const bool in_range = slot < K;
    const bool valid = job_ok && h.cur + p < a.job_pcount[j] && in_range;
    const int t = a.rows_packed[vtt_clamp(a.job_pstart[j] + h.cur + p, 0, T - 1)];
    const int sl = slot < K ? slot : K - 1;
    a.p_node[f] = s_knode[sl];
    a.p_t[f] = vtt_clamp(t, 0, T - 1);
    a.p_job[f] = j;
    a.p_flags[f] = valid ? RF_VALID : 0;
    const int32_t* r = recp(s_kpos[sl]);
    for (int w = 0; w < W; ++w) a.p_rec[(size_t)f * W + w] = r[w];
  }
}

// one CTA, replicated: (cell, rank) order (kept in p_key), capacity and
// pod-cap prefix checks against the proposals' records, per-job prefix and
// gang commit, the job and queue updates
__global__ void __launch_bounds__(VTT_R_ACCEPT_THREADS)
    vtt_r_accept(VttVictimArgs a, int Fp2) {
  VTT_DYN_SMEM(unsigned long long, s_key);
  __shared__ int s_flag;
  __shared__ int s_sum[VTT_R_ACCEPT_THREADS];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int N = (int)a.N, R = (int)a.R, Q = (int)a.Q, M = (int)a.M, P = (int)a.P,
            F = (int)a.F, W = (int)a.W;
  const unsigned long long NQ = (unsigned long long)N * Q;
  const int att = a.ctl[VC_ATT];

  for (int i = tid; i < Fp2; i += nthr) {
    if (i < F) {
      const bool valid = a.p_flags[i] & RF_VALID;
      const unsigned long long kf =
          valid ? (unsigned long long)a.p_node[i] * Q +
                      vtt_clamp(a.job_queue[a.p_job[i]], 0, Q - 1)
                : NQ;
      s_key[i] = (kf << 32) | (unsigned)i;
    } else {
      s_key[i] = ~0ull;
    }
  }
  __syncthreads();
  for (int k = 2; k <= Fp2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = tid; i < Fp2; i += nthr) {
        const int ixj = i ^ jj;
        if (ixj > i) {
          const unsigned long long x = s_key[i], y = s_key[ixj];
          const bool up = (i & k) == 0;
          if (up ? x > y : x < y) {
            s_key[i] = y;
            s_key[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < F; i += nthr) a.p_key[i] = s_key[i];
  // running request sums per cell against its capacity, and the pod cap,
  // from the record of the cell's node (every proposal of a cell has it)
  for (int i = tid; i < F; i += nthr) {
    const unsigned long long kf = s_key[i] >> 32;
    if (kf >= NQ || (i > 0 && (s_key[i - 1] >> 32) == kf)) continue;
    const int32_t* pr = a.p_rec + (size_t)(s_key[i] & 0xffffffffu) * W;
    const float* cap = (const float*)(pr + 5);
    double acc[VTT_MAX_R];
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    long long pos = 0;
    for (int i2 = i; i2 < F && (s_key[i2] >> 32) == kf; ++i2, ++pos) {
      const int f = (int)(s_key[i2] & 0xffffffffu);
      const float* rq = &a.task_req[(size_t)a.p_t[f] * R];
      bool ok = true;
      for (int r = 0; r < R; ++r) {
        acc[r] += (double)rq[r];
        ok = ok && (float)acc[r] < cap[r] + a.eps[r];
      }
      if (ok && (long long)pr[3] + pos < (long long)pr[4]) a.p_flags[f] |= RF_WIN0;
    }
  }
  __syncthreads();
  // wins must be an offset prefix per job, and a gang short of pipelined
  // must win its whole remaining need in this round
  bool any_local = false;
  int wins_local = 0, sel_local = 0;
  for (int m = tid; m < M; m += nthr) {
    const int j = a.sel[m];
    if (j < 0) continue;
    ++sel_local;
    const int need = a.gang_pipelined
                         ? max(a.job_min[j] - a.job_occupied[j] - a.pipe[j], 0)
                         : 0;
    int wins = 0;
    for (int p = 0; p < P; ++p) {
      const uint8_t fl = a.p_flags[m * P + p];
      if (!((fl & RF_VALID) && (fl & RF_WIN0))) break;
      ++wins;
    }
    if (wins < need || wins == 0) continue;
    double acc[VTT_MAX_R];
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    for (int p = 0; p < wins; ++p) {
      const int f = m * P + p;
      a.p_flags[f] |= RF_WIN;
      const int t = a.p_t[f];
      for (int r = 0; r < R; ++r) acc[r] += (double)a.task_req[(size_t)t * R + r];
      a.pipe_node[t] = a.p_node[f];
      a.pipe_att[t] = att + f;
    }
    for (int r = 0; r < R; ++r)
      a.job_alloc[(size_t)j * R + r] = a.job_alloc[(size_t)j * R + r] + (float)acc[r];
    a.pipe[j] += wins;
    a.cursor[j] += wins;
    any_local = true;
    wins_local += wins;
  }
  const bool any_win = vtt_block_any(any_local, &s_flag);
  const int wins_total = vtt_block_sum(wins_local, s_sum);
  const int n_sel = vtt_block_sum(sel_local, s_sum);
  // the winners' requests per queue: a warp a queue, its lanes over the
  // proposals, float64 sums of whole numbers (exact in any order), rounded
  // once into the queue's float32 row
  const int lane = tid & 31;
  for (int q = tid >> 5; q < Q; q += nthr >> 5) {
    double acc[VTT_MAX_R];
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    for (int f = lane; f < F; f += 32) {
      if (!(a.p_flags[f] & RF_WIN) || vtt_clamp(a.job_queue[a.p_job[f]], 0, Q - 1) != q) continue;
      for (int r = 0; r < R; ++r) acc[r] += (double)a.task_req[(size_t)a.p_t[f] * R + r];
    }
    for (int r = 0; r < R; ++r) {
      double x = acc[r];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(FULL_MASK, x, o);
      if (lane == 0)
        a.queue_alloc[(size_t)q * R + r] = a.queue_alloc[(size_t)q * R + r] + (float)x;
    }
  }
  if (!any_win)
    for (int m = tid; m < M; m += nthr)
      if (a.sel[m] >= 0) a.dropped[a.sel[m]] = 1;
  if (tid == 0) {
    a.ctl[VC_ANY_WIN] = any_win ? 1 : 0;
    a.ctl[VC_ATT_TOTAL] += wins_total;
    a.ctl[VC_PROGRESS] = (any_win || n_sel > 0) ? 1 : 0;
  }
}

// one CTA per block: the granted capacity of the block's own cells, from
// the accept's (cell, rank) order, and per node its sum and placements
__global__ void __launch_bounds__(VTT_R_ACCEPT_THREADS) vtt_r_grant(VttVictimArgs a) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int N = (int)a.N, R = (int)a.R, Q = (int)a.Q, F = (int)a.F;
  const unsigned long long NQ = (unsigned long long)(a.NT > 0 ? a.NT : a.N) * Q;
  for (int i = tid; i < F; i += nthr) {
    const unsigned long long kf = a.p_key[i] >> 32;
    if (kf >= NQ || (i > 0 && (a.p_key[i - 1] >> 32) == kf)) continue;
    const int n = (int)(kf / Q) - (int)a.n0, q = (int)(kf % Q);
    if (n < 0 || n >= N) continue;
    double acc[VTT_MAX_R];
    for (int r = 0; r < R; ++r) acc[r] = 0.0;
    int cnt = 0;
    for (int i2 = i; i2 < F && (a.p_key[i2] >> 32) == kf; ++i2) {
      const int f = (int)(a.p_key[i2] & 0xffffffffu);
      if (!(a.p_flags[f] & RF_WIN)) continue;
      ++cnt;
      for (int r = 0; r < R; ++r) acc[r] += (double)a.task_req[(size_t)a.p_t[f] * R + r];
    }
    for (int r = 0; r < R; ++r) {
      a.cons_flat[((size_t)n * Q + q) * R + r] = (float)acc[r];
      if (cnt) atomicAdd(&a.cons_node[(size_t)n * R + r], acc[r]);
    }
    if (cnt) atomicAdd(&a.placed[n], cnt);
  }
}

// a block's partial row [W2] (doubles): victims' request per job [J, R], per
// queue [Q, R], victims per job [J], the victim count, then the evicted
// rows as a bit mask of ceil(V / 32) words
__device__ __forceinline__ size_t vtt_r_mask_at(const VttVictimArgs& a) {
  return (size_t)a.J * a.R + (size_t)a.Q * a.R + (size_t)a.J + 1;
}

// one thread per node of the block: the minimal admitted eviction-order
// prefix of each (node, queue) cell that covers the cell's granted
// capacity; the node's rows, and the victims into the block's partial row
__global__ void vtt_r_victims(VttVictimArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int N = (int)a.N, Q = (int)a.Q, R = (int)a.R, J = (int)a.J;
  if (n >= N) return;
  double* pj = a.part;
  double* pq = pj + (size_t)J * R;
  double* pc = pq + (size_t)Q * R;
  uint32_t* mask = (uint32_t*)(a.part + vtt_r_mask_at(a));
  const int off = a.node_off[n], end = a.node_off[n + 1];
  double acc[VTT_MAX_R], vn[VTT_MAX_R];
  float excl[VTT_MAX_R];
  for (int r = 0; r < R; ++r) vn[r] = 0.0;
  int pq_ = -1, nv = 0;
  for (int i = off; i < end; ++i) {
    const int v = a.l_ev[i];
    const int j = a.run_job[v];
    const int rq = a.job_queue[j];
    const int q = vtt_clamp(rq, 0, Q - 1);
    if (q != pq_) {
      for (int r = 0; r < R; ++r) acc[r] = 0.0;
      pq_ = q;
    }
    if (!(a.flag[v] & VF_CAND)) continue;
    const float* rqv = &a.run_req[(size_t)v * R];
    for (int r = 0; r < R; ++r) {
      acc[r] += (double)rqv[r];
      excl[r] = (float)acc[r] - rqv[r];
    }
    if (vtt_less_equal(&a.cons_flat[((size_t)n * Q + q) * R], excl, a.eps, R)) continue;
    atomicOr(&mask[v >> 5], 1u << (v & 31));
    ++nv;
    for (int r = 0; r < R; ++r) {
      vn[r] += (double)rqv[r];
      atomicAdd(&pj[(size_t)j * R + r], (double)rqv[r]);
      if (rq >= 0) atomicAdd(&pq[(size_t)q * R + r], (double)rqv[r]);
    }
    atomicAdd(&pc[j], 1.0);
  }
  if (nv) atomicAdd(&pc[J], (double)nv);
  for (int r = 0; r < R; ++r) {
    const size_t nr = (size_t)n * R + r;
    const float cons = (float)a.cons_node[nr];
    a.releasing[nr] = (a.releasing[nr] + (float)vn[r]) - cons;
    a.used[nr] = a.used[nr] + cons;
  }
  a.task_count[n] += a.placed[n];
}

// one thread per mask word, replicated: the rows any block evicted this
// round (a.part: the S blocks' exchanged partial rows)
__global__ void vtt_r_evict(VttVictimArgs a) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= (a.V + 31) / 32) return;
  const size_t at = vtt_r_mask_at(a);
  uint32_t bits = 0;
  for (int b = 0; b < a.S; ++b)
    bits |= ((const uint32_t*)(a.part + (size_t)b * a.W2 + at))[w];
  if (!bits) return;
  const int ea = a.ctl[VC_ATT] + (int)a.F;
  for (int k = 0; k < 32; ++k) {
    const long long v = (long long)w * 32 + k;
    if (((bits >> k) & 1u) && v < a.V) {
      a.run_live[v] = 0;
      a.evict_att[v] = ea;
    }
  }
}

// round end, replicated: victims leave their jobs and queues, the S
// blocks' sums added in block order; the round's bookkeeping
__global__ void vtt_r_finish(VttVictimArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = (int)a.R, J = (int)a.J, Q = (int)a.Q, S = (int)a.S;
  const size_t W2 = (size_t)a.W2;
  const double* pj = a.part;
  const double* pq = pj + (size_t)J * R;
  const double* pc = pq + (size_t)Q * R;
  if (idx < J) {
    for (int r = 0; r < R; ++r) {
      const size_t jr = (size_t)idx * R + r;
      double sum = 0.0;
      for (int b = 0; b < S; ++b) sum += pj[b * W2 + jr];
      a.job_alloc[jr] = a.job_alloc[jr] - (float)sum;
    }
    double cnt = 0.0;
    for (int b = 0; b < S; ++b) cnt += pc[b * W2 + idx];
    a.job_occupied[idx] -= (int)cnt;
  }
  if (idx < Q) {
    for (int r = 0; r < R; ++r) {
      const size_t qr = (size_t)idx * R + r;
      double sum = 0.0;
      for (int b = 0; b < S; ++b) sum += pq[b * W2 + qr];
      a.queue_alloc[qr] = a.queue_alloc[qr] - (float)sum;
    }
    a.act_q[idx] = 0;
    a.ls_q[idx] = vtt_f2ord(VTT_NEG_INF);
  }
  if (idx == 0) {
    double nvict = 0.0;
    for (int b = 0; b < S; ++b) nvict += pc[b * W2 + J];
    const int any_win = a.ctl[VC_ANY_WIN];
    a.ctl[VC_ATT] += (int)a.F + 1;
    if (any_win) a.ctl[VC_LAST_V] = (int)nvict;
    a.ctl[VC_ANY] |= any_win;
    a.ctl[VC_ITERS] += 1;
    a.ctl[VC_ACTIVE] = 0;
  }
}

static inline int vtt_rounds_fp2(const VttVictimArgs& a) {
  int Fp2 = 1;
  while (Fp2 < a.F) Fp2 <<= 1;
  return Fp2;
}

static inline int vtt_rounds_wide_blocks(const VttVictimArgs& a) {
  int64_t wide = a.J > a.Q ? a.J : a.Q;
  if (a.M > wide) wide = a.M;
  return (int)((wide + 255) / 256);
}

// the control block (ctl[0, 12)) on the host, once the stream has drained
static inline int vtt_rounds_ctl(const VttVictimArgs& a, int32_t* ctl_out, cudaStream_t s) {
  int err = (int)cudaMemcpyAsync(ctl_out, a.ctl, 12 * sizeof(int32_t),
                                 cudaMemcpyDeviceToHost, s);
  if (!err) err = (int)cudaStreamSynchronize(s);
  return err ? err : (int)cudaGetLastError();
}

// The current device's SM count, asked of the runtime once per device.
static int vtt_sm_count(int* sms) {
  static std::atomic<int> known[VTT_MAX_DEVICES];
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < VTT_MAX_DEVICES && (*sms = known[dev].load(std::memory_order_relaxed))) return 0;
  if ((err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if (dev < VTT_MAX_DEVICES) known[dev].store(*sms, std::memory_order_relaxed);
  return 0;
}

// Begin a solve: each local block's pool rows grouped by node, the
// replicated within-job ranks, the first round's start; the control block
// into ctl_out[12].  The host then runs rounds while ctl_out says progress,
// active jobs and fewer than J + 8 rounds.  job_fill must be zero.
extern "C" int vtt_rounds_begin(const VttVictimArgs* base, const VttVictimArgs* blocks,
                                int n_blocks, int32_t* ctl_out, void* stream) {
  const VttVictimArgs& a = *base;
  if (a.R < 2 || a.R > VTT_MAX_R || a.n_keys > 3 || a.P < 1 || a.P > VTT_R_MAX_PK ||
      a.K < 1 || a.K > VTT_R_MAX_PK || a.F != a.M * a.P || a.TILE < 1 || a.TILE > 8192 ||
      a.W != 5 + a.R || a.S < 1 || n_blocks < 1 ||
      a.nC != (a.J + VTT_SEL_CHUNK - 1) / VTT_SEL_CHUNK)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < n_blocks; ++b)
    if (blocks[b].TB * blocks[b].TILE < blocks[b].N) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = vtt_blocks_setup(blocks, n_blocks, VTT_EV_ROUNDS, s);
  if (err) return err;
  if ((err = (int)cudaFuncSetAttribute(vtt_r_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(a.TILE * sizeof(float)))))
    return err;
  if ((err = (int)cudaFuncSetAttribute(vtt_r_accept, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(vtt_rounds_fp2(a) * sizeof(unsigned long long)))))
    return err;
  const int J = (int)a.J;
  const int vb = (int)((a.V + 255) / 256);
  int sms = 0;
  if ((err = vtt_sm_count(&sms))) return err;
  VTT_LAUNCH(vtt_r_job_count, vb, 256, 0, s)(a);
  VTT_LAUNCH(vtt_v_scan, 1, VTT_VICTIM_THREADS, 0, s)(a.job_fill, a.job_off, J);
  VTT_LAUNCH(vtt_r_job_bucket, vb, 256, 0, s)(a);
  VTT_LAUNCH(vtt_r_count_items, (J + 255) / 256, 256, 0, s)(a);
  VTT_LAUNCH(vtt_v_scan, 1, VTT_VICTIM_THREADS, 0, s)(a.job_fill + 2 * J, a.item_off, J);
  VTT_LAUNCH(vtt_r_count_tiles, sms * VTT_CNT_CTAS_PER_SM, VTT_CNT_THREADS, 0, s)(a);
  VTT_LAUNCH(vtt_r_init, (int)((a.Q + 255) / 256), 256, 0, s)(a);
  VTT_LAUNCH(vtt_r_start, vtt_rounds_wide_blocks(a), 256, 0, s)(a);
  return vtt_rounds_ctl(a, ctl_out, s);
}

// The first half of a round: each local block's analysis, the replicated
// rank and selection, then each block's tiles and records (into its send
// slot).
extern "C" int vtt_rounds_candidates(const VttVictimArgs* base, const VttVictimArgs* blocks,
                                     int n_blocks, void* stream) {
  const VttVictimArgs& a = *base;
  cudaStream_t s = (cudaStream_t)stream;
  for (int b = 0; b < n_blocks; ++b)
    VTT_LAUNCH(vtt_r_analysis, (int)((blocks[b].N + 255) / 256), 256, 0, s)(blocks[b]);
  const int nC = (int)a.nC;
  VTT_LAUNCH(vtt_r_sel_chunk, nC, VTT_SEL_THREADS, 0, s)(a);
  if (nC > 1) {
    const unsigned wide = (unsigned)((a.nC * a.M + VTT_R_WIDE_THREADS - 1) / VTT_R_WIDE_THREADS);
    VTT_LAUNCH(vtt_r_sel_merge, dim3(wide, (unsigned)nC), VTT_R_WIDE_THREADS, 0, s)(a);
    VTT_LAUNCH(vtt_r_sel_place, (int)wide, VTT_R_WIDE_THREADS, 0, s)(a);
  }
  for (int b = 0; b < n_blocks; ++b) {
    const VttVictimArgs& blk = blocks[b];
    VTT_LAUNCH(vtt_r_tiles, dim3((unsigned)blk.M, (unsigned)blk.TB), VTT_R_PROPOSE_THREADS,
               blk.TILE * sizeof(float), s)(blk);
    VTT_LAUNCH(vtt_r_pack, (int)blk.M, VTT_R_PROPOSE_THREADS, 0, s)(blk);
  }
  return (int)cudaGetLastError();
}

// The second half, after the exchange filled base->recv: the replicated
// proposals and accept, then each local block's grants and victims (into
// its zeroed partial row).
extern "C" int vtt_rounds_decide(const VttVictimArgs* base, const VttVictimArgs* blocks,
                                 int n_blocks, void* stream) {
  const VttVictimArgs& a = *base;
  cudaStream_t s = (cudaStream_t)stream;
  const int Fp2 = vtt_rounds_fp2(a);
  VTT_LAUNCH(vtt_r_propose, (int)a.M, VTT_R_PROPOSE_THREADS, 0, s)(a);
  VTT_LAUNCH(vtt_r_accept, 1, VTT_R_ACCEPT_THREADS, Fp2 * sizeof(unsigned long long), s)(a, Fp2);
  for (int b = 0; b < n_blocks; ++b) {
    const VttVictimArgs& blk = blocks[b];
    int err = (int)cudaMemsetAsync(blk.part, 0, (size_t)blk.W2 * sizeof(double), s);
    if (err) return err;
    VTT_LAUNCH(vtt_r_grant, 1, VTT_R_ACCEPT_THREADS, 0, s)(blk);
    VTT_LAUNCH(vtt_r_victims, (int)((blk.N + 255) / 256), 256, 0, s)(blk);
  }
  return (int)cudaGetLastError();
}

// The round's end, after the second exchange filled base->part with the S
// blocks' partial rows: the evictions and sums, then the next round's
// start; the control block into ctl_out[12].
extern "C" int vtt_rounds_finish(const VttVictimArgs* base, int32_t* ctl_out, void* stream) {
  const VttVictimArgs& a = *base;
  cudaStream_t s = (cudaStream_t)stream;
  const int wb = vtt_rounds_wide_blocks(a);
  VTT_LAUNCH(vtt_r_evict, (int)(((a.V + 31) / 32 + 255) / 256), 256, 0, s)(a);
  VTT_LAUNCH(vtt_r_finish, wb, 256, 0, s)(a);
  VTT_LAUNCH(vtt_r_start, wb, 256, 0, s)(a);
  return vtt_rounds_ctl(a, ctl_out, s);
}
