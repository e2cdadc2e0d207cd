// Shared device helpers and the argument block of the allocate solves.
//
// Float discipline (see volcano_tpu_torch/scheduler/kernels.py): the
// sources are compiled with --fmad=false, so no product is contracted into
// a fused multiply-add except where __fmaf_rn is written out — the places
// where the reference (JAX on the CPU) fuses too.  Every argmax/argmin
// breaks ties towards the lowest index.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#ifndef VTT_LAUNCH
#define VTT_LAUNCH(kernel, grid, block, smem, stream) \
  kernel<<<(grid), (block), (smem), (stream)>>>
#endif
#ifndef VTT_DYN_SMEM
#define VTT_DYN_SMEM(type, name)                          \
  extern __shared__ __align__(16) unsigned char vtt_smem_[]; \
  type* name = reinterpret_cast<type*>(vtt_smem_)
#endif

#define VTT_MAX_R 8
#define VTT_PW 4   // u32 words of host-port bits (128 ports)
#define VTT_SW 2   // u32 words of selector bits (64 selectors)
#define VTT_S (32 * VTT_SW)
#define VTT_CW 2   // u32 words of a task's claim set (64 claims)
#define VTT_CLAIMS (32 * VTT_CW)
#define VTT_NEG_INF (-__int_as_float(0x7f800000))
#define VTT_POS_INF (__int_as_float(0x7f800000))

// Mirror of kernels.SolveArgs (ctypes): all pointers, then int64 sizes and
// flags, then the two float score weights.  Mutable state arrays are the
// wrapper's working copies; the kernels update them in place.
struct VttSolveArgs {
  float* idle;
  float* releasing;
  float* used;
  const float* node_alloc;
  const int32_t* node_max_tasks;
  int32_t* task_count;
  const uint8_t* node_valid;
  const float* task_req;
  const int32_t* task_job;
  const int32_t* task_class;
  const uint8_t* task_valid;
  const int32_t* job_queue;
  const int32_t* job_min;
  const int32_t* job_prio;
  const int32_t* job_ready_init;
  const float* job_alloc_init;
  const uint8_t* job_schedulable;
  const int32_t* job_start;
  const int32_t* job_ntasks;
  const float* queue_deserved;
  const uint8_t* class_mask;
  const float* class_score;
  const float* total;
  const float* eps;
  float* job_alloc;
  int32_t* cursor;
  uint8_t* dropped;
  float* queue_alloc;
  uint8_t* queue_dropped;
  int32_t* packed;  // [3T + J]: task_node | task_kind | task_seq | ready
  int32_t* ctl;     // [16] control words; ctl[0] = steps (exact) / rounds (batch)
  // batch-solve scratch
  float* job_keys;       // [J, 4] rank keys, most significant first
  uint8_t* job_active;   // [J]
  int32_t* sel;          // [M] job at each rank, -1 past the active count
  int32_t* p_node;       // [F] proposals, flat (job rank, task offset)
  int32_t* p_t;
  int32_t* p_job;
  uint8_t* p_flags;
  int32_t* best_pipe;    // [N + 1]
  // K5 (portsel; null unless has_portsel): resident host-port words and
  // selector match counts per node (working copies), the tasks' port,
  // required-selector, anti-selector and own-label words, and a scratch
  // copy of "count > 0" per selector bit, refreshed wherever a count moves
  int32_t* node_ports;         // [N, VTT_PW] u32 bit patterns
  int32_t* node_selcnt;        // [N, VTT_S]
  const int32_t* task_ports;   // [T, VTT_PW]
  const int32_t* task_aff;     // [T, VTT_SW]
  const int32_t* task_anti;    // [T, VTT_SW]
  const int32_t* task_self;    // [T, VTT_SW]
  int32_t* node_match;         // [N, VTT_SW] scratch
  // K6 (volsel; null unless has_volsel, exact solve only): each task's
  // feasible-node bitset words and claim set, each claim's capacity group,
  // which groups are global pools, and the state the solve updates (working
  // copies): the node each claim assumed its volume on (-1: none yet) and
  // the Available PVs left per (group, node)
  const int32_t* task_volmask;  // [T, VW] u32 bit patterns
  const int32_t* task_claims;   // [T, VTT_CW] u32 bit patterns
  const int32_t* claim_group;   // [CL]
  const uint8_t* group_global;  // [G]
  int32_t* claim_node;          // [CL]
  int32_t* vol_cap;             // [G, N]
  // K3 on node blocks (the batch solve; K12a runs S blocks): a block owns
  // the node rows [n0, n0 + NB) of the N, and its node pointers above
  // (idle ... node_valid, class_mask / class_score [C, NB], the K5 node
  // planes) address its own rows.  Each round its tiles of TILE rows
  // write their exact top-K, its pack writes its K best records a job
  // into `send`, the exchange gathers every block's into `recv`, and the
  // replicated kernels decide from the records alone.
  float* t_val;                 // [M, TB, K] tile candidates: values
  int32_t* t_idx;               // [M, TB, K] tile candidates: global node rows
  uint8_t* t_any;               // [M, TB] a feasible node in the tile
  int32_t* send;                // this block's records [M, K, W]
  const int32_t* recv;          // every block's records [S, M, K, W]
  int32_t* p_rec;               // [F] the record a proposal's node came from
  unsigned long long* p_key;    // [F] proposals in (node, rank) order
  // the batch solve's select: nC chunks of jobs, each with a list of its
  // first M active jobs in rank order (job, keys, rank over every list),
  // its list length and its last active job
  float* c_key;                 // [nC, M, 4]
  int32_t* c_job;               // [nC, M]
  int32_t* c_rank;              // [nC, M]
  int32_t* c_cnt;               // [nC]
  int32_t* c_max;               // [nC]
  // K2 on a thread-block cluster: each CTA's copy of the queue state
  // (alloc [Q, R] floats, active-job count [Q], dropped [Q]) when it does
  // not fit in shared memory, 16 copies; the timed solve's split (null:
  // the untimed kernel)
  int32_t* x_qstate;            // [16, Q * (R + 2)]
  int64_t* x_split;             // [32]
  int64_t n0, NB, S, TB, TILE, W;
  int64_t N, R, T, J, Q, C, M, P, K, F;
  int64_t n_keys, key0, key1, key2;  // job_key_order: 1 priority, 2 gang, 3 drf
  int64_t use_gang_ready, use_proportion, has_portsel;
  int64_t VW, CL, G, has_volsel, nC;
  // K2: the cluster size asked for (0: the largest the card admits; the
  // entry writes back the size launched), and, set by the entry, the nodes
  // a CTA owns, how many of them stay in its shared memory, whether the
  // queue state does, and the job rows a CTA keeps there (0: none)
  int64_t cluster, x_ns, x_nres, x_qsmem, x_jl;
  float w_least, w_balanced, w_podaff;
};

enum { VTT_KEY_PRIORITY = 1, VTT_KEY_GANG = 2, VTT_KEY_DRF = 3 };

__device__ __forceinline__ bool vtt_less_equal(const float* a, const float* b,
                                               const float* eps, int R) {
  bool ok = true;
  for (int r = 0; r < R; ++r) ok = ok && (a[r] < b[r] + eps[r]);
  return ok;
}

__device__ __forceinline__ float vtt_safe_share(float alloc, float denom) {
  if (denom == 0.0f) return alloc == 0.0f ? 0.0f : 1.0f;
  return alloc / denom;
}

__device__ __forceinline__ float vtt_dominant_share(const float* alloc,
                                                    const float* denom, int R) {
  float s = VTT_NEG_INF;
  for (int r = 0; r < R; ++r) s = fmaxf(s, vtt_safe_share(alloc[r], denom[r]));
  return s;
}

// LeastRequested + BalancedResource + class score of one node for one
// request (kernels._score_nodes, operation for operation).
__device__ __forceinline__ float vtt_score_node(const float* req,
                                                const float* used_n,
                                                const float* cap_n,
                                                float cls_score, float w_least,
                                                float w_balanced) {
  const float ua0 = used_n[0] + req[0];
  const float ua1 = used_n[1] + req[1];
  const float cc = cap_n[0], cm = cap_n[1];
  const float fc = fmaxf(cc - ua0, 0.0f);
  const float fm = fmaxf(cm - ua1, 0.0f);
  const float lc = cc > 0.0f ? (fc * 10.0f) / fmaxf(cc, 1e-30f) : 0.0f;
  const float lm = cm > 0.0f ? (fm * 10.0f) / fmaxf(cm, 1e-30f) : 0.0f;
  const float least = (lc + lm) * 0.5f;
  const float cf = vtt_safe_share(ua0, cc);
  const float mf = vtt_safe_share(ua1, cm);
  const float bal = (cc > 0.0f && cm > 0.0f && cf < 1.0f && mf < 1.0f)
                        ? __fmaf_rn(-fabsf(cf - mf), 10.0f, 10.0f)
                        : 0.0f;
  return __fmaf_rn(w_least, least, bal * w_balanced) + cls_score;
}

// (value, index) order of an argmax with first-max ties: a beats b.
__device__ __forceinline__ bool vtt_better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Warp-wide first-max over (v, i) by an xor butterfly: every lane returns
// the winner (vtt_better is a total order, so both lanes of a pair agree).
__device__ __forceinline__ void vtt_warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (vtt_better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// One (value, index) candidate of a first-max.
struct VttArg {
  float v;
  int i;
};

// A CTA's first-max as a record the other CTAs of its cluster read: one
// 16-byte word.
struct alignas(16) VttArgRec {
  VttArg a;
  int pad[2];
};

// CTA-wide first-max: warp shuffles, then one pass of warp 0 over the
// warps' results in `warps` (one slot a warp).  Every lane of warp 0
// returns the CTA's winner (the other warps their own warp's).  One
// __syncthreads; blockDim.x a multiple of 32.
__device__ __forceinline__ VttArg vtt_cta_argmax(float v, int i, VttArg* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  vtt_warp_argmax(v, i);
  if (lane == 0) warps[warp] = VttArg{v, i};
  __syncthreads();
  if (warp == 0) {
    VttArg r = lane < (int)(blockDim.x >> 5) ? warps[lane] : VttArg{VTT_NEG_INF, 0x7fffffff};
    vtt_warp_argmax(r.v, r.i);
    return r;
  }
  return VttArg{v, i};
}

// ---- thread block clusters (sm_90) ----------------------------------------
// The CTA's rank in its cluster and the cluster's size, a pointer to the
// same shared-memory object in another CTA of the cluster (distributed
// shared memory, written with vtt_cluster_store), and the split cluster
// barrier: arrive releases this
// thread's prior writes (shared and global) to the cluster, wait acquires
// every other thread's.  Every thread of every CTA must take part.
#ifndef VTT_CLUSTER_EMULATED
__device__ __forceinline__ int vtt_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int vtt_cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}
// Write v into CTA rank's copy of the shared-memory object *p (a type of
// whole 16-byte words, 16-byte aligned) with st.shared::cluster.v4: the
// stores go out together and need no reply, and the release of the next
// cluster barrier makes them visible there (reading the other CTA's copy
// with generic loads through a mapa'd pointer instead cost about 0.7 us a
// word, one after the other, on an H100).
template <class T>
__device__ __forceinline__ void vtt_cluster_store(T* p, int rank, const T& v) {
  static_assert(sizeof(T) % 16 == 0 && alignof(T) >= 16, "16-byte words");
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"((unsigned)rank));
  union {
    T t;
    int4 w[sizeof(T) / 16];
  } u;
  u.t = v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 16); ++i)
    asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};"
                 :
                 : "r"(addr + 16 * i), "r"(u.w[i].x), "r"(u.w[i].y), "r"(u.w[i].z),
                   "r"(u.w[i].w)
                 : "memory");
}
// the same for one int
__device__ __forceinline__ void vtt_cluster_store_u32(int* p, int rank, int v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr)
               : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"((unsigned)rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" : : "r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void vtt_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void vtt_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// the device's nanosecond clock (for timed instantiations only)
__device__ __forceinline__ unsigned long long vtt_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Block-wide exact top-K of n candidates in lax.top_k's order (values
// descending, lower index first): K passes, each the first-max among the
// candidates ranked after the previous pass's winner.  get(i, v, idx)
// yields candidate i; indices are distinct except for padding, which
// carries (-inf, INT_MAX) and ranks after every real candidate.  Thread 0
// writes out_v / out_i / out_p (the winner's position i; -1 once the
// candidates run out).  sv, si, sp hold blockDim.x entries (a power of
// two).  Used by the tile pass and by the merges of the batch solves: the
// global top-K is contained in the union of the parts' top-Ks, so a merge
// of parts' top-Ks gives the decisions of one pass over all candidates.
template <class Get>
__device__ __forceinline__ void vtt_block_topk(Get get, int n, int K, float* sv,
                                               int* si, int* sp, float* out_v,
                                               int* out_i, int* out_p) {
  const int tid = threadIdx.x;
  float prev_v = VTT_POS_INF;
  int prev_i = -1;
  for (int k = 0; k < K; ++k) {
    float bv = VTT_NEG_INF;
    int bi = 0x7fffffff, bp = -1;
    for (int c = tid; c < n; c += blockDim.x) {
      float v;
      int i;
      get(c, v, i);
      if ((k == 0 || vtt_better(prev_v, prev_i, v, i)) &&
          (bp < 0 || vtt_better(v, i, bv, bi))) {
        bv = v;
        bi = i;
        bp = c;
      }
    }
    sv[tid] = bv;
    si[tid] = bi;
    sp[tid] = bp;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (tid < s && sp[tid + s] >= 0 &&
          (sp[tid] < 0 || vtt_better(sv[tid + s], si[tid + s], sv[tid], si[tid]))) {
        sv[tid] = sv[tid + s];
        si[tid] = si[tid + s];
        sp[tid] = sp[tid + s];
      }
      __syncthreads();
    }
    bv = sv[0];
    bi = si[0];
    bp = sp[0];
    if (tid == 0) {
      out_v[k] = bv;
      out_i[k] = bp < 0 ? 0x7fffffff : bi;
      out_p[k] = bp;
    }
    __syncthreads();
    if (bp >= 0) {
      prev_v = bv;
      prev_i = bi;
    }
  }
}

// Block-wide OR of a predicate; every thread returns the result.
__device__ __forceinline__ bool vtt_block_any(bool p, volatile int* flag) {
  if (threadIdx.x == 0) *flag = 0;
  __syncthreads();
  if (p) *flag = 1;
  __syncthreads();
  const bool any = *flag != 0;
  __syncthreads();
  return any;
}

// Block-wide sum of an int; every thread returns the result.
__device__ __forceinline__ int vtt_block_sum(int v, int* s) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if (tid < k) s[tid] += s[tid + k];
    __syncthreads();
  }
  const int out = s[0];
  __syncthreads();
  return out;
}

// Block-wide exclusive prefix sum of one int a thread (blockDim.x a
// multiple of 32, at most 1024); s holds blockDim.x ints, s_tot 33.  Every
// thread returns its prefix and the block's total.
__device__ __forceinline__ int vtt_block_scan(int v, int* s, int* s_tot, int& total) {
  const int tid = threadIdx.x, gs = blockDim.x / 32;
  s[tid] = v;
  __syncthreads();
  if (tid < 32) {
    int run = 0;
    for (int e = 0; e < gs; ++e) {
      const int c = s[tid * gs + e];
      s[tid * gs + e] = run;
      run += c;
    }
    s_tot[tid] = run;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < 32; ++e) {
      const int c = s_tot[e];
      s_tot[e] = run;
      run += c;
    }
    s_tot[32] = run;
  }
  __syncthreads();
  const int out = s[tid] + s_tot[tid / gs];
  total = s_tot[32];
  __syncthreads();
  return out;
}

// ---- the job select of the batched rounds (K3, K10): a top-M by chunks ----
//
// sel[r] = the active job of rank r < M in the order vtt_rank_less gives
// (the nk float keys, then the job index), in O(J log^2 C) a round in place
// of a count over all pairs of jobs.  vtt_sel_chunk (one CTA per chunk of
// VTT_SEL_CHUNK jobs) sorts the chunk's active jobs in shared memory by a
// bitonic network and keeps its M first; vtt_sel_merge gives each kept job
// its rank among every chunk's kept jobs (a binary search a chunk);
// vtt_sel_place writes sel[rank] for rank < M.  The M first jobs of the
// whole order all lie in their chunks' M first, so the ranks are exact.
// Every comparison is on the float keys: no packed integer key, so -0.0 and
// +0.0 (the priority key of priority 0) compare equal as the reference's
// sort has them, and the order is that of a count over all pairs wherever
// that count is a permutation -- that is, wherever no key is NaN.
#define VTT_SEL_CHUNK 2048  // jobs a select CTA sorts in shared memory
#define VTT_SEL_THREADS 1024
#define VTT_SEL_SCRATCH \
  (VTT_SEL_CHUNK / 2 > VTT_SEL_THREADS ? VTT_SEL_CHUNK / 2 : VTT_SEL_THREADS)

// The job order: the nk keys (the k-th at ka[k * stride]) most
// significant first, then the job index.
__device__ __forceinline__ bool vtt_rank_less(const float* ka, int ia,
                                              const float* kb, int ib, int nk,
                                              int stride = 1) {
  for (int i = 0; i < nk; ++i) {
    if (ka[i * stride] < kb[i * stride]) return true;
    if (ka[i * stride] > kb[i * stride]) return false;
  }
  return ia < ib;
}

// A select's inputs and scratch: the jobs' active flags and keys ([J, 4],
// nk used), sel [M], and per chunk its list of kept jobs (job, keys, rank)
// and their count; c_max (may be null) takes each chunk's last active job.
struct VttSel {
  const uint8_t* active;
  const float* keys;
  int32_t* sel;
  float* c_key;     // [nC, M, 4]
  int32_t* c_job;   // [nC, M]
  int32_t* c_rank;  // [nC, M]
  int32_t* c_cnt;   // [nC]
  int32_t* c_max;   // [nC] or null
  int J, M, nk, nC;
};

// Stage 1, one CTA of VTT_SEL_THREADS a chunk: the chunk's active jobs in
// job order (a block scan compacts them), sorted by an index permutation in
// shared memory, vtt_rank_less the comparator; the first min(M, active)
// become the chunk's list (with one chunk, the selection itself).  The keys
// lie key-major in shared memory (s_k[k][slot]), so that the network's
// permuted reads spread over the banks.  Thread 0 returns the chunk's last
// active job (-1: none).
__device__ __forceinline__ int vtt_sel_chunk(const VttSel& a) {
  __shared__ float s_k[4 * VTT_SEL_CHUNK];
  __shared__ int s_j[VTT_SEL_CHUNK];
  // the block scan's scratch, then the permutation (int16): 45 KB in all
  __shared__ int s_pi[VTT_SEL_SCRATCH];
  __shared__ int s_tot[33];
  int16_t* s_p = reinterpret_cast<int16_t*>(s_pi);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int J = a.J, M = a.M, nk = a.nk, b = blockIdx.x;
  const int c0 = b * VTT_SEL_CHUNK, cn = min(VTT_SEL_CHUNK, J - c0);
  // the active jobs in job order: thread t holds [t * ipt, (t + 1) * ipt)
  const int ipt = (VTT_SEL_CHUNK + nthr - 1) / nthr;
  const int lo = min(cn, tid * ipt), hi = min(cn, lo + ipt);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += a.active[c0 + i] ? 1 : 0;
  int n;
  int slot = vtt_block_scan(c, s_pi, s_tot, n);
  for (int i = lo; i < hi; ++i) {
    const int j = c0 + i;
    if (!a.active[j]) continue;
    s_j[slot] = j;
    for (int k = 0; k < nk; ++k) s_k[k * VTT_SEL_CHUNK + slot] = a.keys[(size_t)j * 4 + k];
    ++slot;
  }
  if (n == 0) {
    if (tid == 0) {
      a.c_cnt[b] = 0;
      if (a.c_max) a.c_max[b] = -1;
    }
    return -1;
  }
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = tid; i < n2; i += nthr) s_p[i] = (int16_t)(i < n ? i : -1);
  __syncthreads();
  // x before y: padding (-1) after every job
  auto before = [&](int x, int y) {
    return x >= 0 && (y < 0 || vtt_rank_less(&s_k[x], s_j[x], &s_k[y], s_j[y], nk,
                                             VTT_SEL_CHUNK));
  };
  for (int k = 2; k <= n2; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int q = tid; q < (n2 >> 1); q += nthr) {
        const int i = ((q & ~(jj - 1)) << 1) | (q & (jj - 1));
        const int x = s_p[i], y = s_p[i + jj];
        if ((i & k) == 0 ? before(y, x) : before(x, y)) {
          s_p[i] = (int16_t)y;
          s_p[i + jj] = (int16_t)x;
        }
      }
      __syncthreads();
    }
  }
  const int keep = min(M, n);
  for (int r = tid; r < keep; r += nthr) {
    const int p = s_p[r];
    if (a.nC == 1) {
      a.sel[r] = s_j[p];
      continue;
    }
    const size_t x = (size_t)b * M + r;
    a.c_job[x] = s_j[p];
    for (int k = 0; k < nk; ++k) a.c_key[x * 4 + k] = s_k[k * VTT_SEL_CHUNK + p];
    a.c_rank[x] = r;
  }
  const int last = s_j[s_p[n - 1]];
  if (tid == 0) {
    a.c_cnt[b] = keep;
    if (a.c_max) a.c_max[b] = last;
  }
  return last;
}

// Stage 2, thread (kept job x, chunk blockIdx.y): adds to x's rank the jobs
// of that chunk's list that order before x (a binary search: the list is
// sorted).
__device__ __forceinline__ void vtt_sel_merge(const VttSel& a) {
  const int M = a.M;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = x / M, c2 = blockIdx.y;
  if (c >= a.nC || c2 == c || x - c * M >= a.c_cnt[c]) return;
  const int nk = a.nk;
  float kx[4];
  for (int k = 0; k < nk; ++k) kx[k] = a.c_key[(size_t)x * 4 + k];
  const int jx = a.c_job[x];
  int lo = 0, hi = a.c_cnt[c2];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const size_t y = (size_t)c2 * M + mid;
    if (vtt_rank_less(&a.c_key[y * 4], a.c_job[y], kx, jx, nk))
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo) atomicAdd(&a.c_rank[x], lo);
}

// Stage 3, a thread a kept job: sel[rank] for the kept jobs of rank < M.
__device__ __forceinline__ void vtt_sel_place(const VttSel& a) {
  const int M = a.M;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = x / M;
  if (c < a.nC && x - c * M < a.c_cnt[c]) {
    const int r = a.c_rank[x];
    if (r < M) a.sel[r] = a.c_job[x];
  }
}

// ---- K5: host ports and pod (anti)affinity as packed bitsets ------------

// One task's portsel words.
struct VttPs {
  uint32_t port[VTT_PW];
  uint32_t aff[VTT_SW], anti[VTT_SW], self_[VTT_SW];
  bool any_port, any_sel;  // any port bit; any required or anti bit
};

__device__ __forceinline__ VttPs vtt_ps_task(const VttSolveArgs& a, int t) {
  VttPs p;
  uint32_t ports = 0, sel = 0;
  for (int w = 0; w < VTT_PW; ++w) {
    p.port[w] = (uint32_t)a.task_ports[(size_t)t * VTT_PW + w];
    ports |= p.port[w];
  }
  for (int w = 0; w < VTT_SW; ++w) {
    p.aff[w] = (uint32_t)a.task_aff[(size_t)t * VTT_SW + w];
    p.anti[w] = (uint32_t)a.task_anti[(size_t)t * VTT_SW + w];
    p.self_[w] = (uint32_t)a.task_self[(size_t)t * VTT_SW + w];
    sel |= p.aff[w] | p.anti[w];
  }
  p.any_port = ports != 0;
  p.any_sel = sel != 0;
  return p;
}

// Node n admits the task: no host port in common with its residents, every
// required selector matched by a resident, no anti selector matched.
__device__ __forceinline__ bool vtt_ps_feasible(const VttSolveArgs& a, int n,
                                                const VttPs& p) {
  if (p.any_port) {
    const int32_t* np = a.node_ports + (size_t)n * VTT_PW;
    for (int w = 0; w < VTT_PW; ++w)
      if ((uint32_t)np[w] & p.port[w]) return false;
  }
  if (p.any_sel) {
    const int32_t* m = a.node_match + (size_t)n * VTT_SW;
    for (int w = 0; w < VTT_SW; ++w) {
      const uint32_t mw = (uint32_t)m[w];
      if ((p.aff[w] & ~mw) || (p.anti[w] & mw)) return false;
    }
  }
  return true;
}

// score + w_podaff * sum_s selcnt[n, s] * (aff_s - anti_s), rounded once as
// the reference rounds it.  The dot is a sum of small integers (counts of
// resident pods), exact in int32 and in float32 below 2^24, so it needs no
// fixed order; a task with no selector bits keeps its score.
__device__ __forceinline__ float vtt_ps_score(const VttSolveArgs& a, int n,
                                              const VttPs& p, float score) {
  if (!p.any_sel) return score;
  const int32_t* cnt = a.node_selcnt + (size_t)n * VTT_S;
  int dot = 0;
  for (int w = 0; w < VTT_SW; ++w) {
    for (uint32_t b = p.aff[w]; b; b &= b - 1) dot += cnt[w * 32 + __ffs(b) - 1];
    for (uint32_t b = p.anti[w]; b; b &= b - 1) dot -= cnt[w * 32 + __ffs(b) - 1];
  }
  return __fmaf_rn(a.w_podaff, (float)dot, score);
}

// The task becomes resident on node n (sign +1: its ports join the node's,
// its labels the selector counts) or leaves it (sign -1: its ports, which no
// co-resident can share, are cleared and its counts subtracted).  One thread
// owns node n while it runs.
__device__ __forceinline__ void vtt_ps_fold(const VttSolveArgs& a, int n,
                                            const VttPs& p, int sign) {
  int32_t* np = a.node_ports + (size_t)n * VTT_PW;
  for (int w = 0; w < VTT_PW; ++w)
    np[w] = (int32_t)(sign > 0 ? ((uint32_t)np[w] | p.port[w])
                               : ((uint32_t)np[w] & ~p.port[w]));
  int32_t* cnt = a.node_selcnt + (size_t)n * VTT_S;
  int32_t* m = a.node_match + (size_t)n * VTT_SW;
  for (int w = 0; w < VTT_SW; ++w) {
    uint32_t mw = (uint32_t)m[w];
    for (uint32_t b = p.self_[w]; b; b &= b - 1) {
      const int bit = __ffs(b) - 1;
      const int c = cnt[w * 32 + bit] + sign;
      cnt[w * 32 + bit] = c;
      mw = c > 0 ? (mw | (1u << bit)) : (mw & ~(1u << bit));
    }
    m[w] = (int32_t)mw;
  }
}

// node_match[n] from node_selcnt[n]
__device__ __forceinline__ void vtt_ps_init_node(const VttSolveArgs& a, int n) {
  const int32_t* cnt = a.node_selcnt + (size_t)n * VTT_S;
  for (int w = 0; w < VTT_SW; ++w) {
    uint32_t mw = 0;
    for (int b = 0; b < 32; ++b) mw |= (cnt[w * 32 + b] > 0 ? 1u : 0u) << b;
    a.node_match[(size_t)n * VTT_SW + w] = (int32_t)mw;
  }
}

// ---- K6: volumes (the exact solve's volsel extension) --------------------

// The current task's claims, listed once a place step by thread 0 of each
// CTA in its shared memory: claim index, capacity group, whether the group
// is a global pool, and the node the claim assumed its volume on at the
// step's start (-1: none).  A placement by idle fit assumes every claim
// listed with node -1 ("fresh").
struct VttVsTask {
  int n;
  int c[VTT_CLAIMS];
  int g[VTT_CLAIMS];
  int node[VTT_CLAIMS];
  uint8_t glob[VTT_CLAIMS];
};

// Thread 0: list task t's claims (bit i of its claim words is claim i);
// claim_node is the CTA's copy of the claims' assumed nodes.
__device__ __forceinline__ void vtt_vs_task(const VttSolveArgs& a, int t,
                                            const int* claim_node, VttVsTask& v) {
  int k = 0;
  for (int w = 0; w < VTT_CW; ++w) {
    for (uint32_t b = (uint32_t)a.task_claims[(size_t)t * VTT_CW + w]; b; b &= b - 1) {
      const int c = w * 32 + __ffs(b) - 1;
      if (c >= (int)a.CL) break;  // bits past the claim count carry nothing
      const int g = a.claim_group[c];
      v.c[k] = c;
      v.g[k] = g;
      v.glob[k] = a.group_global[g];
      v.node[k] = claim_node[c];
      ++k;
    }
  }
  v.n = k;
}

// Node n admits task t's volumes: its bit in the task's mask word `mask_w`
// (word n / 32 of the task's row), and per claim, an assumed claim's node
// (a pinned pool) or any node (a global pool), an unassumed claim a PV
// left in its group at n: cap(g) reads the node's count of group g.
template <class Cap>
__device__ __forceinline__ bool vtt_vs_feasible(uint32_t mask_w, int n, const VttVsTask& v,
                                                Cap cap) {
  if (!((mask_w >> (n & 31)) & 1u)) return false;
  for (int i = 0; i < v.n; ++i) {
    const int cn = v.node[i];
    if (cn >= 0) {
      if (!v.glob[i] && cn != n) return false;
    } else if (cap(v.g[i]) <= 0) {
      return false;
    }
  }
  return true;
}
