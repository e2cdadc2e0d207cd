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
  int32_t* job_rank;     // [J]
  int32_t* sel;          // [M] job at each rank, -1 past the active count
  int32_t* p_node;       // [F] proposals, flat (job rank, task offset)
  int32_t* p_t;
  int32_t* p_job;
  uint8_t* p_flags;
  int32_t* best_pipe;    // [N + 1]
  int64_t N, R, T, J, Q, C, M, P, K, F;
  int64_t n_keys, key0, key1, key2;  // job_key_order: 1 priority, 2 gang, 3 drf
  int64_t use_gang_ready, use_proportion;
  float w_least, w_balanced;
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

// Block-wide first-max over (v, i); blockDim.x must be a power of two and
// sv/si hold blockDim.x entries.  Every thread returns the winner.
__device__ __forceinline__ void vtt_block_argmax(float& v, int& i, float* sv,
                                                 int* si) {
  const int tid = threadIdx.x;
  sv[tid] = v;
  si[tid] = i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s && vtt_better(sv[tid + s], si[tid + s], sv[tid], si[tid])) {
      sv[tid] = sv[tid + s];
      si[tid] = si[tid + s];
    }
    __syncthreads();
  }
  v = sv[0];
  i = si[0];
  __syncthreads();
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
