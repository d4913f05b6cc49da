// Fused gather -> Gram/rhs for one padded-CSR block of an ALS half-step.
//
// Replaces the TPU kernel predictionio_tpu/ops/als_gram.py::_gram_rhs_kernel
// (ops/als_gram.py:86, pallas_call at :185, launched by gram_rhs :157).
// Same contract: row r gathers the L rows factors[indices[r, l]] of the
// [S + 1, K] table (f32 or bf16; padding slots point at the trailing zero
// row, so no mask stream exists) and accumulates in f32
//   explicit: gram[r] = sum_l y y^T,            rhs[r] = sum_l v * y
//   implicit: gram[r] = sum_l (alpha v) y y^T,  rhs[r] = sum_l (1 + alpha v) y
// The ridge, the implicit YtY term and the solve stay outside
// (parallel/als.py), shared with the unfused path.
//
// What bounds it on an H100: f32 operations. Each slot costs 2 * K^2 + 2K
// f32 operations (rank 16: 0.22 ms at 67 TFLOP/s for the users of the
// 138k x 27k x 20M fit). The factor tables are small (8.8 MB users and
// 1.7 MB items at rank 16 in f32) and sit in the 50 MB L2, so the random
// gather of K * itemsize bytes a slot (64 B at rank 16 in f32) need not
// reach device memory: the bytes the function must move are the indices,
// values and outputs once plus the table once (0.11 ms at that shape).
// This kernel is far from either bound: its inner loop does two shared-
// memory reads per FMA.
//
// The design keeps the [R, L, K] gather out of device memory, which is
// the point of the TPU kernel: each block owns one CSR row (CUDA blocks
// run in any order, and nothing carries between rows, so the TPU's
// sequential row grid and its double-buffered per-row DMAs become one
// block per row with a loop over L chunks inside it). A chunk of C slots
// is staged in shared memory as f32: G[l][k] = y and the augmented
// A[l][0..K] = (y * w_gram, w_rhs), neighbouring threads loading
// neighbouring k of one gathered row. The K x (K + 1) outputs (the Gram
// and, as row K, the rhs) are one flat list of entries; thread t owns
// entries t, t + T, ... (PER of them, in registers) and folds
// A[l][e / K] * G[l][e % K] over the chunk, in l order. A warp reads at
// most a few distinct A values (broadcast) and consecutive G values.
// It is the simple kernel: tensor cores, cp.async/TMA pipelining of the
// next chunk and several rows per block are later work.
//
// Any rank. Past 5 * 1024 entries (K > 71) the entries split into
// gridDim.y groups of at most that many, one block each: every group
// re-stages the chunk's gathered rows (they come from L2, where the
// table sits) and folds only its own entries. A chunk holds C slots:
// 64 while C * (2K + 1) floats fit the 227 KB a block may use (K <= 453),
// fewer beyond. Dynamic shared memory above 48 KB (K >= 96) is opted into
// with cudaFuncSetAttribute. The groups must fit the grid's 65,535 rows
// of blocks (K <= 18,317, ops/als_gram.py MAX_RANK; one slot a chunk
// there still fits); past that the launch returns cudaErrorInvalidValue.
//
// Layout: grid (R, groups), T threads (a multiple of 32, at most 1024),
// dynamic shared memory C * (2K + 1) floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // slots of L staged per pass, while they fit
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 5;     // entries a thread holds in registers
constexpr int kGroup = kMaxThreads * kMaxPer;  // entries one block owns at most
constexpr size_t kMaxSmemBytes = 232448;       // what one block may use on Hopper
constexpr int kMaxGroups = 65535;              // gridDim.y

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, bool kImplicit, int kPer>
__global__ void gram_rhs_kernel(
    const int32_t* __restrict__ indices,  // [R, L]
    const float* __restrict__ values,     // [R, L]
    const T* __restrict__ factors,        // [S + 1, K]
    float* __restrict__ gram,             // [R, K, K]
    float* __restrict__ rhs,              // [R, K]
    int L, int K, float alpha, int chunk, int group) {
  extern __shared__ __align__(16) float smem[];
  const int ka = K + 1;
  float* a_s = smem;                 // [chunk, K + 1]: y * w_gram | w_rhs
  float* g_s = smem + chunk * ka;    // [chunk, K]: y

  const long long row = blockIdx.x;
  const int32_t* ridx = indices + row * L;
  const float* rval = values + row * L;
  const int entries = K * ka;
  const int e0 = blockIdx.y * group;                 // this block's entries
  const int e1 = min(entries, e0 + group);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  int ea[kPer], eb[kPer];
  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = e0 + tid + p * nthreads;
    const int ec = e < e1 ? e : e0;  // idle slots read a valid cell
    ea[p] = ec / K;
    eb[p] = ec - ea[p] * K;
    acc[p] = 0.0f;
  }

  for (int c0 = 0; c0 < L; c0 += chunk) {
    const int n = min(chunk, L - c0);
    __syncthreads();  // the previous chunk's folds are done with smem
    for (int i = tid; i < n * K; i += nthreads) {
      const int l = i / K;
      const int k = i - l * K;
      const long long j = ridx[c0 + l];
      const float y = to_f32(factors[j * K + k]);
      const float v = rval[c0 + l];
      g_s[l * K + k] = y;
      if (kImplicit) {
        const float w = alpha * v;
        a_s[l * ka + k] = y * w;
        if (k == 0) a_s[l * ka + K] = 1.0f + w;
      } else {
        a_s[l * ka + k] = y;
        if (k == 0) a_s[l * ka + K] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < n; ++l) {
      const float* a_row = a_s + l * ka;
      const float* g_row = g_s + l * K;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        acc[p] = fmaf(a_row[ea[p]], g_row[eb[p]], acc[p]);
      }
    }
  }

  const int kk = K * K;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = e0 + tid + p * nthreads;
    if (e >= e1) continue;  // an idle slot: e belongs to the next group's block
    if (e < kk) {
      gram[row * kk + e] = acc[p];
    } else {
      rhs[row * K + (e - kk)] = acc[p];
    }
  }
}

// The K (K + 1) entries (the Gram and, as row K, the rhs) in groups of at
// most kGroup, split evenly; each group's block holds `per` entries a
// thread over `threads` threads.
struct Plan {
  int groups, group, per, threads, chunk;
  size_t smem;
};

bool plan_for(int K, Plan* p) {
  const long long entries = static_cast<long long>(K) * (K + 1);
  p->groups = static_cast<int>((entries + kGroup - 1) / kGroup);
  p->group = static_cast<int>((entries + p->groups - 1) / p->groups);
  p->per = (p->group + kMaxThreads - 1) / kMaxThreads;
  const int t = (p->group + p->per - 1) / p->per;
  p->threads = (t + 31) / 32 * 32;
  const size_t slot_bytes = static_cast<size_t>(2 * K + 1) * sizeof(float);
  p->chunk = static_cast<int>(kMaxSmemBytes / slot_bytes < kChunk ? kMaxSmemBytes / slot_bytes
                                                                   : kChunk);
  p->smem = p->chunk * slot_bytes;
  return p->chunk >= 1 && p->groups <= kMaxGroups;
}

template <typename T, bool kImplicit, int kPer>
int launch_per(const Plan& p, const void* indices, const void* values, const void* factors,
               void* gram, void* rhs, int R, int L, int K, float alpha, cudaStream_t stream) {
  auto kernel = gram_rhs_kernel<T, kImplicit, kPer>;
  if (p.smem > 48 * 1024) {  // above the static limit only after an opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(R, p.groups), p.threads, p.smem, stream>>>(
      static_cast<const int32_t*>(indices), static_cast<const float*>(values),
      static_cast<const T*>(factors), static_cast<float*>(gram), static_cast<float*>(rhs),
      L, K, alpha, p.chunk, p.group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kImplicit>
int launch_typed(const void* indices, const void* values, const void* factors,
                 void* gram, void* rhs, int R, int L, int K, float alpha,
                 cudaStream_t stream) {
  Plan p;
  if (!plan_for(K, &p)) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.per) {
    case 1: return launch_per<T, kImplicit, 1>(p, indices, values, factors, gram, rhs, R, L, K, alpha, stream);
    case 2: return launch_per<T, kImplicit, 2>(p, indices, values, factors, gram, rhs, R, L, K, alpha, stream);
    case 3: return launch_per<T, kImplicit, 3>(p, indices, values, factors, gram, rhs, R, L, K, alpha, stream);
    case 4: return launch_per<T, kImplicit, 4>(p, indices, values, factors, gram, rhs, R, L, K, alpha, stream);
    case 5: return launch_per<T, kImplicit, 5>(p, indices, values, factors, gram, rhs, R, L, K, alpha, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. `bf16` selects a bf16 factor table
// (else f32), `implicit` the implicit-feedback weights. R = 0 launches
// nothing.
extern "C" int als_gram_rhs_launch(
    const void* indices, const void* values, const void* factors,
    void* gram, void* rhs, int R, int L, int K, float alpha,
    int implicit, int bf16, void* stream) {
  if (K < 1 || L < 1 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return implicit
        ? launch_typed<__nv_bfloat16, true>(indices, values, factors, gram, rhs, R, L, K, alpha, s)
        : launch_typed<__nv_bfloat16, false>(indices, values, factors, gram, rhs, R, L, K, alpha, s);
  }
  return implicit
      ? launch_typed<float, true>(indices, values, factors, gram, rhs, R, L, K, alpha, s)
      : launch_typed<float, false>(indices, values, factors, gram, rhs, R, L, K, alpha, s);
}
