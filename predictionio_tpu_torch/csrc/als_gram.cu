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
// (parallel/als.py), shared with the unfused path. The [R, L, K] gather
// never reaches device memory: it is staged in shared memory, chunk by
// chunk, which is the point of the TPU kernel.
//
// Two instances, chosen by K (als_gram_instance; ops/als_gram.py
// gram_instance agrees):
//
// K <= 512: gram_rhs_mma_kernel, the Gram and rhs on the tensor cores.
//   One product per row: A = Y^T (M = K, k = the slots) times
//   B = [w_gram * Y | w_rhs] (N = K + 1, rhs as the extra column), with
//   mma.sync m16n8k8 in 3xTF32: each operand is split into a TF32 hi and
//   its f32 rest (split_fast), and each 8-slot step sums its three
//   products into a zeroed fragment that reaches the running sum by f32
//   adds (mma_tf32.cuh). Only the 16 x 8 tiles that hold an entry on or
//   above the diagonal are computed (K = 16: 3 tiles, rhs included; K =
//   256: 288 of 528); each such entry is stored and mirrored below the
//   diagonal, so gram is exactly symmetric. A tile on the diagonal takes
//   its B columns from the warp's A fragment, already split. A bf16 table
//   is exact in TF32, so its Y operand has no low half and the a_lo b_hi
//   product is skipped (two products a step, not three). Each output
//   entry has one owner and the kernel has no atomics: repeated launches
//   are bit-equal.
//   Work split (mma_shape): a block is 8 warps; a row's tiles go to a team
//   of 1 to 8 warps, each warp one m-tile and up to 4 of its n-tiles, so
//   it loads and splits one A fragment a step. Rank 16 is one warp a row
//   and 8 rows a block; past 8 warps' tiles (K > 64) a row's tiles spread
//   over gridDim.y groups of blocks, each of which stages the row again
//   (from L2, where the table sits). Rank 16, the template's, has an
//   instance with K known to the compiler.
//   Pipeline: each team gathers its row through its own two-stage ring of
//   32-slot chunks in shared memory, [slot][words] with words = 8 mod 16,
//   so the fragment reads (thread (g, t) reads slot t, column g) hit 32
//   distinct banks. Lane l loads slot l's index and value into registers
//   a chunk ahead; the team then issues chunk c + 1's table rows as
//   cp.async copies (16 B where K * itemsize and the table's address
//   allow, else 4 B, else 2 B scalar loads for odd-K bf16; a row's copies
//   on neighbouring lanes, its index passed by a shuffle) and folds chunk
//   c while they fly. Teams meet only among themselves (__syncwarp, or a
//   named barrier), so the 32 warps of an SM drift apart and one's gather
//   hides behind another's products. A padding slot (the table's last
//   row, when that row is zero as the contract says) is written as zeros
//   instead of gathered: padding is a large share of a real block's slots
//   (28% of the users block of the fit below), and all of it reading one
//   row queues on one L2 slice. The weights w_gram and the split
//   w_rhs are written once a slot while it is staged (no division
//   anywhere); bf16 is widened when fragments load.
//   What bounds it on an H100: counted with its products at 3xTF32's 165
//   TFLOP/s, bytes (chip_smoke.py::b1_bound): at rank 16 the users block of
//   the 138k x 27k x 20M fit moves 373 MB once (0.111 ms at 3.35 TB/s;
//   its products take 0.091 ms). The gather itself is rows * L * K *
//   itemsize (1.77 GB there), served from L2 (the tables, 1.7 MB and 8.8
//   MB, fit its 50 MB) and likely the real floor: the staging alone runs
//   near 0.4 ms there. The ring keeps that traffic in flight behind the
//   tensor-core work.
//
// K > 512: gram_rhs_kernel, the grouped SIMT instance (unchanged from the
//   earlier design). Its K (K + 1) outputs are one flat list of entries;
//   thread t owns entries t, t + T, ... (PER of them, in registers) and
//   folds A[l][e / K] * G[l][e % K] over a chunk of slots staged in shared
//   memory as f32 (G = y, A = (y * w_gram, w_rhs)). Past 5 * 1024 entries
//   the entries split into gridDim.y groups of blocks, each re-staging the
//   chunk. A chunk holds C slots: 64 while C * (2K + 1) floats fit the 227
//   KB a block may use (K <= 453), fewer beyond. The groups must fit the
//   grid's 65,535 rows of blocks (K <= 18,317, ops/als_gram.py MAX_RANK);
//   past that the launch returns cudaErrorInvalidValue. Bound by f32
//   operations and by its two shared-memory loads an FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

// ---- the grouped SIMT instance (K > kMmaMaxRank) ----

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

// ---- the tensor-core instance (K <= kMmaMaxRank) ----

constexpr int kMmaMaxRank = 512;
constexpr int kWarps = 8;                 // a block
constexpr int kBlockThreads = kWarps * 32;
constexpr int kMaxTiles = 4;              // 16 x 8 accumulator tiles a warp holds

// How rank K's tiles split over warps, blocks and gridDim.y. A row's Gram
// and rhs are nt n-tiles (8 columns of the K + 1) against mt m-tiles (16
// rows); m-tile mi needs the n-tiles 2 mi .. nt - 1 (those that reach the
// diagonal). A unit is one m-tile and at most `per` consecutive n-tiles of
// it: one warp, which loads the m-tile's A fragment once a step. A row has
// `units` of them, `wpr` to a block (the block runs `rows` rows) or, past 8,
// spread over `groups` blocks of 8 warps each.
struct MmaShape {
  int mt, nt, per, units, groups, wpr, rows;
};

__host__ __device__ constexpr int units_for(int mt, int nt, int per) {
  int u = 0;
  for (int mi = 0; mi < mt; ++mi) u += (nt - 2 * mi + per - 1) / per;
  return u;
}

// the `per` of least cost a row: every warp of a block (idle ones
// included) pays per + 1 tile steps a slot (the +1: loading and splitting
// its A fragment and the weights), and every block that stages the row
// pays about K / 16 more; the larger `per` on a tie
__host__ __device__ constexpr MmaShape mma_shape(int K) {
  const int mt = (K + 15) / 16, nt = (K + 1 + 7) / 8;
  MmaShape best{mt, nt, 0, 0, 0, 0, 0};
  int best_cost = -1;
  for (int per = 1; per <= kMaxTiles; ++per) {
    const int u = units_for(mt, nt, per);
    const int groups = (u + kWarps - 1) / kWarps;
    const int wpr = groups > 1 ? kWarps : u;
    const int rows = kWarps / wpr;
    const int blocks16 = groups * 16 / rows;  // blocks a row, in sixteenths
    const int cost = blocks16 * (kWarps * (per + 1) + (K + 15) / 16);
    if (best_cost < 0 || cost <= best_cost) {
      best = MmaShape{mt, nt, per, u, groups, wpr, rows};
      best_cost = cost;
    }
  }
  return best;
}

// words (4 bytes) of one staged slot: the least >= the row's bytes / 4 that
// is 8 mod 16, so the fragment reads of a warp (thread (g, t) reads slot t,
// column g) hit 32 distinct banks in f32 and distinct words in bf16
__host__ __device__ constexpr int slot_words(int K, int itemsize) {
  const int kw = (K * itemsize + 3) / 4;
  return kw + ((8 - kw) % 16 + 16) % 16;
}

constexpr int kSlots = 32;   // slots a stage: one a lane, for its index and value
__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// one team's ring: two stages of [kSlots][words] gathered rows and
// [kSlots] weights (w_gram, then w_rhs split into its TF32 hi and lo, a pad)
__host__ __device__ constexpr int team_words(int words) { return 2 * kSlots * (words + 4); }

struct MmaPlan {
  MmaShape shape;
  int sentinel;                // the table's last row, the padding's zero row
  int words;
  int piece, pieces, log_tps;  // bytes a copy, copies a gathered row, log2 lanes a row
  size_t smem;
};

bool mma_plan(int K, int table_rows, int itemsize, uintptr_t table_addr, MmaPlan* p) {
  if (K < 1 || K > kMmaMaxRank || table_rows < 1) return false;
  p->shape = mma_shape(K);
  p->sentinel = table_rows - 1;
  p->words = slot_words(K, itemsize);
  const int row_bytes = K * itemsize;
  p->piece = 2;
  if (row_bytes % 4 == 0 && table_addr % 4 == 0) p->piece = 4;
  if (row_bytes % 16 == 0 && table_addr % 16 == 0) p->piece = 16;
  p->pieces = row_bytes / p->piece;
  p->log_tps = 0;
  while (p->log_tps < 5 && (1 << p->log_tps) < p->pieces) ++p->log_tps;
  p->smem = static_cast<size_t>(p->shape.rows) * team_words(p->words) * 4;
  return p->shape.per <= kMaxTiles && p->smem <= kMaxSmemBytes;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo with hi = x rounded to TF32 (to nearest, ties away: add half
// a TF32 ulp, drop the 13 low bits; factors are finite) and lo = x - hi
// exactly in f32. lo goes to the tensor core as it is, which reads its top
// 19 bits: |lo| <= 2^-11 |x|, so that truncation loses at most 2^-21 |x|.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The warps of one row (a team) meet: a warp alone at __syncwarp, more at
// their own named barrier (id 1 + the team's index; id 0 is
// __syncthreads'), so the teams of a block run apart.
__device__ __forceinline__ void team_sync(int team, int wpr) {
  if (wpr == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(wpr * 32) : "memory");
  }
}

// Issue the copies of one chunk's gathered rows into a stage: lane l holds
// slot l's index and value; a row goes to `1 << log_tps` consecutive
// threads of the team (whole 32-byte sectors a warp request), each
// copying pieces q, q + tps, ...; slot s's index reaches them by a
// shuffle. The thread with q = 0 of each slot writes its weights. A slot
// that indexes `zero_row` (the padding's zero row, or -1) is written as
// zeros and not gathered: padding is a large share of the slots, and all
// of it reading one table row would queue on one L2 slice.
// kPieces16 > 0: the rows are that many 16-byte pieces (a power of two, one
// team warp), known to the compiler; 0: the plan's copy size and count.
template <typename T, bool kImplicit, int kPieces16>
__device__ __forceinline__ void stage_chunk(float* y, float* w, const T* __restrict__ factors,
                                            int32_t idx, float val, int n, int K, float alpha,
                                            int words, int wsub, int wpr, int lane,
                                            int zero_row, const MmaPlan& p) {
  int piece = p.piece, pieces = p.pieces, log_tps = p.log_tps;
  if constexpr (kPieces16 > 0) {
    static_assert((kPieces16 & (kPieces16 - 1)) == 0 && kPieces16 <= 32, "pieces a power of two");
    piece = 16;
    pieces = kPieces16;
    log_tps = ilog2(kPieces16);
    wpr = 1;
    wsub = 0;
  }
  const int tps = 1 << log_tps;
#pragma unroll
  for (int e0 = wsub * 32; e0 < (kSlots << log_tps); e0 += wpr * 32) {
    const int e = e0 + lane;
    const int s = e >> log_tps, q0 = e & (tps - 1);
    const long long j = __shfl_sync(0xffffffffu, idx, s & (kSlots - 1));
    const float v = __shfl_sync(0xffffffffu, val, s & (kSlots - 1));
    if (s >= n) continue;
    const char* src = reinterpret_cast<const char*>(factors + j * K);
    char* dst = reinterpret_cast<char*>(y + s * words);
    for (int q = q0; q < pieces; q += tps) {
      if (j == zero_row) {
        if (piece == 16) {
          *reinterpret_cast<float4*>(dst + 16 * q) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (piece == 4) {
          reinterpret_cast<uint32_t*>(dst)[q] = 0u;
        } else {
          reinterpret_cast<uint16_t*>(dst)[q] = 0u;
        }
      } else if (piece == 16) {
        cp_async16(dst + 16 * q, src + 16 * q);
      } else if (piece == 4) {
        cp_async4(dst + 4 * q, src + 4 * q);
      } else {
        reinterpret_cast<uint16_t*>(dst)[q] = __ldg(reinterpret_cast<const unsigned short*>(src) + q);
      }
    }
    if (q0 == 0) {
      const float wg = kImplicit ? alpha * v : 1.0f;
      uint32_t hi, lo;
      split_fast(kImplicit ? 1.0f + wg : v, hi, lo);
      w[4 * s] = wg;
      w[4 * s + 1] = __uint_as_float(hi);
      w[4 * s + 2] = __uint_as_float(lo);
    }
  }
}

template <typename T>
__device__ __forceinline__ float staged(const T* row, int m, int K) {
  return m < K ? to_f32(row[m]) : 0.0f;
}

// c += a b in 3xTF32 with b given split (column g of the fragment, k = t
// and k = t + 4): the three products (a_lo b_hi, a_hi b_lo, then a_hi
// b_hi) sum into one zeroed fragment, which reaches c by f32 adds
// (mma_tf32.cuh: the tensor core truncates its sums, so a running sum is
// never fed back through it). kExactA: a is exact in TF32 (a widened
// bf16), so a.lo is zero and its product is skipped.
template <bool kExactA>
__device__ __forceinline__ void mma3_split(float (&c)[4], const tf32x3::FragA& a, uint32_t bh0,
                                           uint32_t bl0, uint32_t bh1, uint32_t bl1) {
  float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (!kExactA) tf32x3::mma_tf32(step, a.lo, bh0, bh1);
  tf32x3::mma_tf32(step, a.hi, bl0, bl1);
  tf32x3::mma_tf32(step, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += step[e];
}

// kFixedK: 0 for a rank given at run time, else the rank, known to the
// compiler (the recommendation template's 16), which then folds the tile
// layout, the slot stride and the column tests.
template <typename T, bool kImplicit, int kPer, int kFixedK>
__global__ void __launch_bounds__(kBlockThreads, 4) gram_rhs_mma_kernel(
    const int32_t* __restrict__ indices,  // [R, L]
    const float* __restrict__ values,     // [R, L]
    const T* __restrict__ factors,        // [S + 1, K]
    float* __restrict__ gram,             // [R, K, K]
    float* __restrict__ rhs,              // [R, K]
    int R, int L, int k_arg, float alpha, MmaPlan p) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  int K = k_arg, words = p.words;
  MmaShape sh = p.shape;
  if constexpr (kFixedK > 0) {
    constexpr MmaShape fixed = mma_shape(kFixedK);
    K = kFixedK;
    sh = fixed;
    words = slot_words(kFixedK, sizeof(T));
  }
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int team = warp / sh.wpr;       // this warp's row in the block
  const int wsub = warp - team * sh.wpr;  // and its place among the row's warps
  const long long row = static_cast<long long>(blockIdx.x) * sh.rows + team;
  if (team >= sh.rows || row >= R) return;  // no team barrier waits on these warps
  const int u0 = (sh.groups > 1 ? static_cast<int>(blockIdx.y) * kWarps : 0) + wsub;

  // this warp's unit: m-tile mi, n-tiles nb .. nb + cnt - 1 (cnt 0: it
  // only stages)
  int mi = 0, nb = 0, cnt = 0;
  if (u0 < sh.units) {
    int u = u0;
    for (int m = 0; m < sh.mt; ++m) {
      const int c = (sh.nt - 2 * m + sh.per - 1) / sh.per;
      if (u < c) {
        mi = m;
        nb = 2 * m + u * sh.per;
        cnt = min(sh.per, sh.nt - nb);
        break;
      }
      u -= c;
    }
  }
  float acc[kPer][4];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  // the padding's row is skipped only where it is zero, as the contract
  // says (a table whose last row is not zero is gathered like any other)
  int zero_row = p.sentinel;
  {
    const T* srow = factors + static_cast<long long>(p.sentinel) * K;
    bool nonzero = false;
    for (int e = lane; e < K; e += 32) nonzero |= to_f32(srow[e]) != 0.0f;
    if (__any_sync(0xffffffffu, nonzero)) zero_row = -1;
  }
  float* ring = smem + team * team_words(words);
  const int stage_words = kSlots * (words + 4);
  const int32_t* ridx = indices + row * L;
  const float* rval = values + row * L;
  const int nchunks = (L + kSlots - 1) / kSlots;
  constexpr int kPieces16 = kFixedK > 0 ? kFixedK * static_cast<int>(sizeof(T)) / 16 : 0;
  // lane l: the index and value of slot l of the next chunk to stage (the
  // slots past L, the sentinel's, are never staged)
  int32_t idx = 0;
  float val = 0.0f;
  if (lane < L) {
    idx = __ldg(ridx + lane);
    val = __ldg(rval + lane);
  }
  stage_chunk<T, kImplicit, kPieces16>(ring, ring + kSlots * words, factors, idx, val,
                                       min(kSlots, L), K, alpha, words, wsub, sh.wpr, lane,
                                       zero_row, p);
  cp_async_commit();
  if (kSlots + lane < L) {
    idx = __ldg(ridx + kSlots + lane);
    val = __ldg(rval + kSlots + lane);
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();      // chunk c has landed (the last chunk's copies end here)
    team_sync(team, sh.wpr);  // for the whole team; and chunk c - 1's stage is free
    if (c + 1 < nchunks) {    // chunk c + 1 into the other stage, in flight while c folds
      float* y = ring + ((c + 1) & 1) * stage_words;
      stage_chunk<T, kImplicit, kPieces16>(y, y + kSlots * words, factors, idx, val,
                                           min(kSlots, L - (c + 1) * kSlots), K, alpha, words,
                                           wsub, sh.wpr, lane, zero_row, p);
      cp_async_commit();
      const int l = (c + 2) * kSlots + lane;  // and chunk c + 2's indices and values
      if (l < L) {
        idx = __ldg(ridx + l);
        val = __ldg(rval + l);
      }
    }
    if (cnt == 0) continue;
    const float* yrow = ring + (c & 1) * stage_words;
    const float* wrow = yrow + kSlots * words;
    const int steps = min(kSlots, L - c * kSlots) >> 3;
#pragma unroll 2
    for (int st = 0; st < steps; ++st) {
      const int k0 = 8 * st;
      // w_gram and the split w_rhs of slots k0 + t and k0 + t + 4 (the
      // rhs column's B values)
      const float4 w0 = *reinterpret_cast<const float4*>(wrow + 4 * (k0 + t));
      const float4 w1 = *reinterpret_cast<const float4*>(wrow + 4 * (k0 + t + 4));
      const uint32_t rh0 = __float_as_uint(w0.y), rl0 = __float_as_uint(w0.z);
      const uint32_t rh1 = __float_as_uint(w1.y), rl1 = __float_as_uint(w1.z);
      const T* y0 = reinterpret_cast<const T*>(yrow + (k0 + t) * words);
      const T* y1 = reinterpret_cast<const T*>(yrow + (k0 + t + 4) * words);
      // A = Y^T of m-tile mi: (m, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const int m = 16 * mi + g;
      const float x[4] = {staged(y0, m, K), staged(y0, m + 8, K), staged(y1, m, K),
                          staged(y1, m + 8, K)};
      tf32x3::FragA a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kBf16) {
          a.hi[e] = __float_as_uint(x[e]);  // a widened bf16 is exact in TF32
          a.lo[e] = 0u;
        } else {
          split_fast(x[e], a.hi[e], a.lo[e]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (i >= cnt) break;
        const int ni = nb + i;
        const int n = 8 * ni + g;  // B's column: rows k = t and t + 4
        uint32_t bh0, bl0, bh1, bl1;
        if ((ni >> 1) == mi) {
          // a diagonal tile: its columns are rows of this A fragment (x0,
          // x2 for the first 8, x1, x3 for the next), already split where
          // the weight is 1
          const bool second = (ni & 1) != 0;  // selects, not an index: x and a stay in registers
          if constexpr (kImplicit) {
            split_fast(w0.x * (second ? x[1] : x[0]), bh0, bl0);
            split_fast(w1.x * (second ? x[3] : x[2]), bh1, bl1);
          } else {
            bh0 = second ? a.hi[1] : a.hi[0];
            bl0 = second ? a.lo[1] : a.lo[0];
            bh1 = second ? a.hi[3] : a.hi[2];
            bl1 = second ? a.lo[3] : a.lo[2];
          }
        } else if (8 * ni >= K) {
          bh0 = bl0 = bh1 = bl1 = 0u;  // columns past the Gram: the rhs alone
        } else {
          const float yb0 = staged(y0, n, K), yb1 = staged(y1, n, K);
          split_fast(kImplicit ? w0.x * yb0 : yb0, bh0, bl0);
          split_fast(kImplicit ? w1.x * yb1 : yb1, bh1, bl1);
        }
        if (n == K) {
          bh0 = rh0;
          bl0 = rl0;
          bh1 = rh1;
          bl1 = rl1;
        }
        mma3_split<kBf16>(acc[i], a, bh0, bl0, bh1, bl1);
      }
    }
  }
  if (cnt == 0) return;
  float* grow = gram + row * K * K;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i >= cnt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * mi + g + (e >= 2 ? 8 : 0);
      const int n = 8 * (nb + i) + 2 * t + (e & 1);
      if (m >= K || n < m || n > K) continue;  // padding, below the diagonal, past rhs
      const float v = acc[i][e];
      if (n == K) {
        rhs[row * K + m] = v;
      } else {
        grow[static_cast<long long>(m) * K + n] = v;
        if (n != m) grow[static_cast<long long>(n) * K + m] = v;
      }
    }
  }
}

template <typename T, bool kImplicit, int kPer, int kFixedK>
int launch_mma_kernel(const MmaPlan& p, const void* indices, const void* values,
                      const void* factors, void* gram, void* rhs, int R, int L, int K,
                      float alpha, cudaStream_t stream) {
  auto kernel = gram_rhs_mma_kernel<T, kImplicit, kPer, kFixedK>;
  if (p.smem > 48 * 1024) {  // above the static limit only after an opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(R) + p.shape.rows - 1) / p.shape.rows);  // one team a row
  kernel<<<dim3(blocks, p.shape.groups), kBlockThreads, p.smem, stream>>>(
      static_cast<const int32_t*>(indices), static_cast<const float*>(values),
      static_cast<const T*>(factors), static_cast<float*>(gram), static_cast<float*>(rhs),
      R, L, K, alpha, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kImplicit>
int launch_mma(const void* indices, const void* values, const void* factors, void* gram,
               void* rhs, int R, int L, int K, int table_rows, float alpha,
               cudaStream_t stream) {
  MmaPlan p;
  if (!mma_plan(K, table_rows, sizeof(T), reinterpret_cast<uintptr_t>(factors), &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kTemplateRank = 16;  // examples/recommendation/engine.json
  static_assert(mma_shape(kTemplateRank).per == 3, "rank 16: one warp, 3 tiles a row");
  if (K == kTemplateRank && p.piece == 16) {  // its copies are 16 bytes
    return launch_mma_kernel<T, kImplicit, 3, kTemplateRank>(p, indices, values, factors, gram,
                                                             rhs, R, L, K, alpha, stream);
  }
#define GRAM_MMA_CASE(N)                                                                   \
  case N:                                                                                  \
    return launch_mma_kernel<T, kImplicit, N, 0>(p, indices, values, factors, gram, rhs, R, \
                                                 L, K, alpha, stream);
  switch (p.shape.per) {
    GRAM_MMA_CASE(1) GRAM_MMA_CASE(2) GRAM_MMA_CASE(3) GRAM_MMA_CASE(4)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GRAM_MMA_CASE
}

}  // namespace

// 1 when rank K runs on the tensor-core instance, 0 on the SIMT one, -1
// when no instance takes it (ops/als_gram.py gram_instance agrees).
extern "C" int als_gram_instance(int K) {
  if (K < 1) return -1;
  if (K <= kMmaMaxRank) return 1;
  Plan p;
  return plan_for(K, &p) ? 0 : -1;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. `table_rows` is S + 1 (the last row
// is the padding's), `bf16` selects a bf16 factor table (else f32),
// `implicit` the implicit-feedback weights. R = 0 launches nothing.
extern "C" int als_gram_rhs_launch(
    const void* indices, const void* values, const void* factors,
    void* gram, void* rhs, int R, int L, int K, int table_rows, float alpha,
    int implicit, int bf16, void* stream) {
  if (K < 1 || L < 1 || R < 0 || table_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S1 = table_rows;
  if (K <= kMmaMaxRank) {
    if (bf16) {
      return implicit
          ? launch_mma<__nv_bfloat16, true>(indices, values, factors, gram, rhs, R, L, K, S1, alpha, s)
          : launch_mma<__nv_bfloat16, false>(indices, values, factors, gram, rhs, R, L, K, S1, alpha, s);
    }
    return implicit
        ? launch_mma<float, true>(indices, values, factors, gram, rhs, R, L, K, S1, alpha, s)
        : launch_mma<float, false>(indices, values, factors, gram, rhs, R, L, K, S1, alpha, s);
  }
  if (bf16) {
    return implicit
        ? launch_typed<__nv_bfloat16, true>(indices, values, factors, gram, rhs, R, L, K, alpha, s)
        : launch_typed<__nv_bfloat16, false>(indices, values, factors, gram, rhs, R, L, K, alpha, s);
  }
  return implicit
      ? launch_typed<float, true>(indices, values, factors, gram, rhs, R, L, K, alpha, s)
      : launch_typed<float, false>(indices, values, factors, gram, rhs, R, L, K, alpha, s);
}

