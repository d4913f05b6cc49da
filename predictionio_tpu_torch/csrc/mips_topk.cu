// Stage 1 of the two-stage MIPS retrieval: per-tile top-R over an int8
// block-quantized item table.
//
// Replaces the TPU kernel predictionio_tpu/ops/mips.py::mips_block_topk
// (inner `kernel`, ops/mips.py:129, pallas_call at :159). Same contract:
// for each (8-query block, item tile of BI rows) dequantize the tile with
// its f32 scale, score [8, BI] in f32, mask rows at or past num_items to
// -1e30 BEFORE selection, then R passes of max with the lowest-index
// tie-break, masking each pick to -2e30 so padding columns drain as
// distinct indices once the real rows are exhausted.
//
// What bounds it on an H100: the f32 arithmetic, 2*B*padded*K operations
// against 67 TFLOP/s outside the tensor cores, from about 12 queries a
// batch at 1M items x rank 16; below that the single pass over the int8
// table (K bytes per item) and the [B, nb, R] candidate writes, against
// 3.35 TB/s. The
// design: each block stages one int8 tile (BI*K bytes) in shared memory
// once and dequantizes each row once for all 8 queries of its block, so
// device memory sees the table once per query block (the 50 MB L2 holds
// the whole 16 MB table at 1M items x rank 16 between query blocks); the
// [8, BI] score tile never leaves shared memory, and the selection is
// warp-level: warp w owns query row w, each lane scans BI/32 columns and
// a __shfl_xor_sync butterfly reduces (value, index) pairs. It is the
// simple kernel; tensor-core scoring and a register-resident selection
// are later work.
//
// Any rank and tile size. While the query block, the whole [BI, K] tile
// and the [8, BI] score rows fit a block's 227 KB (rank 16 at 512-item
// tiles takes 25,088 bytes), the tile is staged in one pass as above.
// Past that it is staged in passes of at most 1,024 rows x 64 columns of
// K, each row's 8 sums carried from one pass to the next through the
// score rows (stored and reloaded as f32, so every score is summed in the
// same order, k = 0 .. K - 1, as in one pass): shared memory no longer
// grows with K. Score rows past 64 KB (BI > 2,048) go to a global scratch
// slice of each block, and the grid then holds only as many blocks as
// stay resident, each walking (tile, query block) pairs; the selection
// reads them there. A rank past 397 at 512-item tiles, or 8,192-item
// tiles at rank 16, take these paths (mips_block_topk_passes_kernel;
// mips_block_topk_kernel keeps the one-pass layout). The passes cost f32
// stores and reloads of the score rows, 8 per row and pass, and with
// global score rows the selection's R reads of each one come from L2.
//
// Layout: grid (num_blocks, B / 8), 256 threads (8 warps), or (resident
// blocks, 1) with the global score rows. Dynamic shared memory: q [8, K]
// f32 | tile [BI, K] int8 (padded to 16 bytes) | scores [8, BI] f32; in
// passes q [8, cols] | tile [rows, cols] | scores unless global.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // queries per block (the reference's BLOCK_QUERIES)
constexpr int kThreads = 256;   // 8 warps: warp w selects for query row w
constexpr float kNeg = -1e30f;  // padding rows (ops/mips.py _NEG)
constexpr float kSel = -2e30f;  // already-selected columns (ops/mips.py _SEL)

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  // value descending, then catalog index ascending: the first-match argmax
  return v > ov || (v == ov && i < oi);
}

// selection: warp w owns query row w of the block's [8, BI] scores; R
// passes of a warp arg-max, each pick masked to kSel by its owning lane
__device__ __forceinline__ void select_top_r(float* srow, int BI, int R, long long base,
                                             float* __restrict__ out_scores,
                                             int32_t* __restrict__ out_idx, long long out_base) {
  const int lane = threadIdx.x & 31;
  for (int step = 0; step < R; ++step) {
    float best = -CUDART_INF_F;
    int best_i = 0x7fffffff;
    for (int col = lane; col < BI; col += 32) {
      const float v = srow[col];
      if (better(v, col, best, best_i)) {
        best = v;
        best_i = col;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (better(ov, oi, best, best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      out_scores[out_base + step] = best;
      out_idx[out_base + step] = static_cast<int32_t>(base + best_i);
    }
    if ((best_i & 31) == lane) srow[best_i] = kSel;  // the owning lane masks its pick
    __syncwarp();
  }
}

// one (tile, query block) a block, the tile staged in one pass
__global__ void mips_block_topk_kernel(
    const float* __restrict__ queries,   // [B, K]
    const int8_t* __restrict__ table,    // [nb * BI, K]
    const float* __restrict__ scales,    // [nb]
    float* __restrict__ out_scores,      // [B, nb, R]
    int32_t* __restrict__ out_idx,       // [B, nb, R]
    int K, int BI, int R, int num_items, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                    // [8, K]
  int8_t* t_s = reinterpret_cast<int8_t*>(smem + kRows * K * 4);  // [BI, K]
  const int tile_bytes = (BI * K + 15) & ~15;
  float* s_s = reinterpret_cast<float*>(smem + kRows * K * 4 + tile_bytes);  // [8, BI]

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(tile) * BI;

  for (int e = tid; e < kRows * K; e += kThreads) {
    q_s[e] = queries[static_cast<long long>(row0) * K + e];
  }
  const int8_t* src = table + base * K;
  const int nbytes = BI * K;
  if ((nbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(t_s);
    for (int e = tid; e < nbytes / 16; e += kThreads) dst4[e] = src4[e];
  } else {
    for (int e = tid; e < nbytes; e += kThreads) t_s[e] = src[e];
  }
  __syncthreads();

  // scoring: one thread per tile row at a time, dequantized once and
  // dotted with all 8 queries (dequantize first, then the f32 dot: the
  // reference's order, ops/mips.py:137-142)
  const float scale = scales[tile];
  for (int col = tid; col < BI; col += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = 0.0f;
    const int8_t* row = t_s + col * K;
    for (int k = 0; k < K; ++k) {
      const float g = static_cast<float>(row[k]) * scale;
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[b] = fmaf(q_s[b * K + k], g, acc[b]);
    }
    const bool live = base + col < num_items;
#pragma unroll
    for (int b = 0; b < kRows; ++b) s_s[b * BI + col] = live ? acc[b] : kNeg;
  }
  __syncthreads();

  // selection: warp w owns query row w
  const int warp = tid >> 5;
  select_top_r(s_s + warp * BI, BI, R, base, out_scores, out_idx,
               (static_cast<long long>(row0 + warp) * nb + tile) * R);
}

// staging of one pass and where the score rows live, for (K, BI)
struct Plan {
  bool passes;         // staged in passes (mips_block_topk_passes_kernel)
  int rows, cols;      // tile rows and K columns staged per pass
  bool global_scores;  // score rows in the caller's scratch, not shared memory
  long long smem;      // dynamic shared memory bytes
};

constexpr long long kMaxSmemBytes = 232448;  // what one block may use on Hopper
constexpr int kPassCols = 64;                // K columns a pass past one stage
constexpr int kPassRows = 1024;              // tile rows a pass past one stage
constexpr long long kMaxSmemScores = 65536;  // score rows kept in shared memory up to this

__host__ __device__ __forceinline__ long long round16(long long x) { return (x + 15) & ~15LL; }

Plan plan_for(int K, int BI) {
  const long long whole = kRows * K * 4LL + round16(static_cast<long long>(BI) * K) + kRows * BI * 4LL;
  if (whole <= kMaxSmemBytes) return {false, BI, K, false, whole};
  const int cols = K < kPassCols ? K : kPassCols;
  const int rows = BI < kPassRows ? BI : kPassRows;
  const bool global = kRows * BI * 4LL > kMaxSmemScores;
  return {true, rows, cols, global,
          kRows * cols * 4LL + round16(static_cast<long long>(rows) * cols) + (global ? 0 : kRows * BI * 4LL)};
}

// the tile staged in passes of rows x cols; with kGlobalScores the score
// rows in the block's scratch slice and (tile, query block) pairs walked
template <bool kGlobalScores>
__global__ void mips_block_topk_passes_kernel(
    const float* __restrict__ queries,   // [B, K]
    const int8_t* __restrict__ table,    // [nb * BI, K]
    const float* __restrict__ scales,    // [nb]
    float* __restrict__ out_scores,      // [B, nb, R]
    int32_t* __restrict__ out_idx,       // [B, nb, R]
    float* __restrict__ scratch,         // [gridDim.x, 8, BI] when kGlobalScores
    int K, int BI, int R, int num_items, int nb, int query_blocks, int rows, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                       // [8, cols]
  int8_t* t_s = reinterpret_cast<int8_t*>(smem + kRows * cols * 4);  // [rows, cols]
  const int tile_bytes = (rows * cols + 15) & ~15;
  float* s_s = kGlobalScores  // [8, BI]
      ? scratch + static_cast<long long>(blockIdx.x) * kRows * BI
      : reinterpret_cast<float*>(smem + kRows * cols * 4 + tile_bytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // one (tile, query block) pair a block with the grid (nb, query_blocks);
  // a walk over them with the grid of resident blocks
  const long long pairs = static_cast<long long>(nb) * query_blocks;
  for (long long p = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x; p < pairs;
       p += static_cast<long long>(gridDim.x) * gridDim.y) {
    const int tile = static_cast<int>(p % nb);
    const int row0 = static_cast<int>(p / nb) * kRows;
    const long long base = static_cast<long long>(tile) * BI;
    const float scale = scales[tile];

    // scoring: one thread per tile row at a time, dequantized once and
    // dotted with all 8 queries (dequantize first, then the f32 dot: the
    // reference's order, ops/mips.py:137-142), pass by pass
    for (int r0 = 0; r0 < BI; r0 += rows) {
      const int nr = min(rows, BI - r0);
      for (int c0 = 0; c0 < K; c0 += cols) {
        const int nc = min(cols, K - c0);
        __syncthreads();  // the last pass's (or the last pair's selection) reads are done
        for (int e = tid; e < kRows * nc; e += kThreads) {
          const int b = e / nc;
          q_s[e] = queries[static_cast<long long>(row0 + b) * K + c0 + (e - b * nc)];
        }
        const int8_t* src = table + (base + r0) * K + c0;
        if (nc == K) {  // whole rows: one contiguous run of nr * K bytes
          const int nbytes = nr * K;
          if ((nbytes & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            const int4* src4 = reinterpret_cast<const int4*>(src);
            int4* dst4 = reinterpret_cast<int4*>(t_s);
            for (int e = tid; e < nbytes / 16; e += kThreads) dst4[e] = src4[e];
          } else {
            for (int e = tid; e < nbytes; e += kThreads) t_s[e] = src[e];
          }
        } else if ((nc & 15) == 0 && (K & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          const int vecs = nc / 16;  // 16-byte runs of a row's columns
          int4* dst4 = reinterpret_cast<int4*>(t_s);
          for (int e = tid; e < nr * vecs; e += kThreads) {
            const int r = e / vecs;
            dst4[e] = *reinterpret_cast<const int4*>(src + static_cast<long long>(r) * K +
                                                     (e - r * vecs) * 16);
          }
        } else {
          for (int e = tid; e < nr * nc; e += kThreads) {
            const int r = e / nc;
            t_s[e] = src[static_cast<long long>(r) * K + (e - r * nc)];
          }
        }
        __syncthreads();
        const bool last = c0 + nc >= K;
        for (int col = r0 + tid; col < r0 + nr; col += kThreads) {
          float acc[kRows];
#pragma unroll
          for (int b = 0; b < kRows; ++b) acc[b] = c0 == 0 ? 0.0f : s_s[b * BI + col];
          const int8_t* row = t_s + (col - r0) * nc;
          for (int k = 0; k < nc; ++k) {
            const float g = static_cast<float>(row[k]) * scale;
#pragma unroll
            for (int b = 0; b < kRows; ++b) acc[b] = fmaf(q_s[b * nc + k], g, acc[b]);
          }
          const bool dead = last && base + col >= num_items;  // padding, masked once summed
#pragma unroll
          for (int b = 0; b < kRows; ++b) s_s[b * BI + col] = dead ? kNeg : acc[b];
        }
      }
    }
    __syncthreads();

    // selection: warp w owns query row w
    select_top_r(s_s + warp * BI, BI, R, base, out_scores, out_idx,
                 (static_cast<long long>(row0 + warp) * nb + tile) * R);
  }
}

// the grid of a launch: (nb, B / 8), or with global score rows the blocks
// that stay resident (at most one per pair); 0 blocks on an error
cudaError_t grid_for(const Plan& p, int B, int nb, dim3* grid) {
  const int query_blocks = B / kRows;
  if (!p.global_scores) {
    *grid = dim3(nb, query_blocks);
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(mips_block_topk_passes_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p.smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mips_block_topk_passes_kernel<true>,
                                                        kThreads, p.smem);
  }
  if (err != cudaSuccess) return err;
  const long long pairs = static_cast<long long>(nb) * query_blocks;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = dim3(static_cast<unsigned>(pairs < resident ? pairs : resident));
  return cudaSuccess;
}

}  // namespace

// Bytes of dynamic shared memory a launch at rank K and tile size BI uses.
extern "C" int mips_block_topk_smem_bytes(int K, int BI) {
  return static_cast<int>(plan_for(K, BI).smem);
}

// Floats of global scratch a launch needs (0 when the score rows stay in
// shared memory), or -1 on a CUDA error: 8 BI for each resident block.
extern "C" long long mips_block_topk_scratch_floats(int B, int K, int BI, int nb) {
  const Plan p = plan_for(K, BI);
  if (!p.global_scores) return 0;
  dim3 grid;
  if (grid_for(p, B, nb, &grid) != cudaSuccess) return -1;
  return static_cast<long long>(grid.x) * kRows * BI;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch (too much shared memory, a bad grid) reaches the caller.
// `scratch` holds mips_block_topk_scratch_floats(B, K, BI, nb) floats.
extern "C" int mips_block_topk_launch(
    const void* queries, const void* table, const void* scales,
    void* out_scores, void* out_idx, void* scratch,
    int B, int K, int BI, int R, int num_items, int nb, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B % kRows || K < 1 || BI < 1 || R < 1 || R > BI || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan_for(K, BI);
  if (p.smem > kMaxSmemBytes || (p.global_scores && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(queries);
  const auto* tq = static_cast<const int8_t*>(table);
  const auto* sf = static_cast<const float*>(scales);
  auto* os = static_cast<float*>(out_scores);
  auto* oi = static_cast<int32_t*>(out_idx);
  const int smem = static_cast<int>(p.smem);
  dim3 grid;
  cudaError_t err = grid_for(p, B, nb, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!p.passes) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(mips_block_topk_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    mips_block_topk_kernel<<<grid, kThreads, smem, s>>>(qf, tq, sf, os, oi, K, BI, R, num_items, nb);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = p.global_scores ? mips_block_topk_passes_kernel<true>
                                : mips_block_topk_passes_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, s>>>(qf, tq, sf, os, oi, static_cast<float*>(scratch), K, BI, R,
                                      num_items, nb, B / kRows, p.rows, p.cols);
  return static_cast<int>(cudaGetLastError());
}
