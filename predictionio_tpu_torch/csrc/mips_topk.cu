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
// Layout: grid (num_blocks, B / 8), 256 threads (8 warps). Dynamic shared
// memory: q [8, K] f32 | tile [BI, K] int8 (padded to 16 bytes) |
// scores [8, BI] f32.

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

  // selection: warp w owns query row w; R passes of a warp arg-max
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* srow = s_s + warp * BI;
  const long long out_base =
      (static_cast<long long>(row0 + warp) * nb + tile) * R;
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

}  // namespace

extern "C" int mips_block_topk_smem_bytes(int K, int BI) {
  return kRows * K * 4 + ((BI * K + 15) & ~15) + kRows * BI * 4;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch (too much shared memory, a bad grid) reaches the caller.
extern "C" int mips_block_topk_launch(
    const void* queries, const void* table, const void* scales,
    void* out_scores, void* out_idx,
    int B, int K, int BI, int R, int num_items, int nb, void* stream) {
  const int smem = mips_block_topk_smem_bytes(K, BI);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mips_block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(nb, B / kRows);
  mips_block_topk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const int8_t*>(table),
      static_cast<const float*>(scales), static_cast<float*>(out_scores),
      static_cast<int32_t*>(out_idx), K, BI, R, num_items, nb);
  return static_cast<int>(cudaGetLastError());
}
