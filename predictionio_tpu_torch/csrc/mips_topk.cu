// Stage 1 of the two-stage MIPS retrieval: per-tile top-R over an int8
// block-quantized item table.
//
// Replaces the TPU kernel predictionio_tpu/ops/mips.py::mips_block_topk
// (inner `kernel`, ops/mips.py:129, pallas_call at :159). Same contract:
// for each (query, item tile of BI rows) score the tile against the query
// in f32 with its scale, mask rows at or past num_items to -1e30 BEFORE
// selection, then the top R by value with the lowest index first among
// equal values, which is what the reference's R passes of a first-match
// arg-max give when each pick is masked to -2e30 (padding columns drain
// as distinct indices once the real rows are exhausted).
//
// Two instances, chosen by (K, R) (mips_block_topk_instance;
// ops/mips.py mips_instance agrees):
//
// R <= 64 and K <= 2048: mips_mma_kernel. A block is 8 warps and owns one
//   tile and a group of NQ x 8 queries (NQ = 4 from 32 queries a batch, 2
//   from 16, else 1, fewer where shared memory says so); consecutive
//   blocks share a tile, so it crosses L2 B / (8 NQ) times and device
//   memory about once. The tile is walked in sub-tiles of 512 columns.
//   Scoring, on the tensor cores with exact operands: mma.sync m16n8k16
//   with bf16 operands and f32 accumulators, items as A (16 rows), 8
//   queries as B (n = 8). The quantizer clips to [-127, 127], so every
//   int8 item value is exact in bf16 (8 significant bits); each f32 query
//   value splits into three bf16 terms hi + mid + lo that sum to it
//   exactly, and int8 x bf16 products are exact, so the three mma give
//   the exact products, summed by the tensor core. (The other form, two
//   TF32 terms on m16n8k8, drops about 2^-22 of each query value and
//   needs four mma per 16 k where this needs three.) The k index is
//   permuted so that a lane's A values are whole words of the int8 row:
//   lane (g, t) reads bytes 4t..4t+3 of each 16-column step (K <= 16) or
//   8t..8t+7 of each 32-column chunk (one 32-byte sector per row and quad
//   of lanes), straight from global memory into registers; the next
//   chunk's words, and the next sub-tile's first, are in flight while the
//   current ones are used. The query fragments are split once a block
//   into shared memory in the same order. K pads with zeros to the chunk;
//   rows past the tile load as zeros and their columns are never selected.
//   Each 16-column step sums its three products into a zeroed fragment
//   (smallest term first) that reaches the running sum by an f32 add: the
//   tensor core truncates its sums, so a running sum fed back through it
//   would drift an ulp a step (mma_tf32.cuh). At K <= 16 (one step) the
//   fragments of one n-tile at a time go straight to the score rows. The
//   tile's scale multiplies each finished sum once; the sums of a
//   sub-tile, [NQ x 8, 512] f32, go to shared memory.
//   Selection, reading each score once from shared memory on its common
//   path: warp w owns query rows w, w + 8, ..; a lane holds 16 of a row's
//   sums in registers. For R <= 32, the R-th largest of the 32 lane maxima
//   (a warp bitonic sort, the warp's rows sorted together) is a lower
//   bound on the R-th largest sum, since the maxima are distinct elements;
//   only sums at or above it survive (22 of 512 expected at R = 16 on
//   random data), one bit each. A warp prefix sum places each lane's survivors in
//   the warp's candidate buffer as 64-bit keys whose unsigned order is the
//   selection's (value descending, -0 as +0, then index ascending), and
//   each candidate's rank is the count of larger keys; rank < R goes to
//   output slot rank. Past 192 survivors (an all-equal tile) the row is
//   read again into registers, and for R > 32 once: R passes of a shuffle
//   arg-max over the registers, each pick masked to -2e30, then ranks over
//   those R. A tile of more than 512 columns keeps each query's running
//   top R in shared memory: a later sub-tile's sums survive only above the
//   running R-th value as well (an equal value loses to it: its index is
//   larger), and ranks are counted over the running list and the
//   survivors together; the top R of a tile is the top R of the union of
//   its sub-tiles' top R.
//   What bounds it on an H100: at 1M items x rank 16 and B = 256 the
//   products, 2 B x items x K operations, take 0.025 ms at a third of the
//   tensor cores' bf16 rate (three terms; chip_smoke.py stage1_bound) and
//   the bytes (the int8 table once, the [B, nb, R] candidates) 0.024 ms at
//   3.35 TB/s. The kernel is bound by the instructions it issues instead:
//   per 512 sums of a query the selection's reads, maxima, sort, bitmask
//   and ranks, and per fragment the scale and the stores to shared memory.
//
// R > 64 or K > 2048: mips_block_topk_passes_kernel, the SIMT form. Per
//   (tile, 8 queries) a block stages the tile in passes of at most 1,024
//   rows x 64 columns of K, each row's 8 sums carried from one pass to the
//   next through the f32 score rows (one thread a row, dequantized once
//   for all 8 queries); score rows past 64 KB (BI > 2,048) go to a global
//   scratch slice of each block, and the grid then holds only as many
//   blocks as stay resident, each walking (tile, query block) pairs. The
//   selection is R passes of a warp arg-max over the score row, each pick
//   masked to -2e30 by its owning lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // queries an n-tile (the reference's BLOCK_QUERIES)
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // padding rows (ops/mips.py _NEG)
constexpr float kSel = -2e30f;  // already-selected columns (ops/mips.py _SEL)
constexpr long long kMaxSmemBytes = 232448;  // what one block may use on Hopper

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  // value descending, then catalog index ascending: the first-match argmax
  return v > ov || (v == ov && i < oi);
}

// ---------------------------------------------------------------------------
// The tensor-core instance

constexpr int kSub = 512;                    // tile columns a block scores and selects at once
constexpr int kRowStride = kSub + 4;         // score row stride in floats (see the epilogue)
constexpr int kPerLane = kSub / 32;          // scores a lane holds during the selection
constexpr int kMTiles = kSub / 16 / kWarps;  // 16-column m-tiles a warp scores: 4
constexpr int kMaxThresholdR = 32;           // R up to this: the threshold filter
constexpr int kMaxMmaR = 64;                 // R past this: the passes kernel
constexpr int kMaxMmaK = 2048;               // K past this: the passes kernel
constexpr int kCap = 192;                    // survivors a warp's buffer holds
constexpr int kCandSlots = kCap + kMaxMmaR;  // and the running list ahead of them

// a candidate (value, column within the tile) as one key whose unsigned
// order is the selection's: value descending (-0 taken as +0), then
// column ascending
using Key = unsigned long long;

__device__ __forceinline__ Key key_of(float v, int col) {
  uint32_t u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<Key>(u) << 32 | static_cast<uint32_t>(~col);
}

__device__ __forceinline__ float value_of(Key k) {
  const uint32_t u = static_cast<uint32_t>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int column_of(Key k) { return static_cast<int>(~static_cast<uint32_t>(k)); }

// c += a b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// four int8 (bytes 0..3 of w) -> two bf16 pairs, exactly: (b0, b1) and
// (b2, b3), the lower k in the lower half. 2^23 + (b + 128) is exact in
// f32; subtracting 2^23 + 128 leaves b, whose bf16 is its top half.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) - 8388736.0f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

// x = hi + mid + lo exactly (each rest is exact in f32, and the last one
// has at most 8 significant bits)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r);
  r -= __bfloat162float(m);
  hi = bf16_bits(h);
  mid = bf16_bits(m);
  lo = bf16_bits(__float2bfloat16_rn(r));
}

// The first k of the four a lane (t = lane % 4) holds at 16-column step s:
// with W words a lane per chunk of 16 W columns, bytes 4 W t + 4 (s % W)
// of chunk s / W. Lane t's A columns 2t, 2t + 1, 2t + 8, 2t + 9 of the
// step are these four k in order, and so are its B rows.
template <int W>
__device__ __forceinline__ int k_of(int s, int t) {
  return (s / W) * 16 * W + 4 * W * t + 4 * (s % W);
}

// W words of one int8 row from k0 on, zero past K or for a dead row;
// `vec`: K and the table's address allow whole-word loads
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const int8_t* __restrict__ row, int k0,
                                           int K, bool vec, bool live) {
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u;
  if (!live) return;
  if (vec) {
    if (k0 >= K) return;  // K is a multiple of 4 W: a word is all in or all out
    if constexpr (W == 1) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(row + k0));
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(row + k0));
      w[0] = x.x;
      w[1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int b = 0; b < 4 * W; ++b) {
    if (k0 + b < K) w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k0 + b])) << (8 * (b % 4));
  }
}

// chunk c of the lane's 2 x kMTiles rows of sub-tile columns c0 + .. of
// the tile at `tile_rows` (width: the sub-tile's columns)
template <int W>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[kMTiles][2][W], const int8_t* __restrict__ tile_rows,
                                           int c0, int width, int c, int K, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = (warp + kWarps * m) * 16 + (lane >> 2) + 8 * h;
      load_words<W>(w[m][h], tile_rows + static_cast<long long>(c0 + col) * K, k_of<W>(c * W, lane & 3), K,
                    vec, col < width);
    }
}

// for each of N rows, the R-th largest (R <= 32) of the 32 lanes' x[r]:
// a bitonic sort of the warp into descending order, then lane R - 1's
// value; the N rows' shuffles are independent and overlap
template <int N>
__device__ __forceinline__ void rth_largest(float (&x)[N], int R) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool keep_max = ((lane & j) == 0) == ((lane & k) == 0);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float y = __shfl_xor_sync(0xffffffffu, x[r], j);
        x[r] = keep_max ? fmaxf(x[r], y) : fminf(x[r], y);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = __shfl_sync(0xffffffffu, x[r], R - 1);
}

// a row's 16 sums of the lane, v[4i + e] = column 128 i + 4 lane + e;
// columns past a last, narrow sub-tile read as -inf (never selected)
__device__ __forceinline__ void read_row(const float* row, int width, float (&v)[kPerLane]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPerLane / 4; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 128 * i + 4 * lane);
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
  if (width < kSub) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (128 * (j / 4) + 4 * lane + (j % 4) >= width) v[j] = -CUDART_INF_F;
    }
  }
}

// The rest of one row's selection over a sub-tile, once its survivors
// are known: `mask` (bit j: the lane's v[j] survives), `before` (the
// warp's survivors on lower lanes) and `n` (all of them; past kCap, the
// register passes run instead). `run` holds the running top R of the
// tile's earlier sub-tiles when `merge`; the top R of it and this
// sub-tile goes back to `run`, or with `last` to the output slots from
// out_base on. `cand`: the warp's candidate buffer.
__device__ __forceinline__ void finish_row(const float* row, int width, int c0, int R, Key* run,
                                           bool merge, bool last, Key* cand, uint32_t mask,
                                           int before, int n, float* __restrict__ out_scores,
                                           int32_t* __restrict__ out_idx, long long out_base,
                                           long long base) {
  const int lane = threadIdx.x & 31;
  // the running list heads the candidates
  const int n_prev = merge ? R : 0;
  for (int c = lane; c < n_prev; c += 32) cand[c] = run[c];
  if (n <= kCap) {
    int o = n_prev + before;
    while (mask) {  // a survivor's value, read the second time
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int col = 128 * (j >> 2) + 4 * lane + (j & 3);
      cand[o++] = key_of(row[col], c0 + col);
    }
  } else {
    // R passes of a warp arg-max over the registers: the sub-tile's top R
    // (all of it when a last sub-tile is narrower than R)
    float v[kPerLane];
    read_row(row, width, v);
    n = min(R, width);
    for (int step = 0; step < n; ++step) {
      float best = -CUDART_INF_F;
      int best_i = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = 128 * (j / 4) + 4 * lane + (j % 4);
        if (better(v[j], col, best, best_i)) {
          best = v[j];
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
      if (lane == 0) cand[n_prev + step] = key_of(best, c0 + best_i);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (128 * (j / 4) + 4 * lane + (j % 4) == best_i) v[j] = kSel;  // the owner masks its pick
      }
    }
  }
  __syncwarp();

  // each candidate's rank among them all; rank < R is kept
  const int total = n_prev + n;
  for (int b0 = 0; b0 < total; b0 += 32) {
    const int c = b0 + lane;
    const Key me = c < total ? cand[c] : 0ull;
    int rank = 0;
#pragma unroll 4
    for (int d = 0; d < total; ++d) rank += cand[d] > me ? 1 : 0;
    if (c < total && rank < R) {
      if (!last) {
        run[rank] = me;
      } else {
        out_scores[out_base + rank] = value_of(me);
        out_idx[out_base + rank] = static_cast<int32_t>(base + column_of(me));
      }
    }
  }
  __syncwarp();
}

// The selection of warp w's rows w + 8 j (j < nrows) of the block's score
// rows over one sub-tile of `width` columns from c0 on; row j's running
// list at runs + (8 j + w) R, its output slots from out0 + j out_step.
// For R <= 32 the threshold stage runs for all rows at once: each row's
// sums read once into registers, the R-th largest of the 32 lane maxima
// as the lower bound (the maxima are distinct elements, so the R-th
// largest sum is at least it; with `merge`, a survivor must also beat the
// running R-th, which an equal value cannot: its index is larger), and
// each lane's survivors as a bitmask.
template <int NQ>
__device__ __forceinline__ void select_rows(const float* s_s, int nrows, int width, int c0, int R,
                                            Key* runs, bool merge, bool last, Key* cand,
                                            float* __restrict__ out_scores,
                                            int32_t* __restrict__ out_idx, long long out0,
                                            long long out_step, long long base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t mask[NQ];
  int before[NQ], n[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    mask[j] = 0u;
    before[j] = 0;
    n[j] = kCap + 1;  // R > 32: the register passes
  }
  if (R <= kMaxThresholdR) {
    float v[NQ][kPerLane], t[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      read_row(s_s + (j * kRows + warp) * kRowStride, width, v[j]);
      t[j] = v[j][0];
#pragma unroll
      for (int i = 1; i < kPerLane; ++i) t[j] = fmaxf(t[j], v[j][i]);
    }
    rth_largest<NQ>(t, R);
    int incl[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float floor_v = merge && j < nrows
                                ? nextafterf(value_of(runs[(j * kRows + warp) * R + R - 1]), CUDART_INF_F)
                                : -3.402823466e38f;
      const float T = fmaxf(t[j], floor_v);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) mask[j] |= (v[j][i] >= T ? 1u : 0u) << i;
      incl[j] = __popc(mask[j]);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int y = __shfl_up_sync(0xffffffffu, incl[j], off);
        if (lane >= off) incl[j] += y;
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      n[j] = __shfl_sync(0xffffffffu, incl[j], 31);
      before[j] = incl[j] - __popc(mask[j]);
    }
  }
#pragma unroll 1
  for (int j = 0; j < nrows; ++j) {
    uint32_t mj = 0u;
    int bj = 0, nj = 0;
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      if (r == j) {
        mj = mask[r];
        bj = before[r];
        nj = n[r];
      }
    }
    const int q = j * kRows + warp;
    finish_row(s_s + q * kRowStride, width, c0, R, runs + q * R, merge, last, cand, mj, bj, nj,
               out_scores, out_idx, out0 + j * out_step, base);
  }
}

// shared memory of the tensor-core instance: the split query fragments
// [NQ][steps][3][32] uint2 | score rows [NQ x 8][kRowStride] f32 | each
// warp's candidates [8][kCap + 64] | past one sub-tile, each query's
// running list [NQ x 8][R]
__host__ __device__ __forceinline__ long long mma_smem(int nq, int steps, int BI, int R) {
  return nq * steps * 3LL * 32 * 8 + nq * kRows * kRowStride * 4LL + kWarps * kCandSlots * 8LL +
         (BI > kSub ? nq * kRows * 1LL * R * 8 : 0);
}

// a warp's finished 16 x 8 fragments of n-tile j (its m-tiles warp + 8 m)
// to the score rows: the scale once, and with kMasked the columns at or
// past `live` (num_items counted from the sub-tile's first row) set to
// kNeg. Lane (g, t) holds columns g, g + 8 for queries 2t, 2t + 1; the
// row stride, 4 mod 16 floats, puts the 32 lanes on 32 banks. Columns
// past a narrow last sub-tile are stored too and ignored by the selection.
template <bool kMasked>
__device__ __forceinline__ void store_scores(float* s_s, const float (&acc)[kMTiles][4], int j,
                                             float scale, int live) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float* dst = s_s + (j * kRows + 2 * t) * kRowStride + warp * 16 + g;
#pragma unroll
  for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = kWarps * 16 * m + 8 * (e >> 1);  // column, less warp * 16 + g
      float x = acc[m][e] * scale;
      if (kMasked && warp * 16 + g + off >= live) x = kNeg;
      dst[(e & 1) * kRowStride + off] = x;
    }
  }
}

// blocks an SM each instance is compiled for: K <= 16 with 4 or 2 n-tiles
// capped at 128 registers (two blocks), 1 n-tile at 85 (three); the K > 16
// instances keep their accumulators without a cap (capped, they spill and
// run slower)
__host__ __device__ constexpr int min_blocks(int nq, int w) { return w == 2 ? 1 : nq == 1 ? 3 : 2; }

// one (tile, group of NQ x 8 queries) a block; W: words of int8 a lane
// loads per row and chunk (1 for K <= 16, else 2); steps: 16-column
// steps of the padded K
template <int NQ, int W>
__global__ void __launch_bounds__(kThreads, min_blocks(NQ, W)) mips_mma_kernel(
    const float* __restrict__ queries,   // [B, K]
    const int8_t* __restrict__ table,    // [nb * BI, K]
    const float* __restrict__ scales,    // [nb]
    float* __restrict__ out_scores,      // [B, nb, R]
    int32_t* __restrict__ out_idx,       // [B, nb, R]
    int B, int K, int BI, int R, int num_items, int nb, int qgroups, int steps, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* qf = reinterpret_cast<uint2*>(smem);
  float* s_s = reinterpret_cast<float*>(smem + NQ * steps * 3 * 32 * 8);
  Key* cands = reinterpret_cast<Key*>(s_s + NQ * kRows * kRowStride);  // [8][kCandSlots]
  Key* runs = cands + kWarps * kCandSlots;                              // [NQ x 8][R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = static_cast<int>(blockIdx.x % qgroups);
  const int tile = static_cast<int>(blockIdx.x / qgroups);
  const int row0 = qg * NQ * kRows;
  const long long base = static_cast<long long>(tile) * BI;
  const int8_t* tile_rows = table + base * K;
  const float scale = scales[tile];
  const int chunks = steps / W;
  const int nsub = (BI + kSub - 1) / kSub;

  // the first chunk's table words fly while the queries are split
  uint32_t cur[kMTiles][2][W];
  load_chunk<W>(cur, tile_rows, 0, min(kSub, BI), 0, K, vec);

  // the block's queries split into bf16 terms, in B-fragment order: entry
  // (j, s, term, lane) holds query row0 + 8 j + g at k_of(s, t) .. + 3
  for (int e = tid; e < NQ * steps * 32; e += kThreads) {
    const int l = e & 31, s = (e >> 5) % steps, j = (e >> 5) / steps;
    const int row = row0 + j * kRows + (l >> 2);
    const int k0 = k_of<W>(s, l & 3);
    uint32_t h[4], m[4], o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = row < B && k0 + i < K ? queries[static_cast<long long>(row) * K + k0 + i] : 0.0f;
      split3(x, h[i], m[i], o[i]);
    }
    uint2* dst = qf + (j * steps + s) * 3 * 32 + l;
    dst[0] = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    dst[32] = make_uint2(m[0] | m[1] << 16, m[2] | m[3] << 16);
    dst[64] = make_uint2(o[0] | o[1] << 16, o[2] | o[3] << 16);
  }
  __syncthreads();

  for (int sub = 0; sub < nsub; ++sub) {
    const int c0 = sub * kSub;
    const int width = min(kSub, BI - c0);
    const long long rest = num_items - base - c0;  // rows of the sub-tile below num_items
    const int live = rest < kSub ? static_cast<int>(rest) : kSub;  // may be <= 0

    // scoring: warp w owns m-tiles w, w + 8, w + 16, w + 24 of the sub-tile
    const bool masked = live < width;  // padding rows in this sub-tile
    if constexpr (W == 1) {
      // one 16-column step: the A fragments once, then one n-tile at a
      // time straight to the score rows (16 accumulators live). Every
      // m-tile is scored: columns past the tile load as zeros.
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        int8x4_to_bf16(cur[m][0][0], a[m][0], a[m][2]);  // row g
        int8x4_to_bf16(cur[m][1][0], a[m][1], a[m][3]);  // row g + 8
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (row0 + j * kRows >= B) continue;
        const uint2* f = qf + j * 3 * 32 + lane;
        const uint2 bh = f[0], bm = f[32], bl = f[64];
        float acc[kMTiles][4];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
          mma_bf16(acc[m], a[m], bl);
        }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) mma_bf16(acc[m], a[m], bm);
#pragma unroll
        for (int m = 0; m < kMTiles; ++m) mma_bf16(acc[m], a[m], bh);
        if (masked) {
          store_scores<true>(s_s, acc, j, scale, live);
        } else {
          store_scores<false>(s_s, acc, j, scale, live);
        }
      }
    } else {
      float acc[NQ][kMTiles][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        uint32_t nxt[kMTiles][2][W];
        if (c + 1 < chunks) load_chunk<W>(nxt, tile_rows, c0, width, c + 1, K, vec);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int s = c * W + w;
          uint32_t a[kMTiles][4];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            int8x4_to_bf16(cur[m][0][w], a[m][0], a[m][2]);  // row g
            int8x4_to_bf16(cur[m][1][w], a[m][1], a[m][3]);  // row g + 8
          }
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            if (row0 + j * kRows >= B) continue;
            const uint2* f = qf + (j * steps + s) * 3 * 32 + lane;
            const uint2 bh = f[0], bm = f[32], bl = f[64];
            float step[kMTiles][4];
#pragma unroll
            for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
              for (int e = 0; e < 4; ++e) step[m][e] = 0.0f;
              mma_bf16(step[m], a[m], bl);
            }
#pragma unroll
            for (int m = 0; m < kMTiles; ++m) mma_bf16(step[m], a[m], bm);
#pragma unroll
            for (int m = 0; m < kMTiles; ++m) {
              mma_bf16(step[m], a[m], bh);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][m][e] += step[m][e];
            }
          }
        }
        if (c + 1 < chunks) {
#pragma unroll
          for (int m = 0; m < kMTiles; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int w = 0; w < W; ++w) cur[m][h][w] = nxt[m][h][w];
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (row0 + j * kRows >= B) continue;
        if (masked) {
          store_scores<true>(s_s, acc[j], j, scale, live);
        } else {
          store_scores<false>(s_s, acc[j], j, scale, live);
        }
      }
    }
    // the next sub-tile's first words fly during the selection
    if (sub + 1 < nsub) load_chunk<W>(cur, tile_rows, c0 + kSub, min(kSub, BI - c0 - kSub), 0, K, vec);
    __syncthreads();

    // selection: warp w owns rows w, w + 8, ..
    const int nrows = min(NQ, (B - row0) / kRows);
    select_rows<NQ>(s_s, nrows, width, c0, R, runs, sub > 0, sub + 1 == nsub,
                    cands + warp * kCandSlots, out_scores, out_idx,
                    (static_cast<long long>(row0 + warp) * nb + tile) * R,
                    static_cast<long long>(kRows) * nb * R, base);
    __syncthreads();  // the next sub-tile's scoring rewrites the rows
  }
}

// ---------------------------------------------------------------------------
// The SIMT passes instance (R > 64 or K > 2048)

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

// staging of one pass and where the score rows live, for (K, BI)
struct Plan {
  int rows, cols;      // tile rows and K columns staged per pass
  bool global_scores;  // score rows in the caller's scratch, not shared memory
  long long smem;      // dynamic shared memory bytes
};

constexpr int kPassCols = 64;                // K columns a pass
constexpr int kPassRows = 1024;              // tile rows a pass
constexpr long long kMaxSmemScores = 65536;  // score rows kept in shared memory up to this

__host__ __device__ __forceinline__ long long round16(long long x) { return (x + 15) & ~15LL; }

Plan passes_plan(int K, int BI) {
  const int cols = K < kPassCols ? K : kPassCols;
  const int rows = BI < kPassRows ? BI : kPassRows;
  const bool global = kRows * BI * 4LL > kMaxSmemScores;
  return {rows, cols, global,
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

// the grid of a passes launch: (nb, B / 8), or with global score rows the
// blocks that stay resident (at most one per pair)
cudaError_t passes_grid(const Plan& p, int B, int nb, dim3* grid) {
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

// ---------------------------------------------------------------------------
// Instance choice and launch

bool use_mma(int K, int R) { return R <= kMaxMmaR && K <= kMaxMmaK; }

// 16-column steps of K padded to the chunk (16 columns for K <= 16, else 32)
int mma_steps(int K) { return K <= 16 ? 1 : 2 * ((K + 31) / 32); }

// query groups of NQ n-tiles: 4 from 32 queries, 2 from 16, else 1, fewer
// while the shared memory would pass a block's
int mma_nq(int B, int K, int BI, int R) {
  int nq = B >= 4 * kRows ? 4 : B >= 2 * kRows ? 2 : 1;
  while (nq > 1 && mma_smem(nq, mma_steps(K), BI, R) > kMaxSmemBytes) nq >>= 1;
  return nq;
}

template <int NQ, int W>
cudaError_t launch_mma(const float* q, const int8_t* t, const float* s, float* os, int32_t* oi, int B,
                       int K, int BI, int R, int num_items, int nb, bool vec, cudaStream_t stream) {
  const int steps = mma_steps(K);
  const long long smem = mma_smem(NQ, steps, BI, R);
  const long long qgroups = (B + NQ * kRows - 1) / (NQ * kRows);
  const long long blocks = qgroups * nb;
  if (smem > kMaxSmemBytes || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = mips_mma_kernel<NQ, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      q, t, s, os, oi, B, K, BI, R, num_items, nb, static_cast<int>(qgroups), steps, vec);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_mma_w(int nq, const float* q, const int8_t* t, const float* s, float* os, int32_t* oi,
                         int B, int K, int BI, int R, int num_items, int nb, bool vec,
                         cudaStream_t stream) {
  if (nq == 4) return launch_mma<4, W>(q, t, s, os, oi, B, K, BI, R, num_items, nb, vec, stream);
  if (nq == 2) return launch_mma<2, W>(q, t, s, os, oi, B, K, BI, R, num_items, nb, vec, stream);
  return launch_mma<1, W>(q, t, s, os, oi, B, K, BI, R, num_items, nb, vec, stream);
}

}  // namespace

// Which instance runs (K, R): 0 the tensor-core one, 1 the passes one
// (ops/mips.py mips_instance agrees). BI does not enter the choice.
extern "C" int mips_block_topk_instance(int K, int BI, int R) {
  (void)BI;
  return use_mma(K, R) ? 0 : 1;
}

// Bytes of dynamic shared memory a launch at (B, K, BI, R) uses.
extern "C" int mips_block_topk_smem_bytes(int B, int K, int BI, int R) {
  if (use_mma(K, R)) return static_cast<int>(mma_smem(mma_nq(B, K, BI, R), mma_steps(K), BI, R));
  return static_cast<int>(passes_plan(K, BI).smem);
}

// Floats of global scratch a launch needs (0 unless the passes instance
// keeps its score rows there: 8 BI for each resident block), or -1 on a
// CUDA error.
extern "C" long long mips_block_topk_scratch_floats(int B, int K, int BI, int R, int nb) {
  if (use_mma(K, R)) return 0;
  const Plan p = passes_plan(K, BI);
  if (!p.global_scores) return 0;
  dim3 grid;
  if (passes_grid(p, B, nb, &grid) != cudaSuccess) return -1;
  return static_cast<long long>(grid.x) * kRows * BI;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch (too much shared memory, a bad grid) reaches the caller.
// `scratch` holds mips_block_topk_scratch_floats(B, K, BI, R, nb) floats.
extern "C" int mips_block_topk_launch(
    const void* queries, const void* table, const void* scales,
    void* out_scores, void* out_idx, void* scratch,
    int B, int K, int BI, int R, int num_items, int nb, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || B % kRows || K < 1 || BI < 1 || R < 1 || R > BI || nb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(queries);
  const auto* tq = static_cast<const int8_t*>(table);
  const auto* sf = static_cast<const float*>(scales);
  auto* os = static_cast<float*>(out_scores);
  auto* oi = static_cast<int32_t*>(out_idx);
  if (use_mma(K, R)) {
    const int nq = mma_nq(B, K, BI, R);
    if (K <= 16) {
      const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 4 == 0;
      return static_cast<int>(launch_mma_w<1>(nq, qf, tq, sf, os, oi, B, K, BI, R, num_items, nb, vec, s));
    }
    const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0;
    return static_cast<int>(launch_mma_w<2>(nq, qf, tq, sf, os, oi, B, K, BI, R, num_items, nb, vec, s));
  }
  const Plan p = passes_plan(K, BI);
  if (p.smem > kMaxSmemBytes || (p.global_scores && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(p.smem);
  dim3 grid;
  cudaError_t err = passes_grid(p, B, nb, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
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
