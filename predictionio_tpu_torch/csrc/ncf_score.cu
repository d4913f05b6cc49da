// Fused NeuMF head: one user scored against every item of the catalog.
//
// Replaces the TPU kernel predictionio_tpu/models/ncf/kernel.py::
// _ncf_score_kernel (kernel.py:32, pallas_call at :121, built by
// make_all_items_scorer :70). Same function, for the depth-2 tower:
//   score[i] = sum_e (gmf_item[i,e] * gmf_u[e]) * wog[e]
//            + sum_m relu(relu(mlp_u @ W0u + mlp_item[i] @ W0i + b0) @ W1 + b1)[m] * woh[m]
//            + bo
// with f32 item tables [I, E], user rows [E], W0u/W0i [E, H0] (the two
// halves of the first dense kernel), W1 [H0, H1], b0 [H0], b1 [H1],
// wog [E], woh [H1], bo [1]; the output is exactly [I] f32.
//
// What bounds it on an H100: f32 operations. Each item costs
// 2 E H0 + 2 H0 H1 + 3 E + 2 H1 + H0 + H1 operations (the two layers,
// the gmf term, the output dot and the relus: 8,448 at E=32, H0=64,
// H1=32: 0.126 ms at 67 TFLOP/s for 1,000,000 items), against two table
// rows of E f32 read once (256 MB, 0.077 ms at 3.35 TB/s).
//
// Design. The TPU kernel streams (1024, E) item tiles through VMEM and
// runs both dense layers on the MXU. Here the weights (about 17 KB at
// the template's widths) are staged once per block in shared memory,
// zero-padded to multiples of 8 outputs, together with the user's part
// of the first layer, c0 = mlp_u @ W0u + b0 (computed once per block, so
// the user row never goes through a separate launch). Blocks walk tiles
// of 128 items (a grid-stride loop over at most as many blocks as stay
// resident); one thread scores one item. Each tile's table rows are
// staged with coalesced loads into shared memory, transposed (column
// t holds item t, one padding float per row keeps the stores free of
// bank conflicts), first the GMF rows, then the MLP rows. A thread then
// folds its column against 8 output columns at a time: one scalar
// shared load and two float4 broadcast loads per 8 FMAs, the 8 sums in
// registers. The first hidden layer goes to a per-thread shared column
// and feeds the second, whose outputs fold straight into the score. It
// is the simple kernel: tensor cores, register tiling of several items
// per thread and cp.async/TMA staging are later work.
//
// Wider towers. The weights stay in shared memory, staged once a block,
// while they fit there beside a 128-item tile and two such blocks fit an
// SM (the "resident" layout: E=32, H0=64, H1=32 take 66,432 bytes; up to
// about E=48 with hidden 96, 48). Past that a second kernel (the "wide"
// layout) splits each item's hidden columns over the warps of a block, so
// a block keeps 8 warps busy on only 32 items and several blocks fit an
// SM (3 at 64/(256, 128), 2 at 128/(512, 256)): lane l of every warp
// owns item l of the tile, and warp w folds output columns [8w, 8w + 8)
// of each 64-column run. The weights stream through one shared window of
// 64 rows x 64 columns (W0i's rows e, then W1's rows j), every warp
// reading its 8 columns of it with the same float4 broadcasts as the
// resident layout. The first hidden layer of the 32 items goes to shared
// memory, [H0p][32], and feeds the second, whose outputs fold into each
// warp's share of the score; the 8 shares are added in warp order. The
// wide layout holds the transposed tile, E (32 + 1) floats, and that
// first hidden layer, 32 H0p: widths past what a block's 227 KB holds
// (H0 about 1,500 at E=64, with H1 = H0 / 2) are refused, the launch
// returning cudaErrorInvalidValue and ncf_score_smem_bytes -1.
//
// Layout, resident: grid min(tiles, resident blocks), 128 threads, dynamic
// shared memory (E H0p + H0p H1p + H0p + 2 H1p + 2E + E (128 + 1) +
// 128 H0p) floats, H0p and H1p rounded up to 8 (66,432 bytes at 32/64/32).
// Wide: 256 threads, (64 * 64 + H0p + 2 H1p + 2E + 256 + E (32 + 1) +
// 32 H0p) floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;       // output columns folded per pass
constexpr size_t kMaxSmemBytes = 232448;  // what one block may use on Hopper
constexpr size_t kSmemPerSm = 233472;     // an H100 SM's shared memory
constexpr size_t kSmemReserved = 1024;    // what the runtime keeps per block

// the resident layout: one item a thread, 128 a tile
constexpr int kThreads = 128;
constexpr int kStride = kThreads + 1;

// the wide layout: 32 items a tile, 8 warps over the hidden columns, a
// window of 64 weight rows x 64 columns (8 a warp)
constexpr int kWideItems = 32;
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideStride = kWideItems + 1;
constexpr int kWinRows = 64;
constexpr int kWinCols = kChunk * kWideWarps;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// floats of shared memory of the resident layout
__host__ __device__ __forceinline__ size_t resident_floats(int E, int H0, int H1) {
  const size_t h0p = round_up(H0, kChunk), h1p = round_up(H1, kChunk);
  return E * h0p + h0p * h1p + h0p + 2 * h1p + 2 * (size_t)E
       + (size_t)E * kStride + (size_t)kThreads * h0p;
}

// floats of shared memory of the wide layout
__host__ __device__ __forceinline__ size_t wide_floats(int E, int H0, int H1) {
  const size_t h0p = round_up(H0, kChunk), h1p = round_up(H1, kChunk);
  return kWinRows * kWinCols + h0p + 2 * h1p + 2 * (size_t)E + kWideThreads
       + (size_t)E * kWideStride + (size_t)kWideItems * h0p;
}

// 8 weights of a zero-padded shared row from column jc (float4 loads)
__device__ __forceinline__ void weights8(float (&w)[kChunk], const float* row, int jc) {
  const float4 a = *reinterpret_cast<const float4*>(row + jc);
  const float4 b = *reinterpret_cast<const float4*>(row + jc + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// the per-block constants both layouts stage: c0 = mlp_u @ W0u + b0, b1,
// woh (zero-padded to H0p, H1p), the user's gmf row and wog
__device__ __forceinline__ void stage_vectors(
    float* c0_s, float* b1_s, float* woh_s, float* gu_s, float* wog_s,
    const float* __restrict__ gmf_u, const float* __restrict__ mlp_u,
    const float* __restrict__ w0u, const float* __restrict__ b0,
    const float* __restrict__ b1, const float* __restrict__ wog,
    const float* __restrict__ woh, int E, int H0, int H1, int h0p, int h1p) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int m = tid; m < h1p; m += nt) {
    b1_s[m] = m < H1 ? b1[m] : 0.0f;
    woh_s[m] = m < H1 ? woh[m] : 0.0f;
  }
  for (int e = tid; e < E; e += nt) {
    gu_s[e] = gmf_u[e];
    wog_s[e] = wog[e];
  }
  for (int j = tid; j < h0p; j += nt) {
    float acc = 0.0f;  // padded columns stay 0: relu(0) adds nothing below
    if (j < H0) {
      for (int e = 0; e < E; ++e) acc = fmaf(mlp_u[e], w0u[e * H0 + j], acc);
      acc += b0[j];
    }
    c0_s[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) ncf_score_kernel(
    const float* __restrict__ gmf_item,   // [I, E]
    const float* __restrict__ mlp_item,   // [I, E]
    const float* __restrict__ gmf_u,      // [E]
    const float* __restrict__ mlp_u,      // [E]
    const float* __restrict__ w0u,        // [E, H0]
    const float* __restrict__ w0i,        // [E, H0]
    const float* __restrict__ b0,         // [H0]
    const float* __restrict__ w1,         // [H0, H1]
    const float* __restrict__ b1,         // [H1]
    const float* __restrict__ wog,        // [E]
    const float* __restrict__ woh,        // [H1]
    const float* __restrict__ bo,         // [1]
    float* __restrict__ out,              // [I]
    int I, int E, int H0, int H1) {
  extern __shared__ __align__(16) float smem[];
  const int h0p = round_up(H0, kChunk);
  const int h1p = round_up(H1, kChunk);
  // every segment starts at a multiple of 8 floats, so the float4 loads
  // of w0i_s and w1_s rows are aligned
  float* w0i_s = smem;                    // [E][h0p]
  float* w1_s = w0i_s + E * h0p;          // [h0p][h1p]
  float* c0_s = w1_s + h0p * h1p;         // [h0p]  mlp_u @ W0u + b0
  float* b1_s = c0_s + h0p;               // [h1p]
  float* woh_s = b1_s + h1p;              // [h1p]
  float* gu_s = woh_s + h1p;              // [E]
  float* wog_s = gu_s + E;                // [E]
  float* x_s = wog_s + E;                 // [E][kStride]  a tile's rows, transposed
  float* h_s = x_s + E * kStride;         // [h0p][kThreads]  first hidden layer

  const int tid = threadIdx.x;
  for (int k = tid; k < E * h0p; k += kThreads) {
    const int e = k / h0p, j = k - e * h0p;
    w0i_s[k] = j < H0 ? w0i[e * H0 + j] : 0.0f;
  }
  for (int k = tid; k < h0p * h1p; k += kThreads) {
    const int j = k / h1p, m = k - j * h1p;
    w1_s[k] = (j < H0 && m < H1) ? w1[j * H1 + m] : 0.0f;
  }
  stage_vectors(c0_s, b1_s, woh_s, gu_s, wog_s, gmf_u, mlp_u, w0u, b0, b1, wog, woh,
                E, H0, H1, h0p, h1p);
  const float bias_out = bo[0];

  const long long tiles = (static_cast<long long>(I) + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * kThreads;
    const int n = static_cast<int>(min(static_cast<long long>(kThreads), I - base));
    const bool live = tid < n;

    // GMF branch: stage the tile's gmf rows, fold the thread's column
    __syncthreads();  // the weights are staged; the last tile's x_s reads are done
    for (int k = tid; k < n * E; k += kThreads) {
      const int t = k / E, e = k - t * E;
      x_s[e * kStride + t] = gmf_item[base * E + k];
    }
    __syncthreads();
    float gsum = 0.0f;
    if (live) {
      for (int e = 0; e < E; ++e) {
        gsum = fmaf(x_s[e * kStride + tid] * gu_s[e], wog_s[e], gsum);
      }
    }

    // MLP branch: stage the tile's mlp rows, then the two dense layers
    __syncthreads();
    for (int k = tid; k < n * E; k += kThreads) {
      const int t = k / E, e = k - t * E;
      x_s[e * kStride + t] = mlp_item[base * E + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int jc = 0; jc < h0p; jc += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = c0_s[jc + q];
      for (int e = 0; e < E; ++e) {
        const float xe = x_s[e * kStride + tid];
        float w[kChunk];
        weights8(w, w0i_s + e * h0p, jc);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) acc[q] = fmaf(xe, w[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q) h_s[(jc + q) * kThreads + tid] = fmaxf(acc[q], 0.0f);
    }
    float hsum = 0.0f;
    for (int mc = 0; mc < h1p; mc += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = b1_s[mc + q];
      for (int j = 0; j < h0p; ++j) {
        const float hj = h_s[j * kThreads + tid];  // the thread's own column
        float w[kChunk];
        weights8(w, w1_s + j * h1p, mc);
#pragma unroll
        for (int q = 0; q < kChunk; ++q) acc[q] = fmaf(hj, w[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q) hsum = fmaf(fmaxf(acc[q], 0.0f), woh_s[mc + q], hsum);
    }
    out[base + tid] = gsum + hsum + bias_out;
  }
}

// rows [r0, r0 + rows) x columns [c0, c0 + 64) of a [*, ld] matrix into the
// window, zeros past column `cols`
__device__ __forceinline__ void stage_window(float* win_s, const float* __restrict__ src,
                                             int ld, int r0, int rows, int c0, int cols) {
  for (int k = threadIdx.x; k < rows * kWinCols; k += kWideThreads) {
    const int r = k / kWinCols, c = k - r * kWinCols;
    win_s[k] = c0 + c < cols ? src[static_cast<long long>(r0 + r) * ld + c0 + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kWideThreads) ncf_score_wide_kernel(
    const float* __restrict__ gmf_item, const float* __restrict__ mlp_item,
    const float* __restrict__ gmf_u, const float* __restrict__ mlp_u,
    const float* __restrict__ w0u, const float* __restrict__ w0i,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ wog,
    const float* __restrict__ woh, const float* __restrict__ bo,
    float* __restrict__ out, int I, int E, int H0, int H1) {
  extern __shared__ __align__(16) float smem[];
  const int h0p = round_up(H0, kChunk);
  const int h1p = round_up(H1, kChunk);
  float* win_s = smem;                          // [kWinRows][kWinCols]  weights
  float* c0_s = win_s + kWinRows * kWinCols;    // [h0p]
  float* b1_s = c0_s + h0p;                     // [h1p]
  float* woh_s = b1_s + h1p;                    // [h1p]
  float* gu_s = woh_s + h1p;                    // [E]
  float* wog_s = gu_s + E;                      // [E]
  float* part_s = wog_s + E;                    // [kWideWarps][kWideItems]  score shares
  float* x_s = part_s + kWideThreads;           // [E][kWideStride]  a tile's rows, transposed
  float* h_s = x_s + E * kWideStride;           // [h0p][kWideItems]  first hidden layer

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;   // lane: the item; warp: its columns
  stage_vectors(c0_s, b1_s, woh_s, gu_s, wog_s, gmf_u, mlp_u, w0u, b0, b1, wog, woh,
                E, H0, H1, h0p, h1p);
  const float bias_out = bo[0];

  const long long tiles = (static_cast<long long>(I) + kWideItems - 1) / kWideItems;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * kWideItems;
    const int n = static_cast<int>(min(static_cast<long long>(kWideItems), I - base));

    // GMF branch: each warp folds every 8th e of its lane's item (items
    // past n are zero rows, their scores never stored)
    __syncthreads();  // the vectors are staged; the last tile's reads are done
    for (int k = tid; k < kWideItems * E; k += kWideThreads) {
      const int t = k / E, e = k - t * E;
      x_s[e * kWideStride + t] = t < n ? gmf_item[base * E + k] : 0.0f;
    }
    __syncthreads();
    float part = 0.0f;
    for (int e = warp; e < E; e += kWideWarps) {
      part = fmaf(x_s[e * kWideStride + lane] * gu_s[e], wog_s[e], part);
    }
    __syncthreads();
    for (int k = tid; k < kWideItems * E; k += kWideThreads) {
      const int t = k / E, e = k - t * E;
      x_s[e * kWideStride + t] = t < n ? mlp_item[base * E + k] : 0.0f;
    }

    // first layer, 64 columns a pass, 8 a warp, W0i's rows through the window
    for (int j0 = 0; j0 < h0p; j0 += kWinCols) {
      const int jc = j0 + kChunk * warp;
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = jc < h0p ? c0_s[jc + q] : 0.0f;
      for (int e0 = 0; e0 < E; e0 += kWinRows) {
        const int rows = min(kWinRows, E - e0);
        __syncthreads();  // x_s is staged; the window's last reads are done
        stage_window(win_s, w0i, H0, e0, rows, j0, H0);
        __syncthreads();
        if (jc >= h0p) continue;  // warp-uniform: no columns left for this warp
        for (int r = 0; r < rows; ++r) {
          const float xe = x_s[(e0 + r) * kWideStride + lane];
          float w[kChunk];
          weights8(w, win_s + r * kWinCols, kChunk * warp);
#pragma unroll
          for (int q = 0; q < kChunk; ++q) acc[q] = fmaf(xe, w[q], acc[q]);
        }
      }
      if (jc < h0p) {
#pragma unroll
        for (int q = 0; q < kChunk; ++q) h_s[(jc + q) * kWideItems + lane] = fmaxf(acc[q], 0.0f);
      }
    }

    // second layer, 64 columns a pass, W1's rows through the window, each
    // output folded into the warp's share of its item's score
    for (int m0 = 0; m0 < h1p; m0 += kWinCols) {
      const int mc = m0 + kChunk * warp;
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = mc < h1p ? b1_s[mc + q] : 0.0f;
      for (int r0 = 0; r0 < H0; r0 += kWinRows) {
        const int rows = min(kWinRows, H0 - r0);
        __syncthreads();  // h_s is written; the window's last reads are done
        stage_window(win_s, w1, H1, r0, rows, m0, H1);
        __syncthreads();
        if (mc >= h1p) continue;
        for (int r = 0; r < rows; ++r) {
          const float hj = h_s[(r0 + r) * kWideItems + lane];
          float w[kChunk];
          weights8(w, win_s + r * kWinCols, kChunk * warp);
#pragma unroll
          for (int q = 0; q < kChunk; ++q) acc[q] = fmaf(hj, w[q], acc[q]);
        }
      }
      if (mc < h1p) {
#pragma unroll
        for (int q = 0; q < kChunk; ++q) part = fmaf(fmaxf(acc[q], 0.0f), woh_s[mc + q], part);
      }
    }

    // the item's score: the 8 warps' shares in warp order
    part_s[warp * kWideItems + lane] = part;
    __syncthreads();
    if (warp == 0 && lane < n) {
      float score = 0.0f;
#pragma unroll
      for (int w = 0; w < kWideWarps; ++w) score += part_s[w * kWideItems + lane];
      out[base + lane] = score + bias_out;
    }
  }
}

// The block layout for these widths: resident when W0i and W1 fit beside
// a 128-item tile with room for two such blocks an SM (one block of 4
// warps leaves the SM mostly idle), else wide when its tile and first
// hidden layer fit.
struct Plan {
  bool resident;
  size_t smem;
};

bool plan_for(int E, int H0, int H1, Plan* p) {
  constexpr size_t kMaxFloats = kMaxSmemBytes / sizeof(float);
  if (2 * (resident_floats(E, H0, H1) * sizeof(float) + kSmemReserved) <= kSmemPerSm) {
    *p = {true, resident_floats(E, H0, H1) * sizeof(float)};
    return true;
  }
  if (wide_floats(E, H0, H1) <= kMaxFloats) {
    *p = {false, wide_floats(E, H0, H1) * sizeof(float)};
    return true;
  }
  return false;
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int items, const Plan& p, const void* gmf_item,
           const void* mlp_item, const void* gmf_u, const void* mlp_u, const void* w0u,
           const void* w0i, const void* b0, const void* w1, const void* b1, const void* wog,
           const void* woh, const void* bo, void* out, int I, int E, int H0, int H1,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, p.smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long tiles = (static_cast<long long>(I) + items - 1) / items;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, threads, p.smem, stream>>>(
      static_cast<const float*>(gmf_item), static_cast<const float*>(mlp_item),
      static_cast<const float*>(gmf_u), static_cast<const float*>(mlp_u),
      static_cast<const float*>(w0u), static_cast<const float*>(w0i),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wog),
      static_cast<const float*>(woh), static_cast<const float*>(bo),
      static_cast<float*>(out), I, E, H0, H1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths uses, or -1 when
// no layout fits the card's 227 KB a block (the wrapper refuses those).
extern "C" int ncf_score_smem_bytes(int E, int H0, int H1) {
  Plan p;
  return plan_for(E, H0, H1, &p) ? static_cast<int>(p.smem) : -1;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. I = 0 launches nothing.
extern "C" int ncf_score_launch(
    const void* gmf_item, const void* mlp_item, const void* gmf_u, const void* mlp_u,
    const void* w0u, const void* w0i, const void* b0, const void* w1, const void* b1,
    const void* wog, const void* woh, const void* bo, void* out,
    int I, int E, int H0, int H1, void* stream) {
  if (I < 0 || E < 1 || H0 < 1 || H1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (I == 0) return 0;
  Plan p;
  if (!plan_for(E, H0, H1, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.resident) {
    return launch(ncf_score_kernel, kThreads, kThreads, p, gmf_item, mlp_item, gmf_u, mlp_u,
                  w0u, w0i, b0, w1, b1, wog, woh, bo, out, I, E, H0, H1, s);
  }
  return launch(ncf_score_wide_kernel, kWideThreads, kWideItems, p, gmf_item, mlp_item, gmf_u,
                mlp_u, w0u, w0i, b0, w1, b1, wog, woh, bo, out, I, E, H0, H1, s);
}
