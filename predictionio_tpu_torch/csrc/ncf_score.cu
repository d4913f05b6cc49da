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
// Layout: grid min(tiles, resident blocks), 128 threads, dynamic shared
// memory (E H0p + H0p H1p + H0p + 2 H1p + 2E + E (128 + 1) + 128 H0p)
// floats, H0p and H1p rounded up to 8 (66,432 bytes at 32/64/32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // items per tile, one per thread
constexpr int kChunk = 8;       // output columns folded per pass
constexpr int kStride = kThreads + 1;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ __forceinline__ size_t smem_floats(int E, int H0, int H1) {
  const size_t h0p = round_up(H0, kChunk), h1p = round_up(H1, kChunk);
  return E * h0p + h0p * h1p + h0p + 2 * h1p + 2 * (size_t)E
       + (size_t)E * kStride + (size_t)kThreads * h0p;
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
  for (int m = tid; m < h1p; m += kThreads) {
    b1_s[m] = m < H1 ? b1[m] : 0.0f;
    woh_s[m] = m < H1 ? woh[m] : 0.0f;
  }
  for (int e = tid; e < E; e += kThreads) {
    gu_s[e] = gmf_u[e];
    wog_s[e] = wog[e];
  }
  for (int j = tid; j < h0p; j += kThreads) {
    float acc = 0.0f;  // padded columns stay 0: relu(0) adds nothing below
    if (j < H0) {
      for (int e = 0; e < E; ++e) acc = fmaf(mlp_u[e], w0u[e * H0 + j], acc);
      acc += b0[j];
    }
    c0_s[j] = acc;
  }
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
        const float4 wa = *reinterpret_cast<const float4*>(w0i_s + e * h0p + jc);
        const float4 wb = *reinterpret_cast<const float4*>(w0i_s + e * h0p + jc + 4);
        acc[0] = fmaf(xe, wa.x, acc[0]);
        acc[1] = fmaf(xe, wa.y, acc[1]);
        acc[2] = fmaf(xe, wa.z, acc[2]);
        acc[3] = fmaf(xe, wa.w, acc[3]);
        acc[4] = fmaf(xe, wb.x, acc[4]);
        acc[5] = fmaf(xe, wb.y, acc[5]);
        acc[6] = fmaf(xe, wb.z, acc[6]);
        acc[7] = fmaf(xe, wb.w, acc[7]);
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
        const float4 wa = *reinterpret_cast<const float4*>(w1_s + j * h1p + mc);
        const float4 wb = *reinterpret_cast<const float4*>(w1_s + j * h1p + mc + 4);
        acc[0] = fmaf(hj, wa.x, acc[0]);
        acc[1] = fmaf(hj, wa.y, acc[1]);
        acc[2] = fmaf(hj, wa.z, acc[2]);
        acc[3] = fmaf(hj, wa.w, acc[3]);
        acc[4] = fmaf(hj, wb.x, acc[4]);
        acc[5] = fmaf(hj, wb.y, acc[5]);
        acc[6] = fmaf(hj, wb.z, acc[6]);
        acc[7] = fmaf(hj, wb.w, acc[7]);
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q) hsum = fmaf(fmaxf(acc[q], 0.0f), woh_s[mc + q], hsum);
    }
    out[base + tid] = gsum + hsum + bias_out;
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths needs (the
// wrapper refuses widths above the card's 227 KB a block).
extern "C" int ncf_score_smem_bytes(int E, int H0, int H1) {
  return static_cast<int>(smem_floats(E, H0, H1) * sizeof(float));
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
  const size_t smem = smem_floats(E, H0, H1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ncf_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, ncf_score_kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long tiles = (static_cast<long long>(I) + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  ncf_score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gmf_item), static_cast<const float*>(mlp_item),
      static_cast<const float*>(gmf_u), static_cast<const float*>(mlp_u),
      static_cast<const float*>(w0u), static_cast<const float*>(w0i),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wog),
      static_cast<const float*>(woh), static_cast<const float*>(bo),
      static_cast<float*>(out), I, E, H0, H1);
  return static_cast<int>(cudaGetLastError());
}
