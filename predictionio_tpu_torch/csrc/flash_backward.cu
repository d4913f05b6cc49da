// Flash attention's backward as one kernel: delta, dq, dk and dv in one
// launch, the five tile products on the tensor cores in 3xTF32.
//
// Replaces the two backward TPU kernels of
// predictionio_tpu/ops/flash_attention.py and the delta einsum beside them:
//   _dq_kernel (:106, pallas_call :313): dq = sum_k dS k,
//   _dkv_kernel (:148, :326): dv = sum_q P dO, dk = sum_q dS q,
//   delta = rowsum(dO o O) (:294-296),
// with P = exp(s - lse) rebuilt from the forward's lse, s = (q . k) *
// scale on valid pairs (the key valid in the mask and, with `causal`, not
// after the query), dP = dO . v and dS = P (dP - delta) * scale. A query
// row with no valid key and a masked key get exactly 0 gradient: P is
// forced to 0 by the validity flag before the exp (its argument becomes
// -inf), so rows whose lse is about -1e30 cannot overflow.
//
// Layout. q, k and v are the public [B, T, H, D] tensors read through their
// batch and time strides (sb, st; heads D apart, features contiguous); dO, O
// and dq, dk, dv are contiguous [B, T, H, D]; lse is [B, H, T]; the mask is
// [B, T] bytes (0 = invalid key) or null. Rows past T are zero-filled.
//
// What bounds it on an H100. Inputs read once and outputs written once:
// q, k, v, dO, O, dq, dk, dv (32 B T H D bytes) plus the mask and lse. At
// the sequence template's B=256, H=2, T=64, D=16 that is 16.9 MB, 5.1 us at
// 3.35 TB/s, against 10 D operations per causal valid pair (S, dP, dV, dK,
// dQ) plus 2 D per row for delta: bytes. At B=16, T=1024 the same count is
// 2.69 GFLOP: operations. 3xTF32 runs three TF32 products per f32 one, so
// the tensor cores' 495 TFLOP/s give the products an f32 roof of 165
// TFLOP/s, 2.5x above the f32 units' 67: 16.3 us.
//
// Design. One block per (b, h, 64-key tile), 4 warps; each warp owns 16 of
// the keys (one m16 fragment). The block stages its K and V tile once, then
// walks the query tiles from the diagonal (causal) or from 0 to T. Per
// query tile it stages Q and dO, the lse rows, and computes the tile's
// delta rows while dO and O stream in (a shuffle over the lanes of a row).
// Each warp forms S^T = K Q^T and dP^T = V dO^T for its 16 keys x 64
// queries (mma.sync m16n8k8), turns them into P^T and dS^T in registers,
// and accumulates dV += P^T dO and dK += dS^T Q straight from those
// registers: an accumulator fragment is an A fragment once the k index is
// permuted (A column t <-> query 2t, column t + 4 <-> query 2t + 1, and B
// rows loaded to match), so P and dS never leave the warp for these two.
// dS^T goes to shared memory once; after a barrier each warp computes dQ
// for 16 query rows over the tile's 64 keys. With one key tile (T <= 64,
// the training shape) the block owns the whole (b, h) slice and stores dq:
// deterministic. With more, each block adds its dS K into a dq the wrapper
// zeroes, with f32 atomicAdd (FlashAttention-2's scheme): those sums change
// order from run to run, within the same tolerance. dK and dV are written
// once at the end.
//
// Precision: every product is 3xTF32 with f32 adds into the running sums
// (mma_tf32.cuh), where one TF32 product would miss the 2e-5 tolerance the
// kernel is held to.
//
// Against the two one-thread-per-row kernels (a dq one and a dk, dv one)
// that it replaced: (1) s, P and dP are formed once per pair, not once in
// each kernel, and delta needs no launch of its own; (2) 4-warp blocks of tensor-core
// fragments replace one thread per row and its serial FMA chain of D, and
// the query tile's two passes keep 4 such blocks resident on an SM; (3)
// causal masking skips whole 16 x 8 fragments that lie above the diagonal,
// warp-uniformly, and the dQ pass stops at the warp's last key; (4) tiles
// stage as float4 loads (scalar ones when an input is not 16-byte
// aligned), row strides padded to D + 4 and 72 so fragment reads are free
// of bank conflicts; (5) all five products run on the tensor cores.
// wgmma and TMA are later work: at D = 16 a tile is 4 KB.
//
// Head dims 8, 16, 32, 64 and 128 are built (the wrapper zero-pads any
// other D up to 128 to the next of them). At D = 128 a block holds 154,176
// bytes of shared memory and dK, dV take 128 accumulator registers a
// thread, so that instance runs one block an SM and may spill.
//
// Head dims past 128, a multiple of 64 (the wrapper zero-pads others up to
// one), run the chunked instance, built from the D = 64 instance's
// fragments so that neither registers nor shared memory (62,784 bytes,
// three blocks an SM) grow with D. A grid dimension runs over the D / 64
// chunks: block (b, h, key tile, chunk c) owns dK_c and dV_c, the 64
// columns of chunk c of its keys. It walks the query tiles in passes of 32
// queries; per pass it forms S^T = sum over c' of K_c' Q_c'^T, dP^T = sum
// over c' of V_c' dO_c'^T and delta = sum over c' of rowsum(dO_c' o O_c'),
// staging the four tiles of each chunk c' in turn, its own chunk last so
// that Q_c, dO_c and K_c are still staged when it adds dV_c += P^T dO_c,
// dK_c += dS^T Q_c and, after dS^T reaches shared memory, dQ_c += dS K_c
// (atomics past one key tile, as above). S, dP and delta are formed D / 64
// times over: 4 D operations a pair and 2 D a row for each further chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::frag_a;
using tf32x3::load4;
using tf32x3::mma3;
using tf32x3::stage_rows;

constexpr int kTile = 64;                 // keys a block owns; queries per pass
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kTile / kWarps; // 16: one m16 fragment of keys
constexpr int kSteps = kTile / 8;         // 8-wide fragments across a tile
constexpr int kDsStride = kTile + 8;      // dS^T row stride (floats)
// S, P and dS of a query tile are formed in two passes of 32 queries, so
// a thread holds 32 of their values, not 64: at D = 16 that keeps it near
// 100 registers, 4 blocks an SM, and the training shape's 512 blocks fit
// on the 132 SMs at once
constexpr int kParts = 2;
constexpr int kPartSteps = kSteps / kParts;

// shared memory of one block: K, V, Q, dO tiles [64][D + 4], dS^T
// [64][72], lse and delta [64], key flags [64]
template <int D>
constexpr int smem_bytes() {
  return (4 * kTile * (D + 4) + kTile * kDsStride + 2 * kTile) * 4 + kTile;
}

// kRows dO rows -> dst as `stage_rows` does, and delta[r] = rowsum(dO o O)
// of each row (0 past T), added to delta[r] when `add`. Every lane makes
// kRows D / 512 passes; the D / 4 lanes of a row are neighbours in one warp
// and sum by shuffles.
template <int D, int kRows = kTile>
__device__ __forceinline__ void stage_do_delta(float* dst, float* delta_s,
                                               const float* __restrict__ dout,
                                               const float* __restrict__ out, long long stride,
                                               int first, int T, bool vec, bool add = false) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kRows * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f), o = g;
    if (first + r < T) {
      g = load4(dout + (first + r) * stride + c, vec);
      o = load4(out + (first + r) * stride + c, vec);
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = g;
    float part = g.x * o.x + g.y * o.y + g.z * o.z + g.w * o.w;
#pragma unroll
    for (int off = kVecs / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (e % kVecs == 0) delta_s[r] = add ? delta_s[r] + part : part;
  }
}

// query fragment `first` .. first + 7 has a valid pair for the warp whose
// first key is kw: inside T and, with causal masking, not wholly before it
__device__ __forceinline__ bool query_frag_live(int first, int T, int kw, int causal) {
  return first < T && !(causal && first + 7 < kw);
}

// S^T += K Q^T and dP^T += V dO^T over the kD columns of the staged tiles
// (row stride S): a warp's 16 keys (rows kr, kr + 8) x the kJ query
// fragments from fragment j0 of the staged query rows
template <int kD, int S, int kJ>
__device__ __forceinline__ void add_s_dp(float (&s)[kJ][4], float (&dp)[kJ][4], const float* k_s,
                                         const float* v_s, const float* q_s, const float* do_s,
                                         int j0, int q0, int T, int kw, int causal, int kr, int g,
                                         int t) {
#pragma unroll
  for (int kk = 0; kk < kD; kk += 8) {
    const float* kx = k_s + kr * S + kk + t;
    const float* vx = v_s + kr * S + kk + t;
    const FragA ka = frag_a(kx[0], kx[8 * S], kx[4], kx[8 * S + 4]);
    const FragA va = frag_a(vx[0], vx[8 * S], vx[4], vx[8 * S + 4]);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (!query_frag_live(q0 + 8 * (j0 + j), T, kw, causal)) continue;
      const float* qx = q_s + (8 * (j0 + j) + g) * S + kk + t;
      const float* dx = do_s + (8 * (j0 + j) + g) * S + kk + t;
      mma3(s[j], ka, qx[0], qx[4]);
      mma3(dp[j], va, dx[0], dx[4]);
    }
  }
}

// P^T and dS^T in place from S^T and dP^T; dS^T also to ds_s (row stride
// ds_stride) for the dQ pass. Element e of fragment j: key row kr + 8
// (e >> 1), query 8 (j0 + j) + 2 t + (e & 1) of the staged rows, whose lse
// and delta are lse_s and delta_s.
template <int kJ>
__device__ __forceinline__ void probs_and_ds(float (&s)[kJ][4], float (&dp)[kJ][4], float* ds_s,
                                             int ds_stride, const float* lse_s,
                                             const float* delta_s, bool ok_lo, bool ok_hi, int j0,
                                             int q0, int T, int kw, int causal, int kr, int g,
                                             int t, float scale) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int qj = 8 * (j0 + j) + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw + g + 8 * (e >> 1);
      const int ql = qj + (e & 1);
      const bool valid = (e < 2 ? ok_lo : ok_hi) && q0 + ql < T && (!causal || key <= q0 + ql);
      const float x = valid ? s[j][e] * scale - lse_s[ql] : -__int_as_float(0x7f800000);
      const float p = expf(x);
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta_s[ql]) * scale;
    }
    *reinterpret_cast<float2*>(ds_s + kr * ds_stride + qj) = make_float2(dp[j][0], dp[j][1]);
    *reinterpret_cast<float2*>(ds_s + (kr + 8) * ds_stride + qj) = make_float2(dp[j][2], dp[j][3]);
  }
}

// dV += P^T dO and dK += dS^T Q, A from the registers with the k index
// permuted: A column t is query 2 t, column t + 4 query 2 t + 1, the
// staged dO and Q rows (stride S) loaded to match
template <int ND, int S, int kJ>
__device__ __forceinline__ void add_dv_dk(float (&dv_acc)[ND][4], float (&dk_acc)[ND][4],
                                          const float (&s)[kJ][4], const float (&dp)[kJ][4],
                                          const float* do_s, const float* q_s, int j0, int q0,
                                          int T, int kw, int causal, int g, int t) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (!query_frag_live(q0 + 8 * (j0 + j), T, kw, causal)) continue;
    const FragA pa = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
    const FragA da = frag_a(dp[j][0], dp[j][2], dp[j][1], dp[j][3]);
    const float* dx = do_s + (8 * (j0 + j) + 2 * t) * S + g;
    const float* qx = q_s + (8 * (j0 + j) + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      mma3(dv_acc[n], pa, dx[8 * n], dx[S + 8 * n]);
      mma3(dk_acc[n], da, qx[8 * n], qx[S + 8 * n]);
    }
  }
}

// dq's rows row0, row0 + 8 (those below T), 8 NQ columns from `dst`:
// added with f32 atomics when `atomic`, else stored
template <int NQ>
__device__ __forceinline__ void store_dq(const float (&acc)[NQ][4], float* dst, long long stride,
                                         int row0, int T, bool atomic) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row0 + 8 * half >= T) continue;
    float* d = dst + (row0 + 8 * half) * stride;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      if (atomic) {
        atomicAdd(d + 8 * n, acc[n][2 * half]);
        atomicAdd(d + 8 * n + 1, acc[n][2 * half + 1]);
      } else {
        *reinterpret_cast<float2*>(d + 8 * n) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }
  }
}

// dK and dV of this thread's keys (rows kw + g, + 8 below T), 8 ND columns
// from `at` (their first column in row 0)
template <int ND>
__device__ __forceinline__ void store_dk_dv(const float (&dk_acc)[ND][4], const float (&dv_acc)[ND][4],
                                            float* __restrict__ dk, float* __restrict__ dv,
                                            long long at, long long stride, int kw, int g, int T) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw + g + 8 * half;
    if (key >= T) continue;
    const long long i = at + key * stride;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dk + i + 8 * n) =
          make_float2(dk_acc[n][2 * half], dk_acc[n][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + i + 8 * n) =
          make_float2(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int T, int H, long long sb, long long st,
    float scale, int causal, int vec) {
  constexpr int S = D + 4;  // row stride of the K, V, Q and dO tiles
  constexpr int ND = D / 8; // 8-wide fragments across D
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * S;
  float* q_s = v_s + kTile * S;
  float* do_s = q_s + kTile * S;
  float* ds_s = do_s + kTile * S;  // dS^T [key][query]
  float* lse_s = ds_s + kTile * kDsStride;
  float* delta_s = lse_s + kTile;
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(delta_s + kTile);

  // tile-major order: with causal masking the first key tiles walk the most
  // query tiles, so they start first
  const int tiles = (T + kTile - 1) / kTile;
  const int slices = gridDim.x / tiles;
  const int bh = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x / slices) * kTile;
  const long long in_base = b * sb + static_cast<long long>(h) * D;
  const long long io_base = static_cast<long long>(b) * T * H * D + static_cast<long long>(h) * D;
  const long long io_stride = static_cast<long long>(H) * D;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * T;

  stage_rows<D, kTile, kThreads>(k_s, k + in_base, st, k0, T, vec);
  stage_rows<D, kTile, kThreads>(v_s, v + in_base, st, k0, T, vec);
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    ok_s[threadIdx.x] = key < T && (mask == nullptr || mask[static_cast<long long>(b) * T + key]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragment's row group and column
  const int kr = kWarpKeys * warp + g;     // tile rows of this thread's keys: kr, kr + 8
  const int kw = k0 + kWarpKeys * warp;    // the warp's first key
  const bool atomic = tiles > 1;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  for (int q0 = causal ? k0 : 0; q0 < T; q0 += kTile) {
    __syncthreads();  // the last pass's reads of q_s, do_s and ds_s are done
    stage_rows<D, kTile, kThreads>(q_s, q + in_base, st, q0, T, vec);
    stage_do_delta<D>(do_s, delta_s, dout + io_base, out + io_base, io_stride, q0, T, vec);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = q0 + threadIdx.x < T ? lse_row[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();

    const bool ok_lo = ok_s[kr], ok_hi = ok_s[kr + 8];
#pragma unroll
    for (int part = 0; part < kParts; ++part) {  // kPartSteps fragments of queries a pass
      const int j0 = part * kPartSteps;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 8 kPartSteps queries per warp
      float s[kPartSteps][4], dp[kPartSteps][4];
#pragma unroll
      for (int j = 0; j < kPartSteps; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      }
      add_s_dp<D, S>(s, dp, k_s, v_s, q_s, do_s, j0, q0, T, kw, causal, kr, g, t);
      probs_and_ds(s, dp, ds_s, kDsStride, lse_s, delta_s, ok_lo, ok_hi, j0, q0, T, kw, causal,
                   kr, g, t, scale);
      add_dv_dk<ND, S>(dv_acc, dk_acc, s, dp, do_s, q_s, j0, q0, T, kw, causal, g, t);
    }
    __syncthreads();  // dS^T complete

    // dQ = dS K for this warp's 16 query rows over the tile's keys
    const int qw = kWarpKeys * warp;  // the warp's first query row in the tile
    if (q0 + qw < T) {
      float acc[ND][4];
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      }
      for (int i = 0; i < kSteps; ++i) {
        const int key = k0 + 8 * i;
        if (key >= T || (causal && key > q0 + qw + 15)) break;
        const float* dx = ds_s + (8 * i + t) * kDsStride + qw + g;
        const FragA a = frag_a(dx[0], dx[8], dx[4 * kDsStride], dx[4 * kDsStride + 8]);
        const float* kx = k_s + (8 * i + t) * S + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) mma3(acc[n], a, kx[8 * n], kx[4 * S + 8 * n]);
      }
      store_dq<ND>(acc, dq + io_base + 2 * t, io_stride, q0 + qw + g, T, atomic);
    }
  }
  store_dk_dv<ND>(dk_acc, dv_acc, dk, dv, io_base + 2 * t, io_stride, kw, g, T);
}

// The chunked backward for head dims past 128 (D a multiple of kDC):
// block (b, h, key tile, blockIdx.y = chunk c), as the header says.
constexpr int kDC = 64;                 // head-dim chunk
constexpr int kSub = 32;                // queries a pass
constexpr int kSubSteps = kSub / 8;     // 8-query fragments of a pass
constexpr int kSubDsStride = kSub + 8;  // dS^T row stride (floats)
// K_c', V_c' [64][kDC + 4], Q_c', dO_c' [32][kDC + 4], dS^T [64][40],
// lse and delta [32], key flags [64]
constexpr int kChunkedSmem =
    (2 * kTile * (kDC + 4) + 2 * kSub * (kDC + 4) + kTile * kSubDsStride + 2 * kSub) * 4 + kTile;

// three blocks an SM, as its shared memory allows: at most 168 registers
__global__ void __launch_bounds__(kThreads, 3) flash_bwd_chunked_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, int T, int H, int D, long long sb,
    long long st, float scale, int causal, int vec) {
  constexpr int S = kDC + 4;  // row stride of the K, V, Q and dO tiles
  constexpr int ND = kDC / 8; // 8-wide fragments across a chunk
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * S;
  float* q_s = v_s + kTile * S;
  float* do_s = q_s + kSub * S;
  float* ds_s = do_s + kSub * S;  // dS^T [key][query of the pass]
  float* lse_s = ds_s + kTile * kSubDsStride;
  float* delta_s = lse_s + kSub;
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(delta_s + kSub);

  const int chunks = D / kDC;
  const int c = blockIdx.y;  // this block's columns: [kDC c, kDC c + kDC)
  const int tiles = (T + kTile - 1) / kTile;
  const int slices = gridDim.x / tiles;
  const int bh = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int k0 = (blockIdx.x / slices) * kTile;
  const long long in_base = b * sb + static_cast<long long>(h) * D;
  const long long io_base = static_cast<long long>(b) * T * H * D + static_cast<long long>(h) * D;
  const long long io_stride = static_cast<long long>(H) * D;
  const float* lse_row = lse + (static_cast<long long>(b) * H + h) * T;

  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    ok_s[threadIdx.x] = key < T && (mask == nullptr || mask[static_cast<long long>(b) * T + key]);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = kWarpKeys * warp + g;
  const int kw = k0 + kWarpKeys * warp;
  const bool atomic = tiles > 1;
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;
  }

  for (int q0 = causal ? k0 : 0; q0 < T; q0 += kSub) {
    // S^T and dP^T over every chunk: 16 keys x 32 queries per warp
    float s[kSubSteps][4], dp[kSubSteps][4];
#pragma unroll
    for (int j = 0; j < kSubSteps; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    for (int i = 0; i < chunks; ++i) {
      const long long off = static_cast<long long>((c + 1 + i) % chunks) * kDC;  // chunk c last
      __syncthreads();  // the last reads of every tile (and of ds_s) are done
      stage_rows<kDC, kTile, kThreads>(k_s, k + in_base + off, st, k0, T, vec);
      stage_rows<kDC, kTile, kThreads>(v_s, v + in_base + off, st, k0, T, vec);
      stage_rows<kDC, kSub, kThreads>(q_s, q + in_base + off, st, q0, T, vec);
      stage_do_delta<kDC, kSub>(do_s, delta_s, dout + io_base + off, out + io_base + off,
                                io_stride, q0, T, vec, i > 0);
      if (i == 0 && threadIdx.x < kSub) {
        lse_s[threadIdx.x] = q0 + threadIdx.x < T ? lse_row[q0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      add_s_dp<kDC, S>(s, dp, k_s, v_s, q_s, do_s, 0, q0, T, kw, causal, kr, g, t);
    }
    // chunk c is the one staged: dV_c += P^T dO_c and dK_c += dS^T Q_c
    probs_and_ds(s, dp, ds_s, kSubDsStride, lse_s, delta_s, ok_s[kr], ok_s[kr + 8], 0, q0, T,
                 kw, causal, kr, g, t, scale);
    add_dv_dk<ND, S>(dv_acc, dk_acc, s, dp, do_s, q_s, 0, q0, T, kw, causal, g, t);
    __syncthreads();  // dS^T complete

    // dQ_c = dS K_c: warp w takes 16 query rows (16 (w & 1) of the pass)
    // and 32 columns (32 (w >> 1) of the chunk) over the tile's keys
    const int qw = 16 * (warp & 1), cb = 32 * (warp >> 1);
    if (q0 + qw < T) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
      }
      for (int i = 0; i < kSteps; ++i) {
        const int key = k0 + 8 * i;
        if (key >= T || (causal && key > q0 + qw + 15)) break;
        const float* dx = ds_s + (8 * i + t) * kSubDsStride + qw + g;
        const FragA a = frag_a(dx[0], dx[8], dx[4 * kSubDsStride], dx[4 * kSubDsStride + 8]);
        const float* kx = k_s + (8 * i + t) * S + cb + g;
#pragma unroll
        for (int n = 0; n < 4; ++n) mma3(acc[n], a, kx[8 * n], kx[4 * S + 8 * n]);
      }
      store_dq<4>(acc, dq + io_base + c * kDC + cb + 2 * t, io_stride, q0 + qw + g, T, atomic);
    }
  }
  store_dk_dv<ND>(dk_acc, dv_acc, dk, dv, io_base + c * kDC + 2 * t, io_stride, kw, g, T);
}

int launch_chunked(dim3 grid, cudaStream_t s, const float* q, const float* k, const float* v,
                   const unsigned char* mask, const float* dout, const float* out,
                   const float* lse, float* dq, float* dk, float* dv, int T, int H, int D,
                   long long sb, long long st, float scale, int causal, int vec) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkedSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_chunked_kernel<<<grid, kThreads, kChunkedSmem, s>>>(
      q, k, v, mask, dout, out, lse, dq, dk, dv, T, H, D, sb, st, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(dim3 grid, cudaStream_t s, const float* q, const float* k, const float* v,
           const unsigned char* mask, const float* dout, const float* out, const float* lse,
           float* dq, float* dk, float* dv, int T, int H, long long sb, long long st, float scale,
           int causal, int vec) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above the static limit only after an opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_bwd_kernel<D><<<grid, kThreads, bytes, s>>>(q, k, v, mask, dout, out, lse, dq, dk, dv, T,
                                                    H, sb, st, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). sb
// and st are q/k/v's batch and time strides in floats. With T > 64 dq must
// come zeroed (the blocks add into it); with T <= 64 it is written whole.
// A head dim other than 8, 16, 32, 64, 128 or a multiple of 64 past 128
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* out, const void* lse, void* dq,
                                void* dk, void* dv, int B, int T, int H, int D, long long sb,
                                long long st, float scale, int causal, void* stream) {
  if (B < 0 || T < 0 || H < 1 || sb < 0 || st < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const long long blocks = static_cast<long long>(B) * H * ((T + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                         reinterpret_cast<uintptr_t>(out);
  const int vec = (addr & 15) == 0 && sb % 4 == 0 && st % 4 == 0;  // float4 loads allowed
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mk = static_cast<const unsigned char*>(mask);
  const auto* gf = static_cast<const float*>(dout);
  const auto* of = static_cast<const float*>(out);
  const auto* lf = static_cast<const float*>(lse);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  switch (D) {
    case 8: return launch<8>(grid, s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T, H, sb, st, scale, causal, vec);
    case 16: return launch<16>(grid, s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T, H, sb, st, scale, causal, vec);
    case 32: return launch<32>(grid, s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T, H, sb, st, scale, causal, vec);
    case 64: return launch<64>(grid, s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T, H, sb, st, scale, causal, vec);
    case 128: return launch<128>(grid, s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T, H, sb, st, scale, causal, vec);
    default:
      if (D <= 128 || D % kDC != 0 || D / kDC > 65535) return static_cast<int>(cudaErrorInvalidValue);
      return launch_chunked(dim3(grid.x, D / kDC), s, qf, kf, vf, mk, gf, of, lf, dqf, dkf, dvf, T,
                            H, D, sb, st, scale, causal, vec);
  }
}
