// Flash attention's forward (B4): the online-softmax attention of one
// (batch, head, 64-query tile) per block, its two tile products on the
// tensor cores in 3xTF32, f32 in and out.
//
// Replaces the TPU kernel predictionio_tpu/ops/flash_attention.py::
// _fwd_kernel (:58, pallas_call :253): out = softmax(s) V and lse = m +
// log l per query row, s = (q . k) * scale over the keys that are valid
// (mask) and, with `causal`, not after the query. A query row with no
// valid key comes out as exactly 0 with lse about -1e30.
//
// Layout. q, k and v are the public [B, T, H, D] tensors, read through
// their batch and time strides (sb, st; heads D apart, features
// contiguous), so the q/k/v thirds of one projection need no copy; out is
// contiguous [B, T, H, D] and lse [B, H, T]. The mask is [B, T] bytes
// (0 = invalid key) or null for all-valid. Nothing is padded in memory:
// rows past T are zero-filled in shared memory and never written, where
// the reference pads T to 128 and transposes to [B, H, T, D] for Mosaic.
//
// What bounds it on an H100. Per (b, h) it reads q, k, v once and writes
// out and lse: 16 T D + 4 T bytes; with causal masking it does 4 D
// operations for each of the T (T + 1) / 2 (query, key) pairs (S = Q K^T
// and O = P V). At the sequence template's B=256, H=2, T=64, D=16 that is
// 8.5 MB, 2.5 us at 3.35 TB/s, against 0.068 GFLOP: bytes. At B=16,
// T=1024 the same 8.5 MB meets 1.07 GFLOP, 6.5 us at 3xTF32's 165 TFLOP/s
// (a third of the tensor cores' 495 TF32 rate): operations.
//
// Design: FlashAttention-2's forward on mma.sync m16n8k8 (mma_tf32.cuh).
// One block per (b, h, 64-query tile), 4 warps; each warp owns 16 query
// rows, one m16 fragment. The Q tile is staged once; at D <= 32 its A
// fragments (hi and lo halves) are formed once and stay in registers, at
// D >= 64 they are re-read from shared memory for each key tile. K and V
// stream through shared memory in 64-key tiles with row stride D + 4 (no
// bank conflicts on fragment reads), copied with cp.async (synchronous
// loads when an input is not 16-byte aligned). Double-buffered, the next
// tile's copy flying while the warps work on this one, where that still
// leaves two blocks an SM (D <= 64); at D = 128 two buffers would take
// 169 KB and hold the SM to one block, so there one buffer serves (101 KB,
// two blocks an SM) and each tile's copy is waited for. With causal
// masking the key tiles past the block's last query are never staged. Per key tile a warp forms
// S = Q K^T, 16 x 64 (8 fragments, 32 floats a thread), then in registers:
// the scale, the key flags and the causal test (an invalid pair's score
// becomes -inf, so its P is exactly 0), the row max and sum across the
// quad of lanes that share a row (shuffles 1 and 2), and the online-
// softmax rescale of l and of the O accumulators once per 64-key tile.
// O += P V takes P straight from the S accumulators as A fragments, with
// the k index permuted (A column t <-> key 2t, column t + 4 <-> key
// 2t + 1) and V's rows loaded to match, so P never reaches shared memory.
// Fragments wholly above the diagonal are skipped warp-uniformly. The
// epilogue writes out = O / max(l, 1e-20) and lse = m + log(max(l,
// 1e-20)). Every product is 3xTF32 with f32 adds into the running sums.
//
// Left: wgmma and TMA staging.
//
// Head dims 8, 16, 32, 64 and 128 are built (the wrapper zero-pads any
// other D up to 128 to the next of them and passes the caller's scale).
//
// Head dims past 128, a multiple of 64 (the wrapper zero-pads others up
// to one), run the chunked instance: the D = 64 instance's fragments and
// staging over 64-column chunks of D, so neither registers nor shared
// memory grow with D. A grid dimension runs over the D / 64 output
// chunks. Block (b, h, query tile, chunk c) forms each key tile's
// S = sum over chunks c' of Q_c' K_c'^T, the Q_c' and K_c' tiles staged
// chunk by chunk with cp.async (V_c's copy flying meanwhile), runs the
// same online softmax and adds P V_c into its 64 columns of O. Every chunk
// block of a tile forms the same S in the same order, so the same m, l
// and lse; chunk 0 alone stores lse. S is formed D / 64 times over: 2 D
// operations a pair for each further chunk, the price of a design whose
// registers and 52,288 bytes of shared memory do not grow with D.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::frag_a;
using tf32x3::mma3;
using tf32x3::stage_rows;

constexpr int kTile = 64;                  // queries a block owns; keys staged per pass
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = kTile / kWarps;  // 16: one m16 fragment of queries
constexpr int kSteps = kTile / 8;          // 8-key fragments across a key tile
constexpr float kNeg = -1e30f;             // the reference's finite masked score

constexpr int kSmemPerSm = 233472;         // an H100 SM's shared memory
constexpr int kSmemReserved = 1024;        // what the runtime keeps per block

// shared memory of one block with `stages` K, V buffers: the Q tile and
// `stages` K, V tile pairs [64][D + 4], `stages` rows of key flags [64]
template <int D>
__host__ __device__ constexpr int smem_bytes_for(int stages) {
  return (1 + 2 * stages) * kTile * (D + 4) * 4 + stages * kTile;
}

// two K, V buffers while two blocks still fit an SM with them, else one
template <int D>
__host__ __device__ constexpr int stages() {
  return 2 * (smem_bytes_for<D>(2) + kSmemReserved) <= kSmemPerSm ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return smem_bytes_for<D>(stages<D>());
}

// 16 bytes global -> shared without passing through registers; 0 bytes
// read (zero-filled) when not `valid`
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src), "r"(bytes));
}

// rows [first, first + 64) -> dst [64][D + 4], zeros past T: cp.async
// copies when `vec` (the caller commits and waits), else `stage_rows`
template <int D>
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src,
                                            long long stride, int first, int T, bool vec) {
  if (!vec) {
    stage_rows<D, kTile, kThreads>(dst, src, stride, first, T, vec);
    return;
  }
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kThreads) {
    const int r = e / kVecs, c = (e % kVecs) * 4;
    const bool valid = first + r < T;
    cp_async16(dst + r * (D + 4) + c, valid ? src + (first + r) * stride + c : src, valid);
  }
}

// the A fragment of Q's columns [kk, kk + 8) for tile rows qr and qr + 8
template <int D>
__device__ __forceinline__ FragA q_frag(const float* q_s, int qr, int kk, int t) {
  constexpr int S = D + 4;
  const float* x = q_s + qr * S + kk + t;
  return frag_a(x[0], x[8 * S], x[4], x[8 * S + 4]);
}

// key fragment `first` .. first + 7 has a valid pair for the warp whose
// first query is qw: inside T and, with causal masking, not wholly after
// the warp's last query
__device__ __forceinline__ bool key_frag_live(int first, int T, int qw, int causal) {
  return first < T && !(causal && first > qw + kWarpRows - 1);
}

// One key tile's online-softmax step on a warp's S = Q K^T fragments: the
// scale and validity (an invalid pair's score becomes -inf), the tile's
// row max across the quad, the rescale of l and of the O accumulators,
// then P = exp(s - m) in place and its row sums into l. Element e of
// fragment j: query row_lo (e < 2) or row_hi, key k0 + 8 j + 2 t + (e & 1).
template <int ND>
__device__ __forceinline__ void softmax_step(float (&s)[kSteps][4], float (&o)[ND][4],
                                             float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                             const unsigned char* ok_s, int k0, int row_lo,
                                             int row_hi, int t, float scale, int causal) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kl = 8 * j + 2 * t + (e & 1);
      const int row = e < 2 ? row_lo : row_hi;
      const bool valid = ok_s[kl] && (!causal || k0 + kl <= row);
      s[j][e] = valid ? s[j][e] * scale : -__int_as_float(0x7f800000);
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  // the running max stays finite (kNeg), so corr is never NaN and an
  // invalid pair's exp(-inf) is exactly 0
  const float corr_lo = expf(m_lo - mx_lo), corr_hi = expf(m_hi - mx_hi);
  m_lo = mx_lo;
  m_hi = mx_hi;
  l_lo *= corr_lo;
  l_hi *= corr_hi;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    o[n][0] *= corr_lo;
    o[n][1] *= corr_lo;
    o[n][2] *= corr_hi;
    o[n][3] *= corr_hi;
  }
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    s[j][0] = expf(s[j][0] - m_lo);
    s[j][1] = expf(s[j][1] - m_lo);
    s[j][2] = expf(s[j][2] - m_hi);
    s[j][3] = expf(s[j][3] - m_hi);
    l_lo += s[j][0] + s[j][1];
    l_hi += s[j][2] + s[j][3];
  }
}

// O += P V, A from the P registers with the k index permuted: A column t
// is key 2 t, column t + 4 key 2 t + 1, V's rows (stride S) to match
template <int ND, int S>
__device__ __forceinline__ void add_pv(float (&o)[ND][4], const float (&s)[kSteps][4],
                                       const float* v_s, int k0, int T, int qw, int causal,
                                       int g, int t) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (!key_frag_live(k0 + 8 * j, T, qw, causal)) continue;
    const FragA pa = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
    const float* vx = v_s + (8 * j + 2 * t) * S + g;
#pragma unroll
    for (int n = 0; n < ND; ++n) mma3(o[n], pa, vx[8 * n], vx[S + 8 * n]);
  }
}

// The epilogue: l summed across the quad (each lane summed its own keys),
// out = O / max(l, 1e-20) into columns [col0, col0 + 8 ND) of the rows of
// a D-wide out, and lse = m + log(max(l, 1e-20)) when `store_lse`.
template <int ND>
__device__ __forceinline__ void store_out(const float (&o)[ND][4], float m_lo, float m_hi,
                                          float l_lo, float l_hi, float* __restrict__ out,
                                          float* __restrict__ lse, int b, int h, int T, int H,
                                          int D, int col0, bool store_lse, int row_lo, int t) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float lc_lo = fmaxf(l_lo, 1e-20f), lc_hi = fmaxf(l_hi, 1e-20f);
  const long long lse_base = (static_cast<long long>(b) * H + h) * T;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row >= T) continue;
    const float lc = half ? lc_hi : lc_lo;
    float* dst = out + ((static_cast<long long>(b) * T + row) * H + h) * D + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * half] / lc, o[n][2 * half + 1] / lc);
    }
    if (store_lse && t == 0) lse[lse_base + row] = (half ? m_hi : m_lo) + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
    int T, int H, long long sb, long long st, float scale, int causal, int vec) {
  constexpr int S = D + 4;      // row stride of the Q, K and V tiles
  constexpr int ND = D / 8;     // 8-wide fragments across D
  constexpr bool kQInRegs = D <= 32;
  constexpr int kStages = stages<D>();
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kTile * S;   // [kStages][K, V] tiles
  unsigned char* ok2 = reinterpret_cast<unsigned char*>(kv_s + 2 * kStages * kTile * S);

  // tile-major order, last query tiles first: with causal masking they
  // walk the most key tiles
  const int tiles = (T + kTile - 1) / kTile;
  const int slices = gridDim.x / tiles;
  const int bh = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int q0 = (tiles - 1 - blockIdx.x / slices) * kTile;
  const long long in_base = b * sb + static_cast<long long>(h) * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragment's row group and column
  const int qr = kWarpRows * warp + g;    // tile rows of this thread's queries: qr, qr + 8
  const int qw = q0 + kWarpRows * warp;   // the warp's first query
  const int row_lo = q0 + qr, row_hi = row_lo + 8;

  stage_rows<D, kTile, kThreads>(q_s, q + in_base, st, q0, T, vec);
  __syncthreads();
  FragA qa[kQInRegs ? ND : 1];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int n = 0; n < ND; ++n) qa[n] = q_frag<D>(q_s, qr, 8 * n, t);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;

  const int kend = causal ? min(T, q0 + kTile) : T;
  // start copying the K and V tiles at `k0` into buffer `buf`; store their
  // key flags
  auto fetch = [&](int k0, int buf) {
    stage_async<D>(kv_s + 2 * buf * kTile * S, k + in_base, st, k0, T, vec);
    stage_async<D>(kv_s + (2 * buf + 1) * kTile * S, v + in_base, st, k0, T, vec);
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < kTile) {
      const int key = k0 + threadIdx.x;
      ok2[buf * kTile + threadIdx.x] =
          key < T && (mask == nullptr || mask[static_cast<long long>(b) * T + key]);
    }
  };
  if constexpr (kStages == 2) fetch(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < kend; k0 += kTile, buf ^= kStages - 1) {
    __syncthreads();  // the last tile's reads of the buffer fetched next are done
    if constexpr (kStages == 2) {
      if (k0 + kTile < kend) {  // the next tile flies while this one is used
        fetch(k0 + kTile, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    } else {
      fetch(k0, 0);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* k_s = kv_s + 2 * buf * kTile * S;
    const float* v_s = k_s + kTile * S;
    const unsigned char* ok_s = ok2 + buf * kTile;
    if (qw >= T) continue;  // the whole warp lies past T (block-uniform barriers above)

    // S = Q K^T: 16 queries x 64 keys per warp
    float s[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      FragA a;
      if constexpr (kQInRegs) {
        a = qa[n];
      } else {
        a = q_frag<D>(q_s, qr, 8 * n, t);
      }
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (!key_frag_live(k0 + 8 * j, T, qw, causal)) continue;
        const float* kx = k_s + (8 * j + g) * S + 8 * n + t;
        mma3(s[j], a, kx[0], kx[4]);
      }
    }
    softmax_step<ND>(s, o, m_lo, m_hi, l_lo, l_hi, ok_s, k0, row_lo, row_hi, t, scale, causal);
    add_pv<ND, S>(o, s, v_s, k0, T, qw, causal, g, t);
  }
  store_out<ND>(o, m_lo, m_hi, l_lo, l_hi, out, lse, b, h, T, H, D, 0, true, row_lo, t);
}

// The chunked forward for head dims past 128 (D a multiple of kDC): block
// (b, h, query tile, blockIdx.y = output chunk c), as the header says.
constexpr int kDC = 64;  // head-dim chunk
constexpr int kChunkedSmem = 3 * kTile * (kDC + 4) * 4 + kTile;  // Q_c', K_c', V_c; key flags

__global__ void __launch_bounds__(kThreads) flash_fwd_chunked_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
    int T, int H, int D, long long sb, long long st, float scale, int causal, int vec) {
  constexpr int S = kDC + 4;    // row stride of the tiles
  constexpr int ND = kDC / 8;   // 8-wide fragments across a chunk
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * S;
  float* v_s = k_s + kTile * S;
  unsigned char* ok_s = reinterpret_cast<unsigned char*>(v_s + kTile * S);

  const int chunks = D / kDC;
  const int c = blockIdx.y;  // this block's output columns: [kDC c, kDC c + kDC)
  const int tiles = (T + kTile - 1) / kTile;
  const int slices = gridDim.x / tiles;
  const int bh = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int q0 = (tiles - 1 - blockIdx.x / slices) * kTile;
  const long long in_base = b * sb + static_cast<long long>(h) * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = kWarpRows * warp + g;
  const int qw = q0 + kWarpRows * warp;
  const int row_lo = q0 + qr, row_hi = row_lo + 8;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;

  const int kend = causal ? min(T, q0 + kTile) : T;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    // S = sum over chunks of Q_c' K_c'^T: 16 queries x 64 keys per warp
    float s[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    for (int cc = 0; cc < chunks; ++cc) {
      __syncthreads();  // the last reads of q_s and k_s (at cc = 0 of v_s and ok_s) are done
      stage_async<kDC>(q_s, q + in_base + cc * kDC, st, q0, T, vec);
      stage_async<kDC>(k_s, k + in_base + cc * kDC, st, k0, T, vec);
      asm volatile("cp.async.commit_group;\n" ::);
      if (cc == 0) {  // V_c flies while S is formed
        stage_async<kDC>(v_s, v + in_base + c * kDC, st, k0, T, vec);
        asm volatile("cp.async.commit_group;\n" ::);
        if (threadIdx.x < kTile) {
          const int key = k0 + threadIdx.x;
          ok_s[threadIdx.x] = key < T && (mask == nullptr || mask[static_cast<long long>(b) * T + key]);
        }
      }
      if (cc == 0 && chunks > 1) {
        asm volatile("cp.async.wait_group 1;\n" ::);  // Q_0 and K_0 are in; V_c may fly on
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      if (qw < T) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const FragA a = q_frag<kDC>(q_s, qr, 8 * n, t);
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            if (!key_frag_live(k0 + 8 * j, T, qw, causal)) continue;
            const float* kx = k_s + (8 * j + g) * S + 8 * n + t;
            mma3(s[j], a, kx[0], kx[4]);
          }
        }
      }
    }
    if (qw >= T) continue;  // the whole warp lies past T (block-uniform barriers above)
    softmax_step<ND>(s, o, m_lo, m_hi, l_lo, l_hi, ok_s, k0, row_lo, row_hi, t, scale, causal);
    add_pv<ND, S>(o, s, v_s, k0, T, qw, causal, g, t);
  }
  store_out<ND>(o, m_lo, m_hi, l_lo, l_hi, out, lse, b, h, T, H, D, c * kDC, c == 0, row_lo, t);
}

int launch_chunked(dim3 grid, cudaStream_t s, const float* q, const float* k, const float* v,
                   const unsigned char* mask, float* out, float* lse, int T, int H, int D,
                   long long sb, long long st, float scale, int causal, int vec) {
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkedSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_chunked_kernel<<<grid, kThreads, kChunkedSmem, s>>>(q, k, v, mask, out, lse, T, H, D,
                                                                 sb, st, scale, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(dim3 grid, cudaStream_t s, const float* q, const float* k, const float* v,
           const unsigned char* mask, float* out, float* lse, int T, int H, long long sb,
           long long st, float scale, int causal, int vec) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {  // above the static limit only after an opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_fwd_kernel<D><<<grid, kThreads, bytes, s>>>(q, k, v, mask, out, lse, T, H, sb, st, scale,
                                                    causal, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. sb and st are q/k/v's batch and time
// strides in floats. A head dim other than 8, 16, 32, 64, 128 or a
// multiple of 64 past 128 returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, const void* mask,
                                void* out, void* lse, int B, int T, int H, int D, long long sb,
                                long long st, float scale, int causal, void* stream) {
  if (B < 0 || T < 0 || H < 1 || sb < 0 || st < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const long long blocks = static_cast<long long>(B) * H * ((T + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = (addr & 15) == 0 && sb % 4 == 0 && st % 4 == 0;  // float4 loads allowed
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  switch (D) {
    case 8: return launch<8>(grid, s, qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal, vec);
    case 16: return launch<16>(grid, s, qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal, vec);
    case 32: return launch<32>(grid, s, qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal, vec);
    case 64: return launch<64>(grid, s, qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal, vec);
    case 128: return launch<128>(grid, s, qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal, vec);
    default:
      if (D <= 128 || D % kDC != 0 || D / kDC > 65535) return static_cast<int>(cudaErrorInvalidValue);
      return launch_chunked(dim3(grid.x, D / kDC), s, qf, kf, vf, mk, of, lf, T, H, D, sb, st,
                            scale, causal, vec);
  }
}
