// Flash attention: the online-softmax forward (B4) and its two backward
// kernels (B5: dQ, B6: dK and dV), f32 in and out, f32 accumulation.
//
// Replaces the TPU kernels of predictionio_tpu/ops/flash_attention.py:
//   B4 _fwd_kernel (:58, pallas_call :253): out = softmax(s) V and
//      lse = m + log l per query row, s = (q . k) * scale over the keys
//      that are valid (mask) and, with `causal`, not after the query;
//   B5 _dq_kernel (:106, :313): dq = sum_k P (dP - delta) * scale * k,
//      P = exp(s - lse) rebuilt from the saved lse, dP = dO . v;
//   B6 _dkv_kernel (:148, :326): dv = sum_q P dO, dk = sum_q P (dP - delta)
//      * scale * q.
// delta = rowsum(dO o O) is computed outside, as the reference does.
// A query row with no valid key comes out as exactly 0 with lse about
// -1e30, and gets no gradient (P is 0 wherever a key is invalid).
//
// Layout. q, k and v are the public [B, T, H, D] tensors, read through
// their batch and time strides (sb, st; heads D apart, features
// contiguous), so the q/k/v thirds of one projection need no copy; dO and
// every output are contiguous [B, T, H, D], lse and delta [B, H, T]. The
// mask is [B, T] bytes (0 = invalid key) or null for all-valid. Nothing is
// padded: rows past T are bounds-checked, where the reference pads T to
// 128 and transposes to [B, H, T, D] for Mosaic.
//
// What bounds them on an H100. Per (b, h) the forward reads q, k, v once
// and writes out and lse: 16 T D + 4 T bytes; with causal masking it
// does 4 D operations for each of the T (T + 1) / 2 (query, key) pairs
// (q . k and the P V product). At the sequence template's B=256, H=2,
// T=64, D=16 that is 8.5 MB (2.5 us at 3.35 TB/s) against 0.068 GFLOP
// (1.0 us at 67 TFLOP/s): bytes. At B=16, T=1024 the same 8.5 MB meets
// 1.07 GFLOP (16 us): operations, a roof tensor cores would lift 15x.
// B5 and B6 read dO, lse and delta too and do 6 D and 8 D operations a
// pair.
//
// Design: the simple kernel. One thread owns one query row (B4, B5) or
// one key row (B6) of a 64-row block: its q (or k and v) row, its running
// max and sum and its D accumulators live in registers (D is a template
// parameter: 8, 16, 32 or 64). The other side streams through shared
// memory in 64-row tiles, staged with coalesced loads and zero-filled past
// T; every thread reads the same staged row at the same time (a broadcast,
// no bank conflicts), four floats per load. B4 folds keys into the online
// softmax 8 at a time (one rescale of the accumulators per 8 keys). With
// causal masking B4 and B5 stop at the block's last query row and B6
// starts at the block's first key row, so the tiles above the diagonal
// are never staged. Tensor cores (wgmma), several rows per thread and
// TMA staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;    // rows a block owns, one per thread
constexpr int kTile = 64;    // rows of the other side staged per pass
constexpr int kChunk = 8;    // keys per online-softmax update (B4)
constexpr float kNeg = -1e30f;  // the reference's finite masked score

struct Coords {
  int b, h, first;  // batch, head, first row of the block
};

__device__ __forceinline__ Coords block_coords(int T, int H) {
  const int tiles = (T + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  return {bh / H, bh % H, tile * kRows};
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* s) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + d);
    acc = fmaf(a[d], x.x, acc);
    acc = fmaf(a[d + 1], x.y, acc);
    acc = fmaf(a[d + 2], x.z, acc);
    acc = fmaf(a[d + 3], x.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D], float w, const float* s) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(s + d);
    acc[d] = fmaf(w, x.x, acc[d]);
    acc[d + 1] = fmaf(w, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(w, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(w, x.w, acc[d + 3]);
  }
}

// rows [first, first + n) of one (b, h) slice -> dst [kTile][D], zeros past n
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long row_stride, int first, int n) {
  for (int e = threadIdx.x; e < kTile * D; e += kRows) {
    const int r = e / D, c = e % D;
    dst[e] = r < n ? src[static_cast<long long>(first + r) * row_stride + c] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ void load_row(float (&dst)[D], const float* __restrict__ src, bool live) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = live ? src[d] : 0.0f;
}

// keys [k0, k0 + n) of batch row b that are valid, zero past n
__device__ __forceinline__ void stage_mask(unsigned char* dst, const unsigned char* __restrict__ mask,
                                           int b, int T, int k0, int n) {
  for (int j = threadIdx.x; j < kTile; j += kRows) {
    dst[j] = j < n && (mask == nullptr || mask[static_cast<long long>(b) * T + k0 + j]) ? 1 : 0;
  }
}

template <int D>
__global__ void __launch_bounds__(kRows) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
    int T, int H, long long sb, long long st, float scale, int causal) {
  __shared__ __align__(16) float k_s[kTile * D];
  __shared__ __align__(16) float v_s[kTile * D];
  __shared__ unsigned char ok_s[kTile];
  const Coords at = block_coords(T, H);
  const int row = at.first + threadIdx.x;
  const bool live = row < T;
  const long long base = at.b * sb + static_cast<long long>(at.h) * D;
  float qr[D], acc[D];
  load_row<D>(qr, q + base + row * st, live);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  float m = kNeg, l = 0.0f;

  const int kend = causal ? min(T, at.first + kRows) : T;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int n = min(kTile, kend - k0);
    __syncthreads();  // the last tile's reads are done
    stage<D>(k_s, k + base, st, k0, n);
    stage<D>(v_s, v + base, st, k0, n);
    stage_mask(ok_s, mask, at.b, T, k0, n);
    __syncthreads();
    for (int c = 0; c < n; c += kChunk) {
      float s[kChunk];
      bool ok[kChunk];
      float cmax = kNeg;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kj = c + j;  // < kTile: zero-filled and invalid past n
        ok[j] = ok_s[kj] && (!causal || k0 + kj <= row);
        const float score = dot<D>(qr, k_s + kj * D) * scale;
        s[j] = ok[j] ? score : kNeg;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.0f;
        l += p;
        axpy<D>(acc, p, v_s + (c + j) * D);
      }
      m = m_new;
    }
  }
  if (live) {
    const float lc = fmaxf(l, 1e-20f);
    float* o = out + ((static_cast<long long>(at.b) * T + row) * H + at.h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = acc[d] / lc;
    lse[(static_cast<long long>(at.b) * H + at.h) * T + row] = m + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kRows) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int T, int H, long long sb, long long st, float scale, int causal) {
  __shared__ __align__(16) float k_s[kTile * D];
  __shared__ __align__(16) float v_s[kTile * D];
  __shared__ unsigned char ok_s[kTile];
  const Coords at = block_coords(T, H);
  const int row = at.first + threadIdx.x;
  const bool live = row < T;
  const long long base = at.b * sb + static_cast<long long>(at.h) * D;
  const long long out_at = ((static_cast<long long>(at.b) * T + row) * H + at.h) * D;
  const long long row_at = (static_cast<long long>(at.b) * H + at.h) * T + row;
  float qr[D], dor[D], acc[D];
  load_row<D>(qr, q + base + row * st, live);
  load_row<D>(dor, dout + out_at, live);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  const float lse_r = live ? lse[row_at] : 0.0f;
  const float delta_r = live ? delta[row_at] : 0.0f;

  const int kend = causal ? min(T, at.first + kRows) : T;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    const int n = min(kTile, kend - k0);
    __syncthreads();
    stage<D>(k_s, k + base, st, k0, n);
    stage<D>(v_s, v + base, st, k0, n);
    stage_mask(ok_s, mask, at.b, T, k0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!ok_s[j] || (causal && k0 + j > row)) continue;
      const float p = expf(dot<D>(qr, k_s + j * D) * scale - lse_r);
      const float dp = dot<D>(dor, v_s + j * D);
      axpy<D>(acc, p * (dp - delta_r) * scale, k_s + j * D);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[out_at + d] = acc[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRows) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv,
    int T, int H, long long sb, long long st, float scale, int causal) {
  __shared__ __align__(16) float q_s[kTile * D];
  __shared__ __align__(16) float do_s[kTile * D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  const Coords at = block_coords(T, H);
  const int col = at.first + threadIdx.x;  // this thread's key row
  const bool live = col < T;
  const bool key_ok = live && (mask == nullptr || mask[static_cast<long long>(at.b) * T + col]);
  const long long base = at.b * sb + static_cast<long long>(at.h) * D;
  const long long do_base = static_cast<long long>(at.b) * T * H * D + static_cast<long long>(at.h) * D;
  const long long row_base = (static_cast<long long>(at.b) * H + at.h) * T;
  float kr[D], vr[D], dk_acc[D], dv_acc[D];
  load_row<D>(kr, k + base + col * st, live);
  load_row<D>(vr, v + base + col * st, live);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk_acc[d] = 0.0f;
    dv_acc[d] = 0.0f;
  }

  for (int q0 = causal ? at.first : 0; q0 < T; q0 += kTile) {
    const int n = min(kTile, T - q0);
    __syncthreads();
    stage<D>(q_s, q + base, st, q0, n);
    stage<D>(do_s, dout + do_base, static_cast<long long>(H) * D, q0, n);
    for (int i = threadIdx.x; i < kTile; i += kRows) {
      lse_s[i] = i < n ? lse[row_base + q0 + i] : 0.0f;
      delta_s[i] = i < n ? delta[row_base + q0 + i] : 0.0f;
    }
    __syncthreads();
    if (!key_ok) continue;
    // with causal masking only queries at or after this key see it; a
    // query row that sees a valid key has a finite lse, so P <= 1
    for (int i = causal ? max(col - q0, 0) : 0; i < n; ++i) {
      const float p = expf(dot<D>(kr, q_s + i * D) * scale - lse_s[i]);
      axpy<D>(dv_acc, p, do_s + i * D);
      const float dp = dot<D>(vr, do_s + i * D);
      axpy<D>(dk_acc, p * (dp - delta_s[i]) * scale, q_s + i * D);
    }
  }
  if (live) {
    const long long at_out = ((static_cast<long long>(at.b) * T + col) * H + at.h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[at_out + d] = dk_acc[d];
      dv[at_out + d] = dv_acc[d];
    }
  }
}

// grid: one block per (b, h, 64-row tile); 0 when there is nothing to do
bool grid_for(int B, int T, int H, dim3* grid) {
  const long long blocks = static_cast<long long>(B) * H * ((T + kRows - 1) / kRows);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned>(blocks));
  return true;
}

bool bad_args(int B, int T, int H, long long sb, long long st) {
  return B < 0 || T < 0 || H < 1 || sb < 0 || st < 0;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success), so a refused launch reaches the caller; a head dim other than
// 8, 16, 32 or 64 returns cudaErrorInvalidValue and launches nothing.
// sb and st are q/k/v's batch and time strides in floats.

extern "C" int flash_fwd_launch(
    const void* q, const void* k, const void* v, const void* mask, void* out, void* lse,
    int B, int T, int H, int D, long long sb, long long st, float scale, int causal,
    void* stream) {
  if (bad_args(B, T, H, sb, st)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!grid_for(B, T, H, &grid)) return B == 0 || T == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  switch (D) {
    case 8: flash_fwd_kernel<8><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal); break;
    case 16: flash_fwd_kernel<16><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal); break;
    case 32: flash_fwd_kernel<32><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal); break;
    case 64: flash_fwd_kernel<64><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, of, lf, T, H, sb, st, scale, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dq_launch(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int T, int H, int D, long long sb, long long st, float scale, int causal,
    void* stream) {
  if (bad_args(B, T, H, sb, st)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!grid_for(B, T, H, &grid)) return B == 0 || T == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mk = static_cast<const unsigned char*>(mask);
  const auto* gf = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* of = static_cast<float*>(dq);
  switch (D) {
    case 8: flash_dq_kernel<8><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, of, T, H, sb, st, scale, causal); break;
    case 16: flash_dq_kernel<16><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, of, T, H, sb, st, scale, causal); break;
    case 32: flash_dq_kernel<32><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, of, T, H, sb, st, scale, causal); break;
    case 64: flash_dq_kernel<64><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, of, T, H, sb, st, scale, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_dkv_launch(
    const void* q, const void* k, const void* v, const void* mask, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int T, int H, int D, long long sb, long long st, float scale, int causal,
    void* stream) {
  if (bad_args(B, T, H, sb, st)) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!grid_for(B, T, H, &grid)) return B == 0 || T == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mk = static_cast<const unsigned char*>(mask);
  const auto* gf = static_cast<const float*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  const auto* df = static_cast<const float*>(delta);
  auto* kk = static_cast<float*>(dk);
  auto* vv = static_cast<float*>(dv);
  switch (D) {
    case 8: flash_dkv_kernel<8><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, kk, vv, T, H, sb, st, scale, causal); break;
    case 16: flash_dkv_kernel<16><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, kk, vv, T, H, sb, st, scale, causal); break;
    case 32: flash_dkv_kernel<32><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, kk, vv, T, H, sb, st, scale, causal); break;
    case 64: flash_dkv_kernel<64><<<grid, kRows, 0, s>>>(qf, kf, vf, mk, gf, lf, df, kk, vv, T, H, sb, st, scale, causal); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
