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
// wog [E], woh [H1], bo [1]; the output is exactly [I] f32, at any E, H0,
// H1 >= 1 and I >= 0.
//
// What bounds it on an H100. Each item costs 2 E H0 + 2 H0 H1 operations
// in the two dense layers, which run on the tensor cores in 3xTF32 (165
// TFLOP/s at best), and 3E + 2 H1 + H0 + H1 in f32 outside them; it reads
// two table rows of E f32 once. At the template's widths (E=32, hidden
// 64, 32) the bytes bound it: 256 MB for 1,000,000 items, 0.077 ms at
// 3.35 TB/s, against 0.050 ms of dense products. Wide towers are bound by
// the products.
//
// Design. Items are the M dimension of both products. A warp owns 32 rows
// of a tile (two m16n8k8 m-tiles, so each B fragment it loads serves
// two products); a block walks tiles grid-stride over at most as many
// blocks as stay resident. Per tile and warp:
//   - Layer 1, acc1[32 x 64] = x[32 x E] @ W0i[E x 64 columns of H0] + c0,
//     on `mma.sync` in 3xTF32, accumulated in the tensor core
//     (tf32x3::mma3_acc). c0 = mlp_u @ W0u + b0 is computed by the block in
//     f32 and added after the products.
//   - Layer 2 takes relu(acc1) straight from registers as its A fragments
//     (the accumulator's C layout read as an A layout with the k index
//     permuted, W1's rows staged to match): acc2 += relu(acc1) @ W1[64
//     rows x 32 or 64 columns of H1]. The first hidden layer never touches
//     shared or global memory.
//   - relu(acc2 + b1) . woh and the gmf dot are f32 FMAs; a quad of lanes
//     shares two rows of each m-tile and adds its four parts with two
//     shuffles.
// Any width runs through the same loops: for each chunk of H1, for each
// 64-column chunk of H0, layer 1's slice folded straight into acc2; layer 1
// is computed once per H1 chunk (once at the template's widths, 32 times at
// H1 = 2048). Every count inside a chunk is a compile-time
// constant, so the products unroll without guards; columns past H0 and H1
// are zero weights.
//
// Precision. A operands split into hi and lo words cheaply
// (tf32x3::split_fast), B operands once at staging (tf32x3::frag_b); each
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi. Accumulating in the tensor
// core truncates each step's sum, at most about 3/8 ulp of the running
// sum per term; chip_smoke.py's b3_tolerance allows an ulp per term of
// each sum, so B3 skips the f32 adds the attention kernels need.
//
// Staging. W0i and W1 are split once into TF32 hi/lo pairs and stored in
// fragment order, so a lane reads its B fragment with one 16-byte shared
// load. Where a matrix fits shared memory beside the ring it is staged once
// a block and held ("resident": both at the template's widths, 32 KB);
// else one chunk (32 rows x 64 columns of W0i, 64 rows x 32 or 64 columns
// of W1) is staged per use, so each weight byte read from L2 serves a
// tile. The tables' rows of the next tile are in flight while the current
// one computes: 16-byte `cp.async` copies (4-byte where E is not a
// multiple of 4) into a two-stage ring, rows E + 4 floats apart (fragment
// reads free of bank conflicts), zero-filled past I and E. Where two
// stages of whole rows do not fit, one stage holds the gmf rows and then
// the mlp rows of a tile; where one does not, the ring holds 32-column E
// chunks.
//
// Layout: two instances by H1. Up to 32 (the template's 32 included): 4
// warps, 128-item tiles, H1 in 32-column chunks (the template's layer 2
// computes no padding), two blocks an SM, 106,752 bytes of shared memory
// at the template's widths; on an H100 that ran faster than one block of 8
// warps at 1,000,000 items and at E = 1536. Past 32: 8 warps, 256-item
// tiles, 64-column chunks, one block an SM (a wide tower's weight chunks
// need the shared memory of one). The launch configuration (the
// shared-memory opt-in and the occupancy query) is computed once per
// device, instance and size and cached.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "mma_tf32.cuh"

namespace {

using tf32x3::FragA;
using tf32x3::frag_a_fast;
using tf32x3::mma3_acc;

constexpr int kM = 2;                      // m-tiles (16 rows) a warp
constexpr int kN1 = 64;                    // columns of an H0 chunk
constexpr int kNT1 = kN1 / 8;              // its n-tiles
constexpr int kChunkE = 32;                // E rows of a W0i chunk; E chunk of a ring stage
constexpr int kFrag = 32 * 4;              // floats of one fragment-order B tile
constexpr size_t kMaxSmemBytes = 232448;   // what one block may use on Hopper

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// A block's warps for an instance (kNT2, the n-tiles of an H1 chunk): 4
// where H1 <= 32, else 8 (see Layout above).
__host__ __device__ constexpr int warps_for(int nt2c) { return nt2c == 4 ? 4 : 8; }

// Where everything lives for one set of widths; offsets in floats of the
// dynamic shared memory.
struct Plan {
  int E, H0, H1;
  int ep;              // E rounded up to 8
  int nt2c;            // n-tiles of an H1 chunk: 4 (H1 <= 32) or 8
  int threads, items;  // a block's threads; a tile's items (16 kM a warp)
  int ke, nec;         // E columns a ring stage holds (all of E or 32); ring chunks
  int stages;          // ring stages: 2 (the next rows in flight, both tables
                       // a stage) or 1 (one table at a time, gmf then mlp)
  int kc, nkc;         // E columns a layer-1 step takes (all of E where W0i is
                       // resident and the ring whole, else 32); steps
  int nt1, nt2;        // n-tiles of H0 and H1, rounded up to whole chunks
  int nh0c, nh1c;      // chunks of H0 and H1
  int w0_res, w1_res;  // the weight held whole a block (else a chunk per use)
  int c0_res;          // c0 held whole (else one chunk, recomputed per use)
  int vec;             // the tables copy in 16-byte pieces
  int ring, w0, w1, c0, floats;
};

Plan plan_for(int E, int H0, int H1) {
  Plan p{};
  p.E = E;
  p.H0 = H0;
  p.H1 = H1;
  p.ep = round_up(E, 8);
  p.nt2c = H1 <= 32 ? 4 : 8;
  p.threads = 32 * warps_for(p.nt2c);
  p.items = 16 * kM * warps_for(p.nt2c);
  p.nh0c = (H0 + kN1 - 1) / kN1;
  p.nh1c = (H1 + 8 * p.nt2c - 1) / (8 * p.nt2c);
  p.nt1 = p.nh0c * kNT1;
  p.nt2 = p.nh1c * p.nt2c;
  const int chunk = p.ep < kChunkE ? p.ep : kChunkE;
  const long long max_floats = kMaxSmemBytes / sizeof(float);
  const long long w0_all = static_cast<long long>(p.ep / 8) * p.nt1 * kFrag;
  const long long w1_all = static_cast<long long>(p.nt1) * p.nt2 * kFrag;
  const long long c0_all = static_cast<long long>(p.nh0c) * kN1;
  // Both weights resident first, then W1 (the larger product) alone, then
  // W0i alone, then neither; for each, the tile's whole rows in two ring
  // stages, then in one, then 32-column E chunks in two. The last choice
  // (neither resident, chunks) always fits.
  const int res[4][2] = {{1, 1}, {0, 1}, {1, 0}, {0, 0}};
  const int rings[3][2] = {{p.ep, 2}, {p.ep, 1}, {chunk, 2}};
  for (const auto& r : res) {
    for (const auto& rg : rings) {
      const int ke = rg[0], stages = rg[1];
      const long long ring = (stages == 2 ? 4LL : 1LL) * p.items * (ke + 4);
      const long long w0 = r[0] ? w0_all : static_cast<long long>(chunk / 8) * kNT1 * kFrag;
      const long long w1 = r[1] ? w1_all : static_cast<long long>(kNT1) * p.nt2c * kFrag;
      if (ring + w0 + w1 + kN1 > max_floats) continue;
      p.ke = ke;
      p.nec = (p.ep + ke - 1) / ke;
      p.stages = stages;
      p.kc = r[0] && ke == p.ep ? p.ep : chunk;
      p.nkc = (p.ep + p.kc - 1) / p.kc;
      p.w0_res = r[0];
      p.w1_res = r[1];
      p.c0_res = ring + w0 + w1 + c0_all <= max_floats;
      p.ring = 0;
      p.w0 = static_cast<int>(ring);
      p.w1 = static_cast<int>(ring + w0);
      p.c0 = static_cast<int>(ring + w0 + w1);
      p.floats = static_cast<int>(ring + w0 + w1 + (p.c0_res ? c0_all : kN1));
      return p;
    }
  }
  return p;  // not reached
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, bool vec) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
                 "r"(valid ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One table's rows of tile `tile` at E columns [e0, e0 + kw) into dst
// (rows ke + 4 floats apart), zeros past I and E; the caller commits.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src,
                                           long long tile, int e0, int kw, int I,
                                           const Plan& p) {
  const int S = p.ke + 4;
  const int unit = p.vec ? 4 : 1;
  const int per_row = kw / unit;
  const int rows_step = p.threads / per_row, cols_step = p.threads % per_row;
  const long long base = tile * p.items;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  for (; r < p.items; r += rows_step) {
    const int col = c * unit;
    const bool valid = base + r < I && e0 + col < p.E;
    cp_async(dst + r * S + col, valid ? src + (base + r) * p.E + e0 + col : src, valid, p.vec);
    c += cols_step;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// Step `step` of a block's walk over its tiles in a two-stage ring (per
// tile one step, or with ring chunks one per chunk, H0 chunk and H1
// chunk): the tile's mlp rows, and on its first pass over E its gmf rows,
// at the step's E chunk, into stage `step & 1` (mlp, then gmf). A step
// past the block's last tile copies nothing.
__device__ __forceinline__ void stage_step(float* ring, const float* __restrict__ gmf_item,
                                           const float* __restrict__ mlp_item, long long step,
                                           long long tiles, int I, const Plan& p) {
  long long tile = step;
  int within = 0;
  if (p.nec > 1) {
    const int spt = p.nh1c * p.nh0c * p.nec;  // steps a tile
    tile = step / spt;
    within = static_cast<int>(step - tile * spt);
  }
  tile = blockIdx.x + tile * gridDim.x;
  if (tile >= tiles) return;
  const int e0 = (within % p.nec) * p.ke;
  const int kw = min(p.ke, p.ep - e0);
  float* stage = ring + (step & 1) * 2 * p.items * (p.ke + 4);
  stage_rows(stage, mlp_item, tile, e0, kw, I, p);
  if (within < p.nec) stage_rows(stage + p.items * (p.ke + 4), gmf_item, tile, e0, kw, I, p);
}

// B fragments of rows [r0, r0 + 8 ks_n) x columns [c0, c0 + 8 nt_n) of a
// row-major [R, C] matrix, split, fragment (ks, nt) at (ks * stride + nt)
// * 32 + lane; zeros past R and C. `perm`: the k index of the C -> A reuse
// (k = t is row 2t, k = t + 4 is row 2t + 1), else k = t and t + 4. Each
// thread loads eight fragments' elements before it stores any, so their
// loads are in flight together.
template <int kThreads>
__device__ __forceinline__ void stage_frags(uint4* dst, int stride, const float* __restrict__ src,
                                            int R, int C, int r0, int c0, int ks_n, int nt_n,
                                            bool perm) {
  constexpr int kBatch = 8;
  const int total = ks_n * nt_n * 32;
  for (int f0 = threadIdx.x; f0 < total; f0 += kBatch * kThreads) {
    float va[kBatch], vb[kBatch];
    int at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int f = f0 + u * kThreads;
      const int lane = f & 31, rest = f >> 5;
      const int ks = rest / nt_n, nt = rest - ks * nt_n;
      const int g = lane >> 2, t = lane & 3;
      const int ra = r0 + 8 * ks + (perm ? 2 * t : t), rb = ra + (perm ? 1 : 4);
      const int c = c0 + 8 * nt + g;
      const bool live = f < total && c < C;
      va[u] = live && ra < R ? src[static_cast<long long>(ra) * C + c] : 0.0f;
      vb[u] = live && rb < R ? src[static_cast<long long>(rb) * C + c] : 0.0f;
      at[u] = f < total ? (ks * stride + nt) * 32 + lane : -1;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) dst[at[u]] = tf32x3::frag_b(va[u], vb[u]);
    }
  }
}

// c0[j] = mlp_u . W0u[:, j0 + j] + b0[j0 + j] for j < count, in f32; zeros
// past H0 (relu(0) adds nothing below)
__device__ __forceinline__ void stage_c0(float* c0_s, const float* __restrict__ mlp_u,
                                         const float* __restrict__ w0u,
                                         const float* __restrict__ b0, int j0, int count,
                                         const Plan& p) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const int col = j0 + j;
    float acc = 0.0f;
    if (col < p.H0) {
#pragma unroll 8
      for (int e = 0; e < p.E; ++e) {
        acc = fmaf(mlp_u[e], w0u[static_cast<long long>(e) * p.H0 + col], acc);
      }
      acc += b0[col];
    }
    c0_s[j] = acc;
  }
}

// the gmf dot of a warp's staged rows (E columns [e0, e0 + live), rows S
// floats apart): gp[m][h] for rows 16 m + g + 8 h
__device__ __forceinline__ void gmf_dot(float (&gp)[kM][2], const float* rows, int S, int e0,
                                        int live, const float* __restrict__ gmf_u,
                                        const float* __restrict__ wog, int t) {
#pragma unroll 4
  for (int c = t; c < live; c += 4) {
    const float u = __ldg(gmf_u + e0 + c), w = __ldg(wog + e0 + c);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      gp[m][0] = fmaf(rows[16 * m * S + c] * u, w, gp[m][0]);
      gp[m][1] = fmaf(rows[(16 * m + 8) * S + c] * u, w, gp[m][1]);
    }
  }
}

// kNT2: n-tiles of an H1 chunk (Plan::nt2c), which sets the block's warps
// (warps_for). Every count of the inner products is a compile-time
// constant, so they unroll without guards: columns past H0 or H1 are zero
// weights, computed and never used.
template <int kNT2, int kThreads = 32 * warps_for(kNT2), int kItems = 16 * kM * warps_for(kNT2)>
__global__ void __launch_bounds__(kThreads, kNT2 == 4 ? 2 : 1) ncf_score_mma_kernel(
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
    int I, const Plan p) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem + p.ring;
  uint4* w0_s = reinterpret_cast<uint4*>(smem + p.w0);
  uint4* w1_s = reinterpret_cast<uint4*>(smem + p.w1);
  float* c0_s = smem + p.c0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = p.ke + 4;
  const int row0 = 16 * kM * warp + g;  // the warp's first row (m-tile 0, row g)

  const long long tiles = (static_cast<long long>(I) + kItems - 1) / kItems;
  long long step = 0;  // the ring step to consume next
  if (p.stages == 2) {
    stage_step(ring, gmf_item, mlp_item, step, tiles, I, p);
    cp_async_commit();
  }
  if (p.w0_res) stage_frags<kThreads>(w0_s, p.nt1, w0i, p.E, p.H0, 0, 0, p.ep / 8, p.nt1, false);
  if (p.w1_res) stage_frags<kThreads>(w1_s, p.nt2, w1, p.H0, p.H1, 0, 0, p.nt1, p.nt2, true);
  if (p.c0_res) stage_c0(c0_s, mlp_u, w0u, b0, 0, p.nh0c * kN1, p);
  __syncthreads();  // the resident weights and c0 are staged
  const float bias_out = bo[0];
  const float* stage = ring;  // the mlp rows the layers read

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float gp[kM][2] = {}, sp[kM][2] = {};  // per m-tile, rows g and g + 8
    for (int h1c = 0; h1c < p.nh1c; ++h1c) {
      float acc2[kM][kNT2][4] = {};
      for (int h0c = 0; h0c < p.nh0c; ++h0c) {
        const bool first = h1c == 0 && h0c == 0;  // the tile's first pass over E
        if (!p.c0_res) {
          __syncthreads();  // the last chunk's c0 reads are done
          stage_c0(c0_s, mlp_u, w0u, b0, kN1 * h0c, kN1, p);
          __syncthreads();
        }
        float acc1[kM][kNT1][4] = {};
        for (int kk = 0; kk < p.nkc; ++kk) {
          const int e0 = kk * p.kc, kw = min(p.kc, p.ep - e0);
          if (p.nec > 1 || (first && kk == 0)) {  // the ring's next step
            const float* gmf_rows;
            if (p.stages == 2) {
              cp_async_wait_all();  // this step's rows have landed
              __syncthreads();      // for every thread; the other stage's reads are done
              stage = ring + (step & 1) * 2 * kItems * S;
              gmf_rows = stage + kItems * S;
              ++step;
              stage_step(ring, gmf_item, mlp_item, step, tiles, I, p);
              cp_async_commit();
            } else {  // one buffer: the gmf rows (first pass), then the mlp rows
              if (first) {
                __syncthreads();  // the last tile's reads are done
                stage_rows(ring, gmf_item, tile, e0, min(p.ke, p.ep - e0), I, p);
                cp_async_commit();
                cp_async_wait_all();
                __syncthreads();
              }
              gmf_rows = ring;
            }
            if (first) gmf_dot(gp, gmf_rows + row0 * S, S, e0, min(p.ke, p.E - e0), gmf_u, wog, t);
            if (p.stages == 1) {
              __syncthreads();  // the gmf reads (or the last chunk's) are done
              stage_rows(ring, mlp_item, tile, e0, min(p.ke, p.ep - e0), I, p);
              cp_async_commit();
              cp_async_wait_all();
              __syncthreads();
            }
          }
          if (!p.w0_res) {
            __syncthreads();  // the last chunk's reads are done
            stage_frags<kThreads>(w0_s, kNT1, w0i, p.E, p.H0, e0, kN1 * h0c, kw / 8, kNT1, false);
            __syncthreads();
          }
          const uint4* w0v = p.w0_res ? w0_s + ((e0 / 8) * p.nt1 + kNT1 * h0c) * 32 : w0_s;
          const int w0_stride = (p.w0_res ? p.nt1 : kNT1) * 32;
          // layer 1: acc1 += x[rows, E step] @ W0i chunk, each B fragment
          // serving both m-tiles
          const float* xr = stage + row0 * S + (p.nec > 1 ? 0 : e0) + t;
#pragma unroll 2
          for (int ks = 0; ks < kw / 8; ++ks) {
            FragA a[kM];
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              const float* x = xr + 16 * m * S + 8 * ks;
              a[m] = frag_a_fast(x[0], x[8 * S], x[4], x[8 * S + 4]);
            }
            const uint4* b = w0v + ks * w0_stride + lane;
#pragma unroll
            for (int j = 0; j < kNT1; ++j) {
              const uint4 bj = b[32 * j];
#pragma unroll
              for (int m = 0; m < kM; ++m) mma3_acc(acc1[m][j], a[m], bj);
            }
          }
        }
        const float* c0 = c0_s + (p.c0_res ? kN1 * h0c : 0);
#pragma unroll
        for (int j = 0; j < kNT1; ++j) {  // acc1 = mlp_item @ W0i + c0
          const float2 c = *reinterpret_cast<const float2*>(c0 + 8 * j + 2 * t);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            acc1[m][j][0] += c.x;
            acc1[m][j][1] += c.y;
            acc1[m][j][2] += c.x;
            acc1[m][j][3] += c.y;
          }
        }
        if (!p.w1_res) {
          __syncthreads();
          stage_frags<kThreads>(w1_s, kNT2, w1, p.H0, p.H1, kN1 * h0c, 8 * kNT2 * h1c, kNT1, kNT2,
                                true);
          __syncthreads();
        }
        const uint4* w1v = p.w1_res ? w1_s + (kNT1 * h0c * p.nt2 + kNT2 * h1c) * 32 : w1_s;
        const int w1_stride = (p.w1_res ? p.nt2 : kNT2) * 32;
        // layer 2: acc2 += relu(acc1) @ W1 chunk, relu(acc1) read as A
        // fragments in place: A = (c0, c2, c1, c3), W1's rows permuted
#pragma unroll
        for (int j = 0; j < kNT1; ++j) {
          FragA a[kM];
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            a[m] = frag_a_fast(fmaxf(acc1[m][j][0], 0.0f), fmaxf(acc1[m][j][2], 0.0f),
                               fmaxf(acc1[m][j][1], 0.0f), fmaxf(acc1[m][j][3], 0.0f));
          }
          const uint4* b = w1v + j * w1_stride + lane;
#pragma unroll
          for (int n = 0; n < kNT2; ++n) {
            const uint4 bn = b[32 * n];
#pragma unroll
            for (int m = 0; m < kM; ++m) mma3_acc(acc2[m][n], a[m], bn);
          }
        }
      }
      // this H1 chunk's outputs folded into the score: relu(acc2 + b1) . woh
#pragma unroll
      for (int n = 0; n < kNT2; ++n) {
        const int col = 8 * kNT2 * h1c + 8 * n + 2 * t;
        const float ba = col < p.H1 ? __ldg(b1 + col) : 0.0f;
        const float wa = col < p.H1 ? __ldg(woh + col) : 0.0f;
        const float bb = col + 1 < p.H1 ? __ldg(b1 + col + 1) : 0.0f;
        const float wb = col + 1 < p.H1 ? __ldg(woh + col + 1) : 0.0f;
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          sp[m][0] = fmaf(fmaxf(acc2[m][n][0] + ba, 0.0f), wa, sp[m][0]);
          sp[m][0] = fmaf(fmaxf(acc2[m][n][1] + bb, 0.0f), wb, sp[m][0]);
          sp[m][1] = fmaf(fmaxf(acc2[m][n][2] + ba, 0.0f), wa, sp[m][1]);
          sp[m][1] = fmaf(fmaxf(acc2[m][n][3] + bb, 0.0f), wb, sp[m][1]);
        }
      }
    }
    // a quad's four parts of rows g and g + 8 of each m-tile
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float lo = gp[m][0] + sp[m][0], hi = gp[m][1] + sp[m][1];
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      const long long row = tile * kItems + row0 + 16 * m;
      if (t == 0) {
        if (row < I) out[row] = lo + bias_out;
        if (row + 8 < I) out[row + 8] = hi + bias_out;
      }
    }
  }
  cp_async_wait_all();  // the last step copied nothing, but leave no group open
}

// Blocks of `smem` bytes that stay resident on the current device, and the
// device's shared-memory opt-in: both once per device, instance and size,
// cached.
template <int kNT2>
int resident_blocks(size_t smem, cudaError_t* err) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> cache;
  static std::map<int, bool> opted_in;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(device, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  if (!opted_in[device]) {
    *err = cudaFuncSetAttribute(ncf_score_mma_kernel<kNT2>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kMaxSmemBytes));
    if (*err != cudaSuccess) return 0;
    opted_in[device] = true;
  }
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ncf_score_mma_kernel<kNT2>,
                                                         32 * warps_for(kNT2), smem);
  }
  if (*err != cudaSuccess) return 0;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  cache.emplace(key, blocks);
  return blocks;
}

int grid_for(const Plan& p, int I, cudaError_t* err) {
  const size_t smem = static_cast<size_t>(p.floats) * sizeof(float);
  const int resident = p.nt2c == 4 ? resident_blocks<4>(smem, err) : resident_blocks<8>(smem, err);
  if (*err != cudaSuccess) return 0;
  const long long tiles = (static_cast<long long>(I) + p.items - 1) / p.items;
  return static_cast<int>(tiles < resident ? tiles : resident);
}

template <int kNT2>
void launch(const Plan& p, int grid, cudaStream_t stream, const void* gmf_item,
            const void* mlp_item, const void* gmf_u, const void* mlp_u, const void* w0u,
            const void* w0i, const void* b0, const void* w1, const void* b1, const void* wog,
            const void* woh, const void* bo, void* out, int I) {
  ncf_score_mma_kernel<kNT2><<<grid, p.threads, static_cast<size_t>(p.floats) * sizeof(float),
                               stream>>>(
      static_cast<const float*>(gmf_item), static_cast<const float*>(mlp_item),
      static_cast<const float*>(gmf_u), static_cast<const float*>(mlp_u),
      static_cast<const float*>(w0u), static_cast<const float*>(w0i),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(wog),
      static_cast<const float*>(woh), static_cast<const float*>(bo),
      static_cast<float*>(out), I, p);
}

}  // namespace

// Bytes of dynamic shared memory a launch at these widths uses; -1 for
// widths below 1.
extern "C" int ncf_score_smem_bytes(int E, int H0, int H1) {
  if (E < 1 || H0 < 1 || H1 < 1) return -1;
  return static_cast<int>(plan_for(E, H0, H1).floats * sizeof(float));
}

// How these widths are staged: bit 0 W0i resident, bit 1 W1 resident,
// bit 2 c0 resident (else a chunk of each per use), bit 3 a two-stage
// ring, bit 4 H1 in 32-column chunks (else 64), bits 5 and up the number
// of E chunks of the ring; -1 for widths below 1.
extern "C" int ncf_score_layout(int E, int H0, int H1) {
  if (E < 1 || H0 < 1 || H1 < 1) return -1;
  const Plan p = plan_for(E, H0, H1);
  return p.w0_res | p.w1_res << 1 | p.c0_res << 2 | (p.stages == 2) << 3 | (p.nt2c == 4) << 4 |
         p.nec << 5;
}

// Blocks a launch over I items runs (at most as many as stay resident);
// 0 for I = 0, -1 on a CUDA error or widths below 1.
extern "C" int ncf_score_grid(int I, int E, int H0, int H1) {
  if (I < 0 || E < 1 || H0 < 1 || H1 < 1) return -1;
  if (I == 0) return 0;
  cudaError_t err;
  const int grid = grid_for(plan_for(E, H0, H1), I, &err);
  return err == cudaSuccess ? grid : -1;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), so a
// refused launch reaches the caller. I = 0 launches nothing.
extern "C" int ncf_score_launch(
    const void* gmf_item, const void* mlp_item, const void* gmf_u, const void* mlp_u,
    const void* w0u, const void* w0i, const void* b0, const void* w1, const void* b1,
    const void* wog, const void* woh, const void* bo, void* out, int I, int E, int H0, int H1,
    void* stream) {
  if (I < 0 || E < 1 || H0 < 1 || H1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (I == 0) return 0;
  Plan p = plan_for(E, H0, H1);
  p.vec = E % 4 == 0 && reinterpret_cast<uintptr_t>(gmf_item) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(mlp_item) % 16 == 0;
  cudaError_t err;
  const int grid = grid_for(p, I, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.nt2c == 4) {
    launch<4>(p, grid, s, gmf_item, mlp_item, gmf_u, mlp_u, w0u, w0i, b0, w1, b1, wog, woh, bo,
              out, I);
  } else {
    launch<8>(p, grid, s, gmf_item, mlp_item, gmf_u, mlp_u, w0u, w0i, b0, w1, b1, wog, woh, bo,
              out, I);
  }
  return static_cast<int>(cudaGetLastError());
}
