// Top-2 nearest-neighbour search for descriptor matching, on Hopper (sm_90a).
//
// Replaces the TPU kernel orthosfm_tpu/ops/matching_pallas.py::top2_similarity
// (its _kernel and oneway_top2), with a pair axis added: one launch serves a
// whole batch of view pairs of the batched matcher
// (orthosfm_torch/ops/matching.py::match_pairs_batched).
//
// For pair p, query row r < N and database row c < cj[p] it forms
//   sim = <stack[bi[p], r], stack[bj[p], c]>,   d2 = max(2 - 2 sim, 0)
// and keeps, per query row, the smallest and second-smallest d2 and the
// column of the smallest. The N x N similarity block is never stored.
//
// The ranking key is d2, not sim, on purpose: the matcher's plain version
// (and the JAX package's batched matcher it is held against) ranks the clamped
// d2 with top_k, and two different sims can give the same d2 (every sim above
// 1 clamps to 0; near sim = 0 the ulp of 2 - 2 sim is four times that of sim).
// Ties go to the lower column index: inside a thread (columns are visited in
// increasing order and only a strictly smaller d2 replaces the best), across
// database tiles (visited in increasing order) and across the 16 threads that
// merge a row (the merge compares (d2, column) pairs).
//
// TPU layout devices that are gone: the -4 bias lane that pushed invalid
// database rows out becomes the count cj; the padding of N to 256/512 and of
// D to 128 goes (D = 64 and D = 128 are both taken); the gather stack[bi]
// happens here through bi and bj, so no (P, N, D) copy is made.
// Query rows r >= ci[p] are not searched: their outputs are (4, 4, 0), the
// values of an empty database.
//
// Bound: f32 FMAs on the CUDA cores, 2 N^2 D per pair and direction (no TF32,
// no tensor cores: the reference asks for full f32 and the indices must agree
// with an f32 matmul). Design, simple first: a block takes a 64-row query tile
// of one pair and walks the database in 64-row tiles; both tiles pass through
// shared memory in 32-dim chunks; each of the 256 threads holds a 4 x 4 block
// of dot products and a running (best, second, index) for its 4 rows; at the
// end the 16 threads of a row merge with warp shuffles.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TILE = 64;      // query rows and database rows per tile
constexpr int DK = 32;        // descriptor dims per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 products each
constexpr float BIG = 4.0f;   // > any squared distance of unit descriptors

__device__ __forceinline__ void push(float d, int c, float& best, float& second, int& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = c;
  } else if (d < second) {
    second = d;
  }
}

// Merge another thread's (best, second, idx) into this one's.
__device__ __forceinline__ void merge(float& best, float& second, int& idx, float ob, float os,
                                      int oi) {
  const bool other = (ob < best) || (ob == best && oi < idx);
  const float loser = other ? best : ob;
  const float win_second = other ? os : second;
  if (other) {
    best = ob;
    idx = oi;
  }
  second = fminf(loser, win_second);
}

__global__ void __launch_bounds__(THREADS)
top2_kernel(const float* __restrict__ stack, int N, int D, const int* __restrict__ bi,
            const int* __restrict__ bj, const int* __restrict__ ci, const int* __restrict__ cj,
            float* __restrict__ best_out, float* __restrict__ second_out,
            int* __restrict__ idx_out) {
  __shared__ __align__(16) float qs[DK][TILE];  // query chunk, transposed
  __shared__ __align__(16) float bs[DK][TILE];  // database chunk, transposed

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TILE;
  const int tx = threadIdx.x & 15;  // column group: columns tx*4 .. tx*4+3 of a tile
  const int ty = threadIdx.x >> 4;  // row group: rows ty*4 .. ty*4+3 of the tile
  const int nq = ci[p];
  const int nb = cj[p];
  const float* q = stack + (size_t)bi[p] * N * D;
  const float* b = stack + (size_t)bj[p] * N * D;

  float best[4], second[4];
  int idx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = BIG;
    second[i] = BIG;
    idx[i] = INT_MAX;
  }

  if (row0 < nq) {
    for (int c0 = 0; c0 < nb; c0 += TILE) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

      for (int k0 = 0; k0 < D; k0 += DK) {
        // 64 rows x 32 dims of each operand: 512 float4 loads, 2 per thread,
        // neighbouring threads on neighbouring addresses of a row
        for (int l = threadIdx.x; l < TILE * DK / 4; l += THREADS) {
          const int r = l / (DK / 4);
          const int k4 = (l % (DK / 4)) * 4;
          float4 vq = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row0 + r < N) vq = *reinterpret_cast<const float4*>(q + (size_t)(row0 + r) * D + k0 + k4);
          if (c0 + r < nb) vb = *reinterpret_cast<const float4*>(b + (size_t)(c0 + r) * D + k0 + k4);
          qs[k4 + 0][r] = vq.x;
          qs[k4 + 1][r] = vq.y;
          qs[k4 + 2][r] = vq.z;
          qs[k4 + 3][r] = vq.w;
          bs[k4 + 0][r] = vb.x;
          bs[k4 + 1][r] = vb.y;
          bs[k4 + 2][r] = vb.z;
          bs[k4 + 3][r] = vb.w;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < DK; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col < nb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // 2 - 2 sim rounded as two operations, like the plain version
            const float d2 = fmaxf(__fsub_rn(2.0f, __fmul_rn(2.0f, acc[i][j])), 0.0f);
            push(d2, col, best[i], second[i], idx[i]);
          }
        }
      }
    }
  }

  // The 16 threads of a row group are 16 neighbouring lanes of one warp
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[i], off);
      merge(best[i], second[i], idx[i], ob, os, oi);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r >= N) continue;
      const size_t o = (size_t)p * N + r;
      const bool searched = r < nq;
      best_out[o] = searched ? best[i] : BIG;
      second_out[o] = searched ? second[i] : BIG;
      idx_out[o] = (searched && idx[i] != INT_MAX) ? idx[i] : 0;
    }
  }
}

}  // namespace

extern "C" {

// stack (V, N, D) f32 contiguous; bi, bj, ci, cj (P,) int32; outputs (P, N).
// D must be a multiple of 32. Returns the CUDA error of the launch.
int osfm_top2(const float* stack, int N, int D, const int* bi, const int* bj, const int* ci,
              const int* cj, int P, float* best, float* second, int* idx, void* stream) {
  if (P == 0 || N == 0) return 0;
  const dim3 grid((N + TILE - 1) / TILE, P);
  top2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, N, D, bi, bj, ci, cj, best, second, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
