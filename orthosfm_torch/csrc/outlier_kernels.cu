// The outlier filter's nearest-neighbour search on Hopper (sm_90a): one
// kernel, outlier_nn_kernel, that gives every track the distance to its
// nearest other track with a point, as the plain version
// (ops/outliers.py:nearest_neighbor_distances with impl="torch") does.
//
// It replaces no Pallas kernel: the JAX package's nearest_neighbor_distances
// (orthosfm_tpu/ops/outliers.py:24) is an XLA program, a row-chunked sweep
// that writes a (chunk x T) distance tile and reduces it, which the plain
// version repeats in PyTorch (a (2048 x T) f32 tile and about ten
// elementwise passes over it a chunk: ~138 GB moved at T = 50 000).
//
// What it computes, pair by pair, as the plain version's expansion does
// over the 4-D homogeneous points p = (x, y, z, w), rounding where it
// rounds:
//   sq_i  the plain version's own squared norms, torch.sum(p * p, -1), which
//         the wrapper computes beside the launch (O(T)): torch sums a row of
//         4 in an order that depends on the points' layout (on the card
//         (x*x + z*z) + (y*y + w*w) for rows in contiguous memory, another
//         order for the column-major points the BA hands back), so the
//         kernel takes them rather than redoing them
//   dot   = fmaf(w_i, w_j, fmaf(z_i, z_j, fmaf(y_i, y_j, x_i * x_j))) (as the
//           f32 GEMM's FFMA chain over its depth of 4, from 0)
//   d2    = max((sq_i + sq_j) - 2 dot, 0)   [fmaf(-2, dot, sq_i + sq_j):
//                                            2 dot is exact, so one rounding
//                                            as the plain subtraction]
//   a pair with i == j, or whose either track has no point, reads BIG (the
//   plain version's 1e12, a kernel argument);
//   nn_i  = sqrt(min_j d2), and 0 for a track without a point.
// The expansion cancels: near neighbours' d2 carries an error of a few ulp
// of sq_i + sq_j, which decides which tracks the filter keeps near its
// threshold. So the kernel rounds as the plain version does on the card
// (the tests hold the two bit for bit there, in both layouts); on the CPU,
// whose GEMM rounds otherwise, they agree to that error. A NaN distance
// propagates into the minimum as torch.amin's does.
// One case parts from the plain version: a track whose own point is not
// finite reads NaN here wherever a track without a point lies in its
// candidates (such a candidate is an infinite-norm origin, below); the
// plain version reads 1e6 for it if it has no pointed neighbour. The main
// path's points are finite.
//
// What bounds it on this card: T^2 pairs x 12 f32 operations as the plain
// version counts them (FMA as 2; the clamp once a pair), 3.0e10 at
// T = 50 000, 0.45 ms at the f32 peak of 67 TFLOP/s; this design issues 7
// instructions a pair (one multiply, four FMAs, one add, one min: 11
// operations, the clamp taken once a track), 0.52 ms at 128 f32 lanes an SM
// of 132 at 1.98 GHz. Its bytes are O(T) (~1.2 MB read, 0.2 MB written), so
// nothing is written per pair: an all-pairs min-reduction bound by the f32
// pipes.
//
// The design:
// - A CTA of THREADS threads owns a block of QUERIES tracks (ROWS a thread,
//   strided by THREADS so the loads coalesce), held in registers: the
//   point, its sq and the running minimum.
// - It streams its share of the candidates through shared memory in stages
//   of TILE tracks, double-buffered: the next stage's loads are issued into
//   registers before the current stage is consumed and stored after, one
//   barrier a stage. A candidate without a point (or past the share's end)
//   is staged as the origin with an infinite sq, whose d2 to any finite
//   query is +inf, so the pair loop carries no mask; the self pair is
//   tested only in the stages that overlap the CTA's own query block.
// - Every thread reads the same candidate (a shared-memory broadcast) and
//   updates ROWS independent minima: 7 f32 instructions a pair, ROWS chains
//   deep.
// - The clamp at 0 commutes with the minimum (max(., 0) is monotone), so it
//   is taken once a track, with -0 made +0.
// - The candidate axis is split over S CTAs (gridDim.x) so that S x query
//   blocks fills the card's resident CTAs once (the wrapper's launch_plan,
//   from T alone). Their partial minima meet in one word a track by
//   atomicMax on an inverted key of the f32 bits (non-negative floats order
//   as unsigned ints; NaN keyed highest), so the result does not depend on
//   the order the CTAs finish in. The last CTA of a query block to finish
//   (a ticket a block) takes the square roots and zeroes the tracks without
//   a point. The scratch (a key a track and a ticket a block) comes zeroed
//   from the wrapper.
//
// The arithmetic lives in functions compiled for the host too: the same
// file built by the host C++ compiler (no __CUDACC__) exports
// osfm_outlier_nn_host, which runs the same CTAs one after another (every
// split and the min-combine included), for the CPU tests.

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define NN_HD __host__ __device__ __forceinline__
#else
#define NN_HD inline
#endif

namespace {

constexpr int THREADS = 128;             // threads of a CTA
constexpr int ROWS = 8;                  // query tracks a thread holds
constexpr int QUERIES = THREADS * ROWS;  // a CTA's query block
constexpr int TILE = 64;                 // candidates of a shared-memory stage
constexpr int MIN_BLOCKS = 6;            // CTAs resident on an SM (85 registers a thread)
constexpr uint32_t NAN_KEY = 0xFFFFFFFFu;

struct alignas(16) Point {
  float x, y, z, w;
};

NN_HD float dot4(const Point& a, const Point& b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

NN_HD Point load_point(const float* pts, int i) {
  return Point{pts[4 * (size_t)i], pts[4 * (size_t)i + 1], pts[4 * (size_t)i + 2],
               pts[4 * (size_t)i + 3]};
}

// min that returns NaN where either side is NaN (torch.amin's rule)
NN_HD float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? NAN : fminf(a, b);
#endif
}

NN_HD uint32_t bits_of(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return u;
#endif
}

NN_HD float float_of(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

// A track's partial minimum, clamped at 0 (-0 made +0, NaN kept), as the
// key that atomicMax combines: smaller distances give larger keys, NaN the
// largest. A zeroed word is below every key.
NN_HD uint32_t min_key(float m) {
  if (m != m) return NAN_KEY;
  return NAN_KEY - 1u - bits_of(m > 0.0f ? m : 0.0f);
}

NN_HD float key_d2(uint32_t key) { return key == NAN_KEY ? NAN : float_of(NAN_KEY - 1u - key); }

NN_HD float track_nn(uint32_t key, bool pointed) { return pointed ? sqrtf(key_d2(key)) : 0.0f; }

// A thread's ROWS queries (tracks first, first + THREADS, ...): the points,
// their squared norms and the running minima at BIG.
NN_HD void load_queries(int first, int T, const float* pts, const float* sq, float big,
                        Point (&q)[ROWS], float (&qs)[ROWS], float (&m)[ROWS]) {
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = first + k * THREADS;
    q[k] = i < T ? load_point(pts, i) : Point{0.0f, 0.0f, 0.0f, 0.0f};
    qs[k] = i < T ? sq[i] : 0.0f;
    m[k] = big;
  }
}

// A candidate as a stage holds it: a track without a point, or at or past
// `end`, is the origin with an infinite squared norm.
struct Candidate {
  Point p;
  float sq;
};

NN_HD Candidate load_candidate(int j, int end, const float* pts, const float* sq,
                               const uint8_t* has) {
  if (j < end && has[j]) return Candidate{load_point(pts, j), sq[j]};
  return Candidate{Point{0.0f, 0.0f, 0.0f, 0.0f}, INFINITY};
}

// The running minima of a thread's queries over one stage of TILE
// candidates (tracks t0, t0 + 1, ...); SELF: the stage overlaps the CTA's
// query block, so the pair of a track with itself reads BIG.
template <bool SELF>
NN_HD void stage_min(const Point* cp, const float* cs, int t0, int first, float big,
                     const Point (&q)[ROWS], const float (&qs)[ROWS], float (&m)[ROWS]) {
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    const Point p = cp[c];
    const float s = cs[c];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      float d2 = fmaf(-2.0f, dot4(q[k], p), qs[k] + s);
      if (SELF && t0 + c - first == k * THREADS) d2 = big;
      m[k] = min_nan(m[k], d2);
    }
  }
}

NN_HD bool overlaps_block(int t0, int qlo) { return t0 < qlo + QUERIES && qlo < t0 + TILE; }

#ifdef __CUDACC__

// grid (S, query blocks): CTA (s, b) takes the queries of block b against
// the candidates [s * chunk, (s + 1) * chunk); keys: T combine words, then
// a ticket a query block, zeroed.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    outlier_nn_kernel(int T, int chunk, const float* __restrict__ pts,
                      const float* __restrict__ sq, const uint8_t* __restrict__ has, float big,
                      uint32_t* __restrict__ keys, float* __restrict__ nn) {
  __shared__ Point cp[2][TILE];
  __shared__ float cs[2][TILE];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int qlo = blockIdx.y * QUERIES, first = qlo + tid;
  const int c0 = blockIdx.x * chunk, c1 = min(T, c0 + chunk);
  Point q[ROWS];
  float qs[ROWS], m[ROWS];
  load_queries(first, T, pts, sq, big, q, qs, m);

  Candidate next{};
  if (tid < TILE) {
    next = load_candidate(c0 + tid, c1, pts, sq, has);
    cp[0][tid] = next.p;
    cs[0][tid] = next.sq;
  }
  __syncthreads();
  int buf = 0;
  for (int t0 = c0; t0 < c1; t0 += TILE, buf ^= 1) {
    const bool more = t0 + TILE < c1;
    if (more && tid < TILE) next = load_candidate(t0 + TILE + tid, c1, pts, sq, has);
    if (overlaps_block(t0, qlo))
      stage_min<true>(cp[buf], cs[buf], t0, first, big, q, qs, m);
    else
      stage_min<false>(cp[buf], cs[buf], t0, first, big, q, qs, m);
    if (more && tid < TILE) {
      cp[buf ^ 1][tid] = next.p;
      cs[buf ^ 1][tid] = next.sq;
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = first + k * THREADS;
    if (i < T) atomicMax(keys + i, min_key(m[k]));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(keys + T + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int i = first + k * THREADS;
    if (i < T) nn[i] = track_nn(__ldcg(keys + i), has[i] != 0);
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// nn (T,) of the points pts (T, 4), their squared norms sq (T,) and has
// (T,) on the card, the candidate axis cut in shares of `chunk` tracks (the
// last stage of each padded); keys holds T + ceil(T / QUERIES) zeroed words.
// Returns the launch's CUDA error (0: none).
extern "C" int osfm_outlier_nn(int T, int chunk, const float* pts, const float* sq,
                               const uint8_t* has, float big, uint32_t* keys, float* nn,
                               void* stream) {
  if (T <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  const dim3 grid((T + chunk - 1) / chunk, (T + QUERIES - 1) / QUERIES);
  outlier_nn_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      T, chunk, pts, sq, has, big, keys, nn);
  return cudaGetLastError();
}

#else  // the host build: the kernel's CTAs one after another

extern "C" int osfm_outlier_nn_host(int T, int chunk, const float* pts, const float* sq,
                                    const uint8_t* has, float big, uint32_t* keys, float* nn) {
  if (T <= 0 || chunk <= 0) return 1;
  const int splits = (T + chunk - 1) / chunk;
  Point cp[TILE];
  float cs[TILE];
  for (int qlo = 0; qlo < T; qlo += QUERIES) {
    for (int s = 0; s < splits; ++s) {
      const int c0 = s * chunk, c1 = T < c0 + chunk ? T : c0 + chunk;
      for (int tid = 0; tid < THREADS; ++tid) {
        const int first = qlo + tid;
        Point q[ROWS];
        float qs[ROWS], m[ROWS];
        load_queries(first, T, pts, sq, big, q, qs, m);
        for (int t0 = c0; t0 < c1; t0 += TILE) {
          for (int c = 0; c < TILE; ++c) {
            const Candidate next = load_candidate(t0 + c, c1, pts, sq, has);
            cp[c] = next.p;
            cs[c] = next.sq;
          }
          if (overlaps_block(t0, qlo))
            stage_min<true>(cp, cs, t0, first, big, q, qs, m);
          else
            stage_min<false>(cp, cs, t0, first, big, q, qs, m);
        }
        for (int k = 0; k < ROWS; ++k) {
          const int i = first + k * THREADS;
          if (i < T && min_key(m[k]) > keys[i]) keys[i] = min_key(m[k]);
        }
      }
    }
    for (int i = qlo; i < T && i < qlo + QUERIES; ++i) nn[i] = track_nn(keys[i], has[i] != 0);
  }
  return 0;
}

#endif  // __CUDACC__
