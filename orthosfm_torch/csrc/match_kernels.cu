// Two-way top-2 nearest-neighbour search for descriptor matching, on Hopper
// (sm_90a).
//
// Replaces the TPU kernel orthosfm_tpu/ops/matching_pallas.py::top2_similarity
// (its _kernel and oneway_top2), with a pair axis added: one launch serves a
// whole batch of view pairs of the batched matcher
// (orthosfm_torch/ops/matching.py::match_pairs_batched), in both directions.
//
// For pair p, query row r < ci[p] of view bi[p] and database row c < cj[p]
// of view bj[p] it forms
//   sim = <stack[bi[p], r], stack[bj[p], c]>,   d2 = max(2 - 2 sim, 0)
// once, and keeps from that one block
//   - per query row: the smallest and second-smallest d2 over the database
//     rows and the column of the smallest (forward), and
//   - per database row: the same over the query rows and the row of the
//     smallest (backward: what the forward pass of the swapped pair gives).
// The N x N block is never stored.
//
// Each dot product is one fmaf chain over k in order from 0, and fmaf is
// commutative in its two factors: the backward outputs are bit for bit the
// forward outputs of the swapped pair, and each direction is what a one-way
// pass gives. d2 = fmaf(-2, sim, 2) clamped at 0 is 2 - 2 sim rounded as two
// operations (2 sim is exact). Ranking is by the clamped d2, not sim, as the
// plain version and the JAX package's batched matcher rank; ties go to the
// lower index in both directions: inside a thread (indices visited in
// increasing order, only a strictly smaller d2 replaces the best) and in
// every merge (which compares (d2, index) pairs: the merge is associative
// and commutative, so the result does not depend on which CTA finishes
// first, and two runs give identical outputs). Rows past a count, an empty
// side and a d2 of 4 or more give (4, 4, 0). A pair whose views or counts lie
// out of range is not read: its rows give (NaN, NaN, -1) in both directions,
// which no valid pair gives, so that the caller can raise at its next pull
// without a host sync here.
//
// TPU layout devices that are gone: the -4 bias lane that pushed invalid
// database rows out becomes the counts ci and cj; the padding of N to
// 256/512 and of D to 128 goes (D is 64, SURF, or 128, SIFT: one
// instantiation each); the gather stack[bi] happens here through bi and bj.
//
// Bound: f32 FMAs on the CUDA cores, N_i N_j D per pair for both directions
// (2 N_i N_j D operations at 67 TFLOP/s; no TF32, no tensor cores: the
// reference asks for full f32 and the indices must agree with an f32
// product). The bytes (each descriptor read once) are ~1/64 of that time.
// What the design does about the six limits of the first, one-way kernel:
//   1. each product is computed once for both directions (it was computed
//      twice, once a direction);
//   2. the query tile (128 rows x D) stays in shared memory while the CTA
//      walks its database tiles (it was reloaded for every database tile);
//   3. every shared-memory tile is k-major with rows of 128 + 4 floats: the
//      4-byte cp.async stores of 8 dims x 4 rows a warp hit 32 banks, and the
//      16-byte reads of 8 lanes hit 8 neighbouring groups or one (broadcast)
//      (the stores were 8-way conflicted). The padding, not a swizzle, keeps
//      every read's offset an immediate: a swizzle by (k mod 8) held its
//      offsets in registers and spilled more;
//   4. the database is staged in 32-dim chunks through two shared-memory
//      stages: the cp.async of chunk c + 1 is in flight while chunk c is
//      multiplied, one __syncthreads() a chunk (it was two, and no overlap);
//   5. each of the 256 threads holds an 8 x 8 block of a 128 x 128 CTA tile:
//      64 FMAs per four 16-byte shared loads (it was 16 per two);
//   6. the wrapper checks nothing on the device (the range check was a host
//      sync a call): a bad pair poisons its outputs instead.
// Work split: a CTA takes (pair, query tile, database segment), a segment
// being `seg` database tiles that the wrapper sizes so that the grid holds
// a few thousand CTAs: at a few pairs of 8192 rows a query tile's whole
// database would be ~64 tile products in one CTA, and the last wave would
// leave most of the card idle. CTAs past a pair's counts exit at once.
// Merge: each thread keeps its 8 query rows' running top-2 over the
// segment's columns in registers; after each database tile the CTA merges
// the tile's columns over its 128 query rows (a shuffle tree over the 4
// lanes of a warp that share a column, then the 4 warps through shared
// memory) and writes them as a backward partial (best, second, index) to a
// scratch buffer the wrapper allocates; at the end the rows go the same way
// (8 lanes, 2 warps) to a forward partial. Then, once per CTA (one fence,
// two barriers), it takes a ticket on a device counter (as K2's accept
// tail) for each database tile of its segment and one for its query tile;
// the CTA that comes last of a tile's contributors merges that tile's
// partials, two lanes a row. The merge overlaps the other CTAs' products and
// needs no second launch. A second launch that merged every tile at once
// was measured against it on an H100 (PERF.md, PR 5): the same outputs in
// 2-4% less device time, since the tickets' last CTAs merge in the tail of
// the grid while a second launch spreads the merge over the whole card. The
// tickets were kept all the same: they keep a call to one launch, so that
// the launch count on the main path is the count of matcher calls; the
// merge costs 3-6% of the kernel's time there, and a merge spread over more
// of the tail is an open question in PERF.md.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 128;     // rows of a query tile and of a database tile
constexpr int LD = TILE + 4;  // floats per staged dim: the padding that spreads the stores
constexpr int DK = 32;        // descriptor dims per staged database chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 products each
constexpr int WR = 4;         // warps along the query rows (2 along the columns)
constexpr int MAX_SEG = WR * TILE - 1;  // database tiles a CTA: its tickets' flags fit in rx
constexpr float BIG = 4.0f;   // > any squared distance of unit descriptors

struct Args {
  const float* stack;
  int V, N;
  const int *bi, *bj, *ci, *cj;
  int nt, seg, nseg;          // tiles of N rows, database tiles a segment, segments
  float *fb, *fs;             // forward outputs (P, N)
  int* fx;
  float *bb, *bs;             // backward outputs (P, N)
  int* bx;
  float *pfb, *pfs;           // forward partials (P, nseg, N)
  int* pfx;
  float *pbb, *pbs;           // backward partials (P, nt, N)
  int* pbx;
  unsigned int* tickets;      // (P, 2 nt): backward per database tile, forward per query tile
};

__device__ __forceinline__ void push(float d, int c, float& best, float& second, int& idx) {
  second = fminf(second, fmaxf(best, d));
  if (d < best) idx = c;
  best = fminf(best, d);
}

// Merge another (best, second, idx) into this one, comparing (d2, index).
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

__device__ __forceinline__ void shfl_merge(float& best, float& second, int& idx, int lanes) {
  const float ob = __shfl_xor_sync(0xffffffffu, best, lanes);
  const float os = __shfl_xor_sync(0xffffffffu, second, lanes);
  const int oi = __shfl_xor_sync(0xffffffffu, idx, lanes);
  merge(best, second, idx, ob, os, oi);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [row0, row0 + TILE) x dims [k0, k0 + DK) of a view into the
// k-major tile dst[DK][LD]; rows at or past `count` are zero-filled and not
// read. A warp copies 8 dims x 4 rows an instruction: 32-byte row segments
// in, and 32 distinct banks out (bank = 4 k + r mod 32).
template <int D>
__device__ __forceinline__ void stage_chunk(float* dst, const float* view, int row0, int count,
                                            int k0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ck = (warp & 3) * 8 + (lane & 7);  // dim within the chunk
  const int cr = (warp >> 2) * 4 + (lane >> 3);  // row within each group of 8
  const float* g = view + (size_t)(row0 + cr) * D + k0 + ck;
  float* s = dst + ck * LD + cr;
  if (row0 + TILE <= count) {  // the common, full tile: no predicates
#pragma unroll
    for (int i = 0; i < TILE / 8; ++i) cp_async4(s + 8 * i, g + 8 * i * D, true);
  } else {
#pragma unroll
    for (int i = 0; i < TILE / 8; ++i) {
      const bool ok = row0 + 8 * i + cr < count;
      cp_async4(s + 8 * i, ok ? g + 8 * i * D : view, ok);
    }
  }
}

// Row (or column) l of the thread's 8: l < 4 at 4t + l, else at 64 + 4t + l - 4.
__device__ __forceinline__ int local_of(int t, int l) { return (l < 4 ? 0 : 64 - 4) + 4 * t + l; }

__device__ __forceinline__ void write3(float* b, float* s, int* x, size_t o, float vb, float vs,
                                       int vx) {
  b[o] = vb;
  s[o] = vs;
  x[o] = vx;
}

// Rows [lo, min(lo + TILE, N)) of pair p's outputs set to (v, v, iv).
__device__ void fill_tile(float* b, float* s, int* x, int p, int N, int lo, float v, int iv) {
  for (int r = lo + (int)threadIdx.x; r < min(lo + TILE, N); r += blockDim.x)
    write3(b, s, x, (size_t)p * N + r, v, v, iv);
}

// The final outputs of one tile of rows [lo, lo + TILE): rows below `count`
// merge their `n` partials (stride `stride` apart), the rest of the tile gets
// (4, 4, 0). Two neighbouring lanes a row, each merging every other partial
// (loads in flight from both), then one shuffle.
__device__ void finish_tile(const float* pb, const float* ps, const int* px, size_t base,
                            size_t stride, int n, float* b, float* s, int* x, int p, int N, int lo,
                            int count) {
  const int r = lo + (int)(threadIdx.x >> 1);
  float best = BIG, second = BIG;
  int idx = INT_MAX;
  if (r < count) {
#pragma unroll 4
    for (int i = threadIdx.x & 1; i < n; i += 2) {
      const size_t o = base + i * stride + r;
      merge(best, second, idx, __ldcg(pb + o), __ldcg(ps + o), __ldcg(px + o));
    }
  }
  shfl_merge(best, second, idx, 1);
  if (!(threadIdx.x & 1) && r < min(lo + TILE, N))
    write3(b, s, x, (size_t)p * N + r, best, second, idx == INT_MAX ? 0 : idx);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2) top2_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, NT = a.nt;
  float* qs = smem;                           // [D][LD], the query tile
  float* bst = qs + D * LD;                   // [2][DK][LD], database stages
  float* rb = bst + 2 * DK * LD;              // [WR][TILE] column partials of each warp row
  float* rs = rb + WR * TILE;
  int* rx = reinterpret_cast<int*>(rs + WR * TILE);
  float* qb = reinterpret_cast<float*>(rx + WR * TILE);  // [2][TILE] row partials of each warp column
  float* qsec = qb + 2 * TILE;
  int* qx = reinterpret_cast<int*>(qsec + 2 * TILE);

  int blk = blockIdx.x;
  const int qt = blk % NT;
  blk /= NT;
  const int s = blk % a.nseg;
  const int p = blk / a.nseg;
  const int vi = a.bi[p], vj = a.bj[p], nq = a.ci[p], nb = a.cj[p];
  const int t_lo = s * a.seg, t_hi = min(t_lo + a.seg, NT);
  const int row0 = qt * TILE;

  if (vi < 0 || vi >= a.V || vj < 0 || vj >= a.V || nq < 0 || nq > N || nb < 0 || nb > N) {
    const float nan = __int_as_float(0x7fc00000);
    if (s == 0) fill_tile(a.fb, a.fs, a.fx, p, N, row0, nan, -1);
    if (qt == 0)
      for (int t = t_lo; t < t_hi; ++t) fill_tile(a.bb, a.bs, a.bx, p, N, t * TILE, nan, -1);
    return;
  }
  const int nqa = (nq + TILE - 1) / TILE;  // query tiles with valid rows
  const int nta = (nb + TILE - 1) / TILE;  // database tiles with valid rows
  const int nsa = (nta + a.seg - 1) / a.seg;
  if (s == 0 && (qt >= nqa || nsa == 0)) fill_tile(a.fb, a.fs, a.fx, p, N, row0, BIG, 0);
  if (qt == 0)
    for (int t = nqa == 0 ? t_lo : max(t_lo, nta); t < t_hi; ++t)
      fill_tile(a.bb, a.bs, a.bx, p, N, t * TILE, BIG, 0);
  if (qt >= nqa || s >= nsa) return;

  const float* Q = a.stack + (size_t)vi * N * D;
  const float* B = a.stack + (size_t)vj * N * D;
  const int t_end = min(t_hi, nta);
  constexpr int kchunks = D / DK;
  const int nchunks = (t_end - t_lo) * kchunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp & 1) * 8 + (lane & 7);  // column group: lanes of a quarter warp differ
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group

#pragma unroll
  for (int h = 0; h < D / DK; ++h) stage_chunk<D>(qs + h * DK * LD, Q, row0, nq, h * DK);
  stage_chunk<D>(bst, B, t_lo * TILE, nb, 0);
  cp_async_commit();

  float fb[8], fs[8];  // forward: each of the thread's rows over its columns so far
  int fx[8];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    fb[i] = BIG;
    fs[i] = BIG;
    fx[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (int c = 0; c < nchunks; ++c) {
    const int kc = c % kchunks;
    const int t = t_lo + c / kchunks;
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nchunks)
      stage_chunk<D>(bst + ((c + 1) & 1) * DK * LD, B, (t_lo + (c + 1) / kchunks) * TILE, nb,
                     ((c + 1) % kchunks) * DK);
    cp_async_commit();

    const float* qk = qs + kc * DK * LD + 4 * ty;
    const float* bk = bst + (c & 1) * DK * LD + 4 * tx;
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(qk + k * LD);
      const float4 a1 = *reinterpret_cast<const float4*>(qk + k * LD + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + k * LD);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + k * LD + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kc != kchunks - 1) continue;

    // Database tile t is done: d2 of the 8 x 8 block, pushed into the rows'
    // running top-2 and into each column's top-2 over the thread's rows.
    const int col0 = t * TILE;
    const bool full = row0 + TILE <= nq && col0 + TILE <= nb;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + local_of(tx, j);
      float cb = BIG, cs = BIG;
      int cx = INT_MAX;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + local_of(ty, i);
        float d = fmaxf(fmaf(-2.0f, acc[i][j], 2.0f), 0.0f);
        if (!full && (row >= nq || col >= nb)) d = INFINITY;
        push(d, col, fb[i], fs[i], fx[i]);
        push(d, row, cb, cs, cx);
        acc[i][j] = 0.0f;
      }
      // the four lanes of a warp that share this column
      shfl_merge(cb, cs, cx, 8);
      shfl_merge(cb, cs, cx, 16);
      if (lane < 8) {
        const int o = (warp >> 1) * TILE + local_of(tx, j);
        rb[o] = cb;
        rs[o] = cs;
        rx[o] = cx;
      }
    }
    __syncthreads();
    const size_t pbase = ((size_t)p * NT + qt) * N;
    if (tid < TILE && col0 + tid < N) {
      float b = rb[tid], sc = rs[tid];
      int x = rx[tid];
#pragma unroll
      for (int w = 1; w < WR; ++w) merge(b, sc, x, rb[w * TILE + tid], rs[w * TILE + tid], rx[w * TILE + tid]);
      write3(a.pbb, a.pbs, a.pbx, pbase + col0 + tid, b, sc, x);
    }
  }

  // The query rows over this segment: the 8 lanes of a warp that share a
  // row, then the two warps.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    shfl_merge(fb[i], fs[i], fx[i], 1);
    shfl_merge(fb[i], fs[i], fx[i], 2);
    shfl_merge(fb[i], fs[i], fx[i], 4);
    if ((lane & 7) == 0) {
      const int o = (warp & 1) * TILE + local_of(ty, i);
      qb[o] = fb[i];
      qsec[o] = fs[i];
      qx[o] = fx[i];
    }
  }
  __syncthreads();
  if (tid < TILE && row0 + tid < N) {
    float b = qb[tid], sc = qsec[tid];
    int x = qx[tid];
    merge(b, sc, x, qb[TILE + tid], qsec[TILE + tid], qx[TILE + tid]);
    write3(a.pfb, a.pfs, a.pfx, ((size_t)p * a.nseg + s) * N + row0 + tid, b, sc, x);
  }

  // The tickets, once per CTA: one for each database tile of the segment
  // (the query tiles' backward partials of that tile) and one for the query
  // tile (the segments' forward partials). The CTA that comes last of a
  // ticket's contributors merges its tile. A segment may hold more tiles
  // than the CTA has threads: each thread takes every THREADS-th ticket.
  int* last = rx;  // free now: the segment's tiles, then the query tile (<= MAX_SEG + 1)
  const int ntiles = t_end - t_lo;
  __threadfence();
  __syncthreads();
  unsigned int* tk = a.tickets + (size_t)p * 2 * NT;
  for (int i = tid; i <= ntiles; i += THREADS)
    last[i] = i < ntiles ? atomicAdd(tk + t_lo + i, 1u) == (unsigned)nqa - 1u
                         : atomicAdd(tk + NT + qt, 1u) == (unsigned)nsa - 1u;
  __syncthreads();
  for (int i = 0; i <= ntiles; ++i) {
    if (!last[i]) continue;
    __threadfence();
    if (i < ntiles)
      finish_tile(a.pbb, a.pbs, a.pbx, (size_t)p * NT * N, N, nqa, a.bb, a.bs, a.bx, p, N,
                  (t_lo + i) * TILE, nb);
    else
      finish_tile(a.pfb, a.pfs, a.pfx, (size_t)p * a.nseg * N, N, nsa, a.fb, a.fs, a.fx, p, N,
                  row0, nq);
  }
}

// One instantiation for each width: the row stride D is an immediate in
// the staging loads (computed at run time, their addresses took ~18
// instructions a cp.async, ~13% of a chunk's instructions).
template <int D>
int launch(const Args& a, unsigned grid, void* stream) {
  constexpr size_t smem = sizeof(float) * (D * LD + 2 * DK * LD) + 12 * (WR + 2) * TILE;
  static bool smem_set = false;  // the attribute, once per width
  if (!smem_set) {
    const int err = (int)cudaFuncSetAttribute(
        top2_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    smem_set = true;
  }
  top2_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// stack (V, N, D) f32 contiguous, D 64 or 128; bi, bj, ci, cj (P,) int32;
// outputs fwd (best, second, idx) and bwd (best, second, idx), each (P, N);
// `seg` database tiles of 128 rows per CTA; scratch holds
// 3 P N (nseg + nt) 4-byte words (nt = ceil(N / 128), nseg = ceil(nt / seg));
// tickets (P, 2 nt) zeros. Returns the CUDA error of the launch.
int osfm_top2(const float* stack, int V, int N, int D, const int* bi, const int* bj,
              const int* ci, const int* cj, int P, int seg, float* fb, float* fs, int* fx,
              float* bb, float* bs, int* bx, void* scratch, unsigned int* tickets,
              void* stream) {
  if (P == 0 || N == 0) return 0;
  if ((D != 64 && D != 128) || seg < 1 || seg > MAX_SEG) return (int)cudaErrorInvalidValue;
  Args a;
  a.stack = stack;
  a.V = V;
  a.N = N;
  a.bi = bi;
  a.bj = bj;
  a.ci = ci;
  a.cj = cj;
  a.nt = (N + TILE - 1) / TILE;
  a.seg = seg;
  a.nseg = (a.nt + seg - 1) / seg;
  a.fb = fb;
  a.fs = fs;
  a.fx = fx;
  a.bb = bb;
  a.bs = bs;
  a.bx = bx;
  const size_t nf = (size_t)P * a.nseg * N, nbk = (size_t)P * a.nt * N;
  float* w = static_cast<float*>(scratch);
  a.pfb = w;
  a.pfs = w + nf;
  a.pfx = reinterpret_cast<int*>(w + 2 * nf);
  a.pbb = w + 3 * nf;
  a.pbs = w + 3 * nf + nbk;
  a.pbx = reinterpret_cast<int*>(w + 3 * nf + 2 * nbk);
  a.tickets = tickets;
  const long long grid = (long long)P * a.nseg * a.nt;
  if (grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  return D == 64 ? launch<64>(a, (unsigned)grid, stream) : launch<128>(a, (unsigned)grid, stream);
}

}  // extern "C"
