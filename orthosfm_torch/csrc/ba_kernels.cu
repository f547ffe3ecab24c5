// Hand-written Hopper (sm_90a) kernels for the robust Levenberg-Marquardt
// bundle adjustment of orthosfm_torch/solvers/ba.py. Plain C interface,
// loaded with ctypes by orthosfm_torch/solvers/ba_kernels.py, which also
// holds the plain PyTorch version of every kernel.
//
// One LM iteration is three stages, five launches back to back on one stream
// with no host sync; a device `done` flag (state[DONE]) makes the iterations
// after convergence return at once (the analog of the cond-guarded body of
// the JAX package's fused kernel, orthosfm_tpu/solvers/ba_fused.py:476-477):
//
//   K1 schur_assemble     <- ba_pallas.py normal_eq_schur (+ ba_fused.py pass 1);
//                            three launches: blocks, product, reduce
//   K3 camera_solve       <- ba_fused.py _gauss_jordan + the in-kernel reduced
//                            system and camera retraction (:369-407); a
//                            Cholesky here: one warp up to 5 views, a
//                            blocked one-CTA factorization up to 37, the
//                            same panels on a cluster of 8 CTAs above, and
//                            from GRID_MIN_V views a blocked factorization
//                            over the whole card in one cooperative launch
//                            (the grid route, any n)
//   K2 point_update_cost  <- ba_pallas.py point_update_cost (+ ba_fused.py pass 2)
//                            and, in its last CTA, ba_fused.py accept /
//                            lambda / done (:457-474), the rule of K4
//                            lm_accept; in split mode the last CTA only
//                            sums the cost, and K4 runs as a launch of its
//                            own on the cost summed over the shards
//                            (parallel/ba_sharded.py)
//
// The arithmetic is f32 SIMT FMA throughout, but for K3's grid route, whose
// products run on the tensor cores in 3xTF32 (f32 accuracy; one TF32 pass
// would keep three decimal digits).
// The per-observation math (ba_pallas.py _tile_blocks, _point_block_inv,
// _couplings, _inv3x3_rows) is written once, as the __device__ functions
// below, and shared by K1 and K2.
//
// lm_fused (below K4) runs the whole solve in one cooperative launch: the
// initial cost and every iteration of the three stages, by the same device
// functions on the same work items, with grid-wide barriers between the
// stages and the loop's stop on the device (the counterpart of ba_fused.py
// run_lm); from 38 views the launch is made in clusters of 8 CTAs and its
// camera solve is K3's cluster route on the first, and from GRID_MIN_V its
// camera solve is K3's grid route on every CTA, up to the views where its
// per-view tables leave shared memory (~375, fused_plan). ba.run takes it
// where it serves and the per-iteration launches past that.
//
// Scalar LM state: float[STATE_SIZE] = [lambda, cost, iterations, done,
// initial cost, current half, 0, 0]. Iteration i reads slot i%2 and K2's
// last CTA writes slot (i+1)%2, so no CTA ever reads a scalar that another
// CTA is overwriting. The points and cameras (rot, camp) live in two halves
// each (a, b); state[CUR] names the current one: K1 reads it, K3 writes the
// candidate cameras and K2 the candidate points into the other, and an
// accepted step flips state[CUR] (nothing is copied).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LAM = 0, COST = 1, ITERS = 2, DONE = 3, INIT_COST = 4, CUR = 5, STATE_SIZE = 8;

constexpr int NT = 256;                 // threads per CTA of schur_reduce
constexpr size_t SMEM_MAX = 227 * 1024;  // shared bytes per CTA, sm_90

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// A barrier over the threads that run one work item: the whole CTA (id 0,
// __syncthreads: the per-iteration kernels), one warp, or the `nthreads`
// threads of consecutive warps by named barrier `id` (a thread group of
// lm_fused, which runs several work items side by side in one CTA).
struct GroupSync {
  int id, nthreads;
  __device__ __forceinline__ void operator()() const {
    if (id == 0)
      __syncthreads();
    else if (nthreads == 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
  }
};

// K1's per-camera tables, built in shared memory by each of its CTAs.
struct Cam {
  float R9[9];   // R9[b*3+a] = R[b][a], local->world rotation
  float dS[27];  // dS[a*9+k*3+b] = dS[b][a]/d angle_k (Euler; zeros for quat)
  float camp[8]; // [scale, w, h, offx, offy, 0, 0, 0]
  float free[6]; // free tangent slots (1/0)
};

// Quaternion / Euler rotation tables (cameras.rotation_l2w and
// spherical_matrix_derivs; ba_fused.py _r9_from_quat, _r9_ds27_from_euler).
__device__ __forceinline__ void cam_tables(int quat, const float* rot, float* R9, float* dS) {
  if (quat) {
    float w = rot[0], x = rot[1], y = rot[2], z = rot[3];
    float inv = 1.0f / sqrtf(w * w + x * x + y * y + z * z);
    w *= inv; x *= inv; y *= inv; z *= inv;
    float xx = x * x, yy = y * y, zz = z * z;
    float wx = w * x, wy = w * y, wz = w * z;
    float xy = x * y, xz = x * z, yz = y * z;
    float R[9] = {1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                  2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                  2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)};
    for (int i = 0; i < 9; ++i) R9[i] = R[i];
    for (int i = 0; i < 27; ++i) dS[i] = 0.f;
    return;
  }
  const float half_pi = 1.57079632679489661923f;
  float phi = rot[0], omega = rot[1] + half_pi, roll = rot[2];
  float cph = cosf(phi), sph = sinf(phi);
  float com = cosf(omega), som = sinf(omega);
  float crl = cosf(roll), srl = sinf(roll);
  float S[3][3] = {{cph * crl - sph * com * srl, -cph * srl - sph * com * crl, sph * som},
                   {sph * crl + cph * com * srl, -sph * srl + cph * com * crl, -cph * som},
                   {som * srl, som * crl, com}};
  // R = C^T S with C = [[1,0,0],[0,0,-1],[0,1,0]]: rows [S0; S2; -S1]
  for (int a = 0; a < 3; ++a) {
    R9[0 * 3 + a] = S[0][a];
    R9[1 * 3 + a] = S[2][a];
    R9[2 * 3 + a] = -S[1][a];
  }
  float d[3][3][3];  // d[k][b][a]
  for (int a = 0; a < 3; ++a) {
    d[0][0][a] = -S[1][a];
    d[0][1][a] = S[0][a];
    d[0][2][a] = 0.f;
  }
  float dth[3][3] = {{sph * som * srl, sph * som * crl, sph * com},
                     {-cph * som * srl, -cph * som * crl, -cph * com},
                     {com * srl, com * crl, -som}};
  for (int b = 0; b < 3; ++b) {
    for (int a = 0; a < 3; ++a) d[1][b][a] = dth[b][a];
    d[2][b][0] = S[b][1];
    d[2][b][1] = -S[b][0];
    d[2][b][2] = 0.f;
  }
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k)
      for (int b = 0; b < 3; ++b) dS[a * 9 + k * 3 + b] = d[k][b][a];
}

__device__ __forceinline__ void fill_cam(int quat, const float* rot, const float* camp,
                                         const float* free, int v, Cam& c) {
  for (int i = 0; i < 8; ++i) c.camp[i] = camp[v * 8 + i];
  for (int i = 0; i < 6; ++i) c.free[i] = free ? free[v * 6 + i] : 0.f;
  cam_tables(quat, rot + v * 4, c.R9, c.dS);
}

__device__ __forceinline__ float safe_w(float w) {
  return fabsf(w) < 1e-12f ? (w < 0.f ? -1e-12f : 1e-12f) : w;
}

// Per-track point quantities: dehomogenized p3, safe w, the S^3 tangent
// basis B (Householder, e3 -> -+p) and J3B = J3 * B (ba_pallas.py :175-184).
struct PointPre {
  float p4[4], p3[3], sw, B[12], J3B[9];
};

__device__ __forceinline__ void point_pre(const float p4[4], PointPre& P) {
#pragma unroll
  for (int i = 0; i < 4; ++i) P.p4[i] = p4[i];
  P.sw = safe_w(P.p4[3]);
  for (int i = 0; i < 3; ++i) P.p3[i] = P.p4[i] / P.sw;
  float sign = P.p4[3] >= 0.f ? 1.f : -1.f;
  float v4[4] = {P.p4[0], P.p4[1], P.p4[2], P.p4[3] + sign};
  float vn2 = fmaxf(v4[0] * v4[0] + v4[1] * v4[1] + v4[2] * v4[2] + v4[3] * v4[3], 1e-20f);
  for (int i = 0; i < 4; ++i)
    for (int q = 0; q < 3; ++q) P.B[i * 3 + q] = (i == q ? 1.f : 0.f) - 2.f * v4[i] * v4[q] / vn2;
  for (int j = 0; j < 3; ++j)
    for (int q = 0; q < 3; ++q) P.J3B[j * 3 + q] = (P.B[j * 3 + q] - P.p3[j] * P.B[9 + q]) / P.sw;
}

// Pixel projection of p3 through a camera's R9 and camp (ba_pallas.py
// _project_rows).
__device__ __forceinline__ void project(const float* R9, const float* camp, const float* p3,
                                        float local[3], float pix[2]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) local[a] = R9[a] * p3[0] + R9[3 + a] * p3[1] + R9[6 + a] * p3[2];
  float s = camp[0];
#pragma unroll
  for (int k = 0; k < 2; ++k) pix[k] = camp[1 + k] * (-(local[k] / s - camp[3 + k]) * 0.5f + 0.5f);
}

// Residual, Huber weight and closed-form Jacobians of one observation with
// mask m != 0 (ba_pallas.py _tile_blocks for one (view, track) entry), from
// a camera's R9, the two pixel rows of its Euler derivatives dS[k*9 + j*3 + b]
// (k < 2; unread for quaternions), camp and free mask; with free null the
// camera Jacobian is not masked.
__device__ __forceinline__ void obs_block(int quat, const float* R9, const float* dS,
                                          const float* camp, const float* free,
                                          const PointPre& P, float ox, float oy, float huber,
                                          float r[2], float& w, float Jc[2][6], float Jp[2][3]) {
  float local[3], pix[2];
  project(R9, camp, P.p3, local, pix);
  r[0] = pix[0] - ox;
  r[1] = pix[1] - oy;
  float s = camp[0];
  float asc[2] = {-camp[1] / (2.f * s), -camp[2] / (2.f * s)};
  float rn = sqrtf(fmaxf(r[0] * r[0] + r[1] * r[1], 1e-30f));
  w = fminf(1.f, huber / rn);
  const float px = P.p3[0], py = P.p3[1], pz = P.p3[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float dl[3];
    if (quat) {
      dl[0] = R9[3 + k] * pz - R9[6 + k] * py;
      dl[1] = -R9[k] * pz + R9[6 + k] * px;
      dl[2] = R9[k] * py - R9[3 + k] * px;
    } else {
      float Cp[3] = {px, -pz, py};
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dl[j] = dS[k * 9 + j * 3 + 0] * Cp[0] + dS[k * 9 + j * 3 + 1] * Cp[1] +
                dS[k * 9 + j * 3 + 2] * Cp[2];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) Jc[k][j] = asc[k] * dl[j];
    Jc[k][3 + k] = camp[1 + k] * 0.5f;
    Jc[k][4 - k] = 0.f;
    Jc[k][5] = -asc[k] * local[k] / s;
    if (free) {
#pragma unroll
      for (int j = 0; j < 6; ++j) Jc[k][j] *= free[j];
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      Jp[k][q] = asc[k] * (R9[k] * P.J3B[q] + R9[3 + k] * P.J3B[3 + q] + R9[6 + k] * P.J3B[6 + q]);
  }
}

// Accumulate one observation into the point block Vt (upper triangle
// 00,01,02,11,12,22) and the point gradient g_p = -sum w Jp^T r.
__device__ __forceinline__ void add_point_block(float w, const float Jp[2][3], const float r[2],
                                                float vt[6], float gp[3]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float a = w * Jp[k][0], b = w * Jp[k][1], cc = w * Jp[k][2];
    vt[0] += a * Jp[k][0]; vt[1] += a * Jp[k][1]; vt[2] += a * Jp[k][2];
    vt[3] += b * Jp[k][1]; vt[4] += b * Jp[k][2]; vt[5] += cc * Jp[k][2];
    gp[0] -= a * r[k]; gp[1] -= b * r[k]; gp[2] -= cc * r[k];
  }
}

// Inverse of the LM-damped 3x3 point block (ba_pallas.py _point_block_inv +
// _inv3x3_rows); zeros when points are held fixed.
__device__ __forceinline__ void point_inv(const float vt[6], float lam, int opt, float Vi[9]) {
  if (!opt) {
    for (int i = 0; i < 9; ++i) Vi[i] = 0.f;
    return;
  }
  float a = vt[0] + (lam * fmaxf(vt[0], 1e-8f) + 1e-10f), b = vt[1], c = vt[2];
  float d = vt[1], e = vt[3] + (lam * fmaxf(vt[3], 1e-8f) + 1e-10f), f = vt[4];
  float g = vt[2], h = vt[4], i = vt[5] + (lam * fmaxf(vt[5], 1e-8f) + 1e-10f);
  float A = e * i - f * h, B = -(d * i - f * g), C = d * h - e * g;
  float det = a * A + b * B + c * C;
  float inv_det = 1.f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  Vi[0] = A * inv_det; Vi[1] = -(b * i - c * h) * inv_det; Vi[2] = (b * f - c * e) * inv_det;
  Vi[3] = B * inv_det; Vi[4] = (a * i - c * g) * inv_det; Vi[5] = -(a * f - c * d) * inv_det;
  Vi[6] = C * inv_det; Vi[7] = -(a * h - b * g) * inv_det; Vi[8] = (a * e - b * d) * inv_det;
}

// ---------------------------------------------------------------------------
// K1: schur_assemble — replaces ba_pallas.py normal_eq_schur (and pass 1 of
// ba_fused.py run_lm).
//
// Bound: the Schur cross term W V^-1 W^T is, per track with m observed views,
// a rank-3 update of a dense (6m)-square block of the n x n system (n = 6V):
// 3 (6m)(6m+1)/2 FMA for its symmetric half, 14 kFMA a track at V = 16 and
// 222 kFMA at V = 64, against 4 + 3V floats of input per track, so K1 is
// FMA-bound (4.4 us at 16 x 8192 and 29 us at 64 x 4096 on the f32 peak).
// Design: each track's point and observation math in one CTA, written once
// as X = W V^-1 and Y = W to a K-major scratch buffer that stays in L2
// (19 MB at 16 x 8192), then the Schur sum as a dense split-K product with
// register-blocked micro-tiles over the observed tracks only. The same three
// kernels serve every n:
//   schur_blocks: one CTA per chunk of TC tracks, G lanes per track (views
//     lane, lane + G, ...). Warp 0 compacts the chunk's observed tracks (a
//     track with no observation adds nothing and takes no column). A first
//     pass over the views sums V and g_p (shuffles within the group) for
//     V^-1; a second writes X = W V^-1 and Y = W, 3 columns per track, into
//     the K-major scratch Xk, Yk (row k holds column k of X^T: n floats,
//     padded to ldx), zero-filling the chunk's last k-tile, and sums U's
//     upper triangle and the rhs per view in registers, then across the
//     groups of a warp by shuffles, then the eight warps' sums in turn into
//     one [V][27] buffer (a barrier before and after; the warps' partials
//     pass through their staging area): a fixed order. The camera tables
//     (Cam, 200 bytes a view) and that buffer (108) sit in shared memory
//     beside 38 KB of static shared memory up to ~600 views; past that the
//     tables come from a global table that schur_cams builds once a launch,
//     and the sums accumulate in place in the chunk's partial, in the same
//     order, so the result does not depend on where they sit. One partial
//     per chunk. Masked (track, view) entries are skipped (their X, Y
//     columns are zeros).
//   schur_product: S_p = X Y^T over the upper-triangle 32 x 32 output tiles
//     only (the product is symmetric), split over K by chunks; 64 threads, a
//     4 x 4 micro-tile each (two 16-byte shared loads per 16 FMA), k-tiles of
//     16 tracks double-buffered with cp.async; one partial tile per CTA.
//   schur_reduce: sums the product's partials in split order and the
//     blocks' partials in chunk order, eight loads in flight a lane, mirrors
//     the upper tiles (S' is exactly symmetric) and forms
//     S' = blkdiag(U) - X Y^T, diag(U), rhs.
// No float atomics anywhere: results are bit-stable from run to run. Ragged
// T, n and tiles are masked or padded.

constexpr int TC = 32;          // tracks per chunk of schur_blocks
constexpr int BLK_NT = 256;     // threads of schur_blocks
constexpr int NU = 27;          // per-view sums: U's upper triangle (21), rhs (6)
constexpr int KTT = 16;         // tracks per k-tile of schur_product
constexpr int KT3 = 3 * KTT;    // columns per k-tile
constexpr int PT = 32;          // edge of schur_product's output tiles
constexpr int PROD_NT = 64;     // threads of schur_product, a 4 x 4 micro-tile each

// Index of (a, b), a <= b, in the row-major upper triangle of a 6 x 6 block.
__device__ __forceinline__ int upper6(int a, int b) { return a * 6 - a * (a - 1) / 2 + (b - a); }

// The camera tables of the current half, one thread a view, for the block
// pass past shared memory.
__global__ void schur_cams_kernel(int quat, const float* rot_a, const float* rot_b,
                                  const float* camp_a, const float* camp_b,
                                  const float* __restrict__ free, const float* __restrict__ state,
                                  int V, Cam* __restrict__ cams) {
  if (state[DONE] != 0.f) return;
  const bool cur = state[CUR] != 0.f;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < V) fill_cam(quat, cur ? rot_b : rot_a, cur ? camp_b : camp_a, free, v, cams[v]);
}

// One block pass's own shared buffers: schur_blocks_kernel's, and each
// 256-thread group's in lm_fused. Per warp: its groups' tracks (slots); its
// X, Y slices ([2][3][192]), staged for coalesced stores of the scratch
// rows, then its per-view sums ([G][NU]) for the sum over warps.
struct __align__(16) BlocksShared {
  float stage[BLK_NT / 32][2 * 3 * 192];
  int wslot[BLK_NT / 32][32];
  int slot[TC], seen[TC];
  int count;
};

// The block pass of chunk c (tracks c TC .. c TC + TC - 1) by the BLK_NT
// threads of one group (tid 0 .. BLK_NT - 1; `sync` their barrier), from
// the camera tables `cams` and the current points pT at damping lam. usum:
// the chunk's [V][NU] sums, in shared memory (then copied to vpart_c) or,
// with vpart_c null, the chunk's partial itself.
__device__ __forceinline__ void schur_blocks_chunk(
    int quat, const float* pT, const float* obsT, const float* maskT, const Cam* cams,
    float lam, float huber, int opt, int V, int T, int G, int ldx, int c, float* Xk, float* Yk,
    int* counts, float* usum, float* vpart_c, BlocksShared& sh, GroupSync sync, int tid) {
  constexpr int NW = BLK_NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
  const int gl = tid & (G - 1);  // lane within the track's group
  const int grp = tid / G;
  const int t0 = c * TC;

  for (int i = tid; i < V * NU; i += BLK_NT) usum[i] = 0.f;
  if (tid < TC) sh.seen[tid] = 0;
  sync();
  {  // which of the chunk's tracks have an observation: every thread a few views
    const int k = tid % TC, t = t0 + k;
    int any = 0;
    if (t < T)
      for (int v = tid / TC; v < V; v += BLK_NT / TC) any |= maskT[(size_t)v * T + t] != 0.f;
    if (any) sh.seen[k] = 1;
  }
  sync();
  if (warp == 0) {
    const unsigned bal = __ballot_sync(0xffffffffu, sh.seen[lane] != 0);
    sh.slot[lane] = sh.seen[lane] ? __popc(bal & ((1u << lane) - 1u)) : -1;
    if (lane == 0) {
      sh.count = __popc(bal);
      counts[c] = opt ? __popc(bal) : 0;
    }
  }
  sync();
  const size_t cbase = (size_t)c * 3 * TC;  // first scratch column of the chunk
  if (opt) {  // zero the unused columns of the chunk's last k-tile
    const int count = sh.count;
    const size_t k0 = cbase + 3 * count, k1 = cbase + 3 * (((count + KTT - 1) / KTT) * KTT);
    for (size_t i = tid; i < (k1 - k0) * ldx; i += BLK_NT) {
      __stcs(&Xk[k0 * ldx + i], 0.f);
      __stcs(&Yk[k0 * ldx + i], 0.f);
    }
  }

  const int per_lane = (V + G - 1) / G;
  for (int k = grp; k - grp < TC; k += BLK_NT / G) {
    const int s = k < TC ? sh.slot[k] : -1;
    const int t = t0 + k;
    const bool live = s >= 0;
    PointPre P;
    float vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gp[3] = {0.f, 0.f, 0.f};
    if (live) {
      const float p4[4] = {pT[t], pT[(size_t)T + t], pT[2 * (size_t)T + t],
                           pT[3 * (size_t)T + t]};
      point_pre(p4, P);
      for (int v = gl; v < V; v += G) {
        if (maskT[(size_t)v * T + t] == 0.f) continue;
        float r[2], w, Jc[2][6], Jp[2][3];
        const Cam& cv = cams[v];
        obs_block(quat, cv.R9, cv.dS, cv.camp, cv.free, P, obsT[(size_t)(v * 2) * T + t],
                  obsT[(size_t)(v * 2 + 1) * T + t], huber, r, w, Jc, Jp);
        add_point_block(w, Jp, r, vt, gp);
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      for (int i = 0; i < 6; ++i) vt[i] += __shfl_xor_sync(0xffffffffu, vt[i], off);
      for (int i = 0; i < 3; ++i) gp[i] += __shfl_xor_sync(0xffffffffu, gp[i], off);
    }
    float Vi[9];
    point_inv(vt, lam, opt, Vi);
    if (gl == 0) sh.wslot[warp][lane / G] = s;

    for (int j = 0; j < per_lane; ++j) {
      const int v = gl + j * G;
      float u[NU];
      for (int e = 0; e < NU; ++e) u[e] = 0.f;
      float X[6][3], Y[6][3];
      for (int a = 0; a < 6; ++a)
        for (int q = 0; q < 3; ++q) X[a][q] = Y[a][q] = 0.f;
      if (live && v < V) {
        if (maskT[(size_t)v * T + t] != 0.f) {
          float r[2], w, Jc[2][6], Jp[2][3];
          const Cam& cv = cams[v];
          obs_block(quat, cv.R9, cv.dS, cv.camp, cv.free, P, obsT[(size_t)(v * 2) * T + t],
                    obsT[(size_t)(v * 2 + 1) * T + t], huber, r, w, Jc, Jp);
          for (int a = 0; a < 6; ++a) {
            for (int q = 0; q < 3; ++q) Y[a][q] = w * (Jc[0][a] * Jp[0][q] + Jc[1][a] * Jp[1][q]);
            for (int q = 0; q < 3; ++q)
              X[a][q] = Y[a][0] * Vi[0 * 3 + q] + Y[a][1] * Vi[1 * 3 + q] + Y[a][2] * Vi[2 * 3 + q];
            for (int b = a; b < 6; ++b)
              u[upper6(a, b)] = w * (Jc[0][a] * Jc[0][b] + Jc[1][a] * Jc[1][b]);
            u[21 + a] = -w * (Jc[0][a] * r[0] + Jc[1][a] * r[1]) -
                        (X[a][0] * gp[0] + X[a][1] * gp[1] + X[a][2] * gp[2]);
          }
        }
      }
      if (opt) {
        // Each group's 6G floats of a scratch row are contiguous (views
        // jG .. jG + G - 1): stage them, then the warp stores its 192 floats
        // of each row lane by lane.
        const int gw = lane / G, base = j * G * 6;
        for (int q = 0; q < 3; ++q)
          for (int a = 0; a < 6; ++a) {
            sh.stage[warp][q * 192 + gw * G * 6 + gl * 6 + a] = X[a][q];
            sh.stage[warp][(3 + q) * 192 + gw * G * 6 + gl * 6 + a] = Y[a][q];
          }
        __syncwarp();
        for (int e = lane; e < 192; e += 32) {
          const int g2 = e / (G * 6), off = e % (G * 6), s2 = sh.wslot[warp][g2];
          if (s2 < 0 || base + off >= 6 * V) continue;
          for (int q = 0; q < 3; ++q) {
            const size_t at = (cbase + 3 * s2 + q) * ldx + base + off;
            // streaming stores (evict-first in L2): the X, Y scratch (19 MB
            // at 16 x 8192) is read once more, by the product; kept at the
            // normal priority it pushes the problem's own inputs out of L2,
            // which inside lm_fused slowed every later stage (PERF.md)
            __stcs(&Xk[at], sh.stage[warp][q * 192 + e]);
            __stcs(&Yk[at], sh.stage[warp][(3 + q) * 192 + e]);
          }
        }
        __syncwarp();
      }
      // the groups of a warp that hold the same view, then the warps' sums
      // in turn (every warp's lanes gl hold views jG + gl)
      for (int off = G; off < 32; off <<= 1)
        for (int e = 0; e < NU; ++e) u[e] += __shfl_xor_sync(0xffffffffu, u[e], off);
      if (lane < G)
        for (int e = 0; e < NU; ++e) sh.stage[warp][lane * NU + e] = u[e];
      sync();
      for (int i = tid; i < G * NU && j * G * NU + i < V * NU; i += BLK_NT) {
        float s = usum[j * G * NU + i];
        for (int w = 0; w < NW; ++w) s += sh.stage[w][i];
        usum[j * G * NU + i] = s;
      }
      sync();
    }
  }
  if (vpart_c)
    for (int i = tid; i < V * NU; i += BLK_NT) vpart_c[i] = usum[i];
}

// gcams null: the camera tables and the chunk's per-view sums in shared
// memory; else the tables in gcams (schur_cams) and the sums in vpart.
__global__ void __launch_bounds__(BLK_NT) schur_blocks_kernel(
    int quat, const float* pT_a, const float* pT_b, const float* __restrict__ obsT,
    const float* __restrict__ maskT, const float* rot_a, const float* rot_b,
    const float* camp_a, const float* camp_b, const float* __restrict__ free,
    const float* __restrict__ state, float huber, int opt, int V, int T, int G, int ldx,
    const Cam* __restrict__ gcams, float* __restrict__ Xk, float* __restrict__ Yk,
    int* __restrict__ counts, float* __restrict__ vpart) {
  if (state[DONE] != 0.f) return;
  const bool cur = state[CUR] != 0.f;
  extern __shared__ float smem[];
  __shared__ BlocksShared sh;
  Cam* scams = reinterpret_cast<Cam*>(smem);
  const int tid = threadIdx.x, c = blockIdx.x;
  float* vpart_c = vpart + (size_t)c * V * NU;
  if (!gcams)
    for (int v = tid; v < V; v += BLK_NT)
      fill_cam(quat, cur ? rot_b : rot_a, cur ? camp_b : camp_a, free, v, scams[v]);
  schur_blocks_chunk(quat, cur ? pT_b : pT_a, obsT, maskT, gcams ? gcams : scams, state[LAM],
                     huber, opt, V, T, G, ldx, c, Xk, Yk, counts,
                     gcams ? vpart_c : reinterpret_cast<float*>(scams + V),
                     gcams ? nullptr : vpart_c, sh, GroupSync{0, BLK_NT}, tid);
}

// A 16-byte copy of K1's scratch into shared memory, marked first to leave
// L2: X and Y are dead once the product has read them (see the block
// pass's stores).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "l"(policy));
}

// The k-tile after (c, kt) among the chunks before c_end; false at the end.
__device__ __forceinline__ bool next_ktile(const int* __restrict__ counts, int c_end, int& c,
                                           int& kt) {
  ++kt;
  while (c < c_end && kt * KTT >= counts[c]) {
    ++c;
    kt = 0;
  }
  return c < c_end;
}

// The product's double-buffered k-tiles of X and Y, one work item's.
struct ProductShared {
  float Xs[2][KT3][PT], Ys[2][KT3][PT];
};

// Work item (tile, y) of the product: output tile `tile` of the upper
// triangle over split y's chunks, by the PROD_NT threads of one group
// (tid 0 .. PROD_NT - 1; `sync` their barrier), into its partial tile.
__device__ __forceinline__ void schur_product_tile(int ldx, int n_chunks, int cps,
                                                   const int* counts, const float* Xk,
                                                   const float* Yk, float* Ppart, int tile, int y,
                                                   ProductShared& sh, GroupSync sync, int tid) {
  const int nt = ldx / PT;
  int ti = 0, u = tile;
  while (u >= nt - ti) {
    u -= nt - ti;
    ++ti;
  }
  const int r0 = ti * PT, c0 = (ti + u) * PT;
  const int c_end = min(n_chunks, (y + 1) * cps);
  const int ty = tid >> 3, tx = tid & 7;

  auto load = [&](int buf, int c, int kt) {
    const size_t col0 = (size_t)c * 3 * TC + kt * KT3;
    for (int i = tid; i < KT3 * (PT / 4); i += PROD_NT) {
      const int kk = i / (PT / 4), q4 = (i % (PT / 4)) * 4;
      cp_async16(&sh.Xs[buf][kk][q4], Xk + (col0 + kk) * ldx + r0 + q4);
      cp_async16(&sh.Ys[buf][kk][q4], Yk + (col0 + kk) * ldx + c0 + q4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int c = y * cps, kt = -1;
  bool have = next_ktile(counts, c_end, c, kt);
  int buf = 0;
  if (have) load(0, c, kt);
  while (have) {
    int cn = c, ktn = kt;
    const bool more = next_ktile(counts, c_end, cn, ktn);
    if (more) {
      load(buf ^ 1, cn, ktn);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    sync();
#pragma unroll 8
    for (int kk = 0; kk < KT3; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sh.Xs[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sh.Ys[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    sync();
    buf ^= 1;
    c = cn;
    kt = ktn;
    have = more;
  }
  float* P = Ppart + ((size_t)y * (nt * (nt + 1) / 2) + tile) * PT * PT;
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&P[(ty * 4 + i) * PT + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

__global__ void __launch_bounds__(PROD_NT) schur_product_kernel(
    const float* __restrict__ state, int ldx, int n_chunks, int cps,
    const int* __restrict__ counts, const float* __restrict__ Xk, const float* __restrict__ Yk,
    float* __restrict__ Ppart) {
  if (state[DONE] != 0.f) return;
  __shared__ __align__(16) ProductShared sh;
  schur_product_tile(ldx, n_chunks, cps, counts, Xk, Yk, Ppart, blockIdx.x, blockIdx.y, sh,
                     GroupSync{0, PROD_NT}, threadIdx.x);
}

// schur_reduce: RL lanes per output value, each summing every RL-th partial
// in order, eight loads in flight, then a shuffle tree: the order is fixed.
constexpr int RL = 8;

__device__ __forceinline__ float tree_sum(float x) {
  for (int off = RL / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane `sub`'s share of the sum of p[0], p[stride], ... (count terms).
__device__ __forceinline__ float strided_sum(const float* __restrict__ p, size_t stride,
                                             int count, int sub) {
  float s = 0.f;
  for (int k0 = sub; k0 < count; k0 += 8 * RL) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + q * RL;
      v[q] = k < count ? p[(size_t)k * stride] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) s += v[q];
  }
  return s;
}

// Lane vt of the reduce (lane vt % RL of item vt / RL). Item i of the first
// n * n: S'(i / n, i % n) and its mirror, for i / n <= i % n (blkdiag(U)
// minus the product's partials); then rhs, then diag(U). Every lane of a
// warp reaches the shuffles (a warp holds lanes 32w .. 32w + 31); idle
// groups add zeros.
__device__ __forceinline__ void schur_reduce_lane(size_t vt, int V, int ldx, int n_split,
                                                  int n_chunks, const float* Ppart,
                                                  const float* vpart, float* S, float* dU,
                                                  float* rhs) {
  const int n = 6 * V, nt = ldx / PT, n_tiles = nt * (nt + 1) / 2;
  const size_t nn = (size_t)n * n;  // 64-bit: n * n passes 2^31 from ~7700 views
  const size_t item = vt / RL;
  const int sub = (int)(vt % RL);
  const bool is_s = item < nn;
  int i = 0, j = 0, e = -1;  // e: the per-view sum this item needs, if any
  bool live = item < nn + 2 * (size_t)n;
  if (live && is_s) {
    i = (int)(item / n);
    j = (int)(item % n);
    live = i <= j;
    if (i / 6 == j / 6) e = upper6(i % 6, j % 6);
  } else if (live) {
    i = j = (int)((item - nn) % n);
    e = item - nn < (size_t)n ? 21 + i % 6 : upper6(i % 6, i % 6);
  }
  float u = 0.f, p = 0.f;
  if (live && e >= 0)
    u = strided_sum(vpart + (size_t)(i / 6) * NU + e, (size_t)V * NU, n_chunks, sub);
  if (live && is_s) {
    const int ti = i / PT, tj = j / PT;
    p = strided_sum(Ppart + (size_t)(ti * nt - ti * (ti - 1) / 2 + (tj - ti)) * PT * PT +
                        (i % PT) * PT + j % PT,
                    (size_t)n_tiles * PT * PT, n_split, sub);
  }
  u = tree_sum(u);
  p = tree_sum(p);
  if (!live || sub != 0) return;
  if (is_s) {
    S[(size_t)i * n + j] = u - p;
    S[(size_t)j * n + i] = u - p;
  } else {
    (item - nn < (size_t)n ? rhs : dU)[i] = u;
  }
}

__global__ void __launch_bounds__(NT) schur_reduce_kernel(
    const float* __restrict__ state, int V, int ldx, int n_split, int n_chunks,
    const float* __restrict__ Ppart, const float* __restrict__ vpart, float* __restrict__ S,
    float* __restrict__ dU, float* __restrict__ rhs) {
  if (state[DONE] != 0.f) return;
  schur_reduce_lane((size_t)blockIdx.x * NT + threadIdx.x, V, ldx, n_split, n_chunks, Ppart,
                    vpart, S, dU, rhs);
}

// ---------------------------------------------------------------------------
// K3: camera_solve — replaces the reduced camera system, _gauss_jordan and
// the camera retraction of ba_fused.py run_lm (:369-407, :199-226).
//
// Bound: n^3/6 FMA for a Cholesky of the n x n system and n^2 for the two
// triangular solves: 0.16 MFMA at n = 96, 9.4 MFMA at n = 384, far below the
// card's peak; reading S (n^2 floats) takes 0.01 us at n = 96. What sets the
// time is the chain of dependent steps: n pivots, each a few shuffles and
// an rsqrt long, and the barriers and memory round trips between them; at
// n = 384 the matrix (590 KB) no longer fits one SM's shared memory, so it
// is spread over a cluster's. Design: the damped, pinned, Jacobi-scaled system is
// symmetric positive definite, so a Cholesky (a third of Gauss-Jordan's
// FMAs) of the bordered matrix [[S_s, .], [b^T, .]], whose last row becomes
// y = L^-1 b, then the back substitution L^T x = y. Every load of S is
// issued before the first is used (one memory round trip, not one per row).
//   n <= 30 (up to 5 views, the local BAs): one warp, lane i holding row i
//     in registers; a pivot is a shuffle and an rsqrt, the rank-1 update n
//     shuffles and FMAs, with no barrier at all; n is a template argument,
//     so every loop is unrolled.
//   6 to 37 views (n <= 222): one CTA, its whole matrix in shared memory, a
//     blocked right-looking factorization with panels of PW = 16 columns:
//     one warp factors the panel's diagonal block in registers with
//     shuffles, one thread per row below solves its row against it (staging
//     the panel in shared memory), and the trailing lower triangle takes a
//     rank-16 update in 4 x 4 register tiles read as 16-byte loads: three
//     barriers per panel instead of one per column. The back substitution
//     is two barriers per panel: one warp solves the panel's triangle, then
//     every thread takes the panel's x out of the rows above.
//   38 views and more: the same panels on a cluster of 8 CTAs (below), each
//     owning every eighth 16-row block and exchanging one solved panel per
//     step over distributed shared memory: two cluster barriers a panel, and
//     eight SMs' shared memory and FMA units on the trailing update. A
//     one-CTA version with its matrix in a global scratch read through one
//     SM's L1/L2 path took 0.495 ms at n = 384 against the cluster's 0.176
//     (scripts/torch_ba_kernel_turns.py, both in one run on an H100 SXM at
//     700 W). The cluster keeps its rows in shared memory up to 119 views
//     and in a global scratch from 120 views to its limit of 1365 (64 row
//     blocks a CTA).
//   From GRID_MIN_V views: the grid route (below the cluster kernel), the
//     panels spread over the whole card from a global scratch, for any n.
//     The cluster's panels each wait on one warp's factorization of a
//     16-wide block behind two cluster barriers, ~413 of them at n = 6600,
//     where it took 320 ms against 26 ms for torch.linalg.solve_ex.
// No pivoting, no clamp: a pivot that is not positive makes the whole step
// NaN, every camera's (pinned and unobserved ones too, whose NaN K2's cost
// would not see), so K2's cost is NaN and its last CTA rejects the step and
// raises lambda, as Ceres treats a failed Cholesky. The plain version's LU
// solves an indefinite system; a damped reduced camera system is positive
// definite, and only f32 rounding at a small lambda makes it otherwise. Then
// the kernel retracts the cameras into the half of the camera buffers that
// state[CUR] does not name.

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_SOLVE_V = 5;  // views of the one-warp solve (n <= 30)
constexpr int PW = 16;           // panel width of the blocked Cholesky
constexpr int PS = PW + 4;       // row stride of the staged panel (16-byte aligned rows)
constexpr int DS = PW + 1;       // row stride of the staged diagonal block

// Candidate camera: q <- normalize(exp(d) (x) q) or angles += d; offsets and
// scale additive (cameras.retract; ba_fused.py _retract_quat/_euler).
__device__ __forceinline__ void retract_camera(int quat, const float* d, const float* q,
                                               const float* cp, float* qo, float* co) {
  if (quat) {
    const float a2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const bool small = a2 < 1e-12f;
    const float angle = sqrtf(small ? 1.f : a2);
    const float kk = small ? 0.5f - a2 / 48.f : sinf(0.5f * angle) / angle;
    const float aw = small ? 1.f - a2 / 8.f : cosf(0.5f * angle);
    const float ax = kk * d[0], ay = kk * d[1], az = kk * d[2];
    const float o[4] = {aw * q[0] - ax * q[1] - ay * q[2] - az * q[3],
                        aw * q[1] + ax * q[0] + ay * q[3] - az * q[2],
                        aw * q[2] - ax * q[3] + ay * q[0] + az * q[1],
                        aw * q[3] + ax * q[2] - ay * q[1] + az * q[0]};
    const float nrm = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
    for (int i = 0; i < 4; ++i) qo[i] = o[i] / nrm;
  } else {
    for (int i = 0; i < 3; ++i) qo[i] = q[i] + d[i];
    qo[3] = q[3];
  }
  for (int i = 0; i < 8; ++i) co[i] = cp[i];
  co[0] += d[5];
  co[3] += d[3];
  co[4] += d[4];
}

// The cameras K3 reads (the half state[CUR] names) and the half it writes
// the candidate into.
struct CamHalves {
  const float *rot, *camp;
  float *rot_c, *camp_c;
};

__device__ __forceinline__ CamHalves cam_halves(const float* state, float* rot_a, float* rot_b,
                                                float* camp_a, float* camp_b) {
  const bool cur = state[CUR] != 0.f;
  return {cur ? rot_b : rot_a, cur ? camp_b : camp_a, cur ? rot_a : rot_b, cur ? camp_a : camp_b};
}

// The one-warp solve by lane i of one warp, its matrix staged in Ls and its
// step in ds (shared memory). CHECK_DONE: return at once on state[DONE]
// (the per-iteration kernel); lm_fused leaves its loop instead.
template <int V, bool CHECK_DONE>
__device__ __forceinline__ void camera_solve_warp(int quat, const float* S, const float* dU,
                                                  const float* rhs, const float* free,
                                                  const float* state, float* rot_a, float* rot_b,
                                                  float* camp_a, float* camp_b, float* delta,
                                                  float (*Ls)[6 * V + 1], float* ds, int i) {
  constexpr int N = 6 * V;
  const bool row = i < N;
  const CamHalves h = cam_halves(state, rot_a, rot_b, camp_a, camp_b);
  const float *rot = h.rot, *camp = h.camp;
  // Every load first: row i of S, dU, rhs and the free mask of unknown i,
  // camera i's parameters and the scalar state.
  float a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = row ? S[i * N + j] : 0.f;
  const float du = row ? dU[i] : 0.f, bi = row ? rhs[i] : 0.f, f = row ? free[i] : 0.f;
  float q[4], cp[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = i < V ? rot[i * 4 + k] : 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) cp[k] = i < V ? camp[i * 8 + k] : 0.f;
  const float lam = state[LAM];
  if (CHECK_DONE && state[DONE] != 0.f) return;

  // The damped, pinned, Jacobi-scaled system (ba.prepare_camera_system).
  float aii = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) aii = j == i ? a[j] : aii;
  const float damp = lam * fmaxf(du, 1e-8f);
  // one reciprocal of the scale per unknown: a division per entry costs
  // more than the whole factorization
  const float rd = row ? 1.f / sqrtf(fmaxf(fabsf((aii + damp) * f * f + (1.f - f)), 1e-12f)) : 1.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float fj = __shfl_sync(FULL, f, j), rdj = __shfl_sync(FULL, rd, j);
    const float v = (j == i ? a[j] + damp : a[j]) * f * fj + (j == i ? 1.f - f : 0.f);
    a[j] = v * rd * rdj;
  }
  float y = bi * f * rd;

  // Cholesky of the bordered system: column c's pivot, its column of L, and
  // the rank-1 update of the rows below (y with them).
  bool bad = false;
  float il_own = 1.f;  // 1 / L_ii of this lane's row
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const float piv = __shfl_sync(FULL, a[c], c);
    bad |= !(piv > 0.f);
    const float il = rsqrtf(piv);
    a[c] = i == c ? piv * il : (i > c ? a[c] * il : a[c]);
    y = i == c ? y * il : y;
    il_own = i == c ? il : il_own;
    const float yc = __shfl_sync(FULL, y, c);
    float l[N];
#pragma unroll
    for (int j = c + 1; j < N; ++j) l[j] = __shfl_sync(FULL, a[c], j);
#pragma unroll
    for (int j = c + 1; j < N; ++j)
      if (i >= j) a[j] -= a[c] * l[j];
    if (i > c) y -= a[c] * yc;
  }

  // Back substitution L^T x = y: x_c from lane c, then the rows above.
  if (row) {
#pragma unroll
    for (int j = 0; j < N; ++j) Ls[i][j] = a[j];
  }
  __syncwarp();
  float r = y, x = 0.f;
#pragma unroll
  for (int c = N - 1; c >= 0; --c) {
    const float xc = __shfl_sync(FULL, r * il_own, c);
    x = i == c ? xc : x;
    if (i < c) r -= Ls[c][i] * xc;
  }

  bad = bad || __any_sync(FULL, row && f != 0.f && !isfinite(x));
  const float dl = bad ? __int_as_float(0x7fc00000) : (f != 0.f ? x * rd * f : 0.f);
  if (row) delta[i] = dl;
  ds[i] = dl;
  __syncwarp();
  if (i < V) retract_camera(quat, ds + 6 * i, q, cp, h.rot_c + 4 * i, h.camp_c + 8 * i);
}

template <int V>
__global__ void __launch_bounds__(32) camera_solve_warp_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    float* __restrict__ delta) {
  __shared__ float Ls[6 * V][6 * V + 1];
  __shared__ float ds[32];
  camera_solve_warp<V, true>(quat, S, dU, rhs, free, state, rot_a, rot_b, camp_a, camp_b, delta,
                             Ls, ds, threadIdx.x);
}

// The one-CTA solve by the NT threads of one CTA (tid 0 .. NT - 1), its
// matrix and vectors in solve_smem (solve_plan(V).smem bytes, 16-byte
// aligned). Every entry is computed by one thread or one warp whatever NT
// is, so the result does not depend on NT. CHECK_DONE: return at once on
// state[DONE] (the per-iteration kernel); lm_fused leaves its loop instead.
template <int NT, bool CHECK_DONE>
__device__ __forceinline__ void camera_solve_cta(int quat, const float* S, const float* dU,
                                                 const float* rhs, const float* free,
                                                 const float* state, float* rot_a, float* rot_b,
                                                 float* camp_a, float* camp_b, int V,
                                                 float* delta, float* solve_smem, int& s_failed,
                                                 int tid) {
  const int n = 6 * V, N = n + 1, ld = round4(N);
  float* rds = solve_smem;            // [n]       1 / Jacobi scale
  float* fr = rds + round4(n);        // [n]       free mask
  float* dmp = fr + round4(n);        // [n]       LM damping of the diagonal
  float* xs = dmp + round4(n);        // [n]       y, then the solution
  float* inv = xs + round4(n);        // [n]       1 / L_ii
  float* dg = inv + round4(n);        // [PW][DS]  the panel's diagonal block
  float* dgi = dg + round4(PW * DS);  // [PW]      1 / its diagonal (1 past kb)
  float* pan = dgi + PW;              // [N + 3][PS] the panel's rows below its block
  float* A = pan + (n + 4) * PS;      // [N][ld]   the lower triangle
  const int lane = tid & 31, warp = tid >> 5;
  const float lam = state[LAM];
  if (CHECK_DONE && state[DONE] != 0.f) return;
  if (tid == 0) s_failed = 0;

  // Per unknown: damping, free mask and the reciprocal of the Jacobi scale
  // (multiplying by it, not dividing, in the loops below: a division per
  // entry cost more than the factorization); row n of A is b^T.
  for (int i = tid; i < n; i += NT) {
    const float f = free[i], damp = lam * fmaxf(dU[i], 1e-8f);
    const float rd =
        1.f / sqrtf(fmaxf(fabsf((S[(size_t)i * n + i] + damp) * f * f + (1.f - f)), 1e-12f));
    rds[i] = rd;
    fr[i] = f;
    dmp[i] = damp;
    A[(size_t)n * ld + i] = rhs[i] * f * rd;
  }
  __syncthreads();
  // The lower triangle of the damped, pinned, scaled system, from S read as
  // float4 (n * n is a multiple of 4, S 16-byte aligned), eight loads a
  // thread in flight.
  const float4* S4 = reinterpret_cast<const float4*>(S);
  const size_t n4 = (size_t)n * n / 4;
  for (size_t e0 = tid; e0 < n4; e0 += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const size_t e = e0 + q * NT;
      v[q] = e < n4 ? S4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const size_t e = e0 + q * NT;
      if (e >= n4) continue;
      int r = (int)((4 * e) / n), j = (int)(4 * e - (size_t)r * n);
      const float vv[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j <= r) {
          const float a = (r == j ? vv[k] + dmp[r] : vv[k]) * fr[r] * fr[j] +
                          (r == j ? 1.f - fr[r] : 0.f);
          A[(size_t)r * ld + j] = a * rds[r] * rds[j];
        }
        if (++j == n) {
          j = 0;
          ++r;
        }
      }
    }
  }
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += PW) {
    const int kb = min(PW, n - k0);
    if (warp == 0) {
      // Lane r holds row k0 + r of the diagonal block (identity past kb).
      float a[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c)
        a[c] = (lane < kb && c <= lane) ? A[(size_t)(k0 + lane) * ld + k0 + c]
                                        : (c == lane ? 1.f : 0.f);
      bool bad = false;
      float il_own = 1.f;
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        const float piv = __shfl_sync(FULL, a[c], c);
        bad |= !(piv > 0.f);
        const float il = rsqrtf(piv);
        a[c] = lane == c ? piv * il : (lane > c ? a[c] * il : a[c]);
        il_own = lane == c ? il : il_own;
        float l[PW];
#pragma unroll
        for (int c2 = c + 1; c2 < PW; ++c2) l[c2] = __shfl_sync(FULL, a[c], c2);
#pragma unroll
        for (int c2 = c + 1; c2 < PW; ++c2)
          if (lane >= c2) a[c2] -= a[c] * l[c2];
      }
      if (lane < PW) {
        dgi[lane] = il_own;
        if (lane < kb) inv[k0 + lane] = il_own;
#pragma unroll
        for (int c = 0; c < PW; ++c)
          if (c <= lane) {
            dg[lane * DS + c] = a[c];
            if (lane < kb) A[(size_t)(k0 + lane) * ld + k0 + c] = a[c];
          }
      }
      if (bad && lane == 0) s_failed = 1;
    }
    __syncthreads();
    // The rows below: l_i = a_i L_kk^-T, one thread a row, staged in `pan`.
    const int b0 = k0 + kb;
    for (int i = b0 + tid; i < N; i += NT) {
      float x[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) x[c] = c < kb ? A[(size_t)i * ld + k0 + c] : 0.f;
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        float s = x[c];
#pragma unroll
        for (int c2 = 0; c2 < c; ++c2) s -= x[c2] * dg[c * DS + c2];
        x[c] = s * dgi[c];
      }
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        if (c < kb) A[(size_t)i * ld + k0 + c] = x[c];
        pan[i * PS + c] = x[c];
      }
    }
    __syncthreads();
    // Trailing update of the lower triangle, rows and columns b0..n.
    const int mb = (N - b0 + 3) / 4;
    const int n_tiles = mb * (mb + 1) / 2;
    for (int t = tid; t < n_tiles; t += NT) {
      const float t8 = 8.f * t + 1.f;  // bi from an approximate root, then exact
      int bi = (int)((t8 * rsqrtf(t8) - 1.f) * 0.5f);
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      const int i0 = b0 + 4 * bi, j0 = b0 + 4 * (t - bi * (bi + 1) / 2);
      float acc[4][4];  // the tile's current values, loaded before the sums
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[p][q] = (i0 + p < N && j0 + q <= i0 + p) ? A[(size_t)(i0 + p) * ld + j0 + q] : 0.f;
#pragma unroll
      for (int c = 0; c < PW; c += 4) {
        float4 ri[4], cj[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          ri[p] = *reinterpret_cast<const float4*>(&pan[(i0 + p) * PS + c]);
          cj[p] = *reinterpret_cast<const float4*>(&pan[(j0 + p) * PS + c]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[p][q] -= ri[p].x * cj[q].x + ri[p].y * cj[q].y + ri[p].z * cj[q].z +
                         ri[p].w * cj[q].w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + p, j = j0 + q;
          if (i < N && j <= i) A[(size_t)i * ld + j] = acc[p][q];
        }
    }
    __syncthreads();
  }

  // Back substitution L^T x = y (y = row n), a panel at a time from the end:
  // warp 0 solves the panel's triangle, then every thread takes the panel's
  // x out of the rows above it.
  for (int i = tid; i < n; i += NT) xs[i] = A[(size_t)n * ld + i];
  __syncthreads();
  for (int k0 = ((n - 1) / PW) * PW; k0 >= 0; k0 -= PW) {
    const int kb = min(PW, n - k0);
    if (warp == 0) {
      float l[PW];  // lane r: L[k0 + c][k0 + r] for c > r
#pragma unroll
      for (int c = 0; c < PW; ++c)
        l[c] = (c < kb && lane < c) ? A[(size_t)(k0 + c) * ld + k0 + lane] : 0.f;
      float r = lane < kb ? xs[k0 + lane] : 0.f, x = 0.f;
      const float il = lane < kb ? inv[k0 + lane] : 0.f;
#pragma unroll
      for (int c = PW - 1; c >= 0; --c) {
        const float xc = __shfl_sync(FULL, r * il, c);
        x = lane == c ? xc : x;
        r -= l[c] * xc;
      }
      if (lane < kb) xs[k0 + lane] = x;
    }
    __syncthreads();
    for (int i = tid; i < k0; i += NT) {
      float s = xs[i];
#pragma unroll
      for (int c = 0; c < PW; ++c)
        if (c < kb) s -= A[(size_t)(k0 + c) * ld + i] * xs[k0 + c];
      xs[i] = s;
    }
    __syncthreads();
  }

  // A failed factorization (a pivot not positive, or a free unknown that
  // came out non-finite) fails the whole step, pinned and unobserved cameras
  // included, so that no part of it can pass K2's cost test; otherwise a
  // pinned parameter's step is exactly 0.
  for (int i = tid; i < n; i += NT)
    if (fr[i] != 0.f && !isfinite(xs[i])) s_failed = 1;
  __syncthreads();
  const bool failed = s_failed != 0;
  for (int i = tid; i < n; i += NT)
    delta[i] = failed ? __int_as_float(0x7fc00000)
                      : (fr[i] != 0.f ? xs[i] * rds[i] * fr[i] : 0.f);
  __syncthreads();
  const CamHalves h = cam_halves(state, rot_a, rot_b, camp_a, camp_b);
  for (int v = tid; v < V; v += NT)
    retract_camera(quat, delta + 6 * v, h.rot + 4 * v, h.camp + 8 * v, h.rot_c + 4 * v,
                   h.camp_c + 8 * v);
}

template <int NT>
__global__ void __launch_bounds__(NT) camera_solve_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    int V, float* __restrict__ delta) {
  extern __shared__ __align__(16) float solve_smem[];
  __shared__ int s_failed;  // a pivot was not positive
  camera_solve_cta<NT, true>(quat, S, dU, rhs, free, state, rot_a, rot_b, camp_a, camp_b, V,
                             delta, solve_smem, s_failed, threadIdx.x);
}

// The cluster version, for a matrix too large for one CTA's shared memory:
// a cluster of CL_C CTAs, each owning the row blocks b with b % CL_C == its
// rank (block b: rows 16b..16b+15, the rows of panel b's diagonal block).
// Per panel: the owner's warp 0 factors the diagonal block and writes it into
// every CTA's shared memory; a cluster barrier; every CTA solves its own rows
// below against it, one thread a row, and writes each row's 16 panel values
// into every CTA's staged panel; a cluster barrier; every CTA updates the
// lower triangle of its own rows from its staged panel, in 4 x 4 register
// tiles, the tiles spread evenly over its threads. The back substitution
// runs a panel at a time from the end on the panel's owner, which gathers
// the other CTAs' sums of the solved rows (sum_j L[j][i] x_j, each CTA over
// its own rows j) and adds its own: one cluster barrier a panel. Where a
// CTA's rows and the panel do not fit its shared memory (G), they live in
// a global scratch read through L1/L2, the panel once for the cluster.

constexpr int CL_C = 8;     // CTAs of the cluster (the portable limit)
constexpr int CL_NT = 512;  // threads per CTA
constexpr int CL_RT = 256;  // own row tiles a CTA can hold: 64 blocks
constexpr int RB = PW;      // rows per row block

// Floats of a row of block r: its columns up to 16r + 15, padded so that
// consecutive rows start four banks apart.
__host__ __device__ __forceinline__ int row_len(int r) { return RB * (r + 1) + 4; }

// Offset of CTA q's l-th own block (block q + l C) in its rows.
__host__ __device__ __forceinline__ size_t blk_off(int q, int l) {
  return (size_t)RB * ((size_t)l * (RB * (q + 1) + 4) + (size_t)RB * CL_C * l * (l - 1) / 2);
}

// Blocks CTA q owns among nblk.
__host__ __device__ __forceinline__ int own_blocks(int q, int nblk) {
  return q < nblk ? (nblk - 1 - q) / CL_C + 1 : 0;
}

// Shared floats of the cluster solve besides its rows and staged panel:
// six vectors of n, the diagonal block, its inverse diagonal, and the ints
// (the failure flag, the tile count, the row tiles' tile prefix).
__host__ __device__ int cluster_vec_floats(int n) {
  return 6 * round4(n) + round4(PW * DS) + PW + round4(2 + CL_RT);
}

// The cluster solve by the CL_NT threads of each CTA of one cluster of
// CL_C (tid 0 .. CL_NT - 1), its vectors, diagonal block and (unless G)
// rows and staged panel in cl_smem (solve_plan(V).smem bytes, at the same
// offset in every CTA of the cluster), with G in gscratch. CHECK_DONE:
// return at once on state[DONE] (the per-iteration kernel); lm_fused leaves
// its loop instead and runs this on its first cluster, its other CTAs
// waiting at the grid barrier after the stage.
template <bool G, bool CHECK_DONE>
__device__ __forceinline__ void camera_solve_cluster(
    int quat, const float* S, const float* dU, const float* rhs, const float* free,
    const float* state, float* rot_a, float* rot_b, float* camp_a, float* camp_b, int V,
    size_t rows_max, float* gscratch, float* delta, float* cl_smem, int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = 6 * V, N = n + 1, nblk = (N + RB - 1) / RB, npan = (n + PW - 1) / PW;
  const int lane = tid & 31, warp = tid >> 5;
  float* rds = cl_smem;               // [n] 1 / Jacobi scale
  float* fr = rds + round4(n);        // [n] free mask
  float* dmp = fr + round4(n);        // [n] LM damping of the diagonal
  float* con = dmp + round4(n);       // [n] sum_j L[j][i] x_j over own solved rows j
  float* xs = con + round4(n);        // [n] x: own panels' (rank 0: all of it)
  float* inv = xs + round4(n);        // [n] 1 / L_ii of own panels
  float* dg = inv + round4(n);        // [PW][DS] the panel's diagonal block
  float* dgi = dg + round4(PW * DS);  // [PW] 1 / its diagonal (1 past kb)
  int* ctl = reinterpret_cast<int*>(dgi + PW);  // failed, tiles, row tiles' prefix
  int* rt_end = ctl + 2;
  float* vec_end = dgi + PW + round4(2 + CL_RT);
  // [N + 3][PS] the staged panel, then this CTA's row blocks
  float* pan = G ? gscratch + (size_t)CL_C * rows_max : vec_end;
  float* rows = G ? gscratch + (size_t)rank * rows_max : vec_end + (size_t)(N + 3) * PS;
  const float lam = state[LAM];
  if (CHECK_DONE && state[DONE] != 0.f) return;  // the same for every CTA of the cluster
  if (tid == 0) ctl[0] = 0;

  for (int i = tid; i < n; i += CL_NT) {
    const float f = free[i], damp = lam * fmaxf(dU[i], 1e-8f);
    rds[i] = 1.f / sqrtf(fmaxf(fabsf((S[(size_t)i * n + i] + damp) * f * f + (1.f - f)), 1e-12f));
    fr[i] = f;
    dmp[i] = damp;
    con[i] = 0.f;
  }
  __syncthreads();
  // Own rows of the damped, pinned, scaled bordered matrix (row n is b^T).
  const int own = own_blocks(rank, nblk);
  for (int l = 0; l < own; ++l) {
    const int r = rank + l * CL_C, len = RB * (r + 1), rl = row_len(r);
    float* blk = rows + blk_off(rank, l);
#pragma unroll 4
    for (int e = tid; e < RB * len; e += CL_NT) {
      const int q = e / len, j = e - q * len, i = RB * r + q;
      float a = 0.f;
      if (i < n && j <= i) {
        const float v = S[(size_t)i * n + j];
        a = ((i == j ? v + dmp[i] : v) * fr[i] * fr[j] + (i == j ? 1.f - fr[i] : 0.f)) * rds[i] *
            rds[j];
      } else if (i == n && j < n) {
        a = rhs[j] * fr[j] * rds[j];
      }
      blk[q * rl + j] = a;
    }
  }
  __syncthreads();

  for (int p = 0; p < npan; ++p) {
    const int k0 = p * PW, kb = min(PW, n - k0), b0 = k0 + kb;
    const int l0 = rank >= p ? 0 : (p - rank + CL_C - 1) / CL_C;  // first own block >= p
    const int K = 4 * (own - l0);                                 // own row tiles from there
    if (warp == 1) {
      // tiles of the trailing update a row tile holds (its columns b0 up to
      // its last row), and their running sum
      int run = 0;
      for (int kk = 0; kk < K; kk += 32) {
        const int k = kk + lane;
        int cnt = 0;
        if (k < K) {
          const int i0 = RB * (rank + (l0 + k / 4) * CL_C) + 4 * (k % 4);
          const int last = min(i0 + 3, N - 1);
          cnt = i0 < N && last >= b0 ? (last - b0) / 4 + 1 : 0;
        }
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(FULL, cnt, off);
          if (lane >= off) cnt += y;
        }
        if (k < K) rt_end[k] = run + cnt;
        run += __shfl_sync(FULL, cnt, 31);
      }
      if (lane == 0) ctl[1] = run;
    }
    if (rank == p % CL_C && warp == 0) {
      float* blk = rows + blk_off(rank, p / CL_C);
      const int rl = row_len(p);
      // Lane r holds row k0 + r of the diagonal block (identity past kb).
      float a[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c)
        a[c] = (lane < kb && c <= lane) ? blk[lane * rl + k0 + c] : (c == lane ? 1.f : 0.f);
      bool bad = false;
      float il_own = 1.f;
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        const float piv = __shfl_sync(FULL, a[c], c);
        bad |= !(piv > 0.f);
        const float il = rsqrtf(piv);
        a[c] = lane == c ? piv * il : (lane > c ? a[c] * il : a[c]);
        il_own = lane == c ? il : il_own;
        float lc[PW];
#pragma unroll
        for (int c2 = c + 1; c2 < PW; ++c2) lc[c2] = __shfl_sync(FULL, a[c], c2);
#pragma unroll
        for (int c2 = c + 1; c2 < PW; ++c2)
          if (lane >= c2) a[c2] -= a[c] * lc[c2];
      }
      if (lane < PW) {
        if (lane < kb) {
          inv[k0 + lane] = il_own;
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if (c <= lane) blk[lane * rl + k0 + c] = a[c];
        }
        for (int q = 0; q < CL_C; ++q) {
          float* rdg = cluster.map_shared_rank(dg, q);
          cluster.map_shared_rank(dgi, q)[lane] = il_own;
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if (c <= lane) rdg[lane * DS + c] = a[c];
        }
      }
      if (bad && lane == 0) ctl[0] = 1;
    }
    cluster.sync();
    // Own rows below: l_i = a_i L_kk^-T, one thread a row, written back and
    // into every CTA's staged panel.
    for (int t = tid;; t += CL_NT) {
      const int l = l0 + t / RB, q = t % RB;
      if (l >= own) break;
      const int r = rank + l * CL_C, i = RB * r + q;
      if (i < b0 || i >= N) continue;
      float* row = rows + blk_off(rank, l) + (size_t)q * row_len(r);
      float x[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) x[c] = c < kb ? row[k0 + c] : 0.f;
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        float v = x[c];
#pragma unroll
        for (int c2 = 0; c2 < c; ++c2) v -= x[c2] * dg[c * DS + c2];
        x[c] = v * dgi[c];
      }
#pragma unroll
      for (int c = 0; c < PW; ++c)
        if (c < kb) row[k0 + c] = x[c];
      const float4 x4[4] = {make_float4(x[0], x[1], x[2], x[3]), make_float4(x[4], x[5], x[6], x[7]),
                            make_float4(x[8], x[9], x[10], x[11]),
                            make_float4(x[12], x[13], x[14], x[15])};
      if (G) {
#pragma unroll
        for (int m = 0; m < 4; ++m) reinterpret_cast<float4*>(pan + (size_t)i * PS)[m] = x4[m];
      } else {
        for (int dst = 0; dst < CL_C; ++dst) {
          float4* rp = reinterpret_cast<float4*>(cluster.map_shared_rank(pan, dst) + i * PS);
#pragma unroll
          for (int m = 0; m < 4; ++m) rp[m] = x4[m];
        }
      }
    }
    cluster.sync();
    // Trailing update of own rows i >= b0, columns b0..i: tile t belongs to
    // the row tile k whose running sum first exceeds t.
    const int n_tiles = ctl[1];
    for (int t = tid; t < n_tiles; t += CL_NT) {
      int lo = 0, hi = K - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (rt_end[mid] > t) hi = mid; else lo = mid + 1;
      }
      const int k = lo, u = t - (k ? rt_end[k - 1] : 0);
      const int l = l0 + k / 4, r = rank + l * CL_C, q0 = 4 * (k % 4);
      const int i0 = RB * r + q0, j0 = b0 + 4 * u, rl = row_len(r);
      float* blk = rows + blk_off(rank, l);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + a, j = j0 + b;
          acc[a][b] = (i >= b0 && i < N && j <= i) ? blk[(q0 + a) * rl + j] : 0.f;
        }
#pragma unroll
      for (int c = 0; c < PW; c += 4) {
        float4 ri[4], cj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ri[a] = *reinterpret_cast<const float4*>(&pan[(size_t)(i0 + a) * PS + c]);
          cj[a] = *reinterpret_cast<const float4*>(&pan[(size_t)(j0 + a) * PS + c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a][b] -= ri[a].x * cj[b].x + ri[a].y * cj[b].y + ri[a].z * cj[b].z +
                         ri[a].w * cj[b].w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + a, j = j0 + b;
          if (i >= b0 && i < N && j <= i) blk[(q0 + a) * rl + j] = acc[a][b];
        }
    }
    __syncthreads();
  }

  // Back substitution L^T x = y, y = row n (on its owner), a panel at a time
  // from the end, on the panel's owner.
  if (ctl[0] && tid == 0) *cluster.map_shared_rank(ctl, 0) = 1;
  const int bn = n / RB, qn = bn % CL_C;
  const size_t yoff = blk_off(qn, bn / CL_C) + (size_t)(n % RB) * row_len(bn);
  const float* y =
      G ? gscratch + (size_t)qn * rows_max + yoff : cluster.map_shared_rank(rows + yoff, qn);
  for (int p = npan - 1; p >= 0; --p) {
    const int k0 = p * PW, kb = min(PW, n - k0);
    if (rank == p % CL_C) {
      const float* blk = rows + blk_off(rank, p / CL_C);
      const int rl = row_len(p);
      if (warp == 0) {
        float l[PW];  // lane r: L[k0 + c][k0 + r] for c > r
#pragma unroll
        for (int c = 0; c < PW; ++c) l[c] = (c < kb && lane < c) ? blk[c * rl + k0 + lane] : 0.f;
        float v = 0.f;
        if (lane < kb) {
          v = y[k0 + lane];
          for (int q = 0; q < CL_C; ++q) v -= cluster.map_shared_rank(con, q)[k0 + lane];
        }
        const float il = lane < kb ? inv[k0 + lane] : 0.f;
        float x = 0.f;
#pragma unroll
        for (int c = PW - 1; c >= 0; --c) {
          const float xc = __shfl_sync(FULL, v * il, c);
          x = lane == c ? xc : x;
          v -= l[c] * xc;
        }
        if (lane < kb) {
          xs[k0 + lane] = x;
          cluster.map_shared_rank(xs, 0)[k0 + lane] = x;
        }
      }
      __syncthreads();
      for (int i = tid; i < k0; i += CL_NT) {
        float v = con[i];
#pragma unroll
        for (int c = 0; c < PW; ++c)
          if (c < kb) v += blk[c * rl + i] * xs[k0 + c];
        con[i] = v;
      }
    }
    cluster.sync();
  }
  if (rank != 0) return;

  // Rank 0: as the one-CTA kernel's end.
  for (int i = tid; i < n; i += CL_NT)
    if (fr[i] != 0.f && !isfinite(xs[i])) ctl[0] = 1;
  __syncthreads();
  const bool failed = ctl[0] != 0;
  for (int i = tid; i < n; i += CL_NT)
    delta[i] = failed ? __int_as_float(0x7fc00000)
                      : (fr[i] != 0.f ? xs[i] * rds[i] * fr[i] : 0.f);
  __syncthreads();
  const CamHalves h = cam_halves(state, rot_a, rot_b, camp_a, camp_b);
  for (int v = tid; v < V; v += CL_NT)
    retract_camera(quat, delta + 6 * v, h.rot + 4 * v, h.camp + 8 * v, h.rot_c + 4 * v,
                   h.camp_c + 8 * v);
}

template <bool G>
__global__ void __launch_bounds__(CL_NT) camera_solve_cluster_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    int V, size_t rows_max, float* gscratch, float* __restrict__ delta) {
  extern __shared__ __align__(16) float cl_smem[];
  camera_solve_cluster<G, true>(quat, S, dU, rhs, free, state, rot_a, rot_b, camp_a, camp_b, V,
                                rows_max, gscratch, delta, cl_smem, threadIdx.x);
}

// The grid route, for any n: the same Cholesky of the bordered matrix as a
// blocked right-looking factorization whose matrix lives in a global
// scratch, spread over the whole card. Three launches a solve: grid_init
// builds the damped, pinned, Jacobi-scaled system from S; grid_solve, one
// cooperative launch of a persistent grid (one 512-thread CTA an SM),
// factors it and substitutes back, with grid.sync() between its stages;
// grid_finish forms delta and retracts the cameras. lm_fused runs the same
// three (grid_init_tile, grid_solve_all, grid_finish_cta) as its camera
// solve stage, on its own CTAs. Panels are GB = 128 columns wide. For panel
// p, with its diagonal block's factor L_pp already inverted in the scratch
// (Linv_p):
//   trsm: the rows below, l_i = a_i L_pp^-T = a_i Linv_p^T, a product of
//     128-row blocks by Linv_p, one block a CTA;
//   update: the rank-128 update of the trailing lower triangle, one 128 x
//     128 output tile (on or below the diagonal) a CTA. CTA 0 takes tile
//     (0, 0), which is panel p + 1's diagonal block, first, and then factors
//     it and forms its inverse (look-ahead) while the other CTAs take the
//     other tiles: the block is factored once, not by every CTA.
// Both products run on the tensor cores in 3xTF32 (wgmma m64n64k8, four
// warpgroups a 128 x 128 tile: each f32 operand split into a TF32 high
// part, rounded to nearest, and its remainder, hi*hi + hi*lo + lo*hi summed
// in f32; see tile_product), which keeps the f32 accuracy that one TF32
// pass (three decimal digits) loses. The update sums the panel's 128
// products and then subtracts once: a subtraction a product rounds the
// entry n times, and left the solve ~10x further from an f64 one than the
// plain LU at n = 6600.
// The diagonal block (one CTA, in shared memory; grid_diag): 16-column
// sub-panels, one warp factoring each one's triangle while the other warps
// finish the previous sub-panel's update; then the factor's inverse, its
// block columns side by side.
// The bordered last row (b^T) is a row below every panel, so it ends as
// y = L^-1 b. The back substitution L^T x = y then runs panel by panel from
// the last: every CTA forms x_p = Linv_p^T y_p (the same bits in each) and
// takes the panel's x out of its own chunk of y above it, one grid barrier a
// panel. No float atomics: two solves give the same bits. Every launch
// returns at once on state[DONE]; a pivot that is not positive sets a flag
// in the scratch and grid_finish makes all of delta NaN, as the other
// routes do. Barriers a solve: 3 ceil(n / 128) (282 at n = 12000).
// Bound: n^3 / 6 FMA for the factorization; on the tensor cores in 3xTF32
// that is 3 n^3 / 6 FMA at 495 TFLOP/s (3.49 ms at n = 12000); the trailing
// update reads and writes each lower element once a panel, 4 n^3 / (3 *
// 128) bytes in all (5.37 ms at n = 12000 at the HBM rate, the larger).
// What holds it above that (PERF.md): a 128 x 128 x 128 tile takes
// ~10 us where its products alone would take ~3, its chunks' loads, its
// tensor-core steps and their waits running one after the other in each
// CTA, with 128 registers a thread at 512 threads (every attempt to keep
// more in flight spilled and ran slower); and at small n each panel waits
// on its diagonal block, ~30 us on one CTA.

constexpr int GB = 128;        // panel width of the grid route, and its tiles' edge
constexpr int GDS = GB + 1;    // row stride of the diagonal block in shared memory
constexpr int GLV = GB + 4;    // row stride of its inverse (16-byte rows)
constexpr int G_NT = 256;      // threads of grid_init
constexpr int GS_NT = 512;     // threads of grid_solve (one CTA an SM)
constexpr int GKC = 32;        // columns of a chunk of a tile product's operands (128 bytes)
constexpr int GCS = GB + 4;    // row stride of an update tile's entries in shared memory
constexpr int GSUB = GB / PW;  // sub-panels of the diagonal block
constexpr int GI_T = 64;       // edge of grid_init's tiles
constexpr int GF_NT = 1024;    // threads of grid_finish
// grid_solve's dynamic shared memory, in floats: the larger of a tile
// product's two buffers of split operands with an update tile's entries,
// and the diagonal block's factor, its inverse and their temporaries
constexpr int G_PROD_FLOATS = 2 * 4 * GB * GKC + GB * GCS;
constexpr int G_DIAG_FLOATS = GB * GDS + GB * GLV + GB + GSUB * PW * PW + 4;
constexpr size_t G_SMEM =  // and 1 KB to align the start to the operands' 1024-byte atoms
    sizeof(float) * (G_PROD_FLOATS > G_DIAG_FLOATS ? G_PROD_FLOATS : G_DIAG_FLOATS) + 1024;

// The grid route's scratch (offsets in floats): the failure flag (an int),
// x, the panels' inverted diagonal factors (GB x GB each, lower, the
// identity past the matrix), then the bordered matrix A (N rows of lda
// floats; only its lower triangle is used).
struct GridLayout {
  size_t x, linv, a, total;
  int lda, npan;
};

__host__ __device__ __forceinline__ GridLayout grid_layout(int V) {
  const int n = 6 * V;
  GridLayout g;
  g.lda = round4(n + 1);
  g.npan = (n + GB - 1) / GB;
  g.x = 4;
  g.linv = g.x + round4(n);
  g.a = g.linv + (size_t)g.npan * GB * GB;
  g.total = g.a + (size_t)(n + 1) * g.lda;
  return g;
}

// 1 / the Jacobi scale of unknown i of the damped, pinned system.
__device__ __forceinline__ float jacobi_rd(const float* S, const float* dU, const float* free,
                                           float lam, int n, int i) {
  const float f = free[i], damp = lam * fmaxf(dU[i], 1e-8f);
  return 1.f / sqrtf(fmaxf(fabsf((S[(size_t)i * n + i] + damp) * f * f + (1.f - f)), 1e-12f));
}

// The lower triangle of the bordered matrix (row n: b^T) from S at damping
// lam, tile (bi, bj), bj <= bi, of the 64 x 64 tiles on or below the
// diagonal (the upper part of a diagonal tile: zeros), by the `nt` threads
// of one CTA (tid 0 .. nt - 1); `sh`: 5 GI_T floats of its shared memory,
// free on return. Each entry is one thread's, whatever nt is; tile (0, 0)
// clears the failure flag.
__device__ __forceinline__ void grid_init_tile(const float* S, const float* dU, const float* rhs,
                                               const float* free, float lam, int n,
                                               float* scratch, int bi, int bj, float* sh,
                                               int tid, int nt) {
  const GridLayout g = grid_layout(n / 6);
  float* A = scratch + g.a;
  const int N = n + 1;
  float *rd_r = sh, *f_r = sh + GI_T, *d_r = sh + 2 * GI_T, *rd_c = sh + 3 * GI_T,
        *f_c = sh + 4 * GI_T;
  if (bi == 0 && tid == 0) reinterpret_cast<int*>(scratch)[0] = 0;
  if (tid < GI_T) {
    const int i = bi * GI_T + tid;
    if (i < n) {
      f_r[tid] = free[i];
      d_r[tid] = lam * fmaxf(dU[i], 1e-8f);
      rd_r[tid] = jacobi_rd(S, dU, free, lam, n, i);
    }
  } else if (tid < 2 * GI_T) {
    const int c = tid - GI_T, j = bj * GI_T + c;
    if (j < n) {
      f_c[c] = free[j];
      rd_c[c] = jacobi_rd(S, dU, free, lam, n, j);
    }
  }
  __syncthreads();
  for (int e = tid; e < GI_T * GI_T; e += nt) {
    const int r = e / GI_T, c = e % GI_T, i = bi * GI_T + r, j = bj * GI_T + c;
    if (i >= N || j >= N) continue;
    float a = 0.f;
    if (j <= i) {
      if (i < n) {
        const float v = S[(size_t)i * n + j];
        a = ((i == j ? v + d_r[r] : v) * f_r[r] * f_c[c] + (i == j ? 1.f - f_r[r] : 0.f)) *
            rd_r[r] * rd_c[c];
      } else if (j < n) {
        a = rhs[j] * f_c[c] * rd_c[c];
      }
    }
    A[(size_t)i * g.lda + j] = a;
  }
}

__global__ void __launch_bounds__(G_NT) grid_init_kernel(
    const float* __restrict__ S, const float* __restrict__ dU, const float* __restrict__ rhs,
    const float* __restrict__ free, const float* __restrict__ state, int n,
    float* __restrict__ scratch) {
  if (state[DONE] != 0.f) return;
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  __shared__ float sh[5 * GI_T];
  grid_init_tile(S, dU, rhs, free, state[LAM], n, scratch, bi, bj, sh, threadIdx.x, G_NT);
}

// A 16-byte copy into shared memory of the first `bytes` bytes at src (the
// rest zero-filled; src is read only where bytes > 0), cached in L2 only
// and marked first to leave it: the trailing matrix's tiles are read once
// a panel (4 n^3 / (3 GB) bytes in all) and would push the panel's rows,
// which every tile reads, out of the 50 MB L2.
__device__ __forceinline__ void cp_async16_evict_first(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
               "l"(src), "r"(bytes), "l"(policy));
}

// x as a TF32 high part, rounded to nearest (ties away, as cvt.rna.tf32.f32,
// by two integer operations, which issue at a higher rate than the
// conversion), and the remainder, exact in f32, which the tensor cores read
// as TF32 by dropping its low 13 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The accumulators of a 128 x 128 tile a CTA, on the tensor cores' warpgroup
// layout: warpgroup wg (four warps) holds rows 64 (wg >> 1) .. + 64 and
// columns 64 (wg & 1) .. + 64 as one m64n64 wgmma accumulator; element
// [mi][ni][2h + e] of a thread is row 64 (wg >> 1) + 16 (warp % 4) +
// lane / 4 + 8 h, column 64 (wg & 1) + 32 mi + 8 ni + 2 (lane % 4) + e.
struct TileAcc {
  float c[2][4][4];
};

// The matrix descriptor of a K-major tile of 32-bit elements in shared
// memory with the 128-byte swizzle: rows of 128 bytes (32 elements), eight
// rows a 1024-byte atom, 16-byte chunk c of row r stored at chunk c ^ (r % 8).
__device__ __forceinline__ unsigned long long wg_desc(const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (unsigned long long)((a & 0x3ffff) >> 4) | (1ull << 16) |
         ((unsigned long long)(1024 >> 4) << 32) | (1ull << 62);
}

// d = A B^T (+ d where acc) for this warpgroup's 64 x 64 tile, k 8 deep, A
// and B from shared memory by their descriptors (TF32: the low 13 bits of
// each element are dropped).
template <int acc>
__device__ __forceinline__ void wgmma_tf32(float (&d)[2][4][4], unsigned long long da,
                                           unsigned long long db) {
  float* x = &d[0][0][0];
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]), "+f"(x[6]),
        "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]), "+f"(x[11]), "+f"(x[12]), "+f"(x[13]),
        "+f"(x[14]), "+f"(x[15]), "+f"(x[16]), "+f"(x[17]), "+f"(x[18]), "+f"(x[19]),
        "+f"(x[20]), "+f"(x[21]), "+f"(x[22]), "+f"(x[23]), "+f"(x[24]), "+f"(x[25]),
        "+f"(x[26]), "+f"(x[27]), "+f"(x[28]), "+f"(x[29]), "+f"(x[30]), "+f"(x[31])
      : "l"(da), "l"(db), "r"(acc));
}

// acc = sum over k < kb of Ra[r][k] Rb[c][k] for the tile's rows r and
// columns c, in 3xTF32 on the tensor cores by wgmma: Ra's row r at
// ra + r * lda (zero from ra_rows), Rb's row c at rb + c * ldb (zero from
// rb_rows); columns past kb read as zeros. Each GKC-column chunk is loaded
// into registers (through L2, kept there as the panel's rows) while the
// tensor cores work on the chunk before it, split into its TF32 high parts
// (rounded to nearest) and remainders, and stored as four swizzled K-major
// tiles (A hi, A lo, B hi, B lo) in one of two buffers of `sm` (4 GB GKC
// floats each, 1024-byte aligned). The tensor cores round their sums toward zero,
// so a long chain of products summed in one accumulator drifts (48
// roundings a tile left the solve ~10x further from the f64 one than the
// plain LU): each 8-deep step's three products are summed on the tensor
// cores from zero and then added to acc in f32, rounded to nearest. Where
// cs is set, the call also copies the entries of the tile at c (rows of ldc
// floats, c_rows of them; columns c_cols) into cs (GB rows of GCS floats),
// evict-first, by cp.async while the product runs. Each call ends with a
// barrier, so the buffers are free after it.
__device__ __forceinline__ void tile_product(const float* ra, size_t lda, int ra_rows,
                                             const float* rb, size_t ldb, int rb_rows, int kb,
                                             float* sm, TileAcc& acc, const float* c = nullptr,
                                             size_t ldc = 0, int c_rows = 0, int c_cols = 0,
                                             float* cs = nullptr) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = 64 * (wg >> 1), n0 = 64 * (wg & 1);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[mi][ni][e] = 0.f;
  if (cs) {
#pragma unroll
    for (int u = 0; u < GB * (GB / 4) / GS_NT; ++u) {
      const int e = tid + u * GS_NT, r = e / (GB / 4), col = (e % (GB / 4)) * 4;
      const int valid = r < c_rows ? min(max(c_cols - col, 0), 4) : 0;
      cp_async16_evict_first(cs + r * GCS + col, valid ? c + (size_t)r * ldc + col : c,
                             4 * valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int nk = (kb + GKC - 1) / GKC;
  constexpr int UNITS = 2 * GB * (GKC / 4) / GS_NT;  // 16-byte units of a chunk a thread
  float4 v[UNITS];
  auto load = [&](int q) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int e = tid + u * GS_NT, which = e / (GB * (GKC / 4)), rem = e % (GB * (GKC / 4));
      const int r = rem / (GKC / 4), k = q * GKC + (rem % (GKC / 4)) * 4;
      const float* src = (which ? rb + (size_t)r * ldb : ra + (size_t)r * lda) + k;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < (which ? rb_rows : ra_rows)) {
        if (k + 3 < kb) {
          v[u] = __ldcg(reinterpret_cast<const float4*>(src));
        } else {
          v[u].x = k < kb ? __ldcg(src) : 0.f;
          v[u].y = k + 1 < kb ? __ldcg(src + 1) : 0.f;
          v[u].z = k + 2 < kb ? __ldcg(src + 2) : 0.f;
        }
      }
    }
  };
  auto store = [&](int buf) {
    float* base = sm + buf * (4 * GB * GKC);
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int e = tid + u * GS_NT, which = e / (GB * (GKC / 4)), rem = e % (GB * (GKC / 4));
      const int r = rem / (GKC / 4), c16 = rem % (GKC / 4);
      const int off = r * GKC + ((c16 ^ (r & 7)) << 2);
      float* hi = base + which * 2 * GB * GKC;
      const float xs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned hb, lb;
        split_tf32(xs[j], hb, lb);
        h[j] = __uint_as_float(hb);
        l[j] = __uint_as_float(lb);
      }
      *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(hi + GB * GKC + off) = make_float4(l[0], l[1], l[2], l[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  load(0);
  store(0);
  __syncthreads();
  for (int q = 0; q < nk; ++q) {
    if (q + 1 < nk) load(q + 1);
    const float* base = sm + (q & 1) * (4 * GB * GKC);
    const float* ah = base + m0 * GKC;
    const float* al = ah + GB * GKC;
    const float* bh = base + 2 * GB * GKC + n0 * GKC;
    const float* bl = bh + GB * GKC;
#pragma unroll
    for (int kk = 0; kk < GKC; kk += 8) {
      float s[2][4][4];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_tf32<0>(s, wg_desc(al + kk), wg_desc(bh + kk));
      wgmma_tf32<1>(s, wg_desc(ah + kk), wg_desc(bl + kk));
      wgmma_tf32<1>(s, wg_desc(ah + kk), wg_desc(bh + kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc.c[mi][ni][e] += s[mi][ni][e];
    }
    if (q + 1 < nk) store((q + 1) & 1);
    __syncthreads();
  }
  if (cs) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
}

// grid_solve's stamps, in the timing build only (-DOSFM_FUSED_TIMING;
// scripts/torch_k3_routes.py --split): where that library was given a
// buffer (osfm_grid_solve_stamps), CTA 0 appends (kind, %globaltimer) after
// each grid barrier: 0 the first diagonal block, 1 a panel's row solve, 2
// its update, 3 a panel of the back substitution; and inside the first
// diagonal block, 4 after its first sub-panel and 5 after the rest of its
// factor and inverse. In the main path's build it compiles to nothing.
#ifdef OSFM_FUSED_TIMING
__device__ unsigned long long* grid_stamps;  // null: none
#endif
__device__ __forceinline__ void grid_stamp(int kind) {
#ifdef OSFM_FUSED_TIMING
  unsigned long long* stamps = grid_stamps;
  if (!stamps || blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long k = stamps[0];
  stamps[1 + 2 * k] = (unsigned long long)kind;
  stamps[2 + 2 * k] = t;
  stamps[0] = k + 1;
#endif
}

// The diagonal block's update by the 16 columns q0 .. q0 + 15 of its factor:
// D[i][j] -= sum_c D[i][q0 + c] D[j][q0 + c] for j0 <= j < j1, j <= i < GB,
// in 4 x 4 blocks of entries, one a thread of the `nt` threads (this one
// `o`): each block's 16 sums from eight loads a column.
__device__ __forceinline__ void diag_block_update(float* D, int q0, int j0, int j1, int o,
                                                  int nt) {
  const int mi = (GB - j0) / 4, mj = (j1 - j0) / 4;
  for (int e = o; e < mi * mj; e += nt) {
    const int a = e / mj, bj = e % mj, i = j0 + 4 * a, j = j0 + 4 * bj;
    if (j > i + 3) continue;
    float v[4][4] = {};
#pragma unroll
    for (int c = 0; c < PW; ++c) {
      float x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = D[(i + u) * GDS + q0 + c];
        y[u] = D[(j + u) * GDS + q0 + c];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) v[u][w] = fmaf(x[u], y[w], v[u][w]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (j + w <= i + u) D[(i + u) * GDS + j + w] -= v[u][w];
  }
}

// Panel p's diagonal block, by one CTA: its Cholesky factor L in shared
// memory (the identity past the matrix), then L's inverse, written to the
// scratch as Linv_p; a pivot that is not positive sets the scratch's flag.
// The factor: right-looking over 16-column sub-panels; warp 0 factors
// sub-panel q's triangle in registers while the other warps finish the rest
// of sub-panel q - 1's trailing update (the columns past the strip that
// sub-panel q needs first), then all threads solve the rows below sub-panel
// q by substitution and update that strip. Each update sums a sub-panel's
// 16 products and then subtracts once. The inverse: each 16 x 16 diagonal
// block's (thread c of its 16 solving for column c), then each block column
// j of L^-1 by two warps of its own, block row by block row down from the
// diagonal, X_i = -Linv_ii sum_{k = j .. i-1} L_ik X_k (the block columns
// are independent). `sm`: G_DIAG_FLOATS floats, free on return. A function
// of its own (not inlined): its registers are allocated apart from the tile
// products', and neither grid_solve nor lm_fused's call of it spills (ptxas
// -v on sm_90a; inlined, grid_solve spilled 56 bytes a thread), which took
// 3.7-4.7% off grid_solve at 120-375 views (scripts/torch_k3_routes.py
// --grid-variants, PERF.md).
__device__ __noinline__ void grid_diag(float* __restrict__ scratch, GridLayout g, int n, int p,
                                       float* sm) {
  const float* A = scratch + g.a;
  const int k0 = p * GB, kb = min(GB, n - k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* D = sm;                    // [GB][GDS]: the block, then its factor
  float* Lv = D + GB * GDS;         // [GB][GLV]: the factor's inverse (lower triangle)
  float* dinv = Lv + GB * GLV;      // [GB]: 1 / the factor's diagonal
  float* T = dinv + GB;             // [GSUB][PW * PW]: each block column's sums
  int* bad = reinterpret_cast<int*>(T + GSUB * PW * PW);
  if (tid == 0) *bad = 0;
  for (int e0 = 0; e0 < GB * GB; e0 += 8 * GS_NT) {  // eight loads in flight a thread
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * GS_NT + tid, r = e / GB, c = e % GB;
      v[u] = (r < kb && c < kb)
                 ? (c <= r ? __ldcg(A + (size_t)(k0 + r) * g.lda + k0 + c) : 0.f)
                 : (r == c ? 1.f : 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * GS_NT + tid;
      D[(e / GB) * GDS + e % GB] = v[u];
    }
  }
  __syncthreads();
  for (int sp = 0; sp <= GSUB; ++sp) {
    const int s = sp * PW;
    if (warp == 0) {
      if (sp < GSUB) {
        // lane r holds row s + r of the sub-panel's triangle (the identity past PW)
        float a[PW];
#pragma unroll
        for (int c = 0; c < PW; ++c)
          a[c] = (lane < PW && c <= lane) ? D[(s + lane) * GDS + s + c] : (c == lane ? 1.f : 0.f);
        bool bd = false;
        float il_own = 1.f;
#pragma unroll
        for (int c = 0; c < PW; ++c) {
          const float piv = __shfl_sync(FULL, a[c], c);
          bd |= !(piv > 0.f);
          const float il = rsqrtf(piv);
          a[c] = lane == c ? piv * il : (lane > c ? a[c] * il : a[c]);
          il_own = lane == c ? il : il_own;
          float lc[PW];
#pragma unroll
          for (int c2 = c + 1; c2 < PW; ++c2) lc[c2] = __shfl_sync(FULL, a[c], c2);
#pragma unroll
          for (int c2 = c + 1; c2 < PW; ++c2)
            if (lane >= c2) a[c2] -= a[c] * lc[c2];
        }
        if (lane < PW) {
          dinv[s + lane] = il_own;
#pragma unroll
          for (int c = 0; c < PW; ++c)
            if (c <= lane) D[(s + lane) * GDS + s + c] = a[c];
        }
        if (bd && lane == 0) *bad = 1;
      }
    } else if (sp > 0 && s + PW < GB) {  // the rest of sub-panel sp - 1's update
      diag_block_update(D, s - PW, s + PW, GB, tid - 32, GS_NT - 32);
    }
    __syncthreads();
    if (sp == GSUB) break;
    // the block's rows below the sub-panel by substitution, one thread a row
    for (int i = s + PW + tid; i < GB; i += GS_NT) {
      float x[PW];
#pragma unroll
      for (int c = 0; c < PW; ++c) x[c] = D[i * GDS + s + c];
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        float v = 0.f;
#pragma unroll
        for (int c2 = 0; c2 < c; ++c2) v = fmaf(x[c2], D[(s + c) * GDS + s + c2], v);
        x[c] = (x[c] - v) * dinv[s + c];
      }
#pragma unroll
      for (int c = 0; c < PW; ++c) D[i * GDS + s + c] = x[c];
    }
    __syncthreads();
    // the strip the next sub-panel needs first: s + PW <= j < s + 2 PW, j <= i
    if (s + PW < GB) diag_block_update(D, s, s + PW, s + 2 * PW, tid, GS_NT);
    __syncthreads();
    if (p == 0 && sp == 0) grid_stamp(4);
  }
  // Linv_jj, block j = tid / 16, column c = tid % 16:
  // x_r = (e_c - sum_{k<r} L_rk x_k) / L_rr
  if (tid < GB) {
    const int j0 = tid & ~(PW - 1), c = tid & (PW - 1);
    float x[PW];
#pragma unroll
    for (int r = 0; r < PW; ++r) {
      float v = r == c ? 1.f : 0.f;
#pragma unroll
      for (int k = 0; k < r; ++k) v -= D[(j0 + r) * GDS + j0 + k] * x[k];
      x[r] = v * dinv[j0 + r];
    }
#pragma unroll
    for (int r = 0; r < PW; ++r) Lv[(j0 + r) * GLV + j0 + c] = c <= r ? x[r] : 0.f;
  }
  __syncthreads();
  {  // block column j by warps 2j and 2j + 1; thread o a row r and four columns
    const int j = warp >> 1, o = tid & 63, r = o >> 2, c4 = 4 * (o & 3), j0 = j * PW;
    float* Tj = T + j * PW * PW;
    for (int i = j + 1; i < GSUB; ++i) {
      const int i0 = i * PW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = j0; k < i0; ++k) {
        const float l = D[(i0 + r) * GDS + k];
        const float4 x = *reinterpret_cast<const float4*>(Lv + k * GLV + j0 + c4);
        v[0] = fmaf(l, x.x, v[0]);
        v[1] = fmaf(l, x.y, v[1]);
        v[2] = fmaf(l, x.z, v[2]);
        v[3] = fmaf(l, x.w, v[3]);
      }
      *reinterpret_cast<float4*>(Tj + r * PW + c4) = make_float4(v[0], v[1], v[2], v[3]);
      asm volatile("bar.sync %0, 64;" ::"r"(1 + j) : "memory");
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < PW; ++t) {
        const float l = Lv[(i0 + r) * GLV + i0 + t];
        const float4 x = *reinterpret_cast<const float4*>(Tj + t * PW + c4);
        w[0] = fmaf(l, x.x, w[0]);
        w[1] = fmaf(l, x.y, w[1]);
        w[2] = fmaf(l, x.z, w[2]);
        w[3] = fmaf(l, x.w, w[3]);
      }
      *reinterpret_cast<float4*>(Lv + (i0 + r) * GLV + j0 + c4) =
          make_float4(-w[0], -w[1], -w[2], -w[3]);
      asm volatile("bar.sync %0, 64;" ::"r"(1 + j) : "memory");
    }
  }
  __syncthreads();
  if (p == 0) grid_stamp(5);
  float* L = scratch + g.linv + (size_t)p * GB * GB;
  for (int e = tid; e < GB * GB; e += GS_NT) {
    const int r = e / GB, c = e % GB;
    L[e] = c <= r ? Lv[r * GLV + c] : 0.f;
  }
  if (tid == 0 && *bad) reinterpret_cast<int*>(scratch)[0] = 1;
  __syncthreads();
}

// The first 1024-byte boundary at or past p in shared memory (the tile
// product's operand atoms): G_SMEM keeps 1 KB for it.
__device__ __forceinline__ float* align1024(float* p) {
  return p + ((1024 - ((unsigned)__cvta_generic_to_shared(p) & 1023)) & 1023) / 4;
}

// The factorization and the back substitution by every CTA of a cooperative
// grid of GS_NT-thread CTAs (grid_solve's launch, or lm_fused's, whose CTAs
// have as many threads), gsm: G_SMEM - 1024 bytes of each CTA's shared
// memory at a 1024-byte boundary. Which CTA takes which tile or row chunk
// does not change what any entry computes, so the bits do not depend on the
// grid's size. Ends at a grid barrier, x complete in the scratch.
__device__ __forceinline__ void grid_solve_all(int n, float* scratch, float* gsm,
                                               cg::grid_group& grid) {
  const GridLayout g = grid_layout(n / 6);
  float* A = scratch + g.a;
  const int N = n + 1, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  // this thread's accumulator rows and columns (TileAcc): row wr + 8 h,
  // column wc + 32 mi + 8 ni
  const int wr = 64 * (warp >> 3) + 16 * (warp & 3) + (lane >> 2);
  const int wc = 64 * ((warp >> 2) & 1) + 2 * (lane & 3);
  grid_stamp(0);
  if (b == 0) grid_diag(scratch, g, n, 0, gsm);
  grid.sync();
  grid_stamp(0);
  TileAcc acc;
  for (int p = 0; p < g.npan; ++p) {
    const int k0 = p * GB, kb = min(GB, n - k0), b0 = k0 + kb;
    const float* Linv = scratch + g.linv + (size_t)p * GB * GB;
    for (int it = b; it < (N - b0 + GB - 1) / GB; it += G) {  // the rows below, 128 a block
      const int r0 = b0 + it * GB;
      tile_product(A + (size_t)r0 * g.lda + k0, g.lda, min(GB, N - r0), Linv, GB, kb, kb, gsm,
                   acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = r0 + wr + 8 * h;
          if (i >= N) continue;
          float* row = A + (size_t)i * g.lda + k0;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int c = wc + 32 * mi + 8 * ni;
            if (c + 1 < kb) {
              *reinterpret_cast<float2*>(row + c) =
                  make_float2(acc.c[mi][ni][2 * h], acc.c[mi][ni][2 * h + 1]);
            } else if (c < kb) {
              row[c] = acc.c[mi][ni][2 * h];
            }
          }
        }
    }
    grid.sync();
    grid_stamp(1);
    if (b0 >= n) break;  // the last panel leaves only A[n][n], which nothing reads
    // The trailing update: tile t = (ti, tj), tj <= ti, of the 128-aligned
    // grid from b0; tile 0 (panel p + 1's diagonal block) by CTA 0, which
    // then factors it, the others over the other CTAs (with one CTA, all
    // of them, the diagonal block after tile 0).
    const int nt = (N - b0 + GB - 1) / GB, tiles = nt * (nt + 1) / 2;
    for (int tt = b; tt < tiles; tt += G == 1 ? 1 : (b == 0 ? tiles : G - 1)) {
      int ti = (int)((sqrtf(8.f * tt + 1.f) - 1.f) * 0.5f);  // from an approximate root, then exact
      while (ti * (ti + 1) / 2 > tt) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= tt) ++ti;
      const int tj = tt - ti * (ti + 1) / 2, r0 = b0 + ti * GB, c0 = b0 + tj * GB;
      float* cs = gsm + 2 * 4 * GB * GKC;  // the tile's entries, copied during the product
      tile_product(A + (size_t)r0 * g.lda + k0, g.lda, min(GB, N - r0),
                   A + (size_t)c0 * g.lda + k0, g.lda, min(GB, N - c0), GB, gsm, acc,
                   A + (size_t)r0 * g.lda + c0, g.lda, min(GB, N - r0), N - c0, cs);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int il = wr + 8 * h, i = r0 + il;
          if (i >= N) continue;
          float* row = A + (size_t)i * g.lda;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int jl = wc + 32 * mi + 8 * ni, j = c0 + jl;
            const float2 v = *reinterpret_cast<const float2*>(cs + il * GCS + jl);
            if (j + 1 <= i) {  // evict-first: read again only at the next panel
              __stcs(reinterpret_cast<float2*>(row + j),
                     make_float2(v.x - acc.c[mi][ni][2 * h], v.y - acc.c[mi][ni][2 * h + 1]));
            } else if (j <= i) {
              __stcs(row + j, v.x - acc.c[mi][ni][2 * h]);
            }
          }
        }
      __syncthreads();  // cs is read; the next tile copies into it
      if (tt == 0) {
        __syncthreads();  // the block's new entries, before the look-ahead reads them
        grid_diag(scratch, g, n, p + 1, gsm);
      }
    }
    grid.sync();
    grid_stamp(2);
  }
  // The back substitution, panel p from the last: x_p = Linv_p^T y_p (four
  // partial sums over 32 rows each, added in order: the same bits in every
  // CTA), then y_j -= sum_c L[k0 + c][j] x_c for this CTA's j < k0.
  float* y = A + (size_t)n * g.lda;
  float* ys = gsm;                    // y_p
  float* xh = gsm + GB;               // the four partial sums of x_p
  float* xs = gsm + (1 + GS_NT / GB) * GB;  // x_p
  for (int p = g.npan - 1; p >= 0; --p) {
    const int k0 = p * GB, kb = min(GB, n - k0);
    const float* Linv = scratch + g.linv + (size_t)p * GB * GB;
    if (tid < GB) ys[tid] = tid < kb ? __ldcg(y + k0 + tid) : 0.f;
    __syncthreads();
    {
      const int c = tid % GB, part = tid / GB, r0 = part * (GB * GB / GS_NT);
      float a[GB * GB / GS_NT], v = 0.f;  // every load in flight, then the sum in order
#pragma unroll
      for (int u = 0; u < GB * GB / GS_NT; ++u) a[u] = __ldcg(Linv + (size_t)(r0 + u) * GB + c);
#pragma unroll
      for (int u = 0; u < GB * GB / GS_NT; ++u) v = fmaf(a[u], ys[r0 + u], v);
      xh[part * GB + c] = v;
    }
    __syncthreads();
    if (tid < GB) {
      float v = xh[tid];
#pragma unroll
      for (int q = 1; q < GS_NT / GB; ++q) v += xh[q * GB + tid];
      xs[tid] = v;
    }
    __syncthreads();
    if (b == 0 && tid < kb) scratch[g.x + k0 + tid] = xs[tid];
    for (int j = b * GS_NT + tid; j < k0; j += G * GS_NT) {
      float v = 0.f;
      int c = 0;
      for (; c + 32 <= kb; c += 32) {  // 32 loads in flight, then the sum in order
        float a[32];
#pragma unroll
        for (int u = 0; u < 32; ++u) a[u] = __ldcg(A + (size_t)(k0 + c + u) * g.lda + j);
#pragma unroll
        for (int u = 0; u < 32; ++u) v = fmaf(a[u], xs[c + u], v);
      }
      for (; c < kb; ++c) v = fmaf(__ldcg(A + (size_t)(k0 + c) * g.lda + j), xs[c], v);
      y[j] = __ldcg(y + j) - v;
    }
    grid.sync();
    grid_stamp(3);
  }
}

__global__ void __launch_bounds__(GS_NT, 1) grid_solve_kernel(const float* __restrict__ state,
                                                              int n, float* __restrict__ scratch) {
  if (state[DONE] != 0.f) return;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float gsm_raw[];
  grid_solve_all(n, scratch, align1024(gsm_raw), grid);
}

// delta from x (NaN throughout if a pivot was not positive or a free
// unknown came out non-finite) and the candidate cameras, by the `nt`
// threads of one CTA (tid 0 .. nt - 1), from the scalar state `state` (its
// lambda and current half); `failed`: an int of the CTA's shared memory.
// Each entry and camera is one thread's, whatever nt is.
__device__ __forceinline__ void grid_finish_cta(int quat, const float* S, const float* dU,
                                                const float* free, const float* state,
                                                float* rot_a, float* rot_b, float* camp_a,
                                                float* camp_b, int V, const float* scratch,
                                                float* delta, int& failed, int tid, int nt) {
  const int n = 6 * V;
  const GridLayout g = grid_layout(V);
  const float* x = scratch + g.x;
  const float lam = state[LAM];
  if (tid == 0) failed = reinterpret_cast<const int*>(scratch)[0];
  __syncthreads();
  for (int i = tid; i < n; i += nt)
    if (free[i] != 0.f && !isfinite(x[i])) failed = 1;
  __syncthreads();
  const bool fail = failed != 0;
  for (int i = tid; i < n; i += nt)
    delta[i] = fail ? __int_as_float(0x7fc00000)
                    : (free[i] != 0.f ? x[i] * jacobi_rd(S, dU, free, lam, n, i) * free[i] : 0.f);
  __syncthreads();
  const CamHalves h = cam_halves(state, rot_a, rot_b, camp_a, camp_b);
  for (int v = tid; v < V; v += nt)
    retract_camera(quat, delta + 6 * v, h.rot + 4 * v, h.camp + 8 * v, h.rot_c + 4 * v,
                   h.camp_c + 8 * v);
}

__global__ void __launch_bounds__(GF_NT) grid_finish_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ free, const float* __restrict__ state, float* rot_a, float* rot_b,
    float* camp_a, float* camp_b, int V, const float* __restrict__ scratch,
    float* __restrict__ delta) {
  if (state[DONE] != 0.f) return;
  __shared__ int failed;
  grid_finish_cta(quat, S, dU, free, state, rot_a, rot_b, camp_a, camp_b, V, scratch, delta,
                  failed, threadIdx.x, GF_NT);
}

// The camera solve's routes. Its automatic choice: one warp up to
// WARP_SOLVE_V views; the grid route from GRID_MIN_V; between them the
// one-CTA kernel where its whole matrix fits shared memory (a little kept
// for static shared memory), else the cluster, its rows and panel in shared
// memory where they fit, else in the global scratch (G). The cluster serves
// up to CL_MAX_V views (64 row blocks a CTA), the grid route any number.
enum Route { R_AUTO = -1, R_WARP = 0, R_CTA = 1, R_CLUSTER = 2, R_GRID = 3 };
constexpr int CL_MAX_V = 1365;
// GRID_MIN_V: where the grid route overtakes the cluster, for K3's own
// launches and for lm_fused's solve stage alike (fused_plan takes this
// rule, so the two keep their bit-for-bit parity). Cluster / grid ms a
// solve in their own launches (scripts/torch_k3_routes.py --fused, all in
// one run on an H100 80GB HBM3 at 700 W): 96 views 0.3458 / 0.3278, 104
// 0.4015 / 0.3378, 112 0.4608 / 0.3940, 119 0.5182 / 0.3957 (the library's
// Cholesky 0.2876 at 96 views); as lm_fused's solve stage (two copies of
// this source, each route at every size), the route "auto" runs up to 375
// views: 96 0.3747 / 0.4764, 104 0.4343 / 0.4824, 112 0.5038 / 0.5741, 119
// 0.5601 / 0.5812. Inside the launch the cluster stays the faster up to
// 119 views, so the crossover stays at 120 (PERF.md, PR 13).
constexpr int GRID_MIN_V = 120;

struct SolvePlan {
  bool cluster, global;
  int nt;             // threads of the one-CTA kernel
  size_t smem;        // dynamic shared bytes per CTA
  size_t rows_max;    // floats of the largest CTA's rows (cluster)
  size_t scratch;     // floats of the global scratch (G)
};

SolvePlan solve_plan(int V) {
  const int n = 6 * V, N = n + 1, nblk = (N + RB - 1) / RB;
  SolvePlan p = {};
  p.nt = n <= 192 ? 256 : 512;
  p.smem = sizeof(float) * (5 * round4(n) + round4(PW * DS) + PW + (size_t)(n + 4) * PS +
                            (size_t)N * round4(N));
  if (p.smem + 64 <= SMEM_MAX) return p;
  p.cluster = true;
  for (int q = 0; q < CL_C; ++q) {
    const size_t rows = blk_off(q, own_blocks(q, nblk));
    p.rows_max = rows > p.rows_max ? rows : p.rows_max;
  }
  const size_t vec = cluster_vec_floats(n), pan = (size_t)(N + 3) * PS;
  p.smem = sizeof(float) * (vec + pan + p.rows_max);
  p.global = p.smem + 64 > SMEM_MAX;
  if (p.global) {
    p.smem = sizeof(float) * vec;
    p.scratch = CL_C * p.rows_max + pan;
  }
  return p;
}

// ---------------------------------------------------------------------------
// K2: point_update_cost — replaces ba_pallas.py point_update_cost (and pass 2
// of ba_fused.py run_lm); its last CTA applies the accept / lambda / done
// rule of ba_fused.py run_lm (:457-474; the same as ba.py:501-513), K4
// lm_accept, which has no launch of its own.
//
// Bound: per observed (track, view) entry ~120 FMA in the point pass (the
// Jacobians, the point block and gradient, W^T dc) and ~20 in the cost pass,
// against 12 bytes of obsT and maskT: at 16 x 8192 0.5 us of either on the
// f32 peak or the HBM rate. At the main path's sizes what sets the time is
// the launch, the chain of dependent loads and math in each warp, and the
// grid-wide tail. The blocks are recomputed rather than stored by K1
// (storing W and V^-1 would cost 24V floats per track of traffic).
// Design (the layout of 32 tracks by view slices; K1's G-lanes-per-track
// scheme, with its cp.async input tile, was not built: with one lane a track
// and a warp a view slice every load is already 128 coalesced bytes, and G
// lanes a track would add a shuffle reduction per track to the chain of
// dependent math that sets K2's time):
//   - a CTA takes 32 consecutive tracks, one a lane, and its W warps take the
//     views w, w + W, w + 2W, ... of the same 32 tracks: every load of obsT
//     and maskT is 128 coalesced bytes along the track axis, the grid is
//     ceil(T / 32) CTAs (256 at 16 x 8192), and a warp walks about four
//     views, not V: W = ceil(V / 4) up to 16, the fastest of 1-16 warps at
//     3 x 7800, 16 x 8192 and 64 x 4096 on an H100 (ba_kernels.py
//     _k2_warps).
//   - every load the point pass needs is issued before the scalar state
//     arrives: the warp's first view, both halves of the lane's point and
//     of the thread's camera (state[CUR] then picks); each view's loads are
//     issued one view ahead.
//   - each warp sums its views' point block (upper triangle, 6), g_p (3) and
//     W^T dc = sum w Jp_k (Jc_k . dc) (3) per track in registers; the warps'
//     sums meet in shared memory and warp 0 adds them in warp order, forms
//     dp = V^-1 (g_p - W^T dc), retracts the point on S^3, writes it and
//     shares the new dehomogenized point; the cost pass splits over the same
//     views, and its per-track sums meet in warp order too, then a shuffle
//     tree over the lanes: one partial per CTA, in a fixed order.
//   - per-view tables in shared memory, built by every CTA: the candidate
//     camera's R9 and camp[0..4] (14 floats) and, for the point pass, the
//     current one's R9, camp[0..4], the two pixel rows of its Euler
//     derivatives (zeros for quaternions) and dc * free (38): 208 bytes a
//     view beside 25 KB of static buffers, which fit up to ~990 views. The
//     CTAs build theirs at the same time, so a build costs the critical
//     path once (the math of one camera, after loads issued before the
//     state arrives); a table built once a launch and staged from global
//     memory would move that math into a launch of its own (~2-3 us, what
//     folding K4 saved). Past shared memory that is what K2 does: k2_tables
//     builds the same tables in a global buffer, which every CTA reads, up
//     to K3's limit of 1365 views.
//   - every small array is indexed by constants in unrolled loops, and every
//     device function is inlined: no spills (-Xptxas -v on sm_90a).
//   - the accept tail: each CTA writes its partial, fences and takes a ticket
//     (atomicAdd on a device counter); the CTA with the last ticket resets
//     the counter for the next launch, sums the partials in index order
//     (lane l the partials l, l + 32, ..., then a shuffle tree: bit-stable),
//     applies the rule and writes the other state slot. The candidate points
//     go to the half of the point buffer that state[CUR] does not name, as
//     K3's candidate cameras do, so an accepted step only flips state[CUR].
//     A NaN cost (a failed camera step) is not below the current one: the
//     step is rejected and lambda raised.
// With state_in null it computes the initial cost (ba_fused.py cost_of): the
// current cameras as candidates, the points as they are, and writes the
// first state. With state_out null it stops at the partials (to time the
// tail). In split mode (cost_out set, state_out null) the last CTA writes
// the summed cost to cost_out, in the same order, and applies no rule: the
// sharded LM sums that cost over the shards and runs K4 lm_accept, one
// thread, on the sum (lm_rule: the same rule as the tail, so at one shard
// the two give the same bits). No float atomics: results are bit-stable
// from run to run.

constexpr int K2_TRACKS = 32;  // tracks per CTA, one a lane
constexpr int K2_MAXW = 16;    // warps per CTA at most
constexpr int NQ = 12;         // per-track sums: point block (6), g_p (3), W^T dc (3)
constexpr int TAB_CAND = 14;   // candidate table: R9 (9), camp[0..4] (5)
constexpr int TAB_CUR = 38;    // current table: R9, camp[0..4], dS rows (18), dc * free (6)

// The LM schedule constants of the accept rule.
struct LMRule {
  float lam0, func_tol, lam_up, lam_down, min_lam, max_lam;
};

// The accept / lambda / done rule (ba_fused.py :457-474, ba.py:501-513) on
// the scalar state st and the candidate's cost s: the new state into out;
// init: the first state of the initial cost s.
__device__ __forceinline__ void lm_rule(const float* st, float s, bool init, const LMRule& rule,
                                        float out[STATE_SIZE]) {
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) out[i] = 0.f;
  if (init) {
    out[LAM] = rule.lam0;
    out[COST] = s;
    out[INIT_COST] = s;
    return;
  }
  const float cost = st[COST];
  const bool acc = s < cost;
  const float rel = (cost - s) / fmaxf(cost, 1e-20f);
  bool done = acc && rel < rule.func_tol;
  const float nl = acc ? fmaxf(st[LAM] * rule.lam_down, rule.min_lam)
                       : fminf(st[LAM] * rule.lam_up, rule.max_lam);
  done = done || (!acc && nl >= rule.max_lam);
  out[LAM] = nl;
  out[COST] = acc ? s : cost;
  out[ITERS] = st[ITERS] + 1.f;
  out[DONE] = done ? 1.f : 0.f;
  out[INIT_COST] = st[INIT_COST];
  out[CUR] = acc != (st[CUR] != 0.f) ? 1.f : 0.f;
}

// One view's cameras as K2 loads them, both halves, before the state says
// which is current, and its step dc * free (zeros without a step).
struct CamIn {
  float rot[2][4], camp[2][5], dc[6];
};

__device__ __forceinline__ void load_cam(int v, const float* rot_a, const float* rot_b,
                                         const float* camp_a, const float* camp_b,
                                         const float* delta, const float* free, CamIn& c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.rot[0][k] = rot_a[4 * v + k];
    c.rot[1][k] = rot_b[4 * v + k];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    c.camp[0][k] = camp_a[8 * v + k];
    c.camp[1][k] = camp_b[8 * v + k];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) c.dc[j] = delta ? delta[6 * v + j] * free[6 * v + j] : 0.f;
}

// One camera's K2 table from half h of c: R9 and camp[0..4]; with dc, also
// the two pixel rows of the Euler derivatives and dc * free.
__device__ __forceinline__ void k2_table(int quat, const CamIn& c, bool h, bool dc,
                                         float* tab) {
  float rot[4], R9[9], dS[27];
#pragma unroll
  for (int k = 0; k < 4; ++k) rot[k] = h ? c.rot[1][k] : c.rot[0][k];
  cam_tables(quat, rot, R9, dS);
#pragma unroll
  for (int i = 0; i < 9; ++i) tab[i] = R9[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) tab[9 + i] = h ? c.camp[1][i] : c.camp[0][i];
  if (!dc) return;
#pragma unroll
  for (int i = 0; i < 18; ++i) tab[14 + i] = dS[i];
#pragma unroll
  for (int j = 0; j < 6; ++j) tab[32 + j] = c.dc[j];
}

// Loads (m, ox, oy) of view v for column t; zeros past the last view.
__device__ __forceinline__ void load_obs(const float* __restrict__ obsT,
                                         const float* __restrict__ maskT, int V, int T, int v,
                                         int t, float& m, float& ox, float& oy) {
  m = ox = oy = 0.f;
  if (v < V) {
    m = maskT[(size_t)v * T + t];
    ox = obsT[(size_t)(v * 2) * T + t];
    oy = obsT[(size_t)(v * 2 + 1) * T + t];
  }
}

// K2's per-view tables in global memory, one thread a view: gtab holds the
// candidate tables [V][TAB_CAND], then, for the point pass, the current
// ones [V][TAB_CUR], as point_update_cost_kernel builds them in shared
// memory.
__global__ void k2_tables_kernel(int quat, const float* rot_a, const float* rot_b,
                                 const float* camp_a, const float* camp_b,
                                 const float* __restrict__ free,
                                 const float* __restrict__ state_in,
                                 const float* __restrict__ delta, int update_points, int V,
                                 float* __restrict__ gtab) {
  const bool init = state_in == nullptr;
  const bool upd = update_points && !init;
  if (!init && state_in[DONE] != 0.f) return;
  const bool cur = !init && state_in[CUR] != 0.f;
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  CamIn ci;
  load_cam(v, rot_a, rot_b, camp_a, camp_b, upd ? delta : nullptr, free, ci);
  k2_table(quat, ci, init ? cur : !cur, false, gtab + v * TAB_CAND);
  if (upd) k2_table(quat, ci, cur, true, gtab + (size_t)V * TAB_CAND + v * TAB_CUR);
}

// Work item `item` of K2 (tracks 32 item .. 32 item + 31, one a lane) by the
// nw warps of one group (warp 0 .. nw - 1; `sync` their barrier), after the
// per-view tables tab_c (candidate cameras) and tab (current ones, for the
// point pass) are in place: the point update (upd) from the current half
// of pT into the other, then the robust cost at the candidate cameras and
// the new points, summed in warp order and over the lanes into
// cost_part[item]. (m, ox, oy): this warp's first view, and p4 the lane's
// current point, both loaded by the caller; sums and p3s: the group's
// shared buffers.
__device__ __forceinline__ void k2_item(int quat, float* pT_a, float* pT_b, const float* obsT,
                                        const float* maskT, float huber, bool upd, int V, int T,
                                        int item, const float* tab_c, const float* tab, float lam,
                                        bool cur, float m, float ox, float oy, const float p4[4],
                                        float (*sums)[NQ][K2_TRACKS],
                                        float (*p3s)[K2_TRACKS], GroupSync sync, int lane,
                                        int warp, int nw, float* cost_part) {
  const int t = item * K2_TRACKS + lane;
  const bool live = t < T;
  const int tc = live ? t : T - 1;  // a column the idle lanes may load
  if (upd) {
    PointPre P;
    point_pre(p4, P);
    float q[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) q[i] = 0.f;
    for (int v = warp; v < V; v += nw) {  // each view's loads one view ahead
      float mn, oxn, oyn;
      load_obs(obsT, maskT, V, T, v + nw, tc, mn, oxn, oyn);
      if (live && m != 0.f) {
        const float* c = tab + v * TAB_CUR;
        float r[2], w, Jc[2][6], Jp[2][3];
        obs_block(quat, c, c + 14, c + 9, nullptr, P, ox, oy, huber, r, w, Jc, Jp);
        add_point_block(w, Jp, r, q, q + 6);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float jd = 0.f;
#pragma unroll
          for (int a = 0; a < 6; ++a) jd += Jc[k][a] * c[32 + a];
#pragma unroll
          for (int j = 0; j < 3; ++j) q[9 + j] += w * jd * Jp[k][j];
        }
      }
      m = mn;
      ox = oxn;
      oy = oyn;
    }
    load_obs(obsT, maskT, V, T, warp, tc, m, ox, oy);  // the cost pass's first view
#pragma unroll
    for (int i = 0; i < NQ; ++i) sums[warp][i][lane] = q[i];
    sync();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        for (int w2 = 1; w2 < nw; ++w2) q[i] += sums[w2][i][lane];  // q holds warp 0's
      float Vi[9], tmp[3], dp[3], pn[4], nrm2 = 0.f;
      point_inv(q, lam, 1, Vi);
#pragma unroll
      for (int j = 0; j < 3; ++j) tmp[j] = q[6 + j] - q[9 + j];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dp[j] = Vi[j * 3 + 0] * tmp[0] + Vi[j * 3 + 1] * tmp[1] + Vi[j * 3 + 2] * tmp[2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pn[j] = P.p4[j] + P.B[j * 3 + 0] * dp[0] + P.B[j * 3 + 1] * dp[1] + P.B[j * 3 + 2] * dp[2];
        nrm2 += pn[j] * pn[j];
      }
      const float nrm = sqrtf(fmaxf(nrm2, 1e-40f));
#pragma unroll
      for (int j = 0; j < 4; ++j) pn[j] /= nrm;
      float* p_out = cur ? pT_a : pT_b;  // the other half
      if (live) {
#pragma unroll
        for (int j = 0; j < 4; ++j) p_out[(size_t)j * T + t] = pn[j];
      }
      const float sw = safe_w(pn[3]);
#pragma unroll
      for (int j = 0; j < 3; ++j) p3s[j][lane] = pn[j] / sw;
    }
  } else if (warp == 0) {
    const float sw = safe_w(p4[3]);
#pragma unroll
    for (int j = 0; j < 3; ++j) p3s[j][lane] = p4[j] / sw;
  }
  sync();

  // The robust cost at the candidate cameras and the new point.
  const float p3[3] = {p3s[0][lane], p3s[1][lane], p3s[2][lane]};
  const float d2 = huber * huber;
  float rho = 0.f;
  for (int v = warp; v < V; v += nw) {
    float mn, oxn, oyn;
    load_obs(obsT, maskT, V, T, v + nw, tc, mn, oxn, oyn);
    if (live && m != 0.f) {
      const float* c = tab_c + v * TAB_CAND;
      float local[3], pix[2];
      project(c, c + 9, p3, local, pix);
      const float rx = pix[0] - ox, ry = pix[1] - oy;
      const float s2 = rx * rx + ry * ry;
      // a NaN residual (a failed camera step) stays NaN, as in torch.clamp:
      // fmaxf would drop it and count -huber^2
      rho += s2 <= d2 ? s2 : 2.f * huber * sqrtf(s2 < 1e-20f ? 1e-20f : s2) - d2;
    }
    m = mn;
    ox = oxn;
    oy = oyn;
  }
  sums[warp][0][lane] = rho;
  sync();
  if (warp != 0) return;
  for (int w2 = 1; w2 < nw; ++w2) rho += sums[w2][0][lane];
  for (int off = 16; off > 0; off >>= 1) rho += __shfl_xor_sync(FULL, rho, off);
  if (lane == 0) cost_part[item] = 0.5f * rho;
}

// The sum of K2's n cost partials in index order, by one warp (lane l the
// partials l, l + 32, ..., then a shuffle tree): bit-stable; every lane
// gets it. The partials are read through L2, where other CTAs wrote them.
__device__ __forceinline__ float ordered_cost_sum(const float* cost_part, int n, int lane) {
  float s = 0.f;
#pragma unroll 8
  for (int i = lane; i < n; i += 32) s += __ldcg(cost_part + i);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

// gtab null: the per-view tables in shared memory, built by every CTA; else
// read from gtab (k2_tables).
__global__ void __launch_bounds__(K2_MAXW * 32) point_update_cost_kernel(
    int quat, float* pT_a, float* pT_b, const float* __restrict__ obsT,
    const float* __restrict__ maskT, const float* rot_a, const float* rot_b,
    const float* camp_a, const float* camp_b, const float* __restrict__ free,
    const float* __restrict__ state_in, const float* __restrict__ delta, float huber,
    int update_points, int V, int T, const float* __restrict__ gtab,
    float* __restrict__ state_out, float* __restrict__ cost_part,
    unsigned int* __restrict__ ticket, float* __restrict__ cost_out, LMRule rule) {
  extern __shared__ float k2_smem[];
  __shared__ float sums[K2_MAXW][NQ][K2_TRACKS];
  __shared__ float p3s[3][K2_TRACKS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int t = blockIdx.x * K2_TRACKS + lane;
  const int tc = t < T ? t : T - 1;  // a column the idle lanes may load
  // Every load that the first pass needs is issued before the scalar state
  // arrives: this warp's first view, both halves of this lane's point and of
  // this thread's first camera (state[CUR] then picks), so no load waits
  // on another.
  const bool init = state_in == nullptr;
  const bool upd = update_points && !init;
  float st[STATE_SIZE];
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) st[i] = init ? 0.f : state_in[i];
  float m, ox, oy;
  load_obs(obsT, maskT, V, T, warp, tc, m, ox, oy);
  float ph[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ph[0][j] = pT_a[(size_t)j * T + tc];
    ph[1][j] = pT_b[(size_t)j * T + tc];
  }
  CamIn ci;
  if (!gtab && tid < V)
    load_cam(tid, rot_a, rot_b, camp_a, camp_b, upd ? delta : nullptr, free, ci);
  if (st[DONE] != 0.f) {  // converged: pass the state on
    if (blockIdx.x == 0 && tid < STATE_SIZE && state_out) state_out[tid] = state_in[tid];
    return;
  }
  const bool cur = st[CUR] != 0.f;
  float p4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) p4[j] = cur ? ph[1][j] : ph[0][j];
  const float* tab_c = gtab ? gtab : k2_smem;  // [V][TAB_CAND] candidate cameras
  const float* tab = tab_c + V * TAB_CAND;     // [V][TAB_CUR]  current cameras (point pass)
  if (!gtab) {
    for (int v = tid; v < V; v += blockDim.x) {
      if (v != tid) load_cam(v, rot_a, rot_b, camp_a, camp_b, upd ? delta : nullptr, free, ci);
      k2_table(quat, ci, init ? cur : !cur, false, k2_smem + v * TAB_CAND);
      if (upd) k2_table(quat, ci, cur, true, k2_smem + V * TAB_CAND + v * TAB_CUR);
    }
  }
  __syncthreads();
  k2_item(quat, pT_a, pT_b, obsT, maskT, huber, upd, V, T, blockIdx.x, tab_c, tab, st[LAM], cur,
          m, ox, oy, p4, sums, p3s, GroupSync{0, (int)blockDim.x}, lane, warp, nw, cost_part);
  if (warp != 0 || (!state_out && !cost_out)) return;

  // The accept tail, in the CTA that takes the last ticket.
  unsigned int last = 0;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  const float s = ordered_cost_sum(cost_part, gridDim.x, lane);
  if (lane != 0) return;
  *ticket = 0u;
  if (cost_out) *cost_out = s;
  if (!state_out) return;
  float out[STATE_SIZE];
  lm_rule(st, s, init, rule, out);
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) state_out[i] = out[i];
}

// K4 lm_accept as a launch of its own (the sharded LM's accept): the rule
// of K2's tail on the cost summed over the shards. state_in null: the
// first state. A converged state passes on unchanged, as in K2.
__global__ void lm_accept_kernel(const float* __restrict__ state_in,
                                 const float* __restrict__ cost, float* __restrict__ state_out,
                                 LMRule rule) {
  if (threadIdx.x != 0) return;
  const bool init = state_in == nullptr;
  float st[STATE_SIZE], out[STATE_SIZE];
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) st[i] = init ? 0.f : state_in[i];
  if (st[DONE] != 0.f) {
#pragma unroll
    for (int i = 0; i < STATE_SIZE; ++i) state_out[i] = st[i];
    return;
  }
  lm_rule(st, cost[0], init, rule, out);
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) state_out[i] = out[i];
}

// ---------------------------------------------------------------------------
// lm_fused — replaces ba_fused.py run_lm (_make_lm_kernel :229), the whole
// robust LM solve in one pallas_call: the initial cost, then up to
// max_iters iterations of K1, K3 and K2 with its accept rule, and the loop
// with its stop, in one cooperative launch for problems of up to ~375
// views (fused_plan: while K1's and K2's per-view tables fit its shared
// memory).
//
// Bound: per iteration that works, the K1 + K3 + K2 work above (FMA for
// K1's Schur term, the dependent chain of K3's pivots, K2's per-observation
// math); the inputs are read once for the whole solve. What the
// per-iteration path pays besides that work is the host: ~0.13-0.21 ms of
// enqueue an iteration (five launches from Python) against 0.08 ms of
// device work at 16 x 8192, and max_iterations iterations enqueued whether
// they work or not (phase 9's 64-view global BAs: 2100 enqueued, 126
// worked). Here one launch runs the loop, and the iterations after
// convergence are never run. What remains between the stages is a
// grid-wide barrier (grid.sync(), ~1 us; four or five an iteration).
//
// Design: a persistent grid of 512-thread CTAs, one a SM (the CTA takes up
// to 128 registers a thread), as many as the occupancy query lets be
// resident, every stage the per-iteration kernels' own work items, each by
// the same device function with the same per-item arithmetic and sum
// order, so that the solve agrees with the per-iteration path bit for bit,
// iteration count included. A stage deals its items to the CTAs group by
// group (item g * gridDim + CTA for the CTA's g-th group), so that a last,
// partial round of items lands one to a SM rather than filling a few SMs
// (which item a group takes does not change what the item computes). How
// the CTA's 16 warps map onto the per-iteration kernels' CTAs (a group runs
// one work item; named barrier 1 + g stands in for its __syncthreads,
// __syncwarp for a group of one warp):
//   K1 blocks   two groups of 8 warps (BLK_NT threads), a chunk each; the
//               camera tables in shared memory are the CTA's, built once
//   K1 product  eight groups of 2 warps (PROD_NT threads), an output tile
//               and split each, each with its own k-tile buffers
//   K1 reduce   the per-iteration launch's lanes, item * RL + sub, walked by
//               whole warps (a warp holds 32 consecutive lanes)
//   K3          up to 5 views one warp of CTA 0, 6 to 37 the one-CTA solve
//               on all 512 threads of CTA 0 (each entry is one thread's or
//               one warp's work whatever the CTA's size, so it computes what
//               the 256-thread launch does); from 38 views the cluster solve
//               on CTAs 0-7, the launch then being made in clusters of CL_C
//               with the cooperative attribute (cudaLaunchKernelEx), its grid
//               whole clusters (cudaOccupancyMaxActiveClusters: 15 on an H100
//               SXM at 512 threads and ~200 KB, 120 CTAs); the cluster's own
//               barriers, its rows in distributed shared memory and its
//               panel order inside the stage, the grid barriers around it,
//               as in its own launch, so the same bits; from GRID_MIN_V the
//               grid route on every CTA of a plain cooperative launch (one
//               CTA a SM): grid_init's 64 x 64 tiles dealt to the CTAs, a
//               grid barrier, grid_solve's panels (two grid barriers a panel
//               and one a panel of the back substitution) and grid_finish
//               on CTA 0, lambda and the current half from the CTA's state
//               copy; its failure flag in its scratch makes delta NaN, so
//               K2's cost is NaN and the step rejected, as in its launches
//   K2          16 / w groups of w warps (w = the launch's warps a CTA,
//               ba_kernels.py _k2_warps), 32 tracks each; the per-view
//               tables are the CTA's, built once
//   accept      every CTA's warp 0 sums the cost partials in K2's tail order
//               and applies the rule to its own copy of the scalar state in
//               shared memory, so every CTA holds the same state without a
//               further barrier, and all of them leave the loop together
//               on its done flag; CTA 0 writes the final state.
// Between stages: grid.sync(). No stage returns early on the done flag
// (every CTA must reach every barrier); the loop stops instead. The stages
// reuse one dynamic shared buffer, sized for the largest (fused_plan).
// Data written in the launch is read through plain or L2 loads, never the
// read-only path (no __restrict__ on what a stage writes).
// Measured (kernel_bench.lm_fused_split, scripts/torch_lm_fused_variants.py
// on an H100 SXM at 700 W, PERF.md): with K1's X, Y scratch at the normal
// L2 priority every later stage ran 20-70% longer inside the launch than
// in its own (each alone in the launch ran as fast); marked evict-first
// (the block pass's stores, the product's loads) an iteration at 16 x 8192
// took 0.091 ms instead of 0.115. A grid barrier costs ~1 us, below what a
// barrier of its own (one arrival counter, an acquire spin) took (~2 us),
// so grid.sync stays.

constexpr int FUSED_NT = 512;                          // threads of lm_fused's CTA
constexpr int FUSED_BLK_GROUPS = FUSED_NT / BLK_NT;    // K1 block-pass groups a CTA
constexpr int FUSED_PROD_GROUPS = FUSED_NT / PROD_NT;  // K1 product groups a CTA
static_assert(FUSED_NT == GS_NT, "the grid route's tile product takes a CTA of GS_NT threads");

struct FusedArgs {
  int quat;
  float *pT_a, *pT_b;
  const float *obsT, *maskT;
  float *rot_a, *rot_b, *camp_a, *camp_b;
  const float* free;
  float huber;
  int opt, V, T, G, ldx, n_chunks, n_split, cps, warps, max_iters;
  float *Xk, *Yk;
  int* counts;
  float *vpart, *Ppart, *S, *dU, *rhs, *delta, *cost_part, *state_out;
  LMRule rule;
  int route;        // the camera solve's: R_WARP, R_CTA, R_CLUSTER or R_GRID
  float* gscratch;  // the grid route's scratch (grid_layout(V).total floats; R_GRID only)
#ifdef OSFM_FUSED_TIMING
  unsigned long long* stamps;  // FUSED_STAMP_HEAD + FUSED_STAMP_SLOTS * max_iters, zeroed
#endif
};

// The timing build (-DOSFM_FUSED_TIMING; utils/kernel_bench.py
// lm_fused_split builds it on its own, never the main path's library):
// %globaltimer stamps at every stage boundary. Per iteration, slot 0 is CTA
// 0's stamp at its start; barrier b (FUSED_B_*) has slot 1 + 2b, the last
// CTA's arrival (an atomicMax over every CTA's), and 2 + 2b, CTA 0's stamp
// on its release; the last slot is CTA 0's stamp after the accept. A
// barrier the iteration does not take keeps its slots 0. The head: the
// launch's start, the initial cost's barrier (arrival, release) and the
// end of its accept.
enum { FUSED_B_BLOCKS, FUSED_B_PRODUCT, FUSED_B_REDUCE, FUSED_B_SOLVE, FUSED_B_K2, FUSED_NB };
constexpr int FUSED_STAMP_HEAD = 4;
constexpr int FUSED_STAMP_SLOTS = 2 + 2 * FUSED_NB;

#ifdef OSFM_FUSED_TIMING
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// CTA 0's stamp into slot `slot` (the timing build only).
__device__ __forceinline__ void fused_stamp(const FusedArgs& a, int slot) {
#ifdef OSFM_FUSED_TIMING
  if (a.stamps && blockIdx.x == 0 && threadIdx.x == 0) a.stamps[slot] = global_ns();
#endif
}

// grid.sync(), with its arrival and release stamped at slots `slot` and
// slot + 1 in the timing build.
__device__ __forceinline__ void fused_sync(cg::grid_group& grid, const FusedArgs& a, int slot) {
#ifdef OSFM_FUSED_TIMING
  __syncthreads();
  if (a.stamps && threadIdx.x == 0) atomicMax(a.stamps + slot, global_ns());
#endif
  grid.sync();
  fused_stamp(a, slot + 1);
}

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Bytes of a K1 block-pass group's buffers in lm_fused: its BlocksShared and
// its per-view sums.
__host__ __device__ inline size_t fused_blocks_group_bytes(int V) {
  return sizeof(BlocksShared) + round16(sizeof(float) * V * NU);
}

// Floats of a K2 group's buffers in lm_fused: sums [w][NQ][32], p3s [3][32].
__host__ __device__ constexpr int fused_k2_group_floats(int w) {
  return w * NQ * K2_TRACKS + 3 * K2_TRACKS;
}

// K1's block pass over every chunk.
__device__ __forceinline__ void fused_blocks(const FusedArgs& a, const float* st, float* fsm) {
  const int tid = threadIdx.x, g = tid / BLK_NT;
  const bool cur = st[CUR] != 0.f;
  Cam* cams = reinterpret_cast<Cam*>(fsm);
  for (int v = tid; v < a.V; v += FUSED_NT)
    fill_cam(a.quat, cur ? a.rot_b : a.rot_a, cur ? a.camp_b : a.camp_a, a.free, v, cams[v]);
  __syncthreads();
  char* base = reinterpret_cast<char*>(fsm) + round16(sizeof(Cam) * a.V) +
               g * fused_blocks_group_bytes(a.V);
  BlocksShared& sh = *reinterpret_cast<BlocksShared*>(base);
  float* usum = reinterpret_cast<float*>(base + sizeof(BlocksShared));
  const GroupSync sync{1 + g, BLK_NT};
  for (int c = g * gridDim.x + blockIdx.x; c < a.n_chunks; c += gridDim.x * FUSED_BLK_GROUPS) {
    sync();  // the group's buffers are free again
    schur_blocks_chunk(a.quat, cur ? a.pT_b : a.pT_a, a.obsT, a.maskT, cams, st[LAM], a.huber,
                       a.opt, a.V, a.T, a.G, a.ldx, c, a.Xk, a.Yk, a.counts, usum,
                       a.vpart + (size_t)c * a.V * NU, sh, sync, tid % BLK_NT);
  }
}

// K1's product over every (tile, split).
__device__ __forceinline__ void fused_product(const FusedArgs& a, float* fsm) {
  const int tid = threadIdx.x, g = tid / PROD_NT;
  ProductShared& sh = reinterpret_cast<ProductShared*>(fsm)[g];
  const GroupSync sync{1 + g, PROD_NT};
  const int nt = a.ldx / PT, tiles = nt * (nt + 1) / 2, items = tiles * a.n_split;
  for (int it = g * gridDim.x + blockIdx.x; it < items; it += gridDim.x * FUSED_PROD_GROUPS) {
    sync();
    schur_product_tile(a.ldx, a.n_chunks, a.cps, a.counts, a.Xk, a.Yk, a.Ppart, it % tiles,
                       it / tiles, sh, sync, tid % PROD_NT);
  }
}

// K1's ordered reduce over every lane of the per-iteration launch, a warp's
// 32 consecutive lanes at a time, dealt to the CTAs warp by warp.
__device__ __forceinline__ void fused_reduce(const FusedArgs& a) {
  const int n = 6 * a.V;
  const size_t lanes = (((size_t)n * n + 2 * (size_t)n) * RL + 31) & ~(size_t)31;
  const size_t w0 = (size_t)(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  for (size_t vt = w0 * 32 + (threadIdx.x & 31); vt < lanes; vt += (size_t)gridDim.x * FUSED_NT)
    schur_reduce_lane(vt, a.V, a.ldx, a.opt ? a.n_split : 0, a.n_chunks, a.Ppart, a.vpart, a.S,
                      a.dU, a.rhs);
}

// K3 in CTA 0 (one warp or the one-CTA solve), on the first cluster (CTAs
// 0 .. CL_C - 1) or on every CTA (the grid route: grid_init's tiles dealt
// to the CTAs, a grid barrier, grid_solve's factorization and back
// substitution with their own barriers, then grid_finish on CTA 0, with
// lambda and the current half from st): the candidate cameras into the half
// st[CUR] does not name.
template <bool GRID>
__device__ __forceinline__ void fused_solve(const FusedArgs& a, const float* st, float* fsm,
                                            int& s_failed, cg::grid_group& grid) {
  const int tid = threadIdx.x;
  if (GRID) {
    const int n = 6 * a.V, it = (n + GI_T) / GI_T, tiles = it * (it + 1) / 2;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int bi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);  // an approximate root, then exact
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      __syncthreads();  // the tile's shared buffer is free again
      grid_init_tile(a.S, a.dU, a.rhs, a.free, st[LAM], n, a.gscratch, bi, t - bi * (bi + 1) / 2,
                     fsm, tid, FUSED_NT);
    }
    grid.sync();
    // inlined: as a call of its own (__noinline__) the stage ran 9-11%
    // slower at 120-375 views (scripts/torch_k3_routes.py --grid-variants)
    grid_solve_all(n, a.gscratch, align1024(fsm), grid);
    if (blockIdx.x == 0)
      grid_finish_cta(a.quat, a.S, a.dU, a.free, st, a.rot_a, a.rot_b, a.camp_a, a.camp_b, a.V,
                      a.gscratch, a.delta, s_failed, tid, FUSED_NT);
    return;
  }
  if (a.route == R_CLUSTER) {
    if (blockIdx.x < CL_C)
      camera_solve_cluster<false, false>(a.quat, a.S, a.dU, a.rhs, a.free, st, a.rot_a, a.rot_b,
                                         a.camp_a, a.camp_b, a.V, 0, nullptr, a.delta, fsm, tid);
    return;
  }
  if (blockIdx.x != 0) return;
  if (a.route == R_CTA) {
    camera_solve_cta<FUSED_NT, false>(a.quat, a.S, a.dU, a.rhs, a.free, st, a.rot_a, a.rot_b,
                                      a.camp_a, a.camp_b, a.V, a.delta, fsm, s_failed, tid);
    return;
  }
  if (tid >= 32) return;
#define OSFM_WARP_SOLVE(v)                                                                    \
  camera_solve_warp<v, false>(a.quat, a.S, a.dU, a.rhs, a.free, st, a.rot_a, a.rot_b,         \
                              a.camp_a, a.camp_b, a.delta,                                    \
                              reinterpret_cast<float(*)[6 * v + 1]>(fsm),                     \
                              fsm + 6 * v * (6 * v + 1), tid)
  switch (a.V) {
    case 1: OSFM_WARP_SOLVE(1); break;
    case 2: OSFM_WARP_SOLVE(2); break;
    case 3: OSFM_WARP_SOLVE(3); break;
    case 4: OSFM_WARP_SOLVE(4); break;
    default: OSFM_WARP_SOLVE(5); break;
  }
#undef OSFM_WARP_SOLVE
}

// K2 over every 32-track item: the CTA's per-view tables, then its groups.
// init: the initial cost (the current cameras as candidates, no point
// update; st all zeros).
__device__ __forceinline__ void fused_k2(const FusedArgs& a, const float* st, bool init,
                                         float* fsm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool upd = a.opt && !init;
  const bool cur = st[CUR] != 0.f;
  float* tab_c = fsm;                        // [V][TAB_CAND] candidate cameras
  float* tab = tab_c + a.V * TAB_CAND;       // [V][TAB_CUR]  current cameras (point pass)
  for (int v = tid; v < a.V; v += FUSED_NT) {
    CamIn ci;
    load_cam(v, a.rot_a, a.rot_b, a.camp_a, a.camp_b, upd ? a.delta : nullptr, a.free, ci);
    k2_table(a.quat, ci, init ? cur : !cur, false, tab_c + v * TAB_CAND);
    if (upd) k2_table(a.quat, ci, cur, true, tab + v * TAB_CUR);
  }
  __syncthreads();
  const int nw = a.warps, groups = (FUSED_NT / 32) / nw, g = warp / nw, w = warp % nw;
  if (g >= groups) return;
  float* gb = fsm + round4(a.V * (TAB_CAND + TAB_CUR)) + g * fused_k2_group_floats(nw);
  auto sums = reinterpret_cast<float(*)[NQ][K2_TRACKS]>(gb);
  auto p3s = reinterpret_cast<float(*)[K2_TRACKS]>(gb + nw * NQ * K2_TRACKS);
  const GroupSync sync{1 + g, nw * 32};
  const float* pc = cur ? a.pT_b : a.pT_a;
  const int items = (a.T + K2_TRACKS - 1) / K2_TRACKS;
  for (int item = g * gridDim.x + blockIdx.x; item < items; item += gridDim.x * groups) {
    sync();  // the group's buffers are free again
    const int t = item * K2_TRACKS + lane, tc = t < a.T ? t : a.T - 1;
    float m, ox, oy, p4[4];
    load_obs(a.obsT, a.maskT, a.V, a.T, w, tc, m, ox, oy);
#pragma unroll
    for (int j = 0; j < 4; ++j) p4[j] = pc[(size_t)j * a.T + tc];
    k2_item(a.quat, a.pT_a, a.pT_b, a.obsT, a.maskT, a.huber, upd, a.V, a.T, item, tab_c, tab,
            st[LAM], cur, m, ox, oy, p4, sums, p3s, sync, lane, w, nw, a.cost_part);
  }
}

// K2's accept tail, in every CTA: the rule on the ordered sum of the cost
// partials, from st_in (all zeros with init) into st_out.
__device__ __forceinline__ void fused_accept(const FusedArgs& a, const float* st_in, bool init,
                                             float* st_out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float s = ordered_cost_sum(a.cost_part, (a.T + K2_TRACKS - 1) / K2_TRACKS, lane);
    if (lane == 0) {
      float in[STATE_SIZE], out[STATE_SIZE];
#pragma unroll
      for (int i = 0; i < STATE_SIZE; ++i) in[i] = st_in[i];
      lm_rule(in, s, init, a.rule, out);
#pragma unroll
      for (int i = 0; i < STATE_SIZE; ++i) st_out[i] = out[i];
    }
  }
  __syncthreads();
}

// GRID: the instantiation for the grid route (fused_plan's R_GRID); the
// other routes' instantiation holds none of its code, so its registers are
// allocated as before it existed (with the grid route's stage in the same
// kernel, every size below 120 views ran 3.5-10% slower, its spill 296 ->
// 428 bytes a thread; PERF.md, PR 13).
template <bool GRID>
__global__ void __launch_bounds__(FUSED_NT, 1) lm_fused_kernel(const FusedArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float fsm[];
  __shared__ float st[2][STATE_SIZE];  // this CTA's copy of the two state slots
  __shared__ int s_failed;
  const int tid = threadIdx.x;
  if (tid < 2 * STATE_SIZE) st[tid / STATE_SIZE][tid % STATE_SIZE] = 0.f;
  __syncthreads();
  fused_stamp(a, 0);
  fused_k2(a, st[1], true, fsm);  // the initial cost
  fused_sync(grid, a, 1);
  fused_accept(a, st[1], true, st[0]);
  fused_stamp(a, 3);
  int slot = 0;
  for (int it = 0; it < a.max_iters; ++it) {
    const float* s_in = st[it & 1];
    float* s_out = st[(it + 1) & 1];
    const int base = FUSED_STAMP_HEAD + FUSED_STAMP_SLOTS * it;
    fused_stamp(a, base);
    fused_blocks(a, s_in, fsm);
    fused_sync(grid, a, base + 1 + 2 * FUSED_B_BLOCKS);
    if (a.opt) {  // with the points held fixed V^-1 = 0, and S' is blkdiag(U)
      fused_product(a, fsm);
      fused_sync(grid, a, base + 1 + 2 * FUSED_B_PRODUCT);
    }
    fused_reduce(a);
    fused_sync(grid, a, base + 1 + 2 * FUSED_B_REDUCE);
    fused_solve<GRID>(a, s_in, fsm, s_failed, grid);
    fused_sync(grid, a, base + 1 + 2 * FUSED_B_SOLVE);
    fused_k2(a, s_in, false, fsm);
    fused_sync(grid, a, base + 1 + 2 * FUSED_B_K2);
    fused_accept(a, s_in, false, s_out);
    fused_stamp(a, base + FUSED_STAMP_SLOTS - 1);
    slot = (it + 1) & 1;
    if (s_out[DONE] != 0.f) break;  // every CTA holds the same state
  }
  if (blockIdx.x == 0 && tid < STATE_SIZE) a.state_out[tid] = st[slot][tid];
}

// Lets `fn` take up to SMEM_MAX bytes of shared memory, static and dynamic
// together: without it a launch whose two sum past 48 KB is refused. Each
// kernel's attribute is set once (a few kernels: a full table just sets it
// again).
int allow_smem(const void* fn) {
  static const void* done[16];
  static int n_done = 0;
  for (int i = 0; i < n_done; ++i)
    if (done[i] == fn) return 0;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (!err)
    err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)(SMEM_MAX - attr.sharedSizeBytes));
  if (!err && n_done < 16) done[n_done++] = fn;
  return err;
}

// Whether `dynamic` bytes of shared memory fit beside fn's static ones
// (each kernel's static size read once).
bool fits_smem(const void* fn, size_t dynamic) {
  static const void* fns[4];
  static size_t sizes[4];
  static int n_fns = 0;
  int i = 0;
  while (i < n_fns && fns[i] != fn) ++i;
  if (i == n_fns) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn)) return false;
    if (n_fns == 4) return attr.sharedSizeBytes + dynamic <= SMEM_MAX;
    fns[i] = fn;
    sizes[i] = attr.sharedSizeBytes;
    ++n_fns;
  }
  return sizes[i] + dynamic <= SMEM_MAX;
}

// Dynamic shared bytes of K1's block pass and of K2 with their tables there.
size_t k1_dyn_smem(int V) { return sizeof(Cam) * V + sizeof(float) * V * NU; }

size_t k2_dyn_smem(int V, bool upd) {
  return sizeof(float) * V * (TAB_CAND + (upd ? TAB_CUR : 0));
}

// The camera solve's arguments, as each of its launches passes them on.
struct SolveArgs {
  int quat;
  const float *S, *dU, *rhs, *free, *state;
  float *rot_a, *rot_b, *camp_a, *camp_b;
  int V;
  float* delta;
};

template <int K>
int launch_camera_solve(size_t smem, cudaStream_t st, const SolveArgs& a) {
  int err = allow_smem((const void*)camera_solve_kernel<K>);
  if (err) return err;
  camera_solve_kernel<K><<<1, K, smem, st>>>(a.quat, a.S, a.dU, a.rhs, a.free, a.state, a.rot_a,
                                             a.rot_b, a.camp_a, a.camp_b, a.V, a.delta);
  return (int)cudaGetLastError();
}

template <bool G>
int launch_cluster_solve(const SolvePlan& p, cudaStream_t st, const SolveArgs& a,
                         float* gscratch) {
  int err = allow_smem((const void*)camera_solve_cluster_kernel<G>);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL_C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL_C);
  cfg.blockDim = dim3(CL_NT);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, camera_solve_cluster_kernel<G>, a.quat, a.S, a.dU, a.rhs,
                                a.free, a.state, a.rot_a, a.rot_b, a.camp_a, a.camp_b, a.V,
                                p.rows_max, gscratch, a.delta);
  if (err) return err;
  return (int)cudaGetLastError();
}

// The grid route: grid_init, grid_solve (one cooperative launch of as many
// CTAs as are resident, up to the most work a stage has) and grid_finish,
// all on one stream. A cooperative launch the card refuses returns its
// error after grid_init has run, and nothing else runs.
int launch_grid_solve(cudaStream_t st, const SolveArgs& a, float* scratch) {
  int n = 6 * a.V;
  const int N = n + 1;
  const void* fn = (const void*)grid_solve_kernel;
  int err = allow_smem(fn);
  if (err) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev)) ||
      (err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (err = (int)cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) ||
      (err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_solve_kernel, GS_NT,
                                                                G_SMEM)))
    return err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int it = (N + GI_T - 1) / GI_T;
  grid_init_kernel<<<dim3(it, it), G_NT, 0, st>>>(a.S, a.dU, a.rhs, a.free, a.state, n, scratch);
  if ((err = (int)cudaGetLastError())) return err;
  // no more CTAs than the first update's tiles or the back substitution's rows
  const int nt = (N - 1) / GB, need_u = nt * (nt + 1) / 2, need_b = (n + GS_NT - 1) / GS_NT;
  int grid = per_sm * sms;
  const int need = need_u > need_b ? need_u : need_b;
  grid = need < grid ? (need > 1 ? need : 1) : grid;
  const float* state = a.state;
  void* args[] = {(void*)&state, (void*)&n, (void*)&scratch};
  err = (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(GS_NT), args, G_SMEM, st);
  if (err) return err;
  if ((err = (int)cudaGetLastError())) return err;
  grid_finish_kernel<<<1, GF_NT, 0, st>>>(a.quat, a.S, a.dU, a.free, a.state, a.rot_a, a.rot_b,
                                          a.camp_a, a.camp_b, a.V, scratch, a.delta);
  return (int)cudaGetLastError();
}

// The route `route` takes for V views (R_AUTO: the automatic choice), or -1
// where that route cannot serve V views.
int solve_route(int V, int route) {
  if (route == R_AUTO)
    route = V <= WARP_SOLVE_V ? R_WARP
            : V >= GRID_MIN_V ? R_GRID
            : solve_plan(V).cluster ? R_CLUSTER : R_CTA;
  switch (route) {
    case R_WARP: return V >= 1 && V <= WARP_SOLVE_V ? route : -1;
    case R_CTA: return V > WARP_SOLVE_V && !solve_plan(V).cluster ? route : -1;
    case R_CLUSTER: return V > WARP_SOLVE_V && V <= CL_MAX_V && solve_plan(V).cluster ? route : -1;
    case R_GRID: return V >= 1 ? route : -1;
    default: return -1;
  }
}

template <int V>
int launch_warp_solve(cudaStream_t st, const SolveArgs& a) {
  camera_solve_warp_kernel<V><<<1, 32, 0, st>>>(a.quat, a.S, a.dU, a.rhs, a.free, a.state,
                                                a.rot_a, a.rot_b, a.camp_a, a.camp_b, a.delta);
  return (int)cudaGetLastError();
}

// How lm_fused runs at V views with K2 in groups of `warps` warps: its
// camera solve's route, its dynamic shared bytes (its largest stage's: the
// stages reuse one buffer) and its grid: as many CTAs as the occupancy
// query lets be resident (one wave; with the cluster, whole clusters of
// CL_C), or 0 where it cannot serve V views. The camera solve takes K3's
// own rule (solve_route), so lm_fused and the per-iteration kernels run the
// same route at every size: one warp, one CTA, the cluster with its rows in
// shared memory, or from GRID_MIN_V the grid route on every CTA, its
// G_SMEM (~195 KB) the largest stage there. Where K1's block stage (the
// camera tables, 200 bytes a view, and two groups' per-view sums, 108
// bytes a view each, beside 2 x 37 KB) or K2's per-view tables (208 bytes a
// view) no longer fit the one buffer beside the kernel's static shared
// memory, it serves no more: past ~375 views on an H100 (the per-iteration
// kernels read such tables from global memory; inside lm_fused they are
// not built there).
struct FusedPlan {
  int route, grid;
  size_t smem;
};

FusedPlan fused_plan(int V, int warps) {
  FusedPlan f = {};
  if (V < 1 || warps < 1 || warps > K2_MAXW) return f;
  f.route = solve_route(V, R_AUTO);
  if (f.route == R_CLUSTER && solve_plan(V).global) return f;
  const int n = 6 * V;
  const size_t blocks =
      round16(sizeof(Cam) * V) + FUSED_BLK_GROUPS * fused_blocks_group_bytes(V);
  const size_t product = FUSED_PROD_GROUPS * sizeof(ProductShared);
  const size_t solve = f.route == R_WARP   ? sizeof(float) * (n * (n + 1) + 32)
                       : f.route == R_GRID ? G_SMEM
                                           : solve_plan(V).smem;
  const size_t k2 = sizeof(float) * (round4(V * (TAB_CAND + TAB_CUR)) +
                                     (size_t)(FUSED_NT / 32 / warps) * fused_k2_group_floats(warps));
  f.smem = blocks > product ? blocks : product;
  f.smem = solve > f.smem ? solve : f.smem;
  f.smem = k2 > f.smem ? k2 : f.smem;
  const void* fn = f.route == R_GRID ? (const void*)lm_fused_kernel<true>
                                      : (const void*)lm_fused_kernel<false>;
  if (allow_smem(fn) || !fits_smem(fn, f.smem)) return f;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev) || !coop)
    return f;
  if (f.route != R_CLUSTER) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, FUSED_NT, f.smem))
      return f;
    f.grid = per_sm * sms;
    return f;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL_C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL_C);
  cfg.blockDim = dim3(FUSED_NT);
  cfg.dynamicSmemBytes = f.smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, lm_fused_kernel<false>, &cfg)) return f;
  f.grid = clusters * CL_C;
  return f;
}

}  // namespace

extern "C" {

// The route the camera solve takes for V cameras (R_AUTO: its automatic
// choice): 0 warp, 1 one CTA, 2 cluster, 3 grid; -1 where the route asked
// for cannot serve V cameras.
int osfm_camera_solve_route(int V, int route) { return solve_route(V, route); }

// Floats of the global scratch buffer the camera solve's route needs for V
// cameras (0 when its matrix fits in shared memory).
long long osfm_camera_solve_scratch_floats(int V, int route) {
  route = solve_route(V, route);
  if (route == R_GRID) return (long long)grid_layout(V).total;
  return route == R_CLUSTER ? (long long)solve_plan(V).scratch : 0;
}

#ifdef OSFM_FUSED_TIMING
// The timing build's buffer for the grid route's next grid_solve launches
// to stamp (null: none): a count, then (kind, %globaltimer) pairs of 64-bit
// words, 4 + 6 ceil(6V / 128) words at V views (scripts/torch_k3_routes.py
// --split).
int osfm_grid_solve_stamps(void* stamps) {
  return (int)cudaMemcpyToSymbol(grid_stamps, &stamps, sizeof(stamps));
}
#endif

// Floats of the global camera tables K1's block pass needs for V cameras (0
// when its tables and sums fit in shared memory).
int osfm_schur_table_floats(int V) {
  return fits_smem((const void*)schur_blocks_kernel, k1_dyn_smem(V))
             ? 0 : (int)(sizeof(Cam) / sizeof(float)) * V;
}

// The points and cameras come as two halves each (a, b), the current one
// named by state[CUR]. gcams: osfm_schur_table_floats(V) floats, or null
// when that is 0.
int osfm_schur_assemble(int quat, const float* pT_a, const float* pT_b, const float* obsT,
                        const float* maskT, const float* rot_a, const float* rot_b,
                        const float* camp_a, const float* camp_b, const float* free,
                        const float* state, float huber, int opt, int V, int T, int ldx,
                        int n_chunks, int n_split, int cps, float* gcams, float* Xk, float* Yk,
                        int* counts, float* vpart, float* Ppart, float* S, float* dU, float* rhs,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 6 * V;
  int G = 1;  // lanes per track: the views of a track, up to a warp
  while (G < V && G < 32) G *= 2;
  const bool global = osfm_schur_table_floats(V) > 0;
  if (global && !gcams) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (global) {
    schur_cams_kernel<<<(V + 127) / 128, 128, 0, st>>>(quat, rot_a, rot_b, camp_a, camp_b, free,
                                                      state, V, reinterpret_cast<Cam*>(gcams));
    err = (int)cudaGetLastError();
  } else {
    err = allow_smem((const void*)schur_blocks_kernel);
  }
  if (err) return err;
  schur_blocks_kernel<<<n_chunks, BLK_NT, global ? 0 : k1_dyn_smem(V), st>>>(
      quat, pT_a, pT_b, obsT, maskT, rot_a, rot_b, camp_a, camp_b, free, state, huber, opt, V, T,
      G, ldx, global ? reinterpret_cast<const Cam*>(gcams) : nullptr, Xk, Yk, counts, vpart);
  err = (int)cudaGetLastError();
  if (err) return err;
  if (opt) {  // with the points held fixed V^-1 = 0, and S' is blkdiag(U)
    const int nt = ldx / PT;
    schur_product_kernel<<<dim3(nt * (nt + 1) / 2, n_split), PROD_NT, 0, st>>>(
        state, ldx, n_chunks, cps, counts, Xk, Yk, Ppart);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const size_t blocks = (((size_t)n * n + 2 * (size_t)n) * RL + NT - 1) / NT;
  schur_reduce_kernel<<<blocks, NT, 0, st>>>(state, V, ldx, opt ? n_split : 0, n_chunks, Ppart,
                                             vpart, S, dU, rhs);
  return (int)cudaGetLastError();
}

// Reads the cameras of the half state[CUR] names and writes the candidate
// into the other (with state[CUR] = 0: reads rot_a, camp_a, writes rot_b,
// camp_b), by `route` (R_AUTO: the automatic choice); gscratch holds
// osfm_camera_solve_scratch_floats(V, route) floats.
int osfm_camera_solve(int quat, const float* S, const float* dU, const float* rhs,
                      const float* free, const float* state, float* rot_a, float* rot_b,
                      float* camp_a, float* camp_b, int V, int route, float* gscratch,
                      float* delta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SolveArgs a = {quat, S, dU, rhs, free, state, rot_a, rot_b, camp_a, camp_b, V, delta};
  route = solve_route(V, route);
  if (route < 0) return (int)cudaErrorInvalidValue;
  if (route == R_WARP) {
    switch (V) {
      case 1: return launch_warp_solve<1>(st, a);
      case 2: return launch_warp_solve<2>(st, a);
      case 3: return launch_warp_solve<3>(st, a);
      case 4: return launch_warp_solve<4>(st, a);
      default: return launch_warp_solve<5>(st, a);
    }
  }
  if (osfm_camera_solve_scratch_floats(V, route) > 0 && !gscratch)
    return (int)cudaErrorInvalidValue;
  if (route == R_GRID) return launch_grid_solve(st, a, gscratch);
  const SolvePlan p = solve_plan(V);
  if (route == R_CLUSTER)
    return p.global ? launch_cluster_solve<true>(p, st, a, gscratch)
                    : launch_cluster_solve<false>(p, st, a, nullptr);
  if (p.nt == 256) return launch_camera_solve<256>(p.smem, st, a);
  return launch_camera_solve<512>(p.smem, st, a);
}

// Floats of the global tables K2 needs for V cameras with the point pass
// (0 when its tables fit in shared memory for every call).
int osfm_k2_table_floats(int V) {
  return fits_smem((const void*)point_update_cost_kernel, k2_dyn_smem(V, true))
             ? 0 : V * (TAB_CAND + TAB_CUR);
}

// K2 with its accept tail over ceil(T / 32) CTAs of `warps` warps. cost_part
// holds one float per CTA; ticket is a device counter that is 0 before the
// first launch (each launch leaves it 0). state_in null: the initial cost;
// state_out null: no rule; cost_out (split mode): the summed cost. gtab:
// osfm_k2_table_floats(V) floats, or null when that is 0; where this call's
// tables do not fit in shared memory k2_tables builds them there first.
int osfm_point_update_cost(int quat, float* pT_a, float* pT_b, const float* obsT,
                           const float* maskT, const float* rot_a, const float* rot_b,
                           const float* camp_a, const float* camp_b, const float* free,
                           const float* state_in, const float* delta, float huber,
                           int update_points, int V, int T, int warps, float* gtab,
                           float* state_out, float* cost_part, unsigned int* ticket,
                           float* cost_out, float lam0, float func_tol, float lam_up,
                           float lam_down, float min_lam, float max_lam, void* stream) {
  if (warps < 1 || warps > K2_MAXW) return (int)cudaErrorInvalidValue;
  if (cost_out && state_out) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool upd = update_points && state_in;
  const size_t smem = k2_dyn_smem(V, upd);
  const bool global = !fits_smem((const void*)point_update_cost_kernel, smem);
  if (global && !gtab) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (global) {
    k2_tables_kernel<<<(V + 127) / 128, 128, 0, st>>>(quat, rot_a, rot_b, camp_a, camp_b, free,
                                                     state_in, delta, update_points, V, gtab);
    err = (int)cudaGetLastError();
  } else {
    err = allow_smem((const void*)point_update_cost_kernel);
  }
  if (err) return err;
  const LMRule rule = {lam0, func_tol, lam_up, lam_down, min_lam, max_lam};
  point_update_cost_kernel<<<(T + K2_TRACKS - 1) / K2_TRACKS, 32 * warps, global ? 0 : smem,
                             st>>>(quat, pT_a, pT_b, obsT, maskT, rot_a, rot_b, camp_a, camp_b,
                                   free, state_in, delta, huber, update_points, V, T,
                                   global ? gtab : nullptr, state_out, cost_part, ticket,
                                   cost_out, rule);
  return (int)cudaGetLastError();
}

// K4 lm_accept: one thread applies the rule to the cost at cost[0] (the
// cost summed over the shards) and state_in (null: the first state), into
// state_out.
int osfm_lm_accept(const float* state_in, const float* cost, float* state_out, float lam0,
                   float func_tol, float lam_up, float lam_down, float min_lam, float max_lam,
                   void* stream) {
  const LMRule rule = {lam0, func_tol, lam_up, lam_down, min_lam, max_lam};
  lm_accept_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(state_in, cost, state_out,
                                                                    rule);
  return (int)cudaGetLastError();
}

#ifdef OSFM_FUSED_TIMING
// The timing build's stamp buffer for the next osfm_lm_fused launches:
// FUSED_STAMP_HEAD + FUSED_STAMP_SLOTS * max_iters zeroed 64-bit words.
static unsigned long long* fused_stamps = nullptr;
int osfm_lm_fused_stamps(void* stamps) {
  fused_stamps = static_cast<unsigned long long*>(stamps);
  return 0;
}
#endif

// The CTAs of lm_fused's grid at V views with K2 in groups of `warps` warps
// (ba_kernels.py _k2_warps); 0 where lm_fused cannot serve V views.
int osfm_lm_fused_grid(int V, int warps) { return fused_plan(V, warps).grid; }

// The whole LM solve in one cooperative launch (lm_fused): the initial cost,
// then up to max_iters iterations of K1, K3 and K2 with its accept rule on
// the LM buffers (two halves each, state[CUR] = 0 at the start), stopping
// at the done flag; the final scalar state into state_out (STATE_SIZE
// floats). K1's geometry (ldx, n_chunks, n_split, cps) and scratch (Xk, Yk,
// counts, vpart, Ppart), the system (S, dU, rhs), delta (6V) and K2's cost
// partials (ceil(T / 32)) are as the per-iteration launches take them.
// From 38 views the launch is cooperative and in clusters of CL_C, the
// camera solve on the first; from GRID_MIN_V a plain cooperative launch of
// one CTA a SM (not trimmed to the other stages' work: the grid route uses
// every CTA), its camera solve the grid route on all of them, from gscratch
// (osfm_camera_solve_scratch_floats(V, R_GRID) floats; null below
// GRID_MIN_V). Where lm_fused cannot serve V views it returns
// cudaErrorCooperativeLaunchTooLarge and launches nothing; a refused launch
// returns the runtime's error.
int osfm_lm_fused(int quat, float* pT_a, float* pT_b, const float* obsT, const float* maskT,
                  float* rot_a, float* rot_b, float* camp_a, float* camp_b, const float* free,
                  float huber, int opt, int V, int T, int ldx, int n_chunks, int n_split,
                  int cps, int warps, int max_iters, float* Xk, float* Yk, int* counts,
                  float* vpart, float* Ppart, float* S, float* dU, float* rhs, float* delta,
                  float* cost_part, float* gscratch, float* state_out, float lam0,
                  float func_tol, float lam_up, float lam_down, float min_lam, float max_lam,
                  void* stream) {
  if (T < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const FusedPlan f = fused_plan(V, warps);
  if (f.grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (f.route == R_GRID && !gscratch) return (int)cudaErrorInvalidValue;
  const bool cluster = f.route == R_CLUSTER;
  // below the grid route, no more CTAs than the stage with the most work
  // items can use (whole clusters, and at least the one the camera solve
  // runs on)
  const int n = 6 * V, nt = ldx / PT, items = (T + K2_TRACKS - 1) / K2_TRACKS;
  const size_t lanes = ((size_t)n * n + 2 * (size_t)n) * RL;
  const int groups = (FUSED_NT / 32) / warps;
  int need = (n_chunks + FUSED_BLK_GROUPS - 1) / FUSED_BLK_GROUPS;
  if (opt) {
    const int p = (nt * (nt + 1) / 2 * n_split + FUSED_PROD_GROUPS - 1) / FUSED_PROD_GROUPS;
    need = p > need ? p : need;
  }
  const int r = (int)((lanes + FUSED_NT - 1) / FUSED_NT), k = (items + groups - 1) / groups;
  need = r > need ? r : need;
  need = k > need ? k : need;
  if (cluster) need = ((need + CL_C - 1) / CL_C) * CL_C;
  const int grid = f.route == R_GRID || need >= f.grid ? f.grid : need;
  int G = 1;  // K1's lanes per track, as osfm_schur_assemble's
  while (G < V && G < 32) G *= 2;
  const FusedArgs a = {quat, pT_a, pT_b, obsT, maskT, rot_a, rot_b, camp_a, camp_b, free,
                       huber, opt, V, T, G, ldx, n_chunks, n_split, cps, warps, max_iters,
                       Xk, Yk, counts, vpart, Ppart, S, dU, rhs, delta, cost_part, state_out,
                       {lam0, func_tol, lam_up, lam_down, min_lam, max_lam}, f.route,
                       f.route == R_GRID ? gscratch : nullptr
#ifdef OSFM_FUSED_TIMING
                       , fused_stamps
#endif
  };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (cluster) {  // a cooperative launch in clusters of CL_C
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL_C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(FUSED_NT);
    cfg.dynamicSmemBytes = f.smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    err = (int)cudaLaunchKernelEx(&cfg, lm_fused_kernel<false>, a);
  } else {
    void* args[] = {const_cast<FusedArgs*>(&a)};
    const void* fn = f.route == R_GRID ? (const void*)lm_fused_kernel<true>
                                        : (const void*)lm_fused_kernel<false>;
    err = (int)cudaLaunchCooperativeKernel(fn, dim3(grid),
                                           dim3(FUSED_NT), args, f.smem, st);
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
