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
//                            same panels on a cluster of 8 CTAs above
//   K2 point_update_cost  <- ba_pallas.py point_update_cost (+ ba_fused.py pass 2)
//                            and, in its last CTA, ba_fused.py accept /
//                            lambda / done (:457-474), the rule of K4
//                            lm_accept
//
// The arithmetic is f32 SIMT FMA throughout: no tensor cores, so no TF32.
// The per-observation math (ba_pallas.py _tile_blocks, _point_block_inv,
// _couplings, _inv3x3_rows) is written once, as the __device__ functions
// below, and shared by K1 and K2.
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
  const float* __restrict__ pT = cur ? pT_b : pT_a;
  extern __shared__ float smem[];
  constexpr int NW = BLK_NT / 32;
  constexpr int STAGE = 2 * 3 * 192;  // floats of a warp's staging area
  Cam* scams = reinterpret_cast<Cam*>(smem);
  const Cam* cams = gcams ? gcams : scams;
  // [V][NU], the chunk's sums
  float* usum = gcams ? vpart + (size_t)blockIdx.x * V * NU : reinterpret_cast<float*>(scams + V);
  __shared__ int slot[TC];
  __shared__ int s_count;
  // per warp: its groups' tracks (slots); its X, Y slices ([2][3][192]),
  // staged for coalesced stores of the scratch rows, then its per-view sums
  // ([G][NU]) for the sum over warps
  __shared__ int wslot[NW][32];
  __shared__ __align__(16) float stage[NW][STAGE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gl = tid & (G - 1);  // lane within the track's group
  const int grp = tid / G;
  const int c = blockIdx.x, t0 = c * TC;
  const float lam = state[LAM];

  __shared__ int seen[TC];
  if (!gcams)
    for (int v = tid; v < V; v += BLK_NT)
      fill_cam(quat, cur ? rot_b : rot_a, cur ? camp_b : camp_a, free, v, scams[v]);
  for (int i = tid; i < V * NU; i += BLK_NT) usum[i] = 0.f;
  if (tid < TC) seen[tid] = 0;
  __syncthreads();
  {  // which of the chunk's tracks have an observation: every thread a few views
    const int k = tid % TC, t = t0 + k;
    int any = 0;
    if (t < T)
      for (int v = tid / TC; v < V; v += BLK_NT / TC) any |= maskT[v * T + t] != 0.f;
    if (any) seen[k] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned bal = __ballot_sync(0xffffffffu, seen[lane] != 0);
    slot[lane] = seen[lane] ? __popc(bal & ((1u << lane) - 1u)) : -1;
    if (lane == 0) {
      s_count = __popc(bal);
      counts[c] = opt ? __popc(bal) : 0;
    }
  }
  __syncthreads();
  const size_t cbase = (size_t)c * 3 * TC;  // first scratch column of the chunk
  if (opt) {  // zero the unused columns of the chunk's last k-tile
    const int count = s_count;
    const size_t k0 = cbase + 3 * count, k1 = cbase + 3 * (((count + KTT - 1) / KTT) * KTT);
    for (size_t i = tid; i < (k1 - k0) * ldx; i += BLK_NT) {
      Xk[k0 * ldx + i] = 0.f;
      Yk[k0 * ldx + i] = 0.f;
    }
  }

  const int per_lane = (V + G - 1) / G;
  for (int k = grp; k - grp < TC; k += BLK_NT / G) {
    const int s = k < TC ? slot[k] : -1;
    const int t = t0 + k;
    const bool live = s >= 0;
    PointPre P;
    float vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gp[3] = {0.f, 0.f, 0.f};
    if (live) {
      const float p4[4] = {pT[t], pT[T + t], pT[2 * T + t], pT[3 * T + t]};
      point_pre(p4, P);
      for (int v = gl; v < V; v += G) {
        if (maskT[v * T + t] == 0.f) continue;
        float r[2], w, Jc[2][6], Jp[2][3];
        const Cam& cv = cams[v];
        obs_block(quat, cv.R9, cv.dS, cv.camp, cv.free, P, obsT[(v * 2) * T + t],
                  obsT[(v * 2 + 1) * T + t], huber, r, w, Jc, Jp);
        add_point_block(w, Jp, r, vt, gp);
      }
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      for (int i = 0; i < 6; ++i) vt[i] += __shfl_xor_sync(0xffffffffu, vt[i], off);
      for (int i = 0; i < 3; ++i) gp[i] += __shfl_xor_sync(0xffffffffu, gp[i], off);
    }
    float Vi[9];
    point_inv(vt, lam, opt, Vi);
    if (gl == 0) wslot[warp][lane / G] = s;

    for (int j = 0; j < per_lane; ++j) {
      const int v = gl + j * G;
      float u[NU];
      for (int e = 0; e < NU; ++e) u[e] = 0.f;
      float X[6][3], Y[6][3];
      for (int a = 0; a < 6; ++a)
        for (int q = 0; q < 3; ++q) X[a][q] = Y[a][q] = 0.f;
      if (live && v < V) {
        if (maskT[v * T + t] != 0.f) {
          float r[2], w, Jc[2][6], Jp[2][3];
          const Cam& cv = cams[v];
          obs_block(quat, cv.R9, cv.dS, cv.camp, cv.free, P, obsT[(v * 2) * T + t],
                    obsT[(v * 2 + 1) * T + t], huber, r, w, Jc, Jp);
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
            stage[warp][q * 192 + gw * G * 6 + gl * 6 + a] = X[a][q];
            stage[warp][(3 + q) * 192 + gw * G * 6 + gl * 6 + a] = Y[a][q];
          }
        __syncwarp();
        for (int e = lane; e < 192; e += 32) {
          const int g2 = e / (G * 6), off = e % (G * 6), s2 = wslot[warp][g2];
          if (s2 < 0 || base + off >= 6 * V) continue;
          for (int q = 0; q < 3; ++q) {
            const size_t at = (cbase + 3 * s2 + q) * ldx + base + off;
            Xk[at] = stage[warp][q * 192 + e];
            Yk[at] = stage[warp][(3 + q) * 192 + e];
          }
        }
        __syncwarp();
      }
      // the groups of a warp that hold the same view, then the warps' sums
      // in turn (every warp's lanes gl hold views jG + gl)
      for (int off = G; off < 32; off <<= 1)
        for (int e = 0; e < NU; ++e) u[e] += __shfl_xor_sync(0xffffffffu, u[e], off);
      if (lane < G)
        for (int e = 0; e < NU; ++e) stage[warp][lane * NU + e] = u[e];
      __syncthreads();
      for (int i = tid; i < G * NU && j * G * NU + i < V * NU; i += BLK_NT) {
        float s = usum[j * G * NU + i];
        for (int w = 0; w < NW; ++w) s += stage[w][i];
        usum[j * G * NU + i] = s;
      }
      __syncthreads();
    }
  }
  if (!gcams)
    for (int i = tid; i < V * NU; i += BLK_NT) vpart[(size_t)c * V * NU + i] = usum[i];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
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

__global__ void __launch_bounds__(PROD_NT) schur_product_kernel(
    const float* __restrict__ state, int ldx, int n_chunks, int cps,
    const int* __restrict__ counts, const float* __restrict__ Xk, const float* __restrict__ Yk,
    float* __restrict__ Ppart) {
  if (state[DONE] != 0.f) return;
  __shared__ __align__(16) float Xs[2][KT3][PT];
  __shared__ __align__(16) float Ys[2][KT3][PT];
  const int nt = ldx / PT;
  int ti = 0, u = blockIdx.x;
  while (u >= nt - ti) {
    u -= nt - ti;
    ++ti;
  }
  const int r0 = ti * PT, c0 = (ti + u) * PT;
  const int c_end = min(n_chunks, (int)(blockIdx.y + 1) * cps);
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;

  auto load = [&](int buf, int c, int kt) {
    const size_t col0 = (size_t)c * 3 * TC + kt * KT3;
    for (int i = tid; i < KT3 * (PT / 4); i += PROD_NT) {
      const int kk = i / (PT / 4), q4 = (i % (PT / 4)) * 4;
      cp_async16(&Xs[buf][kk][q4], Xk + (col0 + kk) * ldx + r0 + q4);
      cp_async16(&Ys[buf][kk][q4], Yk + (col0 + kk) * ldx + c0 + q4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int c = blockIdx.y * cps, kt = -1;
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
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT3; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
    buf ^= 1;
    c = cn;
    kt = ktn;
    have = more;
  }
  float* P = Ppart + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * PT * PT;
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&P[(ty * 4 + i) * PT + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

// Item i of the first n * n: S'(i / n, i % n) and its mirror, for i / n <=
// i % n (blkdiag(U) minus the product's partials); then rhs, then diag(U).
// Every lane of a warp reaches the shuffles; idle groups add zeros.
__global__ void __launch_bounds__(NT) schur_reduce_kernel(
    const float* __restrict__ state, int V, int ldx, int n_split, int n_chunks,
    const float* __restrict__ Ppart, const float* __restrict__ vpart, float* __restrict__ S,
    float* __restrict__ dU, float* __restrict__ rhs) {
  if (state[DONE] != 0.f) return;
  const int n = 6 * V, nt = ldx / PT, n_tiles = nt * (nt + 1) / 2;
  const int item = (blockIdx.x * NT + threadIdx.x) / RL, sub = threadIdx.x % RL;
  const bool is_s = item < n * n;
  int i = 0, j = 0, e = -1;  // e: the per-view sum this item needs, if any
  bool live = item < n * n + 2 * n;
  if (live && is_s) {
    i = item / n;
    j = item % n;
    live = i <= j;
    if (i / 6 == j / 6) e = upper6(i % 6, j % 6);
  } else if (live) {
    i = j = (item - n * n) % n;
    e = item - n * n < n ? 21 + i % 6 : upper6(i % 6, i % 6);
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
    (item - n * n < n ? rhs : dU)[i] = u;
  }
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

template <int V>
__global__ void __launch_bounds__(32) camera_solve_warp_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    float* __restrict__ delta) {
  constexpr int N = 6 * V;
  __shared__ float Ls[N][N + 1];
  __shared__ float ds[32];
  const int i = threadIdx.x;
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
  if (state[DONE] != 0.f) return;

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

template <int NT>
__global__ void __launch_bounds__(NT) camera_solve_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    int V, float* __restrict__ delta) {
  const int n = 6 * V, N = n + 1, ld = round4(N);
  extern __shared__ __align__(16) float solve_smem[];
  float* rds = solve_smem;            // [n]       1 / Jacobi scale
  float* fr = rds + round4(n);        // [n]       free mask
  float* dmp = fr + round4(n);        // [n]       LM damping of the diagonal
  float* xs = dmp + round4(n);        // [n]       y, then the solution
  float* inv = xs + round4(n);        // [n]       1 / L_ii
  float* dg = inv + round4(n);        // [PW][DS]  the panel's diagonal block
  float* dgi = dg + round4(PW * DS);  // [PW]      1 / its diagonal (1 past kb)
  float* pan = dgi + PW;              // [N + 3][PS] the panel's rows below its block
  float* A = pan + (n + 4) * PS;      // [N][ld]   the lower triangle
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __shared__ int s_failed;  // a pivot was not positive
  const float lam = state[LAM];
  if (state[DONE] != 0.f) return;
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
  const int n4 = n * n / 4;
  for (int e0 = tid; e0 < n4; e0 += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = e0 + q * NT;
      v[q] = e < n4 ? S4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = e0 + q * NT;
      if (e >= n4) continue;
      int r = (4 * e) / n, j = 4 * e - r * n;
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

template <bool G>
__global__ void __launch_bounds__(CL_NT) camera_solve_cluster_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, float* rot_a, float* rot_b, float* camp_a, float* camp_b,
    int V, size_t rows_max, float* gscratch, float* __restrict__ delta) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = 6 * V, N = n + 1, nblk = (N + RB - 1) / RB, npan = (n + PW - 1) / PW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) float cl_smem[];
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
  if (state[DONE] != 0.f) return;  // the same for every CTA of the cluster
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

// The camera solve's launch for V > WARP_SOLVE_V views: the one-CTA kernel
// where its whole matrix fits shared memory (a little kept for static shared
// memory), else the cluster, its rows and panel in shared memory where they
// fit, else in the global scratch (G).
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
// tail). No float atomics: results are bit-stable from run to run.

constexpr int K2_TRACKS = 32;  // tracks per CTA, one a lane
constexpr int K2_MAXW = 16;    // warps per CTA at most
constexpr int NQ = 12;         // per-track sums: point block (6), g_p (3), W^T dc (3)
constexpr int TAB_CAND = 14;   // candidate table: R9 (9), camp[0..4] (5)
constexpr int TAB_CUR = 38;    // current table: R9, camp[0..4], dS rows (18), dc * free (6)

// The LM schedule constants of the accept rule.
struct LMRule {
  float lam0, func_tol, lam_up, lam_down, min_lam, max_lam;
};

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
    m = maskT[v * T + t];
    ox = obsT[(v * 2) * T + t];
    oy = obsT[(v * 2 + 1) * T + t];
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

// gtab null: the per-view tables in shared memory, built by every CTA; else
// read from gtab (k2_tables).
__global__ void __launch_bounds__(K2_MAXW * 32) point_update_cost_kernel(
    int quat, float* pT_a, float* pT_b, const float* __restrict__ obsT,
    const float* __restrict__ maskT, const float* rot_a, const float* rot_b,
    const float* camp_a, const float* camp_b, const float* __restrict__ free,
    const float* __restrict__ state_in, const float* __restrict__ delta, float huber,
    int update_points, int V, int T, const float* __restrict__ gtab,
    float* __restrict__ state_out, float* __restrict__ cost_part,
    unsigned int* __restrict__ ticket, LMRule rule) {
  extern __shared__ float k2_smem[];
  __shared__ float sums[K2_MAXW][NQ][K2_TRACKS];
  __shared__ float p3s[3][K2_TRACKS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int t = blockIdx.x * K2_TRACKS + lane;
  const bool live = t < T;
  const int tc = live ? t : T - 1;  // a column the idle lanes may load
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
    ph[0][j] = pT_a[j * T + tc];
    ph[1][j] = pT_b[j * T + tc];
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
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        for (int w2 = 1; w2 < nw; ++w2) q[i] += sums[w2][i][lane];  // q holds warp 0's
      float Vi[9], tmp[3], dp[3], pn[4], nrm2 = 0.f;
      point_inv(q, st[LAM], 1, Vi);
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
        for (int j = 0; j < 4; ++j) p_out[j * T + t] = pn[j];
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
  __syncthreads();

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
  __syncthreads();
  if (warp != 0) return;
  for (int w2 = 1; w2 < nw; ++w2) rho += sums[w2][0][lane];
  for (int off = 16; off > 0; off >>= 1) rho += __shfl_xor_sync(FULL, rho, off);
  if (lane == 0) cost_part[blockIdx.x] = 0.5f * rho;
  if (!state_out) return;

  // The accept tail, in the CTA that takes the last ticket.
  unsigned int last = 0;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  float s = 0.f;
#pragma unroll 8
  for (int i = lane; i < (int)gridDim.x; i += 32) s += __ldcg(cost_part + i);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane != 0) return;
  *ticket = 0u;
  float out[STATE_SIZE] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (init) {
    out[LAM] = rule.lam0;
    out[COST] = s;
    out[INIT_COST] = s;
  } else {
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
    out[CUR] = acc != cur ? 1.f : 0.f;
  }
#pragma unroll
  for (int i = 0; i < STATE_SIZE; ++i) state_out[i] = out[i];
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

template <int V>
int launch_warp_solve(cudaStream_t st, const SolveArgs& a) {
  camera_solve_warp_kernel<V><<<1, 32, 0, st>>>(a.quat, a.S, a.dU, a.rhs, a.free, a.state,
                                                a.rot_a, a.rot_b, a.camp_a, a.camp_b, a.delta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the global scratch buffer the camera solve needs for V cameras
// (0 when its rows and panel fit in shared memory).
int osfm_camera_solve_scratch_floats(int V) {
  return V <= WARP_SOLVE_V ? 0 : (int)solve_plan(V).scratch;
}

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
  const int blocks = ((n * n + 2 * n) * RL + NT - 1) / NT;
  schur_reduce_kernel<<<blocks, NT, 0, st>>>(state, V, ldx, opt ? n_split : 0, n_chunks, Ppart,
                                             vpart, S, dU, rhs);
  return (int)cudaGetLastError();
}

// Reads the cameras of the half state[CUR] names and writes the candidate
// into the other (with state[CUR] = 0: reads rot_a, camp_a, writes rot_b,
// camp_b).
int osfm_camera_solve(int quat, const float* S, const float* dU, const float* rhs,
                      const float* free, const float* state, float* rot_a, float* rot_b,
                      float* camp_a, float* camp_b, int V, float* gscratch, float* delta,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const SolveArgs a = {quat, S, dU, rhs, free, state, rot_a, rot_b, camp_a, camp_b, V, delta};
  switch (V) {
    case 1: return launch_warp_solve<1>(st, a);
    case 2: return launch_warp_solve<2>(st, a);
    case 3: return launch_warp_solve<3>(st, a);
    case 4: return launch_warp_solve<4>(st, a);
    case 5: return launch_warp_solve<5>(st, a);
    default: break;
  }
  const SolvePlan p = solve_plan(V);
  if (p.global && !gscratch) return (int)cudaErrorInvalidValue;
  if (own_blocks(0, (6 * V + RB) / RB) * 4 > CL_RT) return (int)cudaErrorInvalidValue;
  if (p.cluster)
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
// state_out null: no tail. gtab: osfm_k2_table_floats(V) floats, or null
// when that is 0; where this call's tables do not fit in shared memory
// k2_tables builds them there first.
int osfm_point_update_cost(int quat, float* pT_a, float* pT_b, const float* obsT,
                           const float* maskT, const float* rot_a, const float* rot_b,
                           const float* camp_a, const float* camp_b, const float* free,
                           const float* state_in, const float* delta, float huber,
                           int update_points, int V, int T, int warps, float* gtab,
                           float* state_out, float* cost_part, unsigned int* ticket, float lam0,
                           float func_tol, float lam_up, float lam_down, float min_lam,
                           float max_lam, void* stream) {
  if (warps < 1 || warps > K2_MAXW) return (int)cudaErrorInvalidValue;
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
                                   global ? gtab : nullptr, state_out, cost_part, ticket, rule);
  return (int)cudaGetLastError();
}

}  // extern "C"
