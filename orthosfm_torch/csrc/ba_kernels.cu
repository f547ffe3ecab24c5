// Hand-written Hopper (sm_90a) kernels for the robust Levenberg-Marquardt
// bundle adjustment of orthosfm_torch/solvers/ba.py. Plain C interface,
// loaded with ctypes by orthosfm_torch/solvers/ba_kernels.py, which also
// holds the plain PyTorch version of every kernel.
//
// One LM iteration is four kernels, launched back to back on one stream with
// no host sync; a device `done` flag (state[DONE]) makes the iterations after
// convergence return at once (the analog of the cond-guarded body of the
// JAX package's fused kernel, orthosfm_tpu/solvers/ba_fused.py:476-477):
//
//   K1 schur_assemble     <- ba_pallas.py normal_eq_schur (+ ba_fused.py pass 1)
//   K3 camera_solve       <- ba_fused.py _gauss_jordan + the in-kernel reduced
//                            system and camera retraction (:369-407)
//   K2 point_update_cost  <- ba_pallas.py point_update_cost (+ ba_fused.py pass 2)
//   K4 lm_accept          <- ba_fused.py accept / lambda / done (:457-474)
//
// The arithmetic is f32 SIMT FMA throughout: no tensor cores, so no TF32.
// The per-observation math (ba_pallas.py _tile_blocks, _point_block_inv,
// _couplings, _inv3x3_rows) is written once, as the __device__ functions
// below, and shared by K1 and K2.
//
// Scalar LM state: float[STATE_SIZE] = [lambda, cost, iterations, done,
// initial cost, 0, 0, 0]. Iteration i reads slot i%2 and K4 writes slot
// (i+1)%2, so no CTA ever reads a scalar that another CTA is overwriting.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LAM = 0, COST = 1, ITERS = 2, DONE = 3, INIT_COST = 4, STATE_SIZE = 8;

constexpr int NT = 256;         // threads per CTA (K1, K2, K4)
constexpr int TS = 32;          // edge of the output tile of the Schur sum (K1)
constexpr int KT = 16;          // tracks staged per step in K1
constexpr int LANES = NT / KT;  // threads sharing one track in K1's point pass
constexpr int XS = 3 * KT + 1;  // padded row strides of K1's staging arrays
constexpr int ZS = 2 * KT + 1;
constexpr int SOLVE_NT = 1024;  // threads per CTA of the camera solve (K3)
constexpr int SOLVE_MAX_CLUSTER = 8;              // CTAs of K3's cluster, at most
constexpr size_t SOLVE_SMEM_TARGET = 100 * 1024;  // shared bytes per K3 CTA, aimed at
constexpr size_t SMEM_MAX = 227 * 1024;           // shared bytes per CTA, sm_90

// Per-camera tables, built in shared memory by every CTA that needs them.
struct Cam {
  float R9[9];   // R9[b*3+a] = R[b][a], local->world rotation
  float dS[27];  // dS[a*9+k*3+b] = dS[b][a]/d angle_k (Euler; zeros for quat)
  float camp[8]; // [scale, w, h, offx, offy, 0, 0, 0]
  float free[6]; // free tangent slots (1/0)
};

// Quaternion / Euler rotation tables (cameras.rotation_l2w and
// spherical_matrix_derivs; ba_fused.py _r9_from_quat, _r9_ds27_from_euler).
__device__ void cam_tables(int quat, const float* rot, float* R9, float* dS) {
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

__device__ void fill_cams(int quat, const float* rot, const float* camp, const float* free,
                          int V, Cam* cams) {
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    Cam& c = cams[v];
    for (int i = 0; i < 8; ++i) c.camp[i] = camp[v * 8 + i];
    for (int i = 0; i < 6; ++i) c.free[i] = free ? free[v * 6 + i] : 0.f;
    cam_tables(quat, rot + v * 4, c.R9, c.dS);
  }
}

__device__ __forceinline__ float safe_w(float w) {
  return fabsf(w) < 1e-12f ? (w < 0.f ? -1e-12f : 1e-12f) : w;
}

// Per-track point quantities: dehomogenized p3, safe w, the S^3 tangent
// basis B (Householder, e3 -> -+p) and J3B = J3 * B (ba_pallas.py :175-184).
struct PointPre {
  float p4[4], p3[3], sw, B[12], J3B[9];
};

__device__ void point_pre(const float* pT, int T, int t, PointPre& P) {
  for (int i = 0; i < 4; ++i) P.p4[i] = pT[i * T + t];
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

// Pixel projection of p3 through camera c (ba_pallas.py _project_rows).
__device__ __forceinline__ void project(const Cam& c, const float* p3, float local[3],
                                        float pix[2]) {
  for (int a = 0; a < 3; ++a)
    local[a] = c.R9[a] * p3[0] + c.R9[3 + a] * p3[1] + c.R9[6 + a] * p3[2];
  float s = c.camp[0];
  for (int k = 0; k < 2; ++k)
    pix[k] = c.camp[1 + k] * (-(local[k] / s - c.camp[3 + k]) * 0.5f + 0.5f);
}

// Residual, Huber weight and closed-form Jacobians of one observation with
// mask m != 0 (ba_pallas.py _tile_blocks for one (view, track) entry).
__device__ void obs_block(int quat, const Cam& c, const PointPre& P, float ox, float oy,
                          float huber, float r[2], float& w, float Jc[2][6], float Jp[2][3]) {
  float local[3], pix[2];
  project(c, P.p3, local, pix);
  r[0] = pix[0] - ox;
  r[1] = pix[1] - oy;
  float s = c.camp[0];
  float asc[2] = {-c.camp[1] / (2.f * s), -c.camp[2] / (2.f * s)};
  float rn = sqrtf(fmaxf(r[0] * r[0] + r[1] * r[1], 1e-30f));
  w = fminf(1.f, huber / rn);
  const float* R9 = c.R9;
  const float px = P.p3[0], py = P.p3[1], pz = P.p3[2];
  for (int k = 0; k < 2; ++k) {
    float dl[3];
    if (quat) {
      dl[0] = R9[3 + k] * pz - R9[6 + k] * py;
      dl[1] = -R9[k] * pz + R9[6 + k] * px;
      dl[2] = R9[k] * py - R9[3 + k] * px;
    } else {
      float Cp[3] = {px, -pz, py};
      for (int j = 0; j < 3; ++j)
        dl[j] = c.dS[k * 9 + j * 3 + 0] * Cp[0] + c.dS[k * 9 + j * 3 + 1] * Cp[1] +
                c.dS[k * 9 + j * 3 + 2] * Cp[2];
    }
    for (int j = 0; j < 3; ++j) Jc[k][j] = asc[k] * dl[j];
    Jc[k][3 + k] = c.camp[1 + k] * 0.5f;
    Jc[k][4 - k] = 0.f;
    Jc[k][5] = -asc[k] * local[k] / s;
    for (int j = 0; j < 6; ++j) Jc[k][j] *= c.free[j];
    for (int q = 0; q < 3; ++q)
      Jp[k][q] = asc[k] * (R9[k] * P.J3B[q] + R9[3 + k] * P.J3B[3 + q] + R9[6 + k] * P.J3B[6 + q]);
  }
}

// Accumulate one observation into the point block Vt (upper triangle
// 00,01,02,11,12,22) and the point gradient g_p = -sum w Jp^T r.
__device__ __forceinline__ void add_point_block(float w, const float Jp[2][3], const float r[2],
                                                float vt[6], float gp[3]) {
  for (int k = 0; k < 2; ++k) {
    float a = w * Jp[k][0], b = w * Jp[k][1], cc = w * Jp[k][2];
    vt[0] += a * Jp[k][0]; vt[1] += a * Jp[k][1]; vt[2] += a * Jp[k][2];
    vt[3] += b * Jp[k][1]; vt[4] += b * Jp[k][2]; vt[5] += cc * Jp[k][2];
    gp[0] -= a * r[k]; gp[1] -= b * r[k]; gp[2] -= cc * r[k];
  }
}

// Inverse of the LM-damped 3x3 point block (ba_pallas.py _point_block_inv +
// _inv3x3_rows); zeros when points are held fixed.
__device__ void point_inv(const float vt[6], float lam, int opt, float Vi[9]) {
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
// Bound: the Schur cross term sum_t W V^-1 W^T is a rank-3 update of the
// dense n x n system (n = 6V) per track, 3n^2 FMA per track (27.6 kFMA at
// V=16), so K1 is FMA-bound; the inputs (4+3V floats per track) are read
// from L2. Design: the grid is (track chunks) x (32x32 output tiles of the
// system in block-major (view*6+param) order). A CTA stages 16 tracks at a
// time: a point pass (16 threads per track, shuffled sums over views) builds
// V^-1 and g_p; an observation pass writes W V^-1 rows for the tile's rows,
// W rows for its columns, sqrt(w) Jc for the block-diagonal U, and the rhs /
// diag(U) terms into shared memory; then each thread accumulates 4 entries of
// the tile in registers. Each CTA writes its partial tile; schur_reduce sums
// the partials in chunk order, so results are bit-stable (no float atomics).
// Ragged T and ragged tiles are masked, not padded.
__global__ void __launch_bounds__(NT) schur_assemble_kernel(
    int quat, const float* __restrict__ pT, const float* __restrict__ obsT,
    const float* __restrict__ maskT, const float* __restrict__ rot,
    const float* __restrict__ camp, const float* __restrict__ free,
    const float* __restrict__ state, float huber, int opt, int V, int T, int chunk,
    float* __restrict__ Spart, float* __restrict__ vpart) {
  if (state[DONE] != 0.f) return;
  extern __shared__ float smem[];
  const int n = 6 * V;
  const int ntile = (n + TS - 1) / TS;
  const int ty = blockIdx.y / ntile, tx = blockIdx.y % ntile;
  const int r0 = ty * TS, c0 = tx * TS;
  const int tid = threadIdx.x;
  const float lam = state[LAM];

  Cam* cams = reinterpret_cast<Cam*>(smem);
  float* Xs = reinterpret_cast<float*>(cams + V);  // [TS][XS]  W V^-1 rows
  float* Ys = Xs + TS * XS;                        // [TS][XS]  W rows
  float* Zr = Ys + TS * XS;                        // [TS][ZS]  sqrt(w) Jc, rows
  float* Zc = Zr + TS * ZS;                        // [TS][ZS]  sqrt(w) Jc, cols
  float* Gs = Zc + TS * ZS;                        // [TS][KT]  rhs terms
  float* Ds = Gs + TS * KT;                        // [TS][KT]  diag(U) terms
  float* Vis = Ds + TS * KT;                       // [KT][9]   V^-1
  float* Gps = Vis + KT * 9;                       // [KT][3]   g_p
  const int stage_floats = TS * (2 * XS + 2 * ZS + 2 * KT);

  fill_cams(quat, rot, camp, free, V, cams);

  const int vr0 = r0 / 6, vr1 = min(V - 1, (min(r0 + TS, n) - 1) / 6);
  const int vc0 = c0 / 6, vc1 = min(V - 1, (min(c0 + TS, n) - 1) / 6);
  const int nvr = vr1 - vr0 + 1, nvc = vc1 - vc0 + 1;

  const int ei = tid >> 3;          // tile row owned by this thread
  const int ej0 = (tid & 7) * 4;    // first of its 4 tile columns
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float accv = 0.f;                 // rhs (tid < TS) / diag(U) (TS <= tid < 2 TS), tx == 0
  const int t_begin = blockIdx.x * chunk;
  const int t_end = min(T, t_begin + chunk);
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += KT) {
    for (int i = tid; i < stage_floats; i += NT) Xs[i] = 0.f;

    // Point pass: LANES threads per track, each over views lane, lane+LANES, ...
    {
      const int k = tid / LANES, lane = tid % LANES;
      const int t = t0 + k;
      float vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gp[3] = {0.f, 0.f, 0.f};
      if (t < t_end) {
        PointPre P;
        point_pre(pT, T, t, P);
        for (int v = lane; v < V; v += LANES) {
          if (maskT[v * T + t] == 0.f) continue;
          float r[2], w, Jc[2][6], Jp[2][3];
          obs_block(quat, cams[v], P, obsT[(v * 2) * T + t], obsT[(v * 2 + 1) * T + t], huber,
                    r, w, Jc, Jp);
          add_point_block(w, Jp, r, vt, gp);
        }
      }
      for (int off = LANES / 2; off > 0; off >>= 1) {
        for (int i = 0; i < 6; ++i) vt[i] += __shfl_xor_sync(0xffffffffu, vt[i], off);
        for (int i = 0; i < 3; ++i) gp[i] += __shfl_xor_sync(0xffffffffu, gp[i], off);
      }
      if (lane == 0) {
        point_inv(vt, lam, opt, Vis + k * 9);
        for (int i = 0; i < 3; ++i) Gps[k * 3 + i] = gp[i];
      }
    }
    __syncthreads();

    // Observation pass: one (track, view) entry per item, for the views of
    // the tile's rows and of its columns.
    const int items = KT * (nvr + nvc);
    for (int it = tid; it < items; it += NT) {
      const int k = it % KT, vv = it / KT;
      const bool isrow = vv < nvr;
      const int v = isrow ? vr0 + vv : vc0 + (vv - nvr);
      const int t = t0 + k;
      if (t >= t_end || maskT[v * T + t] == 0.f) continue;
      PointPre P;
      point_pre(pT, T, t, P);
      float r[2], w, Jc[2][6], Jp[2][3];
      obs_block(quat, cams[v], P, obsT[(v * 2) * T + t], obsT[(v * 2 + 1) * T + t], huber, r,
                w, Jc, Jp);
      const float sqw = sqrtf(w);
      const float* Vi = Vis + k * 9;
      const float* gpk = Gps + k * 3;
      const int base = isrow ? r0 : c0;
      for (int a = 0; a < 6; ++a) {
        const int row = v * 6 + a - base;
        if (row < 0 || row >= TS) continue;
        float Wc[3];
        for (int q = 0; q < 3; ++q) Wc[q] = w * (Jc[0][a] * Jp[0][q] + Jc[1][a] * Jp[1][q]);
        if (isrow) {
          float wvi[3];
          for (int q = 0; q < 3; ++q)
            wvi[q] = Wc[0] * Vi[0 * 3 + q] + Wc[1] * Vi[1 * 3 + q] + Wc[2] * Vi[2 * 3 + q];
          for (int q = 0; q < 3; ++q) Xs[row * XS + k * 3 + q] = wvi[q];
          Zr[row * ZS + k * 2 + 0] = sqw * Jc[0][a];
          Zr[row * ZS + k * 2 + 1] = sqw * Jc[1][a];
          if (tx == 0) {
            Gs[row * KT + k] = -w * (Jc[0][a] * r[0] + Jc[1][a] * r[1]) -
                               (wvi[0] * gpk[0] + wvi[1] * gpk[1] + wvi[2] * gpk[2]);
            Ds[row * KT + k] = w * (Jc[0][a] * Jc[0][a] + Jc[1][a] * Jc[1][a]);
          }
        } else {
          for (int q = 0; q < 3; ++q) Ys[row * XS + k * 3 + q] = Wc[q];
          Zc[row * ZS + k * 2 + 0] = sqw * Jc[0][a];
          Zc[row * ZS + k * 2 + 1] = sqw * Jc[1][a];
        }
      }
    }
    __syncthreads();

    // Tile accumulation: S' += blkdiag(U) - (W V^-1) W^T over the staged tracks.
    for (int e = 0; e < 4; ++e) {
      const int j = ej0 + e;
      float s = 0.f;
      for (int d = 0; d < 3 * KT; ++d) s += Xs[ei * XS + d] * Ys[j * XS + d];
      float u = 0.f;
      if ((r0 + ei) / 6 == (c0 + j) / 6)
        for (int d = 0; d < 2 * KT; ++d) u += Zr[ei * ZS + d] * Zc[j * ZS + d];
      acc[e] += u - s;
    }
    if (tx == 0 && tid < 2 * TS) {
      const float* src = tid < TS ? Gs : Ds;
      const int row = tid % TS;
      for (int k = 0; k < KT; ++k) accv += src[row * KT + k];
    }
    __syncthreads();
  }

  float* Sp = Spart + (size_t)blockIdx.x * n * n;
  for (int e = 0; e < 4; ++e) {
    const int i = r0 + ei, j = c0 + ej0 + e;
    if (i < n && j < n) Sp[(size_t)i * n + j] = acc[e];
  }
  if (tx == 0 && tid < 2 * TS) {
    const int row = r0 + tid % TS;
    if (row < n) vpart[((size_t)blockIdx.x * 2 + tid / TS) * n + row] = accv;
  }
}

// Second launch of K1: sums the per-chunk partials in chunk order.
__global__ void schur_reduce_kernel(const float* __restrict__ state, int n, int n_chunks,
                                    const float* __restrict__ Spart,
                                    const float* __restrict__ vpart, float* __restrict__ S,
                                    float* __restrict__ dU, float* __restrict__ rhs) {
  if (state[DONE] != 0.f) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int nn = n * n;
  if (idx < nn) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += Spart[(size_t)c * nn + idx];
    S[idx] = s;
  } else if (idx < nn + 2 * n) {
    const int which = (idx - nn) / n, row = (idx - nn) % n;
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += vpart[((size_t)c * 2 + which) * n + row];
    (which == 0 ? rhs : dU)[row] = s;
  }
}

// ---------------------------------------------------------------------------
// K3: camera_solve — replaces the reduced camera system, _gauss_jordan and
// the camera retraction of ba_fused.py run_lm (:369-407, :199-226).
//
// Bound: n sequential elimination steps, each a rank-1 update of the n x
// (n+1) augmented matrix that must finish before the next step can start.
// At n = 96 the barriers of the steps (latency) set the time; at n = 384 the
// matrix (590 KB) no longer fits one SM, and a single CTA streaming it
// through L2 is bound by that SM's L2 bandwidth. Design: Gauss-Jordan
// without row scaling (each row i != k subtracts (a_ik / a_kk) row k, and
// x_i = a_in / a_ii at the end), so the pivot row is only read during its
// step and a single CTA needs one block barrier per step. A thread-block
// cluster of C CTAs (C = 1..8, chosen by solve_plan) splits the rows into
// contiguous blocks of whole cameras, each block in its CTA's shared memory
// (in a global scratch buffer only past ~110 views, through the same code).
// With C > 1, per step the CTA owning the pivot row publishes a copy in its
// shared memory (double-buffered, so one cluster barrier per step suffices)
// and every CTA copies it over distributed shared memory. Rows are updated
// one warp per row, the lanes along the row (no index division). No
// pivoting: the system is Jacobi-scaled SPD, and pinned parameters are
// identity rows. Each CTA then retracts its own cameras.

// Row i's update at step k, lanes along the row: a_ij -= c a_kj for j > k.
// The two rows never overlap, so several columns' loads can be in flight.
__device__ __forceinline__ void eliminate_row(float* __restrict__ Ai,
                                              const float* __restrict__ Ak, int k, int n,
                                              int lane, float c) {
#pragma unroll 4
  for (int j = k + 1 + lane; j <= n; j += 32) Ai[j] -= c * Ak[j];
}

__device__ __forceinline__ float safe_inv(float p) {
  return 1.f / (fabsf(p) < 1e-30f ? 1e-30f : p);
}

__global__ void __launch_bounds__(SOLVE_NT) camera_solve_kernel(
    int quat, const float* __restrict__ S, const float* __restrict__ dU,
    const float* __restrict__ rhs, const float* __restrict__ free,
    const float* __restrict__ state, const float* __restrict__ rot,
    const float* __restrict__ camp, int V, int vc, float* gscratch, float* __restrict__ delta,
    float* __restrict__ rot_c, float* __restrict__ camp_c) {
  if (state[DONE] != 0.f) return;  // the same for every CTA of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const bool single = cluster.num_blocks() == 1;
  const int n = 6 * V, ld = n + 1;
  const int R = 6 * vc;  // rows per CTA
  const int row0 = rank * R;
  const int nrows = max(0, min(R, n - row0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = SOLVE_NT / 32;
  extern __shared__ float smem[];
  float* rowk = smem;             // [ld]     the pivot row, local copy (C > 1)
  float* pub = rowk + ld;         // [2][ld]  the pivot row published to the cluster
  float* dsc = pub + 2 * ld;      // [n]      Jacobi scale of every row
  float* A = gscratch ? gscratch + (size_t)rank * R * ld : dsc + n;  // [R][ld]
  const float lam = state[LAM];

  for (int i = tid; i < n; i += SOLVE_NT) {
    const float d = (S[(size_t)i * n + i] + lam * fmaxf(dU[i], 1e-8f)) * free[i] * free[i] +
                    (1.f - free[i]);
    dsc[i] = sqrtf(fmaxf(fabsf(d), 1e-12f));
  }
  __syncthreads();
  // This CTA's rows of the damped, pinned, Jacobi-scaled [S | rhs].
  for (int r = warp; r < nrows; r += NW) {
    const int i = row0 + r;
    for (int j = lane; j <= n; j += 32) {
      float a;
      if (j < n) {
        a = S[(size_t)i * n + j];
        if (i == j) a += lam * fmaxf(dU[i], 1e-8f);
        a = a * free[i] * free[j] + (i == j ? 1.f - free[i] : 0.f);
        a = a / dsc[i] / dsc[j];
      } else {
        a = rhs[i] * free[i] / dsc[i];
      }
      A[(size_t)r * ld + j] = a;
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float* Ak = A + (size_t)k * ld;  // a cluster of one reads row k in place
    if (!single) {
      const int owner = k / R;
      float* buf = pub + (k & 1) * ld;
      if (rank == owner)
        for (int j = k + tid; j <= n; j += SOLVE_NT) buf[j] = A[(size_t)(k - row0) * ld + j];
      cluster.sync();
      const float* src = cluster.map_shared_rank(buf, owner);
      for (int j = k + tid; j <= n; j += SOLVE_NT) rowk[j] = src[j];
      __syncthreads();
      Ak = rowk;
    }
    const float inv_piv = safe_inv(Ak[k]);
    for (int r = warp; r < nrows; r += NW) {
      float* Ai = A + (size_t)r * ld;
      if (row0 + r != k) eliminate_row(Ai, Ak, k, n, lane, Ai[k] * inv_piv);
    }
    __syncthreads();
  }

  for (int r = tid; r < nrows; r += SOLVE_NT) {
    const int i = row0 + r;
    delta[i] = A[(size_t)r * ld + n] * safe_inv(A[(size_t)r * ld + i]) / dsc[i] * free[i];
  }
  __syncthreads();

  // Candidate cameras of this CTA's rows: q <- normalize(exp(d) (x) q) or
  // angles += d; offsets and scale additive (cameras.retract; ba_fused.py
  // _retract_quat/_retract_euler).
  for (int v = rank * vc + tid; v < min(V, (rank + 1) * vc); v += SOLVE_NT) {
    const float* d = delta + v * 6;
    const float* q = rot + v * 4;
    float* qo = rot_c + v * 4;
    if (quat) {
      const float a2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const bool small = a2 < 1e-12f;
      const float angle = sqrtf(small ? 1.f : a2);
      const float kk = small ? 0.5f - a2 / 48.f : sinf(0.5f * angle) / angle;
      const float aw = small ? 1.f - a2 / 8.f : cosf(0.5f * angle);
      const float ax = kk * d[0], ay = kk * d[1], az = kk * d[2];
      float o[4] = {aw * q[0] - ax * q[1] - ay * q[2] - az * q[3],
                    aw * q[1] + ax * q[0] + ay * q[3] - az * q[2],
                    aw * q[2] - ax * q[3] + ay * q[0] + az * q[1],
                    aw * q[3] + ax * q[2] - ay * q[1] + az * q[0]};
      const float nrm = sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
      for (int i = 0; i < 4; ++i) qo[i] = o[i] / nrm;
    } else {
      for (int i = 0; i < 3; ++i) qo[i] = q[i] + d[i];
      qo[3] = q[3];
    }
    for (int i = 0; i < 8; ++i) camp_c[v * 8 + i] = camp[v * 8 + i];
    camp_c[v * 8 + 0] += d[5];
    camp_c[v * 8 + 3] += d[3];
    camp_c[v * 8 + 4] += d[4];
  }
  // No CTA may leave while another can still read its published row.
  if (!single) cluster.sync();
}

// Cluster size and rows of K3 for V cameras: the fewest CTAs (a power of
// two, at most SOLVE_MAX_CLUSTER) whose row blocks fit SOLVE_SMEM_TARGET.
struct SolvePlan {
  int cluster, vc;
  size_t fixed_bytes, block_bytes;  // shared bytes besides / of the row block
};

SolvePlan solve_plan(int V) {
  const size_t n = 6 * (size_t)V, ld = n + 1;
  SolvePlan p;
  p.fixed_bytes = sizeof(float) * (3 * ld + n);
  for (p.cluster = 1;; p.cluster *= 2) {
    p.vc = (V + p.cluster - 1) / p.cluster;
    p.block_bytes = sizeof(float) * 6 * (size_t)p.vc * ld;
    if (p.fixed_bytes + p.block_bytes <= SOLVE_SMEM_TARGET || p.cluster == SOLVE_MAX_CLUSTER)
      return p;
  }
}

bool solve_block_in_smem(const SolvePlan& p) {
  return p.fixed_bytes + p.block_bytes <= SMEM_MAX;
}

// ---------------------------------------------------------------------------
// K2: point_update_cost — replaces ba_pallas.py point_update_cost (and pass 2
// of ba_fused.py run_lm).
//
// Bound: one thread per track does ~2V observation blocks (~600 FMA each)
// and reads 4 + 3V floats: FMA-bound, with every input read coalesced along
// the track axis. Design: the blocks are recomputed rather than stored by K1
// (storing W and V^-1 would cost 24V floats per track of traffic);
// W^T dc folds into the same pass as sum_k w Jp_k (Jc_k . dc); the retracted
// point is projected through the candidate cameras in a second pass over
// views; each CTA reduces its robust cost in a fixed tree order into one
// partial, which K4 sums in order. With update_points = 0 and the current
// cameras as candidates, it computes the initial cost (ba_fused.py cost_of).
__global__ void __launch_bounds__(NT) point_update_cost_kernel(
    int quat, const float* __restrict__ pT, const float* __restrict__ obsT,
    const float* __restrict__ maskT, const float* __restrict__ rot,
    const float* __restrict__ camp, const float* __restrict__ free,
    const float* __restrict__ state, const float* __restrict__ delta,
    const float* __restrict__ rot_c, const float* __restrict__ camp_c, float huber,
    int update_points, int V, int T, float* __restrict__ p_out,
    float* __restrict__ cost_part) {
  if (state && state[DONE] != 0.f) return;
  extern __shared__ float smem[];
  Cam* cams = reinterpret_cast<Cam*>(smem);
  Cam* cams_n = cams + V;
  float* dl = reinterpret_cast<float*>(cams_n + V);  // [V*6]
  __shared__ float red[NT / 32];
  const int tid = threadIdx.x;
  if (update_points) {
    fill_cams(quat, rot, camp, free, V, cams);
    for (int i = tid; i < V * 6; i += NT) dl[i] = delta[i];
  }
  fill_cams(quat, rot_c, camp_c, nullptr, V, cams_n);
  const float lam = state ? state[LAM] : 0.f;
  __syncthreads();

  const int t = blockIdx.x * NT + tid;
  float rho_sum = 0.f;
  if (t < T) {
    float p4[4];
    for (int i = 0; i < 4; ++i) p4[i] = pT[i * T + t];
    if (update_points) {
      PointPre P;
      point_pre(pT, T, t, P);
      float vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gp[3] = {0.f, 0.f, 0.f};
      float wd[3] = {0.f, 0.f, 0.f};
      for (int v = 0; v < V; ++v) {
        if (maskT[v * T + t] == 0.f) continue;
        float r[2], w, Jc[2][6], Jp[2][3];
        obs_block(quat, cams[v], P, obsT[(v * 2) * T + t], obsT[(v * 2 + 1) * T + t], huber,
                  r, w, Jc, Jp);
        add_point_block(w, Jp, r, vt, gp);
        for (int k = 0; k < 2; ++k) {
          float jd = 0.f;
          for (int a = 0; a < 6; ++a) jd += Jc[k][a] * dl[v * 6 + a];
          for (int q = 0; q < 3; ++q) wd[q] += w * jd * Jp[k][q];
        }
      }
      float Vi[9];
      point_inv(vt, lam, 1, Vi);
      float tmp[3], dp[3];
      for (int q = 0; q < 3; ++q) tmp[q] = gp[q] - wd[q];
      for (int q = 0; q < 3; ++q)
        dp[q] = Vi[q * 3 + 0] * tmp[0] + Vi[q * 3 + 1] * tmp[1] + Vi[q * 3 + 2] * tmp[2];
      float nrm2 = 0.f;
      for (int j = 0; j < 4; ++j) {
        p4[j] = P.p4[j] + P.B[j * 3 + 0] * dp[0] + P.B[j * 3 + 1] * dp[1] + P.B[j * 3 + 2] * dp[2];
        nrm2 += p4[j] * p4[j];
      }
      const float nrm = sqrtf(fmaxf(nrm2, 1e-40f));
      for (int j = 0; j < 4; ++j) p4[j] /= nrm;
    }
    if (p_out)
      for (int j = 0; j < 4; ++j) p_out[j * T + t] = p4[j];

    const float sw = safe_w(p4[3]);
    const float p3[3] = {p4[0] / sw, p4[1] / sw, p4[2] / sw};
    const float d2 = huber * huber;
    for (int v = 0; v < V; ++v) {
      if (maskT[v * T + t] == 0.f) continue;
      float local[3], pix[2];
      project(cams_n[v], p3, local, pix);
      const float rx = pix[0] - obsT[(v * 2) * T + t], ry = pix[1] - obsT[(v * 2 + 1) * T + t];
      const float s2 = rx * rx + ry * ry;
      rho_sum += s2 <= d2 ? s2 : 2.f * huber * sqrtf(fmaxf(s2, 1e-20f)) - d2;
    }
  }
  for (int off = 16; off > 0; off >>= 1) rho_sum += __shfl_down_sync(0xffffffffu, rho_sum, off);
  if ((tid & 31) == 0) red[tid >> 5] = rho_sum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < NT / 32; ++i) s += red[i];
    cost_part[blockIdx.x] = 0.5f * s;
  }
}

// ---------------------------------------------------------------------------
// K4: lm_accept — replaces the accept/reject, lambda and done update of
// ba_fused.py run_lm (:457-474; the same rule as ba.py:501-513).
//
// Bound: a copy of the 4T candidate point floats on acceptance, memory-bound
// and tiny. Design: every CTA sums K2's partials in the same order and so
// reaches the same decision without a grid-wide sync; CTA 0 alone writes the
// new scalar state into the other slot and the accepted cameras.
__global__ void __launch_bounds__(NT) lm_accept_kernel(
    int init, const float* __restrict__ cost_part, int n_part,
    const float* __restrict__ state_in, float* __restrict__ state_out, float* __restrict__ rot,
    float* __restrict__ camp, float* __restrict__ pT, const float* __restrict__ rot_c,
    const float* __restrict__ camp_c, const float* __restrict__ p_c, int V, int T, float lam0,
    float func_tol, float lam_up, float lam_down, float min_lam, float max_lam) {
  __shared__ int s_acc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < n_part; ++i) s += cost_part[i];
    float out[STATE_SIZE] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int acc = 0;
    if (init) {
      out[LAM] = lam0; out[COST] = s; out[INIT_COST] = s;
    } else if (state_in[DONE] != 0.f) {
      for (int i = 0; i < STATE_SIZE; ++i) out[i] = state_in[i];
    } else {
      const float lam = state_in[LAM], cost = state_in[COST];
      acc = s < cost;
      const float rel = (cost - s) / fmaxf(cost, 1e-20f);
      bool done = acc && rel < func_tol;
      const float nl = acc ? fmaxf(lam * lam_down, min_lam) : fminf(lam * lam_up, max_lam);
      done = done || (!acc && nl >= max_lam);
      out[LAM] = nl;
      out[COST] = acc ? s : cost;
      out[ITERS] = state_in[ITERS] + 1.f;
      out[DONE] = done ? 1.f : 0.f;
      out[INIT_COST] = state_in[INIT_COST];
    }
    if (blockIdx.x == 0)
      for (int i = 0; i < STATE_SIZE; ++i) state_out[i] = out[i];
    s_acc = acc;
  }
  __syncthreads();
  if (!s_acc) return;
  if (blockIdx.x == 0) {
    for (int i = tid; i < V * 4; i += NT) rot[i] = rot_c[i];
    for (int i = tid; i < V * 8; i += NT) camp[i] = camp_c[i];
  }
  if (p_c)
    for (int i = blockIdx.x * NT + tid; i < 4 * T; i += gridDim.x * NT) pT[i] = p_c[i];
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Floats of the global scratch buffer the camera solve needs for V cameras
// (0 when its row blocks fit in shared memory).
int osfm_camera_solve_scratch_floats(int V) {
  const SolvePlan p = solve_plan(V);
  return solve_block_in_smem(p) ? 0 : (int)(p.cluster * p.block_bytes / sizeof(float));
}

int osfm_schur_assemble(int quat, const float* pT, const float* obsT, const float* maskT,
                        const float* rot, const float* camp, const float* free,
                        const float* state, float huber, int opt, int V, int T, int chunk,
                        int n_chunks, float* Spart, float* vpart, float* S, float* dU,
                        float* rhs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 6 * V;
  const int ntile = (n + TS - 1) / TS;
  const size_t smem = sizeof(Cam) * V +
                      sizeof(float) * (TS * (2 * XS + 2 * ZS + 2 * KT) + KT * 12);
  int err = set_smem((const void*)schur_assemble_kernel, smem);
  if (err) return err;
  schur_assemble_kernel<<<dim3(n_chunks, ntile * ntile), NT, smem, st>>>(
      quat, pT, obsT, maskT, rot, camp, free, state, huber, opt, V, T, chunk, Spart, vpart);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int total = n * n + 2 * n;
  schur_reduce_kernel<<<(total + NT - 1) / NT, NT, 0, st>>>(state, n, n_chunks, Spart, vpart,
                                                            S, dU, rhs);
  return (int)cudaGetLastError();
}

int osfm_camera_solve(int quat, const float* S, const float* dU, const float* rhs,
                      const float* free, const float* state, const float* rot,
                      const float* camp, int V, float* gscratch, float* delta, float* rot_c,
                      float* camp_c, void* stream) {
  const SolvePlan p = solve_plan(V);
  if (!gscratch && !solve_block_in_smem(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = p.fixed_bytes + (gscratch ? 0 : p.block_bytes);
  int err = set_smem((const void*)camera_solve_kernel, smem);
  if (err) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster);
  cfg.blockDim = dim3(SOLVE_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, camera_solve_kernel, quat, S, dU, rhs, free, state, rot,
                                camp, V, p.vc, gscratch, delta, rot_c, camp_c);
  if (err) return err;
  return (int)cudaGetLastError();
}

int osfm_point_update_cost(int quat, const float* pT, const float* obsT, const float* maskT,
                           const float* rot, const float* camp, const float* free,
                           const float* state, const float* delta, const float* rot_c,
                           const float* camp_c, float huber, int update_points, int V, int T,
                           float* p_out, float* cost_part, void* stream) {
  const size_t smem = sizeof(Cam) * 2 * V + sizeof(float) * 6 * V;
  int err = set_smem((const void*)point_update_cost_kernel, smem);
  if (err) return err;
  point_update_cost_kernel<<<(T + NT - 1) / NT, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      quat, pT, obsT, maskT, rot, camp, free, state, delta, rot_c, camp_c, huber, update_points,
      V, T, p_out, cost_part);
  return (int)cudaGetLastError();
}

int osfm_lm_accept(int init, const float* cost_part, int n_part, const float* state_in,
                   float* state_out, float* rot, float* camp, float* pT, const float* rot_c,
                   const float* camp_c, const float* p_c, int V, int T, int n_blocks,
                   float lam0, float func_tol, float lam_up, float lam_down, float min_lam,
                   float max_lam, void* stream) {
  lm_accept_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      init, cost_part, n_part, state_in, state_out, rot, camp, pT, rot_c, camp_c, p_c, V, T,
      lam0, func_tol, lam_up, lam_down, min_lam, max_lam);
  return (int)cudaGetLastError();
}

}  // extern "C"
