// The Tomasi-Kanade (TK) initialization on Hopper (sm_90a): two kernels
// that, with a few plain tensor operations around them
// (solvers/tk_kernels.py), run the JAX package's jitted
// robust_factorization (orthosfm_tpu/solvers/tomasi_kanade.py:193) as one
// device program per group, with no host round trip.
//
//   K5 tk_factorize  factorize (tomasi_kanade.py:49-85) with its metric
//                    upgrade lm.solve (orthosfm_tpu/solvers/lm.py:15-50) and
//                    is_result_usable (tomasi_kanade.py:88-98), one problem
//                    (a RANSAC hypothesis, or the fallback over all tracks)
//                    per thread: the measurement matrix D (2G x S), mean
//                    centred over its valid columns, its Gram D D^T (or a
//                    Gram given per problem), RStar = the Gram's top three
//                    eigenvectors by cyclic Jacobi (a fixed number of
//                    sweeps), 40 Levenberg-Marquardt iterations on the
//                    3G + 6 metric-upgrade residuals with their closed-form
//                    Jacobian, Marquardt damping max(diag H, 1e-8) and a
//                    9 x 9 LU with partial pivoting, then the mirror pair
//                    sol1 / sol2 and the validity heuristic.
//   K6 tk_score      _triangulate_and_errors (tomasi_kanade.py:112-140) and
//                    the scoring of score_hypothesis (:170-190), one CTA per
//                    hypothesis walking every track: each valid track is
//                    triangulated under the hypothesis's sol1 (one normal
//                    matrix per model, its closed-form inverse), its
//                    reprojection errors in pixels tested against the
//                    inlier threshold, and the consensus and inlier counts
//                    and the error sum reduced in a fixed order (no float
//                    atomics), so a hypothesis's score does not depend on
//                    how many hypotheses a launch holds (the sharded TK is
//                    bit for bit with one device). The (H, T, G, 3)
//                    intermediates of the plain version are never stored.
//
// What bounds them on this card: K5 is 50-110 kFLOP a problem in a chain of
// 40 dependent LM iterations (latency, not the f32 rate: 241 hypotheses fill
// 4 CTAs of 64 threads); K6 does ~210 FLOP a (hypothesis, track) and reads
// the observations once from device memory (then from L2 for every other
// hypothesis): operations-bound at 241 x 50 000. Both are written to be
// right first; a warp per hypothesis (K5) and a split of the tracks over
// several CTAs (K6) are later work.
//
// The arithmetic of both lives in functions compiled for the host too: the
// same file built by the host C++ compiler (no __CUDACC__) exports
// osfm_tk_factorize_host and osfm_tk_score_host, which the CPU tests hold
// against the plain PyTorch versions and the JAX package. f32 throughout, as
// in the reference.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TK_HD __host__ __device__ __forceinline__
#else
#define TK_HD inline
#endif

namespace {

constexpr int LM_ITERS = 40;
constexpr int JACOBI_SWEEPS = 10;  // a 6 x 6 Gram converges to f32 in ~5
constexpr float HALF_PI = 1.57079632679489662f;
constexpr float CAMERA_DISTANCE = 10.0f;
constexpr float LAMBDA0 = 1e-3f, LAMBDA_UP = 10.0f, LAMBDA_DOWN = 0.1f;
constexpr float MIN_LAMBDA = 1e-12f, MAX_LAMBDA = 1e10f, MIN_DAMP = 1e-8f;
constexpr int FACTORIZE_THREADS = 64;
constexpr int SCORE_THREADS = 256;
constexpr int MAX_SAMPLE = 64;  // K6's sample indices in shared memory

// ---------------------------------------------------------------------------
// K5: one factorization

// The 2G x 2G Gram of the measurement matrix D = -[x^T; y^T] (2G x S),
// mean-centred over the valid columns and masked (factorize's D).
template <int G>
TK_HD void gram_from_obs(const float* obs, const uint8_t* mask, int S, float (&A)[2 * G][2 * G]) {
  constexpr int N = 2 * G;
  float mean[N];
#pragma unroll
  for (int n = 0; n < N; ++n) mean[n] = 0.0f;
  float count = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float m = (mask == nullptr || mask[s]) ? 1.0f : 0.0f;
    count += m;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      mean[g] += -obs[(s * G + g) * 2] * m;
      mean[G + g] += -obs[(s * G + g) * 2 + 1] * m;
    }
  }
  count = fmaxf(count, 1.0f);
#pragma unroll
  for (int n = 0; n < N; ++n) mean[n] = mean[n] / count;
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int q = 0; q < N; ++q) A[p][q] = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float m = (mask == nullptr || mask[s]) ? 1.0f : 0.0f;
    float d[N];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      d[g] = (-obs[(s * G + g) * 2] - mean[g]) * m;
      d[G + g] = (-obs[(s * G + g) * 2 + 1] - mean[G + g]) * m;
    }
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = p; q < N; ++q) A[p][q] += d[p] * d[q];
  }
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int q = 0; q < p; ++q) A[p][q] = A[q][p];
}

// RStar: the eigenvectors of the symmetric A of its three largest
// eigenvalues, in descending order (the left singular vectors of D that
// factorize takes, up to each column's sign), by cyclic Jacobi rotations.
template <int N>
TK_HD void top3_eigenvectors(float (&A)[N][N], float (&R)[N][3]) {
  float V[N][N];
#pragma unroll
  for (int p = 0; p < N; ++p)
#pragma unroll
    for (int q = 0; q < N; ++q) V[p][q] = p == q ? 1.0f : 0.0f;
#pragma unroll 1
  for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float apq = A[p][q];
        if (apq != 0.0f) {
          // the rotation that zeroes A[p][q]; theta^2 may overflow to inf,
          // which gives t = 0
          const float theta = (A[q][q] - A[p][p]) / (2.0f * apq);
          const float t = copysignf(1.0f, theta) / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
          const float c = 1.0f / sqrtf(t * t + 1.0f);
          const float s = t * c;
          const float tau = s / (1.0f + c);
          A[p][p] -= t * apq;
          A[q][q] += t * apq;
          A[p][q] = A[q][p] = 0.0f;
#pragma unroll
          for (int r = 0; r < N; ++r) {
            if (r == p || r == q) continue;
            const float arp = A[r][p], arq = A[r][q];
            A[r][p] = A[p][r] = arp - s * (arq + tau * arp);
            A[r][q] = A[q][r] = arq + s * (arp - tau * arq);
          }
#pragma unroll
          for (int r = 0; r < N; ++r) {
            const float vrp = V[r][p], vrq = V[r][q];
            V[r][p] = vrp - s * (vrq + tau * vrp);
            V[r][q] = vrq + s * (vrp - tau * vrq);
          }
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) R[n][0] = R[n][1] = R[n][2] = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j != k && (A[j][j] > A[k][k] || (A[j][j] == A[k][k] && j < k))) ++rank;
#pragma unroll
    for (int r = 0; r < 3; ++r)
      if (rank == r) {
#pragma unroll
        for (int n = 0; n < N; ++n) R[n][r] = V[n][k];
      }
  }
}

// (row @ Q)[b] = sum_a row[a] Q[a][b], Q row-major in q
TK_HD void times_q(const float (&row)[3], const float (&q)[9], float (&out)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) out[b] = row[0] * q[b] + row[1] * q[3 + b] + row[2] * q[6 + b];
}

TK_HD void accumulate_row(const float (&J)[9], float r, float (&H)[9][9], float (&grad)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    grad[k] += J[k] * r;
#pragma unroll
    for (int l = k; l < 9; ++l) H[k][l] += J[k] * J[l];
  }
}

// The metric-upgrade residuals (the port's tomasi_kanade._tk_residual, in
// its order: per camera u.u - 1, v.v - 1, u.v with u = Q^T i, v = Q^T j;
// then u_0 - e1 and v_0 - e2) at q: returns 0.5 |r|^2 and, with `normal`,
// accumulates J^T J (upper triangle) and J^T r.
template <int G, bool normal>
TK_HD float residuals(const float (&R)[2 * G][3], const float (&q)[9], float (&H)[9][9],
                      float (&grad)[9]) {
  if (normal) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      grad[k] = 0.0f;
#pragma unroll
      for (int l = k; l < 9; ++l) H[k][l] = 0.0f;
    }
  }
  float cost = 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float u[3], v[3];
    times_q(R[g], q, u);
    times_q(R[G + g], q, v);
    const float r1 = u[0] * u[0] + u[1] * u[1] + u[2] * u[2] - 1.0f;
    const float r2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] - 1.0f;
    const float r3 = u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
    cost += r1 * r1;
    cost += r2 * r2;
    cost += r3 * r3;
    if (normal) {
      float J[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) J[3 * a + b] = 2.0f * (R[g][a] * u[b]);
      accumulate_row(J, r1, H, grad);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) J[3 * a + b] = 2.0f * (R[G + g][a] * v[b]);
      accumulate_row(J, r2, H, grad);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) J[3 * a + b] = R[g][a] * v[b] + R[G + g][a] * u[b];
      accumulate_row(J, r3, H, grad);
    }
  }
  // the gauge: camera 0's u and v pinned to the first two world axes; row
  // b' of each has R[0][a] (R[G][a]) at column 3a + b' and zeros elsewhere
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const float(&row)[3] = R[w * G];
    float u[3];
    times_q(row, q, u);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const float r = u[b] - (b == w ? 1.0f : 0.0f);
      cost += r * r;
      if (normal) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          grad[3 * a + b] += row[a] * r;
#pragma unroll
          for (int c = a; c < 3; ++c) H[3 * a + b][3 * c + b] += row[a] * row[c];
        }
      }
    }
  }
  return 0.5f * cost;
}

// x = M[:, :9]^-1 M[:, 9] by LU with partial pivoting (the largest |entry|
// of each column, the first among equals), as jnp.linalg.solve factors;
// M is overwritten.
TK_HD void lu_solve9(float (&M)[9][10], float (&x)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int i = k + 1; i < 9; ++i) {
      if (fabsf(M[i][k]) > fabsf(M[k][k])) {
#pragma unroll
        for (int j = k; j < 10; ++j) {
          const float t = M[k][j];
          M[k][j] = M[i][j];
          M[i][j] = t;
        }
      }
    }
    const float inv = 1.0f / M[k][k];
#pragma unroll
    for (int i = k + 1; i < 9; ++i) {
      const float l = M[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 10; ++j) M[i][j] -= l * M[k][j];
    }
  }
#pragma unroll
  for (int i = 8; i >= 0; --i) {
    float s = M[i][9];
#pragma unroll
    for (int j = i + 1; j < 9; ++j) s -= M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
}

// lm.solve on the metric-upgrade residuals from q (the inits): 40
// iterations of the damped Gauss-Newton step, accepted where the cost
// falls, lambda x 0.1 (>= 1e-12) on accept and x 10 (<= 1e10) on reject.
template <int G>
TK_HD void metric_upgrade(const float (&R)[2 * G][3], float (&q)[9]) {
  float H[9][9], grad[9];
  float c = residuals<G, true>(R, q, H, grad);
  float lam = LAMBDA0;
#pragma unroll 1
  for (int it = 0; it < LM_ITERS; ++it) {
    float M[9][10];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int l = 0; l < 9; ++l) M[k][l] = k <= l ? H[k][l] : H[l][k];
      M[k][k] = H[k][k] + lam * fmaxf(H[k][k], MIN_DAMP);
      M[k][9] = -grad[k];
    }
    float step[9], qn[9];
    lu_solve9(M, step);
#pragma unroll
    for (int k = 0; k < 9; ++k) qn[k] = q[k] + step[k];
    const float cn = residuals<G, false>(R, qn, H, grad);
    if (cn < c) {
#pragma unroll
      for (int k = 0; k < 9; ++k) q[k] = qn[k];
      c = cn;
      lam = fmaxf(lam * LAMBDA_DOWN, MIN_LAMBDA);
      residuals<G, true>(R, q, H, grad);
    } else {
      lam = fminf(lam * LAMBDA_UP, MAX_LAMBDA);
    }
  }
}

TK_HD void unit3(float (&v)[3]) {
  const float n = fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-12f);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}

// (phi, theta) of core/cameras.basis_to_phi_theta_roll on a basis (3 x 3,
// row-major, columns the x/y/z axes), through the coordinate transform
// C = [[1,0,0],[0,0,-1],[0,1,0]]: b = C basis
TK_HD void phi_theta(const float* m, float& phi, float& theta) {
  const float b02 = m[2], b12 = -m[8], b22 = m[5];
  phi = atan2f(-b12, -b02) - HALF_PI;
  const float n = sqrtf(b02 * b02 + b12 * b12 + b22 * b22);
  theta = acosf(fminf(fmaxf(b22 / n, -1.0f), 1.0f)) - HALF_PI;
}

// RFinal = RStar Q -> the unit x, y and z = x cross y axes of each camera,
// normalized so that camera 0 is the identity (sol1), its mirror sol2 =
// F sol1 F with F = diag(1, 1, -1), and the validity heuristic on sol1.
template <int G>
TK_HD void write_models(const float (&R)[2 * G][3], const float (&q)[9], float min_ang,
                        float min_basis, float* sol1, float* sol2, uint8_t* usable) {
  float comb[G][3][3];  // [camera][component][axis]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float x[3], y[3], z[3];
    times_q(R[g], q, x);
    times_q(R[G + g], q, y);
    z[0] = x[1] * y[2] - x[2] * y[1];
    z[1] = x[2] * y[0] - x[0] * y[2];
    z[2] = x[0] * y[1] - x[1] * y[0];
    unit3(x);
    unit3(y);
    unit3(z);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      comb[g][r][0] = x[r];
      comb[g][r][1] = y[r];
      comb[g][r][2] = z[r];
    }
  }
  float s[G][9];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        s[g][3 * i + k] = comb[0][0][i] * comb[g][0][k] + comb[0][1][i] * comb[g][1][k] +
                          comb[0][2][i] * comb[g][2][k];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      sol1[9 * g + e] = s[g][e];
      // F s F flips the sign of the entries with exactly one index 2
      sol2[9 * g + e] = ((e / 3 == 2) != (e % 3 == 2)) ? -s[g][e] : s[g][e];
    }
  float phi[G], theta[G];
#pragma unroll
  for (int g = 0; g < G; ++g) phi_theta(s[g], phi[g], theta[g]);
  bool ok = true;
#pragma unroll
  for (int a = 0; a < G; ++a)
#pragma unroll
    for (int b = 0; b < G; ++b) {
      if (a == b) continue;
      const bool close_ang = fabsf(phi[a] - phi[b]) < min_ang && fabsf(theta[a] - theta[b]) < min_ang;
      float d2 = 0.0f;
#pragma unroll
      for (int e = 0; e < 9; ++e) d2 += (s[a][e] - s[b][e]) * (s[a][e] - s[b][e]);
      if (close_ang || sqrtf(d2) < min_basis) ok = false;
    }
  *usable = ok ? 1 : 0;
}

// Problem b of a launch: obs (B, S, G, 2) with mask (B, S) (null: every
// column), or gram (B, 2G, 2G); rstar_in (B, 2G, 3) replaces the
// eigenvectors where given; q0 (B, 9). Writes sol1 / sol2 (B, G, 3, 3),
// usable (B,) and, where given, rstar_out (B, 2G, 3).
template <int G>
TK_HD void factorize_one(int b, int S, const float* obs, const uint8_t* mask, const float* gram,
                         const float* rstar_in, const float* q0, float min_ang, float min_basis,
                         float* sol1, float* sol2, uint8_t* usable, float* rstar_out) {
  constexpr int N = 2 * G;
  float R[N][3];
  if (rstar_in != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < 3; ++c) R[n][c] = rstar_in[(b * N + n) * 3 + c];
  } else {
    float A[N][N];
    if (gram != nullptr) {
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int c = 0; c < N; ++c) A[p][c] = gram[(b * N + p) * N + c];
    } else {
      gram_from_obs<G>(obs + (size_t)b * S * G * 2, mask == nullptr ? nullptr : mask + (size_t)b * S,
                       S, A);
    }
    top3_eigenvectors<N>(A, R);
  }
  if (rstar_out != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int c = 0; c < 3; ++c) rstar_out[(b * N + n) * 3 + c] = R[n][c];
  }
  float q[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) q[k] = q0[b * 9 + k];
  metric_upgrade<G>(R, q);
  write_models<G>(R, q, min_ang, min_basis, sol1 + b * G * 9, sol2 + b * G * 9, usable + b);
}

// ---------------------------------------------------------------------------
// K6: one hypothesis's score

// A camera of a model, through the reference's angle path
// (tomasi_kanade._model_geometry): R_l2w = C^T S(phi, theta, roll), its
// origin R (0, 0, -d) and the projector I - l l^T of its look direction l =
// R[:, 2].
struct Camera {
  float R[9], o[3], proj[9];
};

TK_HD void camera_geometry(const float* m, Camera& cam) {
  float phi, theta;
  phi_theta(m, phi, theta);
  const float b00 = m[0], b10 = -m[6], b20 = m[3];
  const float omega = theta + HALF_PI;
  const float cph = cosf(phi), sph = sinf(phi), com = cosf(omega), som = sinf(omega);
  // (Rz(phi) Rx(omega)), row-major
  const float P[9] = {cph, -sph * com, sph * som, sph, cph * com, -cph * som, 0.0f, som, com};
  const float ta0 = P[0] * b00 + P[3] * b10 + P[6] * b20;
  const float ta1 = P[1] * b00 + P[4] * b10 + P[7] * b20;
  const float roll = atan2f(ta1, ta0);
  const float crl = cosf(roll), srl = sinf(roll);
  float S[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S[3 * i] = P[3 * i] * crl + P[3 * i + 1] * srl;
    S[3 * i + 1] = P[3 * i] * -srl + P[3 * i + 1] * crl;
    S[3 * i + 2] = P[3 * i + 2];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cam.R[c] = S[c];
    cam.R[3 + c] = S[6 + c];
    cam.R[6 + c] = -S[3 + c];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) cam.o[i] = cam.R[3 * i + 2] * -CAMERA_DISTANCE;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cam.proj[3 * i + j] = (i == j ? 1.0f : 0.0f) - cam.R[3 * i + 2] * cam.R[3 * j + 2];
}

// The inverse of the normal matrix sum_g proj_g + 1e-8 I that every valid
// track of a model shares (solvers/ba.py _adjugate_inverse's formula).
template <int G>
TK_HD void normal_inverse(const Camera* cams, float (&inv)[9]) {
  float A[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    float s = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) s += cams[g].proj[e];
    A[e] = s + (e % 4 == 0 ? 1e-8f : 0.0f);
  }
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6], h = A[7],
              i = A[8];
  const float AA = e * i - f * h, BB = -(d * i - f * g), CC = d * h - e * g;
  const float det = a * AA + b * BB + c * CC;
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  const float adj[9] = {AA, -(b * i - c * h), b * f - c * e, BB, a * i - c * g, -(a * f - c * d),
                        CC, -(a * h - b * g), a * e - b * d};
#pragma unroll
  for (int k = 0; k < 9; ++k) inv[k] = adj[k] * inv_det;
}

// The reprojection errors (pixels) of track `o` (G x 2 pixels) triangulated
// under the model's cameras.
template <int G>
TK_HD void track_errors(const Camera* cams, const float (&inv)[9], const float* wh,
                        const float* o, float (&err)[G]) {
  float bsum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float nx = -2.0f * (o[2 * g] / wh[2 * g] - 0.5f);
    const float ny = -2.0f * (o[2 * g + 1] / wh[2 * g + 1] - 0.5f);
    float org[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      org[i] = cams[g].o[i] + nx * cams[g].R[3 * i] + ny * cams[g].R[3 * i + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      bsum[i] += cams[g].proj[3 * i] * org[0] + cams[g].proj[3 * i + 1] * org[1] +
                 cams[g].proj[3 * i + 2] * org[2];
  }
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = inv[3 * i] * bsum[0] + inv[3 * i + 1] * bsum[1] + inv[3 * i + 2] * bsum[2];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lx = cams[g].R[0] * p[0] + cams[g].R[3] * p[1] + cams[g].R[6] * p[2];
    const float ly = cams[g].R[1] * p[0] + cams[g].R[4] * p[1] + cams[g].R[7] * p[2];
    const float dx = wh[2 * g] * (lx / -2.0f + 0.5f) - o[2 * g];
    const float dy = wh[2 * g + 1] * (ly / -2.0f + 0.5f) - o[2 * g + 1];
    err[g] = sqrtf(dx * dx + dy * dy);
  }
}

// Track t's part of a hypothesis's sums: a consensus track is valid,
// outside the sample and within the threshold at every camera; an inlier
// is a consensus track or a valid sample track, and adds its errors.
template <int G>
TK_HD void score_track(const Camera* cams, const float (&inv)[9], const float* wh, const float* obs,
                       const uint8_t* valid, const long long* samp, int S, int t, float thr,
                       int& n_con, int& n_inl, float& err_sum) {
  if (!valid[t]) return;
  bool in_sample = false;
  for (int s = 0; s < S; ++s) in_sample |= samp[s] == (long long)t;
  float err[G];
  track_errors<G>(cams, inv, wh, obs + (size_t)t * G * 2, err);
  bool ok = true;
#pragma unroll
  for (int g = 0; g < G; ++g) ok = ok && err[g] <= thr;
  const bool consensus = ok && !in_sample;
  if (consensus || in_sample) {
    float e = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) e += err[g];
    err_sum += e;
    ++n_inl;
  }
  n_con += consensus ? 1 : 0;
}

// score_hypothesis's statistic: usable with n_consensus >= the minimum
// scores n_consensus + (thr - clamp(mean error, 0, thr)) / (10 thr), else
// -inf (a NaN mean stays NaN, as torch.clamp keeps it).
TK_HD float hypothesis_score(bool usable, int n_con, int n_inl, float err_sum, int G, float thr,
                             float den, int min_consensus) {
  const int n = n_inl * G;
  const float mean = err_sum / (float)(n > 1 ? n : 1);
  float cl = mean;
  if (cl < 0.0f) cl = 0.0f;
  if (cl > thr) cl = thr;
  return (usable && n_con >= min_consensus) ? (float)n_con + (thr - cl) / den : -INFINITY;
}

#ifdef __CUDACC__

template <int G>
__global__ void __launch_bounds__(FACTORIZE_THREADS)
    tk_factorize_kernel(int B, int S, const float* __restrict__ obs, const uint8_t* __restrict__ mask,
                        const float* __restrict__ gram, const float* __restrict__ rstar_in,
                        const float* __restrict__ q0, float min_ang, float min_basis,
                        float* __restrict__ sol1, float* __restrict__ sol2,
                        uint8_t* __restrict__ usable, float* __restrict__ rstar_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  factorize_one<G>(b, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable,
                   rstar_out);
}

template <int G>
__global__ void __launch_bounds__(SCORE_THREADS)
    tk_score_kernel(int T, int S, const float* __restrict__ sol1, const uint8_t* __restrict__ usable,
                    const float* __restrict__ obs, const uint8_t* __restrict__ valid,
                    const float* __restrict__ width, const float* __restrict__ height,
                    const long long* __restrict__ samp_idx, float thr, float den,
                    int min_consensus, float* __restrict__ score,
                    long long* __restrict__ n_consensus) {
  __shared__ Camera cams[G];
  __shared__ float inv_s[9], wh[2 * G];
  __shared__ long long samp[MAX_SAMPLE];
  __shared__ float warp_err[SCORE_THREADS / 32];
  __shared__ int warp_con[SCORE_THREADS / 32], warp_inl[SCORE_THREADS / 32];
  const int h = blockIdx.x, tid = threadIdx.x;
  if (tid < G) {
    camera_geometry(sol1 + ((size_t)h * G + tid) * 9, cams[tid]);
    wh[2 * tid] = width[tid];
    wh[2 * tid + 1] = height[tid];
  }
  for (int s = tid; s < S; s += blockDim.x) samp[s] = samp_idx[(size_t)h * S + s];
  __syncthreads();
  if (tid == 0) {
    float inv[9];
    normal_inverse<G>(cams, inv);
#pragma unroll
    for (int k = 0; k < 9; ++k) inv_s[k] = inv[k];
  }
  __syncthreads();
  float inv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) inv[k] = inv_s[k];
  int n_con = 0, n_inl = 0;
  float err_sum = 0.0f;
  for (int t = tid; t < T; t += blockDim.x)
    score_track<G>(cams, inv, wh, obs, valid, samp, S, t, thr, n_con, n_inl, err_sum);
  // fixed-order reduction: down each warp, then over the warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    err_sum += __shfl_down_sync(0xffffffffu, err_sum, off);
    n_con += __shfl_down_sync(0xffffffffu, n_con, off);
    n_inl += __shfl_down_sync(0xffffffffu, n_inl, off);
  }
  if (lane == 0) {
    warp_err[warp] = err_sum;
    warp_con[warp] = n_con;
    warp_inl[warp] = n_inl;
  }
  __syncthreads();
  if (tid == 0) {
    float e = 0.0f;
    int c = 0, n = 0;
    for (int w = 0; w < SCORE_THREADS / 32; ++w) {
      e += warp_err[w];
      c += warp_con[w];
      n += warp_inl[w];
    }
    score[h] = hypothesis_score(usable[h] != 0, c, n, e, G, thr, den, min_consensus);
    n_consensus[h] = c;
  }
}

template <int G>
cudaError_t launch_factorize(int B, int S, const float* obs, const uint8_t* mask,
                             const float* gram, const float* rstar_in, const float* q0,
                             float min_ang, float min_basis, float* sol1, float* sol2,
                             uint8_t* usable, float* rstar_out, cudaStream_t stream) {
  const int blocks = (B + FACTORIZE_THREADS - 1) / FACTORIZE_THREADS;
  tk_factorize_kernel<G><<<blocks, FACTORIZE_THREADS, 0, stream>>>(
      B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable, rstar_out);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_score(int H, int T, int S, const float* sol1,
                         const uint8_t* usable, const float* obs, const uint8_t* valid,
                         const float* width, const float* height, const long long* samp_idx,
                         float thr, float den, int min_consensus, float* score,
                         long long* n_consensus, cudaStream_t stream) {
  tk_score_kernel<G><<<H, SCORE_THREADS, 0, stream>>>(T, S, sol1, usable, obs, valid, width, height,
                                                samp_idx, thr, den, min_consensus, score,
                                                n_consensus);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// K5 over B problems of G cameras (G in 2..4); every pointer a device
// address, null where optional. Returns the launch's CUDA error (0: none).
extern "C" int osfm_tk_factorize(int G, int B, int S, const float* obs, const uint8_t* mask,
                                 const float* gram, const float* rstar_in, const float* q0,
                                 float min_ang, float min_basis, float* sol1, float* sol2,
                                 uint8_t* usable, float* rstar_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 2:
      return launch_factorize<2>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1,
                                 sol2, usable, rstar_out, st);
    case 3:
      return launch_factorize<3>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1,
                                 sol2, usable, rstar_out, st);
    case 4:
      return launch_factorize<4>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1,
                                 sol2, usable, rstar_out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K6 over H hypotheses of G cameras (G in 2..4, S <= 64), a CTA of
// SCORE_THREADS each.
extern "C" int osfm_tk_score(int G, int H, int T, int S, const float* sol1,
                             const uint8_t* usable, const float* obs, const uint8_t* valid,
                             const float* width, const float* height, const long long* samp_idx,
                             float thr, float den, int min_consensus, float* score,
                             long long* n_consensus, void* stream) {
  if (S > MAX_SAMPLE) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 2:
      return launch_score<2>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx,
                             thr, den, min_consensus, score, n_consensus, st);
    case 3:
      return launch_score<3>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx,
                             thr, den, min_consensus, score, n_consensus, st);
    case 4:
      return launch_score<4>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx,
                             thr, den, min_consensus, score, n_consensus, st);
    default:
      return cudaErrorInvalidValue;
  }
}

#else  // the host build: the kernels' arithmetic, one problem after another

namespace {

template <int G>
void factorize_all(int B, int S, const float* obs, const uint8_t* mask, const float* gram,
                   const float* rstar_in, const float* q0, float min_ang, float min_basis,
                   float* sol1, float* sol2, uint8_t* usable, float* rstar_out) {
  for (int b = 0; b < B; ++b)
    factorize_one<G>(b, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable,
                     rstar_out);
}

template <int G>
void score_all(int H, int T, int S, const float* sol1, const uint8_t* usable, const float* obs,
               const uint8_t* valid, const float* width, const float* height,
               const long long* samp_idx, float thr, float den, int min_consensus, float* score,
               long long* n_consensus) {
  float wh[2 * G];
  for (int g = 0; g < G; ++g) {
    wh[2 * g] = width[g];
    wh[2 * g + 1] = height[g];
  }
  for (int h = 0; h < H; ++h) {
    Camera cams[G];
    for (int g = 0; g < G; ++g) camera_geometry(sol1 + ((size_t)h * G + g) * 9, cams[g]);
    float inv[9];
    normal_inverse<G>(cams, inv);
    int n_con = 0, n_inl = 0;
    float err_sum = 0.0f;
    for (int t = 0; t < T; ++t)
      score_track<G>(cams, inv, wh, obs, valid, samp_idx + (size_t)h * S, S, t, thr, n_con, n_inl,
                     err_sum);
    score[h] = hypothesis_score(usable[h] != 0, n_con, n_inl, err_sum, G, thr, den, min_consensus);
    n_consensus[h] = n_con;
  }
}

}  // namespace

extern "C" int osfm_tk_factorize_host(int G, int B, int S, const float* obs, const uint8_t* mask,
                                      const float* gram, const float* rstar_in, const float* q0,
                                      float min_ang, float min_basis, float* sol1, float* sol2,
                                      uint8_t* usable, float* rstar_out) {
  switch (G) {
    case 2:
      factorize_all<2>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable,
                       rstar_out);
      return 0;
    case 3:
      factorize_all<3>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable,
                       rstar_out);
      return 0;
    case 4:
      factorize_all<4>(B, S, obs, mask, gram, rstar_in, q0, min_ang, min_basis, sol1, sol2, usable,
                       rstar_out);
      return 0;
    default:
      return 1;
  }
}

extern "C" int osfm_tk_score_host(int G, int H, int T, int S, const float* sol1,
                                  const uint8_t* usable, const float* obs, const uint8_t* valid,
                                  const float* width, const float* height,
                                  const long long* samp_idx, float thr, float den,
                                  int min_consensus, float* score, long long* n_consensus) {
  switch (G) {
    case 2:
      score_all<2>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx, thr, den,
                   min_consensus, score, n_consensus);
      return 0;
    case 3:
      score_all<3>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx, thr, den,
                   min_consensus, score, n_consensus);
      return 0;
    case 4:
      score_all<4>(H, T, S, sol1, usable, obs, valid, width, height, samp_idx, thr, den,
                   min_consensus, score, n_consensus);
      return 0;
    default:
      return 1;
  }
}

#endif  // __CUDACC__
