// Motion-only pose Levenberg-Marquardt, pinhole, in one launch.
//
// Replaces: tpuslam/solve/pose_opt_pallas.py, `pose_optimize_fused` (kernel
// body `_pose_kernel`, with `_chol6_solve` and `_se3_exp_scalar`).
//
// What it computes (f32): for n_rounds rounds of at most n_iters LM steps,
// the pinhole mono/stereo residuals of N observations at the current pose,
// Huber weights in every round but the last, the 21-entry normal matrix and
// 6-entry gradient, a Jacobi-scaled damped 6x6 Cholesky solve, a left SE3
// exp update, acceptance when the sum of per-observation cost deltas is
// below 0, lambda x0.5 on accept / x4 on reject clipped to [1e-7, 1e2], an
// early exit on a small accepted step, and chi2 re-classification of all
// valid observations between rounds. Outputs R, t, inliers (u8), chi2.
//
// What bounds it on this card: latency. One solve is a chain of up to
// n_rounds * n_iters dependent steps (40 for the final pass of the fused
// tracking step, which calls it 4 times per frame); each step reads N = 1024
// observations twice and does two block reductions and one scalar 6x6
// solve. There are ~0.1 MFLOP per step: neither bandwidth nor FLOP/s
// matters, the length of the dependent chain does.
//
// Design: one thread block of 256 threads per solve, so the whole chain
// stays in one launch, as it did on the TPU. The observations are staged
// once in shared memory (10 planes x N f32, 40 KB at N = 1024), each thread
// owning a strided ceil(N/256) of them. Each step: per-thread partial sums
// of the 27 H/g entries; a block reduction in a fixed order (warp shuffles,
// then the 8 warp sums in warp order) so results repeat exactly from run to
// run; thread 0 does the Cholesky and the SE3 exp with the TPU kernel's
// guards and writes the trial pose to shared memory; all threads sum the
// per-observation cost deltas (a second reduction); thread 0 sets accept,
// lambda and the loop flag, which every thread reads after __syncthreads,
// so control flow is uniform across the block. R0/t0 are read from device
// memory, so a pose chain never touches the host. Built without
// --use_fast_math: approximate sqrt/sin/cos change accept decisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int NRED = 27;  // 21 lower-triangular H entries + 6 gradient entries
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;

struct Obs {
  float X0, X1, X2, mu, mv, mur, info, sm;
};

struct Res {
  float x, y, z, iz, iz2, ru, rv, rur, chi2;
};

__device__ __forceinline__ Res residual(const float* P, const Obs& o, float fx,
                                        float fy, float cx, float cy,
                                        float bf) {
  Res r;
  r.x = P[0] * o.X0 + P[1] * o.X1 + P[2] * o.X2 + P[9];
  r.y = P[3] * o.X0 + P[4] * o.X1 + P[5] * o.X2 + P[10];
  r.z = P[6] * o.X0 + P[7] * o.X1 + P[8] * o.X2 + P[11];
  const float zs = fabsf(r.z) < 1e-6f ? 1e-6f : r.z;
  r.iz = 1.0f / zs;
  r.iz2 = r.iz * r.iz;
  const float u = fx * r.x * r.iz + cx;
  const float v = fy * r.y * r.iz + cy;
  const float ur = u - bf * r.iz;
  r.ru = u - o.mu;
  r.rv = v - o.mv;
  r.rur = (ur - o.mur) * o.sm;
  r.chi2 = (r.ru * r.ru + r.rv * r.rv + r.rur * r.rur) * o.info;
  return r;
}

// Per-observation (Huber-)robustified cost, 0 where unused or behind.
__device__ __forceinline__ float cost_term(const Res& r, float use, float th,
                                           bool robust) {
  float c = r.chi2;
  if (robust && !(r.chi2 <= th)) {
    c = 2.0f * sqrtf(th) * sqrtf(fmaxf(r.chi2, 0.0f)) - th;
  }
  return (r.z > 0.0f && use > 0.5f) ? c : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum NV per-thread values over the block in a fixed order; the result is
// in out[0..NV) for every thread after return.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* scratch,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[warp * NV + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Jacobi-scaled, damped 6x6 Cholesky solve of H dx = g (the guards of
// _chol6_solve: 1e-30 on the scaling, +1e-7 on the damped diagonal, 1e-20
// under the square root).
__device__ void chol6_solve(const float* tot, float damping, float* dx) {
  float H[6][6], b[6], sc[6], L[6][6], y[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int c = 0; c <= a; ++c, ++k) H[a][c] = H[c][a] = tot[k];
  for (int a = 0; a < 6; ++a) b[a] = -tot[21 + a];
  for (int i = 0; i < 6; ++i) sc[i] = 1.0f / sqrtf(fmaxf(H[i][i], 1e-30f));
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) H[i][j] = H[i][j] * sc[i] * sc[j];
  for (int i = 0; i < 6; ++i) b[i] = b[i] * sc[i];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i][j] + (i == j ? (damping + 1e-7f) : 0.0f);
      for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
      L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-20f)) : s / L[j][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int m = 0; m < i; ++m) s = s - L[i][m] * y[m];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * dx[m];
    dx[i] = s / L[i][i];
  }
  for (int i = 0; i < 6; ++i) dx[i] = dx[i] * sc[i];
}

// Pn = exp(dx) * P (left update), with the small-angle series below 1e-8.
__device__ void se3_update(const float* dx, const float* P, float* Pn) {
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float t2 = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = t2 < 1e-8f;
  const float safe_t2 = small ? 1.0f : t2;
  const float th = sqrtf(safe_t2);
  const float a = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
  const float bb = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / safe_t2;
  const float cc = small ? 1.0f / 6.0f - t2 / 120.0f
                         : (th - sinf(th)) / (safe_t2 * th);
  const float W[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float R[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = eye + a * W[i][j] + bb * w2;
      V[i][j] = eye + bb * W[i][j] + cc * w2;
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Pn[3 * i + j] = R[i][0] * P[j] + R[i][1] * P[3 + j] + R[i][2] * P[6 + j];
    const float dt = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
    Pn[9 + i] = R[i][0] * P[9] + R[i][1] * P[10] + R[i][2] * P[11] + dt;
  }
}

__global__ void __launch_bounds__(NT)
pose_lm_kernel(const float* __restrict__ X, const float* __restrict__ uvr,
               const float* __restrict__ info, const uint8_t* __restrict__ smask,
               const uint8_t* __restrict__ valid, int N,
               const float* __restrict__ R0, const float* __restrict__ t0,
               float fx, float fy, float cx, float cy, float bf, float damping,
               float tol, int n_rounds, int n_iters, float* __restrict__ R_out,
               float* __restrict__ t_out, uint8_t* __restrict__ inl_out,
               float* __restrict__ chi2_out) {
  extern __shared__ float smem[];
  float* sX0 = smem;
  float* sX1 = smem + N;
  float* sX2 = smem + 2 * N;
  float* sU = smem + 3 * N;
  float* sV = smem + 4 * N;
  float* sUR = smem + 5 * N;
  float* sInfo = smem + 6 * N;
  float* sSm = smem + 7 * N;
  float* sValid = smem + 8 * N;
  float* sUse = smem + 9 * N;
  __shared__ float sP[12], sPn[12], red[NW * NRED], tot[NRED];
  __shared__ float s_lam, s_sq, s_sqstep;
  __shared__ int s_cont;

  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += NT) {
    sX0[n] = X[3 * n];
    sX1[n] = X[3 * n + 1];
    sX2[n] = X[3 * n + 2];
    sU[n] = uvr[3 * n];
    sV[n] = uvr[3 * n + 1];
    sUR[n] = uvr[3 * n + 2];
    sInfo[n] = info[n];
    sSm[n] = smask[n] ? 1.0f : 0.0f;
    sValid[n] = valid[n] ? 1.0f : 0.0f;
    sUse[n] = sValid[n];
  }
  if (tid < 9) sP[tid] = R0[tid];
  if (tid < 3) sP[9 + tid] = t0[tid];
  __syncthreads();

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < n_rounds - 1;
    int it = 0;
    if (tid == 0) {
      s_lam = damping;
      s_sq = INFINITY;
      s_cont = (it < n_iters) && (INFINITY > tol);
    }
    __syncthreads();
    while (s_cont) {
      float P[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) P[i] = sP[i];
      float acc[NRED];
#pragma unroll
      for (int i = 0; i < NRED; ++i) acc[i] = 0.0f;
      for (int n = tid; n < N; n += NT) {
        const Obs o{sX0[n], sX1[n], sX2[n], sU[n], sV[n], sUR[n], sInfo[n], sSm[n]};
        const Res r = residual(P, o, fx, fy, cx, cy, bf);
        const float th = o.sm > 0.5f ? CHI2_STEREO : CHI2_MONO;
        float w = 1.0f;
        if (robust) w = fminf(1.0f, sqrtf(th) / sqrtf(fmaxf(r.chi2, 1e-12f)));
        w = w * o.info * sUse[n];
        if (!(r.z > 0.0f)) w = 0.0f;
        const float ws = w * o.sm;
        // Jacobian rows wrt xi = (rho, phi): J = Jproj @ [I | -hat(Xc)]
        const float du[3] = {fx * r.iz, 0.0f, -fx * r.x * r.iz2};
        const float dv[3] = {0.0f, fy * r.iz, -fy * r.y * r.iz2};
        const float dur[3] = {du[0], du[1], du[2] + bf * r.iz2};
        float Ju[6], Jv[6], Jur[6];
        const float* ds[3] = {du, dv, dur};
        float* Js[3] = {Ju, Jv, Jur};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* d = ds[q];
          float* J = Js[q];
          J[0] = d[0];
          J[1] = d[1];
          J[2] = d[2];
          J[3] = d[1] * (-r.z) + d[2] * r.y;
          J[4] = d[0] * r.z + d[2] * (-r.x);
          J[5] = d[0] * (-r.y) + d[1] * r.x;
        }
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int c = 0; c <= a; ++c, ++k)
            acc[k] += w * (Ju[a] * Ju[c] + Jv[a] * Jv[c]) + ws * (Jur[a] * Jur[c]);
          acc[21 + a] += w * (r.ru * Ju[a] + r.rv * Jv[a]) + ws * (r.rur * Jur[a]);
        }
      }
      block_sum<NRED>(acc, red, tot);
      if (tid == 0) {
        float dx[6];
        chol6_solve(tot, s_lam, dx);
        se3_update(dx, P, sPn);
        float sq = 0.0f;
        for (int i = 0; i < 6; ++i) sq += dx[i] * dx[i];
        s_sqstep = sq;
      }
      __syncthreads();
      float Pn[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) Pn[i] = sPn[i];
      float delta[1] = {0.0f};
      for (int n = tid; n < N; n += NT) {
        const Obs o{sX0[n], sX1[n], sX2[n], sU[n], sV[n], sUR[n], sInfo[n], sSm[n]};
        const float th = o.sm > 0.5f ? CHI2_STEREO : CHI2_MONO;
        const float use = sUse[n];
        delta[0] += cost_term(residual(Pn, o, fx, fy, cx, cy, bf), use, th, robust) -
                    cost_term(residual(P, o, fx, fy, cx, cy, bf), use, th, robust);
      }
      block_sum<1>(delta, red, tot);
      if (tid == 0) {
        const bool accept = tot[0] < 0.0f;
        if (accept) {
          for (int i = 0; i < 12; ++i) sP[i] = sPn[i];
        }
        s_lam = fminf(fmaxf(accept ? s_lam * 0.5f : s_lam * 4.0f, 1e-7f), 1e2f);
        s_sq = accept ? s_sqstep : INFINITY;
        ++it;
        s_cont = (it < n_iters) && (s_sq > tol);
      }
      __syncthreads();
    }
    // re-classify all valid observations (ref: Optimizer.cc:1100+)
    float P[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) P[i] = sP[i];
    for (int n = tid; n < N; n += NT) {
      const Obs o{sX0[n], sX1[n], sX2[n], sU[n], sV[n], sUR[n], sInfo[n], sSm[n]};
      const Res r = residual(P, o, fx, fy, cx, cy, bf);
      const float th = o.sm > 0.5f ? CHI2_STEREO : CHI2_MONO;
      sUse[n] = sValid[n] * ((r.chi2 <= th && r.z > 0.0f) ? 1.0f : 0.0f);
    }
    __syncthreads();
  }

  float P[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = sP[i];
  for (int n = tid; n < N; n += NT) {
    const Obs o{sX0[n], sX1[n], sX2[n], sU[n], sV[n], sUR[n], sInfo[n], sSm[n]};
    const Res r = residual(P, o, fx, fy, cx, cy, bf);
    const float th = o.sm > 0.5f ? CHI2_STEREO : CHI2_MONO;
    chi2_out[n] = r.chi2;
    inl_out[n] = (sValid[n] > 0.5f && r.chi2 <= th && r.z > 0.0f) ? 1 : 0;
  }
  if (tid < 9) R_out[tid] = P[tid];
  if (tid < 3) t_out[tid] = P[9 + tid];
}

}  // namespace

extern "C" int pose_lm(const float* X, const float* uvr, const float* info,
                       const uint8_t* smask, const uint8_t* valid, int N,
                       const float* R0, const float* t0, float fx, float fy,
                       float cx, float cy, float bf, float damping, float tol,
                       int n_rounds, int n_iters, float* R_out, float* t_out,
                       uint8_t* inl_out, float* chi2_out, void* stream) {
  const size_t smem = (size_t)10 * N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pose_lm_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      X, uvr, info, smask, valid, N, R0, t0, fx, fy, cx, cy, bf, damping, tol,
      n_rounds, n_iters, R_out, t_out, inl_out, chi2_out);
  return (int)cudaGetLastError();
}
