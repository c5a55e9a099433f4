// Motion-only pose Levenberg-Marquardt, pinhole, in one launch.
//
// Replaces: tpuslam/solve/pose_opt_pallas.py, `pose_optimize_fused` (kernel
// body `_pose_kernel`, with `_chol6_solve` and `_se3_exp_scalar`).
//
// What it computes (f32): for n_rounds rounds of at most n_iters LM steps,
// the pinhole mono/stereo residuals of N observations, Huber weights in
// every round but the last, the 21-entry normal matrix and 6-entry
// gradient, a Jacobi-scaled damped 6x6 Cholesky solve, a left SE3 exp
// update, acceptance when the sum of per-observation cost deltas is below
// 0, lambda x0.5 on accept / x4 on reject clipped to [1e-7, 1e2], an early
// exit on a small accepted step, and chi2 re-classification of all valid
// observations between rounds. Outputs R, t, inliers (u8), chi2.
//
// What bounds it on this card: latency. One solve is a chain of up to
// n_rounds * n_iters dependent steps (40 for the final pass of the fused
// tracking step, which calls it 4 times per frame). A step at N = 1024 is
// ~0.3 MFLOP: at the card's f32 peak that is ~5 ns, so what counts is how
// many dependent phases (passes, reductions, barriers, the scalar solve)
// each step has and how long each takes on one SM: the pass and its
// reduction, and the solves left on the critical path (round starts and
// accepted steps: ~40 IEEE divisions and square roots in a dependent
// chain).
//
// Design: one block of NT threads per solve, so the whole chain stays in
// one launch; the observations are staged in shared memory once. Warp 0
// solves; each thread of warps 1.. owns the observations
// n = tid - 32 + k * (NT - 32). Each LM step is
//   1. one pass at the trial pose Pn by warps 1..: per observation the
//      cost term c(Pn) (for the accept test) and the 27 H/g contributions
//      at Pn (which the next step needs if Pn is accepted). c(P) of the
//      current pose stays in shared memory from the pass that produced P
//      (two cost planes, swapped on accept), so the cost delta is
//      c(Pn) - c(P) with no second residual; on reject the H, g and costs
//      at P are kept. Meanwhile warp 0 solves for the trial that follows
//      if Pn is rejected (the same H, g and P, lambda x 4): once the pose
//      has converged most steps are rejected (~80 % of the 40 steps of
//      chip_smoke.py's problems), and then no solve is on the critical
//      path;
//   2. one block reduction of 28 values (27 + the cost delta): a warp
//      reduce-scatter (31 shuffles; lane k ends with the warp's sum of
//      value k), a barrier, then warp 0 sums the per-warp partials of
//      value k in warp order. The order is fixed, so repeated launches
//      give the same bits;
//   3. warp 0, all 32 lanes on the same values, takes the accept test and
//      the lambda update; after an accept (or a round's first evaluation)
//      it solves the Jacobi-scaled damped 6x6 Cholesky and the SE3 exp of
//      the next trial pose, unrolled in registers, its independent
//      divisions and square roots one per lane; after a reject it takes
//      the speculative trial. It publishes the pose and the loop flag in
//      shared memory and a second barrier releases the block. (Solving in
//      every warp instead saves that barrier but issues the solve NW times
//      over: on the H100 it measured slower.)
// Each round starts with one pass at P that re-classifies the
// observations (rounds after the first) and evaluates H, g and c(P) with
// the round's robust flag and use-mask. NT = 384 (11 warps for the pass)
// measured fastest at N = 1024 of 288, 384, 416 and 544 threads (and, for
// the design without speculation, of 256, 384, 512 and 1024, which
// spills). R0/t0 are read from device memory, so a pose chain never
// touches the host. Built without --use_fast_math: approximate
// sqrt/sin/cos and division change accept decisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 384;   // threads of the one block per solve
constexpr int NW = NT / 32;
constexpr int NHG = 27;   // 21 lower-triangular H entries + 6 gradient entries
                          // (then v[NHG]: the cost delta)
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 7.815f;
constexpr uint8_t F_STEREO = 1, F_VALID = 2, F_USE = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr double INV_PI = 0.318309886183790671537767526745028724;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// Shared-memory planes of the observations, N entries each.
struct Stage {
  float *X0, *X1, *X2, *U, *V, *UR, *info;
  float* cost;     // 2 x N: c at the current pose and at the trial pose
  uint8_t* flags;  // F_STEREO | F_VALID | F_USE
  int N;
};

struct Res {
  float x, y, z, iz, iz2, ru, rv, rur, chi2;
};

__device__ __forceinline__ Res residual(const float (&P)[12], float X0, float X1, float X2,
                                        float mu, float mv, float mur, float info, float sm,
                                        const Cam& c) {
  Res r;
  r.x = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[9];
  r.y = P[3] * X0 + P[4] * X1 + P[5] * X2 + P[10];
  r.z = P[6] * X0 + P[7] * X1 + P[8] * X2 + P[11];
  const float zs = fabsf(r.z) < 1e-6f ? 1e-6f : r.z;
  r.iz = 1.0f / zs;
  r.iz2 = r.iz * r.iz;
  const float u = c.fx * r.x * r.iz + c.cx;
  const float v = c.fy * r.y * r.iz + c.cy;
  const float ur = u - c.bf * r.iz;
  r.ru = u - mu;
  r.rv = v - mv;
  r.rur = (ur - mur) * sm;
  r.chi2 = (r.ru * r.ru + r.rv * r.rv + r.rur * r.rur) * info;
  return r;
}

// The (Huber-)robustified cost c and weight w of one residual, sth =
// sqrtf(th): the Pallas kernel's
//   c = chi2 <= th ? chi2 : 2 sqrt(th) sqrt(max(chi2, 0)) - th,
//   w = min(1, sqrt(th) / sqrt(max(chi2, 1e-12))),
// with the square root and the division taken only where chi2 > th: for
// chi2 <= th the quotient is >= 1 after rounding, so w is exactly 1, and
// for chi2 > th both square roots are sqrtf(chi2). A NaN chi2 gives
// c = -th, w = 1, as there.
__device__ __forceinline__ void huber(float chi2, float th, float sth, float& c, float& w) {
  c = chi2;
  w = 1.0f;
  if (!(chi2 <= th)) {
    const float e = sqrtf(fmaxf(chi2, 0.0f));
    c = 2.0f * sth * e - th;
    if (chi2 > th) w = fminf(1.0f, sth / e);
  }
}

// One row of the pose Jacobian from the projection row d:
// J = d @ [I | -hat(Xc)] with xi = (rho, phi).
__device__ __forceinline__ void pose_row(const float (&d)[3], const Res& r, float (&J)[6]) {
  J[0] = d[0];
  J[1] = d[1];
  J[2] = d[2];
  J[3] = d[1] * (-r.z) + d[2] * r.y;
  J[4] = d[0] * r.z + d[2] * (-r.x);
  J[5] = d[0] * (-r.y) + d[1] * r.x;
}

// One pass, by a thread of warps 1.., over its observations
// n = tid - 32 + k * (NT - 32) at pose P: stores each cost
// term in cost_out and accumulates the H/g contributions into v[0..27).
// kTrial: also accumulates sum(c(P) - cost_prev) into v[27]. reclass:
// first sets use = valid & chi2 <= th & z > 0 from the residual at P.
template <bool kTrial>
__device__ __forceinline__ void pass(const float (&P)[12], const Stage& s, const Cam& c,
                                     bool robust, bool reclass, const float* cost_prev,
                                     float* cost_out, float (&v)[32]) {
  const float sth_mono = sqrtf(CHI2_MONO), sth_stereo = sqrtf(CHI2_STEREO);
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.0f;
  for (int n = threadIdx.x - 32; n < s.N; n += NT - 32) {
    uint8_t f = s.flags[n];
    const float sm = (f & F_STEREO) ? 1.0f : 0.0f;
    const float info = s.info[n];
    const Res r = residual(P, s.X0[n], s.X1[n], s.X2[n], s.U[n], s.V[n], s.UR[n], info, sm, c);
    const bool st = f & F_STEREO;
    const float th = st ? CHI2_STEREO : CHI2_MONO;
    if (reclass) {
      const bool in = (f & F_VALID) && r.chi2 <= th && r.z > 0.0f;
      f = (f & ~F_USE) | (in ? F_USE : 0);
      s.flags[n] = f;
    }
    const float use = (f & F_USE) ? 1.0f : 0.0f;
    float c0 = r.chi2, w = 1.0f;
    if (robust) huber(r.chi2, th, st ? sth_stereo : sth_mono, c0, w);
    // the cost term: 0 where unused or behind
    const float cost = (r.z > 0.0f && use > 0.5f) ? c0 : 0.0f;
    cost_out[n] = cost;
    if constexpr (kTrial) v[NHG] += cost - cost_prev[n];
    w = w * info * use;
    if (!(r.z > 0.0f)) w = 0.0f;
    const float ws = w * sm;
    // rows of the projection Jacobian wrt the camera-frame point
    const float du[3] = {c.fx * r.iz, 0.0f, -c.fx * r.x * r.iz2};
    const float dv[3] = {0.0f, c.fy * r.iz, -c.fy * r.y * r.iz2};
    float Ju[6], Jv[6];
    pose_row(du, r, Ju);
    pose_row(dv, r, Jv);
    // H += (w Ju)^T Ju + (w Jv)^T Jv [+ (ws Jur)^T Jur], g likewise. Ju[1]
    // and Jv[0] are structurally 0, and so is the stereo row where ws = 0:
    // their products are skipped (they add +-0 to finite sums).
    float wJu[6], wJv[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      wJu[a] = w * Ju[a];
      wJv[a] = w * Jv[a];
    }
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b, ++k) {
        float h = 0.0f;
        if (a != 1 && b != 1) h = wJu[a] * Ju[b];
        if (a != 0 && b != 0) h = h + wJv[a] * Jv[b];
        v[k] += h;
      }
      v[21 + a] += (a != 1 ? wJu[a] * r.ru : 0.0f) + (a != 0 ? wJv[a] * r.rv : 0.0f);
    }
    if (ws != 0.0f) {
      const float dur[3] = {du[0], du[1], du[2] + c.bf * r.iz2};
      float Jur[6], wsJur[6];
      pose_row(dur, r, Jur);
#pragma unroll
      for (int a = 0; a < 6; ++a) wsJur[a] = ws * Jur[a];
      k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b, ++k)
          if (a != 1 && b != 1) v[k] += wsJur[a] * Jur[b];
        if (a != 1) v[21 + a] += wsJur[a] * r.rur;
      }
    }
  }
}

// One stage of the warp reduce-scatter: lanes that differ in bit OFF
// swap halves, so afterwards v[i], i < OFF, holds value i + (lane & OFF)'s
// bits above, summed over both lanes. Offsets are template arguments, so
// every index is a compile-time constant and v stays in registers.
template <int OFF>
__device__ __forceinline__ void rs_stage(float (&v)[32], int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// Sums v over the block in a fixed order. Each warp reduce-scatters (31
// shuffles; lane k ends with the warp's sum of value k) and writes its
// partials to part; after one barrier warp 0 sums the partials of value k
// in warp order: lane k of warp 0 returns the block's total of value k
// (other warps return nothing meaningful). part is free again after the
// caller's next barrier.
__device__ __forceinline__ float block_reduce(float (&v)[32], float* part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  rs_stage<16>(v, lane);
  rs_stage<8>(v, lane);
  rs_stage<4>(v, lane);
  rs_stage<2>(v, lane);
  rs_stage<1>(v, lane);
  part[warp * 32 + lane] = v[0];
  __syncthreads();
  float s = 0.0f;
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) s += part[w * 32 + lane];
  }
  return s;
}

// Jacobi-scaled, damped 6x6 Cholesky solve of H dx = -g (the guards of
// _chol6_solve: 1e-30 on the scaling, +1e-7 on the damped diagonal, 1e-20
// under the square root). hg: the 21 lower-triangular H entries, then g.
// Called by a whole warp; every lane gets dx. The independent square roots
// and divisions (the six Jacobi scales, each Cholesky column's
// sub-diagonal) run one per lane and are broadcast by shuffles: each IEEE
// operation is a branchy sequence, and ptxas does not interleave several
// of them in one thread. Every lane does the same arithmetic as a serial
// solve, so the bits are those of the serial version.
__device__ __forceinline__ void chol6_solve(const float* hg, float damping, float (&dx)[6]) {
  const int lane = threadIdx.x & 31;
  float H[6][6], b[6], sc[6], L[6][6], y[6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = 0; c <= a; ++c, ++k) H[a][c] = H[c][a] = hg[k];
#pragma unroll
  for (int a = 0; a < 6; ++a) b[a] = -hg[21 + a];
  {
    float hii = H[0][0];
#pragma unroll
    for (int i = 1; i < 6; ++i)
      if (lane == i) hii = H[i][i];
    const float mine = 1.0f / sqrtf(fmaxf(hii, 1e-30f));
#pragma unroll
    for (int i = 0; i < 6; ++i) sc[i] = __shfl_sync(FULL, mine, i);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) H[i][j] = H[i][j] * sc[i] * sc[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = b[i] * sc[i];
  // column j: its diagonal, then lane i > j divides row i, and lane 0
  // the forward substitution's y[j] (whose inputs are all known by then)
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float sj[6];
#pragma unroll
    for (int i = j; i < 6; ++i) {
      float s = H[i][j] + (i == j ? (damping + 1e-7f) : 0.0f);
#pragma unroll
      for (int m = 0; m < j; ++m) s = s - L[i][m] * L[j][m];
      sj[i] = s;
    }
    L[j][j] = sqrtf(fmaxf(sj[j], 1e-20f));
    float num = b[j];
#pragma unroll
    for (int m = 0; m < j; ++m) num = num - L[j][m] * y[m];
#pragma unroll
    for (int i = j + 1; i < 6; ++i)
      if (lane == i) num = sj[i];
    const float q = num / L[j][j];
    y[j] = __shfl_sync(FULL, q, 0);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) L[i][j] = __shfl_sync(FULL, q, i);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) s = s - L[m][i] * dx[m];
    dx[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) dx[i] = dx[i] * sc[i];
}

// Pn = exp(dx) * P (left update), with the small-angle series below 1e-8.
// Called by a whole warp; its six divisions run one per lane.
__device__ __forceinline__ void se3_update(const float (&dx)[6], const float* P,
                                           float (&Pn)[12]) {
  const int lane = threadIdx.x & 31;
  const float p0 = dx[3], p1 = dx[4], p2 = dx[5];
  const float t2 = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = t2 < 1e-8f;
  const float safe_t2 = small ? 1.0f : t2;
  const float th = sqrtf(safe_t2);
  // sin and cos in double through sincospi, whose argument reduction is
  // exact: no Payne-Hanek slow path (sinf's, with a local array, hence a
  // stack frame), and f32 results at least as accurate as sinf/cosf
  double sd, cd;
  sincospi(static_cast<double>(th) * INV_PI, &sd, &cd);
  const float sn = static_cast<float>(sd), cs = static_cast<float>(cd);
  float num = sn, den = th;
  if (lane == 1) num = 1.0f - cs, den = safe_t2;
  if (lane == 2) num = th - sn, den = safe_t2 * th;
  if (lane == 3) num = t2, den = 6.0f;
  if (lane == 4) num = t2, den = 24.0f;
  if (lane == 5) num = t2, den = 120.0f;
  const float q = num / den;
  float qs[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) qs[i] = __shfl_sync(FULL, q, i);
  const float a = small ? 1.0f - qs[3] : qs[0];
  const float bb = small ? 0.5f - qs[4] : qs[1];
  const float cc = small ? 1.0f / 6.0f - qs[5] : qs[2];
  const float W[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      R[i][j] = eye + a * W[i][j] + bb * w2;
      V[i][j] = eye + bb * W[i][j] + cc * w2;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Pn[3 * i + j] = R[i][0] * P[j] + R[i][1] * P[3 + j] + R[i][2] * P[6 + j];
    const float dt = V[i][0] * dx[0] + V[i][1] * dx[1] + V[i][2] * dx[2];
    Pn[9 + i] = R[i][0] * P[9] + R[i][1] * P[10] + R[i][2] * P[11] + dt;
  }
}

// Warp 0: the next trial pose from the H, g in sHG at the pose in sP
// with damping lam; returns |dx|^2 (the LM step's squared length).
__device__ __forceinline__ float solve_trial(const float* sHG, const float* sP, float lam,
                                             float (&Pn)[12]) {
  float dx[6];
  chol6_solve(sHG, lam, dx);
  se3_update(dx, sP, Pn);
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) sq += dx[i] * dx[i];
  return sq;
}

__global__ void __launch_bounds__(NT)
pose_lm_kernel(const float* __restrict__ X, const float* __restrict__ uvr,
               const float* __restrict__ info, const uint8_t* __restrict__ smask,
               const uint8_t* __restrict__ valid, int N, const float* __restrict__ R0,
               const float* __restrict__ t0, Cam cam, float damping, float tol,
               int n_rounds, int n_iters, float* __restrict__ R_out,
               float* __restrict__ t_out, uint8_t* __restrict__ inl_out,
               float* __restrict__ chi2_out) {
  extern __shared__ float smem[];
  __shared__ float part[NW * 32];
  // warp 0's LM state, and its decisions that every thread reads after
  // the step's second barrier: the pose to evaluate next, whether to, and
  // which cost plane holds c(P)
  __shared__ float sP[12], sPn[12], sHG[NHG];
  __shared__ int s_cont, s_cur;
  const Stage s{smem,         smem + N,     smem + 2 * N, smem + 3 * N,
                smem + 4 * N, smem + 5 * N, smem + 6 * N, smem + 7 * N,
                reinterpret_cast<uint8_t*>(smem + 9 * N), N};
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool solver = tid < 32;  // warp 0 solves; warps 1.. own the observations
  for (int n = tid; n < N; n += NT) {
    s.X0[n] = X[3 * n];
    s.X1[n] = X[3 * n + 1];
    s.X2[n] = X[3 * n + 2];
    s.U[n] = uvr[3 * n];
    s.V[n] = uvr[3 * n + 1];
    s.UR[n] = uvr[3 * n + 2];
    s.info[n] = info[n];
    s.flags[n] = (smask[n] ? F_STEREO : 0) | (valid[n] ? (F_VALID | F_USE) : 0);
  }
  if (tid < 9) sP[tid] = R0[tid];
  if (tid < 3) sP[9 + tid] = t0[tid];
  if (tid == 0) s_cur = 0;
  __syncthreads();

  // warp 0's scalars (the other warps never read them)
  float lam = 0.0f, sq = 0.0f, sqstep = 0.0f;
  int it = 0;
  // warp 0 publishes the next trial pose (lane 0 writes it) and the flag
  auto publish = [&](bool cont, const float (&Pn)[12]) {
    __syncwarp();
    if (lane == 0) {
      if (cont) {
#pragma unroll
        for (int i = 0; i < 12; ++i) sPn[i] = Pn[i];
      }
      s_cont = cont;
    }
  };

  float v[32];
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < n_rounds - 1;
    // the round's first evaluation, by warps 1..: re-classify (ref:
    // Optimizer.cc:1100+) and evaluate H, g and c(P) under the round's
    // robust flag and use-mask
    if (solver) {
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = 0.0f;
    } else {
      float P[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) P[i] = sP[i];
      pass<false>(P, s, cam, robust, rnd > 0, nullptr, s.cost + s_cur * N, v);
    }
    const float tot = block_reduce(v, part);
    if (solver) {
      if (lane < NHG) sHG[lane] = tot;
      __syncwarp();
      lam = damping;
      sq = INFINITY;
      it = 0;
      const bool cont = it < n_iters && sq > tol;
      float Pn[12];
      if (cont) sqstep = solve_trial(sHG, sP, lam, Pn);
      publish(cont, Pn);
    }
    __syncthreads();
    while (s_cont) {
      // warps 1.. evaluate the trial pose; meanwhile warp 0 solves for
      // the trial that follows a rejection (the same H, g and P, lambda x
      // 4), which is most LM steps once the pose has converged
      float Prej[12], sqrej = 0.0f;
      if (solver) {
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = 0.0f;
        if (it + 1 < n_iters)
          sqrej = solve_trial(sHG, sP, fminf(fmaxf(lam * 4.0f, 1e-7f), 1e2f), Prej);
      } else {
        float Pn[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) Pn[i] = sPn[i];
        const int cur = s_cur;
        pass<true>(Pn, s, cam, robust, false, s.cost + cur * N, s.cost + (cur ^ 1) * N, v);
      }
      const float tot_n = block_reduce(v, part);
      if (solver) {
        const bool accept = __shfl_sync(FULL, tot_n, NHG) < 0.0f;
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-7f), 1e2f);
        sq = accept ? sqstep : INFINITY;
        ++it;
        const bool cont = it < n_iters && sq > tol;
        if (accept) {
          if (lane < 12) sP[lane] = sPn[lane];
          if (lane < NHG) sHG[lane] = tot_n;
          if (lane == 0) s_cur ^= 1;
          __syncwarp();
          float Pn[12];
          if (cont) sqstep = solve_trial(sHG, sP, lam, Pn);
          publish(cont, Pn);
        } else {
          sqstep = sqrej;
          publish(cont, Prej);
        }
      }
      __syncthreads();
    }
  }

  // outputs at the final pose; the inliers are the last round's
  // re-classification
  float P[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = sP[i];
  if (tid < 9) R_out[tid] = sP[tid];
  if (tid < 3) t_out[tid] = sP[9 + tid];
  for (int n = tid; n < N; n += NT) {
    const uint8_t f = s.flags[n];
    const float sm = (f & F_STEREO) ? 1.0f : 0.0f;
    const Res r =
        residual(P, s.X0[n], s.X1[n], s.X2[n], s.U[n], s.V[n], s.UR[n], s.info[n], sm, cam);
    const float th = (f & F_STEREO) ? CHI2_STEREO : CHI2_MONO;
    chi2_out[n] = r.chi2;
    inl_out[n] = ((f & F_VALID) && r.chi2 <= th && r.z > 0.0f) ? 1 : 0;
  }
}

}  // namespace

extern "C" int pose_lm(const float* X, const float* uvr, const float* info,
                       const uint8_t* smask, const uint8_t* valid, int N, const float* R0,
                       const float* t0, float fx, float fy, float cx, float cy, float bf,
                       float damping, float tol, int n_rounds, int n_iters, float* R_out,
                       float* t_out, uint8_t* inl_out, float* chi2_out, void* stream) {
  // 7 observation planes + 2 cost planes of f32, then one flag byte each
  const size_t smem = (size_t)9 * N * sizeof(float) + (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pose_lm_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      X, uvr, info, smask, valid, N, R0, t0, Cam{fx, fy, cx, cy, bf}, damping, tol, n_rounds,
      n_iters, R_out, t_out, inl_out, chi2_out);
  return (int)cudaGetLastError();
}
