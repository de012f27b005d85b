// TGS-soft solve for one world: the whole substep pipeline, contacts and
// joints, in one launch.
//
// Replaces the two Pallas TPU kernels of box2d_tpu/solver_pallas.py that
// compute this pipeline: `_solver_kernel` (run_solver_kernel, the
// VMEM-resident mode 1) and the contact branch of `_tiled_kernel`
// (run_solver_kernel_tiled, the HBM-streaming mode 2). On this card the
// VMEM/HBM split that separates them does not exist, so one kernel serves
// both. The arrays are K1's own layout (see contact_solver.py):
//   scalars (8) [h, inv_h, contact_speed, restitution_threshold,
//                max_linear_speed, 0, 0, 0]
//   idx (2, L) i32, -1 = dead lane; data (33, L); acc (9, L)
//   body (8, Nb) [vx, vy, w, dpx, dpy, dqc, dqs, pos_active]
//   params (12, Nb) [inv_m, inv_I, ext_dvx, ext_dvy, ext_dw, lin_damp,
//                    ang_damp, lock_x, lock_y, lock_w, max_w, vel_active]
// Windows: color bucket c is lanes [c*chunk, (c+1)*chunk) for c < n_colors,
// then the overflow tail [l0, L). Per stage k of 3*nsub+1 (p = k % 3, the
// last stage p = 3): p==0 integrates velocities then warm-starts, p==1
// solves with bias, p==2 integrates positions then relaxes, p==3 applies
// restitution.
//
// Every window is one Jacobi window, as in the Pallas kernels: all lanes
// read the body state as it was at the window's start (phase 1 writes the
// lane's velocity deltas to scratch), then the deltas of dynamic endpoints
// are added (phase 2, atomicAdd). Within a color bucket no two lanes share
// a dynamic body, so this equals the Gauss-Seidel sweep; in the overflow
// tail it is the mass-split Jacobi pass. Static and kinematic endpoints have
// zero inverse mass, so their delta is exactly zero and is not written.
//
// What bounds it: one thread block (one SM of the card's 132) walks all
// windows, with two block barriers per window, and each lane gathers its
// two bodies' rows from L2 (Nb x 8 floats: 316 KB at pyramid-140, too big
// for shared memory). The design keeps everything in one launch (no
// per-window launch or host round trip) and reads body rows through L2
// (ld.global.cg) so that other lanes' atomics are seen after each barrier.
// Spreading windows over more SMs (grid-wide sync) or batching worlds over
// blocks (gridDim.x) is later work.
//
// Joints: a jointed world launches the second instance of the kernel
// (solve_kernel<true>), which sweeps a joint segment ahead of each color's
// contact bucket (joint_sweep.cuh): joints of color c, then contacts of
// color c, for c ascending, then the overflow tail, in every stage but the
// restitution stage. A joint segment is a Jacobi window like any other. A
// world without live joints launches solve_kernel<false>, which holds no
// joint code, so its registers and its results are those of the
// contact-only kernel.

#include <cuda_runtime.h>

#include "joint_sweep.cuh"

namespace {

constexpr int kThreads = 1024;

enum Row {
  NX = 0, NY, FRICTION, RESTITUTION, TANGENT_SPEED, ROLLING_RES,
  ROLLING_MASS, SOFT_BIAS, SOFT_MASS, SOFT_IMP,
  AX0, AY0, BX0, BY0, AX1, AY1, BX1, BY1,
  SEP0, SEP1, NMASS0, NMASS1, TMASS0, TMASS1, RELV0, RELV1,
  MASK0, MASK1, INV_MA, INV_MB, INV_IA, INV_IB, RELAX
};

struct Problem {
  const float* scal;
  const int* idx;
  const float* data;
  const float* params;
  float* body;
  float* acc;
  float* scratch;  // (6, scratch_w) per-lane velocity deltas of a window
  int nb, L, chunk, l0, n_colors, nsub, scratch_w;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ void integrate_velocities(const Problem& q, float max_lin) {
  const int nb = q.nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const float* prm = q.params;
    if (!(prm[11 * nb + i] > 0.0f)) continue;
    float bx = __ldcg(q.body + 0 * nb + i);
    float by = __ldcg(q.body + 1 * nb + i);
    float bw = __ldcg(q.body + 2 * nb + i);
    float vx = prm[2 * nb + i] + prm[5 * nb + i] * bx;
    float vy = prm[3 * nb + i] + prm[5 * nb + i] * by;
    float w = prm[4 * nb + i] + prm[6 * nb + i] * bw;
    float vv = vx * vx + vy * vy;
    float scale = vv > max_lin * max_lin
        ? max_lin * rsqrtf(fmaxf(vv, 1e-12f)) : 1.0f;
    vx = vx * scale;
    vy = vy * scale;
    float mw = prm[10 * nb + i];
    w = clampf(w, -mw, mw);
    vx = vx * (1.0f - prm[7 * nb + i]);
    vy = vy * (1.0f - prm[8 * nb + i]);
    w = w * (1.0f - prm[9 * nb + i]);
    __stcg(q.body + 0 * nb + i, vx);
    __stcg(q.body + 1 * nb + i, vy);
    __stcg(q.body + 2 * nb + i, w);
  }
}

__device__ void integrate_positions(const Problem& q, float h) {
  const int nb = q.nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    if (!(__ldcg(q.body + 7 * nb + i) > 0.0f)) continue;
    float vx = __ldcg(q.body + 0 * nb + i);
    float vy = __ldcg(q.body + 1 * nb + i);
    float w = __ldcg(q.body + 2 * nb + i);
    float dpx = __ldcg(q.body + 3 * nb + i) + h * vx;
    float dpy = __ldcg(q.body + 4 * nb + i) + h * vy;
    float da = h * w;
    float c0 = __ldcg(q.body + 5 * nb + i);
    float s0 = __ldcg(q.body + 6 * nb + i);
    float c1 = c0 - da * s0;
    float s1 = s0 + da * c0;
    float inv = rsqrtf(fmaxf(c1 * c1 + s1 * s1, 1e-12f));
    __stcg(q.body + 3 * nb + i, dpx);
    __stcg(q.body + 4 * nb + i, dpy);
    __stcg(q.body + 5 * nb + i, c1 * inv);
    __stcg(q.body + 6 * nb + i, s1 * inv);
  }
}

// One constraint lane of stage p: returns the six velocity deltas
// (a: vx, vy, w; b: vx, vy, w) and, for p != 0, writes the lane's
// accumulator column. The arithmetic follows _solver_kernel's contact_sweep
// operation by operation, including its 0/1 stage flags.
__device__ void solve_lane(const Problem& q, int lane, int ia, int ib, int p,
                           float inv_h, float contact_speed,
                           float restitution_threshold, float out[6]) {
  const int L = q.L;
  const int nb = q.nb;
  const float* d = q.data + lane;
  float* a = q.acc + lane;
  auto row = [&](int r) { return __ldg(d + r * L); };

  const float nx = row(NX), ny = row(NY);
  const float tx = ny, ty = -nx;
  const float inv_ma = row(INV_MA), inv_mb = row(INV_MB);
  const float inv_ia = row(INV_IA), inv_ib = row(INV_IB);
  float ni[2] = {a[0 * L], a[1 * L]};
  float ti[2] = {a[2 * L], a[3 * L]};
  float tni[2] = {a[4 * L], a[5 * L]};
  const float roll = a[6 * L];

  if (p == 0) {  // warm start: deltas from the stored impulses only
    float dvax = 0.0f, dvay = 0.0f, dwa = 0.0f;
    float dvbx = 0.0f, dvby = 0.0f, dwb = 0.0f;
    for (int j = 0; j < 2; ++j) {
      const float mask = row(MASK0 + j);
      const float pn = ni[j] * mask;
      const float pt = ti[j] * mask;
      const float px = pn * nx + pt * tx;
      const float py = pn * ny + pt * ty;
      const float rax = row(AX0 + 4 * j), ray = row(AY0 + 4 * j);
      const float rbx = row(BX0 + 4 * j), rby = row(BY0 + 4 * j);
      dvax = dvax - inv_ma * px;
      dvay = dvay - inv_ma * py;
      dwa = dwa - inv_ia * (rax * py - ray * px);
      dvbx = dvbx + inv_mb * px;
      dvby = dvby + inv_mb * py;
      dwb = dwb + inv_ib * (rbx * py - rby * px);
    }
    dwa = dwa - inv_ia * roll;
    dwb = dwb + inv_ib * roll;
    out[0] = dvax; out[1] = dvay; out[2] = dwa;
    out[3] = dvbx; out[4] = dvby; out[5] = dwb;
    return;
  }

  const float bias_f = p == 1 ? 1.0f : 0.0f;
  const float rest_f = p == 3 ? 1.0f : 0.0f;
  const float solve_f = 1.0f - rest_f;
  const float* ba = q.body + ia;
  const float* bb = q.body + ib;
  const float va0 = __ldcg(ba), va1 = __ldcg(ba + nb), wa0 = __ldcg(ba + 2 * nb);
  const float vb0 = __ldcg(bb), vb1 = __ldcg(bb + nb), wb0 = __ldcg(bb + 2 * nb);
  const float dpx = __ldcg(bb + 3 * nb) - __ldcg(ba + 3 * nb);
  const float dpy = __ldcg(bb + 4 * nb) - __ldcg(ba + 4 * nb);
  const float dqca = __ldcg(ba + 5 * nb), dqsa = __ldcg(ba + 6 * nb);
  const float dqcb = __ldcg(bb + 5 * nb), dqsb = __ldcg(bb + 6 * nb);
  float vax = va0, vay = va1, wa = wa0;
  float vbx = vb0, vby = vb1, wb = wb0;

  const float restitution = row(RESTITUTION);
  const float soft_bias = row(SOFT_BIAS);
  const float soft_mass = row(SOFT_MASS);
  const float soft_imp = row(SOFT_IMP);
  const float relaxv = row(RELAX);
  float total_normal = 0.0f;

  for (int j = 0; j < 2; ++j) {
    const float rax = row(AX0 + 4 * j), ray = row(AY0 + 4 * j);
    const float rbx = row(BX0 + 4 * j), rby = row(BY0 + 4 * j);
    const float mask = row(MASK0 + j);
    const float nmass = row(NMASS0 + j);
    const float vrx = (vbx - wb * rby) - (vax - wa * ray);
    const float vry = (vby + wb * rbx) - (vay + wa * rax);
    const float vn = vrx * nx + vry * ny;

    const float rrx_a = dqca * rax - dqsa * ray;
    const float rry_a = dqsa * rax + dqca * ray;
    const float rrx_b = dqcb * rbx - dqsb * rby;
    const float rry_b = dqsb * rbx + dqcb * rby;
    const float dsx = dpx + rrx_b - rrx_a;
    const float dsy = dpy + rry_b - rry_a;
    const float s = row(SEP0 + j) + dsx * nx + dsy * ny;
    const bool speculative = s > 0.0f;
    const float bias = speculative
        ? s * inv_h
        : bias_f * fmaxf(soft_mass * soft_bias * s, -contact_speed);
    const float mscale = speculative ? 1.0f
                                     : 1.0f + bias_f * (soft_mass - 1.0f);
    const float iscale = speculative ? 0.0f : bias_f * soft_imp;
    const float imp_s = (-nmass * (mscale * vn + bias) - iscale * ni[j])
                        * relaxv;
    const float new_s = fmaxf(ni[j] + imp_s, 0.0f) * mask;
    const float d_s = new_s - ni[j];

    const float relv = row(RELV0 + j);
    const float apply_r = ((restitution != 0.0f)
                           && (relv < -restitution_threshold)
                           && (tni[j] > 0.0f)) ? mask : 0.0f;
    const float imp_r = -nmass * (vn + restitution * relv);
    const float new_r = fmaxf(ni[j] + imp_r, 0.0f);
    const float d_r = (new_r - ni[j]) * apply_r;

    const float impulse = solve_f * d_s + rest_f * d_r;
    ni[j] = ni[j] + impulse;
    tni[j] = tni[j] + solve_f * new_s + rest_f * d_r;
    total_normal = total_normal + new_s;

    const float px = impulse * nx;
    const float py = impulse * ny;
    vax = vax - inv_ma * px;
    vay = vay - inv_ma * py;
    wa = wa - inv_ia * (rax * py - ray * px);
    vbx = vbx + inv_mb * px;
    vby = vby + inv_mb * py;
    wb = wb + inv_ib * (rbx * py - rby * px);
  }

  const float friction = row(FRICTION);
  const float tangent_speed = row(TANGENT_SPEED);
  for (int j = 0; j < 2; ++j) {
    const float rax = row(AX0 + 4 * j), ray = row(AY0 + 4 * j);
    const float rbx = row(BX0 + 4 * j), rby = row(BY0 + 4 * j);
    const float mask = row(MASK0 + j);
    const float tmass = row(TMASS0 + j);
    const float vrx = (vbx - wb * rby) - (vax - wa * ray);
    const float vry = (vby + wb * rbx) - (vay + wa * rax);
    const float vt = vrx * tx + vry * ty - tangent_speed;
    const float max_f = friction * ni[j];
    const float new_t = clampf(ti[j] - tmass * vt * relaxv, -max_f, max_f)
                        * mask;
    const float impulse = solve_f * (new_t - ti[j]);
    ti[j] = ti[j] + impulse;
    const float px = impulse * tx;
    const float py = impulse * ty;
    vax = vax - inv_ma * px;
    vay = vay - inv_ma * py;
    wa = wa - inv_ia * (rax * py - ray * px);
    vbx = vbx + inv_mb * px;
    vby = vby + inv_mb * py;
    wb = wb + inv_ib * (rbx * py - rby * px);
  }

  const float rolling_mass = row(ROLLING_MASS);
  const float max_l = row(ROLLING_RES) * total_normal;
  const float new_roll = clampf(roll - rolling_mass * (wb - wa) * relaxv,
                                -max_l, max_l);
  const float dl = solve_f * (new_roll - roll);
  wa = wa - inv_ia * dl;
  wb = wb + inv_ib * dl;

  a[0 * L] = ni[0];
  a[1 * L] = ni[1];
  a[2 * L] = ti[0];
  a[3 * L] = ti[1];
  a[4 * L] = tni[0];
  a[5 * L] = tni[1];
  a[6 * L] = roll + dl;

  out[0] = vax - va0; out[1] = vay - va1; out[2] = wa - wa0;
  out[3] = vbx - vb0; out[4] = vby - vb1; out[5] = wb - wb0;
}

// Phase 2 of a window: add the scratch deltas of one lane to its dynamic
// endpoints.
__device__ __forceinline__ void add_deltas(float* body, int nb, int ia,
                                           int ib, bool dyn_a, bool dyn_b,
                                           const float* s, int sw) {
  if (dyn_a) {
    atomicAdd(body + 0 * nb + ia, s[0 * sw]);
    atomicAdd(body + 1 * nb + ia, s[1 * sw]);
    atomicAdd(body + 2 * nb + ia, s[2 * sw]);
  }
  if (dyn_b) {
    atomicAdd(body + 0 * nb + ib, s[3 * sw]);
    atomicAdd(body + 1 * nb + ib, s[4 * sw]);
    atomicAdd(body + 2 * nb + ib, s[5 * sw]);
  }
}

// One joint segment [lo, hi) of stage p as a Jacobi window.
__device__ void joint_window(const Problem& q, const JointRegion& jr, int lo,
                             int hi, int p, float h, float inv_h) {
  const int LJ = jr.LJ;
  for (int lane = lo + threadIdx.x; lane < hi; lane += blockDim.x) {
    const int ia = jr.idx[lane];
    if (ia < 0) continue;
    const int ib = jr.idx[LJ + lane];
    float dl[6];
    joint_lane(jr, q.body, q.nb, lane, ia, ib, p, h, inv_h, dl);
    float* s = q.scratch + (lane - lo);
    for (int r = 0; r < 6; ++r) s[r * q.scratch_w] = dl[r];
  }
  __syncthreads();
  for (int lane = lo + threadIdx.x; lane < hi; lane += blockDim.x) {
    const int ia = jr.idx[lane];
    if (ia < 0) continue;
    const int ib = jr.idx[LJ + lane];
    const float* d = jr.data + lane;
    add_deltas(q.body, q.nb, ia, ib,
               d[JINV_MA * LJ] > 0.0f || d[JINV_IA * LJ] > 0.0f,
               d[JINV_MB * LJ] > 0.0f || d[JINV_IB * LJ] > 0.0f,
               q.scratch + (lane - lo), q.scratch_w);
  }
  __syncthreads();
}

template <bool kJoints>
__global__ void __launch_bounds__(kThreads)
solve_kernel(Problem q, JointRegion jr, const float* acc_in,
             const float* body_in, const float* jacc_in) {
  const float h = q.scal[0];
  const float inv_h = q.scal[1];
  const float contact_speed = q.scal[2];
  const float restitution_threshold = q.scal[3];
  const float max_lin = q.scal[4];
  const int L = q.L;
  const int nb = q.nb;

  for (int i = threadIdx.x; i < 8 * nb; i += blockDim.x)
    __stcg(q.body + i, body_in[i]);
  for (int i = threadIdx.x; i < 9 * L; i += blockDim.x)
    q.acc[i] = acc_in[i];
  if constexpr (kJoints) {
    for (int i = threadIdx.x; i < 9 * jr.LJ; i += blockDim.x)
      jr.acc[i] = jacc_in[i];
  }
  __syncthreads();

  const int stages = 3 * q.nsub + 1;
  for (int k = 0; k < stages; ++k) {
    const int p = (k == stages - 1) ? 3 : k % 3;
    if (p == 0) {
      integrate_velocities(q, max_lin);
      __syncthreads();
    } else if (p == 2) {
      integrate_positions(q, h);
      __syncthreads();
    }
    for (int win = 0; win <= q.n_colors; ++win) {
      if constexpr (kJoints) {
        if (p != 3 && win < q.n_colors) {
          const int jlo = jr.off[win];
          const int jhi = jr.off[win + 1];
          if (jhi > jlo) joint_window(q, jr, jlo, jhi, p, h, inv_h);
        }
      }
      const int lo = win < q.n_colors ? win * q.chunk : q.l0;
      const int hi = win < q.n_colors ? lo + q.chunk : L;
      // phase 1: every lane reads the window-start state
      for (int lane = lo + threadIdx.x; lane < hi; lane += blockDim.x) {
        const int ia = q.idx[lane];
        if (ia < 0) continue;
        const int ib = q.idx[L + lane];
        float dl[6];
        solve_lane(q, lane, ia, ib, p, inv_h, contact_speed,
                   restitution_threshold, dl);
        float* s = q.scratch + (lane - lo);
        for (int r = 0; r < 6; ++r) s[r * q.scratch_w] = dl[r];
      }
      __syncthreads();
      // phase 2: add the deltas of dynamic endpoints
      for (int lane = lo + threadIdx.x; lane < hi; lane += blockDim.x) {
        const int ia = q.idx[lane];
        if (ia < 0) continue;
        const int ib = q.idx[L + lane];
        const float* d = q.data + lane;
        add_deltas(q.body, nb, ia, ib,
                   d[INV_MA * L] > 0.0f || d[INV_IA * L] > 0.0f,
                   d[INV_MB * L] > 0.0f || d[INV_IB * L] > 0.0f,
                   q.scratch + (lane - lo), q.scratch_w);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() of the
// launch.
extern "C" int b2t_contact_solve(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, float* scratch,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int scratch_w,
    void* stream) {
  Problem q{scalars, idx, data, params, out_body, out_acc, scratch,
            nb, L, chunk, l0, n_colors, nsub, scratch_w};
  JointRegion none{nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  solve_kernel<false><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, none, acc_in, body_in, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The same pipeline with a joint region: jidx (2, LJ), jdata (39, LJ),
// jacc_in / out_jacc (9, LJ), jtype (LJ), joff (n_colors + 1).
extern "C" int b2t_contact_solve_joints(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, float* scratch,
    const int* jidx, const float* jdata, const float* jacc_in,
    const int* jtype, const int* joff, float* out_jacc,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int scratch_w,
    int LJ, void* stream) {
  Problem q{scalars, idx, data, params, out_body, out_acc, scratch,
            nb, L, chunk, l0, n_colors, nsub, scratch_w};
  JointRegion jr{jidx, jdata, out_jacc, jtype, joff, LJ};
  solve_kernel<true><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, jr, acc_in, body_in, jacc_in);
  return static_cast<int>(cudaGetLastError());
}
