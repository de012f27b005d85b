// TGS-soft solve for one world: the whole substep pipeline, contacts and
// joints, in one launch of one thread-block cluster.
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
// then the overflow tail [l0, L), cut into windows of tail_w lanes from l0
// (contact_solver.tail_window: the width the JAX package's Pallas path
// sweeps the tail at). Per stage k of 3*nsub+1 (p = k % 3, the
// last stage p = 3): p==0 integrates velocities then warm-starts, p==1
// solves with bias, p==2 integrates positions then relaxes, p==3 applies
// restitution.
//
// The window table. The prologue finds where the live lanes of each
// bucket and of the tail end (only dead lanes being -1 is relied on) and
// keeps the table in each CTA's shared memory; every stage then walks only
// the non-empty windows, in the order of contact_solver.window_table: for
// each color c its joint segment and its contact bucket, then the tail's
// windows [l0 + k*tail_w, l0 + (k+1)*tail_w) up to its last live lane. An
// empty bucket costs neither a pass nor a barrier. (A tail window between
// two live ones that holds no live lane would be visited, as a no-op: the
// layout packs the live tail lanes from l0, so there is none.) The Pallas
// kernels walk a list of active windows too (window_metadata); the table
// is that list, built on the card without a host read.
//
// Two kinds of window. In a color bucket, and in the joint segment of a
// color that did not overflow, no two lanes share a dynamic body: that is
// what the coloring guarantees, and joints and contacts are colored
// together, so joint segment c and bucket c share none either. There a
// lane reads its two bodies, solves, and adds v - v0 to each dynamic
// endpoint at once; no other lane of the window touches that body, so the
// add in L2 leaves v0 + (v - v0), what the twin's index_add_ leaves. Joint
// segment c and bucket c are one such window, with one barrier behind it.
// The overflow tail's windows and the overflow color's joint segment share
// bodies and stay Jacobi windows, each in two phases: phase 1 adds each
// lane's deltas to its bodies' sums, barrier, phase 2 (a pass over the
// bodies) adds each body's sums to its velocity, barrier; so every tail
// window reads the body state its predecessor left, as the reference's
// windows in sequence do. The sums are fixed point (int64 in units of
// 2^-32, added with integer atomics), so they come out the same whatever
// order the lanes add in: a launch gives the same bits every time, and a
// world in a batched launch the same bits as alone. The twin's index_add_
// adds floats lane by lane; the two differ by that rounding alone. A delta
// of 2^30 or more, or one that is not finite, makes its body's velocity
// NaN. The sums live in jsum, zeroed once by a call that has such
// windows; phase 2 clears what it adds. That joint segment is
// cut as the tiled Pallas kernel cuts it: one window per joint type, at
// most `jwin` lanes each. Static and kinematic endpoints have zero inverse
// mass; their delta is exactly zero and is not written.
//
// The cluster. A launch is one cluster of kCluster CTAs of kThreads
// threads on as many SMs. A window's lanes are dealt to the CTAs a warp at
// a time, so a 2,560-lane bucket of pyramid-140 is one pass spread over
// eight SMs (so is each of its tail's two 2,560-lane windows), and so
// are the body integration passes; the barriers are the cluster's hardware barrier
// (barrier.cluster.arrive.release / wait.acquire). A call whose every pass
// fits in one CTA (pyramid-20: 211 bodies, windows of at most 128 lanes)
// runs on CTA 0 alone, behind block barriers, which cost less; the other
// CTAs leave after the prologue. Body rows, accumulators and scratch stay
// in device memory and are read and written only through L2
// (ld/st.global.cg and atomics), never through an SM's L1, so a barrier's
// release/acquire is all it takes for one SM's writes to be seen by the
// others. Inputs that no one writes go through the read-only path. CTAs of
// 512 threads leave each thread 128 registers: at 1,024 threads (64
// registers) the lane's solve spilled 400-600 bytes.
//
// What bounds it: latency, not bytes or flops. The windows of a stage are
// serial, and each costs one lane's dependent chain (idx load, body
// gathers from L2, ~260 float operations, atomics whose completion the
// barrier's release waits for) plus the barrier (two for a Jacobi window):
// a call takes about (windows per stage x stages) x (that chain + a
// barrier), a few microseconds a window. Its bound from bytes is three
// orders of magnitude lower. Keeping the body rows in the cluster's
// distributed shared memory (a shorter chain) and CUDA graphs around the
// host-bound step are the next levers (ROADMAP.md section 2).
//
// Batches: b2t_contact_solve_batched solves W worlds of one capacity in
// one launch, the arrays stacked world after world. Each world runs exactly
// what a single call on its own arrays runs (its own window table, stages,
// windows and arithmetic), so world w equals a single call on world w's
// arrays, bit for bit. b2t_contact_solve_joints_batched does the same with
// each world's joint region: the joint arrays are stacked world after world
// too, at one LJ, and each world reads its own overflow flag, so a world
// whose coloring overflowed sweeps its overflow color as kind-pure Jacobi
// windows beside worlds that did not. The host picks one of two kernels,
// once for each capacity (contact_solver.batched_plan):
// - small worlds, whose every pass fits in 1,024 lanes (joint_farm(1): 5
//   bodies, 3,200 capacity lanes and about ten live ones; pyramid-20: 211
//   bodies; pyramid-40: 821), take solve_small_kernel. A world is solved by a
//   group of warps sized to its bodies (a colored window holds at most one
//   live lane a dynamic body), several groups a CTA, several CTAs an SM, with
//   no cluster: a batch of 1,024 joint_farm(1) worlds is resident at once,
//   where one cluster of eight 512-thread CTAs a world held 15 worlds at a
//   time. The world's body rows, Jacobi sums, window table and list of the
//   colors in use live in its group's slice of shared memory, so a lane
//   gathers its bodies and adds its deltas there, not in L2, a window's
//   barrier is the group's named barrier, not a 512-thread CTA barrier, and a
//   stage walks only the colors in use. The group scans its world's lanes for
//   the table once and copies its live lanes' accumulators to out_acc; the
//   grid's last CTAs copy every other lane of out_acc (dead lanes: the
//   contract writes every lane), four lanes a load, beside the solves. What
//   bounds it: a world's serial chain of windows (13 stages of its colored and
//   Jacobi windows), each one lane's dependent loads and arithmetic; and, at
//   1,024 worlds, the dead lanes' copy, whose CTAs wait for SMs that the
//   solves leave (two CTAs an SM at this instance's registers).
// - the others (pyramid-60: 1,831 bodies) take solve_kernel<*, true>, one
//   cluster of kCluster CTAs a world, each choosing the whole cluster or
//   CTA 0 as a single call does: past about 1,024 lanes a world's windows
//   are many rounds of a 128-thread group, and the cluster's 4,096
//   threads are faster (time_solver.py --paths).
// Both keep every add of the single kernel: a colored window adds at most
// one float to a body, rounded as the single kernel's L2 atomic rounds it
// (InShared::add), and a Jacobi window's sums are fixed point.
//
// Joints: a jointed world launches the second instance of the kernel
// (solve_kernel<true>), which sweeps a joint segment with each color's
// contact bucket (joint_sweep.cuh), in every stage but the restitution
// stage. A world without live joints launches solve_kernel<false>, which
// holds no joint code, so its registers and its results are those of the
// contact-only kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "joint_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;   // threads of a CTA: 128 registers each
constexpr int kCluster = 8;     // CTAs of the cluster
constexpr int kClusterThreads = kThreads * kCluster;
constexpr int kMaxColors = 32;   // the coloring's color masks hold 32 bits

constexpr int NF_ROWS = 33;   // rows of data
constexpr int NA_ROWS = 9;    // rows of acc

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
  long long* jsum;  // (4, nb): a Jacobi window's sums of each body's
                    // velocity deltas (rows 0-2, units of 2^-32) and a
                    // flag for a delta out of range (row 3)
  int nb, L, chunk, l0, n_colors, nsub;
  int tail_w;      // lanes of a tail window
};

struct Stage {
  int p;
  float h, inv_h, contact_speed, restitution_threshold;
};

// The window table, one copy in each CTA's shared memory.
struct Table {
  int part[kMaxColors + 1];  // this CTA's share: 1 + its last live lane of
                             // each contact window, 0 if none
  int end[kMaxColors + 1];   // end of the live lanes of bucket c, and of
                             // the tail at c = n_colors
  int joff[kMaxColors + 1];  // joint segment offsets
  int split;                 // the joint color swept as Jacobi windows, or -1
  int widest;                // lanes of the call's widest pass
};

// A solved lane: its endpoints, which of them are dynamic, its deltas.
struct LaneOut {
  int ia, ib;
  bool dyn_a, dyn_b;
  float d[6];
};

// This thread's place in the cluster's lane order: the cluster's warps are
// dealt round-robin over the CTAs, so a window of a few thousand lanes keeps
// every SM of the cluster busy, and a warp's lanes stay contiguous.
__device__ __forceinline__ int cluster_lane(unsigned rank) {
  return ((threadIdx.x >> 5) * kCluster + rank) * 32 + (threadIdx.x & 31);
}

// The lanes a thread takes in a pass: first, first + step, ... A call
// runs every pass on the whole cluster, or, when every pass of the call
// fits in one CTA, on CTA 0 alone, behind that CTA's barrier.
struct Pass {
  int first, step;
  bool cluster;
  int bar;   // a world group's named barrier (the small-world kernel)
};

// Where a call keeps its body rows and Jacobi sums, and the barrier behind
// a pass. InL2: device memory, read and written through L2 only (the
// cluster kernel); the barrier is the cluster's
// (barrier.cluster.arrive.release / wait.acquire: what an SM wrote to L2
// before it is seen by every SM of the cluster after it), or the CTA's.
// InShared: the world group's slice of its CTA's shared memory (the
// small-world kernel); the barrier is the group's, the named barrier
// pass.bar of pass.step threads (for a one-warp group too: it costs a
// third of a __syncwarp's cycles there, PERF.md). add: a velocity delta added
// to a body, by one lane at a time (a colored window adds at most once to
// a body, the phase 2 of a Jacobi window once for each body): a float
// atomic in L2, which rounds to nearest and flushes subnormals (PTX
// atom.add.f32); the same rounding as one add.rn.ftz.f32 in shared memory,
// where an atomic costs hundreds of cycles more. add_sum: a Jacobi
// window's fixed-point sums, which lanes share: integer atomics. ld_acc /
// st_acc: a lane's accumulators in out_acc, which after the prologue only
// the thread that solves the lane reads and writes: through L2 in the
// cluster kernel (its CTAs share them), through the SM's L1 in the small
// kernel (its group's barrier orders the prologue's copy before them).
struct InL2 {
  static constexpr bool kColorList = false;   // run_stages walks every color
  __device__ static float ld_acc(const float* p) { return __ldcg(p); }
  __device__ static void st_acc(float* p, float v) { __stcg(p, v); }
  __device__ static float ld(const float* p) { return __ldcg(p); }
  __device__ static long long ld(const long long* p) { return __ldcg(p); }
  __device__ static void st(float* p, float v) { __stcg(p, v); }
  __device__ static void st(long long* p, long long v) { __stcg(p, v); }
  __device__ static void add(float* p, float v) { atomicAdd(p, v); }
  __device__ static void add_sum(long long* p, long long v) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(v));
  }
  __device__ static void sync(const Pass& pass, cg::cluster_group cluster) {
    if (pass.cluster) cluster.sync(); else __syncthreads();
  }
};

struct InShared {
  static constexpr bool kColorList = true;    // only the colors in use
  __device__ static float ld_acc(const float* p) { return __ldca(p); }
  __device__ static void st_acc(float* p, float v) { __stwb(p, v); }
  __device__ static float ld(const float* p) { return *p; }
  __device__ static long long ld(const long long* p) { return *p; }
  __device__ static void st(float* p, float v) { *p = v; }
  __device__ static void st(long long* p, long long v) { *p = v; }
  __device__ static void add(float* p, float v) {
    float r;
    asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(*p), "f"(v));
    *p = r;
  }
  __device__ static void add_sum(long long* p, long long v) {
    asm volatile("red.shared.add.u64 [%0], %1;"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))),
                    "l"(v) : "memory");
  }
  __device__ static void sync(const Pass& pass, cg::cluster_group) {
    asm volatile("bar.sync %0, %1;" :: "r"(pass.bar), "r"(pass.step)
                 : "memory");
  }
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

template <class M>
__device__ void integrate_velocities(const Problem& q, float max_lin,
                                     const Pass& pass) {
  const int nb = q.nb;
  for (int i = pass.first; i < nb; i += pass.step) {
    const float* prm = q.params;
    if (!(prm[11 * nb + i] > 0.0f)) continue;
    float bx = M::ld(q.body + 0 * nb + i);
    float by = M::ld(q.body + 1 * nb + i);
    float bw = M::ld(q.body + 2 * nb + i);
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
    M::st(q.body + 0 * nb + i, vx);
    M::st(q.body + 1 * nb + i, vy);
    M::st(q.body + 2 * nb + i, w);
  }
}

template <class M>
__device__ void integrate_positions(const Problem& q, float h,
                                    const Pass& pass) {
  const int nb = q.nb;
  for (int i = pass.first; i < nb; i += pass.step) {
    if (!(M::ld(q.body + 7 * nb + i) > 0.0f)) continue;
    float vx = M::ld(q.body + 0 * nb + i);
    float vy = M::ld(q.body + 1 * nb + i);
    float w = M::ld(q.body + 2 * nb + i);
    float dpx = M::ld(q.body + 3 * nb + i) + h * vx;
    float dpy = M::ld(q.body + 4 * nb + i) + h * vy;
    float da = h * w;
    float c0 = M::ld(q.body + 5 * nb + i);
    float s0 = M::ld(q.body + 6 * nb + i);
    float c1 = c0 - da * s0;
    float s1 = s0 + da * c0;
    float inv = rsqrtf(fmaxf(c1 * c1 + s1 * s1, 1e-12f));
    M::st(q.body + 3 * nb + i, dpx);
    M::st(q.body + 4 * nb + i, dpy);
    M::st(q.body + 5 * nb + i, c1 * inv);
    M::st(q.body + 6 * nb + i, s1 * inv);
  }
}

// One constraint lane of stage p: returns the six velocity deltas
// (a: vx, vy, w; b: vx, vy, w) and, for p != 0, writes the lane's
// accumulator column (through L2). The arithmetic follows _solver_kernel's
// contact_sweep operation by operation, including its 0/1 stage flags.
template <class M>
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
  float ni[2] = {M::ld_acc(a + 0 * L), M::ld_acc(a + 1 * L)};
  float ti[2] = {M::ld_acc(a + 2 * L), M::ld_acc(a + 3 * L)};
  float tni[2] = {M::ld_acc(a + 4 * L), M::ld_acc(a + 5 * L)};
  const float roll = M::ld_acc(a + 6 * L);

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
  const float va0 = M::ld(ba), va1 = M::ld(ba + nb), wa0 = M::ld(ba + 2 * nb);
  const float vb0 = M::ld(bb), vb1 = M::ld(bb + nb), wb0 = M::ld(bb + 2 * nb);
  const float dpx = M::ld(bb + 3 * nb) - M::ld(ba + 3 * nb);
  const float dpy = M::ld(bb + 4 * nb) - M::ld(ba + 4 * nb);
  const float dqca = M::ld(ba + 5 * nb), dqsa = M::ld(ba + 6 * nb);
  const float dqcb = M::ld(bb + 5 * nb), dqsb = M::ld(bb + 6 * nb);
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

  M::st_acc(a + 0 * L, ni[0]);
  M::st_acc(a + 1 * L, ni[1]);
  M::st_acc(a + 2 * L, ti[0]);
  M::st_acc(a + 3 * L, ti[1]);
  M::st_acc(a + 4 * L, tni[0]);
  M::st_acc(a + 5 * L, tni[1]);
  M::st_acc(a + 6 * L, roll + dl);

  out[0] = vax - va0; out[1] = vay - va1; out[2] = wa - wa0;
  out[3] = vbx - vb0; out[4] = vby - vb1; out[5] = wb - wb0;
}

// The endpoints of contact lane `lane` (joint lane, when kJoint) and
// which of them are dynamic (inverse mass or inertia above 0); false for a
// dead lane.
template <bool kJoint>
__device__ __forceinline__ bool endpoints(const Problem& q,
                                          const JointRegion& jr, int lane,
                                          LaneOut& o) {
  constexpr int ma = kJoint ? int(JINV_MA) : int(INV_MA);
  constexpr int mb = kJoint ? int(JINV_MB) : int(INV_MB);
  constexpr int ia = kJoint ? int(JINV_IA) : int(INV_IA);
  constexpr int ib = kJoint ? int(JINV_IB) : int(INV_IB);
  const int n = kJoint ? jr.LJ : q.L;
  const int* idx = kJoint ? jr.idx : q.idx;
  const float* d = (kJoint ? jr.data : q.data) + lane;
  o.ia = __ldg(idx + lane);
  if (o.ia < 0) return false;
  o.ib = __ldg(idx + n + lane);
  o.dyn_a = __ldg(d + ma * n) > 0.0f || __ldg(d + ia * n) > 0.0f;
  o.dyn_b = __ldg(d + mb * n) > 0.0f || __ldg(d + ib * n) > 0.0f;
  return true;
}

// Solve lane `lane` of stage s into o (joints only for p != 3); false for
// a dead lane.
template <bool kJoint, class M>
__device__ __forceinline__ bool solve(const Problem& q, const JointRegion& jr,
                                      int lane, const Stage& s, LaneOut& o) {
  if (!endpoints<kJoint>(q, jr, lane, o)) return false;
  if constexpr (kJoint) {
    joint_lane<M>(jr, q.body, q.nb, lane, o.ia, o.ib, s.p, s.h, s.inv_h,
                  o.d);
  } else {
    solve_lane<M>(q, lane, o.ia, o.ib, s.p, s.inv_h, s.contact_speed,
                  s.restitution_threshold, o.d);
  }
  return true;
}

// Add a lane's velocity deltas to its dynamic endpoints.
template <class M>
__device__ __forceinline__ void add_deltas(float* body, int nb,
                                           const LaneOut& o) {
  if (o.dyn_a) {
    M::add(body + 0 * nb + o.ia, o.d[0]);
    M::add(body + 1 * nb + o.ia, o.d[1]);
    M::add(body + 2 * nb + o.ia, o.d[2]);
  }
  if (o.dyn_b) {
    M::add(body + 0 * nb + o.ib, o.d[3]);
    M::add(body + 1 * nb + o.ib, o.d[4]);
    M::add(body + 2 * nb + o.ib, o.d[5]);
  }
}

// A window whose lanes share no dynamic body: contact lanes
// [clo, clo + nc), then joint lanes [jlo, jlo + nj). Each lane adds its
// deltas at once; the caller puts one barrier behind the window. Contacts
// come first so that a contact lane keeps its thread in every stage.
template <bool kJoints, class M>
__device__ void colored_window(const Problem& q, const JointRegion& jr,
                               int clo, int nc, int jlo, int nj,
                               const Stage& s, const Pass& pass) {
  for (int i = pass.first; i < nc + nj; i += pass.step) {
    LaneOut o;
    if (i < nc) {
      if (solve<false, M>(q, jr, clo + i, s, o))
        add_deltas<M>(q.body, q.nb, o);
    } else if constexpr (kJoints) {
      if (solve<true, M>(q, jr, jlo + i - nc, s, o))
        add_deltas<M>(q.body, q.nb, o);
    }
  }
}

constexpr float kFixScale = 4294967296.0f;       // 2^32 units a m/s
constexpr float kFixUnit = 1.0f / 4294967296.0f;
constexpr float kFixMax = 1073741824.0f;         // 2^30

// Add one delta to a body's fixed-point sum (d * 2^32 is exact in float,
// then rounded to an integer; an integer add that returns nothing), or
// flag it when it is out of range.
template <class M>
__device__ __forceinline__ void add_fixed(long long* sum, long long* flag,
                                          float d) {
  if (fabsf(d) < kFixMax) {
    M::add_sum(sum, __float2ll_rn(d * kFixScale));
  } else {
    M::st(flag, 1ll);
  }
}

// Phase 2 of a Jacobi window, over the bodies: each adds its sums to its
// velocity and clears them (a body no lane of the window touched has sums
// of zero; a flag turns its velocity to NaN, as a non-finite delta would
// in a float sum). A thread loads the sums of up to kApply bodies at once,
// so that their loads overlap, then adds each to its velocity in L2 (an
// add that returns nothing, so the thread does not wait for it; the only
// add to that velocity in the pass).
constexpr int kApply = 4;

template <class M>
__device__ void apply_sums(const Problem& q, const Pass& pass) {
  const int nb = q.nb;
  const float nan = __int_as_float(0x7fc00000);
  for (int base = pass.first; base < nb; base += kApply * pass.step) {
    long long t[kApply][4];
#pragma unroll
    for (int j = 0; j < kApply; ++j) {
      const int b = base + j * pass.step;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        t[j][r] = b < nb ? M::ld(q.jsum + r * nb + b) : 0ll;
    }
#pragma unroll
    for (int j = 0; j < kApply; ++j) {
      const int b = base + j * pass.step;
      const bool bad = t[j][3] != 0;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (t[j][r] == 0 && !bad) continue;
        M::add(q.body + r * nb + b,
               bad ? nan : __ll2float_rn(t[j][r]) * kFixUnit);
        M::st(q.jsum + r * nb + b, 0ll);
      }
      if (bad) M::st(q.jsum + 3 * nb + b, 0ll);
    }
  }
}

// A window [lo, lo + n) whose lanes share bodies: every lane reads the
// body state at the window's start and adds its deltas to the bodies'
// fixed-point sums (phase 1), then each body adds its sums to its
// velocity (phase 2). Contact lanes, or joint lanes when kJoint.
template <bool kJoint, class M>
__device__ void jacobi_window(const Problem& q, const JointRegion& jr,
                              int lo, int n, const Stage& s,
                              const Pass& pass, cg::cluster_group cluster) {
  const int nb = q.nb;
  long long* flag = q.jsum + 3 * nb;
  for (int i = pass.first; i < n; i += pass.step) {
    LaneOut o;
    if (!solve<kJoint, M>(q, jr, lo + i, s, o)) continue;
    for (int r = 0; r < 3; ++r) {
      if (o.dyn_a)
        add_fixed<M>(q.jsum + r * nb + o.ia, flag + o.ia, o.d[r]);
      if (o.dyn_b)
        add_fixed<M>(q.jsum + r * nb + o.ib, flag + o.ib, o.d[3 + r]);
    }
  }
  M::sync(pass, cluster);
  apply_sums<M>(q, pass);
  M::sync(pass, cluster);
}

// The overflow color's joint segment [lo, hi), as the tiled Pallas kernel
// sweeps it: a Jacobi window for each run of one joint type (the lanes are
// sorted by type), cut every jr.jwin lanes.
template <class M>
__device__ void overflow_joint_windows(const Problem& q,
                                       const JointRegion& jr, int lo, int hi,
                                       const Stage& s, const Pass& pass,
                                       cg::cluster_group cluster) {
  int a = lo;
  while (a < hi) {
    const int ty = __ldg(jr.type + a);
    // the first lane in (a, a + jwin) of a later type
    int l = a + 1, r = min(a + jr.jwin, hi);
    while (l < r) {
      const int mid = (l + r) >> 1;
      if (__ldg(jr.type + mid) == ty) l = mid + 1; else r = mid;
    }
    jacobi_window<true, M>(q, jr, a, l - a, s, pass, cluster);
    a = l;
  }
}

// World w's arrays in a batched launch: every array holds one world after
// another, each at its own stride, the joint arrays at one LJ, and each
// world has its own overflow flag. (The Jacobi sums, where a kernel keeps
// them in device memory, are offset by the caller.)
template <bool kJoints>
__device__ __forceinline__ void at_world(Problem& q, JointRegion& jr,
                                         const float*& acc_in,
                                         const float*& body_in,
                                         const float*& jacc_in, long w) {
  q.scal += 8 * w;
  q.idx += 2 * w * q.L;
  q.data += long(NF_ROWS) * w * q.L;
  q.acc += long(NA_ROWS) * w * q.L;
  acc_in += long(NA_ROWS) * w * q.L;
  q.body += 8 * w * q.nb;
  body_in += 8 * w * q.nb;
  q.params += 12 * w * q.nb;
  if constexpr (kJoints) {
    const long lj = jr.LJ;
    jr.idx += 2 * w * lj;
    jr.data += long(JRELAX + 1) * w * lj;
    jr.acc += long(S2Y + 1) * w * lj;
    jacc_in += long(S2Y + 1) * w * lj;
    jr.type += w * lj;
    jr.off += w * (q.n_colors + 1);
    jr.overflow = __ldg(jr.overflow_w + w);
  }
}

// The joint color swept as Jacobi windows, or -1: the overflow color is
// the highest in use, so when the coloring overflowed it owns the last
// non-empty joint segment (if it holds joints at all); sweeping a segment
// without shared bodies as Jacobi windows changes nothing.
template <bool kJoints>
__device__ __forceinline__ int joint_split(const JointRegion& jr,
                                           const Table& tab, int ncol) {
  int split = -1;
  if constexpr (kJoints) {
    if (jr.overflow) {
      for (int c = ncol - 1; c >= 0 && split < 0; --c)
        if (tab.joff[c + 1] > tab.joff[c]) split = c;
    }
  }
  return split;
}

// The stages of a solve over the window table; M: where the body rows and
// Jacobi sums live and which barrier follows a pass. Where M::kColorList,
// a stage walks the n_live colors of `live` (those whose bucket or joint
// segment holds a live lane, in order) instead of every color.
template <bool kJoints, class M>
__device__ __forceinline__ void run_stages(const Problem& q,
                                           const JointRegion& jr, Stage s,
                                           float max_lin, const Table& tab,
                                           const int* live, int n_live,
                                           const Pass& pass,
                                           cg::cluster_group cluster) {
  const int ncol = q.n_colors;
  const int stages = 3 * q.nsub + 1;
  const int n_walk = M::kColorList ? n_live : ncol;
  for (int k = 0; k < stages; ++k) {
    s.p = (k == stages - 1) ? 3 : k % 3;
    if (s.p == 0 || s.p == 2) {
      if (s.p == 0) integrate_velocities<M>(q, max_lin, pass);
      else integrate_positions<M>(q, s.h, pass);
      M::sync(pass, cluster);
    }
    for (int kc = 0; kc < n_walk; ++kc) {
      const int c = M::kColorList ? live[kc] : kc;
      const int clo = c * q.chunk;
      const int nc = tab.end[c] - clo;
      int jlo = 0, nj = 0;
      if constexpr (kJoints) {
        if (s.p != 3) {
          jlo = tab.joff[c];
          nj = tab.joff[c + 1] - jlo;
          if (c == tab.split) {
            overflow_joint_windows<M>(q, jr, jlo, jlo + nj, s, pass,
                                      cluster);
            nj = 0;
          }
        }
      }
      if (nc + nj > 0) {
        colored_window<kJoints, M>(q, jr, clo, nc, jlo, nj, s, pass);
        M::sync(pass, cluster);
      }
    }
    // The tail's windows. A tail of one window is swept apart from the
    // loop: the same work, but the kernel built this way runs its colored
    // windows 10% faster than the loop alone, on inputs with no tail at all
    // (code layout; time_solver.py --one-process, PERF.md).
    const int nt = tab.end[ncol] - q.l0;
    if (nt > 0 && nt <= q.tail_w) {
      jacobi_window<false, M>(q, jr, q.l0, nt, s, pass, cluster);
    } else if (nt > 0) {
      for (int a = 0; a < nt; a += q.tail_w)
        jacobi_window<false, M>(q, jr, q.l0 + a, min(q.tail_w, nt - a), s,
                                pass, cluster);
    }
  }
}

// kBatch: the arrays hold one world after another (at_world), and world w
// is solved by cluster w of the grid: every world has its own window
// table, its own on_cluster choice, its own output rows and scratch.
template <bool kJoints, bool kBatch>
__global__ void __launch_bounds__(kThreads, 1)
solve_kernel(Problem q, JointRegion jr, const float* acc_in,
             const float* body_in, const float* jacc_in) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int t0 = cluster_lane(rank);
  if constexpr (kBatch) {
    const long w = blockIdx.x / kCluster;
    at_world<kJoints>(q, jr, acc_in, body_in, jacc_in, w);
    q.jsum += 4 * w * q.nb;
  }
  __shared__ Table tab;
  Stage s;
  s.h = q.scal[0];
  s.inv_h = q.scal[1];
  s.contact_speed = q.scal[2];
  s.restitution_threshold = q.scal[3];
  const float max_lin = q.scal[4];
  const int L = q.L;
  const int ncol = q.n_colors;

  for (int i = t0; i < 8 * q.nb; i += kClusterThreads)
    __stcg(q.body + i, __ldg(body_in + i));
  for (int i = t0; i < 9 * L; i += kClusterThreads)
    __stcg(q.acc + i, __ldg(acc_in + i));
  if constexpr (kJoints) {
    for (int i = t0; i < 9 * jr.LJ; i += kClusterThreads)
      __stcg(jr.acc + i, __ldg(jacc_in + i));
  }

  // The window table. Each CTA marks the last live lane of each contact
  // window within its share of the lanes (a live lane whose next lane in
  // the warp is not a live lane of the same window), then takes the maximum
  // over the eight CTAs' shares from their shared memory.
  for (int c = threadIdx.x; c <= ncol; c += kThreads) {
    tab.part[c] = 0;
    if constexpr (kJoints) tab.joff[c] = __ldg(jr.off + c);
  }
  __syncthreads();
  const int wl = threadIdx.x & 31;
  const int lc = ncol * q.chunk;
  for (int base = t0 - wl; base < L; base += kClusterThreads) {
    const int lane = base + wl;
    const int win = lane < lc ? lane / q.chunk
                              : (lane >= q.l0 && lane < L ? ncol : -1);
    const int v = (win >= 0 && __ldg(q.idx + lane) >= 0) ? lane + 1 : 0;
    const int win_next = __shfl_down_sync(0xffffffffu, win, 1);
    const int v_next = __shfl_down_sync(0xffffffffu, v, 1);
    if (v > 0 && (wl == 31 || win_next != win || v_next == 0))
      atomicMax(&tab.part[win], v);
  }
  // every CTA's share is complete, and the copies above are in L2
  cluster.sync();
  for (int c = threadIdx.x; c <= ncol; c += kThreads) {
    int e = c < ncol ? c * q.chunk : q.l0;
    for (unsigned r = 0; r < kCluster; ++r)
      e = max(e, *cluster.map_shared_rank(&tab.part[c], r));
    tab.end[c] = e;
  }
  if (threadIdx.x == 0) {
    // the widest pass of the call: a color's window, a tail window, the
    // bodies
    int widest = max(q.nb, min(tab.end[ncol] - q.l0, q.tail_w));
    for (int c = 0; c < ncol; ++c) {
      int n = tab.end[c] - c * q.chunk;
      if constexpr (kJoints) n += tab.joff[c + 1] - tab.joff[c];
      widest = max(widest, n);
    }
    tab.widest = widest;
    tab.split = joint_split<kJoints>(jr, tab, ncol);
  }
  // the table is complete in every CTA, and no CTA reads another's shared
  // memory after this barrier
  cluster.sync();

  // A call whose every pass fits in one CTA (a small world) runs on CTA 0
  // alone: a block barrier costs less than the cluster's. The other CTAs
  // leave; none of them is waited for again.
  const bool on_cluster = tab.widest > kThreads;
  if (!on_cluster && rank != 0) return;
  const Pass pass = on_cluster
      ? Pass{t0, kClusterThreads, true, 0}
      : Pass{static_cast<int>(threadIdx.x), kThreads, false, 0};
  // The Jacobi windows' sums start at zero, and each window leaves them
  // so; a call without such windows never touches them.
  if (tab.end[ncol] > q.l0 || tab.split >= 0) {
    for (int i = pass.first; i < 4 * q.nb; i += pass.step)
      __stcg(q.jsum + i, 0ll);
    InL2::sync(pass, cluster);
  }
  run_stages<kJoints, InL2>(q, jr, s, max_lin, tab, nullptr, 0, pass,
                            cluster);
}

// ---------------------------------------------------------------------------
// The small-world kernel: a batch of worlds whose every pass fits in 512
// lanes (contact_solver.batched_plan decides, from the capacity), several
// worlds an SM.
// ---------------------------------------------------------------------------

// Threads of a small-world CTA at most. Its launch bound (one CTA an SM at
// least) leaves a thread up to 255 registers, and neither instance spills.
constexpr int kGroupMax = 128;
constexpr int kScan = 16;          // lanes a thread loads at once in the scan
constexpr int kCopyCtasMax = 4096;

// A small-world launch, from the host's plan: `group` threads a world (a
// multiple of 32), `per_cta` worlds a CTA, and `world_bytes` of shared
// memory a world (small_world_bytes); CTAs [0, solve_ctas) solve, the
// others copy.
struct Small {
  int worlds, group, per_cta, solve_ctas, world_bytes;
};

// The shared memory a world takes: its Jacobi sums (4, nb) int64, its body
// rows (8, nb), its window table and its list of the colors in use (a
// count, then the colors), rounded to 16 bytes.
__host__ __device__ constexpr int small_world_bytes(int nb) {
  return (4 * nb * 8 + 8 * nb * 4 + int(sizeof(Table))
          + 4 * (kMaxColors + 1) + 15) / 16 * 16;
}

// The copy CTAs: every lane of out_acc that no world group writes, each
// lane that is dead or live in a bucket at or above n_colors (no window
// visits one), copied from acc_in, four lanes a load where the layout
// allows it. These lanes are disjoint from the groups', so the copy needs
// no barrier with the solves and runs beside them on the SMs they leave.
__device__ void copy_idle_lanes(const Problem& q, const float* acc_in,
                                int worlds, long first, long step) {
  const int L = q.L;
  const int lc = q.n_colors * q.chunk;
  auto idle = [&](int v, int lane) {
    return int(v < 0 || (lane >= lc && lane < q.l0));
  };
  const auto bits = reinterpret_cast<unsigned long long>(q.idx)
      | reinterpret_cast<unsigned long long>(q.acc)
      | reinterpret_cast<unsigned long long>(acc_in);
  if (L % 4 == 0 && (bits & 15) == 0) {
    const int quads = L / 4;
    const long n = long(worlds) * quads;
    for (long k = first; k < n; k += step) {
      const long w = k / quads;
      const int lane = int(k - w * quads) * 4;
      const int4 v = __ldg(reinterpret_cast<const int4*>(q.idx + 2 * w * L
                                                         + lane));
      const int m = idle(v.x, lane) | idle(v.y, lane + 1) << 1
          | idle(v.z, lane + 2) << 2 | idle(v.w, lane + 3) << 3;
      if (m == 0) continue;
      const float* src = acc_in + long(NA_ROWS) * w * L + lane;
      float* dst = q.acc + long(NA_ROWS) * w * L + lane;
      if (m == 15) {
        float4 r[NA_ROWS];
#pragma unroll
        for (int i = 0; i < NA_ROWS; ++i)
          r[i] = __ldcs(reinterpret_cast<const float4*>(src + long(i) * L));
#pragma unroll
        for (int i = 0; i < NA_ROWS; ++i)
          __stcs(reinterpret_cast<float4*>(dst + long(i) * L), r[i]);
      } else {
        for (int i = 0; i < NA_ROWS; ++i)
          for (int j = 0; j < 4; ++j)
            if (m >> j & 1) dst[long(i) * L + j] = src[long(i) * L + j];
      }
    }
  } else {
    const long n = long(worlds) * L;
    for (long k = first; k < n; k += step) {
      const long w = k / L;
      const int lane = int(k - w * L);
      if (!idle(__ldg(q.idx + 2 * w * L + lane), lane)) continue;
      for (int i = 0; i < NA_ROWS; ++i)
        q.acc[(long(NA_ROWS) * w + i) * L + lane] =
            acc_in[(long(NA_ROWS) * w + i) * L + lane];
    }
  }
}

// The group's window table, as the cluster kernel's prologue finds it: the
// end of the live lanes of each bucket and of the tail. A thread loads
// kScan quads of lanes at once (single lanes where the layout is not cut
// in quads), a warp's 32 loads on contiguous lanes.
__device__ void scan_windows(const Problem& q, Table& tab, const Pass& pass) {
  const int L = q.L;
  const int ncol = q.n_colors;
  const int lc = ncol * q.chunk;
  const int wl = pass.first & 31;
  const bool quads = L % 4 == 0 && q.chunk % 4 == 0 && q.l0 % 4 == 0
      && (reinterpret_cast<unsigned long long>(q.idx) & 15) == 0;
  const int width = quads ? 4 : 1;   // a quad lies in one window
  for (int b0 = 0; b0 < L; b0 += kScan * width * pass.step) {
    int4 v[kScan];
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      const int lane = b0 + (j * pass.step + pass.first) * width;
      v[j] = make_int4(-1, -1, -1, -1);
      if (lane < L) {
        if (quads) v[j] = __ldg(reinterpret_cast<const int4*>(q.idx + lane));
        else v[j].x = __ldg(q.idx + lane);
      }
    }
#pragma unroll
    for (int j = 0; j < kScan; ++j) {
      const int lane = b0 + (j * pass.step + pass.first) * width;
      const int win = lane < lc ? lane / q.chunk
                                : (lane >= q.l0 && lane < L ? ncol : -1);
      const int e = win < 0 ? 0
          : v[j].w >= 0 ? lane + 4 : v[j].z >= 0 ? lane + 3
          : v[j].y >= 0 ? lane + 2 : v[j].x >= 0 ? lane + 1 : 0;
      const int win_next = __shfl_down_sync(0xffffffffu, win, 1);
      const int e_next = __shfl_down_sync(0xffffffffu, e, 1);
      if (e > 0 && (wl == 31 || win_next != win || e_next == 0))
        atomicMax(&tab.end[win], e);
    }
  }
}

// Each live lane of a window, copied from acc_in to out_acc, where the
// stages read and write it (the copy CTAs take every other lane). The
// windows' lanes are numbered one after another, and a thread copies
// kCopyLanes of them at once, their loads all issued before its stores.
constexpr int kCopyLanes = 4;

__device__ void copy_window_lanes(const Problem& q, const float* acc_in,
                                  const Table& tab, const Pass& pass) {
  const int L = q.L;
  const int ncol = q.n_colors;
  int c = 0, start = 0;   // window c holds numbers [start, start + n(c))
  auto lo = [&](int c) { return c < ncol ? c * q.chunk : q.l0; };
  auto lane_of = [&](int k) {
    while (c <= ncol && k >= start + tab.end[c] - lo(c)) {
      start += tab.end[c] - lo(c);
      ++c;
    }
    return c <= ncol ? lo(c) + k - start : -1;
  };
  for (int k0 = pass.first;; k0 += kCopyLanes * pass.step) {
    int lane[kCopyLanes];
#pragma unroll
    for (int j = 0; j < kCopyLanes; ++j)
      lane[j] = lane_of(k0 + j * pass.step);
    if (lane[0] < 0) break;
    bool live[kCopyLanes];
#pragma unroll
    for (int j = 0; j < kCopyLanes; ++j)
      live[j] = lane[j] >= 0 && __ldg(q.idx + lane[j]) >= 0;
    float r[kCopyLanes][NA_ROWS];
#pragma unroll
    for (int j = 0; j < kCopyLanes; ++j)
#pragma unroll
      for (int i = 0; i < NA_ROWS; ++i)
        r[j][i] = live[j] ? __ldg(acc_in + i * L + lane[j]) : 0.0f;
#pragma unroll
    for (int j = 0; j < kCopyLanes; ++j)
#pragma unroll
      for (int i = 0; i < NA_ROWS; ++i)
        if (live[j]) __stwb(q.acc + i * L + lane[j], r[j][i]);
  }
}

// World w of the batch on its group of `sm.group` threads: its body rows,
// Jacobi sums and window table in the group's slice of shared memory, its
// constraint rows, accumulators and parameters in device memory; the
// stages are the cluster kernel's (run_stages), behind the group's
// barrier. The first world of a CTA uses named barrier 0, the next 1, ...
template <bool kJoints>
__global__ void __launch_bounds__(kGroupMax, 1)
solve_small_kernel(Problem q, JointRegion jr, const float* acc_in,
                   const float* body_in, const float* jacc_in, Small sm) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (static_cast<int>(blockIdx.x) >= sm.solve_ctas) {
    copy_idle_lanes(q, acc_in, sm.worlds,
                    long(blockIdx.x - sm.solve_ctas) * blockDim.x
                        + threadIdx.x,
                    long(gridDim.x - sm.solve_ctas) * blockDim.x);
    return;
  }
  const int g = static_cast<int>(threadIdx.x) / sm.group;
  const long w = long(blockIdx.x) * sm.per_cta + g;
  if (w >= sm.worlds) return;
  at_world<kJoints>(q, jr, acc_in, body_in, jacc_in, w);
  const Pass pass{static_cast<int>(threadIdx.x) - g * sm.group, sm.group,
                  false, g};
  const int t = pass.first;
  const int nb = q.nb;
  const int ncol = q.n_colors;
  unsigned char* mine = smem + long(g) * sm.world_bytes;
  long long* jsum = reinterpret_cast<long long*>(mine);
  float* body = reinterpret_cast<float*>(jsum + 4 * nb);
  Table& tab = *reinterpret_cast<Table*>(body + 8 * nb);
  int* live = reinterpret_cast<int*>(&tab + 1);   // [0]: the count
  float* out_body = q.body;
  q.body = body;
  q.jsum = jsum;
  cg::cluster_group cluster = cg::this_cluster();
  Stage s;
  s.h = q.scal[0];
  s.inv_h = q.scal[1];
  s.contact_speed = q.scal[2];
  s.restitution_threshold = q.scal[3];
  const float max_lin = q.scal[4];

  for (int i = t; i < 8 * nb; i += sm.group) body[i] = __ldg(body_in + i);
  for (int i = t; i < 4 * nb; i += sm.group) jsum[i] = 0ll;
  for (int c = t; c <= ncol; c += sm.group) {
    tab.end[c] = c < ncol ? c * q.chunk : q.l0;
    if constexpr (kJoints) tab.joff[c] = __ldg(jr.off + c);
  }
  if constexpr (kJoints) {
    for (int i = t; i < (S2Y + 1) * jr.LJ; i += sm.group)
      __stwb(jr.acc + i, __ldg(jacc_in + i));
  }
  InShared::sync(pass, cluster);
  scan_windows(q, tab, pass);
  InShared::sync(pass, cluster);
  if (t == 0) {
    tab.split = joint_split<kJoints>(jr, tab, ncol);
    int n = 0;
    for (int c = 0; c < ncol; ++c) {
      bool used = tab.end[c] > c * q.chunk;
      if constexpr (kJoints) used = used || tab.joff[c + 1] > tab.joff[c];
      if (used) live[1 + n++] = c;
    }
    live[0] = n;
  }
  copy_window_lanes(q, acc_in, tab, pass);
  InShared::sync(pass, cluster);
  run_stages<kJoints, InShared>(q, jr, s, max_lin, tab, live + 1, live[0],
                                pass, cluster);
  InShared::sync(pass, cluster);
  for (int i = t; i < 8 * nb; i += sm.group) __stcg(out_body + i, body[i]);
}

// The launch: one cluster of kCluster CTAs per world, `worlds` worlds (1
// for a single-world call).
cudaLaunchConfig_t launch_config(cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int worlds) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * worlds, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kJoints, bool kBatch>
int launch(const Problem& q, const JointRegion& jr, const float* acc_in,
           const float* body_in, const float* jacc_in, int worlds,
           void* stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      static_cast<cudaStream_t>(stream), attr, worlds);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, solve_kernel<kJoints, kBatch>, q, jr, acc_in, body_in, jacc_in);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The dynamic shared memory of a small-world CTA; above 48 KB it needs the
// kernel's opt-in.
template <bool kJoints>
cudaError_t small_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(solve_small_kernel<kJoints>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// A batched launch: the small-world kernel where the host's plan gives a
// group (group > 0), else the cluster kernel, a cluster a world.
template <bool kJoints>
int launch_batched(const Problem& q, const JointRegion& jr,
                   const float* acc_in, const float* body_in,
                   const float* jacc_in, int worlds, int group, int per_cta,
                   void* stream) {
  if (group == 0)
    return launch<kJoints, true>(q, jr, acc_in, body_in, jacc_in, worlds,
                                 stream);
  const int threads = group * per_cta;
  if (group % 32 != 0 || group < 32 || per_cta < 1 || threads > kGroupMax
      || per_cta > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int world_bytes = small_world_bytes(q.nb);
  const int smem = per_cta * world_bytes;
  cudaError_t err = small_smem<kJoints>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int solve_ctas = (worlds + per_cta - 1) / per_cta;
  const long items = q.L % 4 == 0 ? long(worlds) * (q.L / 4)
                                  : long(worlds) * q.L;
  const long copy_ctas = std::min(
      std::max((items + 4L * threads - 1) / (4L * threads), 1L),
      long(kCopyCtasMax));
  const Small sm{worlds, group, per_cta, solve_ctas, world_bytes};
  solve_small_kernel<kJoints>
      <<<solve_ctas + int(copy_ctas), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(q, jr, acc_in, body_in,
                                              jacc_in, sm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. tail_w: the width of the tail's Jacobi
// windows; jsum: (4, nb) int64 of scratch, which the kernel zeroes. Each
// launch is one cluster on `stream`;
// it does not synchronise, allocates nothing, and returns the launch's
// error code (cudaLaunchKernelEx, then cudaGetLastError()).

// The launch shape of one instance of the kernel (kind 0: contact only,
// 1: with the joint sweep, 2: the batched contact-only instance, 3: the
// batched instance with the joint sweep): out[0]
// CTAs of the cluster, out[1] threads of a CTA, out[2] how many such
// clusters the card can hold at once (cudaOccupancyMaxActiveClusters; 0:
// the cluster does not fit).
extern "C" int b2t_launch_shape(int kind, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(nullptr, attr, 1);
  const void* fn =
      kind == 1 ? reinterpret_cast<void*>(solve_kernel<true, false>)
      : kind == 2 ? reinterpret_cast<void*>(solve_kernel<false, true>)
      : kind == 3 ? reinterpret_cast<void*>(solve_kernel<true, true>)
                  : reinterpret_cast<void*>(solve_kernel<false, false>);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  out[0] = kCluster;
  out[1] = kThreads;
  out[2] = err == cudaSuccess ? n : 0;
  return static_cast<int>(err);
}

// The small-world kernel (joints: its instance with the joint sweep) at
// `group` threads a world, `per_cta` worlds of nb bodies a CTA: out[0]
// CTAs an SM can hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] the card's SMs,
// out[2] registers a thread, out[3] local memory a thread (bytes; spills
// land there), out[4] the CTA's dynamic shared memory (bytes).
extern "C" int b2t_small_shape(int joints, int group, int per_cta, int nb,
                               int* out) {
  const int threads = group * per_cta;
  const int smem = per_cta * small_world_bytes(nb);
  const void* fn = joints
      ? reinterpret_cast<const void*>(solve_small_kernel<true>)
      : reinterpret_cast<const void*>(solve_small_kernel<false>);
  cudaError_t err = joints ? small_smem<true>(smem) : small_smem<false>(smem);
  cudaFuncAttributes a = {};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  int n = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = n;
  out[1] = sms;
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = smem;
  return static_cast<int>(err);
}

extern "C" int b2t_contact_solve(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, long long* jsum,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int tail_w,
    void* stream) {
  const Problem q{scalars, idx, data, params, out_body, out_acc, jsum,
                  nb, L, chunk, l0, n_colors, nsub, tail_w};
  const JointRegion none{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                         0, nullptr};
  return launch<false, false>(q, none, acc_in, body_in, nullptr, 1, stream);
}

// The contact-only pipeline for `worlds` worlds in one launch. Every array
// holds one world after another: scalars (W, 8), idx (W, 2, L), data
// (W, 33, L), acc_in / out_acc (W, 9, L), body_in / out_body (W, 8, nb),
// params (W, 12, nb), jsum (W, 4, nb; unused, and may be null, on the
// small-world path); every world has the same nb, L, chunk, l0, n_colors,
// nsub and tail_w. group, per_cta: the host's plan
// (contact_solver.batched_plan); group 0 takes the cluster kernel, a
// cluster of kCluster CTAs a world (gridDim W x kCluster), each choosing
// the whole cluster or CTA 0 as a single call does; else the small-world
// kernel, `group` threads a world, `per_cta` worlds a CTA.
extern "C" int b2t_contact_solve_batched(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, long long* jsum, int worlds,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int tail_w,
    int group, int per_cta, void* stream) {
  const Problem q{scalars, idx, data, params, out_body, out_acc, jsum,
                  nb, L, chunk, l0, n_colors, nsub, tail_w};
  const JointRegion none{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                         0, nullptr};
  return launch_batched<false>(q, none, acc_in, body_in, nullptr, worlds,
                               group, per_cta, stream);
}

// The same pipeline with a joint region: jidx (2, LJ), jdata (39, LJ),
// jacc_in / out_jacc (9, LJ), jtype (LJ), joff (n_colors + 1); overflow:
// the coloring overflowed (contact_solver.window_table); jwin: the width of
// the overflow color's joint windows.
extern "C" int b2t_contact_solve_joints(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, long long* jsum,
    const int* jidx, const float* jdata, const float* jacc_in,
    const int* jtype, const int* joff, float* out_jacc,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int tail_w,
    int LJ, int overflow, int jwin, void* stream) {
  const Problem q{scalars, idx, data, params, out_body, out_acc, jsum,
                  nb, L, chunk, l0, n_colors, nsub, tail_w};
  const JointRegion jr{jidx, jdata, out_jacc, jtype, joff, LJ, overflow,
                       jwin, nullptr};
  return launch<true, false>(q, jr, acc_in, body_in, jacc_in, 1, stream);
}

// The jointed pipeline for `worlds` worlds in one launch: the arrays of
// b2t_contact_solve_batched and each world's joint region, one world after
// another at one LJ: jidx (W, 2, LJ), jdata (W, 39, LJ), jacc_in /
// out_jacc (W, 9, LJ), jtype (W, LJ), joff (W, n_colors + 1), and
// overflow (W,) int32, each world's flag. World w is what
// b2t_contact_solve_joints gives for world w's arrays.
extern "C" int b2t_contact_solve_joints_batched(
    const float* scalars, const int* idx, const float* data,
    const float* acc_in, const float* body_in, const float* params,
    float* out_body, float* out_acc, long long* jsum,
    const int* jidx, const float* jdata, const float* jacc_in,
    const int* jtype, const int* joff, float* out_jacc,
    const int* overflow, int worlds,
    int nb, int L, int chunk, int l0, int n_colors, int nsub, int tail_w,
    int LJ, int jwin, int group, int per_cta, void* stream) {
  const Problem q{scalars, idx, data, params, out_body, out_acc, jsum,
                  nb, L, chunk, l0, n_colors, nsub, tail_w};
  const JointRegion jr{jidx, jdata, out_jacc, jtype, joff, LJ, 0, jwin,
                       overflow};
  return launch_batched<true>(q, jr, acc_in, body_in, jacc_in, worlds,
                              group, per_cta, stream);
}
