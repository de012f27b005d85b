// The joint sweep: one lane of one joint window of the TGS-soft solver.
//
// Replaces the Pallas TPU kernel function `_joint_sweep` of
// box2d_tpu/solver_pallas.py (traced into `_tiled_kernel`'s pallas_call for
// every jointed world). Rows follow that file's tables unchanged (see
// box2d_tpu_torch/joints.py):
//   jdata (39, LJ): inv masses, frames, delta centre, axial mass, the three
//     softness triples, four type-resolved flags, limits, target, speed,
//     max1..max4, linear velocity, jrelax
//   jacc (9, LJ): ix, iy, spring, motor, lower, upper, angular, s2x, s2y
//   jtype (LJ): the lane's joint type; joff (n_colors + 1): lane offsets of
//     each color's segment (lanes sorted by color, then type)
// Stage p == 0 warm-starts from the stored impulses (it needs the anchors,
// hence dq), p == 1 solves with bias, p == 2 relaxes; joints take no part in
// the restitution stage.
//
// What differs from the TPU kernel, on purpose: a lane branches on its own
// type (a `switch`), so windows need not be kind-pure and carry no padding
// to a lane multiple; bodies are gathered by index from L2 instead of by
// one-hot products; the relative angle is `atan2f`, where the TPU kernel
// carries a polynomial for want of the primitive.
//
// What bounds it: like the contact sweep, latency. One block walks the
// windows in order, each lane gathers sixteen body floats and up to 39 data
// rows, and a window of a thousand lanes is one pass of the block's 1,024
// threads between two barriers. Lanes are sorted by type inside a color so a
// warp runs one branch. The arithmetic is written operation by operation as
// the plain PyTorch twin (joints.joint_lanes) and built with -fmad=false, so
// the two round alike.

#pragma once

#include <cuda_runtime.h>

namespace {

enum JointType {
  J_DISTANCE = 0, J_MOTOR = 1, J_PRISMATIC = 2, J_REVOLUTE = 3, J_WELD = 4,
  J_WHEEL = 5, J_FILTER = 6, J_MOUSE = 7
};

enum JRow {
  JINV_MA = 0, JINV_MB, JINV_IA, JINV_IB,
  FAPX, FAPY, FAQC, FAQS, FBPX, FBPY, FBQC, FBQS,
  DCX, DCY, AXIAL_MASS,
  SB, SM, SI, AB, AM, AI, CB, CM, CI,
  F_SPRING, F_MOTOR, F_LIMIT, F_AUX,
  LOWER, UPPER, TARGET, SPEED, MAX1, MAX2, MAX3, LVX, LVY, MAX4, JRELAX
};

enum JAcc { IX = 0, IY, A_SPRING, A_MOTOR, A_LOWER, A_UPPER, A_ANGULAR,
            S2X, S2Y };

struct JointRegion {
  const int* idx;    // (2, LJ)
  const float* data; // (39, LJ)
  float* acc;        // (9, LJ), in place
  const int* type;   // (LJ)
  const int* off;    // (n_colors + 1)
  int LJ;
};

__device__ __forceinline__ float jclamp(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float recip_pos(float k) {
  return k > 0.0f ? 1.0f / k : 0.0f;
}

__device__ __forceinline__ float recip_nz(float k) {
  return k != 0.0f ? 1.0f / k : 0.0f;
}

__device__ __forceinline__ float unwind(float angle) {
  const float two_pi = 6.283185307179586f;
  const float x = (angle + 3.141592653589793f) / two_pi;
  return (x - floorf(x)) * two_pi - 3.141592653589793f;
}

// One joint lane of stage p (0, 1 or 2): writes the six velocity deltas
// (a: vx, vy, w; b: vx, vy, w) to out and, for p != 0, the lane's
// accumulator column.
__device__ void joint_lane(const JointRegion& jr, const float* body, int nb,
                           int lane, int ia_, int ib_, int p, float h,
                           float inv_h, float out[6]) {
  const int LJ = jr.LJ;
  const float* d = jr.data + lane;
  float* a = jr.acc + lane;
  auto R = [&](int r) { return __ldg(d + r * LJ); };
  const int jtype = jr.type[lane];
  const float bias_f = p == 1 ? 1.0f : 0.0f;
  const bool warm = p == 0;

  const float ma = R(JINV_MA), mb = R(JINV_MB);
  const float ia = R(JINV_IA), ib = R(JINV_IB);
  const float* ba = body + ia_;
  const float* bb = body + ib_;
  const float vax0 = __ldcg(ba), vay0 = __ldcg(ba + nb);
  const float wa0 = __ldcg(ba + 2 * nb);
  const float vbx0 = __ldcg(bb), vby0 = __ldcg(bb + nb);
  const float wb0 = __ldcg(bb + 2 * nb);
  const float dpax = __ldcg(ba + 3 * nb), dpay = __ldcg(ba + 4 * nb);
  const float dpbx = __ldcg(bb + 3 * nb), dpby = __ldcg(bb + 4 * nb);
  const float dqca = __ldcg(ba + 5 * nb), dqsa = __ldcg(ba + 6 * nb);
  const float dqcb = __ldcg(bb + 5 * nb), dqsb = __ldcg(bb + 6 * nb);

  const float fapx = R(FAPX), fapy = R(FAPY);
  const float fbpx = R(FBPX), fbpy = R(FBPY);
  const float rax = dqca * fapx - dqsa * fapy;
  const float ray = dqsa * fapx + dqca * fapy;
  const float rbx = dqcb * fbpx - dqsb * fbpy;
  const float rby = dqsb * fbpx + dqcb * fbpy;
  const float dcx = R(DCX), dcy = R(DCY);
  const float dx = dpbx - dpax + dcx + rbx - rax;
  const float dy = dpby - dpay + dcy + rby - ray;

  const float axial = R(AXIAL_MASS);
  float imp_x = a[IX * LJ], imp_y = a[IY * LJ];
  float spr_i = a[A_SPRING * LJ], mot_i = a[A_MOTOR * LJ];
  float low_i = a[A_LOWER * LJ], up_i = a[A_UPPER * LJ];
  float ang_i = a[A_ANGULAR * LJ];
  float s2x = a[S2X * LJ], s2y = a[S2Y * LJ];
  // new accumulator values (start as the old ones)
  float n_ix = imp_x, n_iy = imp_y, n_spr = spr_i, n_mot = mot_i;
  float n_low = low_i, n_up = up_i, n_ang = ang_i, n_s2x = s2x, n_s2y = s2y;

  const float faqc = R(FAQC), faqs = R(FAQS);
  const float fbqc = R(FBQC), fbqs = R(FBQS);
  const float qac = dqca * faqc - dqsa * faqs;
  const float qas = dqsa * faqc + dqca * faqs;
  const float qbc = dqcb * fbqc - dqsb * fbqs;
  const float qbs = dqsb * fbqc + dqcb * fbqs;
  const float relc = qac * qbc + qas * qbs;
  const float rels = qac * qbs - qas * qbc;

  float vax = vax0, vay = vay0, wa = wa0;
  float vbx = vbx0, vby = vby0, wb = wb0;

  auto cross = [](float ax_, float ay_, float bx_, float by_) {
    return ax_ * by_ - ay_ * bx_;
  };
  auto apply_lin = [&](float px, float py, float la, float lb) {
    vax = vax - ma * px;
    vay = vay - ma * py;
    wa = wa - ia * la;
    vbx = vbx + mb * px;
    vby = vby + mb * py;
    wb = wb + ib * lb;
  };
  auto apply_point = [&](float px, float py) {
    apply_lin(px, py, cross(rax, ray, px, py), cross(rbx, rby, px, py));
  };
  auto apply_ang = [&](float l) {
    wa = wa - ia * l;
    wb = wb + ib * l;
  };
  auto rel_x = [&]() { return (vbx - wb * rby) - (vax - wa * ray); };
  auto rel_y = [&]() { return (vby + wb * rbx) - (vay + wa * rax); };
  auto vr_dot = [&](float ux, float uy) {
    const float vrx = rel_x();
    const float vry = rel_y();
    return vrx * ux + vry * uy;
  };
  const float cb = R(CB), cm = R(CM), ci = R(CI);
  // soft lower/upper limit (constraint softness); returns the new impulse
  auto soft_limit = [&](float c, float cdot, float mass, float old) {
    const float bias = c > 0.0f ? c * inv_h : bias_f * cb * c;
    const float msc = c > 0.0f ? 1.0f : 1.0f + bias_f * (cm - 1.0f);
    const float isc = c > 0.0f ? 0.0f : bias_f * ci;
    const float impulse = -msc * mass * (cdot + bias) - isc * old;
    return fmaxf(old + impulse, 0.0f);
  };
  // scale (x, y) down to length max_i where it is longer
  auto cap_length = [](float& x, float& y, float max_i, bool need_pos) {
    const float ln = sqrtf(x * x + y * y);
    bool over = ln > max_i;
    if (need_pos) over = over && (max_i > 0.0f);
    const float scale = over ? max_i / (ln > 0.0f ? ln : 1.0f) : 1.0f;
    x = x * scale;
    y = y * scale;
  };

  switch (jtype) {
    case J_DISTANCE: {
      const float ln = sqrtf(dx * dx + dy * dy);
      const float inv = recip_pos(ln);
      const float axx = dx * inv, axy = dy * inv;
      auto axial_impulse = [&](float di) {
        apply_point(di * axx, di * axy);
      };
      if (warm) {
        axial_impulse(imp_x + low_i - up_i + mot_i);
        break;
      }
      const float cdot = vr_dot(axx, axy);
      const float c = ln - R(TARGET);
      const float bias = bias_f * cb * c;
      const float msc = 1.0f + bias_f * (cm - 1.0f);
      const float isc = bias_f * ci;
      const float dimp_r = -msc * axial * (cdot + bias) - isc * imp_x;
      const float dimp_s = (-R(SM) * axial * (cdot + R(SB) * c)
                            - R(SI) * imp_x) * R(F_AUX);
      const float imp_spring = jclamp(imp_x + dimp_s, R(MAX2) * h,
                                      R(MAX3) * h);
      const float dimp = R(F_SPRING) > 0.0f ? imp_spring - imp_x : dimp_r;
      n_ix = imp_x + dimp;
      axial_impulse(dimp);

      const float lim = R(F_LIMIT);
      const float new_low = soft_limit(ln - R(LOWER), vr_dot(axx, axy),
                                       axial, low_i);
      const float dlow = (new_low - low_i) * lim;
      n_low = lim > 0.0f ? new_low : low_i;
      axial_impulse(dlow);
      const float new_up = soft_limit(R(UPPER) - ln, -vr_dot(axx, axy),
                                      axial, up_i);
      const float dup = (new_up - up_i) * lim;
      n_up = lim > 0.0f ? new_up : up_i;
      axial_impulse(-dup);

      const float mot = R(F_MOTOR);
      float dimp_m = axial * (R(SPEED) - vr_dot(axx, axy));
      const float max_i = h * R(MAX1);
      const float new_mot = jclamp(mot_i + dimp_m, -max_i, max_i);
      dimp_m = (new_mot - mot_i) * mot;
      n_mot = mot > 0.0f ? new_mot : mot_i;
      axial_impulse(dimp_m);
      break;
    }
    case J_REVOLUTE: {
      if (warm) {
        const float axl = spr_i + mot_i + low_i - up_i;
        apply_lin(imp_x, imp_y, cross(rax, ray, imp_x, imp_y) + axl,
                  cross(rbx, rby, imp_x, imp_y) + axl);
        break;
      }
      const float rel_angle = atan2f(rels, relc);
      const float spr = R(F_SPRING);
      const float cspr = unwind(rel_angle - R(TARGET));
      float dimp = (-R(SM) * axial * ((wb - wa) + R(SB) * cspr)
                    - R(SI) * spr_i) * spr;
      n_spr = spr_i + dimp;
      apply_ang(dimp);

      const float mot = R(F_MOTOR);
      dimp = -axial * (wb - wa - R(SPEED));
      const float max_i = h * R(MAX1);
      const float new_mot = jclamp(mot_i + dimp, -max_i, max_i);
      dimp = (new_mot - mot_i) * mot;
      n_mot = mot > 0.0f ? new_mot : mot_i;
      apply_ang(dimp);

      const float lim = R(F_LIMIT);
      const float new_low = soft_limit(rel_angle - R(LOWER), wb - wa, axial,
                                       low_i);
      const float dlow = (new_low - low_i) * lim;
      n_low = lim > 0.0f ? new_low : low_i;
      apply_ang(dlow);
      const float new_up = soft_limit(R(UPPER) - rel_angle, wa - wb, axial,
                                      up_i);
      const float dup = (new_up - up_i) * lim;
      n_up = lim > 0.0f ? new_up : up_i;
      apply_ang(-dup);

      const float cdx = rel_x();
      const float cdy = rel_y();
      const float sepx = dpbx - dpax + (rbx - rax) + dcx;
      const float sepy = dpby - dpay + (rby - ray) + dcy;
      const float bx_ = cdx + bias_f * cb * sepx;
      const float by_ = cdy + bias_f * cb * sepy;
      const float msc = 1.0f + bias_f * (cm - 1.0f);
      const float isc = bias_f * ci;
      const float k11 = ma + mb + ray * ray * ia + rby * rby * ib;
      const float k12 = -ray * rax * ia - rby * rbx * ib;
      const float k22 = ma + mb + rax * rax * ia + rbx * rbx * ib;
      const float invd = recip_nz(k11 * k22 - k12 * k12);
      const float sx = invd * (k22 * bx_ - k12 * by_);
      const float sy = invd * (k11 * by_ - k12 * bx_);
      const float dix = -msc * sx - isc * imp_x;
      const float diy = -msc * sy - isc * imp_y;
      n_ix = imp_x + dix;
      n_iy = imp_y + diy;
      apply_point(dix, diy);
      break;
    }
    case J_WELD: {
      if (warm) {
        apply_lin(imp_x, imp_y, cross(rax, ray, imp_x, imp_y) + ang_i,
                  cross(rbx, rby, imp_x, imp_y) + ang_i);
        break;
      }
      const float rel_angle = atan2f(rels, relc);
      const float ang_on = fminf(bias_f + R(F_MOTOR), 1.0f);
      const float bias = ang_on * R(AB) * rel_angle;
      const float msc = 1.0f + ang_on * (R(AM) - 1.0f);
      const float isc = ang_on * R(AI);
      const float dimp = -msc * axial * (wb - wa + bias) - isc * ang_i;
      n_ang = ang_i + dimp;
      apply_ang(dimp);
      const float lin_on = fminf(bias_f + R(F_SPRING), 1.0f);
      const float sepx = dpbx - dpax + (rbx - rax) + dcx;
      const float sepy = dpby - dpay + (rby - ray) + dcy;
      const float cdx = rel_x();
      const float cdy = rel_y();
      const float sb = R(SB);
      const float bx_ = cdx + lin_on * sb * sepx;
      const float by_ = cdy + lin_on * sb * sepy;
      const float mscl = 1.0f + lin_on * (R(SM) - 1.0f);
      const float iscl = lin_on * R(SI);
      const float k11 = ma + mb + ray * ray * ia + rby * rby * ib;
      const float k12 = -ray * rax * ia - rby * rbx * ib;
      const float k22 = ma + mb + rax * rax * ia + rbx * rbx * ib;
      const float invd = recip_nz(k11 * k22 - k12 * k12);
      const float sx = invd * (k22 * bx_ - k12 * by_);
      const float sy = invd * (k11 * by_ - k12 * bx_);
      const float dix = -mscl * sx - iscl * imp_x;
      const float diy = -mscl * sy - iscl * imp_y;
      n_ix = imp_x + dix;
      n_iy = imp_y + diy;
      apply_point(dix, diy);
      break;
    }
    case J_MOTOR: {
      if (warm) {
        const float px = imp_x + s2x, py = imp_y + s2y;
        const float am2 = ang_i + spr_i;
        apply_lin(px, py, cross(rax, ray, px, py) + am2,
                  cross(rbx, rby, px, py) + am2);
        break;
      }
      const float rel_angle = atan2f(rels, relc);
      const float aspr = R(F_SPRING);
      float dimp = (-R(AM) * axial * (wb - wa + R(AB) * rel_angle)
                    - R(AI) * spr_i);
      float max_i = h * R(MAX2);
      const float new_aspr = jclamp(spr_i + dimp, -max_i, max_i);
      dimp = (new_aspr - spr_i) * aspr;
      n_spr = aspr > 0.0f ? new_aspr : spr_i;
      apply_ang(dimp);
      const float avel = R(F_MOTOR);
      dimp = -axial * (wb - wa - R(SPEED));
      max_i = h * R(MAX1);
      const float new_avel = jclamp(ang_i + dimp, -max_i, max_i);
      dimp = (new_avel - ang_i) * avel;
      n_ang = avel > 0.0f ? new_avel : ang_i;
      apply_ang(dimp);

      const float k11 = ma + mb + ray * ray * ia + rby * rby * ib;
      const float k12 = -ray * rax * ia - rby * rbx * ib;
      const float k22 = ma + mb + rax * rax * ia + rbx * rbx * ib;
      const float invd = recip_nz(k11 * k22 - k12 * k12);

      const float lspr = R(F_LIMIT);
      const float sepx = dpbx - dpax + (rbx - rax) + dcx;
      const float sepy = dpby - dpay + (rby - ray) + dcy;
      const float sb = R(SB), sm = R(SM), si = R(SI);
      float cdx = rel_x() + sb * sepx;
      float cdy = rel_y() + sb * sepy;
      float sx = invd * (k22 * cdx - k12 * cdy);
      float sy = invd * (k11 * cdy - k12 * cdx);
      float dix = -sm * sx - si * s2x;
      float diy = -sm * sy - si * s2y;
      float nx_ = s2x + dix, ny_ = s2y + diy;
      cap_length(nx_, ny_, h * R(MAX3), false);
      dix = (nx_ - s2x) * lspr;
      diy = (ny_ - s2y) * lspr;
      n_s2x = lspr > 0.0f ? nx_ : s2x;
      n_s2y = lspr > 0.0f ? ny_ : s2y;
      apply_point(dix, diy);

      const float lvel = R(F_AUX);
      cdx = rel_x() - R(LVX);
      cdy = rel_y() - R(LVY);
      sx = invd * (k22 * cdx - k12 * cdy);
      sy = invd * (k11 * cdy - k12 * cdx);
      nx_ = imp_x - sx;
      ny_ = imp_y - sy;
      cap_length(nx_, ny_, h * R(MAX4), false);
      dix = (nx_ - imp_x) * lvel;
      diy = (ny_ - imp_y) * lvel;
      n_ix = lvel > 0.0f ? nx_ : imp_x;
      n_iy = lvel > 0.0f ? ny_ : imp_y;
      apply_point(dix, diy);
      break;
    }
    case J_PRISMATIC:
    case J_WHEEL: {
      const float axx = qac, axy = qas;
      const float perpx = -axy, perpy = axx;
      const float a1 = cross(rax + dx, ray + dy, axx, axy);
      const float a2 = cross(rbx, rby, axx, axy);
      const float s1 = cross(rax + dx, ray + dy, perpx, perpy);
      const float s2 = cross(rbx, rby, perpx, perpy);
      const float translation = axx * dx + axy * dy;
      const float ax_mass = recip_pos(ma + mb + ia * a1 * a1 + ib * a2 * a2);
      auto adot = [&]() {
        const float base = axx * (vbx - vax) + axy * (vby - vay);
        return base + a2 * wb - a1 * wa;
      };
      auto apply_axial = [&](float di) {
        const float px = di * axx, py = di * axy;
        vax = vax - ma * px;
        vay = vay - ma * py;
        wa = wa - ia * di * a1;
        vbx = vbx + mb * px;
        vby = vby + mb * py;
        wb = wb + ib * di * a2;
      };
      auto limits = [&]() {
        const float lim = R(F_LIMIT);
        const float new_low = soft_limit(translation - R(LOWER), adot(),
                                         ax_mass, low_i);
        const float dlow = (new_low - low_i) * lim;
        n_low = lim > 0.0f ? new_low : low_i;
        apply_axial(dlow);
        const float new_up = soft_limit(R(UPPER) - translation, -adot(),
                                        ax_mass, up_i);
        const float dup = (new_up - up_i) * lim;
        n_up = lim > 0.0f ? new_up : up_i;
        apply_axial(-dup);
      };
      auto perp_dot = [&]() {
        return perpx * (vbx - vax) + perpy * (vby - vay) + s2 * wb - s1 * wa;
      };
      if (jtype == J_PRISMATIC) {
        if (warm) {
          const float axl = spr_i + mot_i + low_i - up_i;
          apply_lin(axl * axx + imp_x * perpx, axl * axy + imp_x * perpy,
                    axl * a1 + imp_x * s1 + imp_y,
                    axl * a2 + imp_x * s2 + imp_y);
          break;
        }
        const float rel_angle = atan2f(rels, relc);
        const float spr = R(F_SPRING);
        const float cspr = translation - R(TARGET);
        float dimp = (-R(SM) * ax_mass * (adot() + R(SB) * cspr)
                      - R(SI) * spr_i) * spr;
        n_spr = spr_i + dimp;
        apply_axial(dimp);
        const float mot = R(F_MOTOR);
        dimp = ax_mass * (R(SPEED) - adot());
        const float max_i = h * R(MAX1);
        const float new_mot = jclamp(mot_i + dimp, -max_i, max_i);
        dimp = (new_mot - mot_i) * mot;
        n_mot = mot > 0.0f ? new_mot : mot_i;
        apply_axial(dimp);
        limits();
        const float cdot1 = perp_dot();
        const float cdot2 = wb - wa;
        const float bias1 = bias_f * cb * (perpx * dx + perpy * dy);
        const float bias2 = bias_f * cb * rel_angle;
        const float msc = 1.0f + bias_f * (cm - 1.0f);
        const float isc = bias_f * ci;
        const float k11 = ma + mb + ia * s1 * s1 + ib * s2 * s2;
        const float k12 = ia * s1 + ib * s2;
        float k22 = ia + ib;
        k22 = k22 == 0.0f ? 1.0f : k22;
        const float invd = recip_nz(k11 * k22 - k12 * k12);
        const float bx_ = cdot1 + bias1;
        const float by_ = cdot2 + bias2;
        const float sx = invd * (k22 * bx_ - k12 * by_);
        const float sy = invd * (k11 * by_ - k12 * bx_);
        const float dix = -msc * sx - isc * imp_x;
        const float diy = -msc * sy - isc * imp_y;
        n_ix = imp_x + dix;
        n_iy = imp_y + diy;
        apply_lin(dix * perpx, dix * perpy, dix * s1 + diy, dix * s2 + diy);
      } else {
        if (warm) {
          const float axl = spr_i + low_i - up_i;
          apply_lin(axl * axx + imp_x * perpx, axl * axy + imp_x * perpy,
                    axl * a1 + imp_x * s1 + mot_i,
                    axl * a2 + imp_x * s2 + mot_i);
          break;
        }
        const float motor_mass = recip_pos(ia + ib);
        const float perp_mass =
            recip_pos(ma + mb + ia * s1 * s1 + ib * s2 * s2);
        const float mot = R(F_MOTOR);
        float dimp = -motor_mass * (wb - wa - R(SPEED));
        const float max_i = h * R(MAX1);
        const float new_mot = jclamp(mot_i + dimp, -max_i, max_i);
        dimp = (new_mot - mot_i) * mot;
        n_mot = mot > 0.0f ? new_mot : mot_i;
        apply_ang(dimp);
        const float spr = R(F_SPRING);
        dimp = (-R(SM) * ax_mass * (adot() + R(SB) * translation)
                - R(SI) * spr_i) * spr;
        n_spr = spr_i + dimp;
        apply_axial(dimp);
        limits();
        const float cdot = perp_dot();
        const float bias = bias_f * cb * (perpx * dx + perpy * dy);
        const float msc = 1.0f + bias_f * (cm - 1.0f);
        const float isc = bias_f * ci;
        dimp = -msc * perp_mass * (cdot + bias) - isc * imp_x;
        n_ix = imp_x + dimp;
        apply_lin(dimp * perpx, dimp * perpy, dimp * s1, dimp * s2);
      }
      break;
    }
    case J_MOUSE: {
      if (warm) {
        apply_lin(imp_x, imp_y, 0.0f, cross(rbx, rby, imp_x, imp_y));
        break;
      }
      const float sb = R(SB);
      const float cx = dcx - fapx + rbx + dpbx;
      const float cy = dcy - fapy + rby + dpby;
      const float cdx = vbx - wb * rby + sb * cx;
      const float cdy = vby + wb * rbx + sb * cy;
      const float k11 = mb + rby * rby * ib;
      const float k12 = -rby * rbx * ib;
      const float k22 = mb + rbx * rbx * ib;
      const float invd = recip_nz(k11 * k22 - k12 * k12);
      const float sx = invd * (k22 * cdx - k12 * cdy);
      const float sy = invd * (k11 * cdy - k12 * cdx);
      float dix = -R(SM) * sx - R(SI) * imp_x;
      float diy = -R(SM) * sy - R(SI) * imp_y;
      float nx_ = imp_x + dix, ny_ = imp_y + diy;
      cap_length(nx_, ny_, h * R(MAX1), true);
      n_ix = nx_;
      n_iy = ny_;
      dix = nx_ - imp_x;
      diy = ny_ - imp_y;
      vbx = vbx + mb * dix;
      vby = vby + mb * diy;
      wb = wb + ib * cross(rbx, rby, dix, diy);
      break;
    }
    default:
      break;  // filter joints are never live lanes
  }

  if (!warm) {
    a[IX * LJ] = n_ix;
    a[IY * LJ] = n_iy;
    a[A_SPRING * LJ] = n_spr;
    a[A_MOTOR * LJ] = n_mot;
    a[A_LOWER * LJ] = n_low;
    a[A_UPPER * LJ] = n_up;
    a[A_ANGULAR * LJ] = n_ang;
    a[S2X * LJ] = n_s2x;
    a[S2Y * LJ] = n_s2y;
  }
  out[0] = vax - vax0; out[1] = vay - vay0; out[2] = wa - wa0;
  out[3] = vbx - vbx0; out[4] = vby - vby0; out[5] = wb - wb0;
}

}  // namespace
