// Device functions of the pushing kernels (pushing cycles, pushing
// autoreset step, K-step rollout); noise, the clamp chain and the wall rule
// come from common.cuh and walls.cuh.
//
// Arithmetic follows gymnasium_planar_robotics_tpu/ops/pallas_step.py
// expression by expression (same operand order; JAX's "where(dx == 0, 1,
// sign(dx))" and "sign(0) == 0" written out).  Every scalar constant is an
// f32 rounding of the value the Pallas kernel bakes in at trace time; sums
// the Pallas kernel forms in Python float64 (e.g. 1 + dt*damping/mass) are
// formed the same way on the host and arrive here already rounded.

#pragma once

#include "common.cuh"
#include "walls.cuh"

namespace gprt {

// The constants struct, passed by value to every pushing kernel.  The field
// order is the contract with the Python side (CONST_FIELDS in
// ops/kernels/pushing.py), checked at load time through gprt_const_names().
// wall_x/wall_y: the wall-check size during cycles, c + offset_wall (the
// radius in both for the circle, the half-extents for the box).
#define GPRT_CONST_FIELDS(X)                                                   \
  X(v_max) X(a_max) X(dt) X(std_pos) X(std_vel) X(accel_scale) X(total_mass)   \
  X(mover_hx) X(mover_hy) X(obj_hx) X(obj_hy) X(obj_mass) X(contact_k)         \
  X(contact_b) X(contact_bt) X(contact_mu) X(mu_g_dt) X(obj_inertia)           \
  X(plow_unit) X(plow_cap) X(cone_zeta) X(cone_vt) X(cone_vt_off)              \
  X(cone_vt_span) X(conez_unit) X(conez_cap) X(mover_height) X(obj_height)     \
  X(imp_k) X(imp_d) X(z0) X(fz_cap0) X(fz_slope) X(damp) X(damp_w)             \
  X(mu_spin_dt) X(wall_x) X(wall_y) X(x0) X(x1) X(y0) X(y1) X(has_fast)       \
  X(fx0) X(fx1) X(fy0) X(fy1) X(object_noise) X(max_episode_steps) X(min_x)   \
  X(min_y) X(span_x) X(span_y) X(obj_min_x) X(obj_min_y) X(obj_span_x)         \
  X(obj_span_y) X(min_mo) X(threshold)

#define GPRT_DECLARE_FIELD(name) float name;
struct Consts {
  GPRT_CONST_FIELDS(GPRT_DECLARE_FIELD)
};
#undef GPRT_DECLARE_FIELD

// ---------------------------------------------------------------------------
// one env step of pushing physics: num_cycles control cycles
// ---------------------------------------------------------------------------

struct Phys {
  float px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz;
};

// The per-cycle noisy wall check on the fully populated table
// (pallas_step._make_wall_checker.check): the position noise pair, for the
// box (kBox) also two pairs of quaternion noise around the identity, turned
// into the 2D rotation by quat_to_R2.  True = no wall collision.  The circle
// keeps the expression it had before the box existed (nvcc may contract
// it); the box rounds each operation as the plain version does.
template <bool kBox, class Noise>
__device__ __forceinline__ bool wall_ok(const Consts& c, Noise& noise, float npx, float npy) {
  float nwx, nwy;
  normal_pair(noise, nwx, nwy);
  if constexpr (!kBox) return circle_valid_full(c, npx + nwx * c.std_pos, npy + nwy * c.std_pos, c.wall_x);
  float q1, q2, q3, q4;
  normal_pair(noise, q1, q2);
  normal_pair(noise, q3, q4);
  const Rot2 R = quat_to_R2(madd(1.0f, q1, c.std_pos), mul(q2, c.std_pos), mul(q3, c.std_pos), mul(q4, c.std_pos));
  return box_valid_full(c, madd(npx, nwx, c.std_pos), madd(npy, nwy, c.std_pos), R, c.wall_x, c.wall_y);
}

// pallas_step._make_pushing_cycles.run: clamp chain (acc or jerk), v2
// box-push contact with the hysteretic face axis, quasi-3D mover z, wedge
// cap, cone share, plow load, floor and spin Coulomb friction, noisy wall
// check, collision latch.  Draws 2 + 2p uniforms per cycle (the velocity
// pair, then p = 1 wall pair for the circle, 3 for the box), also for
// latched envs.  Returns the wall flag (0 or 1).
template <bool kJerk, bool kBox, class Noise>
__device__ float run_cycles(const Consts& c, Noise& noise, int num_cycles, Phys& s, float ux, float uy) {
  float done_f = 0.0f, wall_f = 0.0f;
  float caxis = -1.0f;  // hysteretic normal axis: lives only within this step
  for (int i = 0; i < num_cycles; ++i) {
    const bool done = done_f > 0.0f;
    float nvx, nvy;
    normal_pair(noise, nvx, nvy);
    const float vmx = s.vx + nvx * c.std_vel;
    const float vmy = s.vy + nvy * c.std_vel;

    float ctrl_x, ctrl_y, nkx, nky;
    if (kJerk) {
      // measured acceleration: the last qacc; integrator state: act
      clamp_chain<true>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, s.ax, s.ay, s.kx, s.ky, nkx, nky);
      ctrl_x = nkx;
      ctrl_y = nky;
    } else {
      clamp_chain<false>(c.v_max, c.a_max, c.dt, vmx, vmy, ux, uy, s.ax, s.ay, s.kx, s.ky, ctrl_x, ctrl_y);
      nkx = s.kx;
      nky = s.ky;
    }

    // corner-aware penalty contact from the pre-integration state
    const float cos_y = cosf(s.oyaw), sin_y = sinf(s.oyaw);
    const float rx = fabsf(cos_y) * c.obj_hx + fabsf(sin_y) * c.obj_hy;
    const float ry = fabsf(sin_y) * c.obj_hx + fabsf(cos_y) * c.obj_hy;
    const float dx = s.ox - s.px, dy = s.oy - s.py;
    const float olx = (c.mover_hx + rx) - fabsf(dx);
    const float oly = (c.mover_hy + ry) - fabsf(dy);
    const bool in_contact = (olx > 0.0f) & (oly > 0.0f);
    const float olx_c = fmaxf(olx, 0.0f), oly_c = fmaxf(oly, 0.0f);
    const float sx = dx < 0.0f ? -1.0f : 1.0f;  // where(dx == 0, 1, sign(dx))
    const float sy = dy < 0.0f ? -1.0f : 1.0f;
    const bool keep_x = (caxis == 0.0f) & (olx > 0.0f);
    const bool keep_y = (caxis == 1.0f) & (oly > 0.0f);
    const bool axis_x = keep_x | ((olx_c <= oly_c) & !keep_y);
    const float n_x = axis_x ? sx : 0.0f;
    const float n_y = axis_x ? 0.0f : sy;
    const float pen = axis_x ? olx_c : oly_c;
    const float new_caxis = in_contact ? (axis_x ? 0.0f : 1.0f) : -1.0f;

    const float lo_x = fmaxf(s.px - c.mover_hx, s.ox - rx);
    const float hi_x = fminf(s.px + c.mover_hx, s.ox + rx);
    const float lo_y = fmaxf(s.py - c.mover_hy, s.oy - ry);
    const float hi_y = fminf(s.py + c.mover_hy, s.oy + ry);
    const float cpx = 0.5f * (lo_x + hi_x), cpy = 0.5f * (lo_y + hi_y);
    const float r_ox = cpx - s.ox, r_oy = cpy - s.oy;
    const float v_obj_cx = s.wvx - s.ow * r_oy;
    const float v_obj_cy = s.wvy + s.ow * r_ox;
    const float vrx = v_obj_cx - s.vx, vry = v_obj_cy - s.vy;
    const float vn = vrx * n_x + vry * n_y;
    const float fn_mag = fmaxf(0.0f, c.contact_k * pen - c.contact_b * vn);
    const float t_x = -n_y, t_y = n_x;
    const float vt = vrx * t_x + vry * t_y;
    // slip-gated vertical friction share, wedge-capped by the mover lift
    const float f_imp_r = fminf(fmaxf(0.0f, -c.contact_b * vn), fn_mag);
    const float avt = fabsf(vt);
    const float slip = fminf(avt / c.cone_vt, 1.0f) * clip01((c.cone_vt_off - avt) / c.cone_vt_span);
    const float fz_cap = c.fz_cap0 + c.fz_slope * fmaxf(s.mz - c.z0, 0.0f);
    const float f_z = fminf(c.cone_zeta * fn_mag * slip, fz_cap);
    const float budget = c.contact_mu * fn_mag;
    const float cap = f_z > 0.0f ? sqrtf(fmaxf(budget * budget - f_z * f_z, 0.0f)) : budget;
    const float ft_mag = fminf(fmaxf(-c.contact_bt * vt, -cap), cap);
    const float cmask = in_contact ? 1.0f : 0.0f;
    // quasi-3D z-overlap scaling and mover z (impedance vs the f_z lift)
    const float zf = clip01((fminf(s.mz + c.mover_height, c.obj_height) - s.mz) / c.mover_height);
    const float f_obj_x = (fn_mag * n_x + ft_mag * t_x) * cmask * zf;
    const float f_obj_y = (fn_mag * n_y + ft_mag * t_y) * cmask * zf;
    const float torque = r_ox * f_obj_y - r_oy * f_obj_x;
    const float f_z_c = f_z * cmask * zf;
    const float zacc = (c.imp_k * (c.z0 - s.mz) - c.imp_d * s.mvz + f_z_c) / c.total_mass;
    const float new_mvz = s.mvz + c.dt * zacc;
    const float new_mz = fmaxf(s.mz + c.dt * new_mvz, 0.0f);

    // gain-mass-scaled command + contact reaction over the total body mass
    const float qacc_x = c.accel_scale * ctrl_x + (-f_obj_x) / c.total_mass;
    const float qacc_y = c.accel_scale * ctrl_y + (-f_obj_y) / c.total_mass;
    const float nvx_t = s.vx + c.dt * qacc_x;
    const float nvy_t = s.vy + c.dt * qacc_y;
    const float npx = s.px + c.dt * nvx_t;
    const float npy = s.py + c.dt * nvy_t;

    // object: plow load, implicit joint damping, exact discrete Coulomb
    const float fimp = f_imp_r * cmask * zf;
    const float load = 1.0f + fminf(c.plow_unit * fimp, c.plow_cap) + fminf(c.conez_unit * f_z_c, c.conez_cap);
    float ovx_t = (s.wvx + c.dt * (f_obj_x / c.obj_mass)) / c.damp;
    float ovy_t = (s.wvy + c.dt * (f_obj_y / c.obj_mass)) / c.damp;
    const float speed = sqrtf(ovx_t * ovx_t + ovy_t * ovy_t);
    const float scale = fmaxf(0.0f, 1.0f - c.mu_g_dt * load / fmaxf(speed, 1e-12f));
    ovx_t = ovx_t * scale;
    ovy_t = ovy_t * scale;
    const float nox = s.ox + c.dt * ovx_t;
    const float noy = s.oy + c.dt * ovy_t;
    // yaw: contact torque, implicit damping, torsional Coulomb floor
    float ow_t = (s.ow + c.dt * torque / c.obj_inertia) / c.damp_w;
    ow_t = sign0(ow_t) * fmaxf(0.0f, fabsf(ow_t) - c.mu_spin_dt * load);
    const float noyaw = s.oyaw + c.dt * ow_t;

    const float new_wall_f = wall_ok<kBox>(c, noise, npx, npy) ? 0.0f : 1.0f;

    if (!done) {
      s.px = npx; s.py = npy; s.vx = nvx_t; s.vy = nvy_t;
      s.ax = qacc_x; s.ay = qacc_y; s.kx = nkx; s.ky = nky;
      s.ox = nox; s.oy = noy; s.wvx = ovx_t; s.wvy = ovy_t;
      s.oyaw = noyaw; s.ow = ow_t; s.mz = new_mz; s.mvz = new_mvz;
      // the carried axis dies when the climb breaks contact (zf == 0)
      caxis = zf > 0.0f ? new_caxis : -1.0f;
      wall_f = new_wall_f;
    }
    done_f = fmaxf(done_f, wall_f);
  }
  return wall_f;
}

// ---------------------------------------------------------------------------
// one full autoreset env step (pallas_step._pushing_autoreset_step)
// ---------------------------------------------------------------------------

struct StepState {
  Phys p;
  float gx, gy, steps;
};

// the 17 per-step outputs besides the state, in the Pallas aux order
struct StepAux {
  float s_mpx, s_mpy, s_mvx, s_mvy, s_agx, s_agy;
  float f_mpx, f_mpy, f_mvx, f_mvy, f_agx, f_agy, f_qax, f_qay;
  float wall, reached, trunc, stalled, trials;
};

// Cycles, termination, pre-reset observation (3 pairs), in-kernel restart
// (mover 2, object 2 + 2*(cand_k-1) candidates, goal 2), post-reset
// observation (3 pairs): (2 + 2p)*num_cycles + 16 + 2*cand_k uniforms (p = 1
// circle, 3 box).  The restart draws no wall check.
template <bool kJerk, bool kBox, class Noise>
__device__ void autoreset_step(const Consts& c, Noise& noise, int num_cycles, int cand_k, StepState& st, float ux,
                               float uy, StepAux& aux) {
  Phys& s = st.p;
  const float g_old_x = st.gx, g_old_y = st.gy;
  const float wall_f = run_cycles<kJerk, kBox>(c, noise, num_cycles, s, ux, uy);
  aux.f_qax = s.ax;  // pre-reset qacc (jerk-mode final observation)
  aux.f_qay = s.ay;

  float n1, n2, n3, n4, n5, n6;
  normal_pair(noise, n1, n2);
  normal_pair(noise, n3, n4);
  normal_pair(noise, n5, n6);
  aux.f_mpx = s.px + n1 * c.std_pos;
  aux.f_mpy = s.py + n2 * c.std_pos;
  aux.f_mvx = s.vx + n3 * c.std_vel;
  aux.f_mvy = s.vy + n4 * c.std_vel;
  aux.f_agx = s.ox + n5 * c.object_noise;
  aux.f_agy = s.oy + n6 * c.object_noise;

  const bool term = wall_f > 0.0f;
  const float new_steps = st.steps + 1.0f;
  const bool trunc = new_steps >= c.max_episode_steps;
  const bool done = term | trunc;

  // restart: mover uniform, object = first of cand_k candidates farther than
  // min_mo from the new mover, goal uniform
  const float rmx = uniform_in(noise, c.min_x, c.span_x);
  const float rmy = uniform_in(noise, c.min_y, c.span_y);
  float rox = uniform_in(noise, c.obj_min_x, c.obj_span_x);
  float roy = uniform_in(noise, c.obj_min_y, c.obj_span_y);
  const float d0x = rox - rmx, d0y = roy - rmy;
  float found = sqrtf(d0x * d0x + d0y * d0y) > c.min_mo ? 1.0f : 0.0f;
  float trials = 1.0f;
  for (int k = 1; k < cand_k; ++k) {
    const float cx = uniform_in(noise, c.obj_min_x, c.obj_span_x);
    const float cy = uniform_in(noise, c.obj_min_y, c.obj_span_y);
    const float ddx = cx - rmx, ddy = cy - rmy;
    const bool ok = sqrtf(ddx * ddx + ddy * ddy) > c.min_mo;
    const bool take = ok & (found == 0.0f);
    trials = trials + (1.0f - found);
    rox = take ? cx : rox;
    roy = take ? cy : roy;
    found = fmaxf(found, ok ? 1.0f : 0.0f);
  }
  const float rgx = uniform_in(noise, c.obj_min_x, c.obj_span_x);
  const float rgy = uniform_in(noise, c.obj_min_y, c.obj_span_y);

  // a stalled restart keeps the post-cycle state and the incremented step
  // counter, so done fires again next step and the restart is retried
  aux.stalled = (done & (found == 0.0f)) ? 1.0f : 0.0f;
  const bool do_reset = done & (found > 0.0f);
  if (do_reset) {
    s.px = rmx; s.py = rmy; s.vx = 0.0f; s.vy = 0.0f;
    s.ax = 0.0f; s.ay = 0.0f; s.kx = 0.0f; s.ky = 0.0f;
    s.ox = rox; s.oy = roy; s.wvx = 0.0f; s.wvy = 0.0f;
    s.oyaw = 0.0f; s.ow = 0.0f; s.mz = c.z0; s.mvz = 0.0f;
    st.gx = rgx; st.gy = rgy; st.steps = 0.0f;
  } else {
    st.steps = new_steps;
  }

  float m1, m2, m3, m4, m5, m6;
  normal_pair(noise, m1, m2);
  normal_pair(noise, m3, m4);
  normal_pair(noise, m5, m6);
  aux.s_mpx = do_reset ? s.px + m1 * c.std_pos : aux.f_mpx;
  aux.s_mpy = do_reset ? s.py + m2 * c.std_pos : aux.f_mpy;
  aux.s_mvx = do_reset ? s.vx + m3 * c.std_vel : aux.f_mvx;
  aux.s_mvy = do_reset ? s.vy + m4 * c.std_vel : aux.f_mvy;
  aux.s_agx = do_reset ? s.ox + m5 * c.object_noise : aux.f_agx;
  aux.s_agy = do_reset ? s.oy + m6 * c.object_noise : aux.f_agy;

  // reference scoring: noisy achieved position vs the OLD goal
  const float ddx_g = aux.f_agx - g_old_x, ddy_g = aux.f_agy - g_old_y;
  aux.reached = sqrtf(ddx_g * ddx_g + ddy_g * ddy_g) <= c.threshold ? 1.0f : 0.0f;
  aux.wall = wall_f;
  aux.trunc = trunc ? 1.0f : 0.0f;
  aux.trials = done ? trials : 0.0f;
}

// plane I/O of the 16 physics planes / 19 step-state planes
__device__ __forceinline__ void load_phys(const float* in, int64_t B, int64_t e, Phys& s) {
  s.px = in[0 * B + e]; s.py = in[1 * B + e]; s.vx = in[2 * B + e]; s.vy = in[3 * B + e];
  s.ax = in[4 * B + e]; s.ay = in[5 * B + e]; s.kx = in[6 * B + e]; s.ky = in[7 * B + e];
  s.ox = in[8 * B + e]; s.oy = in[9 * B + e]; s.wvx = in[10 * B + e]; s.wvy = in[11 * B + e];
  s.oyaw = in[12 * B + e]; s.ow = in[13 * B + e]; s.mz = in[14 * B + e]; s.mvz = in[15 * B + e];
}

__device__ __forceinline__ void store_phys(float* out, int64_t B, int64_t e, const Phys& s) {
  out[0 * B + e] = s.px; out[1 * B + e] = s.py; out[2 * B + e] = s.vx; out[3 * B + e] = s.vy;
  out[4 * B + e] = s.ax; out[5 * B + e] = s.ay; out[6 * B + e] = s.kx; out[7 * B + e] = s.ky;
  out[8 * B + e] = s.ox; out[9 * B + e] = s.oy; out[10 * B + e] = s.wvx; out[11 * B + e] = s.wvy;
  out[12 * B + e] = s.oyaw; out[13 * B + e] = s.ow; out[14 * B + e] = s.mz; out[15 * B + e] = s.mvz;
}

__device__ __forceinline__ void load_state(const float* in, int64_t B, int64_t e, StepState& st) {
  load_phys(in, B, e, st.p);
  st.gx = in[16 * B + e];
  st.gy = in[17 * B + e];
  st.steps = in[18 * B + e];
}

__device__ __forceinline__ void store_state(float* out, int64_t B, int64_t e, const StepState& st) {
  store_phys(out, B, e, st.p);
  out[16 * B + e] = st.gx;
  out[17 * B + e] = st.gy;
  out[18 * B + e] = st.steps;
}

}  // namespace gprt
