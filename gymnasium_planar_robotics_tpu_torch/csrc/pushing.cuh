// Device functions shared by the pushing kernels (noise probe, pushing
// cycles, pushing autoreset step, K-step rollout).
//
// Layout: one thread per env; every input and output is an f32 plane of
// B envs stored structure-of-arrays as [planes, B], so neighbouring threads
// read neighbouring addresses.  The tail block masks envs >= B.
//
// Arithmetic follows gymnasium_planar_robotics_tpu/ops/pallas_step.py
// expression by expression (same operand order; JAX's "where(dx == 0, 1,
// sign(dx))" and "sign(0) == 0" written out).  Every scalar constant is an
// f32 rounding of the value the Pallas kernel bakes in at trace time; sums
// the Pallas kernel forms in Python float64 (e.g. 1 + dt*damping/mass) are
// formed the same way on the host and arrive here already rounded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3, no
// --use_fast_math (sqrtf, division, logf, cosf and sinf stay IEEE / libm
// accurate so the card agrees with the plain PyTorch versions).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gprt {

constexpr int kThreads = 128;
constexpr float kTwoPi = 6.28318530717958647692f;

// The constants struct, passed by value to every pushing kernel.  The field
// order is the contract with the Python side (CONST_FIELDS in
// ops/kernels/pushing.py), checked at load time through gprt_const_names().
#define GPRT_CONST_FIELDS(X)                                                   \
  X(v_max) X(a_max) X(dt) X(std_pos) X(std_vel) X(accel_scale) X(total_mass)   \
  X(mover_hx) X(mover_hy) X(obj_hx) X(obj_hy) X(obj_mass) X(contact_k)         \
  X(contact_b) X(contact_bt) X(contact_mu) X(mu_g_dt) X(obj_inertia)           \
  X(plow_unit) X(plow_cap) X(cone_zeta) X(cone_vt) X(cone_vt_off)              \
  X(cone_vt_span) X(conez_unit) X(conez_cap) X(mover_height) X(obj_height)     \
  X(imp_k) X(imp_d) X(z0) X(fz_cap0) X(fz_slope) X(damp) X(damp_w)             \
  X(mu_spin_dt) X(wall_size) X(x0) X(x1) X(y0) X(y1) X(has_fast) X(fx0)        \
  X(fx1) X(fy0) X(fy1) X(object_noise) X(max_episode_steps) X(min_x) X(min_y)  \
  X(span_x) X(span_y) X(obj_min_x) X(obj_min_y) X(obj_span_x) X(obj_span_y)    \
  X(min_mo) X(threshold)

#define GPRT_DECLARE_FIELD(name) float name;
struct Consts {
  GPRT_CONST_FIELDS(GPRT_DECLARE_FIELD)
};
#undef GPRT_DECLARE_FIELD

// ---------------------------------------------------------------------------
// noise sources: uniform() returns the next uniform in [0, 1) of this env
// ---------------------------------------------------------------------------

// Pre-drawn uniforms [N, B]: draw d of env e is p[d * B + e], in the order
// the Pallas kernel's _InjectedNoise consumes its planes.
struct InjectedNoise {
  const float* p;
  int64_t stride;
  __device__ InjectedNoise(const float* base, int64_t batch, int64_t env) : p(base + env), stride(batch) {}
  __device__ __forceinline__ float uniform() {
    float u = *p;
    p += stride;
    return u;
  }
};

// Philox4x32-10 (Salmon et al., SC'11), key = the launch seed, counter =
// (draw / 4, env, 0, 0); word draw % 4 of the block becomes the uniform.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Mantissa-bitcast uniform (pallas_step._uniform): OR 23 random bits into
// the mantissa of 1.0 to get [1, 2), subtract 1.  Never returns 1.0.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

struct PhiloxNoise {
  uint2 key;
  uint32_t env;
  uint32_t block;
  int word;
  uint4 buf;
  __device__ PhiloxNoise(uint64_t seed, int64_t env_)
      : key(make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32))),
        env(static_cast<uint32_t>(env_)), block(0), word(4), buf(make_uint4(0, 0, 0, 0)) {}
  __device__ __forceinline__ float uniform() {
    if (word == 4) {
      buf = philox4x32_10(make_uint4(block++, env, 0u, 0u), key);
      word = 0;
    }
    const uint32_t bits = word == 0 ? buf.x : word == 1 ? buf.y : word == 2 ? buf.z : buf.w;
    ++word;
    return bits_to_uniform(bits);
  }
};

// Box-Muller (pallas_step._NoiseBase.normal_pair): u1 = 1 - u keeps the log
// finite; draws u1's uniform first, then u2's.
template <class Noise>
__device__ __forceinline__ void normal_pair(Noise& noise, float& a, float& b) {
  const float u1 = 1.0f - noise.uniform();
  const float u2 = noise.uniform();
  const float r = sqrtf(-2.0f * logf(u1));
  const float th = kTwoPi * u2;
  a = r * cosf(th);
  b = r * sinf(th);
}

// ---------------------------------------------------------------------------
// small helpers with JAX semantics
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// jnp.sign: -1, 0 or +1 (0 at 0, unlike copysignf)
__device__ __forceinline__ float sign0(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// L2-ball clamp (pallas_step._clamp_norm2): inclusive >=, max*v/norm order
__device__ __forceinline__ bool clamp_norm2(float x, float y, float max_val, float& cx, float& cy) {
  const float norm = sqrtf(x * x + y * y);
  const bool clamp = norm >= max_val;
  const float safe = norm > 0.0f ? norm : 1.0f;
  cx = clamp ? max_val * x / safe : x;
  cy = clamp ? max_val * y / safe : y;
  return clamp;
}

// Circle wall validity on a fully populated layout (pallas_step.
// _make_wall_valid, full-layout branch): centre above the table and the
// inflated circle strictly inside the outer rectangle, or centre above the
// interior rectangle of complete 3x3 cells.
__device__ __forceinline__ bool wall_valid(const Consts& c, float px, float py, float r) {
  const bool above = (px >= c.x0) & (px <= c.x1) & (py >= c.y0) & (py <= c.y1);
  const bool inside = (px - r > c.x0) & (px + r < c.x1) & (py - r > c.y0) & (py + r < c.y1);
  bool res = above & inside;
  if (c.has_fast != 0.0f) res = ((px >= c.fx0) & (px <= c.fx1) & (py >= c.fy0) & (py <= c.fy1)) | res;
  return res;
}

// ---------------------------------------------------------------------------
// one env step of pushing physics: num_cycles control cycles
// ---------------------------------------------------------------------------

struct Phys {
  float px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz;
};

// pallas_step._make_pushing_cycles.run: clamp chain (acc or jerk), v2
// box-push contact with the hysteretic face axis, quasi-3D mover z, wedge
// cap, cone share, plow load, floor and spin Coulomb friction, noisy wall
// check, collision latch.  Draws 4 uniforms per cycle (velocity pair, wall
// pair), also for latched envs.  Returns the wall flag (0 or 1).
template <bool kJerk, class Noise>
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
      const float cax0 = s.ax + c.dt * ux, cay0 = s.ay + c.dt * uy;
      float cax, cay;
      const bool aclamp = clamp_norm2(cax0, cay0, c.a_max, cax, cay);
      const float j1x = aclamp ? (cax - s.ax) / c.dt : ux;
      const float j1y = aclamp ? (cay - s.ay) / c.dt : uy;
      const float nx = vmx + c.dt * cax, ny = vmy + c.dt * cay;
      float cnx, cny;
      const bool vclamp = clamp_norm2(nx, ny, c.v_max, cnx, cny);
      const float fax = vclamp ? (cnx - vmx) / c.dt : cax;
      const float fay = vclamp ? (cny - vmy) / c.dt : cay;
      const bool diff = (fax != cax) | (fay != cay);
      const float jx = diff ? (fax - s.ax) / c.dt : j1x;
      const float jy = diff ? (fay - s.ay) / c.dt : j1y;
      nkx = s.kx + c.dt * jx;
      nky = s.ky + c.dt * jy;
      ctrl_x = nkx;
      ctrl_y = nky;
    } else {
      const float nx = vmx + c.dt * ux, ny = vmy + c.dt * uy;
      float cnx, cny;
      const bool vclamp = clamp_norm2(nx, ny, c.v_max, cnx, cny);
      ctrl_x = vclamp ? (cnx - vmx) / c.dt : ux;
      ctrl_y = vclamp ? (cny - vmy) / c.dt : uy;
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

    float nwx, nwy;
    normal_pair(noise, nwx, nwy);
    const float new_wall_f = wall_valid(c, npx + nwx * c.std_pos, npy + nwy * c.std_pos, c.wall_size) ? 0.0f : 1.0f;

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

template <class Noise>
__device__ __forceinline__ float uniform_in(Noise& noise, float lo, float span) {
  return lo + noise.uniform() * span;
}

// Cycles, termination, pre-reset observation (3 pairs), in-kernel restart
// (mover 2, object 2 + 2*(cand_k-1) candidates, goal 2), post-reset
// observation (3 pairs): 4*num_cycles + 16 + 2*cand_k uniforms.
template <bool kJerk, class Noise>
__device__ void autoreset_step(const Consts& c, Noise& noise, int num_cycles, int cand_k, StepState& st, float ux,
                               float uy, StepAux& aux) {
  Phys& s = st.p;
  const float g_old_x = st.gx, g_old_y = st.gy;
  const float wall_f = run_cycles<kJerk>(c, noise, num_cycles, s, ux, uy);
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

inline unsigned int num_blocks(int64_t B) { return static_cast<unsigned int>((B + kThreads - 1) / kThreads); }

}  // namespace gprt
