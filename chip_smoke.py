#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Builds the port's CUDA kernels from ``gymnasium_planar_robotics_tpu_torch/
csrc`` (nvcc, at first use), then runs these phases and prints one line per
phase:

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions, the
   build time and the compiler's register report;
2. kernel A (noise probe) against its plain PyTorch version on injected
   uniforms and on the host copy of its Philox stream, plus the moments of
   262,144 Philox normals;
3. kernels B, C and D against their plain versions at 4096 envs, injected
   uniforms, from states with the mover planted at the object;
4. the public serving path: ``make_pushing_env`` -> ``init_batch(4096)`` ->
   ``make_fused_step`` and ``make_fused_step_autoreset`` for a few steps ->
   ``make_fused_rollout`` for 64 steps at K=1 and K=32 (Philox noise), with
   every launch counter read before and after; K=32 against K=1 at
   ``std_noise=0`` on envs that never restart;
5. env-steps/s of ``make_fused_rollout`` at 4096 and 65,536 envs, kernels
   against the plain versions on the card, at K=1 and K=32 (CUDA events).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero.  A full report goes to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or outside a checkout, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = 'gymnasium_planar_robotics_tpu_torch'
B_MAIN = 4096
B_LARGE = 65536
T_ROLL = 64
K_MAIN = 32
DEVICE = 'cuda:0'

KERNELS = {
    'noise_probe': ('csrc/noise_probe.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:2309'),
    'pushing_cycles': ('csrc/pushing_cycles.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:903'),
    'pushing_autoreset': ('csrc/pushing_autoreset.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1034'),
    'pushing_rollout': ('csrc/pushing_rollout.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1083'),
}


class PhaseError(AssertionError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(got, ref, rtol: float, atol: float):
    """(max |got - ref|, all within atol + rtol * |ref|) over finite tensors."""
    import torch

    require(bool(torch.isfinite(got).all()), 'kernel output is not finite')
    d = (got - ref).abs()
    return float(d.max()), bool((d <= atol + rtol * ref.abs()).all())


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def planted_state(P, config, params, b: int, gen, vel=(0.4, 0.0)):
    """init_batch state with the mover planted at the object's -x face in
    every other env, moving toward it (contact fires in the first cycles)."""
    import torch

    state, _, _ = P.init_batch(config, params, b, gen)
    plant = (torch.arange(b, device=state.pos.device) % 2 == 0)[:, None]
    offset = torch.tensor([-0.115, 0.0], device=state.pos.device)
    state.pos = torch.where(plant, state.obj_pos + offset, state.pos)
    state.vel = torch.where(plant, torch.tensor(vel, device=state.pos.device).expand(b, 2), state.vel)
    return state


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is False)', file=sys.stderr)
        return 2
    if not (ROOT / PKG / 'csrc').is_dir():
        print(f'chip_smoke: run from the root of a checkout ({PKG}/ not found beside this script)', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from gymnasium_planar_robotics_tpu_torch.models import pushing as P
    from gymnasium_planar_robotics_tpu_torch.ops import kernels
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import build, noise
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kp

    dev = torch.device(DEVICE)
    report: dict = {'phases': {}}
    kstats = {name: {} for name in KERNELS}
    failed = []

    def phase(name):
        def wrap(fn):
            t0 = time.perf_counter()
            try:
                res = fn()
                ok = True
            except Exception as exc:  # the phase fails: traceback to stderr, exit code 1 at the end
                traceback.print_exc()
                res = {'error': f'{type(exc).__name__}: {exc}'}
                ok = False
                failed.append(name)
            res = dict(res or {}, ok=ok, seconds=round(time.perf_counter() - t0, 3))
            report['phases'][name] = res
            print(f'[{name}] ' + json.dumps(res), flush=True)
            return res
        return wrap

    # -- 1. card, versions, build ------------------------------------------
    card = card_line()

    @phase('card_build')
    def _():
        t0 = time.perf_counter()
        build.lib()
        # ptxas -v: registers and spills per kernel instantiation
        regs, cur = {}, None
        for ln in build.build_info.get('log', '').splitlines():
            if 'Function properties for' in ln:
                cur = ln.split('Function properties for')[1].strip()
            elif cur and 'spill stores' in ln:
                regs[cur] = ln.strip()
            elif cur and 'Used' in ln and 'registers' in ln:
                regs[cur] = ln.split('Used')[1].split(',')[0].strip() + '; ' + regs.get(cur, '')
                cur = None
        return {
            'card': card, 'torch': torch.__version__, 'cuda': torch.version.cuda,
            'device': torch.cuda.get_device_name(0), 'build_s': round(time.perf_counter() - t0, 3),
            'nvcc_s': round(build.build_info.get('seconds', 0.0), 3), 'ptxas': regs,
        }

    if failed:
        print('chip_smoke: the kernels did not build', file=sys.stderr)
        return 1

    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 2. kernel A ---------------------------------------------------------
    @phase('kernel_A_noise_probe')
    def _():
        draws = 8
        u = torch.rand((2 * draws, B_MAIN), generator=gen, device=dev)
        got = noise.noise_probe_cuda(draws, B_MAIN, dev, uniforms=u)
        ref = noise.noise_probe_plain(u)
        err_inj, ok_inj = compare(got, ref, 2e-6, 2e-6)
        # Philox stream: kernel vs the host copy of its stream, then moments
        n_env = 131072
        got_p = noise.noise_probe_cuda(1, n_env, dev, seed=12345)
        ref_p = noise.noise_probe_plain(noise.philox_uniforms(12345, 2, n_env).to(dev))
        err_ph, ok_ph = compare(got_p, ref_p, 2e-6, 2e-6)
        flat = got_p.reshape(-1).double()
        mean, std = float(flat.mean()), float(flat.std())
        tail = float((flat.abs() > 2.0).double().mean())
        require(ok_inj, f'injected Box-Muller disagrees: {err_inj}')
        require(ok_ph, f'Philox stream disagrees with its host copy: {err_ph}')
        require(abs(mean) < 0.01 and abs(std - 1.0) < 0.01 and abs(tail - 0.0455) < 0.003,
                f'Philox normal moments off: mean {mean} std {std} P(|z|>2) {tail}')
        # time at the main path's shape (observation noise: 3 pairs per env)
        u3 = torch.rand((6, B_MAIN), generator=gen, device=dev)
        ms = time_ms(lambda: noise.noise_probe_cuda(3, B_MAIN, dev, uniforms=u3), 50)
        plain_ms = time_ms(lambda: noise.noise_probe_plain(u3), 50)
        kstats['noise_probe'].update(max_abs_err=max(err_inj, err_ph), ms=ms, plain_ms=plain_ms)
        return {'max_abs_err_injected': err_inj, 'max_abs_err_philox': err_ph, 'tol': 'atol 2e-6 + rtol 2e-6',
                'philox_samples': 2 * n_env, 'mean': mean, 'std': std, 'p_abs_gt_2': tail,
                'ms': ms, 'plain_ms': plain_ms}

    # -- 3. kernels B, C, D ---------------------------------------------------
    config, params = P.make_pushing_env(device=dev)
    kc = kp.make_kernel_consts(config, params, 32)
    # per-plane tolerances, by class: positions, goals and observations at
    # rtol 3e-5, atol 3e-6 (nvcc contracts multiply-adds, PyTorch's
    # elementwise ops do not, and contact amplifies one ulp); object velocity
    # and spin (planes 10, 11, 13) at atol 1e-4 (the Coulomb stick/slip step
    # amplifies ulps); planes downstream of the clamp chain's (v' - v) / dt
    # (acc, act, pre-reset qacc: 4-7, 31, 32) at rtol 1e-4, atol 1e-4
    vel_rows, acc_rows = (10, 11, 13), (4, 5, 6, 7, 31, 32)

    def plane_tol(i):
        return (1e-4, 1e-4) if i in acc_rows else (3e-5, 1e-4) if i in vel_rows else (3e-5, 3e-6)

    def plane_compare(got, ref):
        errs, bad = [], []
        for i in range(got.shape[0]):
            rtol, atol = plane_tol(i)
            e, ok = compare(got[i], ref[i], rtol, atol)
            errs.append(e)
            if not ok:
                bad.append(i)
        return max(errs), bad, errs

    @phase('kernel_B_pushing_cycles')
    def _():
        state = planted_state(P, config, params, B_MAIN, gen)
        act = (torch.rand((2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0
        planes = torch.cat([P.state_to_planes(state)[:16], act]).contiguous()
        u = torch.rand((kp.cycles_noise_planes(kc.num_cycles), B_MAIN), generator=gen, device=dev)
        got = kp.pushing_cycles_cuda(planes, kc, u)
        ref = kp.pushing_cycles_plain(planes, kc, u)
        err, bad, errs = plane_compare(got, ref)
        moved = float((got[8:10] - planes[8:10]).abs().max())
        require(not bad, f'planes {bad} disagree: {[errs[i] for i in bad]}')
        require(moved > 1e-5, 'contact never moved an object')
        ms = time_ms(lambda: kp.pushing_cycles_cuda(planes, kc, u), 20)
        plain_ms = time_ms(lambda: kp.pushing_cycles_plain(planes, kc, u), 3)
        philox_ms = time_ms(lambda: kp.pushing_cycles_cuda(planes, kc, None, 7), 20)
        kstats['pushing_cycles'].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        return {'max_abs_err': err, 'per_plane': errs, 'object_moved': moved,
                'ms': ms, 'plain_ms': plain_ms, 'philox_ms': philox_ms}

    @phase('kernel_C_pushing_autoreset')
    def _():
        state = planted_state(P, config, params, B_MAIN, gen)
        # a spread of step counters so truncation restarts fire in one step
        state.steps = torch.randint(0, config.max_episode_steps, (B_MAIN,), generator=gen, device=dev,
                                    dtype=torch.int32)
        act = (torch.rand((2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0
        st = P.state_to_planes(state)
        u = torch.rand((kp.autoreset_noise_planes(kc.num_cycles, kc.cand_k), B_MAIN), generator=gen, device=dev)
        got = kp.pushing_autoreset_cuda(st, act, kc, u)
        ref = kp.pushing_autoreset_plain(st, act, kc, u)
        err, bad, errs = plane_compare(got, ref)
        restarts = int(((got[18] == 0) & (st[18] > 0)).sum())
        require(not bad, f'planes {bad} disagree: {[errs[i] for i in bad]}')
        require(restarts > 0, 'no restart fired')
        ms = time_ms(lambda: kp.pushing_autoreset_cuda(st, act, kc, u), 20)
        plain_ms = time_ms(lambda: kp.pushing_autoreset_plain(st, act, kc, u), 3)
        philox_ms = time_ms(lambda: kp.pushing_autoreset_cuda(st, act, kc, None, 7), 20)
        kstats['pushing_autoreset'].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        return {'max_abs_err': err, 'per_plane': errs, 'restarts': restarts,
                'ms': ms, 'plain_ms': plain_ms, 'philox_ms': philox_ms}

    @phase('kernel_D_pushing_rollout')
    def _():
        state = planted_state(P, config, params, B_MAIN, gen)
        st = P.state_to_planes(state)
        acts = ((torch.rand((K_MAIN, 2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        n = K_MAIN * kp.autoreset_noise_planes(kc.num_cycles, kc.cand_k)
        u = torch.rand((n, B_MAIN), generator=gen, device=dev)
        got_st, got_sig = kp.pushing_rollout_cuda(st, acts, kc, u)
        ref_st, ref_sig = kp.pushing_rollout_plain(st, acts, kc, u)
        # over K steps of chaotic contact, ulp differences can grow and flip a
        # wall check; count the envs whose whole trajectory agrees
        # (the per-step plane tolerances, x10 for the K steps)
        d_state = (got_st - ref_st).abs()
        rtol = torch.tensor([plane_tol(i)[0] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        atol = torch.tensor([plane_tol(i)[1] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        env_ok = ((d_state <= atol + rtol * ref_st.abs()).all(0) & (got_sig == ref_sig).all(0).all(0))
        frac = float(env_ok.double().mean())
        err = float(d_state.max())
        err_ok = float(d_state[:, env_ok].max()) if env_ok.any() else float('inf')
        require(bool(torch.isfinite(got_st).all()), 'kernel D state is not finite')
        require(frac >= 0.99, f'only {frac:.4f} of envs agree over {K_MAIN} steps')
        ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kc, u), 5)
        plain_ms = time_ms(lambda: kp.pushing_rollout_plain(st, acts, kc, u), 1)
        philox_ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kc, None, 7), 5)
        kstats['pushing_rollout'].update(max_abs_err=err_ok, ms=ms, plain_ms=plain_ms)
        return {'K': K_MAIN, 'envs_agreeing': frac, 'max_abs_err_agreeing_envs': err_ok,
                'max_abs_err_all_envs': err, 'restarts_kernel': int((got_sig[2] > 0.5).sum() + (got_sig[0] > 0.5).sum()),
                'ms': ms, 'plain_ms': plain_ms, 'philox_ms': philox_ms}

    # -- 4. the public serving path --------------------------------------------
    @phase('main_path')
    def _():
        cfg, prm = P.make_pushing_env(device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        kernels.reset_launches()
        state, obs, info = P.init_batch(cfg, prm, B_MAIN, g)
        step = P.make_fused_step(cfg, prm)
        s = state
        for _ in range(3):
            s, o, r, te, tr, inf = step(s, torch.full((B_MAIN, 2), 3.0, device=dev), generator=g)
        step_ar = P.make_fused_step_autoreset(cfg, prm)
        s = state
        rewards = []
        for _ in range(5):
            a = (torch.rand((B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
            s, o, r, te, tr, inf = step_ar(s, a, generator=g)
            rewards.append(r)
        acts = (torch.rand((T_ROLL, B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
        outs = {}
        for K in (1, K_MAIN):
            roll = P.make_fused_rollout(cfg, prm, steps_per_launch=K)
            outs[K] = roll(s, acts, 100 + K)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)

        require(all(v > 0 for v in launches.values()), f'a kernel of the path never launched: {launches}')
        checks = {}
        for K, (fs, rew, term, trunc) in outs.items():
            for name in ('pos', 'vel', 'obj_pos', 'obj_vel', 'goal', 'mover_z', 'obj_yaw'):
                require(bool(torch.isfinite(getattr(fs, name)).all()), f'K={K}: {name} not finite')
            require(set(torch.unique(rew).tolist()) <= {0.0, -1.0, -50.0}, f'K={K}: rewards {torch.unique(rew)}')
            speed = torch.linalg.vector_norm(fs.vel, dim=-1)
            require(float(speed.max()) <= float(prm.v_max) * 1.01, f'K={K}: |v| {float(speed.max())}')
            require(bool(((fs.pos > -0.1) & (fs.pos < 0.82)).all()), f'K={K}: mover off the table')
            require(bool(((fs.goal >= prm.obj_min_xy) & (fs.goal <= prm.obj_max_xy)).all()), f'K={K}: goal')
            require(bool((fs.mover_z >= 0).all()), f'K={K}: mover z < 0')
            require(bool(((fs.steps >= 0) & (fs.steps <= cfg.max_episode_steps)).all()), f'K={K}: steps')
            require(bool((term | trunc).any()), f'K={K}: no episode ended in {T_ROLL} steps')
            checks[K] = {'terminations': int(term.sum()), 'truncations': int(trunc.sum()),
                         'reward_mean': float(rew.mean()), 'success_rate_step': float((rew == 0).double().mean())}
        require(set(torch.cat(rewards).unique().tolist()) <= {0.0, -1.0, -50.0}, 'per-step rewards')

        # K=32 against K=1 at std_noise=0 on envs that never restart
        cfg0, prm0 = P.make_pushing_env(std_noise=0.0, device=dev)
        s0 = planted_state(P, cfg0, prm0, B_MAIN, g, vel=(0.05, 0.0))
        # 40 steps (one chunk of 32 + a tail of 8) of an oscillating push that
        # keeps the mover on the table (amplitude ~5 cm)
        T0 = 40
        ph = 2 * torch.pi * torch.arange(T0, device=dev) / 20
        a0 = torch.stack([3.0 * torch.cos(ph), 0.5 * torch.sin(ph)], -1)[:, None].expand(T0, B_MAIN, 2)
        r1 = P.make_fused_rollout(cfg0, prm0, steps_per_launch=1)(s0, a0, 5)
        r32 = P.make_fused_rollout(cfg0, prm0, steps_per_launch=K_MAIN)(s0, a0, 5)
        live = ~(r1[2].any(0) | r1[3].any(0) | r32[2].any(0) | r32[3].any(0))
        require(int(live.sum()) > B_MAIN // 2, f'too many restarts: {int(live.sum())} live')
        errs = {}
        for name in ('pos', 'vel', 'obj_pos', 'mover_z'):
            a, b = getattr(r32[0], name)[live], getattr(r1[0], name)[live]
            e, ok = compare(a, b, 3e-5, 3e-6)
            errs[name] = e
            require(ok, f'K={K_MAIN} vs K=1 {name}: {e}')
        contact = float((r1[0].obj_pos - s0.obj_pos)[live].abs().max())
        require(contact > 1e-5, 'contact never moved an object in the K comparison')
        return {'launches': launches, 'rollouts': checks, 'k32_vs_k1_live_envs': int(live.sum()),
                'k32_vs_k1_max_abs_err': errs, 'tol': 'rtol 3e-5 atol 3e-6'}

    main_launches = report['phases']['main_path'].get('launches', {})

    # -- 5. rollout rate ----------------------------------------------------
    @phase('rollout_rate')
    def _():
        rates = {}
        for b in (B_MAIN, B_LARGE):
            cfg, prm = P.make_pushing_env(device=dev)
            g = torch.Generator(device=dev).manual_seed(2)
            state, _, _ = P.init_batch(cfg, prm, b, g)
            acts = (torch.rand((T_ROLL, b, 2), generator=g, device=dev) * 2 - 1) * 10.0
            kcb = kp.make_kernel_consts(cfg, prm, 32)
            n_step = kp.autoreset_noise_planes(cfg.num_cycles, 32)

            def plain_step(planes, action, seed, n_step=n_step, kcb=kcb, b=b):
                return kp.pushing_autoreset_plain(planes, action, kcb, torch.rand((n_step, b), device=dev))

            def plain_chunk(planes, actions, seed, n_step=n_step, kcb=kcb, b=b):
                u = torch.rand((actions.shape[0] * n_step, b), device=dev)
                return kp.pushing_rollout_plain(planes, actions, kcb, u)

            for K in (1, K_MAIN):
                kern = P.make_fused_rollout(cfg, prm, steps_per_launch=K)
                plain = P._make_rollout(cfg, prm, K, plain_step, plain_chunk)
                t_k = time_ms(lambda kern=kern: kern(state, acts, 3), 3)
                t_p = time_ms(lambda plain=plain: plain(state, acts, 3), 1)
                rates[f'B={b},K={K}'] = {
                    'kernel_ms': t_k, 'plain_ms': t_p,
                    'kernel_env_steps_per_s': b * T_ROLL / (t_k / 1e3),
                    'plain_env_steps_per_s': b * T_ROLL / (t_p / 1e3),
                }
        return {'T': T_ROLL, 'card': card, 'rates': rates}

    report['card'] = card
    kernel_rows = []
    for name, (src, replaces) in KERNELS.items():
        st = kstats[name]
        kernel_rows.append({
            'name': name, 'route': 'cuda', 'source': f'{PKG}/{src}', 'replaces': replaces,
            'launches': int(main_launches.get(name, 0)), 'max_abs_err': st.get('max_abs_err'),
            'ms': st.get('ms'), 'plain_ms': st.get('plain_ms'),
        })
    report['kernels'] = kernel_rows
    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    (out_dir / 'chip_smoke.json').write_text(json.dumps(report, indent=1))

    if failed:
        print(f'chip_smoke: failed phases: {failed}', file=sys.stderr)
        return 1
    print(f'card: {card}')
    print(json.dumps({'kernels': kernel_rows}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
