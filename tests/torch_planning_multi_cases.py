"""Shared cases of the M-mover planning tests (kernel H): configurations and
planted states with wall hits, head-on mover pairs and truncation restarts.

Imports numpy and torch only: the GPU test file uses it on a machine
without JAX.
"""

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan

FULL3, FULL4 = np.ones((3, 3)), np.ones((4, 4))
HOLED3 = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
NOTCH = np.array([[1, 1, 1], [1, 1, 0]])  # one missing-corner site, six cells
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}

#: name -> (layout, movers, collision params, jerk, mover slots [M, 2], accel_scale)
CASES = {
    'circle_full_acc_m3': (FULL4, 3, {'size': np.array([0.11, 0.14, 0.12])}, False,
                           [(0.3, 0.3), (0.3, 0.7), (0.75, 0.7)], None),
    'circle_holed_jerk_m2': (HOLED3, 2, {'size': np.array([0.11, 0.13])}, True, [(0.2, 0.2), (0.55, 0.25)], None),
    'box_full_jerk_m2': (FULL3, 2, {'shape': 'box', 'size': np.array([[0.09, 0.08], [0.08, 0.09]])}, True,
                         [(0.2, 0.2), (0.5, 0.5)], None),
    'box_notch_acc_m2': (NOTCH, 2, BOX, False, [(0.15, 0.2), (0.35, 0.5)], None),
    'circle_full_scaled_m2': (FULL3, 2, {}, False, [(0.2, 0.2), (0.5, 0.5)], [1.0, 0.8125]),
    # the main configuration (the JAX package's multi-agent bench, bench.py:401)
    'circle_full_acc_m4': (FULL4, 4, {}, False, [(0.2, 0.2), (0.2, 0.7), (0.7, 0.2), (0.7, 0.7)], None),
}


def make_env(name, device='cpu', **kw):
    """The port's (config, params) of case ``name``; ``kw`` go to
    ``make_planning_env``."""
    layout, m, coll, jerk, _, scale = CASES[name]
    cfg, prm = tplan.make_planning_env(layout, m, collision_params=coll, learn_jerk=jerk, device=device, **kw)
    if scale is not None:
        prm = dataclasses.replace(prm, accel_scale=torch.tensor(scale, dtype=torch.float32, device=device))
    return cfg, prm


def half_x(prm) -> np.ndarray:
    """Each mover's collision size along x (radius or half-extent)."""
    c = prm.c_size.cpu().numpy()
    return c.reshape(c.shape[0], -1)[:, 0]


def planted_state(name, cfg, prm, b: int, seed: int = 0) -> tplan.PlanningState:
    """Movers at the case's slots (jittered by up to 5 mm); envs [0, b/4):
    mover 0 at the -x wall (x from r - 1 cm to r + 2 cm) moving out at
    1 m/s; envs [b/4, b/2): movers 0 and 1 side by side 1 mm apart, head-on
    at 1 m/s each; velocities, accelerations and goals random; step counters
    spread, every 8th about to truncate."""
    m, slots = cfg.num_movers, np.asarray(CASES[name][4])
    device = prm.min_xy.device
    rng = np.random.default_rng(seed)
    q = b // 4
    pos = slots[None] + rng.uniform(-0.005, 0.005, (b, m, 2))
    vel = rng.uniform(-0.3, 0.3, (b, m, 2))
    hx = half_x(prm)
    pos[:q, 0, 0] = np.linspace(hx[0] - 0.01, hx[0] + 0.02, q)
    vel[:q, 0] = [-1.0, 0.1]
    pos[q:2 * q, 1] = pos[q:2 * q, 0] + [hx[0] + hx[1] + 1e-3, 0.0]
    vel[q:2 * q, 0], vel[q:2 * q, 1] = [1.0, 0.0], [-1.0, 0.0]
    acc = rng.uniform(-5.0, 5.0, (b, m, 2))
    lo, hi = prm.min_xy.cpu().numpy(), prm.max_xy.cpu().numpy()
    goals = rng.uniform(lo, hi, (b, m, 2))
    steps = rng.integers(0, cfg.max_episode_steps - 5, b)
    steps[::8] = cfg.max_episode_steps - 1

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return tplan.PlanningState(pos=t(pos), vel=t(vel), acc=t(acc), act=t(acc), goals=t(goals),
                               steps=t(steps, torch.int32))


def actions(cfg, b: int, seed: int) -> np.ndarray:
    """Random actions ``[B, M, 2]`` within the actuation limit."""
    lim = 80.0 if cfg.learn_jerk else 8.0
    return np.random.default_rng(seed).uniform(-lim, lim, (b, cfg.num_movers, 2)).astype(np.float32)
