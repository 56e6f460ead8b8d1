"""Shared cases of the M-mover planning tests (kernel H): configurations and
planted states with wall hits, head-on mover pairs and truncation restarts.

Imports numpy and torch only: the GPU test file uses it on a machine
without JAX.
"""

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan

FULL3, FULL4, FULL6, FULL8 = np.ones((3, 3)), np.ones((4, 4)), np.ones((6, 6)), np.ones((8, 8))
HOLED3 = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
NOTCH = np.array([[1, 1, 1], [1, 1, 0]])  # one missing-corner site, six cells
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
HOLED8 = np.ones((8, 8))
HOLED8[7, 6] = HOLED8[0, 7] = 0  # two missing tiles away from the slots


def grid_slots(nx: int, ny: int, start: float, step: float) -> list:
    """``nx * ny`` mover slots on a square grid, x-major."""
    return [(start + step * i, start + step * j) for i in range(nx) for j in range(ny)]


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
    # more movers than a thread-per-env kernel was instantiated for: 3 x 3
    # slots on the 6x6 table, 4 x 3 on the 8x8 (mover 1's head-on partner
    # lands near mover 3, so a planted pair may hit two movers at once)
    'circle_full_acc_m9': (FULL6, 9, {'size': np.array([0.11, 0.12, 0.1, 0.11, 0.13, 0.11, 0.1, 0.12, 0.11])},
                           False, grid_slots(3, 3, 0.3, 0.42), None),
    'box_full_jerk_m9': (FULL6, 9, BOX, True, grid_slots(3, 3, 0.3, 0.42), [1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 1.0, 1.0,
                                                                           0.95]),
    'circle_holed_acc_m12': (HOLED8, 12, {}, False, grid_slots(4, 3, 0.3, 0.42), None),
}


def ladder_case(m: int, box: bool, holed: bool) -> tuple:
    """A case in ``CASES``' form for any M: ceil(sqrt(M)) slots a row 0.42 m
    apart on the smallest square table that holds them with 0.3 m margins,
    without its far corner tile when ``holed`` (away from the slots); acc."""
    nx = int(np.ceil(np.sqrt(m)))
    slots = grid_slots(nx, nx, 0.3, 0.42)[:m]
    n = int(np.ceil((0.6 + 0.42 * (nx - 1)) / 0.24))
    layout = np.ones((n, n))
    if holed:
        layout[n - 1, n - 1] = 0
    return layout, m, dict(BOX) if box else {}, False, slots, None


#: ladder cases by name, ``ladder_m<M>_<circle|box>_<full|holed>``; 65
#: movers take kernel H's L = 4 slots, 88 and more its many-mover variant
LADDER = {f'ladder_m{m}_{"box" if box else "circle"}_{"holed" if holed else "full"}': ladder_case(m, box, holed)
          for m in (2, 3, 4, 5, 8, 9, 12, 17, 33, 48, 64, 65, 88, 96, 128, 129, 192, 256) for box in (False, True)
          for holed in (False, True)}


def case(name: str) -> tuple:
    return CASES[name] if name in CASES else LADDER[name]


def make_env(name, device='cpu', **kw):
    """The port's (config, params) of case ``name``; ``kw`` go to
    ``make_planning_env``."""
    layout, m, coll, jerk, _, scale = case(name)
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
    m, slots = cfg.num_movers, np.asarray(case(name)[4])
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


def plant_accepted_sets(u: np.ndarray, name: str, cfg, prm, cand_k: int, envs, k: int = 1) -> None:
    """Write into the uniforms ``u`` [planes, B] of a kernel H step the draws
    of start set k and goal set k of ``envs`` so that both sets land on the
    case's slots (wall-valid and apart): those envs, when done, accept set k
    after k rejected sets (at many movers random sets are rarely accepted)."""
    m, box = cfg.num_movers, cfg.collision_shape == 'box'
    lo, hi = (x.cpu().numpy().astype(np.float64) for x in (prm.min_xy, prm.max_xy))
    uv = ((np.asarray(case(name)[4], np.float64) - lo) / (hi - lo)).astype(np.float32).reshape(-1)
    starts = (2 + 4 * (3 if box else 1)) * m * cfg.num_cycles + 4 * m
    for base in (starts, starts + 2 * m * cand_k):
        rows = base + 2 * m * k + np.arange(2 * m)
        u[rows[:, None], np.asarray(envs)[None, :]] = uv[:, None]


def actions(cfg, b: int, seed: int) -> np.ndarray:
    """Random actions ``[B, M, 2]`` within the actuation limit."""
    lim = 80.0 if cfg.learn_jerk else 8.0
    return np.random.default_rng(seed).uniform(-lim, lim, (b, cfg.num_movers, 2)).astype(np.float32)
