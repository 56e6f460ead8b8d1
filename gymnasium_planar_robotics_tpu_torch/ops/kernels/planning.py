"""Single-mover planning kernels E, F and G: wrappers, plain PyTorch
versions, constants.

Counterpart of ``gymnasium_planar_robotics_tpu/ops/pallas_step.py``:

- kernel E, ``planning_cycles``: ``_step_kernel`` (one env step of
  ``num_cycles`` control cycles, no restart);
- kernel F, ``planning_autoreset``: ``_planning_autoreset_kernel`` /
  ``_planning_autoreset_step`` (cycles, observations, termination, in-kernel
  start and goal resampling);
- kernel G, ``planning_rollout``: ``_planning_rollout_kernel`` (K autoreset
  steps in one launch).

State travels as f32 planes ``[planes, B]``: pos x/y, vel x/y, act x/y (the
control-space acceleration: the integrator activation in jerk mode, the
applied command in acc mode), then goal x/y and the step counter for the
9-plane autoreset state.  The plain versions do the kernels' arithmetic with
the same operand order, one rounding per operation, in the same draw order
over a given uniform tensor; on the card they agree with the kernels bit
for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import build, to_numpy, walls
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import clamp_chain, scalar, sqrt
from gymnasium_planar_robotics_tpu_torch.ops.kernels.noise import UniformStream

#: field order of ``gprt::PlanningConsts`` in ``csrc/planning.cuh``
PLANNING_FIELDS = (
    'v_max', 'a_max', 'dt', 'std_pos', 'std_vel', 'accel_scale', 'wall_x', 'wall_y', 'sample_x', 'sample_y',
    'x0', 'x1', 'y0', 'y1', 'has_fast', 'fx0', 'fx1', 'fy0', 'fy1', 'threshold', 'max_episode_steps',
    'min_x', 'min_y', 'span_x', 'span_y',
)

N_CYCLES_IN, N_CYCLES_OUT = 8, 7  # 6 mover planes + action x/y; 6 mover planes + wall
N_STATE = 9  # pos, vel, act x/y, goal x/y, steps
N_AUTORESET_OUT = 23  # 9 state + post-reset obs 4 + pre-reset obs 6 + wall, reached, stalled, trials


def cycles_noise_planes(num_cycles: int, box: bool = False) -> int:
    """Uniforms one step of cycles draws (``pallas_step._step_noise_planes``):
    a velocity pair and the wall-check pairs (1 circle, 3 box) per cycle."""
    return (2 + 2 * (3 if box else 1)) * num_cycles


def autoreset_noise_planes(num_cycles: int, cand_k: int, box: bool = False) -> int:
    """cycles + pre-obs (2 pairs) + start and goal sampling (cand_k x/y
    each) + post-obs (2 pairs)."""
    return cycles_noise_planes(num_cycles, box) + 8 + 4 * cand_k


# ---------------------------------------------------------------------------
# constants (host side, float64 as the Pallas kernels form them)
# ---------------------------------------------------------------------------


def supports(config, params) -> bool:
    """Whether the fused single-mover kernels cover this configuration
    (``pallas_step.supports``): 1 mover, circle or box shape, f32."""
    return (config.num_movers == 1 and config.collision_shape in ('circle', 'box')
            and to_numpy(params.v_max).dtype == np.float32)


@dataclasses.dataclass(frozen=True)
class KernelConsts:
    """Everything a planning kernel launch needs besides its tensors.

    ``f`` maps each ``PLANNING_FIELDS`` name to its f32 value (as a Python
    float); ``vector`` is the same in field order, the bytes of
    ``gprt::PlanningConsts``; ``rule`` is the layout's wall rule, whose
    ``table`` the kernels read from device memory on holed layouts."""

    f: dict
    vector: np.ndarray
    rule: walls.WallRule
    box: bool
    num_cycles: int
    cand_k: int
    learn_jerk: bool
    _tables: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def wall_size(self) -> tuple:
        return self.f['wall_x'], self.f['wall_y']

    @property
    def sample_size(self) -> tuple:
        return self.f['sample_x'], self.f['sample_y']

    def table_on(self, device: torch.device):
        """The wall table on ``device`` (None on full layouts), made once."""
        if self.rule.full:
            return None
        if device not in self._tables:
            self._tables[device] = torch.from_numpy(self.rule.table).to(device)
        return self._tables[device]


def make_kernel_consts(config, params, cand_k: int = 16) -> KernelConsts:
    """The constants ``make_fused_planning_cycles`` and
    ``make_fused_planning_autoreset_cycles`` bind into the Pallas kernels,
    each rounded once to f32."""
    if config.num_movers != 1:
        raise NotImplementedError(
            'kernels E-G cover 1 mover, and the JAX package has no M-mover make_fused_step either '
            '(pallas_step.supports): M movers step through make_fused_step_autoreset and make_fused_rollout (kernel H)')
    if not supports(config, params):
        raise NotImplementedError('the fused planning kernels run in f32; f64 params step through the eager step')
    return shared_consts(config, params, cand_k)


def shared_consts(config, params, cand_k: int = 16) -> KernelConsts:
    """``make_kernel_consts`` without its checks: the fields kernels E-H
    share (the size and ``accel_scale`` fields are the first mover's)."""
    box = config.collision_shape == 'box'
    wall_size, sample_size = walls.wall_sizes(config, params)
    wall_x, wall_y = wall_size if box else (wall_size,) * 2
    sample_x, sample_y = sample_size if box else (sample_size,) * 2
    std = to_numpy(params.std_noise)
    min_x, min_y = (float(x) for x in to_numpy(params.min_xy))
    max_x, max_y = (float(x) for x in to_numpy(params.max_xy))
    rule = walls.make_wall_rule(walls.grid_np(params))
    rect = rule.rect or dict.fromkeys(('x0', 'x1', 'y0', 'y1', 'has_fast', 'fx0', 'fx1', 'fy0', 'fy1'), 0.0)
    v = dict(
        v_max=float(to_numpy(params.v_max)), a_max=float(to_numpy(params.a_max)), dt=float(to_numpy(params.dt)),
        std_pos=float(std[0]), std_vel=float(std[1]), accel_scale=float(to_numpy(params.accel_scale).reshape(-1)[0]),
        wall_x=wall_x, wall_y=wall_y, sample_x=sample_x, sample_y=sample_y, **rect,
        threshold=float(to_numpy(params.threshold_pos)), max_episode_steps=float(config.max_episode_steps),
        min_x=min_x, min_y=min_y,
        # the spans the Pallas kernel forms in Python float64 before rounding
        span_x=max_x - min_x, span_y=max_y - min_y,
    )
    vector = np.array([v[k] for k in PLANNING_FIELDS], dtype=np.float32)
    f = {k: float(x) for k, x in zip(PLANNING_FIELDS, vector)}
    return KernelConsts(f=f, vector=vector, rule=rule, box=box, num_cycles=config.num_cycles, cand_k=cand_k,
                        learn_jerk=bool(config.learn_jerk))


# ---------------------------------------------------------------------------
# plain versions (same arithmetic, same draw order)
# ---------------------------------------------------------------------------


def _cycles_plain(kc: KernelConsts, noise: UniformStream, mover, ux, uy):
    """The cycle loop of ``_step_kernel``: 6 mover planes in, 6 out + wall."""
    f = kc.f
    px, py, vx, vy, ax, ay = mover
    dt, scale = f['dt'], f['accel_scale']
    dt_t = scalar(dt, px)
    done_f = torch.zeros_like(px)
    wall_f = torch.zeros_like(px)
    for _ in range(kc.num_cycles):
        done = done_f > 0.0
        nvx, nvy = noise.normal_pair()
        vmx = vx + nvx * f['std_vel']
        vmy = vy + nvy * f['std_vel']
        nax, nay = clamp_chain(kc.learn_jerk, f['v_max'], f['a_max'], dt, dt_t, vmx, vmy, ux, uy,
                               scale * ax, scale * ay, ax, ay)
        nvx_t = vx + dt * (scale * nax)
        nvy_t = vy + dt * (scale * nay)
        npx = px + dt * nvx_t
        npy = py + dt * nvy_t
        ok = walls.wall_check(kc.rule, kc.box, noise, npx, npy, f['std_pos'], kc.wall_size)
        px = torch.where(done, px, npx)
        py = torch.where(done, py, npy)
        vx = torch.where(done, vx, nvx_t)
        vy = torch.where(done, vy, nvy_t)
        ax = torch.where(done, ax, nax)
        ay = torch.where(done, ay, nay)
        wall_f = torch.where(done, wall_f, torch.where(ok, 0.0, 1.0))
        done_f = torch.maximum(done_f, wall_f)
    return [px, py, vx, vy, ax, ay], wall_f


def _sample_valid_plain(kc: KernelConsts, noise: UniformStream):
    """First accepted of cand_k wall-valid uniform draws over the sampling box."""
    f = kc.f

    def draw():
        return noise.uniform_in(f['min_x'], f['span_x']), noise.uniform_in(f['min_y'], f['span_y'])

    def valid(x, y):
        return walls.sample_valid_at(kc.rule, kc.box, x, y, kc.sample_size)

    sx, sy = draw()
    found = torch.where(valid(sx, sy), 1.0, 0.0)
    trials = torch.ones_like(sx)
    for _ in range(kc.cand_k - 1):
        cx, cy = draw()
        ok = valid(cx, cy)
        take = ok & (found == 0.0)
        trials = trials + (1.0 - found)
        sx = torch.where(take, cx, sx)
        sy = torch.where(take, cy, sy)
        found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
    return sx, sy, found, trials


def _autoreset_step_plain(kc: KernelConsts, noise: UniformStream, st, ux, uy):
    """``_planning_autoreset_step``: 9 state planes in; returns the 9 new
    state planes and the 15 aux planes (s_vx, s_vy, s_agx, s_agy, f_vx, f_vy,
    f_agx, f_agy, f_ax, f_ay, wall, reached, trunc, stalled, trials)."""
    f = kc.f
    gx, gy, steps = st[6:9]
    (px, py, vx, vy, ax, ay), wall_f = _cycles_plain(kc, noise, st[:6], ux, uy)
    f_ax, f_ay = ax, ay

    n1, n2 = noise.normal_pair()
    n3, n4 = noise.normal_pair()
    f_agx = px + n1 * f['std_pos']
    f_agy = py + n2 * f['std_pos']
    f_vx = vx + n3 * f['std_vel']
    f_vy = vy + n4 * f['std_vel']
    ddx, ddy = f_agx - gx, f_agy - gy
    reached = sqrt(ddx * ddx + ddy * ddy) <= f['threshold']
    term = (wall_f > 0.0) | reached
    new_steps = steps + 1.0
    trunc = new_steps >= f['max_episode_steps']
    done = term | trunc

    rsx, rsy, s_found, s_trials = _sample_valid_plain(kc, noise)
    rgx, rgy, g_found, g_trials = _sample_valid_plain(kc, noise)
    # a stalled draw does not restart the env: state and counter carry over
    found = (s_found > 0.0) & (g_found > 0.0)
    stalled_f = torch.where(done & ~found, 1.0, 0.0)
    do_reset = done & found

    px = torch.where(do_reset, rsx, px)
    py = torch.where(do_reset, rsy, py)
    vx, vy, ax, ay = (torch.where(do_reset, 0.0, x) for x in (vx, vy, ax, ay))
    gx = torch.where(do_reset, rgx, gx)
    gy = torch.where(do_reset, rgy, gy)
    steps = torch.where(do_reset, 0.0, new_steps)

    m1, m2 = noise.normal_pair()
    m3, m4 = noise.normal_pair()
    s_agx = torch.where(do_reset, px + m1 * f['std_pos'], f_agx)
    s_agy = torch.where(do_reset, py + m2 * f['std_pos'], f_agy)
    s_vx = torch.where(do_reset, vx + m3 * f['std_vel'], f_vx)
    s_vy = torch.where(do_reset, vy + m4 * f['std_vel'], f_vy)

    aux = [s_vx, s_vy, s_agx, s_agy, f_vx, f_vy, f_agx, f_agy, f_ax, f_ay,
           wall_f, torch.where(reached, 1.0, 0.0), torch.where(trunc, 1.0, 0.0),
           stalled_f, torch.where(done, s_trials + g_trials, 0.0)]
    return [px, py, vx, vy, ax, ay, gx, gy, steps], aux


def planning_cycles_plain(planes: torch.Tensor, kc: KernelConsts, uniforms: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel E: ``[8, B]`` (6 mover planes + action x/y)
    -> ``[7, B]`` (6 mover planes + wall) over ``[cycles_noise_planes, B]``
    uniforms."""
    noise = UniformStream(uniforms)
    mover, wall = _cycles_plain(kc, noise, list(planes[:6]), planes[6], planes[7])
    noise.finalize()
    return torch.stack(mover + [wall])


def planning_autoreset_plain(state: torch.Tensor, action: torch.Tensor, kc: KernelConsts,
                             uniforms: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F: ``[9, B]`` state + ``[2, B]`` action -> the
    23 output planes ``[23, B]`` (the Pallas ``raw_planes`` order: 9 state,
    post-reset obs, pre-reset obs, wall, reached, stalled, trials)."""
    noise = UniformStream(uniforms)
    new_st, aux = _autoreset_step_plain(kc, noise, list(state), action[0], action[1])
    noise.finalize()
    return torch.stack(new_st + aux[:12] + aux[13:])


def planning_rollout_plain(state: torch.Tensor, actions: torch.Tensor, kc: KernelConsts,
                           uniforms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel G: ``[9, B]`` state + ``[K, 2, B]`` actions ->
    (final ``[9, B]`` state, ``[3, K, B]`` wall/reached/trunc) over
    ``[K * autoreset_noise_planes, B]`` uniforms."""
    noise = UniformStream(uniforms)
    st = list(state)
    signals = []
    for t in range(actions.shape[0]):
        st, aux = _autoreset_step_plain(kc, noise, st, actions[t, 0], actions[t, 1])
        signals.append(torch.stack(aux[10:13]))
    noise.finalize()
    return torch.stack(st), torch.stack(signals, dim=1)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def launch_args(kc: KernelConsts, device):
    names = build.lib().planning_const_names
    if names != PLANNING_FIELDS:
        raise RuntimeError(f'gprt::PlanningConsts field order differs from PLANNING_FIELDS: {names}')
    table = kc.table_on(device)
    return (kc.vector.ctypes.data, table.data_ptr() if table is not None else None, kc.rule.n_cells,
            int(kc.box), int(kc.rule.full), int(kc.learn_jerk), kc.num_cycles)


def planning_cycles_cuda(planes, kc: KernelConsts, uniforms=None, seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Kernel E on the card."""
    b = planes.shape[1]
    kernels.check_plane(planes, 'planes', (N_CYCLES_IN, b))
    noise_ptr = kernels.noise_ptr(uniforms, cycles_noise_planes(kc.num_cycles, kc.box), b, planes.device)
    out = torch.empty((N_CYCLES_OUT, b), dtype=torch.float32, device=planes.device)
    with torch.cuda.device(planes.device):
        err = build.lib().gprt_planning_cycles(
            planes.data_ptr(), noise_ptr, out.data_ptr(), b, *launch_args(kc, planes.device),
            *kernels.seed_args(seed, planes.device), kernels.stream_ptr(out),
        )
    build.check(err, 'planning_cycles')
    kernels.LAUNCHES['planning_cycles'] += 1
    return out


def planning_autoreset_cuda(state, action, kc: KernelConsts, uniforms=None,
                            seed: int | torch.Tensor = 0) -> torch.Tensor:
    """Kernel F on the card."""
    b = state.shape[1]
    kernels.check_plane(state, 'state', (N_STATE, b))
    kernels.check_plane(action, 'action', (2, b))
    noise_ptr = kernels.noise_ptr(uniforms, autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box), b, state.device)
    out = torch.empty((N_AUTORESET_OUT, b), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        err = build.lib().gprt_planning_autoreset(
            state.data_ptr(), action.data_ptr(), noise_ptr, out.data_ptr(), b, *launch_args(kc, state.device),
            kc.cand_k, *kernels.seed_args(seed, state.device), kernels.stream_ptr(out),
        )
    build.check(err, 'planning_autoreset')
    kernels.LAUNCHES['planning_autoreset'] += 1
    return out


def planning_rollout_cuda(state, actions, kc: KernelConsts, uniforms=None, seed: int | torch.Tensor = 0):
    """Kernel G on the card."""
    b = state.shape[1]
    k = actions.shape[0]
    kernels.check_plane(state, 'state', (N_STATE, b))
    kernels.check_plane(actions, 'actions', (k, 2, b))
    n = k * autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    noise_ptr = kernels.noise_ptr(uniforms, n, b, state.device)
    st_out = torch.empty((N_STATE, b), dtype=torch.float32, device=state.device)
    step_out = torch.empty((3, k, b), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        err = build.lib().gprt_planning_rollout(
            state.data_ptr(), actions.data_ptr(), noise_ptr, st_out.data_ptr(), step_out.data_ptr(), b, k,
            *launch_args(kc, state.device), kc.cand_k, *kernels.seed_args(seed, state.device),
            kernels.stream_ptr(st_out),
        )
    build.check(err, 'planning_rollout')
    kernels.LAUNCHES['planning_rollout'] += 1
    return st_out, step_out


# ---------------------------------------------------------------------------
# dispatch: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------


def planning_cycles(planes, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None):
    """Kernel E, or its plain version on CPU tensors (``kernels.dispatch``)."""
    return kernels.dispatch((planes,), cycles_noise_planes(kc.num_cycles, kc.box), uniforms, seed, generator,
                            lambda u: planning_cycles_plain(planes, kc, u),
                            lambda u, s: planning_cycles_cuda(planes, kc, u, s))


def planning_autoreset(state, action, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None):
    """Kernel F, or its plain version on CPU tensors."""
    n = autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    return kernels.dispatch((state, action), n, uniforms, seed, generator,
                            lambda u: planning_autoreset_plain(state, action, kc, u),
                            lambda u, s: planning_autoreset_cuda(state, action, kc, u, s))


def planning_rollout(state, actions, kc: KernelConsts, *, uniforms=None, seed: int | None = None, generator=None):
    """Kernel G, or its plain version on CPU tensors."""
    n = actions.shape[0] * autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    return kernels.dispatch((state, actions), n, uniforms, seed, generator,
                            lambda u: planning_rollout_plain(state, actions, kc, u),
                            lambda u, s: planning_rollout_cuda(state, actions, kc, u, s))
