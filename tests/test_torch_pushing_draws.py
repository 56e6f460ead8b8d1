"""The split of pushing's autoreset step into its state-independent draws
and the physics that consumes them (kernels C and D's producer/consumer
design and its plain mirror, ``ops/kernels/pushing.py``).

- The split plain step (``step_draws_plain`` then
  ``autoreset_physics_plain``) equals the interleaved step it replaced --
  each cycle drawing as it runs, then the observation, restart and
  observation draws -- bit for bit, on injected uniforms and on the host
  copy of the Philox stream, for the circle and the box, acc and jerk,
  ``cand_k`` 32 and 7 (a step then draws a count that is not a multiple of
  4), over K = 1 and 3 steps.
- The draws equal what the producer warps compute by absolute index: draw
  d of step t is uniform plane t * n_step + d, the restart's first accepted
  candidate is searched after the first candidate.
- The restart reads no state, and its ``trials`` is 1 + j for the first
  accepted candidate j, else ``cand_k``.
- Kernel B's ring (a step of cycle stages and no step stage): stage k holds
  cycles k * per .. (k + 1) * per - 1, the last stage partial, each value
  taken by absolute index; in stage order the values are
  ``cycle_draws_plain``'s, and the cycles run on them are kernel B's plain
  version, bit for bit.
- The kernels' block shape (with the producer warp or without) by batch
  width: B, C and D each up to its own wide batch.
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

B = 24
NUM_CYCLES = 6
BOX = {'shape': 'box', 'size': [0.09, 0.09]}
STAGE_VALUES = 24  # values of one ring stage for each env (kStageValues, csrc/split.cuh)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make(box: bool, jerk: bool, cand_k: int, num_cycles: int = NUM_CYCLES):
    cfg, prm = tpush.make_pushing_env(num_cycles=num_cycles, learn_jerk=jerk, device='cpu',
                                      **({'collision_params': BOX} if box else {}))
    return cfg, prm, kpush.make_kernel_consts(cfg, prm, cand_k)


def busy_state(cfg, prm, seed: int):
    """init_batch with half the envs planted at the object, a quarter at
    the -x wall moving out and step counters spread so that restarts fire."""
    g = torch.Generator().manual_seed(seed)
    state, _, _ = tpush.init_batch(cfg, prm, B, g)
    h, q = B // 2, B // 4
    state.pos[:h] = state.obj_pos[:h] + torch.tensor([-0.115, 0.0])
    state.vel[:h] = torch.tensor([0.4, 0.0])
    state.pos[h:h + q, 0] = 0.1
    state.vel[h:h + q] = torch.tensor([-1.0, 0.2])
    state.steps = torch.randint(0, cfg.max_episode_steps, (B,), generator=g, dtype=torch.int32)
    return tpush.state_to_planes(state)


def uniforms(mode: str, n: int, seed: int) -> torch.Tensor:
    if mode == 'philox':
        return noise.philox_uniforms(seed, n, B)
    return torch.from_numpy(np.random.default_rng(seed).random((n, B), dtype=np.float32))


def interleaved_step(kc, stream, st, ux, uy):
    """The autoreset step before the split: each cycle draws its pairs as it
    runs, then the pre-reset observation, the restart's serial candidate
    loop and the post-reset observation draw in turn."""
    f = kc.f
    cycles = ((stream.normal_pair(), kpush._wall_pose_plain(f, stream, kc.box)) for _ in range(kc.num_cycles))
    phys, wall_f = kpush._run_cycles_plain(f, cycles, kc.learn_jerk, kc.box, st[:16], ux, uy)
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz = phys
    gx, gy, steps = st[16:19]
    n = [z for _ in range(3) for z in stream.normal_pair()]
    f_obs = [px + n[0] * f['std_pos'], py + n[1] * f['std_pos'], vx + n[2] * f['std_vel'],
             vy + n[3] * f['std_vel'], ox + n[4] * f['object_noise'], oy + n[5] * f['object_noise']]
    new_steps = steps + 1.0
    trunc = new_steps >= f['max_episode_steps']
    done = (wall_f > 0.0) | trunc
    rmx = stream.uniform_in(f['min_x'], f['span_x'])
    rmy = stream.uniform_in(f['min_y'], f['span_y'])
    rox = stream.uniform_in(f['obj_min_x'], f['obj_span_x'])
    roy = stream.uniform_in(f['obj_min_y'], f['obj_span_y'])
    found = torch.where(torch.sqrt((rox - rmx) * (rox - rmx) + (roy - rmy) * (roy - rmy)) > f['min_mo'], 1.0, 0.0)
    trials = torch.ones_like(px)
    for _ in range(kc.cand_k - 1):
        cx = stream.uniform_in(f['obj_min_x'], f['obj_span_x'])
        cy = stream.uniform_in(f['obj_min_y'], f['obj_span_y'])
        ok = torch.sqrt((cx - rmx) * (cx - rmx) + (cy - rmy) * (cy - rmy)) > f['min_mo']
        take = ok & (found == 0.0)
        trials = trials + (1.0 - found)
        rox, roy = torch.where(take, cx, rox), torch.where(take, cy, roy)
        found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
    rgx = stream.uniform_in(f['obj_min_x'], f['obj_span_x'])
    rgy = stream.uniform_in(f['obj_min_y'], f['obj_span_y'])
    do_reset = done & (found > 0.0)

    def reset_to(new, old):
        return torch.where(do_reset, new, old)

    zeros = [reset_to(0.0, x) for x in (vx, vy, ax, ay, kx, ky)]
    new_st = [reset_to(rmx, px), reset_to(rmy, py), *zeros, reset_to(rox, ox), reset_to(roy, oy),
              *(reset_to(0.0, x) for x in (wvx, wvy, oyaw, ow)), reset_to(f['z0'], mz), reset_to(0.0, mvz),
              reset_to(rgx, gx), reset_to(rgy, gy), reset_to(0.0, new_steps)]
    m = [z for _ in range(3) for z in stream.normal_pair()]
    scale = (f['std_pos'], f['std_pos'], f['std_vel'], f['std_vel'], f['object_noise'], f['object_noise'])
    post = [reset_to(new_st[r] + m[i] * scale[i], f_obs[i]) for i, r in enumerate((0, 1, 2, 3, 8, 9))]
    ddx, ddy = f_obs[4] - gx, f_obs[5] - gy
    reached = torch.sqrt(ddx * ddx + ddy * ddy) <= f['threshold']
    aux = post + f_obs + [ax, ay, wall_f, torch.where(reached, 1.0, 0.0), torch.where(trunc, 1.0, 0.0),
                          torch.where(done & (found == 0.0), 1.0, 0.0), torch.where(done, trials, 0.0)]
    return new_st, aux


CASES = [(box, jerk, cand_k) for box in (False, True) for jerk in (False, True) for cand_k in (32, 7)]


def case_id(c):
    return f"{'box' if c[0] else 'circle'}-{'jerk' if c[1] else 'acc'}-k{c[2]}"


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_split_step_equals_interleaved(case, mode):
    box, jerk, cand_k = case
    cfg, prm, kc = make(box, jerk, cand_k)
    st = busy_state(cfg, prm, seed=cand_k)
    act = torch.rand((2, B), generator=torch.Generator().manual_seed(3)) * 16.0 - 8.0
    u = uniforms(mode, kpush.autoreset_noise_planes(kc.num_cycles, cand_k, box), seed=11)
    got = kpush.pushing_autoreset_plain(st, act, kc, u)
    stream = noise.UniformStream(u)
    new_st, aux = interleaved_step(kc, stream, list(st), act[0], act[1])
    stream.finalize()
    want = torch.stack(new_st + aux[:15] + aux[17:])
    assert torch.equal(got, want)
    assert int((got[18] == 0).sum()) > 0  # restarts fired


@pytest.mark.parametrize('K', [1, 3])
@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_split_rollout_equals_interleaved(case, K):
    box, jerk, cand_k = case
    cfg, prm, kc = make(box, jerk, cand_k)
    st = busy_state(cfg, prm, seed=K)
    acts = torch.rand((K, 2, B), generator=torch.Generator().manual_seed(K)) * 16.0 - 8.0
    u = uniforms('philox' if K == 3 else 'injected', K * kpush.autoreset_noise_planes(kc.num_cycles, cand_k, box), 5)
    got_st, got_sig = kpush.pushing_rollout_plain(st, acts, kc, u)
    stream, cur, sig = noise.UniformStream(u), list(st), []
    for t in range(K):
        cur, aux = interleaved_step(kc, stream, cur, acts[t, 0], acts[t, 1])
        sig.append(torch.stack(aux[14:17]))
    stream.finalize()
    assert torch.equal(got_st, torch.stack(cur))
    assert torch.equal(got_sig, torch.stack(sig, dim=1))


def draws_by_index(kc, u: torch.Tensor, t: int):
    """One step's draws as the producer warps take them: draw d of step t is
    plane t * n_step + d; the restart tests the first candidate, then
    searches the rest for the first accepted one."""
    f, q = kc.f, 8 if kc.box else 4
    base = t * kpush.autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)

    def at(d):
        return noise.UniformStream(u[base + d:])

    cycles = [(at(i * q).normal_pair(), kpush._wall_pose_plain(f, at(i * q + 2), kc.box))
              for i in range(kc.num_cycles)]
    d_obs = q * kc.num_cycles
    n = tuple(z for i in range(3) for z in at(d_obs + 2 * i).normal_pair())
    d_r = d_obs + 6
    rmx, rmy = f['min_x'] + u[base + d_r] * f['span_x'], f['min_y'] + u[base + d_r + 1] * f['span_y']

    def cand(j):
        s = at(d_r + 2 + 2 * j)
        return s.uniform_in(f['obj_min_x'], f['obj_span_x']), s.uniform_in(f['obj_min_y'], f['obj_span_y'])

    def ok(cx, cy):
        return torch.sqrt((cx - rmx) * (cx - rmx) + (cy - rmy) * (cy - rmy)) > f['min_mo']

    rox, roy = cand(0)
    found = ok(rox, roy)
    trials = torch.where(found, 1.0, float(kc.cand_k))
    first = torch.full_like(rmx, -1.0)
    for j in range(1, kc.cand_k):
        cx, cy = cand(j)
        take = ok(cx, cy) & ~found & (first < 0)
        rox, roy = torch.where(take, cx, rox), torch.where(take, cy, roy)
        first = torch.where(take, float(j), first)
    trials = torch.where(first >= 0, 1.0 + first, trials)
    found = found | (first >= 0)
    goal = at(d_r + 2 + 2 * kc.cand_k)
    rgx, rgy = goal.uniform_in(f['obj_min_x'], f['obj_span_x']), goal.uniform_in(f['obj_min_y'], f['obj_span_y'])
    m = tuple(z for i in range(3) for z in at(d_r + 4 + 2 * kc.cand_k + 2 * i).normal_pair())
    restart = (rmx, rmy, rox, roy, torch.where(found, 1.0, 0.0), trials, rgx, rgy)
    return kpush.StepDraws(cycles=cycles, n=n, restart=restart, m=m)


@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_draws_by_absolute_index(case):
    box, jerk, cand_k = case
    _, _, kc = make(box, jerk, cand_k)
    K = 3
    n_step = kpush.autoreset_noise_planes(kc.num_cycles, cand_k, box)
    u = uniforms('philox', K * n_step, seed=21)

    def flat(d):
        cycles = [x for (v, (wx, wy, R)) in d.cycles for x in (*v, wx, wy, *(R or ()))]
        return cycles + [*d.n, *d.restart, *d.m]

    stream, searched = noise.UniformStream(u), 0
    for t in range(K):
        want = kpush.step_draws_plain(kc, stream)
        got = draws_by_index(kc, u, t)
        for a, b in zip(flat(got), flat(want), strict=True):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        searched += int((want.restart[5] > 1).sum())
    stream.finalize()
    assert searched > 0  # some first candidates were rejected


def crafted_restart(kc, accept: int | None):
    """Uniform planes for one restart with the mover at its range's low
    corner: candidates 0 .. accept - 1 at the object range's low corner
    (within min_mo of it: rejected), candidate ``accept`` on at the high
    corner (accepted); with ``accept`` None every candidate is rejected."""
    u = torch.zeros((4 + 2 * kc.cand_k, B))
    if accept is not None:
        u[2 + 2 * accept:2 + 2 * kc.cand_k] = 0.999
    return u


@pytest.mark.parametrize('accept', [0, 1, 5, 31, None])
def test_restart_trials_count_the_first_accepted_candidate(accept):
    _, _, kc = make(False, False, 32)
    f = kc.f
    stream = noise.UniformStream(crafted_restart(kc, accept))
    rmx, rmy, rox, roy, found, trials, rgx, rgy = kpush.restart_plain(f, stream, kc.cand_k)
    near = torch.full((B,), f['obj_min_x'])
    far = f['obj_min_x'] + torch.full((B,), 0.999) * f['obj_span_x']
    if accept is None:
        assert bool((found == 0.0).all()) and bool((trials == kc.cand_k).all())
        assert torch.equal(rox, near)  # the first candidate
    else:
        assert bool((found == 1.0).all()) and bool((trials == 1 + accept).all())
        assert torch.equal(rox, far)


@pytest.mark.parametrize('box', [False, True])
def test_restart_reads_no_state(box):
    """Two different states, every env at its last step, on the same draws:
    every env that restarts gets the same mover, object, goal and trials."""
    cfg, prm, kc = make(box, False, 7)
    u = uniforms('philox', kpush.autoreset_noise_planes(kc.num_cycles, kc.cand_k, box), seed=4)
    act = torch.zeros((2, B))
    states = [busy_state(cfg, prm, seed) for seed in (1, 2)]
    assert not torch.equal(states[0][:16], states[1][:16])
    outs = []
    for st in states:
        st[18] = float(cfg.max_episode_steps - 1)
        outs.append(kpush.pushing_autoreset_plain(st, act, kc, u))
    a, b = outs
    restarted = (a[18] == 0) & (b[18] == 0)
    assert int(restarted.sum()) > B // 2
    for plane in (0, 1, 8, 9, 16, 17, 35):  # mover, object, goal, trials
        assert torch.equal(a[plane][restarted], b[plane][restarted])
    assert torch.equal(a[34], b[34])  # stalled: every env is done, so exactly the restarts that found none


def ring_stages(kc, u: torch.Tensor) -> list:
    """Kernel B's ring for one step, as its producer warp fills it: a step
    without its step stage, stage k holding cycles k * per .. min((k + 1) *
    per, num_cycles) - 1 (per = STAGE_VALUES // q cycles, q the values of a
    cycle: 4 circle, 8 box), cycle i's values computed from its draws by
    absolute index (the velocity pair from draw q * i, the wall pose from
    q * i + 2)."""
    q = 8 if kc.box else 4
    per = STAGE_VALUES // q
    stages = []
    for k in range(-(-kc.num_cycles // per)):
        stage = []
        for i in range(k * per, min((k + 1) * per, kc.num_cycles)):
            s = noise.UniformStream(u[q * i:])
            stage.append((s.normal_pair(), kpush._wall_pose_plain(kc.f, s, kc.box)))
        stages.append(stage)
    return stages


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('num_cycles', [40, 6])
@pytest.mark.parametrize('box, jerk', [(False, False), (False, True), (True, False), (True, True)],
                         ids=['circle-acc', 'circle-jerk', 'box-acc', 'box-jerk'])
def test_cycles_ring_takes_the_draws_by_absolute_index(box, jerk, num_cycles, mode):
    cfg, prm, kc = make(box, jerk, 32, num_cycles)
    q = 8 if box else 4
    per = STAGE_VALUES // q
    u = uniforms(mode, kpush.cycles_noise_planes(num_cycles, box), seed=num_cycles)
    stages = ring_stages(kc, u)
    sizes = [len(stage) for stage in stages]
    assert sum(sizes) == num_cycles and all(n * q <= STAGE_VALUES for n in sizes)
    assert sizes[:-1] == [per] * (len(sizes) - 1) and sizes[-1] == num_cycles - per * (len(sizes) - 1)
    if num_cycles == 40:
        assert sizes[-1] < per  # the last stage partial: 4 of 6 cycles (circle), 1 of 3 (box)
    stream = noise.UniformStream(u)
    want = kpush.cycle_draws_plain(kc.f, stream, num_cycles, box)
    stream.finalize()
    got = [cycle for stage in stages for cycle in stage]

    def flat(cycles):
        return [x for (v, (wx, wy, R)) in cycles for x in (*v, wx, wy, *(R or ()))]

    for a, b in zip(flat(got), flat(want), strict=True):
        assert torch.equal(a, b)
    # the consumer's cycles on the ring's values are kernel B's plain version
    st = busy_state(cfg, prm, seed=num_cycles)
    act = torch.rand((2, B), generator=torch.Generator().manual_seed(4)) * 16.0 - 8.0
    planes = torch.cat([st[:16], act])
    phys, wall = kpush._run_cycles_plain(kc.f, got, jerk, box, list(planes[:16]), act[0], act[1])
    out = kpush.pushing_cycles_plain(planes, kc, u)
    assert torch.equal(torch.stack(phys + [wall]), out)
    assert int((out[16] > 0).sum()) > 0  # wall hits


@pytest.mark.parametrize('kernel', ['autoreset', 'rollout'])
@pytest.mark.parametrize('box', [False, True])
@pytest.mark.parametrize('b, want', [(1, 1), (31, 1), (4096, 1), (32768, 1), (32769, 0), (65536, 0),
                                     (1 << 20, 0)])
def test_uses_producer_by_width(b, want, box, kernel):
    """Kernels C and D launch blocks with one producer warp up to 32,768
    envs and blocks without one above (the measured table), in both
    collision shapes."""
    _, _, kc = make(box, False, 32)
    assert kpush.WIDE_BATCH['box' if box else 'circle'][kernel] == 32768
    assert kpush.uses_producer(b, kc, kernel) == want
    if kernel == 'autoreset':
        assert kpush.uses_producer(b, kc) == want  # C's, the default


@pytest.mark.parametrize('box', [False, True])
@pytest.mark.parametrize('b, producer', [(1, 1), (31, 1), (4096, 1), ('wide', 1), ('wide + 1', 0), (1 << 20, 0)])
def test_uses_producer_by_width_for_kernel_b(b, producer, box):
    """Kernel B launches blocks with the producer warp up to its own wide
    batch, in each collision shape, and blocks without one above."""
    _, _, kc = make(box, False, 32)
    wide = kpush.WIDE_BATCH['box' if box else 'circle']['cycles']
    b = {'wide': wide, 'wide + 1': wide + 1}.get(b, b)
    assert wide >= 4096
    assert kpush.uses_producer(b, kc, 'cycles') == producer


def test_uses_producer_follows_the_wide_batch(monkeypatch):
    _, _, kc = make(False, False, 32)
    monkeypatch.setitem(kpush.WIDE_BATCH, 'circle', {'cycles': 0, 'autoreset': 0, 'rollout': 0})
    assert kpush.uses_producer(1, kc) == 0
    assert kpush.uses_producer(1, kc, 'cycles') == 0
    monkeypatch.setitem(kpush.WIDE_BATCH, 'circle', {'cycles': 1 << 20, 'autoreset': 1 << 20, 'rollout': 1 << 20})
    assert kpush.uses_producer(65536, kc) == 1
    assert kpush.uses_producer(65536, kc, 'rollout') == 1
    assert kpush.uses_producer(1 << 20, kc, 'cycles') == 1
    assert kpush.uses_producer((1 << 20) + 1, kc, 'cycles') == 0
    _, _, kcb = make(True, False, 32)
    assert kpush.uses_producer(65536, kcb) == 0  # the box keeps its own row
