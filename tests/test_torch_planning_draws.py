"""The split of single-mover planning's autoreset step into its
state-independent draws and the physics that consumes them (kernels F and
G's producer/consumer design and its plain mirror, ``ops/kernels/planning.py``).

- The split plain step (``step_draws_plain`` then
  ``autoreset_physics_plain``) equals the interleaved step it replaced --
  each cycle drawing as it runs, then the observation, sampler and
  observation draws -- bit for bit, on injected uniforms and on the host
  copy of the Philox stream, for the circle and the box, full and holed
  layouts, acc and jerk, ``cand_k`` 16 and 7 (the goal sampler's first
  candidate then starts inside a Philox block), over K = 1 and 3 steps.
- The draws equal what the producer warp computes by absolute index: draw d
  of step t is uniform plane t * n_step + d, each sampler's first accepted
  candidate is searched after its first candidate.
- The restart reads no state, and each sampler's ``trials`` is 1 + j for
  its first accepted candidate j, else ``cand_k``.
- Kernel E's ring (a step of cycle stages and no step stage): stage k holds
  cycles k * per .. (k + 1) * per - 1, the last stage partial, made by
  producer warp 1 + k % 2, each value taken by absolute index (whole Philox
  blocks); in stage order the values are ``cycle_draws_plain``'s, and the
  cycles run on them are kernel E's plain version, bit for bit.
- The kernels' block shape (with the producer or thread-per-env) by batch
  width: E, F and G each up to its configuration's wide batch.
"""

import numpy as np
import pytest
import torch

from gymnasium_planar_robotics_tpu_torch.models import planning as tplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise, walls
from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kplan
from gymnasium_planar_robotics_tpu_torch.ops.kernels.dynamics import sqrt

B = 24
BOX = {'shape': 'box', 'size': np.array([0.09, 0.08])}
LAYOUTS = {'full': np.ones((3, 3)), 'holed': np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]])}
KW = dict(std_noise=[2e-3, 5e-2, 1e-5])
NUM_CYCLES = 6
STAGE_VALUES, RING_SLOTS, PRODUCERS = 24, 4, 2  # kStageValues, kRingSlots (split.cuh), kPlanningProducers


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def make(box: bool, layout: str, jerk: bool, cand_k: int, num_cycles: int = NUM_CYCLES):
    cfg, prm = tplan.make_planning_env(LAYOUTS[layout], 1, collision_params=BOX if box else {}, learn_jerk=jerk,
                                       device='cpu', num_cycles=num_cycles, **KW)
    return cfg, prm, kplan.make_kernel_consts(cfg, prm, cand_k)


def busy_state(cfg, prm, seed: int):
    """init_batch with a quarter of the envs just inside the +x edge moving
    out (wall hits) and step counters spread so that truncations fire."""
    g = torch.Generator().manual_seed(seed)
    state, _, _ = tplan.init_batch(cfg, prm, B, g)
    q = B // 4
    state.pos[:q, 0, 0] = 0.58
    state.vel[:q, 0] = torch.tensor([1.0, 0.1])
    state.steps = torch.randint(0, cfg.max_episode_steps, (B,), generator=g, dtype=torch.int32)
    state.steps[::3] = cfg.max_episode_steps - 1
    return tplan.state_to_planes(cfg, state)


def uniforms(mode: str, n: int, seed: int) -> torch.Tensor:
    if mode == 'philox':
        return noise.philox_uniforms(seed, n, B)
    return torch.from_numpy(np.random.default_rng(seed).random((n, B), dtype=np.float32))


def interleaved_step(kc, stream, st, ux, uy):
    """The autoreset step before the split: each cycle draws its pairs as it
    runs, then the pre-reset observation, the two serial samplers and the
    post-reset observation draw in turn."""
    f = kc.f
    gx, gy, steps = st[6:9]
    cycles = ((stream.normal_pair(), kplan._wall_pose_plain(kc, stream)) for _ in range(kc.num_cycles))
    (px, py, vx, vy, ax, ay), wall_f = kplan._cycles_plain(kc, cycles, st[:6], ux, uy)
    f_ax, f_ay = ax, ay
    n1, n2 = stream.normal_pair()
    n3, n4 = stream.normal_pair()
    f_agx, f_agy = px + n1 * f['std_pos'], py + n2 * f['std_pos']
    f_vx, f_vy = vx + n3 * f['std_vel'], vy + n4 * f['std_vel']
    ddx, ddy = f_agx - gx, f_agy - gy
    reached = sqrt(ddx * ddx + ddy * ddy) <= f['threshold']
    new_steps = steps + 1.0
    trunc = new_steps >= f['max_episode_steps']
    done = (wall_f > 0.0) | reached | trunc

    def sampler():
        sx = stream.uniform_in(f['min_x'], f['span_x'])
        sy = stream.uniform_in(f['min_y'], f['span_y'])
        found = torch.where(walls.sample_valid_at(kc.rule, kc.box, sx, sy, kc.sample_size), 1.0, 0.0)
        trials = torch.ones_like(sx)
        for _ in range(kc.cand_k - 1):
            cx = stream.uniform_in(f['min_x'], f['span_x'])
            cy = stream.uniform_in(f['min_y'], f['span_y'])
            ok = walls.sample_valid_at(kc.rule, kc.box, cx, cy, kc.sample_size)
            take = ok & (found == 0.0)
            trials = trials + (1.0 - found)
            sx, sy = torch.where(take, cx, sx), torch.where(take, cy, sy)
            found = torch.maximum(found, torch.where(ok, 1.0, 0.0))
        return sx, sy, found, trials

    rsx, rsy, s_found, s_trials = sampler()
    rgx, rgy, g_found, g_trials = sampler()
    found = (s_found > 0.0) & (g_found > 0.0)
    do_reset = done & found
    px, py = torch.where(do_reset, rsx, px), torch.where(do_reset, rsy, py)
    vx, vy, ax, ay = (torch.where(do_reset, 0.0, x) for x in (vx, vy, ax, ay))
    gx, gy = torch.where(do_reset, rgx, gx), torch.where(do_reset, rgy, gy)
    steps = torch.where(do_reset, 0.0, new_steps)
    m1, m2 = stream.normal_pair()
    m3, m4 = stream.normal_pair()
    aux = [torch.where(do_reset, vx + m3 * f['std_vel'], f_vx), torch.where(do_reset, vy + m4 * f['std_vel'], f_vy),
           torch.where(do_reset, px + m1 * f['std_pos'], f_agx), torch.where(do_reset, py + m2 * f['std_pos'], f_agy),
           f_vx, f_vy, f_agx, f_agy, f_ax, f_ay, wall_f, torch.where(reached, 1.0, 0.0),
           torch.where(trunc, 1.0, 0.0), torch.where(done & ~found, 1.0, 0.0),
           torch.where(done, s_trials + g_trials, 0.0)]
    return [px, py, vx, vy, ax, ay, gx, gy, steps], aux


CASES = [(box, layout, jerk, cand_k) for box in (False, True) for layout in LAYOUTS for jerk in (False, True)
         for cand_k in (16, 7)]


def case_id(c):
    return f"{'box' if c[0] else 'circle'}-{c[1]}-{'jerk' if c[2] else 'acc'}-k{c[3]}"


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_split_step_equals_interleaved(case, mode):
    box, layout, jerk, cand_k = case
    cfg, prm, kc = make(box, layout, jerk, cand_k)
    st = busy_state(cfg, prm, seed=cand_k)
    act = (torch.rand((2, B), generator=torch.Generator().manual_seed(3)) * 2 - 1) * (100.0 if jerk else 10.0)
    u = uniforms(mode, kplan.autoreset_noise_planes(kc.num_cycles, cand_k, box), seed=11)
    got = kplan.planning_autoreset_plain(st, act, kc, u)
    stream = noise.UniformStream(u)
    new_st, aux = interleaved_step(kc, stream, list(st), act[0], act[1])
    stream.finalize()
    assert torch.equal(got, torch.stack(new_st + aux[:12] + aux[13:]))
    assert int((got[8] == 0).sum()) > 0  # restarts fired


@pytest.mark.parametrize('K', [1, 3])
@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_split_rollout_equals_interleaved(case, K):
    box, layout, jerk, cand_k = case
    cfg, prm, kc = make(box, layout, jerk, cand_k)
    st = busy_state(cfg, prm, seed=K)
    acts = (torch.rand((K, 2, B), generator=torch.Generator().manual_seed(K)) * 2 - 1) * (100.0 if jerk else 10.0)
    u = uniforms('philox' if K == 3 else 'injected', K * kplan.autoreset_noise_planes(kc.num_cycles, cand_k, box), 5)
    got_st, got_sig = kplan.planning_rollout_plain(st, acts, kc, u)
    stream, cur, sig = noise.UniformStream(u), list(st), []
    for t in range(K):
        cur, aux = interleaved_step(kc, stream, cur, acts[t, 0], acts[t, 1])
        sig.append(torch.stack(aux[10:13]))
    stream.finalize()
    assert torch.equal(got_st, torch.stack(cur))
    assert torch.equal(got_sig, torch.stack(sig, dim=1))


def draws_by_index(kc, u: torch.Tensor, t: int):
    """One step's draws as the producer warp takes them: draw d of step t is
    plane t * n_step + d (every offset a multiple of 4: a cycle's draws are
    whole Philox blocks); each sampler tests its first candidate, then
    searches the rest for the first accepted one."""
    f, q = kc.f, 8 if kc.box else 4
    base = t * kplan.autoreset_noise_planes(kc.num_cycles, kc.cand_k, kc.box)
    assert base % 4 == 0 and (q * kc.num_cycles) % 4 == 0

    def at(d):
        return noise.UniformStream(u[base + d:])

    cycles = [(at(i * q).normal_pair(), kplan._wall_pose_plain(kc, at(i * q + 2))) for i in range(kc.num_cycles)]
    d_obs = q * kc.num_cycles
    n = tuple(z for i in range(2) for z in at(d_obs + 2 * i).normal_pair())

    def sampler(d0):
        def cand(j):
            s = at(d0 + 2 * j)
            return s.uniform_in(f['min_x'], f['span_x']), s.uniform_in(f['min_y'], f['span_y'])

        def ok(x, y):
            return walls.sample_valid_at(kc.rule, kc.box, x, y, kc.sample_size)

        sx, sy = cand(0)
        found = ok(sx, sy)
        first = torch.full_like(sx, -1.0)
        for j in range(1, kc.cand_k):
            cx, cy = cand(j)
            take = ok(cx, cy) & ~found & (first < 0)
            sx, sy = torch.where(take, cx, sx), torch.where(take, cy, sy)
            first = torch.where(take, float(j), first)
        trials = torch.where(found, 1.0, torch.where(first >= 0, 1.0 + first, float(kc.cand_k)))
        return sx, sy, torch.where(found | (first >= 0), 1.0, 0.0), trials

    d_start = d_obs + 4
    d_goal = d_start + 2 * kc.cand_k
    m = tuple(z for i in range(2) for z in at(d_goal + 2 * kc.cand_k + 2 * i).normal_pair())
    return kplan.StepDraws(cycles=cycles, n=n, start=sampler(d_start), goal=sampler(d_goal), m=m)


def flat(d):
    cycles = [x for (v, (wx, wy, R)) in d.cycles for x in (*v, wx, wy, *R)]
    return cycles + [*d.n, *d.start, *d.goal, *d.m]


@pytest.mark.parametrize('case', CASES, ids=case_id)
def test_draws_by_absolute_index(case):
    box, layout, jerk, cand_k = case
    _, _, kc = make(box, layout, jerk, cand_k)
    K = 3
    n_step = kplan.autoreset_noise_planes(kc.num_cycles, cand_k, box)
    u = uniforms('philox', K * n_step, seed=21)
    stream, searched = noise.UniformStream(u), 0
    for t in range(K):
        want = kplan.step_draws_plain(kc, stream)
        got = draws_by_index(kc, u, t)
        for a, b in zip(flat(got), flat(want), strict=True):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        searched += int((want.start[3] > 1).sum() + (want.goal[3] > 1).sum())
    stream.finalize()
    if layout == 'holed':
        assert searched > 0  # some first candidates were rejected


def crafted_sampler(kc, accept: int | None):
    """Uniform planes for one sampler: candidates 0 .. accept - 1 at the
    sampling box's low corner (the circle touches the table's edge there:
    rejected), candidate ``accept`` at its centre (accepted); with
    ``accept`` None every candidate is rejected."""
    u = torch.zeros((2 * kc.cand_k, B))
    if accept is not None:
        u[2 * accept:2 * accept + 2] = 0.5
    return u


@pytest.mark.parametrize('accept', [0, 1, 5, 15, None])
def test_sampler_trials_count_the_first_accepted_candidate(accept):
    _, _, kc = make(False, 'holed', False, 16)
    f = kc.f
    low = (f['min_x'], f['min_y'])
    assert not bool(walls.sample_valid_at(kc.rule, kc.box, torch.tensor([low[0]]), torch.tensor([low[1]]),
                                          kc.sample_size))
    sx, sy, found, trials = kplan._sample_valid_plain(kc, noise.UniformStream(crafted_sampler(kc, accept)))
    if accept is None:
        assert bool((found == 0.0).all()) and bool((trials == kc.cand_k).all())
        assert bool((sx == low[0]).all())  # the first candidate
    else:
        assert bool((found == 1.0).all()) and bool((trials == 1 + accept).all())
        assert torch.equal(sx, torch.full((B,), f['min_x']) + torch.full((B,), 0.5) * f['span_x'])


@pytest.mark.parametrize('box', [False, True])
def test_restart_reads_no_state(box):
    """Two different states, every env at its last step, on the same draws:
    every env that restarts gets the same start, goal and trials."""
    cfg, prm, kc = make(box, 'holed', False, 7)
    u = uniforms('philox', kplan.autoreset_noise_planes(kc.num_cycles, kc.cand_k, box), seed=4)
    act = torch.zeros((2, B))
    states = [busy_state(cfg, prm, seed) for seed in (1, 2)]
    assert not torch.equal(states[0][:6], states[1][:6])
    outs = []
    for st in states:
        st[8] = float(cfg.max_episode_steps - 1)
        outs.append(kplan.planning_autoreset_plain(st, act, kc, u))
    a, b = outs
    restarted = (a[8] == 0) & (b[8] == 0)
    assert int(restarted.sum()) > B // 2
    for plane in (0, 1, 6, 7, 22):  # start, goal, trials
        assert torch.equal(a[plane][restarted], b[plane][restarted])
    assert torch.equal(a[21], b[21])  # stalled: every env is done, so exactly the restarts that found none


def ring_stages(kc, u: torch.Tensor) -> list:
    """Kernel E's ring for one step, as its producer warps fill it: a step
    without its step stage, stage k made by warp 1 + k % PRODUCERS into slot
    k % RING_SLOTS and holding cycles k * per .. min((k + 1) * per,
    num_cycles) - 1 (per = STAGE_VALUES // q cycles, q the values of a
    cycle: 4 circle, 8 box), cycle i's values computed from its whole Philox
    blocks at draw q * i: the velocity pair from the first two words, the
    wall pose from the rest.  Returns (warp, slot, cycles) a stage."""
    q = 8 if kc.box else 4
    per = STAGE_VALUES // q
    stages = []
    for k in range(-(-kc.num_cycles // per)):
        cycles = []
        for i in range(k * per, min((k + 1) * per, kc.num_cycles)):
            assert (q * i) % 4 == 0
            s = noise.UniformStream(u[q * i:])
            cycles.append((s.normal_pair(), kplan._wall_pose_plain(kc, s)))
        stages.append((1 + k % PRODUCERS, k % RING_SLOTS, cycles))
    return stages


@pytest.mark.parametrize('mode', ['injected', 'philox'])
@pytest.mark.parametrize('num_cycles', [40, 6])
@pytest.mark.parametrize('layout', list(LAYOUTS))
@pytest.mark.parametrize('box, jerk', [(False, False), (False, True), (True, False), (True, True)],
                         ids=['circle-acc', 'circle-jerk', 'box-acc', 'box-jerk'])
def test_cycles_ring_takes_the_draws_by_absolute_index(box, jerk, layout, num_cycles, mode):
    cfg, prm, kc = make(box, layout, jerk, 16, num_cycles)
    q = 8 if box else 4
    per = STAGE_VALUES // q
    u = uniforms(mode, kplan.cycles_noise_planes(num_cycles, box), seed=num_cycles)
    stages = ring_stages(kc, u)
    sizes = [len(cycles) for _, _, cycles in stages]
    assert sum(sizes) == num_cycles and all(n * q <= STAGE_VALUES for n in sizes)
    assert sizes[:-1] == [per] * (len(sizes) - 1) and sizes[-1] == num_cycles - per * (len(sizes) - 1)
    if num_cycles == 40:
        assert sizes[-1] < per  # the last stage partial: 4 of 6 cycles (circle), 1 of 3 (box)
    producer_of = {}
    for warp, slot, _ in stages:
        assert producer_of.setdefault(slot, warp) == warp  # each slot has a single producer
    stream = noise.UniformStream(u)
    want = kplan.cycle_draws_plain(kc, stream)
    stream.finalize()
    got = [cycle for _, _, cycles in stages for cycle in cycles]

    def flat(cycles):
        return [x for (v, (wx, wy, R)) in cycles for x in (*v, wx, wy, *R)]

    for a, b in zip(flat(got), flat(want), strict=True):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    # the consumer's cycles on the ring's values are kernel E's plain version
    st = busy_state(cfg, prm, seed=num_cycles)
    st[0, :B // 4] = 0.64  # at the +x wall, moving out
    act = (torch.rand((2, B), generator=torch.Generator().manual_seed(4)) * 2 - 1) * (100.0 if jerk else 10.0)
    planes = torch.cat([st[:6], act])
    mover, wall = kplan._cycles_plain(kc, got, list(planes[:6]), act[0], act[1])
    out = kplan.planning_cycles_plain(planes, kc, u)
    assert torch.equal(torch.stack(mover + [wall]), out)
    assert int((out[6] > 0).sum()) > 0  # wall hits


@pytest.mark.parametrize('kernel', ['cycles', 'autoreset', 'rollout'])
@pytest.mark.parametrize('box, layout', [(False, 'full'), (True, 'full'), (False, 'holed'), (True, 'holed')])
@pytest.mark.parametrize('b, producer', [(1, 1), (31, 1), (4096, 1), ('wide', 1), ('wide + 1', 0), (1 << 20, 0)])
def test_uses_producer_by_width(b, producer, box, layout, kernel):
    """Kernels E, F and G launch blocks with the producer up to their
    configuration's wide batch and thread-per-env blocks above."""
    _, _, kc = make(box, layout, False, 16)
    wide = kplan.WIDE_BATCH['box' if box else 'circle', layout][kernel]
    b = {'wide': wide, 'wide + 1': wide + 1}.get(b, b)
    assert wide >= 4096
    assert kplan.uses_producer(b, kc, kernel) == producer
    if kernel == 'autoreset':
        assert kplan.uses_producer(b, kc) == producer  # F's, the default


def test_uses_producer_follows_the_wide_batches(monkeypatch):
    _, _, kc = make(False, 'full', False, 16)
    monkeypatch.setitem(kplan.WIDE_BATCH, ('circle', 'full'), {'cycles': 8192, 'autoreset': 0, 'rollout': 4096})
    assert kplan.uses_producer(1, kc) == 0
    assert kplan.uses_producer(4096, kc, 'rollout') == 1
    assert kplan.uses_producer(4097, kc, 'rollout') == 0
    assert kplan.uses_producer(8192, kc, 'cycles') == 1
    assert kplan.uses_producer(8193, kc, 'cycles') == 0
