"""The roofline of the fused rollouts on the card.

Counterpart of the JAX package's ``bench.py`` roofline (``ROOFLINE_KERNELS``,
``_microbench_peaks``, ``_run_roofline``): measured device peaks, per
env-step operation and byte counts of the three fused rollouts, and for a
measured rate the fraction of each peak it uses, the binding resource and
the speed-of-light rate.

- ``microbench_peaks`` measures the f32 FMA rate and the transcendental rate
  with kernel I (``ops/kernels/peaks``) and the HBM rate with an in-place
  multiply over 256 MB (plain PyTorch, as the JAX package leaves it to XLA).
- ``OPS`` counts the f32 operations of the CUDA sources (``csrc/``) per env,
  the special functions apart; the counts of the Pallas bodies
  (``ROOFLINE_KERNELS``) are not the port's.
- ``roofline(rates)`` prints one JSON line per rollout.
"""

from __future__ import annotations

import json
import statistics

import torch

from gymnasium_planar_robotics_tpu_torch.ops.kernels import peaks as kpeaks

#: published peaks of an H100 SXM at its 700 W limit (NVIDIA's data sheet):
#: f32 outside the tensor cores and HBM; the special-function units (16 per
#: SM per clock, Hopper white paper) at the clock the f32 peak implies
#: (67e12 / (132 SMs * 128 lanes * 2) = 1.98 GHz)
PUBLISHED_F32 = 67e12
PUBLISHED_HBM = 3.35e12
PUBLISHED_CLOCK = PUBLISHED_F32 / (132 * 128 * 2)
PUBLISHED_MUFU = 132 * 16 * PUBLISHED_CLOCK

# f32 operations per env, counted from the CUDA sources: (operations,
# special functions), one per add, mul, compare, select, min/max, logic op
# in the first, one per division, square root, log, cos and sin in the
# second.  Per control cycle: pushing (velocity noise, clamp chain, contact,
# mover z, object friction, noisy full-layout wall check, latch); planning by
# actuation and collision shape with the full-layout rule, plus the extra of
# the holed rule (nine cells' cover tests and one covered cell's edge tests;
# the missing-corner segment tests are not counted, so the count is a floor).
OPS = {
    'normal_pair': (5, 4),
    'pushing_cycle': (268, 30),
    # the box collision shape's cycle: the circle's plus the box wall check's
    # extra, which is planning's (two more normal pairs, quat_to_R2, four
    # vertex transforms and their tests in place of the circle's)
    'pushing_cycle_box': (371, 41),
    'pushing_step_extra': (110, 26),  # observations, termination, restart selects
    'pushing_candidate': (16, 1),  # one object candidate of the restart (all cand_k are drawn and tested)
    'pushing_features': (8, 0),  # C-feat: the four differences of each of the two feature blocks
    'planning_cycle_acc': (87, 13),
    'planning_cycle_jerk': (116, 20),
    'planning_box_extra': (103, 11),
    'planning_holed_extra_circle': (72, 0),
    'planning_holed_extra_box': (95, 0),
    'planning_step_extra': (67, 17),  # observations, termination, restart selects
    'planning_candidate_circle': (36, 0),  # one tested start/goal candidate
    'planning_candidate_box': (89, 0),
    # kernel H (csrc/planning_multi.cuh), per mover per cycle on top of a
    # planning cycle (whose counts include the mover's wall check): the
    # pair-test pose (a normal pair, two multiply-adds), for the box its
    # noisy rotation (two normal pairs, quat_to_R2)
    'multi_pair_pose': (9, 4),
    'multi_pair_pose_box_extra': (50, 11),
    'multi_pair_circle': (7, 1),  # one pair test per cycle
    'multi_pair_box': (71, 0),  # SAT minus containment
    'multi_step_mover': (43, 17),  # both observations and the goal test of one mover
    'multi_step_env': (10, 0),  # termination, flags, trials
    'multi_candidate_mover_circle': (34, 0),  # one mover of a tested candidate set: draws, wall test
    'multi_candidate_mover_box': (87, 0),
    'multi_candidate_pair_circle': (7, 1),  # one pair of a tested set (start or goal test)
    'multi_candidate_pair_box': (21, 0),  # identity-orientation SAT (start sets)
}


def ops_total(*terms) -> float:
    """Sum of ``count * OPS[name]`` over (count, name) terms, special
    functions included."""
    return float(sum(n * sum(OPS[name]) for n, name in terms))


def ops_split(*terms) -> tuple[float, float]:
    """(f32 operations, special functions) of (count, name) terms."""
    return (float(sum(n * OPS[name][0] for n, name in terms)), float(sum(n * OPS[name][1] for n, name in terms)))


def planning_cycle_ops(box: bool, full: bool, jerk: bool) -> list:
    """(count, name) terms of one planning control cycle of one mover."""
    terms = [(1, 'planning_cycle_jerk' if jerk else 'planning_cycle_acc')]
    if box:
        terms.append((1, 'planning_box_extra'))
    if not full:
        terms.append((1, 'planning_holed_extra_box' if box else 'planning_holed_extra_circle'))
    return terms


def multi_cycle_terms(m: int, box: bool, full: bool, jerk: bool) -> list:
    """(count, name) terms of one kernel H control cycle of one env: M
    movers' cycles with their pair-test poses, and the M(M-1)/2 pair tests
    (the same work whatever lane layout runs it)."""
    mover = planning_cycle_ops(box, full, jerk) + [(1, 'multi_pair_pose')]
    if box:
        mover.append((1, 'multi_pair_pose_box_extra'))
    return [(m * n, nm) for n, nm in mover] + [(m * (m - 1) // 2, 'multi_pair_box' if box else 'multi_pair_circle')]


def multi_env_terms(m: int, num_cycles: int, box: bool, full: bool, jerk: bool) -> list:
    """(count, name) terms of one kernel H step of one env that runs
    ``num_cycles`` cycles, restarts aside: the cycles, the observations."""
    return ([(num_cycles * n, nm) for n, nm in multi_cycle_terms(m, box, full, jerk)]
            + [(m, 'multi_step_mover'), (1, 'multi_step_env')])


def rollout_costs(num_cycles: int = 40, k: int = 32, movers: int = 4, cand_k: int = 32) -> dict:
    """Per env-step (f32 operations, special functions, bytes) of the three
    fused rollouts at their main configurations: pushing on kernel D and
    1-mover planning on kernel G with ``k`` steps per launch, 4-mover
    planning on kernel H (one step per launch); pushing tests all ``cand_k``
    object candidates of its restart in every step.  Bytes: the state planes
    read and written once per launch, each step's action and signal (or
    output) planes; the restarts' candidate tests of planning are not
    counted (a floor: about 2 of 50 steps end an episode)."""
    m = movers
    return {
        'pushing rollout': (*ops_split((num_cycles, 'pushing_cycle'), (1, 'pushing_step_extra'),
                                       (cand_k, 'pushing_candidate')), (19 + k * (2 + 3) + 19) * 4 / k),
        'planning rollout (1 mover)': (*ops_split(*[(num_cycles * n, nm) for n, nm in planning_cycle_ops(
            False, True, False)], (1, 'planning_step_extra')), (9 + k * (2 + 3) + 9) * 4 / k),
        'planning 4-mover rollout': (*ops_split(*multi_env_terms(m, num_cycles, False, True, False)),
                                     (10 * m + 1 + 18 * m + 6) * 4.0),
    }


def _event_ms(fn, repeats: int) -> list:
    """CUDA-event times of ``repeats`` calls of ``fn``, each alone."""
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return runs


def microbench_peaks(device='cuda', k_fma: int = 1 << 20, k_transc: int = 1 << 15, repeats: int = 5) -> dict:
    """The card's sustained rates: f32 FMA (TFLOP/s, 2 per FMA) and the
    transcendental mix (Gop/s, 3 per step) from kernel I at tens of
    milliseconds a call, HBM (GB/s) from 16 in-place multiplies of 256 MB
    (a read and a write each).  Each rate is the best of ``repeats`` calls
    after a warm-up, as the JAX package reports its peaks.  Needs a card."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise ValueError(f'the peaks are a measurement of the card, got {device}')
    out = {}
    for name, transc, k, per in (('fma', False, k_fma, kpeaks.FMA_OPS), ('transc', True, k_transc, kpeaks.TRANSC_OPS)):
        n = kpeaks.probe_length(device, transc)
        x = torch.full((n,), 0.5, dtype=torch.float32, device=device)
        kpeaks.peak_cuda(x, 1, transc)  # warm-up
        runs = _event_ms(lambda x=x, k=k, transc=transc: kpeaks.peak_cuda(x, k, transc), repeats)
        out[name] = {'n': n, 'k': k, 'ops': float(n) * k * per, 'ms_runs': runs, 'ms': min(runs)}
    y = torch.ones(64 * 1024 * 1024, dtype=torch.float32, device=device)
    k_hbm = 16

    def hbm():
        for _ in range(k_hbm):
            y.mul_(1.0000001)

    hbm()
    runs = _event_ms(hbm, repeats)
    out['hbm'] = {'bytes': float(k_hbm * 2 * y.numel() * 4), 'ms_runs': runs, 'ms': min(runs)}
    out['fma_tflops'] = out['fma']['ops'] / (out['fma']['ms'] * 1e-3) / 1e12
    out['transc_gops'] = out['transc']['ops'] / (out['transc']['ms'] * 1e-3) / 1e9
    out['hbm_gbs'] = out['hbm']['bytes'] / (out['hbm']['ms'] * 1e-3) / 1e9
    out['ms_spread'] = {k: (max(v['ms_runs']) - min(v['ms_runs'])) / statistics.median(v['ms_runs'])
                        for k, v in out.items() if isinstance(v, dict)}
    return out


def roofline(rates: dict, peaks: dict | None = None, costs: dict | None = None, log=print) -> list:
    """For each ``name -> env-steps/s`` of ``rates`` (names of
    ``rollout_costs``): the fractions of the measured f32, transcendental
    and HBM peaks its counted work uses, of the published f32 and HBM peaks
    beside them, the binding resource, and the speed-of-light rate were
    only that resource the limit.  Prints (``log``) and returns one dict
    per rollout; ``peaks`` from ``microbench_peaks`` (measured here when
    not given)."""
    peaks = microbench_peaks() if peaks is None else peaks
    costs = rollout_costs() if costs is None else costs
    f32, tr, bw = peaks['fma_tflops'] * 1e12, peaks['transc_gops'] * 1e9, peaks['hbm_gbs'] * 1e9
    rows = []
    for name, rate in rates.items():
        flops, transc, nbytes = costs[name]
        frac = {'f32': rate * flops / f32, 'transcendental': rate * transc / tr, 'hbm': rate * nbytes / bw}
        bound = max(frac, key=frac.get)
        row = {
            'metric': f'roofline {name}', 'env_steps_per_s': rate,
            'flops_per_step': flops, 'transc_per_step': transc, 'bytes_per_step': nbytes,
            'frac_f32': frac['f32'], 'frac_transcendental': frac['transcendental'], 'frac_hbm': frac['hbm'],
            'frac_f32_published': rate * flops / PUBLISHED_F32, 'frac_hbm_published': rate * nbytes / PUBLISHED_HBM,
            'bound': bound, 'speed_of_light_env_steps_per_s': rate / frac[bound],
        }
        rows.append(row)
        log(json.dumps(row))
    log(json.dumps({'metric': 'roofline peaks', 'f32_tflops': peaks['fma_tflops'],
                    'transcendental_gops': peaks['transc_gops'], 'hbm_gbs': peaks['hbm_gbs'],
                    'published_f32_tflops': PUBLISHED_F32 / 1e12, 'published_hbm_gbs': PUBLISHED_HBM / 1e9,
                    'published_mufu_gops': PUBLISHED_MUFU / 1e9}))
    return rows
