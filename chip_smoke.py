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
   262,144 Philox normals, at the shapes the paths launch it at
   (``A_SHAPES``: 3 pairs x 4096 and 65,536 envs, 3 and 8 pairs x 1 env, 258
   and 774 pairs x 4096 envs) and at ragged widths (1, 33, 4097 envs; 1-774
   pairs); the eager paths' call ``noise_probe(..., generator=gen)``: one
   launch in the Philox mode keyed by the card seed ``draw_seed`` draws, no
   uniforms, no host synchronisation; and the profiler's device time a
   launch in both modes at each of ``A_SHAPES``, beside an empty kernel's on
   the same grid, the bound and ``torch.randn`` of the same count;
3. kernels B, C and D against their plain versions at 4096 envs, from
   states with the mover planted at the object, in both noise modes:
   injected uniforms, and the kernel's own Philox stream (seed 7, the mode
   the public path launches) against the plain version fed the host copy
   of that stream (``noise.philox_uniforms``); B in both block shapes (with
   the producer warp and without) at 4096 and 65,536 envs in both noise
   modes, with the profiler's device time a launch in each shape and the
   SASS instructions a control cycle of its consumer's, producer's and
   thread-per-env loop; C and D also at 65,536 envs,
   where the wrapper launches blocks without the producer warp: held
   against their plain versions in both modes (D over 3 steps; an env that
   hits the wall may latch it a control cycle apart) and timed
   with and without the producer warp at both widths, with the ring layout,
   the consumer's cycle loop in SASS (instructions and MUFU per cycle) and
   ``ptxas -v``;
4. the public pushing path: ``make_pushing_env`` -> ``init_batch(4096)`` ->
   ``make_fused_step`` and ``make_fused_step_autoreset`` for a few steps ->
   ``make_fused_rollout`` for 64 steps at K=1 and K=32 (Philox noise), with
   every launch counter set to 0 before and read after; K=32 against K=1 at
   ``std_noise=0`` on envs that never restart, bit for bit;
5. env-steps/s of the pushing ``make_fused_rollout`` at 4096 and 65,536
   envs, kernels against the plain versions on the card (over T_PLAIN = 16
   steps), at K=1 and K=32;
6. kernels E, F and G (single-mover planning) against their plain versions
   at 4096 envs, in both noise modes as in 3., on four configurations:
   circle and box collision shapes on the full 3x3 table and on a holed
   layout, a quarter of the envs driven into a wall; E, F and G in both block
   shapes (with producer warps, the wrapper's choice up to its
   configuration's ``planning.WIDE_BATCH`` envs, and thread-per-env), also
   at 65,536 envs (F on every configuration; E, and G over 3 steps, on the
   full layouts), timed in both
   shapes at both widths, with the SASS instructions per control cycle of
   the consumer's, the producer's and the thread-per-env loop and
   ``ptxas -v``;
7. the public planning path: ``make_planning_env(np.ones((3, 3)), 1)`` ->
   ``init_batch(4096)`` -> ``make_fused_step`` x3 ->
   ``make_fused_step_autoreset`` x5 -> ``make_fused_rollout`` T=64 at K=1
   and K=32, counters set to 0 before and read after; K=32 against K=1 at
   ``std_noise=0`` on envs that never restart;
8. env-steps/s of the planning ``make_fused_rollout`` at 4096 and 65,536
   envs, T=64, K=1 and K=32, five alternating repeats each (median), plus
   the plain versions once over 16 steps;
9. kernel H (M-mover planning, any M: G lanes an env, L mover slots a
   lane) against its plain version at 4096 envs, in both noise modes, on
   six configurations: circle and box on the full 4x4 table with 4 movers,
   per-mover radii on a holed 4x4 layout with 3 movers (jerk), box on the
   L-shape with 2 movers (jerk), 12 movers on the full 8x8 table with
   ``cand_k=128`` (the share of done envs whose restart stalls reported),
   and 33 movers on a 16x16 table (parity only: its restarts stall); from
   states with a quarter of the envs driven into a wall and a quarter with
   head-on pairs; then timed on states eight random steps into a rollout
   (``tools/rollout_rates.multi_rollout_state``): the main configuration in
   the wrapper's layout (the kernels line, its bound counting the cycles
   each env runs up to its latch), and 2, 4, 8 and 12 movers at 4096 and
   65,536 envs in every layout (G, L) the wrapper can pick, the table
   ``LANE_TABLE`` is read from, with each instantiation's ``ptxas -v``;
   and 65, 96 and 128 movers (L = 4 slots or the many-mover variant, by
   ``LANE_TABLE``), circle and box, in both layouts, held at 1 cycle (both
   noise modes at 65, Philox above) and timed at 40; and 129 and 256 movers
   (the many-mover variant: one warp an env, the movers in shared memory),
   circle and box, held at 1 cycle on 64 envs in both noise modes and timed
   at 40 cycles on 4096 (129 circle movers held there in full: the kernels
   line's entry, with the device ms of that planted state beside a state
   where no env is done and one where every env restarts after its first
   cycle, that one held on 64 envs);
10. the public M-mover path: ``make_planning_env(np.ones((4, 4)), 4)`` ->
   ``init_batch(4096)`` -> ``make_fused_step_autoreset`` x5 ->
   ``multi_agent.make_batched_parallel_step`` x3 -> ``make_fused_rollout``
   T=64, counters set to 0 before and read after (72 launches of H); then
   the same at 12 movers on the full 8x8 table, counted on its own (no
   eager fallback); and the multi-agent step at 65 movers (3 launches of
   H);
11. env-steps/s of the M=4 ``make_fused_rollout`` at 4096 and 65,536 envs,
   T=64, five repeats (median, with the host's enqueue time), plus the
   plain version once at 4096 envs over 16 steps;
12. kernel C-feat (kernel C with the policy feature blocks) against its
   plain version at 4096 envs, planted states, acc and jerk, in both noise
   modes: its 36 planes equal kernel C's at the same noise bit for bit, its
   blocks equal its own planes' rows and differences bit for bit; timed as
   kernel C in 3.;
13. the PPO training path: ``ppo.make_train_step_reactive`` over
   ``pushing.make_reactive_rollout`` (dense shaping) with the recipe
   ``baseline`` of ``tools/train_push_strong.py`` ((128, 128) trunk, 25
   rollout steps, lr 3e-4, 4 epochs) at 2048 envs for 20 train steps,
   counters set to 0 before and read after (500 C-feat and 500 P launches,
   no other env kernel but A); then a constant-policy reactive rollout against
   ``make_fused_rollout`` at K=1, 4096 envs, T=64, bit for bit;
14. kernel P (the reactive policy step, ``ops/kernels/policy``) against
   its plain version (the torch ops, TF32 off) on the same inputs at
   (12, (256, 256), 2) x 65,536 envs and the training phase's (12, (128,
   128), 2) x 2048: raw, logp and value within 2e-6 of the plain version's
   largest magnitude, the action its own raw clamped bit for bit, one
   launch a call; its time by CUDA events (five groups of 20 launches),
   the plain version's, the torch ops' busy time on the card (the
   profiler's kernel records, ``library_ms``), the bound and the
   compiler's registers; then env-steps/s of the reactive rollout with a
   (256, 256) policy (``ppo.sample_action_pm``: kernel P) against
   ``make_fused_rollout`` at K=1, 4096 and 65,536 envs, T=64, ten
   alternating repeats (medians, with the host's enqueue time), one P
   launch a step;
15. PPO learns on the card: 1-mover planning (3x3, ``a_max`` 3, dense
   shaping, (64, 64) trunk, 16 rollout steps, lr 1e-3, 256 envs), 110
   train steps over ``planning.make_reactive_rollout``; the mean reward of
   the last 10 steps beats that of the first 10 by more than 0.3;
16. kernel I (the roofline's peak probes) against its plain version at a
   small K, then ``utils/roofline.microbench_peaks``: the f32 FMA TFLOP/s,
   the transcendental Gop/s and the HBM GB/s beside the published peaks,
   counters set to 0 before and read after;
17. ``utils/roofline.roofline`` on the pushing (kernel D, K=32), planning
   (kernel G, K=32) and 4-mover (kernel H) rates at 4096 envs of phases 5,
   8 and 11;
18. the eager steps on the card: pushing's ``step`` against kernel B, and
   planning's (1 and 4 movers) against kernels E and H, at 4096 envs and
   ``std_noise=0``; ``step_autoreset`` of both families for 32 steps at 2048
   envs, counters set to 0 before and read after, ms and host share per
   step, CUDA launches per step (``utils/profiling.trace``) and the host
   synchronisations in a step, beside the fused step;
19. the PPO recipe on the eager step: ``tools/train_push_strong.train``
   (recipe ``baseline``) at 2048 envs for a few iterations with one strict
   eval of 1024 episodes, and the train step split into rollout and update;
20. the box collision shape's kernels B, C, C-feat and D against their plain
   versions at 4096 envs (box half-extents 0.09, bench.py:653-655), a
   quarter of the envs driven into the -x wall, in both noise modes (D held
   over 4 steps and timed at K=32), each timed beside its circle twin and
   its bound (``roofline.OPS['pushing_cycle_box']``), B, C, C-feat and D as
   in 3.;
21. the box main path: ``make_fused_step``, ``make_fused_step_autoreset``,
   ``make_fused_rollout`` at K=1 and K=32 and ``make_reactive_rollout`` with
   a (256, 256) policy at 4096 envs, counters set to 0 before and read
   after; then the eager ``step`` against kernel B at 2048 envs (flags
   equal) and a few eager ``step_autoreset`` steps;
22. mesh movers: the mesh+bumper configuration of bench.py:643-644 through
   ``make_fused_rollout`` at 4096 envs and K=1 (env-steps/s, beside the
   default mover), and planning's kernel F with a mesh mover and bumper
   against its plain version in both block shapes;
23. every fused step (pushing, box pushing, 1-, 4- and 12-mover planning,
   the multi-agent step at 4 and 12 movers) with a generator on the card
   makes no host synchronisation (sync debug mode 'warn');
24. DDPG+HER on pushing: ``tools/train_push_her.py``'s train step at its
   defaults ((256, 256), 50 rollout steps, 20 updates at minibatch 4096, a
   4M replay buffer, the fused step) at 512 and 2048 envs, a warm-up and 3
   iterations split into rollout, relabel + insert and update (CUDA
   events), counters set to 0 before each and read after (50 launches of C
   an iteration), no host synchronisation in the rollout, the buffer's
   bytes;
25. HER on 1-mover planning's fused step (kernel F): the learning gate of
   ``tests/test_her_learning.py`` (3x3, 256 envs, 250 iterations with and
   without relabelling), its thresholds reported with the curves;
26. ``utils/checkpoint``: the HER runner saved after 2 iterations and
   restored into a fresh one, bit-equal, and its next iteration bit-equal
   to the uninterrupted run's;
27. the adapters' card path, ``envs/runner.py`` (this machine has no
   gymnasium, pettingzoo or mujoco, so the Gym, vector and PettingZoo shells
   themselves are held on the CPU): the single-env runner (eager step,
   kernel A) for pushing and 1- and 4-mover planning, 50 steps around a
   reset, ms a step, A's launches a step, one host synchronisation a step;
   the vector runner at 4096 envs for pushing, box pushing, 1- and 4-mover
   planning and 129 movers: the fused step (C, C box, F, H, H's many-mover
   variant) at one launch and one host synchronisation a step, each step's
   outputs bit-equal to the fused step called directly, ms a step and
   env-steps/s through the numpy boundary;
28. the sharded paths (``parallel/sharding.py``) on a world-size-1 NCCL
   group (a ``FileStore``, no network) at 4096 envs: the sharded fused step
   of pushing (C), 1-mover planning (F) and 4-mover planning (H), the
   sharded rollouts at K=1 and K=32 (C/D, F/G) and the sharded reactive
   rollout (C-feat), counters set to 0 before and read after; each bit for
   bit against its unsharded twin from the same generator state or seed (a
   card seed tensor too), no host synchronisation in a sharded step,
   ``metrics_summary`` through NCCL equal to the local means, and ms a
   step and env-steps/s of the sharded steps and their twins alternating;
29. PPO over the sharded paths: the port's ``examples/train_sharded.py``,
   fused (kernel F) and ``--reactive``, at 4096 envs, rollout 32, 3
   iterations: ms an iteration, env-steps/s, all-reduces an iteration,
   finite parameters;
30. the trajectory store: the port's ``examples/collect_trajectories.py``
   on the card (512 envs, 200 steps of kernel F), the ``g++`` build's
   seconds, every frame read back bit for bit;
31. the domain-core facade's ``qpos_is_valid`` on 2^20 poses on the card
   against the CPU, the checked pushing fused step (``models/debug.py``)
   clean and on a corrupted state, and the impedance wrench on 2^20 poses
   against the CPU (float64, atol 1e-12);
32. planning's reset in bounded chunks: ``init_batch`` at 24 movers (circle
   r=0.11, full 16x16 table) at 4096 and 65,536 envs, its chunks of
   sets and envs, peak memory (held to a bound from the chunk), stall
   share and ms, bit-equal at 4096 envs to the one-chunk reset from the
   same generator state;
33. the vector runner over a world-size-1 NCCL mesh at 4096 envs (pushing,
   box pushing, 1- and 4-mover planning; the sharded fused step, C, C box,
   F, H), 20 steps after a reset: ms a step, collectives a step, launches,
   every output and the final state bit-equal to the unsharded runner's;
34. the transfer protocol's in-engine half (``tools/transfer_eval.py``):
   the scripted pursuit policy's eval at 512 episodes, success and
   success_any; ``train_planning`` and ``train_pushing_ppo``, 2 iterations
   at 256 envs each, ms an iteration.

Times are CUDA-event times; a short launch (A, E, F, H) is timed as the
median of five groups of 20 launches, with the groups' spread (where the
host enqueues A, E or F slower than the card runs it, that is the host's
rate: their phases, and B's, also give the profiler's device time a
launch).  The line
before the last is a JSON object with one entry per kernel (A-H, C-feat,
I's two probes, the box variants of B, C, C-feat and D, and P): its
launches on its own path (``launches``) and, by phase, on its path, the
sharded path of phase 28 and phases 32-34 (``launches_by_phase``), its largest error against the plain version (both
noise modes), its time in the mode its path launches (Philox; kernel A:
the profiler's device time at 3 pairs x 4096 envs), the plain version's
time, its bound in that mode and, for kernel A, ``torch.randn`` of the same
count, for kernel P the torch ops' busy time (``library_ms``):
the larger of its bytes (state, action and output planes; the Philox mode
reads no uniforms) over 3.35 TB/s and its f32 operations over 67 TFLOP/s,
counted from this run's inputs (Philox's integer work is not counted, so
the bound is a floor).  The phase lines also give the injected mode's time
and bound, which count the uniform planes.  The last line is
``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero.  A full report goes to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or outside a checkout, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = 'gymnasium_planar_robotics_tpu_torch'
B_MAIN = 4096
B_LARGE = 65536
K_LARGE_CHECK = 3  # kernel D's steps held against its plain version at B_LARGE
T_ROLL = 64
T_PLAIN = 16  # steps of the plain versions' timed rollouts in the rate phases (the kernels run T_ROLL)
K_MAIN = 32
DEVICE = 'cuda:0'

KERNELS = {
    'noise_probe': ('csrc/noise_probe.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:2309'),
    'pushing_cycles': ('csrc/pushing_cycles.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:903'),
    'pushing_autoreset': ('csrc/pushing_autoreset.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1034'),
    'pushing_rollout': ('csrc/pushing_rollout.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1083'),
    'planning_cycles': ('csrc/planning_cycles.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:569'),
    'planning_autoreset': ('csrc/planning_autoreset.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1545'),
    'planning_rollout': ('csrc/planning_rollout.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1587'),
    'planning_multi_autoreset': ('csrc/planning_multi_autoreset.cu',
                                 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1767'),
    # kernel H above 128 movers: the many-mover variant (the movers in shared memory)
    'planning_multi_autoreset_many': ('csrc/planning_multi_autoreset.cu',
                                      'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1767'),
    # kernel C's emit_features branch (in _pushing_autoreset_kernel)
    'pushing_autoreset_features': ('csrc/pushing_autoreset.cu',
                                   'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1066'),
    # kernel I: the roofline's peak probes, launched through bench.py:550
    'peak_fma': ('csrc/peaks.cu', 'bench.py:523'),
    'peak_transc': ('csrc/peaks.cu', 'bench.py:531'),
    # the box collision shape of B, C, C-feat and D (the same Pallas
    # functions traced with box=True)
    'pushing_cycles_box': ('csrc/pushing_cycles.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:903'),
    'pushing_autoreset_box': ('csrc/pushing_autoreset.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1034'),
    'pushing_autoreset_features_box': ('csrc/pushing_autoreset.cu',
                                       'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1066'),
    'pushing_rollout_box': ('csrc/pushing_rollout.cu', 'gymnasium_planar_robotics_tpu/ops/pallas_step.py:1083'),
    # kernel P: the reactive policy step, which the JAX package leaves to XLA
    'policy_mlp': ('csrc/policy_mlp.cu', 'gymnasium_planar_robotics_tpu/models/ppo.py:85'),
}
PUSHING_KERNELS = ('noise_probe', 'pushing_cycles', 'pushing_autoreset', 'pushing_rollout')
PLANNING_KERNELS = ('planning_cycles', 'planning_autoreset', 'planning_rollout')
MULTI_KERNELS = ('planning_multi_autoreset',)
ADAPTER_KERNELS = ('planning_multi_autoreset_many',)  # counted on the adapters' path (phase 27)
TRAIN_KERNELS = ('pushing_autoreset_features', 'policy_mlp')
PEAK_KERNELS = ('peak_fma', 'peak_transc')
BOX_KERNELS = ('pushing_cycles_box', 'pushing_autoreset_box', 'pushing_rollout_box', 'pushing_autoreset_features_box')
# kernel A's (pairs, envs) on the paths: the main path's observation, the
# wide batch, the single-env runner's observation and reset, a 129-mover
# observation and a 129-mover box reset's noisy checks
A_SHAPES = ((3, 4096), (3, 65536), (3, 1), (8, 1), (258, 4096), (774, 4096))
M_MAIN = 4  # movers of the M-mover main configuration (bench.py:401)
M_WIDE = 12  # movers of the wide M-mover configuration: full 8x8 table, cand_k=128
H_LAYOUT_MOVERS = (2, 4, 8, 12)  # movers at which kernel H is timed in every lane layout
H_WIDE_MOVERS = (65, 96, 128)  # movers above 64: kernel H's L = 4 slots
H_MANY_MOVERS = (129, 256)  # movers above 128: kernel H's many-mover variant
T_ADAPTER = 50  # steps of the single-env runner (around a reset)
T_VECTOR = 20  # timed steps of the vector runner
HER_BATCHES = (512, 2048)  # the HER recipe's batch (tools/train_push_her.py --batch) and the PPO recipe's
HER_ITERS = 3  # timed HER iterations a batch, after one warm-up
HER_GATE_ITERS = 250  # iterations of each learner in the HER gate (tests/test_her_learning.py:98)
B_TRAIN = 2048  # the PPO recipe's batch (tools/train_push_strong.py --batch)
TRAIN_STEPS = 20
B_EAGER, T_EAGER = 2048, 32  # the eager step_autoreset's run
EAGER_ITERS = 2  # iterations of the PPO recipe on the eager step
K_G_CHECK = 4  # kernel G's (and box D's) steps held against its plain version (but the timed run's K_MAIN)
T_BOX_EAGER = 3  # steps of the box's eager step_autoreset
M_RESET = 24  # movers of the reset-memory phase: full 16x16 table, circle r=0.11
# the most f32 temporaries of one test's entries (pairs + movers x table cells a (set, env)) the
# reset may hold at once beside two draws of uniforms; the test is a chunk of candidate sets
# (``planning.reset_chunks``) or the noisy re-check of the whole batch, whichever is larger
RESET_TEMPS = 4
T_MESH = 20  # timed steps of the vector runner over a mesh

# the card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit): HBM
# bytes/s and f32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

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


def time_groups(fn, groups: int = 5, iters: int = 20):
    """(median, group means) of ``groups`` CUDA-event timings of ``iters``
    calls each: a launch of tens of microseconds varies between groups
    more than one mean resolves."""
    runs = [time_ms(fn, iters) for _ in range(groups)]
    return statistics.median(runs), runs


def timed(fn):
    """(result, CUDA-event ms, host ms) of one call of ``fn``; the host ms
    is the time to enqueue it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    res = fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end), host


def spread(runs) -> float:
    """(max - min) / median of a list of timings."""
    return (max(runs) - min(runs)) / statistics.median(runs)


def bound(nbytes: float, ops: float):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for this work, the larger of bytes over the HBM rate and operations
    over the f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


@functools.lru_cache(maxsize=None)
def sass_text(lib_path: str) -> str:
    """``cuobjdump -sass`` of the built library, run once (tens of seconds)."""
    cuobjdump = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    return subprocess.run([cuobjdump, '-sass', lib_path], capture_output=True, text=True, check=True).stdout


def sass_loops(lib_path: str, kernel: str):
    """The loops of ``kernel`` (a substring of its mangled name) in the built
    library: for each backward branch, the ``(op, args)`` of the
    instructions between its target and itself."""
    body, inside = [], False
    for ln in sass_text(lib_path).splitlines():
        if 'Function : ' in ln:
            inside = kernel in ln
            continue
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);', ln)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, args in body:
        t = re.match(r'\s*(0x[0-9a-f]+|\d+)', args) if op.startswith('BRA') else None
        if t and int(t.group(1), 0) < addr:
            loops.append([(o, a) for ad, o, a in body if int(t.group(1), 0) <= ad <= addr])
    return loops


def sass_loop_counts(lib_path: str, kernel: str) -> dict:
    """FP32 and MUFU instructions per chain step in the main loop of
    ``kernel`` (``sass_loops``): the widest loop, over its count of ``FMUL``
    by 0.49 (the step's first operation, rounded on its own: one per step,
    so the loop's unrolling cancels out)."""
    loop = max(sass_loops(lib_path, kernel), key=len)
    fp32 = sum(op.split('.')[0] in ('FFMA', 'FADD', 'FMUL', 'FMNMX', 'FSETP', 'FSEL', 'FSET') for op, _ in loop)
    mufu = sum(op.startswith('MUFU') for op, _ in loop)
    steps = sum(op.startswith('FMUL') and '0.4900000' in args for op, args in loop)
    return {'fp32_per_step': fp32 / steps, 'mufu_per_step': mufu / steps, 'steps_in_loop': steps,
            'loop_instructions': len(loop)}


def friction_marker(op: str, args: str) -> bool:
    """The pushing cycle's marker: the ``FMNMX`` with 1e-12 of the floor
    friction's ``fmaxf(speed, 1e-12f)``, one per cycle."""
    return op.startswith('FMNMX') and re.search(r'e-1[23]', args) is not None


def box_muller_marker(op: str, args: str) -> bool:
    """Box-Muller's ``2 pi * u2``: one per normal pair drawn."""
    return op.startswith('FMUL') and '6.28318' in args


def shared_load_marker(op: str, args: str) -> bool:
    """A shared-memory load: one per value a consumer pops from the ring."""
    return op.startswith('LDS')


def pops(n: int):
    """Whether a loop pops ``n`` values from the ring: one control cycle of
    a consumer's loop, ``n`` the values of a cycle (a loop with other counts
    of shared loads reads a step stage)."""
    return lambda loop: sum(shared_load_marker(o, a) for o, a in loop) == n


def sass_cycle_counts(lib_path: str, kernel: str, marker=friction_marker, per_cycle: int = 1, where=None) -> dict:
    """Instructions and MUFU (special-function) instructions per control
    cycle in the cycle loop of ``kernel`` (``sass_loops``): the innermost
    loop holding ``marker`` instructions (among the loops for which
    ``where(loop)`` holds, when given), ``per_cycle`` of them a cycle, so the
    loop's unrolling cancels out.  Static counts: a stage hand-over inside
    the loop counts once a cycle though it runs once a stage."""
    marked = [(loop, sum(marker(o, a) for o, a in loop)) for loop in sass_loops(lib_path, kernel)
              if where is None or where(loop)]
    marked = [(loop, n / per_cycle) for loop, n in marked if n]
    if not marked:
        return {'error': f'no cycle loop found in {kernel}'}
    loop, cycles = min(marked, key=lambda m: len(m[0]))
    return {'instructions_per_cycle': len(loop) / cycles,
            'mufu_per_cycle': sum(o.startswith('MUFU') for o, _ in loop) / cycles,
            'cycles_in_loop': cycles, 'loop_instructions': len(loop)}


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
    from gymnasium_planar_robotics_tpu_torch.tools.rollout_rates import (PROFILER_MISSES, forced_layout, forced_shape,
                                                                         kernel_h_layouts, ladder_state,
                                                                         launch_device_ms, multi_rollout_state)
    from gymnasium_planar_robotics_tpu_torch.utils.roofline import (OPS, multi_cycle_terms, multi_env_terms, ops_total,
                                                                    planning_cycle_ops)

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
            'nvcc_s': round(build.build_info.get('seconds', 0.0), 3),
            'source_s': build.build_info.get('source_seconds', {}), 'ptxas': regs,
        }

    if failed:
        print('chip_smoke: the kernels did not build', file=sys.stderr)
        return 1

    gen = torch.Generator(device=dev).manual_seed(0)

    def philox(seed, n, b):
        """The uniforms a kernel launched with ``seed`` draws, on the card."""
        return noise.philox_uniforms(seed, n, b).to(dev)

    def philox_normals(seed, d, b):
        """Kernel A's plain version over the host copy of the Philox stream
        of ``seed`` (``d`` pairs of ``b`` envs), on the card."""
        return noise.noise_probe_plain(philox(seed, 2 * d, b))

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
        # both modes at the paths' shapes (A_SHAPES) and at ragged widths,
        # odd and even pair counts (a thread's Philox block with one pair or two)
        checks, errs = {}, {'injected': 0.0, 'philox': 0.0}
        for d, b in sorted(set(A_SHAPES) | {(d, b) for d in (1, 3, 4, 8, 258, 774) for b in (1, 33, 4097)}):
            u_db = torch.rand((2 * d, b), generator=gen, device=dev)
            for mode, got_db, ref_db in (
                    ('injected', noise.noise_probe_cuda(d, b, dev, uniforms=u_db), noise.noise_probe_plain(u_db)),
                    ('philox', noise.noise_probe_cuda(d, b, dev, seed=7 + d), philox_normals(7 + d, d, b))):
                err_db, ok_db = compare(got_db, ref_db, 2e-6, 2e-6)
                require(ok_db, f'{mode} at {d} pairs x {b} envs disagrees: {err_db}')
                errs[mode] = max(errs[mode], err_db)
            checks[f'{d}x{b}'] = 'ok'
        # the eager paths' call: A's Philox mode keyed by draw_seed(gen) (a
        # card tensor), one launch, no uniforms drawn, no host synchronisation
        twin = torch.Generator(device=dev)
        twin.set_state(gen.get_state())
        seed_t = kernels.draw_seed(twin)
        draw_uniforms, kernels.draw_uniforms = kernels.draw_uniforms, None  # a call of it raises
        before = kernels.LAUNCHES['noise_probe']
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    got_g = noise.noise_probe(258, B_MAIN, dev, generator=gen)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            kernels.draw_uniforms = draw_uniforms
        syncs = sum('called a synchronizing' in str(w.message) for w in caught)
        require(kernels.LAUNCHES['noise_probe'] == before + 1 and syncs == 0,
                f'the paths\' call: {kernels.LAUNCHES["noise_probe"] - before} launches, {syncs} host syncs')
        err_g, ok_g = compare(got_g, philox_normals(int(seed_t), 258, B_MAIN), 2e-6, 2e-6)
        require(ok_g, f'the paths\' call disagrees with its seed\'s stream: {err_g}')
        # device ms a launch (the profiler's) of both modes at each shape, an
        # empty kernel on the same grid (the floor of a launch of that
        # shape), the bound, and torch.randn of the same count (a yardstick:
        # another stream, which the port never calls)
        shapes = {}
        for d, b in A_SHAPES:
            u_db = torch.rand((2 * d, b), generator=gen, device=dev)
            ops = ops_total((d * b, 'normal_pair'))
            cell = {'library_ms': launch_device_ms(lambda: torch.randn((2 * d, b), device=dev), 100)}
            for mode, kw, nbytes in (('philox', {'seed': 7}, 8 * d * b), ('injected', {'uniforms': u_db}, 16 * d * b)):
                bound_ms, bound_by = bound(nbytes, ops)
                cell[mode] = {
                    'device_ms': launch_device_ms(lambda: noise.noise_probe_cuda(d, b, dev, **kw), 100),
                    'empty_ms': launch_device_ms(lambda: noise.empty_launch_cuda(b, dev, d, mode == 'injected'), 100),
                    'bound_ms': bound_ms, 'bound_by': bound_by}
            shapes[f'{d}x{b}'] = cell
        main = shapes[f'3x{B_MAIN}']
        ms, ms_groups = time_groups(lambda: noise.noise_probe_cuda(3, B_MAIN, dev, seed=7))
        u3 = philox(7, 6, B_MAIN)
        plain_ms = time_ms(lambda: noise.noise_probe_plain(u3), 50)
        # the kernels line: the Philox mode the paths launch, at the main
        # path's shape (3 pairs x 4096 envs), by the profiler's device time
        # (the events' time of a launch this short is the host's enqueue)
        kstats['noise_probe'].update(max_abs_err=max(err_inj, err_ph, err_g, *errs.values()),
                                     ms=main['philox']['device_ms'], plain_ms=plain_ms,
                                     bound_ms=main['philox']['bound_ms'], bound_by=main['philox']['bound_by'],
                                     library_ms=main['library_ms'])
        return {'max_abs_err_injected': max(err_inj, errs['injected']),
                'max_abs_err_philox': max(err_ph, err_g, errs['philox']), 'tol': 'atol 2e-6 + rtol 2e-6',
                'checked': checks, 'philox_samples': 2 * n_env, 'mean': mean, 'std': std, 'p_abs_gt_2': tail,
                'paths_call': {'launches': 1, 'host_syncs': syncs, 'max_abs_err': err_g},
                'ms_events': ms, 'ms_groups': ms_groups, 'ms_spread': spread(ms_groups), 'plain_ms': plain_ms,
                'shapes': shapes, 'threads': noise.A_THREADS, 'waves': noise.A_WAVES}

    # -- 3. kernels B, C, D ---------------------------------------------------
    config, params = P.make_pushing_env(device=dev)
    kc = kp.make_kernel_consts(config, params, 32)
    def pushing_step_ops():
        """f32 operations of one pushing autoreset step of one env."""
        return ops_total((kc.num_cycles, 'pushing_cycle'), (1, 'pushing_step_extra'),
                         (kc.cand_k, 'pushing_candidate'))

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

    # feature rows against the plain version's: the planes' tolerance, atol
    # doubled for the rows that are differences of two planes
    feat_rtol, feat_atol = 3e-5, 6e-6

    def with_producer(producer: int, fn, module=kp):
        """``fn()`` with the kernels of ``module`` (pushing's B, C and D;
        planning's E, F and G) launching blocks with (1) or without (0) the
        producer at every width."""
        with forced_shape(module, producer):
            return fn()

    def split_report(launch, main_args, large_args, kernel: str, kc_, which: str = 'autoreset',
                     grouped: bool = True) -> dict:
        """Kernels C and D's two block shapes: the time of ``launch(*args)``
        (Philox) at B_MAIN and B_LARGE with and without the producer warp (the
        wrapper takes one at each width for ``kc_`` and ``which`` kernel, the
        other shows when the threshold goes stale), the ring layout, and the
        consumer's cycle loop in SASS (``kernel``: its acc Philox
        instantiation)."""
        def ms_of(fn):
            return time_groups(fn)[0] if grouped else statistics.median(time_ms(fn, 5) for _ in range(3))

        by_p = {b: {p: ms_of(lambda args=args, p=p: with_producer(p, lambda: launch(*args))) for p in (0, 1)}
                for b, args in ((B_MAIN, main_args), (B_LARGE, large_args))}
        # ptxas -v of the kernel's instantiations of this shape (acc or jerk,
        # either noise mode): both roles run in one block, one warpgroup, so
        # they share its register allocation
        name, flags = kernel.split('IL', 1)
        shape = re.compile(name + r'ILb[01]ELb' + re.findall(r'b([01])', flags)[1] + 'E')
        ptxas = {k: v for k, v in report['phases']['card_build'].get('ptxas', {}).items() if shape.search(k)}
        producers = {b: kp.uses_producer(b, kc_, which) for b in (B_MAIN, B_LARGE)}
        return {'ms_large': by_p[B_LARGE][producers[B_LARGE]], 'B_large': B_LARGE, 'producers': producers,
                'wide_batch': kp.WIDE_BATCH, 'ms_by_producers': by_p, 'layout': kp.split_layout(),
                'consumer_sass': sass_cycle_counts(build.build_info['path'], kernel), 'ptxas_both_roles': ptxas}

    def large_state(cfg, prm, steps=True):
        """A B_LARGE-env state as the B_MAIN phases build theirs."""
        state = planted_state(P, cfg, prm, B_LARGE, gen)
        if steps:
            state.steps = torch.randint(0, cfg.max_episode_steps, (B_LARGE,), generator=gen, device=dev,
                                        dtype=torch.int32)
        return P.state_to_planes(state)

    def large_modes(n_noise):
        u = torch.rand((n_noise, B_LARGE), generator=gen, device=dev)
        return (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, B_LARGE)))

    def check_large_autoreset(kc_, st, act, emit=False) -> dict:
        """Kernel C (C-feat with ``emit``) at B_LARGE through the wrapper's
        own block shape, in both noise modes, against its plain version: the
        flags (wall, stalled, trials) equal for every env, the planes at the
        plane-class tolerances except that an env which hit the wall in this
        step may latch it one control cycle apart (the noisy wall check's
        last-ulp rounding at a crossing decides the cycle) on at most 0.1% of
        the envs; the feature blocks its own planes and, on the envs that
        agree, within feat_rtol/feat_atol."""
        res = {'B': B_LARGE, 'producers': kp.uses_producer(B_LARGE, kc_)}
        for mode, uk, seed, uref in large_modes(kp.autoreset_noise_planes(kc_.num_cycles, kc_.cand_k, kc_.box)):
            got = kp.pushing_autoreset_cuda(st, act, kc_, uk, seed, emit)
            ref = kp.pushing_autoreset_plain(st, act, kc_, uref, emit)
            if emit:
                (got, feat), (ref, ref_feat) = got, ref
                require(torch.equal(feat, kp.features_from_planes(st, got)),
                        f'B={B_LARGE} {mode}: the blocks are not the launch\'s own planes')
            require(torch.equal(got[33:36], ref[33:36]), f'B={B_LARGE} {mode}: wall, stalled or trials differ')
            env_ok = torch.ones(B_LARGE, dtype=torch.bool, device=dev)
            for i in range(got.shape[0]):
                rtol, atol = plane_tol(i)
                env_ok &= (got[i] - ref[i]).abs() <= atol + rtol * ref[i].abs()
            latched = int((~env_ok).sum())
            require(bool((got[33][~env_ok] > 0).all()), f'B={B_LARGE} {mode}: an env that hit no wall disagrees')
            require(latched <= 1e-3 * B_LARGE, f'B={B_LARGE} {mode}: {latched} envs latch the wall apart')
            if emit:
                err_feat, ok_feat = compare(feat[..., env_ok], ref_feat[..., env_ok], feat_rtol, feat_atol)
                require(ok_feat, f'B={B_LARGE} {mode}: feature blocks disagree: {err_feat}')
                res[f'max_abs_err_features_{mode}'] = err_feat
            res[f'max_abs_err_{mode}'] = float((got[:, env_ok] - ref[:, env_ok]).abs().max())
            res[f'wall_latch_envs_{mode}'] = latched
            res[f'restarts_{mode}'] = int(((got[18] == 0) & (st[18] > 0)).sum())
        return res

    def check_large_rollout(kc_, st) -> dict:
        """Kernel D at B_LARGE over K_LARGE_CHECK steps through the wrapper's
        own block shape, in both noise modes, against its plain version: the
        envs whose signals are equal and whose state agrees at the plane
        tolerances x10, at least 99%."""
        acts = ((torch.rand((K_LARGE_CHECK, 2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        rtol = torch.tensor([plane_tol(i)[0] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        atol = torch.tensor([plane_tol(i)[1] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        n = K_LARGE_CHECK * kp.autoreset_noise_planes(kc_.num_cycles, kc_.cand_k, kc_.box)
        res = {'B': B_LARGE, 'K': K_LARGE_CHECK, 'producers': kp.uses_producer(B_LARGE, kc_, 'rollout')}
        for mode, uk, seed, uref in large_modes(n):
            got_st, got_sig = kp.pushing_rollout_cuda(st, acts, kc_, uk, seed)
            ref_st, ref_sig = kp.pushing_rollout_plain(st, acts, kc_, uref)
            require(bool(torch.isfinite(got_st).all()), f'B={B_LARGE} {mode}: kernel D state is not finite')
            d_state = (got_st - ref_st).abs()
            env_ok = (d_state <= atol + rtol * ref_st.abs()).all(0) & (got_sig == ref_sig).all(0).all(0)
            frac = float(env_ok.double().mean())
            require(frac >= 0.99, f'B={B_LARGE} {mode}: only {frac:.4f} of envs agree over {K_LARGE_CHECK} steps')
            res[mode] = {'envs_agreeing': frac, 'max_abs_err_agreeing_envs': float(d_state[:, env_ok].max()),
                         'wall_hits': int((got_sig[0] > 0.5).sum())}
        return res

    def cycles_shapes(kc_, planes, planes_l) -> dict:
        """Kernel B (``kc_``'s shape) in both block shapes (with the producer
        warp, 1, and without, 0) and both noise modes against its plain
        version, at B_MAIN-env ``planes`` and B_LARGE-env ``planes_l``: the
        wall flags equal for every env and every plane at its class tolerance,
        except at B_LARGE that an env which hit the wall may latch it one
        control cycle apart on at most 0.1% of the envs (as kernel C there);
        the profiler's device ms a launch (Philox) in both shapes at both
        widths; and the SASS instructions a control cycle of the consumer's,
        the producer's and the thread-per-env loop (the acc Philox
        instantiation)."""
        res = {'wide_batch': kp.WIDE_BATCH['box' if kc_.box else 'circle']['cycles'], 'device_ms': {},
               'producer': {}}
        for pl in (planes, planes_l):
            b = pl.shape[1]
            u = torch.rand((kp.cycles_noise_planes(kc_.num_cycles, kc_.box), b), generator=gen, device=dev)
            n_noise = u.shape[0]
            for mode, uk, seed, uref in (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, b))):
                ref = kp.pushing_cycles_plain(pl, kc_, uref)
                for producer in (0, 1):
                    got = with_producer(producer, lambda: kp.pushing_cycles_cuda(pl, kc_, uk, seed))
                    tag = f'B={b} {mode}, producer {producer}'
                    require(torch.equal(got[16], ref[16]), f'{tag}: wall flags differ in '
                                                           f'{int((got[16] != ref[16]).sum())} envs')
                    env_ok = torch.ones(b, dtype=torch.bool, device=dev)
                    for i in range(got.shape[0]):
                        rtol, atol = plane_tol(i)
                        env_ok &= (got[i] - ref[i]).abs() <= atol + rtol * ref[i].abs()
                    latched = int((~env_ok).sum())
                    require(bool(torch.isfinite(got).all()), f'{tag}: kernel B output is not finite')
                    require(latched == 0 if b == B_MAIN else latched <= 1e-3 * b, f'{tag}: {latched} envs disagree')
                    require(bool((got[16][~env_ok] > 0).all()), f'{tag}: an env that hit no wall disagrees')
                    res[f'{mode}_B={b}_producer_{producer}'] = {
                        'max_abs_err': float((got[:, env_ok] - ref[:, env_ok]).abs().max()),
                        'wall_hits': int((got[16] > 0).sum()), 'wall_latch_envs': latched}
            res['device_ms'][b] = {p: launch_device_ms(lambda p=p: with_producer(
                p, lambda: kp.pushing_cycles_cuda(pl, kc_, None, 7)), 100) for p in (0, 1)}
            res['producer'][b] = kp.uses_producer(b, kc_, 'cycles')
        path, kernel = build.build_info['path'], f'pushing_cycles_kernelILb0ELb{int(kc_.box)}ELb0E'
        res['sass'] = {
            'consumer': sass_cycle_counts(path, kernel, where=pops(8 if kc_.box else 4)),
            'producer': sass_cycle_counts(path, kernel, box_muller_marker, 4 if kc_.box else 2,
                                          where=lambda loop: not any(friction_marker(o, a) for o, a in loop)),
            'thread_per_env': sass_cycle_counts(path, kernel, where=pops(0))}
        return res

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
        n_noise = kp.cycles_noise_planes(kc.num_cycles)
        got_p = kp.pushing_cycles_cuda(planes, kc, None, 7)
        err_p, bad_p, _ = plane_compare(got_p, kp.pushing_cycles_plain(planes, kc, philox(7, n_noise, B_MAIN)))
        require(not bad_p, f'Philox mode: planes {bad_p} disagree')
        injected_ms = time_ms(lambda: kp.pushing_cycles_cuda(planes, kc, u), 20)
        plain_ms = time_ms(lambda: kp.pushing_cycles_plain(planes, kc, u), 3)
        ms = time_ms(lambda: kp.pushing_cycles_cuda(planes, kc, None, 7), 20)
        ops = ops_total((B_MAIN * kc.num_cycles, 'pushing_cycle'))
        bound_ms, bound_by = bound((18 + 17) * 4 * B_MAIN, ops)
        state_l = planted_state(P, config, params, B_LARGE, gen)
        act_l = (torch.rand((2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0
        shapes = cycles_shapes(kc, planes, torch.cat([P.state_to_planes(state_l)[:16], act_l]).contiguous())
        kstats['pushing_cycles'].update(max_abs_err=max(err, err_p, *(v['max_abs_err'] for k, v in shapes.items()
                                                                      if k.startswith(('injected', 'philox')))),
                                        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        return {'max_abs_err': err, 'max_abs_err_philox': err_p, 'per_plane': errs, 'object_moved': moved,
                'ms': ms, 'bound_ms': bound_ms, 'bound_by': bound_by, 'plain_ms': plain_ms,
                'injected_ms': injected_ms, 'injected_bound_ms': bound((18 + n_noise + 17) * 4 * B_MAIN, ops)[0],
                'bound_ms_large': bound((18 + 17) * 4 * B_LARGE, ops * B_LARGE / B_MAIN)[0], 'shapes': shapes}

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
        n_noise = kp.autoreset_noise_planes(kc.num_cycles, kc.cand_k)
        got_p = kp.pushing_autoreset_cuda(st, act, kc, None, 7)
        err_p, bad_p, _ = plane_compare(got_p, kp.pushing_autoreset_plain(st, act, kc, philox(7, n_noise, B_MAIN)))
        require(not bad_p, f'Philox mode: planes {bad_p} disagree')
        injected_ms = time_ms(lambda: kp.pushing_autoreset_cuda(st, act, kc, u), 20)
        plain_ms = time_ms(lambda: kp.pushing_autoreset_plain(st, act, kc, u), 3)
        ms = time_ms(lambda: kp.pushing_autoreset_cuda(st, act, kc, None, 7), 20)
        ops = B_MAIN * pushing_step_ops()
        bound_ms, bound_by = bound((21 + 36) * 4 * B_MAIN, ops)
        kstats['pushing_autoreset'].update(max_abs_err=max(err, err_p), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by)
        st_l = large_state(config, params)
        act_l = ((torch.rand((2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        large = check_large_autoreset(kc, st_l, act_l)
        split = split_report(lambda s_, a_: kp.pushing_autoreset_cuda(s_, a_, kc, None, 7), (st, act), (st_l, act_l),
                             'pushing_autoreset_kernelILb0ELb0ELb0ELb0E', kc)
        return {'large': large, 'max_abs_err': err, 'max_abs_err_philox': err_p, 'per_plane': errs, 'restarts': restarts,
                'ms': ms, 'bound_ms': bound_ms, 'bound_by': bound_by, 'plain_ms': plain_ms,
                'injected_ms': injected_ms, 'injected_bound_ms': bound((21 + n_noise + 36) * 4 * B_MAIN, ops)[0],
                'bound_ms_large': bound((21 + 36) * 4 * B_LARGE, B_LARGE * pushing_step_ops())[0], **split}

    @phase('kernel_D_pushing_rollout')
    def _():
        state = planted_state(P, config, params, B_MAIN, gen)
        st = P.state_to_planes(state)
        acts = ((torch.rand((K_MAIN, 2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        n = K_MAIN * kp.autoreset_noise_planes(kc.num_cycles, kc.cand_k)
        u = torch.rand((n, B_MAIN), generator=gen, device=dev)
        rtol = torch.tensor([plane_tol(i)[0] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        atol = torch.tensor([plane_tol(i)[1] for i in range(kp.N_STATE)], device=dev)[:, None] * 10

        def agreement(got_st, got_sig, ref_st, ref_sig):
            # over K steps of chaotic contact, ulp differences can grow and
            # flip a wall check; count the envs whose whole trajectory agrees
            # (the per-step plane tolerances, x10 for the K steps)
            require(bool(torch.isfinite(got_st).all()), 'kernel D state is not finite')
            d_state = (got_st - ref_st).abs()
            env_ok = ((d_state <= atol + rtol * ref_st.abs()).all(0) & (got_sig == ref_sig).all(0).all(0))
            frac = float(env_ok.double().mean())
            require(frac >= 0.99, f'only {frac:.4f} of envs agree over {K_MAIN} steps')
            err_ok = float(d_state[:, env_ok].max()) if env_ok.any() else float('inf')
            return frac, err_ok, float(d_state.max())

        got_st, got_sig = kp.pushing_rollout_cuda(st, acts, kc, u)
        frac, err_ok, err = agreement(got_st, got_sig, *kp.pushing_rollout_plain(st, acts, kc, u))
        frac_p, err_ok_p, _ = agreement(*kp.pushing_rollout_cuda(st, acts, kc, None, 7),
                                        *kp.pushing_rollout_plain(st, acts, kc, philox(7, n, B_MAIN)))
        injected_ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kc, u), 5)
        plain_ms = time_ms(lambda: kp.pushing_rollout_plain(st, acts, kc, u), 1, warmup=0)
        ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kc, None, 7), 5)
        ops = K_MAIN * B_MAIN * pushing_step_ops()
        bound_ms, bound_by = bound((19 + K_MAIN * (2 + 3) + 19) * 4 * B_MAIN, ops)
        kstats['pushing_rollout'].update(max_abs_err=max(err_ok, err_ok_p), ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by)
        st_l = large_state(config, params, steps=False)
        large = check_large_rollout(kc, st_l)
        acts_l = ((torch.rand((K_MAIN, 2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        split = split_report(lambda s_, a_: kp.pushing_rollout_cuda(s_, a_, kc, None, 7), (st, acts), (st_l, acts_l),
                             'pushing_rollout_kernelILb0ELb0ELb0E', kc, 'rollout', grouped=False)
        return {'K': K_MAIN, 'large': large, **split, 'envs_agreeing': frac, 'envs_agreeing_philox': frac_p,
                'bound_ms_large': bound((19 + K_MAIN * (2 + 3) + 19) * 4 * B_LARGE,
                                        K_MAIN * B_LARGE * pushing_step_ops())[0],
                'max_abs_err_agreeing_envs': err_ok, 'max_abs_err_agreeing_envs_philox': err_ok_p,
                'max_abs_err_all_envs': err,
                'restarts_kernel': int((got_sig[2] > 0.5).sum() + (got_sig[0] > 0.5).sum()),
                'ms': ms, 'bound_ms': bound_ms, 'bound_by': bound_by, 'plain_ms': plain_ms,
                'injected_ms': injected_ms, 'injected_bound_ms': bound((19 + K_MAIN * (2 + n // K_MAIN + 3) + 19) * 4
                                                                       * B_MAIN, ops)[0]}

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

        require(all(launches[k] > 0 for k in PUSHING_KERNELS), f'a kernel of the path never launched: {launches}')
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
            # kernels C and D run one consumer step: the same bits
            require(torch.equal(a, b), f'K={K_MAIN} vs K=1 {name}: not bit-equal (max {e})')
        contact = float((r1[0].obj_pos - s0.obj_pos)[live].abs().max())
        require(contact > 1e-5, 'contact never moved an object in the K comparison')
        return {'launches': launches, 'rollouts': checks, 'k32_vs_k1_live_envs': int(live.sum()),
                'k32_vs_k1_max_abs_err': errs, 'tol': 'bit-equal (and rtol 3e-5 atol 3e-6)'}

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
                t_p = time_ms(lambda plain=plain: plain(state, acts[:T_PLAIN], 3), 1, warmup=0)
                rates[f'B={b},K={K}'] = {
                    'kernel_ms': t_k, 'plain_ms': t_p,
                    'kernel_env_steps_per_s': b * T_ROLL / (t_k / 1e3),
                    'plain_env_steps_per_s': b * T_PLAIN / (t_p / 1e3),
                }
        return {'T': T_ROLL, 'T_plain': T_PLAIN, 'card': card, 'rates': rates}

    # -- 6. planning kernels E, F, G -------------------------------------------
    import numpy as np

    from gymnasium_planar_robotics_tpu_torch.models import planning as PL
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning as kpl

    box_coll = {'shape': 'box', 'size': np.array([0.09, 0.08])}
    # the main configuration first: circle on the full 3x3 table (the JAX
    # package's planning bench, bench.py:213, :262)
    plan_configs = {
        'circle_full': (np.ones((3, 3)), {}),
        'circle_holed': (np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]]), {}),
        'box_full': (np.ones((3, 3)), box_coll),
        'box_holed': (np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]]), box_coll),
    }
    # kernel vs plain: the kernels round each operation as the plain
    # versions' eager ops do, so flags, steps and trials must be equal and
    # the other planes agree to rtol 1e-6 / atol 1e-7 (in practice exactly)
    plan_rtol, plan_atol = 1e-6, 1e-7

    def plan_env(name, **kw):
        layout, coll = plan_configs[name]
        return PL.make_planning_env(layout, 1, collision_params=coll, device=dev, **kw)

    def wall_state(cfg, prm, b, seed, spread_steps=False):
        """init_batch; a quarter of the envs at the +x edge moving out at
        1 m/s (wall hits), every 8th about to truncate."""
        g = torch.Generator(device=dev).manual_seed(seed)
        state, _, _ = PL.init_batch(cfg, prm, b, g)
        q = b // 4
        state.pos[:q, 0, 0] = torch.linspace(0.56, 0.62, q, device=dev)
        state.vel[:q, 0] = torch.tensor([1.0, 0.1], device=dev)
        if spread_steps:
            state.steps = torch.randint(0, cfg.max_episode_steps, (b,), generator=g, device=dev, dtype=torch.int32)
        state.steps[::8] = cfg.max_episode_steps - 1
        return state

    def planes_check(got, ref, exact):
        """(largest |err| over the non-flag planes, planes that disagree)."""
        errs, bad = [], []
        for i in range(got.shape[0]):
            if i in exact:
                if not torch.equal(got[i], ref[i]):
                    bad.append(i)
                continue
            e, ok = compare(got[i], ref[i], plan_rtol, plan_atol)
            errs.append(e)
            if not ok:
                bad.append(i)
        return max(errs), bad

    def plan_step_ops(kc, candidates: float) -> float:
        """f32 operations of one autoreset step over the batch: every env
        runs the cycles and the observations; ``candidates`` start and goal
        candidates are tested in all (this run's data: done envs only)."""
        cycle = planning_cycle_ops(kc.box, kc.rule.full, kc.learn_jerk)
        per_env = ops_total(*[(kc.num_cycles * n, name) for n, name in cycle], (1, 'planning_step_extra'))
        holed = [] if kc.rule.full else [(1, 'planning_holed_extra_box' if kc.box else 'planning_holed_extra_circle')]
        cand = ops_total((1, 'planning_candidate_box' if kc.box else 'planning_candidate_circle'), *holed)
        return per_env * B_MAIN + cand * candidates

    # kernels E, F and G launch blocks with the producer up to their
    # configuration's kpl.WIDE_BATCH envs and thread-per-env blocks above:
    # both shapes are held against the plain versions at B_MAIN and B_LARGE
    # (every configuration for F, the full layouts for E and G; G's plain
    # rollout on a holed table is the costly part) and timed at both widths
    plan_widths = {name: (B_MAIN, B_LARGE) if name.endswith('full') else (B_MAIN,) for name in plan_configs}

    def plan_modes(n_noise, b):
        u = torch.rand((n_noise, b), generator=gen, device=dev)
        return u, (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, b)))

    def plan_split_report(kernel: str, box: bool) -> dict:
        """The SASS of kernel E's, F's or G's circle or box, full-layout, Philox
        instantiations: instructions per control cycle in the consumer's
        loop (a cycle's values popped from the ring), in the producer's and
        in the thread-per-env loop (normal pairs drawn), and their ``ptxas
        -v``."""
        path, q = build.build_info['path'], 8 if box else 4
        inst = {p: f'{kernel}ILb{int(box)}ELb1ELb0ELb{p}E' for p in (0, 1)}
        ptxas = {k: v for k, v in report['phases']['card_build'].get('ptxas', {}).items()
                 if any(i in k for i in inst.values())}
        return {'consumer': sass_cycle_counts(path, inst[1], shared_load_marker, q, where=pops(q)),
                'producer': sass_cycle_counts(path, inst[1], box_muller_marker, q // 2),
                'thread_per_env': sass_cycle_counts(path, inst[0], box_muller_marker, q // 2), 'ptxas': ptxas}

    @phase('kernel_E_planning_cycles')
    def _():
        res = {}
        for name in plan_configs:
            jerk = name.startswith('box')
            cfg, prm = plan_env(name, learn_jerk=jerk)
            kc = kpl.make_kernel_consts(cfg, prm)
            n_noise = kpl.cycles_noise_planes(cfg.num_cycles, kc.box)
            entry = {'jerk': jerk, 'max_abs_err': 0.0, 'wall_hits': {}, 'device_ms': {}, 'producer': {}}
            # both block shapes (with the producer warps, 1, and thread-per-env, 0) at B_MAIN, and on the full
            # layouts at B_LARGE too
            for b in (B_MAIN, B_LARGE) if name.endswith('full') else (B_MAIN,):
                state = wall_state(cfg, prm, b, 10)
                act = (torch.rand((2, b), generator=gen, device=dev) * 2 - 1) * (100.0 if jerk else 10.0)
                planes = torch.cat([PL.state_to_planes(cfg, state)[:6], act]).contiguous()
                u, modes = plan_modes(n_noise, b)
                for mode, uk, seed, uref in modes:
                    ref = kpl.planning_cycles_plain(planes, kc, uref)
                    for producer in (0, 1):
                        got = with_producer(producer, lambda: kpl.planning_cycles_cuda(planes, kc, uk, seed), kpl)
                        e, bad = planes_check(got, ref, exact=(6,))
                        walls = int((got[6] > 0).sum())
                        tag = f'{name} B={b} ({mode}, producer {producer})'
                        require(not bad, f'{tag}: planes {bad} disagree')
                        require(0 < walls < b, f'{tag}: {walls} wall hits')
                        entry['max_abs_err'] = max(entry['max_abs_err'], e)
                    entry['wall_hits'][mode if b == B_MAIN else f'{mode}_B={b}'] = walls
                # the profiler's kernel records: a launch of E is shorter than the host's enqueue of it
                entry['device_ms'][b] = {p: launch_device_ms(lambda p=p: with_producer(
                    p, lambda: kpl.planning_cycles_cuda(planes, kc, None, 7), kpl), 100) for p in (0, 1)}
                entry['producer'][b] = kpl.uses_producer(b, kc, 'cycles')
                if b != B_MAIN:
                    continue
                injected_ms, _ = time_groups(lambda: kpl.planning_cycles_cuda(planes, kc, u))
                ms, ms_groups = time_groups(lambda: kpl.planning_cycles_cuda(planes, kc, None, 7))
                plain_ms = time_ms(lambda: kpl.planning_cycles_plain(planes, kc, u), 1)
                ops = ops_total(*[(B_MAIN * cfg.num_cycles * n, nm) for n, nm in planning_cycle_ops(
                    kc.box, kc.rule.full, jerk)])
                bound_ms, bound_by = bound((8 + 7) * 4 * B_MAIN, ops)
                entry.update(ms=ms, ms_groups=ms_groups, ms_spread=spread(ms_groups), bound_ms=bound_ms,
                             bound_by=bound_by, plain_ms=plain_ms, injected_ms=injected_ms,
                             injected_bound_ms=bound((8 + n_noise + 7) * 4 * B_MAIN, ops)[0])
            if name.endswith('full'):
                entry['sass'] = plan_split_report('planning_cycles_kernel', kc.box)
            res[name] = entry
        main = res['circle_full']
        kstats['planning_cycles'].update(max_abs_err=max(r['max_abs_err'] for r in res.values()), ms=main['ms'],
                                         plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                                         bound_by=main['bound_by'])
        return {'B': B_MAIN, 'B_large': B_LARGE, 'tol': f'flags exact, planes rtol {plan_rtol} atol {plan_atol}',
                'modes': 'injected uniforms; Philox seed 7 against the plain version on its host copy',
                'wide_batch_E': {' '.join(k): v['cycles'] for k, v in kpl.WIDE_BATCH.items()},
                'block_shapes': 'thread-per-env (0) and the consumer with its producer warps (1), both held '
                                'against the plain versions; device_ms: Philox, the profiler\'s ms a launch',
                'configs': res}

    @phase('kernel_F_planning_autoreset')
    def _():
        res = {}
        for name in plan_configs:
            jerk = name.endswith('holed')
            cfg, prm = plan_env(name, learn_jerk=jerk)
            kc = kpl.make_kernel_consts(cfg, prm)
            n_noise = kpl.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box)
            entry = {'jerk': jerk, 'max_abs_err': 0.0, 'ms_by_producers': {}}
            for b in (B_MAIN, B_LARGE):
                state = wall_state(cfg, prm, b, 11, spread_steps=True)
                act = ((torch.rand((2, b), generator=gen, device=dev) * 2 - 1) * (100.0 if jerk else 10.0))
                act = act.contiguous()
                st = PL.state_to_planes(cfg, state)
                u, modes = plan_modes(n_noise, b)
                for mode, uk, seed, uref in modes:
                    ref = kpl.planning_autoreset_plain(st, act, kc, uref)
                    for producer in (0, 1):
                        got = with_producer(producer, lambda: kpl.planning_autoreset_cuda(st, act, kc, uk, seed), kpl)
                        e, bad = planes_check(got, ref, exact=(8, 19, 20, 21, 22))
                        restarts = int(((got[8] == 0) & (st[8] > 0)).sum())
                        walls = int((got[19] > 0).sum())
                        tag = f'{name} B={b} ({mode}, producer {producer})'
                        require(not bad, f'{tag}: planes {bad} disagree')
                        require(restarts > 0 and walls > 0, f'{tag}: {restarts} restarts, {walls} wall hits')
                        entry['max_abs_err'] = max(entry['max_abs_err'], e)
                    entry[mode if b == B_MAIN else f'{mode}_B={b}'] = {
                        'restarts': restarts, 'wall_hits': walls, 'stalled': int(got[21].sum()),
                        'candidates_tested': int(got[22].sum())}
                if name.endswith('full'):
                    # the profiler's kernel records: a launch of F is shorter than the host's enqueue of it
                    entry['ms_by_producers'][b] = {p: launch_device_ms(lambda p=p: with_producer(
                        p, lambda: kpl.planning_autoreset_cuda(st, act, kc, None, 7), kpl), 100) for p in (0, 1)}
                if b != B_MAIN:
                    continue
                injected_ms, _ = time_groups(lambda: kpl.planning_autoreset_cuda(st, act, kc, u))
                ms, ms_groups = time_groups(lambda: kpl.planning_autoreset_cuda(st, act, kc, None, 7))
                entry['device_ms'] = launch_device_ms(lambda: kpl.planning_autoreset_cuda(st, act, kc, None, 7), 100)
                plain_ms = time_ms(lambda: kpl.planning_autoreset_plain(st, act, kc, u), 1)
                bound_ms, bound_by = bound((11 + 23) * 4 * B_MAIN,
                                           plan_step_ops(kc, entry['philox']['candidates_tested']))
                entry.update(ms=ms, ms_groups=ms_groups, ms_spread=spread(ms_groups), bound_ms=bound_ms,
                             bound_by=bound_by, plain_ms=plain_ms, injected_ms=injected_ms,
                             injected_bound_ms=bound((11 + n_noise + 23) * 4 * B_MAIN,
                                                     plan_step_ops(kc, entry['injected']['candidates_tested']))[0])
            if name.endswith('full'):
                entry['sass'] = plan_split_report('planning_autoreset_kernel', kc.box)
            entry['producer'] = {b: kpl.uses_producer(b, kc) for b in (B_MAIN, B_LARGE)}
            res[name] = entry
        main = res['circle_full']
        kstats['planning_autoreset'].update(max_abs_err=max(r['max_abs_err'] for r in res.values()), ms=main['ms'],
                                            plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                                            bound_by=main['bound_by'])
        return {'B': B_MAIN, 'B_large': B_LARGE, 'tol': f'flags exact, planes rtol {plan_rtol} atol {plan_atol}',
                'modes': 'injected uniforms; Philox seed 7 against the plain version on its host copy',
                'wide_batch_F_G': {' '.join(k): v for k, v in kpl.WIDE_BATCH.items()},
                'block_shapes': 'thread-per-env (0) and the consumer with its producer warps (1), both held '
                                'against the plain versions; ms_by_producers and device_ms: Philox, the '
                                'profiler\'s ms a launch',
                'configs': res}

    @phase('kernel_G_planning_rollout')
    def _():
        res = {}
        def episode_ends(sig):
            return int(((sig[0] > 0.5) | (sig[1] > 0.5) | (sig[2] > 0.5)).sum())

        for name in plan_configs:
            cfg, prm = plan_env(name)
            kc = kpl.make_kernel_consts(cfg, prm)
            n_noise = kpl.autoreset_noise_planes(cfg.num_cycles, kc.cand_k, kc.box)
            entry = {'max_abs_err': 0.0, 'ms_by_producers': {}}
            for b in plan_widths[name]:
                st = PL.state_to_planes(cfg, wall_state(cfg, prm, b, 12))
                acts = ((torch.rand((K_MAIN, 2, b), generator=gen, device=dev) * 2 - 1) * 10.0).contiguous()
                # the plain rollout is the phase's cost: K_G_CHECK steps
                # (K_LARGE_CHECK at B_LARGE), but the main configuration's
                # Philox mode (the timed run) K_MAIN
                k_check = K_G_CHECK if b == B_MAIN else K_LARGE_CHECK
                k_philox = K_MAIN if name == 'circle_full' and b == B_MAIN else k_check
                u = torch.rand(((K_MAIN if b == B_MAIN else k_check) * n_noise, b), generator=gen, device=dev)
                for mode, k, u_k, seed in (('injected', k_check, u[:k_check * n_noise], 0),
                                           ('philox', k_philox, philox(7, k_philox * n_noise, b), 7)):
                    a = acts[:k]
                    ref_st, ref_sig = kpl.planning_rollout_plain(st, a, kc, u_k)
                    for producer in (0, 1):
                        got_st, got_sig = with_producer(producer, lambda: kpl.planning_rollout_cuda(
                            st, a, kc, None if seed else u_k, seed), kpl)
                        d_state = (got_st - ref_st).abs()
                        env_ok = ((d_state <= plan_atol + plan_rtol * ref_st.abs()).all(0)
                                  & (got_sig == ref_sig).all(0).all(0))
                        frac = float(env_ok.double().mean())
                        tag = f'{name} B={b} ({mode}, producer {producer})'
                        require(bool(torch.isfinite(got_st).all()), f'{tag}: kernel G state is not finite')
                        require(frac >= 0.99, f'{tag}: only {frac:.4f} of envs agree over {k} steps')
                        entry['max_abs_err'] = max(entry['max_abs_err'], float(d_state.max()))
                    entry[mode if b == B_MAIN else f'{mode}_B={b}'] = {'k': k, 'envs_agreeing': frac,
                                                                        'episode_ends': episode_ends(got_sig)}
                if name.endswith('full'):
                    entry['ms_by_producers'][b] = {p: statistics.median(time_ms(lambda p=p: with_producer(
                        p, lambda: kpl.planning_rollout_cuda(st, acts, kc, None, 7), kpl), 5) for _ in range(3))
                        for p in (0, 1)}
                if name == 'circle_full' and b == B_MAIN:
                    entry['injected']['episode_ends_k_main'] = episode_ends(
                        kpl.planning_rollout_cuda(st, acts, kc, u)[1])
                    injected_ms = time_ms(lambda: kpl.planning_rollout_cuda(st, acts, kc, u), 5)
                    ms = time_ms(lambda: kpl.planning_rollout_cuda(st, acts, kc, None, 7), 5)
                    plain_ms = time_ms(lambda: kpl.planning_rollout_plain(st, acts, kc, u), 1, warmup=0)

                    def ops(ends):
                        # a floor: each episode end tests at least one start and one goal candidate
                        return (K_MAIN - 1) * plan_step_ops(kc, 0.0) + plan_step_ops(kc, 2.0 * ends)

                    bound_ms, bound_by = bound((9 + K_MAIN * (2 + 3) + 9) * 4 * B_MAIN,
                                               ops(entry['philox']['episode_ends']))
                    entry.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
                                 injected_ms=injected_ms,
                                 injected_bound_ms=bound((9 + K_MAIN * (2 + n_noise + 3) + 9) * 4 * B_MAIN,
                                                         ops(entry['injected']['episode_ends_k_main']))[0])
                    kstats['planning_rollout'].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            if name.endswith('full'):
                entry['sass'] = plan_split_report('planning_rollout_kernel', kc.box)
            entry['producer'] = {b: kpl.uses_producer(b, kc, 'rollout') for b in (B_MAIN, B_LARGE)}
            res[name] = entry
        kstats['planning_rollout'].update(max_abs_err=max(r['max_abs_err'] for r in res.values()))
        return {'B': B_MAIN, 'B_large': B_LARGE, 'K': K_MAIN,
                'tol': f'signals exact, state rtol {plan_rtol} atol {plan_atol}',
                'modes': 'injected uniforms; Philox seed 7 against the plain version on its host copy',
                'wide_batch_F_G': {' '.join(k): v for k, v in kpl.WIDE_BATCH.items()},
                'block_shapes': 'thread-per-env (0) and the consumer with its producer warps (1), both held '
                                'against the plain versions; ms_by_producers: Philox, K=32, ms a launch',
                'configs': res}

    # -- 7. the public planning path ----------------------------------------------
    def far_goals(state):
        """Goals in the sampling box's corner farthest from each start."""
        state.goals = torch.where(state.pos < 0.36, 0.6, 0.12).to(state.pos.dtype)
        return state

    @phase('planning_main_path')
    def _():
        cfg, prm = PL.make_planning_env(np.ones((3, 3)), 1, device=dev)
        g = torch.Generator(device=dev).manual_seed(3)
        kernels.reset_launches()
        state, obs, info = PL.init_batch(cfg, prm, B_MAIN, g)
        step = PL.make_fused_step(cfg, prm)
        s = state
        for _ in range(3):
            s, o, r, te, tr, inf = step(s, torch.full((B_MAIN, 2), 3.0, device=dev), generator=g)
        step_ar = PL.make_fused_step_autoreset(cfg, prm)
        s = state
        rewards = []
        for _ in range(5):
            a = (torch.rand((B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
            s, o, r, te, tr, inf = step_ar(s, a, generator=g)
            rewards.append(r)
        acts = (torch.rand((T_ROLL, B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
        outs = {K: PL.make_fused_rollout(cfg, prm, steps_per_launch=K)(s, acts, 100 + K) for K in (1, K_MAIN)}
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)

        require(all(launches[k] > 0 for k in PLANNING_KERNELS), f'a kernel of the path never launched: {launches}')
        require(bool(~info['reset_stalled'].any()), 'init_batch stalled')
        require(set(torch.cat(rewards).unique().tolist()) <= {50.0, -50.0, -1.0}, 'per-step rewards')
        checks = {}
        for K, (fs, rew, term, trunc) in outs.items():
            for name in ('pos', 'vel', 'acc', 'goals'):
                require(bool(torch.isfinite(getattr(fs, name)).all()), f'K={K}: {name} not finite')
            require(set(torch.unique(rew).tolist()) <= {50.0, -50.0, -1.0}, f'K={K}: rewards {torch.unique(rew)}')
            speed = torch.linalg.vector_norm(fs.vel, dim=-1)
            require(float(speed.max()) <= float(prm.v_max) * 1.01, f'K={K}: |v| {float(speed.max())}')
            require(bool(((fs.pos >= 0.0) & (fs.pos <= 0.72)).all()), f'K={K}: mover off the table')
            require(bool(((fs.goals >= prm.min_xy) & (fs.goals <= prm.max_xy)).all()), f'K={K}: goal')
            require(bool(((fs.steps >= 0) & (fs.steps <= cfg.max_episode_steps)).all()), f'K={K}: steps')
            require(bool((term | trunc).any()), f'K={K}: no episode ended in {T_ROLL} steps')
            checks[K] = {'terminations': int(term.sum()), 'truncations': int(trunc.sum()),
                         'successes': int((rew == 50.0).sum()), 'wall_hits': int((rew == -50.0).sum()),
                         'reward_mean': float(rew.mean())}

        # K=32 against K=1 at std_noise=0 on envs that never restart: 40
        # steps (one chunk of 32 + a tail of 8) of a cosine drive, whose
        # swing from rest is bounded, toward far goals
        cfg0, prm0 = PL.make_planning_env(np.ones((3, 3)), 1, std_noise=0.0, device=dev)
        s0 = far_goals(PL.init_batch(cfg0, prm0, B_MAIN, g)[0])
        T0 = 40
        ph = 2 * torch.pi * torch.arange(T0, device=dev) / 20
        a0 = torch.stack([2.0 * torch.cos(ph), -2.0 * torch.cos(ph)], -1)[:, None].expand(T0, B_MAIN, 2)
        r1 = PL.make_fused_rollout(cfg0, prm0, steps_per_launch=1)(s0, a0, 5)
        r32 = PL.make_fused_rollout(cfg0, prm0, steps_per_launch=K_MAIN)(s0, a0, 5)
        live = ~(r1[2].any(0) | r1[3].any(0) | r32[2].any(0) | r32[3].any(0))
        require(int(live.sum()) > B_MAIN // 4, f'too many episode ends: {int(live.sum())} live')
        errs = {}
        for name in ('pos', 'vel', 'acc', 'goals'):
            e, ok = compare(getattr(r32[0], name)[live], getattr(r1[0], name)[live], 3e-5, 3e-6)
            errs[name] = e
            require(ok, f'K={K_MAIN} vs K=1 {name}: {e}')
        return {'launches': launches, 'rollouts': checks, 'k32_vs_k1_live_envs': int(live.sum()),
                'k32_vs_k1_max_abs_err': errs, 'tol': 'bit-equal (and rtol 3e-5 atol 3e-6)'}

    planning_launches = report['phases']['planning_main_path'].get('launches', {})

    # -- 8. planning rollout rate ----------------------------------------------------
    @phase('planning_rollout_rate')
    def _():
        rates = {}
        for b in (B_MAIN, B_LARGE):
            cfg, prm = PL.make_planning_env(np.ones((3, 3)), 1, device=dev)
            g = torch.Generator(device=dev).manual_seed(4)
            state, _, _ = PL.init_batch(cfg, prm, b, g)
            acts = (torch.rand((T_ROLL, b, 2), generator=g, device=dev) * 2 - 1) * 10.0
            kcb = kpl.make_kernel_consts(cfg, prm)
            n_step = kpl.autoreset_noise_planes(cfg.num_cycles, kcb.cand_k, kcb.box)
            rolls = {K: PL.make_fused_rollout(cfg, prm, steps_per_launch=K) for K in (1, K_MAIN)}
            for K in rolls:  # warm-up
                rolls[K](state, acts, 1)
            torch.cuda.synchronize()
            event_ms, host_ms = {1: [], K_MAIN: []}, {1: [], K_MAIN: []}
            for rep in range(5):  # alternating repeats
                for K in (1, K_MAIN):
                    _, ms, host = timed(lambda K=K, rep=rep: rolls[K](state, acts, 3 + rep))
                    event_ms[K].append(ms)
                    host_ms[K].append(host)

            def plain_step(planes, action, seed, n_step=n_step, kcb=kcb, b=b):
                return kpl.planning_autoreset_plain(planes, action, kcb, torch.rand((n_step, b), device=dev))

            def plain_chunk(planes, actions, seed, n_step=n_step, kcb=kcb, b=b):
                u = torch.rand((actions.shape[0] * n_step, b), device=dev)
                return kpl.planning_rollout_plain(planes, actions, kcb, u)

            for K in (1, K_MAIN):
                plain = PL._make_rollout(cfg, prm, K, plain_step, plain_chunk)
                t_p = time_ms(lambda plain=plain: plain(state, acts[:T_PLAIN], 3), 1, warmup=0)
                med = statistics.median(event_ms[K])
                rates[f'B={b},K={K}'] = {
                    'kernel_ms_runs': event_ms[K], 'host_enqueue_ms_runs': host_ms[K], 'kernel_ms_median': med,
                    'kernel_env_steps_per_s': b * T_ROLL / (med / 1e3), 'plain_ms': t_p,
                    'plain_env_steps_per_s': b * T_PLAIN / (t_p / 1e3),
                }
        return {'T': T_ROLL, 'T_plain': T_PLAIN, 'card': card, 'repeats': 5, 'rates': rates}

    # -- 9. kernel H (M-mover planning) ----------------------------------------------
    from gymnasium_planar_robotics_tpu_torch.models import common, multi_agent
    from gymnasium_planar_robotics_tpu_torch.ops import collision
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import planning_multi as kmu

    holed4 = np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 1, 1, 1], [1, 1, 1, 1]])
    lshape = np.array([[1, 1, 0], [1, 1, 1], [0, 1, 1]])
    # name -> (layout, movers, collision params, jerk, cand_k); the main
    # configuration first; the last one is held for parity only (its
    # restarts stall: random sets of 33 movers are almost never accepted)
    multi_configs = {
        'circle_full_m4': (np.ones((4, 4)), M_MAIN, {}, False, 16),
        'box_full_m4': (np.ones((4, 4)), M_MAIN, box_coll, False, 16),
        'circle_holed_m3_jerk': (holed4, 3, {'size': np.array([0.11, 0.14, 0.12])}, True, 16),
        'box_lshape_m2_jerk': (lshape, 2, box_coll, True, 16),
        'circle_full_m12': (np.ones((8, 8)), M_WIDE, {}, False, 128),
        'circle_full_m33': (np.ones((16, 16)), 33, {}, False, 16),
    }

    def multi_env(name, **kw):
        layout, m, coll, jerk, _ = multi_configs[name]
        return PL.make_planning_env(layout, m, collision_params=coll, learn_jerk=jerk, device=dev, **kw)

    def multi_planted(cfg, prm, b, seed):
        """init_batch; envs [0, b/4): mover 0 at the -x wall moving out at
        1 m/s; envs [b/4, b/2): movers 0 and 1 side by side 1 mm apart,
        head-on at 1 m/s each; step counters spread, every 8th about to
        truncate."""
        g = torch.Generator(device=dev).manual_seed(seed)
        state, _, _ = PL.init_batch(cfg, prm, b, g)
        q = b // 4
        hx = prm.c_size.reshape(cfg.num_movers, -1)[:, 0]
        state.pos[:q, 0, 0] = torch.linspace(float(hx[0]) - 0.01, float(hx[0]) + 0.02, q, device=dev)
        state.vel[:q, 0] = torch.tensor([-1.0, 0.1], device=dev)
        state.pos[q:2 * q, 1] = state.pos[q:2 * q, 0] + torch.stack([hx[0] + hx[1] + 1e-3, torch.zeros_like(hx[0])])
        state.vel[q:2 * q, 0] = torch.tensor([1.0, 0.0], device=dev)
        state.vel[q:2 * q, 1] = torch.tensor([-1.0, 0.0], device=dev)
        state.steps = torch.randint(0, cfg.max_episode_steps, (b,), generator=g, device=dev, dtype=torch.int32)
        state.steps[::8] = cfg.max_episode_steps - 1
        return state

    def multi_step_ops(cfg, mc, cycles_run: float, sets_tested: float, b: int = B_MAIN) -> float:
        """f32 operations of one kernel H step over the batch, counted from
        this run's data: ``cycles_run`` control cycles in all (each env's up
        to its latch, from the plain version's ``cycles_run``), every env's
        observations, and ``sets_tested`` candidate sets (done envs only, up
        to the first accepted set)."""
        kc, m = mc.base, cfg.num_movers
        n_pairs = m * (m - 1) // 2
        per_cycle = ops_total(*multi_cycle_terms(m, kc.box, kc.rule.full, kc.learn_jerk))
        per_env = ops_total(*multi_env_terms(m, 0, kc.box, kc.rule.full, kc.learn_jerk))
        holed = [] if kc.rule.full else [(m, 'planning_holed_extra_box' if kc.box else 'planning_holed_extra_circle')]
        per_set = ops_total((m, 'multi_candidate_mover_box' if kc.box else 'multi_candidate_mover_circle'),
                            (n_pairs, 'multi_candidate_pair_box' if kc.box else 'multi_candidate_pair_circle'),
                            *holed)
        return per_cycle * cycles_run + per_env * b + per_set * sets_tested

    def multi_rollout_h(m, b, seed):
        """(config, params, kernel constants, state planes, action planes) of
        kernel H at M movers on a state eight random steps into a rollout
        (``tools/rollout_rates.multi_rollout_state``): the envs kernel H
        sees on the main path."""
        cfg, prm, state = multi_rollout_state(m, b, seed, DEVICE)
        act = ((torch.rand((2 * m, b), generator=gen, device=dev) * 2 - 1) * 10.0).contiguous()
        return cfg, prm, kmu.make_multi_kernel_consts(cfg, prm), PL.state_to_planes(cfg, state), act

    @phase('kernel_H_planning_multi_autoreset')
    def _():
        res = {}
        t_part = {'start': time.perf_counter()}
        for name, (_, _, _, _, cand_k) in multi_configs.items():
            cfg, prm = multi_env(name)
            m = cfg.num_movers
            mc = kmu.make_multi_kernel_consts(cfg, prm, cand_k)
            st = PL.state_to_planes(cfg, multi_planted(cfg, prm, B_MAIN, 13))
            lim = 100.0 if cfg.learn_jerk else 10.0
            act = ((torch.rand((2 * m, B_MAIN), generator=gen, device=dev) * 2 - 1) * lim).contiguous()
            n_noise = kmu.multi_noise_planes(cfg.num_cycles, m, mc.base.cand_k, mc.base.box)
            u = torch.rand((n_noise, B_MAIN), generator=gen, device=dev)
            exact = (8 * m, *range(18 * m + 1, 18 * m + 6))
            entry = {'M': m, 'jerk': cfg.learn_jerk, 'cand_k': cand_k, 'lanes': list(kmu.lane_layout(m, B_MAIN)),
                     'max_abs_err': 0.0}
            for mode, got, ref in (
                    ('injected', kmu.planning_multi_autoreset_cuda(st, act, mc, u),
                     kmu.planning_multi_autoreset_plain(st, act, mc, u)),
                    ('philox', kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7),
                     kmu.planning_multi_autoreset_plain(st, act, mc, philox(7, n_noise, B_MAIN)))):
                e, bad = planes_check(got, ref, exact=exact)
                done = got[18 * m + 5] > 0
                restarts = int(((got[8 * m] == 0) & (st[8 * m] > 0)).sum())
                walls_, movers = int((got[18 * m + 1] > 0).sum()), int((got[18 * m + 2] > 0).sum())
                stalled = int(got[18 * m + 4].sum())
                require(not bad, f'{name} ({mode}): planes {bad} disagree')
                require((restarts > 0 or m == 33) and stalled + restarts > 0 and walls_ > 0 and movers > 0,
                        f'{name} ({mode}): {restarts} restarts, {stalled} stalls, {walls_} wall hits, {movers} '
                        f'mover hits')
                entry['max_abs_err'] = max(entry['max_abs_err'], e)
                entry[mode] = {'restarts': restarts, 'wall_hits': walls_, 'mover_hits': movers, 'stalled': stalled,
                               'done': int(done.sum()), 'stalled_share_of_done': stalled / max(int(done.sum()), 1),
                               'sets_tested': int(got[18 * m + 5].sum())}
            entry['ms'], _ = time_groups(lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), 3, 10)
            res[name] = entry

        t_part['configs'] = time.perf_counter()
        # the main configuration on the states the main path gives kernel H,
        # in the wrapper's layout: the kernels line's time and bound
        cfg, prm, mc, st, act = multi_rollout_h(M_MAIN, B_MAIN, 21)
        m = M_MAIN
        n_noise = kmu.multi_noise_planes(cfg.num_cycles, m, mc.base.cand_k, mc.base.box)
        u = torch.rand((n_noise, B_MAIN), generator=gen, device=dev)
        u7 = philox(7, n_noise, B_MAIN)
        got = kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7)
        ref, cycles = kmu.planning_multi_autoreset_plain(st, act, mc, u7, cycles_run=True)
        e, bad = planes_check(got, ref, exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
        require(not bad, f'rollout state (philox): planes {bad} disagree')
        cycles = float(cycles.sum())
        cycles_inj = float(kmu.planning_multi_autoreset_plain(st, act, mc, u, cycles_run=True)[1].sum())
        sets_inj = float(kmu.planning_multi_autoreset_cuda(st, act, mc, u)[18 * m + 5].sum())
        injected_ms, injected_groups = time_groups(lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, u))
        ms, ms_groups = time_groups(lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7))
        plain_ms = time_ms(lambda: kmu.planning_multi_autoreset_plain(st, act, mc, u), 1, warmup=0)
        bound_ms, bound_by = bound((10 * m + 1 + 18 * m + 6) * 4 * B_MAIN,
                                   multi_step_ops(cfg, mc, cycles, float(got[18 * m + 5].sum())))
        main = {'M': m, 'B': B_MAIN, 'lanes': list(kmu.lane_layout(m, B_MAIN)), 'max_abs_err': e, 'ms': ms,
                'ms_groups': ms_groups, 'ms_spread': spread(ms_groups), 'bound_ms': bound_ms, 'bound_by': bound_by,
                'cycles_run_share': cycles / (cfg.num_cycles * B_MAIN), 'plain_ms': plain_ms,
                'injected_ms': injected_ms, 'injected_groups': injected_groups,
                'injected_bound_ms': bound((10 * m + 1 + n_noise + 18 * m + 6) * 4 * B_MAIN,
                                           multi_step_ops(cfg, mc, cycles_inj, sets_inj))[0]}
        kstats['planning_multi_autoreset'].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                                  max_abs_err=max([e] + [r['max_abs_err'] for r in res.values()]))

        t_part['main'] = time.perf_counter()
        # every layout (G, L) the wrapper can pick: held against the plain
        # version at 4096 envs, then timed on rollout states at both widths
        for m in H_LAYOUT_MOVERS:
            cfg, prm, mc, st, act = multi_rollout_h(m, B_MAIN, 30 + m)
            ref = kmu.planning_multi_autoreset_plain(st, act, mc, philox(7, kmu.multi_noise_planes(
                cfg.num_cycles, m, mc.base.cand_k, mc.base.box), B_MAIN))
            for lay in kmu.layouts(m):
                with forced_layout(m, lay):
                    _, bad = planes_check(kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), ref,
                                          exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                require(not bad, f'M={m} (G, L)={lay}: planes {bad} disagree')
        layout_ms = kernel_h_layouts(H_LAYOUT_MOVERS, (B_MAIN, B_LARGE), DEVICE)
        t_part['layouts'] = time.perf_counter()

        # 65-128 movers: 32 lanes of 4 slots or the many-mover variant, by
        # LANE_TABLE.  Held against the plain version at 1 cycle and 1
        # candidate set on all envs, in the wrapper's layout and the other one
        # forced, both noise modes at 65 movers and the Philox mode the path
        # launches above; then timed in both layouts at the full 40 cycles and
        # cand_k 16 (Philox), on the same planted states, and the wrapper's
        # launch held against the plain version on 64 envs
        above = {}
        for m in H_WIDE_MOVERS:
            for box in (False, True):
                tag = f'M={m} {"box" if box else "circle"}'
                lay = kmu.lane_layout(m, B_MAIN)
                other = next(x for x in kmu.layouts(m) if x != lay)
                entry = {'lanes': list(lay), 'other_lanes': list(other)}
                require(kmu.layouts(m) == ((32, 4), (32, kmu.SMEM_SLOTS)) and lay == kmu.LANE_TABLE[
                    kmu.table_row(m)][0], f'{tag}: layout')
                for cycles, cand_k in ((1, 1), (40, 16)):
                    cfg, prm, st, act = ladder_state(m, box, B_MAIN, cycles, device=DEVICE)
                    mc = kmu.make_multi_kernel_consts(cfg, prm, cand_k)
                    n_noise = kmu.multi_noise_planes(cycles, m, cand_k, box)
                    if cycles == 1:
                        u = torch.rand((n_noise, B_MAIN), generator=gen, device=dev)
                        with forced_layout(m, other):
                            got_other = kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7)
                        ref7 = kmu.planning_multi_autoreset_plain(st, act, mc, philox(7, n_noise, B_MAIN))
                        modes = (('philox', kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), ref7),
                                 ('philox_other', got_other, ref7))
                        if m == H_WIDE_MOVERS[0]:
                            modes += (('injected', kmu.planning_multi_autoreset_cuda(st, act, mc, u),
                                       kmu.planning_multi_autoreset_plain(st, act, mc, u)),)
                        for mode, got, ref in modes:
                            e, bad = planes_check(got, ref, exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                            walls_, movers = int((got[18 * m + 1] > 0).sum()), int((got[18 * m + 2] > 0).sum())
                            require(not bad, f'{tag} ({mode}): planes {bad} disagree')
                            require(walls_ > 0 and movers > 0, f'{tag} ({mode}): {walls_} wall, {movers} mover hits')
                            entry[mode] = {'max_abs_err': e, 'wall_hits': walls_, 'mover_hits': movers,
                                           'sets_tested': int(got[18 * m + 5].sum())}
                    else:  # launches of a millisecond or more: CUDA events time the device
                        entry['ms'], entry['ms_groups'] = time_groups(
                            lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), 3, 5)
                        with forced_layout(m, other):
                            entry['ms_other'], entry['ms_other_groups'] = time_groups(
                                lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), 3, 5)
                        # the timed launch held against the plain version on 64 of its envs, 16 of each
                        # planted quarter (wall, head-on, random, random)
                        q = B_MAIN // 4
                        cols = np.concatenate([np.arange(k * q, k * q + 16) for k in range(4)])
                        idx = torch.from_numpy(cols).to(dev)
                        got = kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7)[:, idx]
                        ref = kmu.planning_multi_autoreset_plain(
                            st[:, idx].contiguous(), act[:, idx].contiguous(), mc,
                            noise.philox_uniforms(7, n_noise, len(cols), cols).to(dev))
                        e, bad = planes_check(got, ref, exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                        require(not bad, f'{tag} (40 cycles, cand_k 16, philox): planes {bad} disagree')
                        restarts = int(((got[8 * m] == 0) & (st[8 * m, idx] > 0)).sum())
                        entry['timed_check'] = {
                            'envs': len(cols), 'max_abs_err': e, 'restarts': restarts,
                            'stalled': int(got[18 * m + 4].sum()), 'wall_hits': int((got[18 * m + 1] > 0).sum()),
                            'mover_hits': int((got[18 * m + 2] > 0).sum()), 'sets_tested': int(got[18 * m + 5].sum())}
                above[tag] = entry
        t_part['above_64_movers'] = time.perf_counter()
        for v in above.values():
            name = kmu.launch_name(v['lanes'][1])
            kstats[name]['max_abs_err'] = max([kstats[name].get('max_abs_err', 0.0)] + [
                v[mode]['max_abs_err'] for mode in ('injected', 'philox', 'philox_other', 'timed_check') if mode in v])

        # above 128 movers: the many-mover variant (one warp an env, the movers
        # in shared memory).  Held against the plain version at 1 cycle and 1
        # candidate set on 64 envs in both noise modes, then timed at 40 cycles
        # and cand_k 16 on 4096 planted envs (Philox); the timed launch at 129
        # circle movers is held against the plain version on all its envs and
        # gives the kernels line (bound from this run's cycles and sets)
        many = {}
        for m in H_MANY_MOVERS:
            for box in (False, True):
                tag = f'M={m} {"box" if box else "circle"}'
                require(kmu.layouts(m) == ((32, kmu.SMEM_SLOTS),) and kmu.lane_layout(m, B_MAIN) == (
                    32, kmu.SMEM_SLOTS), f'{tag}: layout')
                entry = {'smem_bytes': kmu.many_smem_bytes(m, box)}
                cfg, prm, st, act = ladder_state(m, box, 64, 1, device=DEVICE)
                mc = kmu.make_multi_kernel_consts(cfg, prm, 1)
                n_noise = kmu.multi_noise_planes(1, m, 1, box)
                u = torch.rand((n_noise, 64), generator=gen, device=dev)
                for mode, got, uref in (('injected', kmu.planning_multi_autoreset_cuda(st, act, mc, u), u),
                                        ('philox', kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7),
                                         philox(7, n_noise, 64))):
                    e, bad = planes_check(got, kmu.planning_multi_autoreset_plain(st, act, mc, uref),
                                          exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                    walls_, movers = int((got[18 * m + 1] > 0).sum()), int((got[18 * m + 2] > 0).sum())
                    require(not bad, f'{tag} ({mode}): planes {bad} disagree')
                    require(walls_ > 0 and movers > 0, f'{tag} ({mode}): {walls_} wall, {movers} mover hits')
                    entry[mode] = {'max_abs_err': e, 'wall_hits': walls_, 'mover_hits': movers,
                                   'sets_tested': int(got[18 * m + 5].sum())}
                cfg, prm, st, act = ladder_state(m, box, B_MAIN, 40, device=DEVICE)
                mc = kmu.make_multi_kernel_consts(cfg, prm, 16)
                entry['ms'], entry['ms_groups'] = time_groups(
                    lambda: kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7), 3, 5)
                if (m, box) == (H_MANY_MOVERS[0], False):
                    n_noise = kmu.multi_noise_planes(40, m, 16, box)
                    u7 = philox(7, n_noise, B_MAIN)
                    got = kmu.planning_multi_autoreset_cuda(st, act, mc, None, 7)
                    t0 = time.perf_counter()
                    ref, cycles = kmu.planning_multi_autoreset_plain(st, act, mc, u7, cycles_run=True)
                    torch.cuda.synchronize()
                    plain_ms = (time.perf_counter() - t0) * 1e3
                    e, bad = planes_check(got, ref, exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                    require(not bad, f'{tag} (40 cycles, cand_k 16, philox): planes {bad} disagree')
                    cycles = float(cycles.sum())
                    sets = float(got[18 * m + 5].sum())
                    bound_ms, bound_by = bound((10 * m + 1 + 18 * m + 6) * 4 * B_MAIN,
                                               multi_step_ops(cfg, mc, cycles, sets))
                    entry['timed_check'] = {'envs': B_MAIN, 'max_abs_err': e, 'cycles_run_share': cycles / (
                        40 * B_MAIN), 'sets_tested': sets, 'wall_hits': int((got[18 * m + 1] > 0).sum()),
                        'mover_hits': int((got[18 * m + 2] > 0).sum())}
                    kstats['planning_multi_autoreset_many'].update(
                        ms=entry['ms'], plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                        max_abs_err=max(e, entry['injected']['max_abs_err'], entry['philox']['max_abs_err'],
                                        kstats['planning_multi_autoreset_many'].get('max_abs_err', 0.0)))
                    # the launch's two parts apart: no env done (cycles only), every env latched in
                    # cycle 0 (its 2 x 16 candidate sets), timed as the planted launch (CUDA events: the
                    # device sets the pace); the sets held against the plain version on 64 envs (the
                    # cycles are, in the planted launch above)
                    entry['device_ms'] = {'planted': entry['ms']}
                    for kind in ('cycles', 'sets'):
                        cfg_k, prm_k, st_k, act_k = ladder_state(m, box, B_MAIN, 40, kind, device=DEVICE)
                        mc_k = kmu.make_multi_kernel_consts(cfg_k, prm_k, 16)
                        got = kmu.planning_multi_autoreset_cuda(st_k, act_k, mc_k, None, 7)
                        e_k, bad = 0.0, []
                        if kind == 'sets':
                            ref = kmu.planning_multi_autoreset_plain(
                                st_k[:, :64].contiguous(), act_k[:, :64].contiguous(), mc_k, philox(7, n_noise, 64))
                            e_k, bad = planes_check(got[:, :64], ref, exact=(8 * m, *range(18 * m + 1, 18 * m + 6)))
                        done_k = int((got[18 * m + 5] > 0).sum())
                        require(not bad, f'{tag} ({kind}): planes {bad} disagree')
                        require(done_k == (0 if kind == 'cycles' else B_MAIN), f'{tag} ({kind}): {done_k} envs done')
                        entry['device_ms'][kind], _ = time_groups(
                            lambda: kmu.planning_multi_autoreset_cuda(st_k, act_k, mc_k, None, 7), 3, 5)
                        entry[kind] = {'max_abs_err': e_k, 'done': done_k, 'sets_tested': float(got[18 * m + 5].sum())}
                        kstats['planning_multi_autoreset_many']['max_abs_err'] = max(
                            kstats['planning_multi_autoreset_many']['max_abs_err'], e_k)
                else:
                    kstats['planning_multi_autoreset_many']['max_abs_err'] = max(
                        kstats['planning_multi_autoreset_many'].get('max_abs_err', 0.0),
                        entry['injected']['max_abs_err'], entry['philox']['max_abs_err'])
                many[tag] = entry
        t_part['above_128_movers'] = time.perf_counter()
        # ptxas -v of each instantiation (L, box)
        ptxas = {}
        for fn, line in report['phases']['card_build'].get('ptxas', {}).items():
            mt = re.search(r'planning_multi_kernelILi(\d+)ELb(\d)E', fn)
            if mt:
                ptxas['L={},box={}'.format(*mt.groups())] = line
            mt = re.search(r'planning_multi_many_kernelILb(\d)E', fn)
            if mt:
                ptxas['many,box={}'.format(*mt.groups())] = line
        return {'B': B_MAIN, 'tol': f'flags exact, planes rtol {plan_rtol} atol {plan_atol}',
                'modes': 'injected uniforms; Philox seed 7 against the plain version on its host copy',
                'configs': res, 'main': main, 'layout_ms': layout_ms, 'above_64_movers': above,
                'above_128_movers': many, 'max_movers': kmu.MAX_MOVERS, 'lane_table': {
                    str(k): v for k, v in kmu.LANE_TABLE.items()}, 'wide_batch': kmu.WIDE_BATCH, 'ptxas': ptxas,
                'seconds_by_part': {k: t_part[k] - t_part[p] for p, k in zip(list(t_part), list(t_part)[1:])}}

    # -- 10. the public M-mover path ------------------------------------------------
    def drive_multi_path(m, side, seed):
        """The public M-mover path at 4096 envs: init_batch ->
        make_fused_step_autoreset x5 -> multi_agent.make_batched_parallel_step
        x3 -> make_fused_rollout T=64, counters set to 0 before and read
        after, with the mover collisions kernel H reports on the way."""
        cfg, prm = PL.make_planning_env(np.ones((side, side)), m, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        require(multi_agent.fused_covers(cfg, prm), f'{m} movers: the multi-agent step would step eagerly')
        # count the mover collisions the kernel reports on the path (its
        # mover plane), beside the launch counters
        launch, mover_hits = kmu.planning_multi_autoreset_cuda, []

        def recording(*args, **kw):
            out = launch(*args, **kw)
            mover_hits.append(out[18 * m + 2].sum())
            return out

        kmu.planning_multi_autoreset_cuda = recording
        try:
            kernels.reset_launches()
            state, obs, info = PL.init_batch(cfg, prm, B_MAIN, g)
            step_ar = PL.make_fused_step_autoreset(cfg, prm)
            s = state
            infos = []
            for _ in range(5):
                s, o, r, te, tr, inf = step_ar(s, (torch.rand((B_MAIN, m, 2), generator=g, device=dev) * 2 - 1) * 10.0,
                                               generator=g)
                infos.append(inf)
            par = multi_agent.make_batched_parallel_step(cfg, prm)
            agent_rewards = []
            for _ in range(3):
                s, batch = par(s, (torch.rand((B_MAIN, m, 2), generator=g, device=dev) * 2 - 1) * 10.0, generator=g)
                agent_rewards.append(batch.reward)
            acts = (torch.rand((T_ROLL, B_MAIN, m, 2), generator=g, device=dev) * 2 - 1) * 10.0
            n_before = len(mover_hits)
            fs, rew, term, trunc = PL.make_fused_rollout(cfg, prm)(s, acts, 200)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            kmu.planning_multi_autoreset_cuda = launch
        roll_mover_hits = int(sum(int(h) for h in mover_hits[n_before:]))

        require(launches['planning_multi_autoreset'] == 5 + 3 + T_ROLL,
                f'{m} movers: kernel H launched {launches["planning_multi_autoreset"]} times, expected {5 + 3 + T_ROLL}')
        # init_batch's own rule: a stalled env keeps its last draw (at 12
        # movers about one env in six stalls within its 104 sets)
        placed = ~info['reset_stalled']
        require(m > M_MAIN or bool(placed.all()), 'init_batch stalled')
        require(not bool(common.wall_collision_any(prm.grid, state.pos[placed], None, prm.c_size + prm.c_offset_wall
                                                   + prm.c_offset, 'circle').any()), 'init_batch: a mover wall-invalid')
        require(not bool(collision.check_mover_collision(state.pos[placed], prm.c_size + prm.c_offset).any()),
                'init_batch: a start pair collides')
        allowed = {50.0, -50.0} | {-float(k) for k in range(1, m + 1)}
        require(set(torch.unique(rew).tolist()) <= allowed, f'rollout rewards {torch.unique(rew).tolist()}')
        require(set(torch.unique(torch.stack(agent_rewards)).tolist()) <= {50.0, -50.0, 0.0, -1.0},
                'per-agent rewards')
        for name in ('pos', 'vel', 'acc', 'goals'):
            require(bool(torch.isfinite(getattr(fs, name)).all()), f'{name} not finite')
        speed = torch.linalg.vector_norm(fs.vel, dim=-1)
        require(float(speed.max()) <= float(prm.v_max) * 1.01, f'|v| {float(speed.max())}')
        require(bool(((fs.pos >= 0.0) & (fs.pos <= 0.24 * side)).all()), 'a mover off the table')
        # a stalled restart leaves its env's counter counting (done fires
        # again next step): at most the 5 + 3 + T_ROLL steps driven above
        over = int((fs.steps > cfg.max_episode_steps).sum())
        require(bool(((fs.steps >= 0) & (fs.steps <= cfg.max_episode_steps + 5 + 3 + T_ROLL)).all())
                and (over == 0 or m > M_MAIN), f'steps: {over} envs past the episode limit')
        ends = int((term | trunc).sum())
        require(ends > 0 and roll_mover_hits > 0, f'rollout: {ends} episode ends, {roll_mover_hits} mover collisions')
        return {'launches': launches, 'lanes': list(kmu.lane_layout(m, B_MAIN)),
                'init_trials_mean': float(info['reset_trials'].double().mean()),
                'init_stalled': int(info['reset_stalled'].sum()), 'steps_past_limit': over,
                'step_mover_collisions': int(sum(int(i['mover_collision'].sum()) for i in infos)),
                'step_stalled': int(sum(int(i['reset_stalled'].sum()) for i in infos)),
                'rollout': {'terminations': int(term.sum()), 'truncations': int(trunc.sum()),
                            'mover_collisions': roll_mover_hits, 'successes': int((rew == 50.0).sum()),
                            'collisions': int((rew == -50.0).sum()), 'reward_mean': float(rew.mean())}}

    @phase('multi_planning_main_path')
    def _():
        res = drive_multi_path(M_MAIN, 4, 5)
        # the same path at 12 movers on the 8x8 table, counted on its own
        res[f'M={M_WIDE}'] = drive_multi_path(M_WIDE, 8, 15)
        # the multi-agent step at 65 movers (f32) takes kernel H, L = 4 slots,
        # counted on its own; the movers start on a grid of slots (random
        # sets of 65 are never apart)
        m = H_WIDE_MOVERS[0]
        cfg, prm, _, _ = ladder_state(m, False, 1, 40, device=DEVICE)
        g = torch.Generator(device=dev).manual_seed(25)
        nx = math.ceil(math.sqrt(m))
        slots = [(0.3 + 0.42 * i, 0.3 + 0.42 * j) for i in range(nx) for j in range(nx)][:m]
        state, _, _ = PL.reset(cfg, prm, B_MAIN, g, start_xy=slots, goals_xy=slots[::-1])
        require(multi_agent.fused_covers(cfg, prm), f'{m} movers: the multi-agent step would step eagerly')
        par = multi_agent.make_batched_parallel_step(cfg, prm)
        kernels.reset_launches()
        rewards = []
        for _ in range(3):
            state, batch = par(state, (torch.rand((B_MAIN, m, 2), generator=g, device=dev) * 2 - 1) * 10.0,
                               generator=g)
            rewards.append(batch.reward)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        require(launches['planning_multi_autoreset'] == 3 and sum(launches.values()) == 3,
                f'{m} movers: launches {launches}')
        rew = torch.stack(rewards)
        require(rew.shape == (3, B_MAIN, m) and set(torch.unique(rew).tolist()) <= {50.0, -50.0, 0.0, -1.0},
                f'{m} movers: per-agent rewards {torch.unique(rew).tolist()[:8]}')
        require(bool(torch.isfinite(state.pos).all()), f'{m} movers: positions not finite')
        res[f'M={m} multi_agent'] = {'launches': launches, 'lanes': list(kmu.lane_layout(m, B_MAIN)),
                                     'reward_mean': float(rew.mean())}
        return res

    multi_launches = report['phases']['multi_planning_main_path'].get('launches', {})

    # -- 11. M-mover rollout rate ----------------------------------------------------
    @phase('multi_planning_rollout_rate')
    def _():
        rates = {}
        for b in (B_MAIN, B_LARGE):
            cfg, prm = PL.make_planning_env(np.ones((4, 4)), M_MAIN, device=dev)
            g = torch.Generator(device=dev).manual_seed(6)
            state, _, _ = PL.init_batch(cfg, prm, b, g)
            acts = (torch.rand((T_ROLL, b, M_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
            roll = PL.make_fused_rollout(cfg, prm)
            roll(state, acts, 1)  # warm-up
            torch.cuda.synchronize()
            event_ms, host_ms = [], []
            for rep in range(5):
                _, ms, host = timed(lambda rep=rep: roll(state, acts, 3 + rep))
                event_ms.append(ms)
                host_ms.append(host)
            med = statistics.median(event_ms)
            entry = {'kernel_ms_runs': event_ms, 'host_enqueue_ms_runs': host_ms, 'kernel_ms_median': med,
                     'host_share_median': statistics.median(h / e for h, e in zip(host_ms, event_ms)),
                     'kernel_env_steps_per_s': b * T_ROLL / (med / 1e3)}
            if b == B_MAIN:
                mc = kmu.make_multi_kernel_consts(cfg, prm)
                n_step = kmu.multi_noise_planes(cfg.num_cycles, M_MAIN, mc.base.cand_k, mc.base.box)

                def plain_step(planes, action, seed, mc=mc, n_step=n_step, b=b):
                    return kmu.planning_multi_autoreset_plain(planes, action, mc, torch.rand((n_step, b), device=dev))

                plain = PL._make_multi_rollout(cfg, prm, plain_step)
                t_p = time_ms(lambda: plain(state, acts[:T_PLAIN], 3), 1, warmup=0)
                entry.update(plain_ms=t_p, plain_env_steps_per_s=b * T_PLAIN / (t_p / 1e3))
            rates[f'B={b}'] = entry
        return {'T': T_ROLL, 'T_plain': T_PLAIN, 'M': M_MAIN, 'card': card, 'repeats': 5, 'rates': rates}

    # -- 12. kernel C-feat -------------------------------------------------------------
    @phase('kernel_C_feat_pushing_autoreset_features')
    def _():
        res = {}
        for jerk in (False, True):
            cfg, prm = P.make_pushing_env(learn_jerk=jerk, device=dev)
            kcj = kp.make_kernel_consts(cfg, prm, 32)
            state = planted_state(P, cfg, prm, B_MAIN, gen)
            state.steps = torch.randint(0, cfg.max_episode_steps, (B_MAIN,), generator=gen, device=dev,
                                        dtype=torch.int32)
            act = ((torch.rand((2, B_MAIN), generator=gen, device=dev) * 2 - 1) * (80.0 if jerk else 8.0)).contiguous()
            st = P.state_to_planes(state)
            n_noise = kp.autoreset_noise_planes(kcj.num_cycles, kcj.cand_k)
            u = torch.rand((n_noise, B_MAIN), generator=gen, device=dev)
            entry = {}
            for mode, uk, seed, uref in (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, B_MAIN))):
                out, feat = kp.pushing_autoreset_cuda(st, act, kcj, uk, seed, emit_features=True)
                require(torch.equal(out, kp.pushing_autoreset_cuda(st, act, kcj, uk, seed)),
                        f'jerk={jerk} ({mode}): the emit launch changed the 36 planes')
                require(torch.equal(feat, kp.features_from_planes(st, out)),
                        f'jerk={jerk} ({mode}): the blocks are not the launch\'s own planes')
                ref_out, ref_feat = kp.pushing_autoreset_plain(st, act, kcj, uref, emit_features=True)
                err_planes, bad, _ = plane_compare(out, ref_out)
                err_feat, ok_feat = compare(feat, ref_feat, feat_rtol, feat_atol)
                restarts = int(((out[18] == 0) & (st[18] > 0)).sum())
                require(not bad, f'jerk={jerk} ({mode}): planes {bad} disagree')
                require(ok_feat, f'jerk={jerk} ({mode}): feature blocks disagree: {err_feat}')
                require(restarts > 0 and torch.equal(feat[1, 6:8], st[16:18]),
                        f'jerk={jerk} ({mode}): {restarts} restarts, or the pre-reset block lost the old goal')
                entry[mode] = {'max_abs_err_features': err_feat, 'max_abs_err_planes': err_planes,
                               'restarts': restarts}
            if not jerk:
                ms, ms_groups = time_groups(lambda: kp.pushing_autoreset_cuda(st, act, kcj, None, 7, True))
                c_ms, c_groups = time_groups(lambda: kp.pushing_autoreset_cuda(st, act, kcj, None, 7))
                injected_ms, _ = time_groups(lambda: kp.pushing_autoreset_cuda(st, act, kcj, u, 0, True))
                plain_ms = time_ms(lambda: kp.pushing_autoreset_plain(st, act, kcj, u, True), 3)
                ops = B_MAIN * (pushing_step_ops() + sum(OPS['pushing_features']))
                bound_ms, bound_by = bound((21 + 36 + 24) * 4 * B_MAIN, ops)
                entry.update(ms=ms, ms_groups=ms_groups, ms_spread=spread(ms_groups), kernel_c_ms=c_ms,
                             kernel_c_groups=c_groups, bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
                             injected_ms=injected_ms,
                             injected_bound_ms=bound((21 + n_noise + 36 + 24) * 4 * B_MAIN, ops)[0])
                kstats['pushing_autoreset_features'].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                                            bound_by=bound_by)
                st_l = large_state(cfg, prm)
                act_l = ((torch.rand((2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
                entry['large'] = check_large_autoreset(kcj, st_l, act_l, emit=True)
                entry.update(split_report(lambda s_, a_: kp.pushing_autoreset_cuda(s_, a_, kcj, None, 7, True),
                                          (st, act), (st_l, act_l), 'pushing_autoreset_kernelILb0ELb0ELb0ELb1E',
                                          kcj))
            res['jerk' if jerk else 'acc'] = entry
        kstats['pushing_autoreset_features'].update(max_abs_err=max(
            e[m]['max_abs_err_features'] for e in res.values() for m in ('injected', 'philox')))
        ptxas = {k: v for k, v in report['phases']['card_build'].get('ptxas', {}).items()
                 if 'pushing_autoreset_kernel' in k}
        return {'B': B_MAIN, 'tol': f'planes as kernel C; features rtol {feat_rtol} atol {feat_atol}; '
                                    '36 planes vs kernel C and blocks vs own planes exact',
                'modes': 'injected uniforms; Philox seed 7 against the plain version on its host copy',
                'configs': res, 'ptxas_kernel_c': ptxas}

    # -- 13. PPO training on the reactive pushing rollout --------------------------------
    from gymnasium_planar_robotics_tpu_torch.models import ppo as PPO

    # tools/train_push_strong.py: PUSHING_KW and the recipe 'baseline'
    push_kw = dict(std_noise=1e-5, num_cycles=40, v_max=2.0, a_max=10.0, j_max=100.0, threshold_pos=0.05)

    @phase('ppo_train_main_path')
    def _():
        cfg, prm = P.make_pushing_env(device=dev, **push_kw)
        pcfg = PPO.PPOConfig(obs_dim=12, action_dim=2, hidden=(128, 128), rollout_steps=25, action_scale=10.0,
                             learning_rate=3e-4, update_epochs=4, gamma=0.99)
        g = torch.Generator(device=dev).manual_seed(8)

        def make_rollout(policy_step):
            return P.make_reactive_rollout(cfg, prm, policy_step, pcfg.rollout_steps, dense_reward=True)

        kernels.reset_launches()
        state, _, _ = P.init_batch(cfg, prm, B_TRAIN, g)
        policy = PPO.init_params(pcfg, g, device=dev)
        train_step, make_opt = PPO.make_train_step_reactive(pcfg, make_rollout)
        runner = (state, policy, make_opt(policy), g, 0)
        metrics, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            (runner, m), ms, _ = timed(lambda runner=runner: train_step(runner))
            metrics.append(m)
            step_ms.append(ms)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)

        expected = TRAIN_STEPS * pcfg.rollout_steps
        require(launches['pushing_autoreset_features'] == expected,
                f'C-feat launched {launches["pushing_autoreset_features"]} times, expected {expected}')
        require(launches['policy_mlp'] == expected,
                f'the policy kernel launched {launches["policy_mlp"]} times, expected {expected}')
        others = {k: v for k, v in launches.items()
                  if k not in ('pushing_autoreset_features', 'noise_probe', 'policy_mlp') and v}
        require(not others, f'other env kernels launched on the training path: {others}')
        loss = [float(m['loss']) for m in metrics]
        reward = [float(m['reward_mean']) for m in metrics]
        done = [float(m['done_rate']) for m in metrics]
        require(all(math.isfinite(x) for x in loss + reward), f'loss {loss}, reward_mean {reward}')
        require(min(reward) > -60.0, f'reward_mean {min(reward)}')
        require(all(p.isfinite().all() for p in policy.parameters()), 'the policy is not finite')

        # the split: the rollout alone (same policy and shapes), the update as
        # the rest of a train step
        roll = make_rollout(train_step.policy_step)
        s = runner[0]
        roll_ms, roll_host = [], []
        with torch.no_grad():
            for rep in range(5):
                eps = torch.randn((pcfg.rollout_steps, 2, B_TRAIN), generator=g, device=dev)
                (res, ms, host) = timed(lambda s=s, eps=eps, rep=rep: roll(s, policy, g, 1000 + 25 * rep,
                                                                           policy_xs=eps))
                s = res[0]
                roll_ms.append(ms)
                roll_host.append(host)
        step_med, roll_med = statistics.median(step_ms[1:]), statistics.median(roll_ms)

        # a constant policy gives make_fused_rollout at K=1, bit for bit
        s0 = planted_state(P, config, params, B_MAIN, g)
        a0 = torch.tensor([[2.0], [-1.0]], device=dev)
        const = P.make_reactive_rollout(config, params, lambda pol, x, obs: (a0.expand(2, obs.shape[1]), ()), T_ROLL)
        fr, traj, _ = const(s0, None, None, 300)
        ff, rew_f, term_f, trunc_f = P.make_fused_rollout(config, params)(s0, a0.T.expand(T_ROLL, B_MAIN, 2), 300)
        for f in ('pos', 'vel', 'acc', 'act', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w', 'mover_z', 'mover_vz',
                  'goal', 'steps'):
            require(torch.equal(getattr(fr, f), getattr(ff, f)), f'constant policy: {f} differs from the fused rollout')
        for name, got, want in (('reward', traj[2], rew_f), ('terminated', traj[3], term_f),
                                ('truncated', traj[4], trunc_f)):
            require(torch.equal(got, want), f'constant policy: {name} differs from the fused rollout')
        require(bool((term_f | trunc_f).any()), 'constant policy: no episode ended')
        return {'B': B_TRAIN, 'train_steps': TRAIN_STEPS, 'launches': launches, 'loss': loss,
                'reward_mean': reward, 'done_rate': done, 'train_step_ms_runs': step_ms,
                'train_step_ms_median': step_med, 'rollout_ms_runs': roll_ms, 'rollout_host_ms_runs': roll_host,
                'rollout_ms_median': roll_med, 'update_ms_median': step_med - roll_med,
                'train_env_steps_per_s': B_TRAIN * pcfg.rollout_steps / (step_med / 1e3),
                'constant_policy_vs_fused': {'B': B_MAIN, 'T': T_ROLL, 'bit_equal': True,
                                             'episode_ends': int((term_f | trunc_f).sum())}}

    train_launches = report['phases']['ppo_train_main_path'].get('launches', {})

    # -- 14. kernel P, then the reactive rollout rate ---------------------------------
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import policy as kpolicy
    from gymnasium_planar_robotics_tpu_torch.tools.rollout_rates import path_device_ms

    @phase('policy_kernel')
    def _():
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32, as the policy's precision
        res, errs = {}, []
        try:
            with torch.no_grad():
                for hidden, b in (((256, 256), B_LARGE), ((128, 128), B_TRAIN)):
                    g = torch.Generator(device=dev).manual_seed(40)
                    pol = PPO.init_params(PPO.PPOConfig(obs_dim=12, action_dim=2, hidden=hidden), g, device=dev)
                    for p in pol.parameters():  # biases and log_std drawn too, so that every term counts
                        if p.dim() == 1:
                            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
                    x, eps = torch.randn((12, b), generator=g, device=dev), torch.randn((2, b), generator=g, device=dev)
                    args = (x, eps, *pol.params_pm(), 10.0)
                    before = kernels.LAUNCHES['policy_mlp']
                    got = kpolicy.policy_mlp(*args)
                    require(kernels.LAUNCHES['policy_mlp'] == before + 1,
                            f'{hidden}: {kernels.LAUNCHES["policy_mlp"] - before} launches for one call')
                    want = kpolicy.policy_mlp_plain(*args)
                    gaps = {}
                    for name, k, w in zip(('raw', 'logp', 'value'), got[1:], want[1:]):
                        err, _ = compare(k, w, 0.0, math.inf)
                        errs.append(err)
                        gaps[name] = err / float(w.abs().max())
                        require(gaps[name] <= 2e-6, f'{hidden} x {b}: {name} {gaps[name]:.3e} of its largest magnitude')
                    require(torch.equal(got[0], torch.clamp(got[1], -10.0, 10.0)), f'{hidden}: action is not clamp(raw)')
                    dims = (12, *hidden)
                    flops = 2 * (sum(dims[i] * dims[i + 1] for i in range(len(hidden))) + hidden[-1] * 3)
                    ms, ms_groups = time_groups(lambda: kpolicy.policy_mlp(*args))
                    plain_ms = time_ms(lambda: kpolicy.policy_mlp_plain(*args), 20)
                    library_ms = path_device_ms(lambda: kpolicy.policy_mlp_plain(*args))
                    # the necessary bytes: 12 features and 2 noise values in; action, raw, logp, value out
                    bound_ms, bound_by = bound((12 + 2 + 2 + 2 + 1 + 1) * 4 * b, flops * b)
                    res[f'{hidden[0]}x{hidden[1]},B={b}'] = {
                        'gap_of_largest': gaps, 'max_abs_err': max(errs[-3:]), 'ms': ms, 'ms_groups': ms_groups,
                        'ms_spread': spread(ms_groups), 'plain_ms': plain_ms, 'library_ms': library_ms,
                        'bound_ms': bound_ms, 'bound_by': bound_by, 'x_bound': ms / bound_ms,
                        'flops_per_env': flops, 'tflops': flops * b / ms / 1e9}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        main = res[f'256x256,B={B_LARGE}']
        kstats['policy_mlp'].update(max_abs_err=max(errs), ms=main['ms'], plain_ms=main['plain_ms'],
                                    bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                                    library_ms=main['library_ms'])
        ptxas = {k: v for k, v in report['phases']['card_build'].get('ptxas', {}).items() if 'policy_mlp' in k}
        return {'tol': 'raw, logp, value within 2e-6 of the plain version\'s largest magnitude; action == clamp(raw)',
                'shapes': res, 'ptxas': ptxas}

    @phase('reactive_rollout_rate')
    def _():
        cfg, prm = P.make_pushing_env(device=dev)
        pcfg = PPO.PPOConfig(obs_dim=12, action_dim=2, hidden=(256, 256), rollout_steps=T_ROLL)
        policy = PPO.init_params(pcfg, torch.Generator(device=dev).manual_seed(9), device=dev)

        def policy_step(pol, eps_t, obs_pm):
            # the benchmark's reactive policy: a Gaussian action by kernel P,
            # the value carried as a PPO rollout would
            action, _, _, value = PPO.sample_action_pm(pol, obs_pm, eps_t, 10.0)
            return action, value

        kernels.reset_launches()
        reactive = P.make_reactive_rollout(cfg, prm, policy_step, T_ROLL)
        fused = P.make_fused_rollout(cfg, prm)
        rates = {}
        with torch.no_grad():
            for b in (B_MAIN, B_LARGE):
                g = torch.Generator(device=dev).manual_seed(10)
                state, _, _ = P.init_batch(cfg, prm, b, g)
                eps = torch.randn((T_ROLL, 2, b), generator=g, device=dev)
                acts = (torch.rand((T_ROLL, b, 2), generator=g, device=dev) * 2 - 1) * 10.0
                paths = {'reactive': lambda seed, state=state, eps=eps: reactive(state, policy, g, seed, policy_xs=eps),
                         'fused_k1': lambda seed, state=state, acts=acts: fused(state, acts, seed)}
                for fn in paths.values():  # warm-up
                    fn(1)
                torch.cuda.synchronize()
                ev, host = {k: [] for k in paths}, {k: [] for k in paths}
                for rep in range(10):  # alternating repeats
                    for name, fn in paths.items():
                        _, ms, h = timed(lambda fn=fn, rep=rep: fn(3 + rep))
                        ev[name].append(ms)
                        host[name].append(h)
                for name in paths:
                    med = statistics.median(ev[name])
                    rates[f'B={b},{name}'] = {
                        'ms_runs': ev[name], 'host_enqueue_ms_runs': host[name], 'ms_median': med,
                        'host_share_median': statistics.median(h / e for h, e in zip(host[name], ev[name])),
                        'env_steps_per_s': b * T_ROLL / (med / 1e3),
                        'host_ms_per_step': statistics.median(host[name]) / T_ROLL}
                rates[f'B={b},policy_host_ms_per_step'] = (rates[f'B={b},reactive']['host_ms_per_step']
                                                          - rates[f'B={b},fused_k1']['host_ms_per_step'])
        torch.cuda.synchronize()
        calls = 2 * 11 * T_ROLL  # two widths, a warm-up and ten repeats, a launch a step
        require(kernels.LAUNCHES['policy_mlp'] == calls,
                f'the policy kernel launched {kernels.LAUNCHES["policy_mlp"]} times, expected {calls}')
        return {'T': T_ROLL, 'hidden': list(pcfg.hidden), 'card': card, 'repeats': 10, 'rates': rates,
                'policy_launches': kernels.LAUNCHES['policy_mlp']}

    # -- 15. PPO learns on 1-mover planning ----------------------------------------------
    @phase('ppo_planning_learns')
    def _():
        # tests/test_ppo_learning.py's configuration; the kernels run the
        # sparse config and the rollout computes the dense shaping
        cfg, prm = PL.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, a_max=3.0, device=dev)
        pcfg = PPO.PPOConfig(obs_dim=6, action_dim=2, hidden=(64, 64), rollout_steps=16, action_scale=10.0,
                             learning_rate=1e-3, update_epochs=4)
        g = torch.Generator(device=dev).manual_seed(11)
        state, _, _ = PL.init_batch(cfg, prm, 256, g)
        policy = PPO.init_params(pcfg, g, device=dev)
        train_step, make_opt = PPO.make_train_step_reactive(pcfg, lambda ps: PL.make_reactive_rollout(
            cfg, prm, ps, pcfg.rollout_steps, dense_reward=True))
        runner = (state, policy, make_opt(policy), g, 0)
        metrics = []
        t0 = time.perf_counter()
        for _ in range(110):
            runner, m = train_step(runner)
            metrics.append(m)
        rewards = [float(m['reward_mean']) for m in metrics]
        seconds = time.perf_counter() - t0
        early, late = statistics.mean(rewards[:10]), statistics.mean(rewards[-10:])
        require(all(math.isfinite(r) for r in rewards), 'reward_mean not finite')
        require(late > early + 0.3, f'PPO failed to improve: early {early}, late {late}')
        return {'B': 256, 'iterations': 110, 'early_mean': early, 'late_mean': late, 'gain': late - early,
                'reward_mean': rewards, 'seconds_110_steps': seconds}

    # -- 16. kernel I: the roofline's peak probes ------------------------------------
    from gymnasium_planar_robotics_tpu_torch.ops.kernels import peaks as kpk
    from gymnasium_planar_robotics_tpu_torch.utils import roofline as RL

    # kernel vs plain at K = 64: fma exact against fma_once_plain (the chain
    # rounded once a step, as fmaf rounds; the multiplier moves the result
    # by about 4e-6 relative, so only an exact check sees it), and rtol 1e-5
    # against fma_plain (the JAX rounding: the product, then the sum);
    # transc atol 1e-6 (the CUDA math library's logf and cosf within 2 ulps
    # of the plain version's ops; the chain contracts, so a difference does
    # not grow)
    measured = {}

    @phase('kernel_I_peaks')
    def _():
        res = {}
        for transc, k in ((False, 64), (True, 16)):
            name = 'peak_transc' if transc else 'peak_fma'
            x = torch.rand(kpk.probe_length(dev, transc), generator=gen, device=dev) * 0.98 + 0.01
            got = kpk.peak_cuda(x, k, transc)
            if transc:
                err, ok = compare(got, kpk.transc_plain(x, k), 0.0, 1e-6)
                require(ok, f'{name}: kernel vs plain {err}')
                res[name] = {'k_check': k, 'max_abs_err': err, 'tol': 'rtol 0 atol 1e-6'}
                continue
            ref = kpk.fma_once_plain(x, k)
            err, ok = compare(got, ref, 0.0, 0.0)
            require(ok, f'{name}: kernel vs fma_once_plain {err}, {int((got != ref).sum())} elements differ')
            err_j, ok = compare(got, kpk.fma_plain(x, k), 1e-5, 0.0)
            require(ok, f'{name}: kernel vs fma_plain {err_j}')
            res[name] = {'k_check': k, 'max_abs_err': err, 'max_abs_err_vs_fma_plain': err_j,
                         'tol': 'exact vs fma_once_plain; rtol 1e-5 vs fma_plain'}
        kernels.reset_launches()
        peaks = RL.microbench_peaks(dev)
        torch.cuda.synchronize()
        launches = {k: kernels.LAUNCHES[k] for k in PEAK_KERNELS}
        measured.update(peaks=peaks, launches=launches)
        require(all(launches.values()), f'a probe of the path never launched: {launches}')
        require(peaks['fma_tflops'] <= 1.05 * RL.PUBLISHED_F32 / 1e12,
                f'{peaks["fma_tflops"]} TFLOP/s is above 105% of the published peak: the count is wrong')
        sass = sass_loop_counts(build.build_info['path'], 'peak_transc_kernel')
        for transc, key in ((False, 'fma'), (True, 'transc')):
            name, pk = ('peak_transc' if transc else 'peak_fma'), peaks[key]
            x = torch.full((pk['n'],), 0.5, device=dev)
            # the plain version a CPU tensor runs (peaks.peak)
            plain = kpk.transc_plain if transc else kpk.fma_plain
            plain_ms = time_ms(lambda x=x, plain=plain, k=pk['k']: plain(x, k), 1, warmup=0)
            if transc:
                # the loop's FP32 and MUFU instructions over 128 and 16 lanes
                # per clock per SM at the published peak's clock
                per_step = max(sass['fp32_per_step'] / 128, sass['mufu_per_step'] / 16)
                bound_ms, bound_by = pk['n'] * pk['k'] * per_step / (132 * RL.PUBLISHED_CLOCK) * 1e3, 'operations'
            else:
                bound_ms, bound_by = bound(8 * pk['n'], pk['ops'])
            kstats[name].update(max_abs_err=res[name]['max_abs_err'], ms=pk['ms'], plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
            res[name].update(n=pk['n'], k=pk['k'], ms=pk['ms'], ms_runs=pk['ms_runs'], plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by, x_bound=pk['ms'] / bound_ms)
        return {'card': card, 'launches': launches, 'fma_tflops': peaks['fma_tflops'],
                'transc_gops': peaks['transc_gops'], 'hbm_gbs': peaks['hbm_gbs'],
                'published': {'f32_tflops': RL.PUBLISHED_F32 / 1e12, 'hbm_gbs': RL.PUBLISHED_HBM / 1e9,
                              'mufu_gops': RL.PUBLISHED_MUFU / 1e9},
                'fma_of_published': peaks['fma_tflops'] / (RL.PUBLISHED_F32 / 1e12),
                'hbm_of_published': peaks['hbm_gbs'] / (RL.PUBLISHED_HBM / 1e9), 'ms_spread': peaks['ms_spread'],
                'hbm_ms': peaks['hbm']['ms'], 'transc_sass': sass, 'probes': res}

    # -- 17. the roofline ----------------------------------------------------------------
    @phase('roofline')
    def _():
        ph = report['phases']
        rates = {
            'pushing rollout': ph['rollout_rate']['rates'][f'B={B_MAIN},K={K_MAIN}']['kernel_env_steps_per_s'],
            'planning rollout (1 mover)':
                ph['planning_rollout_rate']['rates'][f'B={B_MAIN},K={K_MAIN}']['kernel_env_steps_per_s'],
            'planning 4-mover rollout':
                ph['multi_planning_rollout_rate']['rates'][f'B={B_MAIN}']['kernel_env_steps_per_s'],
        }
        rows = RL.roofline(rates, measured['peaks'], costs=RL.rollout_costs(k=K_MAIN))
        return {'card': card, 'B': B_MAIN, 'K': K_MAIN, 'rows': rows}

    # -- 18. the eager steps on the card ----------------------------------------------------
    from gymnasium_planar_robotics_tpu_torch.utils import profiling

    def state_errs(got, want, classes, rows=None):
        """Largest |err| per field, each within its class's (rtol, atol)."""
        errs = {}
        for keys, rtol, atol in classes:
            for k in keys:
                a, b = getattr(got, k), getattr(want, k)
                e, ok = compare(a if rows is None else a[rows], b if rows is None else b[rows], rtol, atol)
                require(ok, f'{k}: eager vs fused {e}')
                errs[k] = e
        return errs

    @phase('eager_main_path')
    def _():
        res = {}
        # pushing's eager step against kernel B, at the JAX package's
        # eager-vs-fused tolerances: its straight-push test (this phase's
        # scenario) for the fields it checks; obj_yaw as its diagonal test;
        # mover_z, obj_w and mover_vz, which neither checks, as its
        # cone-share test's positions and velocities (an H100 80GB HBM3 at
        # 700 W read 0, 4.0e-6 and 7.3e-11 on them)
        cfg0, prm0 = P.make_pushing_env(std_noise=0.0, device=dev)
        g = torch.Generator(device=dev).manual_seed(21)
        s0 = planted_state(P, cfg0, prm0, B_MAIN, g)
        act = (torch.rand((B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 8.0
        es, _, _, et, _, ei = P.step(cfg0, prm0, s0, act, generator=g)
        fs, _, _, ft, _, fi = P.make_fused_step(cfg0, prm0)(s0, act, seed=7, generator=g)
        errs = state_errs(es, fs, ((('pos', 'vel', 'obj_pos', 'obj_vel'), 2e-6, 2e-6), (('acc',), 1e-4, 1e-5),
                                   (('obj_yaw',), 1e-4, 1e-6), (('mover_z',), 3e-5, 3e-6),
                                   (('obj_w', 'mover_vz'), 3e-5, 1e-4)))
        require(torch.equal(ei['wall_collision'], fi['wall_collision']), 'pushing: wall flags differ from kernel B')
        res['pushing_vs_B'] = {'max_abs_err': errs, 'wall_hits': int(ei['wall_collision'].sum()),
                               'objects_moved': int(((es.obj_pos - s0.obj_pos).abs() > 1e-5).any(-1).sum()),
                               'tol': 'pos, vel, obj_pos, obj_vel rtol 2e-6 atol 2e-6; acc rtol 1e-4 atol 1e-5; '
                                      'obj_yaw rtol 1e-4 atol 1e-6; mover_z rtol 3e-5 atol 3e-6; '
                                      'obj_w, mover_vz rtol 3e-5 atol 1e-4'}
        # planning's against kernel E (1 mover) and kernel H (4 movers, the
        # envs H does not restart): rtol 2e-6, atol 2e-7
        for m, layout in ((1, np.ones((3, 3))), (M_MAIN, np.ones((4, 4)))):
            cfg, prm = PL.make_planning_env(layout, m, std_noise=0.0, device=dev)
            st = multi_planted(cfg, prm, B_MAIN, 22) if m > 1 else wall_state(cfg, prm, B_MAIN, 22)
            a = (torch.rand((B_MAIN, m, 2), generator=g, device=dev) * 2 - 1) * 8.0
            es, _, _, _, _, ei = PL.step(cfg, prm, st, a, generator=g)
            if m == 1:
                fs, _, _, ft, ftr, fi = PL.make_fused_step(cfg, prm)(st, a, seed=7, generator=g)
                rows = torch.ones(B_MAIN, dtype=torch.bool, device=dev)
            else:
                fs, _, _, ft, ftr, fi = PL.make_fused_step_autoreset(cfg, prm)(st, a, seed=7, generator=g)
                rows = ~(ft | ftr)
            for k in ('wall_collision', 'mover_collision'):
                require(torch.equal(ei[k], fi[k]), f'planning M={m}: {k} differs from the kernel')
            errs = state_errs(es, fs, ((('pos', 'vel'), 2e-6, 2e-7), (('acc',), 1e-4, 1e-4)), rows)
            res[f'planning_m{m}_vs_{"E" if m == 1 else "H"}'] = {
                'max_abs_err': errs, 'compared_envs': int(rows.sum()), 'wall_hits': int(ei['wall_collision'].sum()),
                'mover_hits': int(ei['mover_collision'].sum()),
                'bit_equal_pos': bool(torch.equal(es.pos[rows], fs.pos[rows])),
                'tol': 'pos, vel rtol 2e-6 atol 2e-7; acc rtol 1e-4 atol 1e-4; flags equal'}

        # step_autoreset for T_EAGER steps beside the fused autoreset step
        families = (('pushing', P, P.make_pushing_env(device=dev), (2,)),
                    ('planning', PL, PL.make_planning_env(np.ones((3, 3)), 1, device=dev), (1, 2)))
        for fam, mod, (cfg, prm), ashape in families:
            g = torch.Generator(device=dev).manual_seed(23)
            state, _, _ = mod.init_batch(cfg, prm, B_EAGER, g)
            acts = (torch.rand((T_EAGER, B_EAGER, *ashape), generator=g, device=dev) * 2 - 1) * 10.0
            fused = mod.make_fused_step_autoreset(cfg, prm)
            paths = {'eager': lambda s, t: mod.step_autoreset(cfg, prm, s, acts[t], generator=g),
                     'fused_k1': lambda s, t: fused(s, acts[t], seed=500 + t, generator=g)}
            entry = {}
            for name, fn in paths.items():
                fn(state, 0)  # warm-up
                torch.cuda.synchronize()

                def run(fn=fn):
                    s, ends = state, []
                    for t in range(T_EAGER):
                        s, _, r, te, tr, _ = fn(s, t)
                        ends.append(te | tr)
                    return s, torch.stack(ends)

                kernels.reset_launches()
                (s_end, ends), ms, host = timed(run)
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
                with profiling.trace() as prof:
                    s = state
                    for t in range(4):
                        s = fn(s, t)[0]
                    torch.cuda.synchronize()
                prof_sum = profiling.trace_summary(prof)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter('always')
                    torch.cuda.set_sync_debug_mode('warn')
                    try:
                        fn(state, 1)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                syncs = [str(w.message)[:160] for w in caught if 'called a synchronizing' in str(w.message)]
                for k in ('pos', 'vel'):
                    require(bool(torch.isfinite(getattr(s_end, k)).all()), f'{fam} {name}: {k} not finite')
                require(bool(ends.any()), f'{fam} {name}: no episode ended in {T_EAGER} steps')
                entry[name] = {'ms_per_step': ms / T_EAGER, 'host_share': host / ms, 'launches': launches,
                               'episode_ends': int(ends.sum()), 'env_steps_per_s': B_EAGER * T_EAGER / (ms / 1e3),
                               'cuda_launch_calls_per_step': prof_sum['launch_calls'] / 4,
                               'device_kernels_per_step': prof_sum['device_kernels'] / 4,
                               'device_ms_per_step': prof_sum['device_ms'] / 4, 'host_syncs_in_a_step': len(syncs),
                               'sync_messages': syncs[:3]}
            require(entry['eager']['host_syncs_in_a_step'] == 0, f'{fam}: the eager step waits on the host: '
                    f'{entry["eager"]["sync_messages"]}')
            require(entry['eager']['launches'].get('noise_probe', 0) > 0, f'{fam}: kernel A never launched')
            res[f'{fam}_step_autoreset'] = dict(entry, B=B_EAGER, T=T_EAGER,
                                                eager_over_fused=entry['eager']['ms_per_step']
                                                / entry['fused_k1']['ms_per_step'])
        return {'card': card, **res}

    # -- 19. the PPO recipe on the eager step ----------------------------------------------
    from gymnasium_planar_robotics_tpu_torch.tools import train_push_strong as TPS

    @phase('ppo_eager_recipe')
    def _():
        timings, lines = {}, []
        kernels.reset_launches()
        t0 = time.perf_counter()
        policy = TPS.train('baseline', EAGER_ITERS, B_TRAIN, 0, 10**9, log=lines.append, device=dev,
                           timings=timings)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        ev = timings['evals'][-1]
        require(all(0.0 <= ev[k] <= 1.0 for k in ('success', 'success_any', 'wall_rate')), f'eval {ev}')
        require(math.isfinite(ev['dfin_med']) and launches.get('noise_probe', 0) > 0, f'eval {ev}, {launches}')
        # the split: the recipe's own train step (train's) in its two parts,
        # the rollout (train_step.collect) and the PPO epochs
        # (train_step.update), each timed with CUDA events, from where
        # training stopped
        train_step = timings['train_step']
        state, obs_vec, _, opt, g = timings['runner']
        roll_ms, update_ms, losses = [], [], []
        for _ in range(2):
            (state, obs_vec, *rollout), ms, _ = timed(lambda s=state, o=obs_vec: train_step.collect(s, o, policy, g))
            roll_ms.append(ms)
            loss, ms, _ = timed(lambda rollout=rollout: train_step.update(policy, opt, *rollout))
            update_ms.append(ms)
            losses.append(float(loss))
        require(all(math.isfinite(x) for x in losses), f'loss {losses}')
        t_roll = rollout[0].reward.shape[0]  # the recipe's rollout_steps
        iter_med = statistics.median(timings['iter_ms'][1:] or timings['iter_ms'])
        return {'card': card, 'B': B_TRAIN, 'iterations': EAGER_ITERS, 'seconds': seconds, 'log': lines,
                'launches': launches, 'iter_ms': timings['iter_ms'], 'iter_ms_median': iter_med,
                'eval': ev, 'eval_episodes': 1024, 'eval_s': timings['eval_s'][-1],
                'rollout_ms_runs': roll_ms, 'update_ms_runs': update_ms,
                'update_ms_median': statistics.median(update_ms),
                'rollout_steps': t_roll, 'rollout_ms_per_env_step': statistics.median(roll_ms) / t_roll,
                'train_env_steps_per_s': B_TRAIN * t_roll / (iter_med / 1e3),
                'hours_for_12000_iterations': 12000 * iter_med / 3.6e6, 'losses': losses}

    # -- 20. the box variants of kernels B, C, C-feat and D ------------------------------
    # the box of the JAX package's bench rows (bench.py:653-655)
    box_coll = {'shape': 'box', 'size': [0.09, 0.09]}
    cfg_box, prm_box = P.make_pushing_env(collision_params=box_coll, device=dev)
    kcb = kp.make_kernel_consts(cfg_box, prm_box, 32)
    box_ptxas = {k: v for k, v in report['phases']['card_build'].get('ptxas', {}).items()
                 if re.search(r'pushing_\w+_kernelILb[01]ELb1E', k)}

    def box_step_ops():
        """f32 operations of one box pushing autoreset step of one env."""
        return ops_total((kcb.num_cycles, 'pushing_cycle_box'), (1, 'pushing_step_extra'),
                         (kcb.cand_k, 'pushing_candidate'))

    def box_state(b: int, steps: bool = False):
        """planted_state, and a quarter of the envs with the box's -x side
        within a centimetre of the -x wall, moving out (wall hits)."""
        state = planted_state(P, cfg_box, prm_box, b, gen)
        wall = (torch.arange(b, device=dev) % 4 == 1)
        state.pos[wall, 0] = torch.linspace(0.09, 0.1, int(wall.sum()), device=dev)
        state.vel[wall] = torch.tensor([-1.0, 0.2], device=dev)
        if steps:
            state.steps = torch.randint(0, cfg_box.max_episode_steps, (b,), generator=gen, device=dev,
                                        dtype=torch.int32)
        return state

    def box_modes(n_noise):
        u = torch.rand((n_noise, B_MAIN), generator=gen, device=dev)
        return u, (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, B_MAIN)))

    @phase('kernel_B_box')
    def _():
        state = box_state(B_MAIN)
        act = (torch.rand((2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0
        planes = torch.cat([P.state_to_planes(state)[:16], act]).contiguous()
        n_noise = kp.cycles_noise_planes(kcb.num_cycles, True)
        u, modes = box_modes(n_noise)
        entry = {}
        for mode, uk, seed, uref in modes:
            got = kp.pushing_cycles_cuda(planes, kcb, uk, seed)
            err, bad, errs = plane_compare(got, kp.pushing_cycles_plain(planes, kcb, uref))
            walls = int((got[16] > 0).sum())
            require(not bad, f'{mode}: planes {bad} disagree: {[errs[i] for i in bad]}')
            require(0 < walls < B_MAIN, f'{mode}: {walls} wall hits')
            entry[mode] = {'max_abs_err': err, 'wall_hits': walls}
        ms, ms_groups = time_groups(lambda: kp.pushing_cycles_cuda(planes, kcb, None, 7))
        injected_ms = time_ms(lambda: kp.pushing_cycles_cuda(planes, kcb, u), 20)
        plain_ms = time_ms(lambda: kp.pushing_cycles_plain(planes, kcb, u), 3)
        ops = ops_total((B_MAIN * kcb.num_cycles, 'pushing_cycle_box'))
        bound_ms, bound_by = bound((18 + 17) * 4 * B_MAIN, ops)
        act_l = (torch.rand((2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0
        shapes = cycles_shapes(kcb, planes, torch.cat([P.state_to_planes(box_state(B_LARGE))[:16], act_l]).contiguous())
        kstats['pushing_cycles_box'].update(
            max_abs_err=max(*(e['max_abs_err'] for e in entry.values()),
                            *(v['max_abs_err'] for k, v in shapes.items() if k.startswith(('injected', 'philox')))),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        return {'B': B_MAIN, 'collision': box_coll, **entry, 'shapes': shapes, 'ms': ms, 'ms_groups': ms_groups,
                'ms_spread': spread(ms_groups), 'circle_ms': kstats['pushing_cycles'].get('ms'),
                'bound_ms': bound_ms, 'bound_by': bound_by, 'plain_ms': plain_ms, 'injected_ms': injected_ms,
                'injected_bound_ms': bound((18 + n_noise + 17) * 4 * B_MAIN, ops)[0],
                'ptxas': {k: v for k, v in box_ptxas.items() if 'pushing_cycles_kernel' in k}}

    def box_autoreset_phase(emit: bool):
        state = box_state(B_MAIN, steps=True)
        act = ((torch.rand((2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        st = P.state_to_planes(state)
        n_noise = kp.autoreset_noise_planes(kcb.num_cycles, kcb.cand_k, True)
        u, modes = box_modes(n_noise)
        entry = {}
        for mode, uk, seed, uref in modes:
            got = kp.pushing_autoreset_cuda(st, act, kcb, uk, seed, emit)
            ref = kp.pushing_autoreset_plain(st, act, kcb, uref, emit)
            if emit:
                (got, feat), (ref, ref_feat) = got, ref
                require(torch.equal(feat, kp.features_from_planes(st, got)),
                        f'{mode}: the blocks are not the launch\'s own planes')
                err_feat, ok_feat = compare(feat, ref_feat, feat_rtol, feat_atol)
                require(ok_feat, f'{mode}: feature blocks disagree: {err_feat}')
                entry.setdefault('max_abs_err_features', 0.0)
                entry['max_abs_err_features'] = max(entry['max_abs_err_features'], err_feat)
            err, bad, errs = plane_compare(got, ref)
            restarts = int(((got[18] == 0) & (st[18] > 0)).sum())
            walls = int((got[33] > 0).sum())
            require(not bad, f'{mode}: planes {bad} disagree: {[errs[i] for i in bad]}')
            require(restarts > 0 and walls > 0, f'{mode}: {restarts} restarts, {walls} wall hits')
            entry[mode] = {'max_abs_err': err, 'restarts': restarts, 'wall_hits': walls}
        ms, ms_groups = time_groups(lambda: kp.pushing_autoreset_cuda(st, act, kcb, None, 7, emit))
        st_l = P.state_to_planes(box_state(B_LARGE, steps=True))
        act_l = ((torch.rand((2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        entry['large'] = check_large_autoreset(kcb, st_l, act_l, emit)
        split = split_report(lambda s_, a_: kp.pushing_autoreset_cuda(s_, a_, kcb, None, 7, emit), (st, act),
                             (st_l, act_l), 'pushing_autoreset_kernelILb0ELb1ELb0EL' + ('b1E' if emit else 'b0E'), kcb)
        injected_ms = time_ms(lambda: kp.pushing_autoreset_cuda(st, act, kcb, u, 0, emit), 20)
        plain_ms = time_ms(lambda: kp.pushing_autoreset_plain(st, act, kcb, u, emit), 3)
        ops = B_MAIN * (box_step_ops() + (sum(OPS['pushing_features']) if emit else 0))
        n_out = 36 + (24 if emit else 0)
        bound_ms, bound_by = bound((21 + n_out) * 4 * B_MAIN, ops)
        name = 'pushing_autoreset_features_box' if emit else 'pushing_autoreset_box'
        circle = 'pushing_autoreset_features' if emit else 'pushing_autoreset'
        err = max(entry[m]['max_abs_err'] for m in ('injected', 'philox'))
        kstats[name].update(max_abs_err=entry.get('max_abs_err_features', err), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        kernel = 'ILb0ELb1ELb0ELb1E' if emit else 'ILb0ELb1ELb0ELb0E'  # acc, box, Philox, emit
        return {'B': B_MAIN, 'collision': box_coll, **entry, 'ms': ms, 'ms_groups': ms_groups, **split,
                'ms_spread': spread(ms_groups), 'circle_ms': kstats[circle].get('ms'), 'bound_ms': bound_ms,
                'bound_by': bound_by, 'plain_ms': plain_ms, 'injected_ms': injected_ms,
                'injected_bound_ms': bound((21 + n_noise + n_out) * 4 * B_MAIN, ops)[0],
                'ptxas': {k: v for k, v in box_ptxas.items() if 'pushing_autoreset_kernel' + kernel in k}}

    phase('kernel_C_box')(lambda: box_autoreset_phase(False))
    phase('kernel_C_feat_box')(lambda: box_autoreset_phase(True))

    @phase('kernel_D_box')
    def _():
        st = P.state_to_planes(box_state(B_MAIN))
        acts = ((torch.rand((K_MAIN, 2, B_MAIN), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        n_step = kp.autoreset_noise_planes(kcb.num_cycles, kcb.cand_k, True)
        rtol = torch.tensor([plane_tol(i)[0] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        atol = torch.tensor([plane_tol(i)[1] for i in range(kp.N_STATE)], device=dev)[:, None] * 10
        entry = {}
        # held against the plain version over K_G_CHECK steps in both modes
        # (the envs whose whole trajectory agrees at the plane tolerances
        # x10, as phase 3), timed at K_MAIN
        a = acts[:K_G_CHECK]
        u = torch.rand((K_G_CHECK * n_step, B_MAIN), generator=gen, device=dev)
        for mode, uk, seed, uref in (('injected', u, 0, u), ('philox', None, 7, philox(7, K_G_CHECK * n_step, B_MAIN))):
            got_st, got_sig = kp.pushing_rollout_cuda(st, a, kcb, uk, seed)
            ref_st, ref_sig = kp.pushing_rollout_plain(st, a, kcb, uref)
            require(bool(torch.isfinite(got_st).all()), f'{mode}: kernel D state is not finite')
            d_state = (got_st - ref_st).abs()
            env_ok = (d_state <= atol + rtol * ref_st.abs()).all(0) & (got_sig == ref_sig).all(0).all(0)
            frac = float(env_ok.double().mean())
            walls = int((got_sig[0] > 0.5).sum())
            require(frac >= 0.99, f'{mode}: only {frac:.4f} of envs agree over {K_G_CHECK} steps')
            require(walls > 0, f'{mode}: no wall hit in {K_G_CHECK} steps')
            entry[mode] = {'k': K_G_CHECK, 'envs_agreeing': frac, 'wall_hits': walls,
                           'max_abs_err_agreeing_envs': float(d_state[:, env_ok].max())}
        u32 = torch.rand((K_MAIN * n_step, B_MAIN), generator=gen, device=dev)
        ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kcb, None, 7), 5)
        st_l = P.state_to_planes(box_state(B_LARGE))
        entry['large'] = check_large_rollout(kcb, st_l)
        acts_l = ((torch.rand((K_MAIN, 2, B_LARGE), generator=gen, device=dev) * 2 - 1) * 8.0).contiguous()
        split = split_report(lambda s_, a_: kp.pushing_rollout_cuda(s_, a_, kcb, None, 7), (st, acts), (st_l, acts_l),
                             'pushing_rollout_kernelILb0ELb1ELb0E', kcb, 'rollout', grouped=False)
        injected_ms = time_ms(lambda: kp.pushing_rollout_cuda(st, acts, kcb, u32), 5)
        plain_ms = time_ms(lambda: kp.pushing_rollout_plain(st, acts, kcb, u32), 1, warmup=0)
        ops = K_MAIN * B_MAIN * box_step_ops()
        bound_ms, bound_by = bound((19 + K_MAIN * (2 + 3) + 19) * 4 * B_MAIN, ops)
        kstats['pushing_rollout_box'].update(
            max_abs_err=max(entry[m]['max_abs_err_agreeing_envs'] for m in ('injected', 'philox')), ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        return {'B': B_MAIN, 'K_timed': K_MAIN, 'collision': box_coll, **entry, 'ms': ms, **split,
                'circle_ms': kstats['pushing_rollout'].get('ms'), 'bound_ms': bound_ms, 'bound_by': bound_by,
                'plain_ms': plain_ms, 'injected_ms': injected_ms,
                'injected_bound_ms': bound((19 + K_MAIN * (2 + n_step + 3) + 19) * 4 * B_MAIN, ops)[0],
                'ptxas': {k: v for k, v in box_ptxas.items() if 'pushing_rollout_kernel' in k}}

    # -- 21. the box main path ---------------------------------------------------------------
    @phase('box_pushing_main_path')
    def _():
        g = torch.Generator(device=dev).manual_seed(30)
        pcfg = PPO.PPOConfig(obs_dim=12, action_dim=2, hidden=(256, 256), rollout_steps=T_ROLL)
        policy = PPO.init_params(pcfg, torch.Generator(device=dev).manual_seed(31), device=dev)

        def policy_step(pol, eps_t, obs_pm):
            mu, log_std, value = PPO.apply_pm(pol, obs_pm)
            return torch.clamp(mu + torch.exp(log_std)[:, None] * eps_t, -10.0, 10.0), value

        kernels.reset_launches()
        state, _, info = P.init_batch(cfg_box, prm_box, B_MAIN, g)
        step = P.make_fused_step(cfg_box, prm_box)
        s = state
        for _ in range(3):
            s, *_ = step(s, torch.full((B_MAIN, 2), 3.0, device=dev), generator=g)
        step_ar = P.make_fused_step_autoreset(cfg_box, prm_box)
        s, rewards = state, []
        for _ in range(5):
            s, o, r, te, tr, inf = step_ar(s, (torch.rand((B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0,
                                           generator=g)
            rewards.append(r)
        acts = (torch.rand((T_ROLL, B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
        outs = {K: P.make_fused_rollout(cfg_box, prm_box, steps_per_launch=K)(s, acts, 200 + K) for K in (1, K_MAIN)}
        reactive = P.make_reactive_rollout(cfg_box, prm_box, policy_step, T_ROLL)
        with torch.no_grad():
            eps = torch.randn((T_ROLL, 2, B_MAIN), generator=g, device=dev)
            rs, traj, last = reactive(s, policy, g, 300, policy_xs=eps)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        require(all(launches[k] > 0 for k in BOX_KERNELS), f'a box kernel of the path never launched: {launches}')
        require(all(launches[k] == 0 for k in PUSHING_KERNELS[1:] + TRAIN_KERNELS),
                f'a circle kernel ran on the box path: {launches}')
        require(bool(~info['reset_stalled'].any()) and not bool(info['wall_collision'].any()), 'init_batch')
        checks = {}
        for K, (fs, rew, term, trunc) in outs.items():
            for name in ('pos', 'vel', 'obj_pos', 'goal', 'mover_z', 'obj_yaw'):
                require(bool(torch.isfinite(getattr(fs, name)).all()), f'K={K}: {name} not finite')
            require(set(torch.unique(rew).tolist()) <= {0.0, -1.0, -50.0}, f'K={K}: rewards {torch.unique(rew)}')
            require(float(torch.linalg.vector_norm(fs.vel, dim=-1).max()) <= float(prm_box.v_max) * 1.01, f'K={K}: |v|')
            require(bool(((fs.goal >= prm_box.obj_min_xy) & (fs.goal <= prm_box.obj_max_xy)).all()), f'K={K}: goal')
            require(bool(term.any()), f'K={K}: no wall hit in {T_ROLL} steps')
            checks[K] = {'terminations': int(term.sum()), 'truncations': int(trunc.sum()),
                         'reward_mean': float(rew.mean())}
        obs_vec, _, r_react, te_react, _, _ = traj
        require(bool(torch.isfinite(obs_vec).all() and torch.isfinite(rs.pos).all()), 'reactive: not finite')
        require(obs_vec.shape == (T_ROLL, B_MAIN, 12) and last.shape == (B_MAIN, 12), 'reactive: shapes')
        checks['reactive'] = {'T': T_ROLL, 'hidden': list(pcfg.hidden),
                              'terminations': int(te_react.sum()), 'reward_mean': float(r_react.mean())}

        # the eager step against kernel B at std_noise = 0 (phase 18's
        # scenario): flags equal, fields at phase 18's tolerances; then the
        # eager step_autoreset for a few steps
        cfg0, prm0 = P.make_pushing_env(collision_params=box_coll, std_noise=0.0, device=dev)
        g0 = torch.Generator(device=dev).manual_seed(32)
        s0 = planted_state(P, cfg0, prm0, B_EAGER, g0)
        wall = (torch.arange(B_EAGER, device=dev) % 4 == 1)
        s0.pos[wall, 0] = torch.linspace(0.09, 0.13, int(wall.sum()), device=dev)
        s0.vel[wall] = torch.tensor([-1.0, 0.2], device=dev)
        a0 = (torch.rand((B_EAGER, 2), generator=g0, device=dev) * 2 - 1) * 8.0
        es, _, _, _, _, ei = P.step(cfg0, prm0, s0, a0, generator=g0)
        fs, _, _, _, _, fi = P.make_fused_step(cfg0, prm0)(s0, a0, seed=7, generator=g0)
        require(torch.equal(ei['wall_collision'], fi['wall_collision']), 'eager box step: wall flags differ from B')
        errs = state_errs(es, fs, ((('pos', 'vel', 'obj_pos', 'obj_vel'), 2e-6, 2e-6), (('acc',), 1e-4, 1e-5),
                                   (('obj_yaw',), 1e-4, 1e-6), (('mover_z',), 3e-5, 3e-6),
                                   (('obj_w', 'mover_vz'), 3e-5, 1e-4)))
        se, ends = s0, 0
        for _ in range(T_BOX_EAGER):
            se, _, _, te, tr, _ = P.step_autoreset(cfg_box, prm_box, se, a0, generator=g0)
            ends += int((te | tr).sum())
        require(bool(torch.isfinite(se.pos).all()) and ends > 0, f'eager step_autoreset: {ends} episode ends')
        return {'B': B_MAIN, 'collision': box_coll, 'launches': launches, 'rollouts': checks,
                'eager_vs_B': {'B': B_EAGER, 'max_abs_err': errs, 'wall_hits': int(ei['wall_collision'].sum()),
                               'objects_moved': int(((es.obj_pos - s0.obj_pos).abs() > 1e-5).any(-1).sum())},
                'eager_step_autoreset': {'B': B_EAGER, 'steps': T_BOX_EAGER, 'episode_ends': ends}}

    box_launches = report['phases']['box_pushing_main_path'].get('launches', {})

    # -- 22. mesh movers: pushing's mesh+bumper rollout, planning's fused step ----------------
    @phase('mesh_bumper')
    def _():
        # the JAX package's 'pushing mesh+bumper 4096 envs' row (bench.py:643-644)
        mesh = {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}
        cfgm, prmm = P.make_pushing_env(mover_params=mesh, device=dev)
        g = torch.Generator(device=dev).manual_seed(33)
        state, _, _ = P.init_batch(cfgm, prmm, B_MAIN, g)
        acts = (torch.rand((T_ROLL, B_MAIN, 2), generator=g, device=dev) * 2 - 1) * 10.0
        paths = {'mesh_bumper': P.make_fused_rollout(cfgm, prmm), 'default_mover': P.make_fused_rollout(config, params)}
        for fn in paths.values():
            fn(state, acts, 1)
        ev = {k: [] for k in paths}
        for rep in range(5):  # alternating repeats
            for name, fn in paths.items():
                (fs, rew, term, trunc), ms, _ = timed(lambda fn=fn, rep=rep: fn(state, acts, 2 + rep))
                ev[name].append(ms)
        require(bool(torch.isfinite(fs.pos).all()) and bool((term | trunc).any()), 'mesh rollout')
        rates = {k: B_MAIN * T_ROLL / (statistics.median(v) / 1e3) for k, v in ev.items()}
        # planning's fused step (kernel F) with mesh movers and a bumper
        # (accel_scale < 1), against its plain version in both modes
        pcfg, pprm = PL.make_planning_env(np.ones((3, 3)), 1, mover_params=mesh, device=dev)
        pkc = kpl.make_kernel_consts(pcfg, pprm)
        st = PL.state_to_planes(pcfg, wall_state(pcfg, pprm, B_MAIN, 34, spread_steps=True))
        act = ((torch.rand((2, B_MAIN), generator=g, device=dev) * 2 - 1) * 10.0).contiguous()
        n_noise = kpl.autoreset_noise_planes(pcfg.num_cycles, pkc.cand_k, pkc.box)
        u = torch.rand((n_noise, B_MAIN), generator=g, device=dev)
        plan = {}
        for mode, uk, seed, uref in (('injected', u, 0, u), ('philox', None, 7, philox(7, n_noise, B_MAIN))):
            ref = kpl.planning_autoreset_plain(st, act, pkc, uref)
            for producer in (0, 1):
                got = with_producer(producer, lambda: kpl.planning_autoreset_cuda(st, act, pkc, uk, seed), kpl)
                e, bad = planes_check(got, ref, exact=(8, 19, 20, 21, 22))
                require(not bad, f'planning mesh ({mode}, producer {producer}): planes {bad} disagree')
                plan[f'{mode}_producer_{producer}'] = {'max_abs_err': e, 'wall_hits': int((got[19] > 0).sum())}
        return {'B': B_MAIN, 'T': T_ROLL, 'K': 1, 'card': card, 'mover': mesh,
                'accel_scale': float(prmm.accel_scale), 'mover_half': prmm.mover_half.tolist(),
                'ms_runs': ev, 'env_steps_per_s': rates,
                'planning_kernel_F': dict(plan, accel_scale=float(pprm.accel_scale[0]),
                                          tol=f'flags exact, planes rtol {plan_rtol} atol {plan_atol}')}

    # -- 23. no fused step waits for the host ----------------------------------------------
    @phase('fused_steps_stay_on_card')
    def _():
        """Every fused step with a generator on the card, under sync debug
        mode 'warn': the Philox seed is drawn on the card and read by the
        kernel there, so no step copies anything to the host."""
        g = torch.Generator(device=dev).manual_seed(35)
        cfg1, prm1 = PL.make_planning_env(np.ones((3, 3)), 1, device=dev)
        cfg4, prm4 = PL.make_planning_env(np.ones((4, 4)), M_MAIN, device=dev)
        cfg12, prm12 = PL.make_planning_env(np.ones((8, 8)), M_WIDE, device=dev)
        s_push = P.init_batch(config, params, B_MAIN, g)[0]
        s_box = P.init_batch(cfg_box, prm_box, B_MAIN, g)[0]
        s1 = PL.init_batch(cfg1, prm1, B_MAIN, g)[0]
        s4 = PL.init_batch(cfg4, prm4, B_MAIN, g)[0]
        s12 = PL.init_batch(cfg12, prm12, B_MAIN, g)[0]
        a2 = torch.ones((B_MAIN, 2), device=dev)
        a4 = torch.ones((B_MAIN, M_MAIN, 2), device=dev)
        a12 = torch.ones((B_MAIN, M_WIDE, 2), device=dev)
        steps = {
            'pushing make_fused_step': (P.make_fused_step(config, params), s_push, a2),
            'pushing make_fused_step_autoreset': (P.make_fused_step_autoreset(config, params), s_push, a2),
            'pushing box make_fused_step_autoreset': (P.make_fused_step_autoreset(cfg_box, prm_box), s_box, a2),
            'planning make_fused_step': (PL.make_fused_step(cfg1, prm1), s1, a2),
            'planning make_fused_step_autoreset': (PL.make_fused_step_autoreset(cfg1, prm1), s1, a2),
            'planning 4-mover make_fused_step_autoreset': (PL.make_fused_step_autoreset(cfg4, prm4), s4, a4),
            'multi_agent make_batched_parallel_step': (multi_agent.make_batched_parallel_step(cfg4, prm4), s4, a4),
            'planning 12-mover make_fused_step_autoreset': (PL.make_fused_step_autoreset(cfg12, prm12), s12, a12),
            'multi_agent 12-mover make_batched_parallel_step': (multi_agent.make_batched_parallel_step(cfg12, prm12),
                                                                s12, a12),
        }
        res = {}
        for name, (fn, s, a) in steps.items():
            fn(s, a, generator=g)  # warm-up
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    fn(s, a, generator=g)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = [str(w.message)[:160] for w in caught if 'called a synchronizing' in str(w.message)]
            res[name] = {'host_syncs': len(syncs), 'messages': syncs[:3]}
        bad = {k: v for k, v in res.items() if v['host_syncs']}
        require(not bad, f'fused steps wait on the host: {bad}')
        return {'B': B_MAIN, 'generator': 'on the card', 'steps': res}

    # -- 24. DDPG/TD3+HER on pushing's fused step -------------------------------------------
    from gymnasium_planar_robotics_tpu_torch.models import her
    from gymnasium_planar_robotics_tpu_torch.tools import her_gate
    from gymnasium_planar_robotics_tpu_torch.tools import train_push_her as TPH
    from gymnasium_planar_robotics_tpu_torch.utils import checkpoint

    def syncs_in(fn):
        """(result of ``fn()``, the host synchronisations it made) under
        sync debug mode 'warn'."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            torch.cuda.set_sync_debug_mode('warn')
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum('called a synchronizing' in str(w.message) for w in caught)

    def require_full_f32():
        """HER's products run in full float32, as the JAX package's."""
        require(torch.get_float32_matmul_precision() == 'highest' and not torch.backends.cuda.matmul.allow_tf32,
                f'float32 matmul precision {torch.get_float32_matmul_precision()!r}, '
                f'TF32 {torch.backends.cuda.matmul.allow_tf32}')

    def relabel_insert(step, traj, buf, g):
        batch, rel = step.relabel(traj, g)
        her._replay_insert(buf, batch)
        return batch, rel

    @phase('her_pushing_main_path')
    def _():
        """The ``train_push_her.py`` recipe's train step at its defaults
        ((256, 256), 50 rollout steps, 20 updates at minibatch 4096, a 4M
        replay buffer, the fused step: kernel C) at HER_BATCHES envs: one
        warm-up iteration, then HER_ITERS iterations split by CUDA events
        into rollout, relabel + insert and update, launch counters set to 0
        before each and read after."""
        res = {}
        for b in HER_BATCHES:
            args = TPH.parser().parse_args(['--batch', str(b), '--seed', '3', '--device', DEVICE])
            _, _, hcfg, step, runner = TPH.build(args)
            require_full_f32()
            torch.cuda.reset_peak_memory_stats(dev)
            runner, _ = step(runner)  # warm-up
            torch.cuda.synchronize()
            state, obs, nets, a_opt, c_opt, buf, g = runner
            parts = {'rollout': [], 'relabel_insert': [], 'update': []}
            syncs = {k: [] for k in parts}
            launches = []
            iter_ms = []
            for _ in range(HER_ITERS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                kernels.reset_launches()
                t0 = time.perf_counter()
                ev[0].record()
                (state, obs, traj), n = syncs_in(lambda: step.collect(state, obs, nets, g))
                syncs['rollout'].append(n)
                ev[1].record()
                (batch, _), n = syncs_in(lambda: relabel_insert(step, traj, buf, g))
                syncs['relabel_insert'].append(n)
                ev[2].record()
                (c_l, a_l), n = syncs_in(lambda: step.update(nets, a_opt, c_opt, batch, buf, g))
                syncs['update'].append(n)
                ev[3].record()
                torch.cuda.synchronize()
                iter_ms.append((time.perf_counter() - t0) * 1e3)
                launches.append(dict(kernels.LAUNCHES))
                for k, i in zip(parts, range(3)):
                    parts[k].append(ev[i].elapsed_time(ev[i + 1]))
                require(bool(torch.isfinite(c_l)) and bool(torch.isfinite(a_l)), f'B={b}: losses not finite')
            per_iter = [lc['pushing_autoreset'] for lc in launches]
            require(all(n == hcfg.rollout_steps for n in per_iter), f'B={b}: kernel C launched {per_iter} times '
                                                                    f'an iteration, expected {hcfg.rollout_steps}')
            require(all(sum(lc.values()) == lc['pushing_autoreset'] for lc in launches),
                    f'B={b}: other kernels launched: {launches[-1]}')
            require(not any(syncs['rollout']), f'B={b}: the rollout synchronised with the host {syncs["rollout"]}')
            require(buf['filled'] == min((HER_ITERS + 1) * 2 * hcfg.rollout_steps * b, hcfg.replay_size),
                    f'B={b}: replay filled {buf["filled"]}')
            med = statistics.median(iter_ms)
            res[f'B={b}'] = {
                'iter_ms_host_clock': iter_ms, 'iter_ms_median': med,
                'parts_ms': parts, 'parts_ms_median': {k: statistics.median(v) for k, v in parts.items()},
                'env_steps_per_s': b * hcfg.rollout_steps / (med / 1e3),
                'kernel_C_launches_per_iter': per_iter, 'host_syncs': syncs,
                'replay_bytes': sum(buf[k].numel() * buf[k].element_size() for k in her.REPLAY_FIELDS),
                'replay_filled': buf['filled'],
                'peak_memory_bytes': torch.cuda.max_memory_allocated(dev)}
        return {'card': card, 'recipe': 'train_push_her.py defaults (DDPG, (256, 256), 20 updates, minibatch 4096, '
                'replay 4M, fused)', 'iters': HER_ITERS, **res}

    @phase('her_planning_learns')
    def _():
        """The gate of the JAX package's HER learning test on the card
        (``tools/her_gate.py``): DDPG+HER on sparse 1-mover planning (3x3,
        ``std_noise=1e-5``, ``a_max`` 3, 256 envs, (64, 64), 16 rollout
        steps, 8 updates, no replay) over planning's fused step (kernel F),
        250 iterations with and without relabelling, at the fixed seed 0 (as
        the JAX test runs at its fixed seed; the run is deterministic on the
        card).  Fails unless all three thresholds hold: late > early + 0.08,
        late > 0.38, and late > late without relabelling + 0.10; also on a
        non-finite rate, kernel F not launched once a rollout step, or
        products not in full float32."""
        res = her_gate.gate(0, HER_GATE_ITERS, DEVICE)
        require(res['finite'], 'a non-finite episode success rate')
        require(res['kernel_F_launches'] == 2 * HER_GATE_ITERS * 16,
                f'kernel F launched {res["kernel_F_launches"]} times, expected {2 * HER_GATE_ITERS * 16}')
        require_full_f32()
        nums = f'early {res["early"]}, late {res["late"]}, late without relabelling {res["late_no_relabel"]}'
        require(res['lift_held'], f'the gate: late not above early + 0.08 ({nums})')
        require(res['level_held'], f'the gate: late not above 0.38 ({nums})')
        require(res['relabel_held'], f'the gate: late not above late without relabelling + 0.10 ({nums})')
        return res

    @phase('checkpoint_round_trip')
    def _():
        """The HER runner on the card (the recipe at 512 envs, a 262,144-
        transition replay buffer), saved after 2 iterations and restored
        into a fresh runner: bit-equal, and its next iteration's metrics,
        weights, Adam moments and buffer equal the uninterrupted run's bit
        for bit."""
        import tempfile

        argv = ['--batch', '512', '--replay', '262144', '--device', DEVICE, '--seed', '4']

        def fresh(seed_argv=argv):
            return TPH.build(TPH.parser().parse_args(seed_argv))[3:]

        step, runner = fresh()
        for _ in range(2):
            runner, _ = step(runner)
        (ROOT / 'chiprun_out').mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / 'chiprun_out') as tmp:
            t0 = time.perf_counter()
            checkpoint.save(tmp, runner, step=2)
            save_s = time.perf_counter() - t0
            step2, other = fresh(argv[:-1] + ['9'])
            t0 = time.perf_counter()
            restored = checkpoint.restore(tmp, other)
            restore_s = time.perf_counter() - t0
            require(checkpoint.saved_step(tmp) == 2, 'saved step')

        def flat(r):
            state, obs, nets, a_opt, c_opt, buf, g = r
            out = [getattr(state, f.name) for f in dataclasses.fields(state)] + list(obs.values())
            out += list(nets.state_dict().values()) + [buf[k] for k in her.REPLAY_FIELDS] + [g.get_state()]
            for opt in (a_opt, c_opt):
                out += [v for st_ in opt.state_dict()['state'].values() for v in st_.values()]
            return out, (buf['ptr'], buf['filled'])

        a, ints_a = flat(runner)
        b_, ints_b = flat(restored)
        require(ints_a == ints_b and len(a) == len(b_) and all(torch.equal(x, y) for x, y in zip(a, b_)),
                'the restored runner differs from the saved one')
        runner, m_full = step(runner)
        restored, m_res = step2(restored)
        same_metrics = all(torch.equal(m_full[k], m_res[k]) for k in m_full)
        a, _ = flat(runner)
        b_, _ = flat(restored)
        differ = sum(not torch.equal(x, y) for x, y in zip(a, b_))
        require(same_metrics and differ == 0, f'resumed iteration differs: metrics equal {same_metrics}, '
                                              f'{differ} tensors differ')
        return {'tensors': len(a), 'checkpoint_bytes': sum(x.numel() * x.element_size() for x in a),
                'save_s': save_s, 'restore_s': restore_s, 'bit_equal': True}

    # -- 27. the adapters' card path: envs/runner.py (this machine has no gymnasium) ---------
    from gymnasium_planar_robotics_tpu_torch.envs import runner as env_runner

    box_size = {'shape': 'box', 'size': [0.09, 0.09]}
    adapter_envs = {
        'pushing': lambda: P.make_pushing_env(device=dev),
        'pushing_box': lambda: P.make_pushing_env(collision_params=box_size, device=dev),
        'planning_m1': lambda: PL.make_planning_env(np.ones((3, 3)), 1, device=dev),
        'planning_m4': lambda: PL.make_planning_env(np.ones((4, 4)), M_MAIN, device=dev),
    }
    adapter_kernel = {'pushing': 'pushing_autoreset', 'pushing_box': 'pushing_autoreset_box',
                      'planning_m1': 'planning_autoreset', 'planning_m4': 'planning_multi_autoreset'}

    def launches_in(fn):
        """(result of ``fn()``, the kernel launches it made, the host
        synchronisations sync debug mode saw in it)."""
        before = dict(kernels.LAUNCHES)
        out, calls = syncs_in(fn)
        return out, {k: v - before[k] for k, v in kernels.LAUNCHES.items() if v != before[k]}, calls

    def drive_vector(cfg, prm, b, steps, state=None, seed=7):
        """The vector runner over ``steps`` steps of random actions (and a
        warm-up step before them): (runner, ms a step, launches a step,
        episode ends, the replay ``check_vector`` holds it against)."""
        vr = env_runner.VectorRunner(cfg, prm, b)
        require(vr.using_fused, 'the vector runner would step eagerly')
        vr.seed(seed)
        if state is None:
            vr.reset()
        else:  # planted (init_batch's candidate sets of many movers would not fit the card)
            vr.state = state
        start = (type(vr.state)(**{k: v.clone() for k, v in vars(vr.state).items()}), vr.generator.get_state())
        rng = np.random.default_rng(seed)
        limit = float(prm.j_max if cfg.learn_jerk else prm.a_max)
        n = 2 * getattr(cfg, 'num_movers', 1)
        ms, per_step, ends, acts, outs = [], [], 0, [], []
        for t in range(steps + 1):  # the first step is a warm-up
            acts.append(rng.uniform(-limit, limit, (b, n)).astype(np.float32))
            syncs0 = vr.host.host_syncs
            t0 = time.perf_counter()
            out, launched, calls = launches_in(lambda: vr.step(acts[-1]))
            if t:
                ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(launched)
            outs.append(out)
            require(vr.host.host_syncs == syncs0 + 1 and calls == 0, f'step {t}: {calls} hidden host syncs')
            ends += int(out[2].sum() + out[3].sum())
        return vr, ms, per_step, ends, (cfg, prm, start, acts, outs)

    def check_vector(replay):
        """Each step of a vector runner's drive bit for bit against the fused
        step called directly from the same state and generator state."""
        cfg, prm, (st, gen_state), acts, outs = replay
        direct = (P if cfg.__class__ is P.PushingConfig else PL).make_fused_step_autoreset(cfg, prm)
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        for t, (a, out) in enumerate(zip(acts, outs)):
            st, *want = direct(st, torch.from_numpy(a).to(dev), generator=g)
            got = [x for x in env_runner.leaves(out, []) if isinstance(x, np.ndarray)]
            want = [x.cpu().numpy() for x in env_runner.leaves(tuple(want), [])]
            require(len(got) == len(want) and all(np.array_equal(x, y) for x, y in zip(got, want)),
                    f'step {t}: the runner differs from the direct fused step')

    @phase('adapters_main_path')
    def _():
        """The adapters' card path: the single-env runner (the Gym and
        PettingZoo envs' eager step, kernel A) for pushing and 1- and
        4-mover planning, 50 steps around a reset; the vector runner (the
        vector envs' fused autoreset step) at 4096 envs for pushing, box
        pushing, 1- and 4-mover planning, and at 129 movers (kernel H's
        many-mover variant); counters set to 0 before and read after."""
        res = {'single': {}, 'vector': {}, 'card': card}
        kernels.reset_launches()
        for name in ('pushing', 'planning_m1', 'planning_m4'):
            cfg, prm = adapter_envs[name]()
            er = env_runner.EnvRunner(cfg, prm)
            er.seed(12)
            rng = np.random.default_rng(12)
            limit = float(prm.j_max if cfg.learn_jerk else prm.a_max)
            n = 2 * getattr(cfg, 'num_movers', 1)
            er.reset()
            ms, a_per_step, resets = [], [], 0
            for t in range(T_ADAPTER + 1):  # the first step is a warm-up
                syncs0 = er.host.host_syncs
                t0 = time.perf_counter()
                out, launched, calls = launches_in(lambda: er.step(rng.uniform(-limit, limit, n)))
                if t:
                    ms.append((time.perf_counter() - t0) * 1e3)
                require(set(launched) == {'noise_probe'} and er.host.host_syncs == syncs0 + 1 and calls == 0,
                        f'{name} step {t}: launches {launched}, {calls} hidden host syncs')
                require(bool(np.isfinite(out[0]['observation']).all()), f'{name}: observation not finite')
                a_per_step.append(launched['noise_probe'])
                if out[2] or er.steps >= cfg.max_episode_steps:
                    er.reset()
                    resets += 1
            res['single'][name] = {'B': 1, 'steps': T_ADAPTER, 'ms_median': statistics.median(ms), 'ms_min': min(ms),
                                   'ms_max': max(ms), 'A_launches_per_step': statistics.mean(a_per_step),
                                   'host_syncs_per_step': 1, 'resets': resets}
        replays = []
        for name in ('pushing', 'pushing_box', 'planning_m1', 'planning_m4'):
            cfg, prm = adapter_envs[name]()
            vr, ms, per_step, ends, replay = drive_vector(cfg, prm, B_MAIN, T_VECTOR)
            replays.append(replay)
            require(all(ls == {adapter_kernel[name]: 1} for ls in per_step), f'{name}: launches {per_step[:3]}')
            med = statistics.median(ms)
            res['vector'][name] = {'B': B_MAIN, 'using_fused': vr.using_fused, 'steps': T_VECTOR, 'ms_median': med,
                                   'ms_min': min(ms), 'ms_max': max(ms), 'env_steps_per_s': B_MAIN / (med / 1e3),
                                   'launches_per_step': per_step[-1], 'host_syncs_per_step': 1, 'episode_ends': ends}
        # 129 movers from the slots of a full table (random sets of this many
        # are never apart): kernel H's many-mover variant
        m = H_MANY_MOVERS[0]
        cfg, prm, _, _ = ladder_state(m, False, 1, 40, device=DEVICE)
        nx = math.ceil(math.sqrt(m))
        slots = [(0.3 + 0.42 * i, 0.3 + 0.42 * j) for i in range(nx) for j in range(nx)][:m]
        g = torch.Generator(device=dev).manual_seed(27)
        state = PL.reset(cfg, prm, B_MAIN, g, start_xy=slots, goals_xy=slots[::-1])[0]
        vr, ms, per_step, ends, replay = drive_vector(cfg, prm, B_MAIN, 3, state=state)
        replays.append(replay)
        require(all(ls == {'planning_multi_autoreset_many': 1} for ls in per_step), f'M={m}: launches {per_step}')
        med = statistics.median(ms)
        res['vector'][f'planning_m{m}'] = {'B': B_MAIN, 'using_fused': vr.using_fused, 'steps': 3, 'ms_median': med,
                                            'env_steps_per_s': B_MAIN / (med / 1e3), 'launches_per_step': per_step[-1]}
        torch.cuda.synchronize()
        res['launches'] = dict(kernels.LAUNCHES)
        for replay in replays:  # after the counts are read: these launches are not the path's
            check_vector(replay)
        return res

    adapter_launches = report['phases']['adapters_main_path'].get('launches', {})

    # -- 28. the sharded paths at world size 1 (parallel/sharding.py over NCCL) ---------------
    import torch.distributed as torch_dist

    from gymnasium_planar_robotics_tpu_torch.models import ppo
    from gymnasium_planar_robotics_tpu_torch.parallel import sharding

    def leaves_equal(a, b) -> bool:
        """Every tensor of two outputs (states, dicts, tuples) equal, bit for bit."""
        la = [x for x in env_runner.leaves(a, []) if isinstance(x, torch.Tensor)]
        lb = [x for x in env_runner.leaves(b, []) if isinstance(x, torch.Tensor)]
        return len(la) == len(lb) > 0 and all(torch.equal(x, y) for x, y in zip(la, lb))

    def as_tree(state):
        return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}

    def twin_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)

    @phase('sharded_main_path')
    def _():
        """The sharded fused steps (pushing C, 1-mover planning F, 4-mover
        planning H), the sharded rollouts at K=1 and K=32 (C/D, F/G) and the
        sharded reactive rollout (C-feat) on a world-size-1 NCCL group at
        4096 envs, counters set to 0 before and read after; then each held
        bit for bit against its unsharded twin from the same generator state
        or seed (a card seed tensor too), no host synchronisation in a
        sharded step, ``metrics_summary`` through NCCL against the local
        means, and ms a step of sharded and unsharded steps alternating."""
        mesh = sharding.make_mesh(dev)
        require(mesh.size() == 1 and torch_dist.get_backend() == 'nccl',
                f'world {mesh.size()}, backend {torch_dist.get_backend()}')
        cfg1, prm1 = PL.make_planning_env(np.ones((3, 3)), 1, device=dev)
        cfg4, prm4 = PL.make_planning_env(np.ones((4, 4)), M_MAIN, device=dev)
        g0 = torch.Generator(device=dev).manual_seed(28)
        fams = {'pushing': (P, config, params, 2), 'planning_m1': (PL, cfg1, prm1, 2),
                'planning_m4': (PL, cfg4, prm4, 2 * M_MAIN)}
        starts = {k: m.init_batch(c, p, B_MAIN, g0)[0] for k, (m, c, p, _) in fams.items()}
        acts = {k: 2.0 * torch.rand((B_MAIN, n), generator=g0, device=dev) - 1.0 for k, (_, _, _, n) in fams.items()}
        steps = {k: sharding.make_sharded_fused_step(m, c, p, mesh) for k, (m, c, p, _) in fams.items()}
        rolls = {(k, kk): sharding.make_sharded_fused_rollout(fams[k][0], fams[k][1], fams[k][2], mesh,
                                                              steps_per_launch=kk)
                 for k in ('pushing', 'planning_m1') for kk in (1, K_MAIN)}
        roll_acts = {k: 2.0 * torch.rand((K_MAIN, B_MAIN, 2), generator=g0, device=dev) - 1.0
                     for k in ('pushing', 'planning_m1')}
        pcfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(256, 256), rollout_steps=K_MAIN, action_scale=10.0)
        pol = ppo.init_params(pcfg, torch.Generator(device=dev).manual_seed(3), device=dev)

        def policy_step(p, gen, obs_pm):
            action, raw, logp, value = ppo.sample_action_pm(p, obs_pm, gen, pcfg.action_scale)
            return action, (raw, logp, value)

        react = sharding.make_sharded_reactive_rollout(P, config, params, policy_step, K_MAIN, mesh)
        seed_t = torch.tensor([4321], dtype=torch.int64, device=dev)

        # the drive: every sharded function once (generators cloned for the twins)
        kernels.reset_launches()
        out, gens = {}, {}
        with torch.no_grad():
            for k in fams:
                gs, gens[k] = twin_gen(100 + len(out))
                out[k] = steps[k](starts[k], acts[k], generator=gs)
                out[k + '_seed'] = steps[k](starts[k], acts[k], seed=seed_t)
            for (k, kk), roll in rolls.items():
                out[('roll', k, kk)] = roll(starts[k], roll_acts[k], 77)
                out[('roll_t', k, kk)] = roll(starts[k], roll_acts[k], seed_t)
            gs, gens['react'] = twin_gen(29)
            out['react'] = react(starts['pushing'], pol, gs, 500)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        path = ('pushing_autoreset', 'pushing_rollout', 'pushing_autoreset_features', 'planning_autoreset',
                'planning_rollout', 'planning_multi_autoreset')
        require(all(launches.get(k, 0) > 0 for k in path), f'kernels of the sharded path not launched: {launches}')

        # the twins, after the count
        with torch.no_grad():
            def same(got, want) -> bool:
                return leaves_equal((as_tree(got[0]), got[1:]), (as_tree(want[0]), want[1:]))

            for k, (m, c, p, _) in fams.items():
                un = m.make_fused_step_autoreset(c, p)
                require(same(out[k], un(starts[k], acts[k], generator=gens[k])),
                        f'{k}: the sharded step differs from the unsharded one')
                require(same(out[k + '_seed'], un(starts[k], acts[k], seed=seed_t)),
                        f'{k}: the sharded step under a card seed differs')
            for (k, kk) in rolls:
                un = fams[k][0].make_fused_rollout(fams[k][1], fams[k][2], steps_per_launch=kk)
                for tag, sd in (('roll', 77), ('roll_t', seed_t)):
                    require(same(out[(tag, k, kk)], un(starts[k], roll_acts[k], sd)),
                            f'{k} K={kk}: the sharded rollout ({tag}) differs')
            un = P.make_reactive_rollout(config, params, policy_step, K_MAIN)
            require(same(out['react'], un(starts['pushing'], pol, gens['react'], 500)),
                    'the sharded reactive rollout differs')

        # no host synchronisation in a sharded step; metrics_summary through NCCL
        syncs = {}
        for k in fams:
            g = torch.Generator(device=dev).manual_seed(5)
            steps[k](starts[k], acts[k], generator=g)
            torch.cuda.synchronize()
            res, syncs[k] = syncs_in(lambda k=k, g=g: steps[k](starts[k], acts[k], generator=g))
        require(not any(syncs.values()), f'sharded steps wait on the host: {syncs}')
        _, _, rew, term, _, info = out['pushing']
        summary, summary_syncs = syncs_in(lambda: sharding.metrics_summary(rew, term, info, mesh))
        local = sharding.metrics_summary(rew, term, info)
        require(summary_syncs == 0 and all(torch.equal(summary[k], local[k]) for k in local),
                f'metrics_summary over NCCL: {summary} against {local}, {summary_syncs} host syncs')

        # ms a step, sharded and unsharded alternating (five groups of 20 each)
        timing = {}
        for k, (m, c, p, _) in fams.items():
            un, g = m.make_fused_step_autoreset(c, p), torch.Generator(device=dev).manual_seed(6)
            sh_runs, un_runs = [], []
            for _ in range(5):
                sh_runs.append(time_ms(lambda k=k, g=g: steps[k](starts[k], acts[k], generator=g), 20))
                un_runs.append(time_ms(lambda un=un, k=k, g=g: un(starts[k], acts[k], generator=g), 20))
            sh_med, un_med = statistics.median(sh_runs), statistics.median(un_runs)
            timing[k] = {'sharded_ms_runs': sh_runs, 'unsharded_ms_runs': un_runs, 'sharded_ms': sh_med,
                         'unsharded_ms': un_med, 'sharded_env_steps_per_s': B_MAIN / (sh_med / 1e3),
                         'unsharded_env_steps_per_s': B_MAIN / (un_med / 1e3)}
        for k in ('pushing', 'planning_m1'):
            sh, un = rolls[(k, K_MAIN)], fams[k][0].make_fused_rollout(fams[k][1], fams[k][2], steps_per_launch=K_MAIN)
            sh_runs, un_runs = [], []
            for rep in range(3):
                sh_runs.append(time_ms(lambda: sh(starts[k], roll_acts[k], 9), 2))
                un_runs.append(time_ms(lambda: un(starts[k], roll_acts[k], 9), 2))
            timing[f'{k}_rollout_K{K_MAIN}'] = {
                'sharded_ms_per_step': statistics.median(sh_runs) / K_MAIN,
                'unsharded_ms_per_step': statistics.median(un_runs) / K_MAIN,
                'sharded_env_steps_per_s': B_MAIN * K_MAIN / (statistics.median(sh_runs) / 1e3),
                'unsharded_env_steps_per_s': B_MAIN * K_MAIN / (statistics.median(un_runs) / 1e3)}
        return {'B': B_MAIN, 'world': 1, 'backend': 'nccl', 'card': card, 'launches': launches, 'bit_equal': True,
                'host_syncs_per_step': syncs, 'metrics_summary': {k: float(v) for k, v in summary.items()},
                'timing': timing}

    sharded_launches = report['phases']['sharded_main_path'].get('launches', {})

    # -- 29. PPO over the sharded paths: the port's examples/train_sharded.py ---------------
    from gymnasium_planar_robotics_tpu_torch.examples import collect_trajectories, train_sharded

    @phase('sharded_ppo')
    def _():
        """``examples/train_sharded.py`` at 4096 envs, rollout 32, 3
        iterations after a warm-up, on the sharded fused step (kernel F) and
        with ``--reactive`` on the sharded reactive rollout (F between the
        policy's launches): ms an iteration, env-steps/s, the all-reduces an
        iteration, kernel F's launches, finite parameters."""
        res = {'card': card}
        real = torch_dist.all_reduce
        for mode, extra in (('fused', []), ('reactive', ['--reactive'])):
            calls, coll_ms = [0], []

            def counting(*a, **kw):  # and the collective's host time
                calls[0] += 1
                t0 = time.perf_counter()
                real(*a, **kw)
                coll_ms.append((time.perf_counter() - t0) * 1e3)

            kernels.reset_launches()
            torch_dist.all_reduce = counting
            try:
                out = train_sharded.main(['--batch', str(B_MAIN), '--iters', '3', '--rollout', str(K_MAIN),
                                          '--device', str(dev), *extra])
            finally:
                torch_dist.all_reduce = real
            torch.cuda.synchronize()
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            iters = out['iters'] + 1  # the warm-up iteration counts too
            require(launches.get('planning_autoreset', 0) == iters * K_MAIN,
                    f'{mode}: kernel F launched {launches}, expected {iters * K_MAIN}')
            require(all(bool(p.isfinite().all()) for p in out['policy'].parameters()), f'{mode}: policy not finite')
            require(all(math.isfinite(v) for v in out['metrics'].values()), f'{mode}: metrics {out["metrics"]}')
            res[mode] = {'B': out['batch'], 'rollout': K_MAIN, 'iters': out['iters'], 'ranks': out['ranks'],
                         'ms_per_iter': out['ms_per_iter'], 'env_steps_per_s': out['env_steps_per_s'],
                         'all_reduces_per_iter': calls[0] / iters, 'launches': launches, 'metrics': out['metrics']}
        return res

    # -- 30. the trajectory store: the port's examples/collect_trajectories.py ------------
    from gymnasium_planar_robotics_tpu_torch.utils import trajstore

    @phase('trajstore_collect')
    def _():
        """``examples/collect_trajectories.py`` on the card at its defaults
        (512 envs, 200 steps of kernel F through ``make_fused_rollout``): the
        g++ build's seconds, the frames written, and every frame read back
        bit for bit."""
        import tempfile

        t0 = time.perf_counter()
        trajstore.lib()
        build_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            kept = []
            kernels.reset_launches()
            t0 = time.perf_counter()
            frames = collect_trajectories.collect(os.path.join(tmp, 'traj'), 512, 200, dev, keep=kept)
            collect_s = time.perf_counter() - t0
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            with trajstore.TrajReader(os.path.join(tmp, 'traj')) as r:
                n = len(r)
                same = all(r.get(i) == kept[i] for i in range(n))
                leaves = trajstore.unpack_arrays(r.get(0))
        require(frames == n == 200 and same, f'{frames} written, {n} readable, read back equal {same}')
        require(launches.get('planning_autoreset') == 200, f'launches {launches}')
        return {'gxx_build_s': build_s, 'build': {k: v for k, v in trajstore.build_info.items() if k != 'path'},
                'frames': frames, 'frame_bytes': len(kept[0]), 'leaves': [list(x.shape) for x in leaves],
                'collect_s': collect_s, 'read_back_bit_equal': True, 'launches': launches}

    # -- 31. the facade, the checked step, the impedance law -------------------------------
    from gymnasium_planar_robotics_tpu_torch.core import PlanarRoboticsCore
    from gymnasium_planar_robotics_tpu_torch.models import debug
    from gymnasium_planar_robotics_tpu_torch.ops import rotations
    from gymnasium_planar_robotics_tpu_torch.utils import impedance

    @phase('core_debug_impedance')
    def _():
        """The facade's ``qpos_is_valid`` on 2^20 poses on the card against
        the CPU (circle on a holed layout with offsets, and box); the checked
        pushing fused step, clean and with a corrupted state; the impedance
        wrench on 2^20 poses against the CPU (float64, atol 1e-12 where the
        orientation error is away from half a turn, the conditioning's bound
        there)."""
        n = 1 << 20
        rng = np.random.default_rng(31)
        qpos = np.zeros((n, 7))
        qpos[:, :2] = rng.uniform(-0.05, 0.77, (n, 2))
        yaw = rng.uniform(-np.pi, np.pi, n)
        qpos[:, 3], qpos[:, 6] = np.cos(yaw / 2), np.sin(yaw / 2)
        holed = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
        facade = {}
        for name, cp in (('circle', {'shape': 'circle', 'size': 0.1, 'offset': 0.01, 'offset_wall': 0.005}),
                         ('box', {'shape': 'box', 'size': [0.09, 0.08]})):
            card_core, cpu_core = PlanarRoboticsCore(holed, collision_params=cp, device=dev), \
                PlanarRoboticsCore(holed, collision_params=cp, device='cpu')
            t0 = time.perf_counter()
            got = card_core.qpos_is_valid(qpos, add_safety_offset=True)
            card_s = time.perf_counter() - t0
            want = cpu_core.qpos_is_valid(qpos, add_safety_offset=True)
            require(np.array_equal(got, want), f'{name}: {int((got != want).sum())} poses differ')
            facade[name] = {'poses': n, 'valid_share': float(got.mean()), 'card_s': card_s, 'equal': True}

        g = torch.Generator(device=dev).manual_seed(31)
        fused = P.make_fused_step_autoreset(config, params)
        checked = debug.make_checked_step(config, params, lambda c, p, s, a: fused(s, a, generator=g))
        s0 = P.init_batch(config, params, B_MAIN, g)[0]
        a0 = torch.zeros((B_MAIN, 2), device=dev)
        (err, _), clean_syncs = syncs_in(lambda: checked(s0, a0))
        clean = err.get()
        bad = dataclasses.replace(s0, pos=torch.full_like(s0.pos, float('nan')))
        err_bad, _ = checked(bad, a0)
        corrupt = err_bad.get()
        require(clean is None and clean_syncs == 0, f'clean step: {clean}, {clean_syncs} host syncs')
        require(corrupt == 'non-finite mover position (`check` failed)', f'corrupted step: {corrupt}')

        pos = rng.normal(0, 0.1, (n, 3))
        quat = rng.normal(size=(n, 4))
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        quat_d = rng.normal(size=(n, 4))
        quat_d /= np.linalg.norm(quat_d, axis=1, keepdims=True)
        vel, pos_d = rng.normal(0, 0.2, (n, 6)), rng.normal(0, 0.1, (n, 3))
        wrench, secs = {}, {}
        for where in ('card', 'cpu'):
            d = dev if where == 'card' else torch.device('cpu')
            gains = impedance.make_gains(1.24, 2.0, 0.5, device=d)
            t = [torch.as_tensor(x, device=d) for x in (pos, quat, vel, pos_d, quat_d)]
            t0 = time.perf_counter()
            wrench[where] = impedance.impedance_wrench(gains, *t).cpu()
            secs[where] = time.perf_counter() - t0
        err = (wrench['card'] - wrench['cpu']).abs().amax(-1)
        # the orientation error's angle is 2 asin(s), s = |xyz| of the relative
        # rotation's quaternion: near s = 1 (half a turn) an ulp of s moves it
        # by 2 ulp / sqrt(1 - s^2), so there the bound is the conditioning's
        m_cpu = rotations.quat2mat(torch.as_tensor(quat))
        rel = m_cpu.transpose(-1, -2) @ rotations.quat2mat(torch.as_tensor(quat_d))
        s = torch.linalg.vector_norm(rotations.mat2quat(rel)[:, 1:], dim=-1)
        cond = 1.0 / torch.sqrt(torch.clamp(1.0 - s * s, min=1e-300))
        tight = cond < 1e3  # the angle more than ~2e-3 rad from half a turn
        w_err, w_err_tight = float(err.max()), float(err[tight].max())
        bound = 1e-12 + 0.5 * 2 * 4.4e-16 * 8 * cond  # K_r x 2 x 8 ulp of 1 x the conditioning
        require(w_err_tight <= 1e-12 and bool((err <= bound).all()),
                f'impedance wrench: card against CPU {w_err_tight} (away from half a turn), {w_err} in all, '
                f'{int((err > bound).sum())} poses beyond the conditioning bound')
        return {'card': card, 'facade_qpos_is_valid': facade,
                'checked_step': {'B': B_MAIN, 'clean': clean, 'corrupted': corrupt, 'host_syncs_clean': clean_syncs},
                'impedance': {'poses': n, 'max_abs_err': w_err, 'max_abs_err_away_from_half_turn': w_err_tight,
                              'poses_near_half_turn': int((~tight).sum()),
                              'tol': 'atol 1e-12 (float64) where 1 / sqrt(1 - s^2) < 1e3; else 1e-12 + '
                                     '3.5e-15 / sqrt(1 - s^2)',
                              'card_s': secs['card'], 'cpu_s': secs['cpu']}}

    # -- 32. planning's reset in bounded chunks: 24 movers at 4096 and 65,536 envs ------------
    @phase('planning_reset_memory')
    def _():
        """``init_batch`` at ``M_RESET`` movers (circle r=0.11, full 16x16
        table) at 4096 and 65,536 envs: the chunks of sets and envs, the
        peak memory (the peak reset before the call; above the memory
        before it, at most ``RESET_TEMPS`` f32 temporaries of the larger test
        plus two draws of uniforms), the stall share and ms;
        at 4096 envs the result bit-equal to a one-chunk reset
        (``RESET_CHUNK_ENTRIES`` raised) from the same generator state;
        counters set to 0 before the timed calls and read after."""
        cfg, prm = PL.make_planning_env(np.ones((16, 16)), M_RESET, device=dev)
        k = 8 * -(-cfg.max_reset_trials // 8)
        g = torch.Generator(device=dev).manual_seed(32)
        start = g.get_state()
        chunked = PL.init_batch(cfg, prm, B_MAIN, g)
        saved = PL.RESET_CHUNK_ENTRIES
        PL.RESET_CHUNK_ENTRIES = 1 << 62
        try:
            g.set_state(start)
            whole = PL.init_batch(cfg, prm, B_MAIN, g)
        finally:
            PL.RESET_CHUNK_ENTRIES = saved
        require(leaves_equal((as_tree(chunked[0]), chunked[1:]), (as_tree(whole[0]), whole[1:])),
                'the chunked reset differs from the one-chunk reset')
        del chunked, whole
        res = {'card': card, 'movers': M_RESET, 'table': '16x16', 'chunk_entries': saved, 'sets': k,
               'bit_equal_to_one_chunk_at': B_MAIN}
        kernels.reset_launches()
        for b in (B_MAIN, B_LARGE):
            sets, envs = PL.reset_chunks(M_RESET, prm.grid.tile_x.numel(), b, k, 8)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            state, obs, info = PL.init_batch(cfg, prm, b, g)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            require(bool(torch.isfinite(state.pos).all() & torch.isfinite(obs['observation']).all()),
                    f'B={b}: reset not finite')
            peak = torch.cuda.max_memory_allocated(dev)
            # the bound: the starts' and the goals' uniforms, and RESET_TEMPS f32 temporaries of the
            # larger test, a chunk of sets or the re-check of the batch (one set of every env)
            per = M_RESET * (M_RESET - 1) // 2 + M_RESET * prm.grid.tile_x.numel()
            uniforms = 2 * M_RESET * k * b * prm.min_xy.element_size()
            limit = 2 * uniforms + RESET_TEMPS * 4 * per * max(sets * envs, b)
            require(peak - base <= limit, f'B={b}: the reset took {peak - base} bytes, above its bound {limit}')
            res[f'B={b}'] = {'chunk_sets': sets, 'chunk_envs': envs, 'chunks': -(-k // sets) * -(-b // envs), 'ms': ms,
                             'peak_bytes': peak, 'base_bytes': base, 'bound_bytes': limit,
                             'stall_share': float(info['reset_stalled'].double().mean()),
                             'trials_mean': float(info['reset_trials'].double().mean())}
            del state, obs, info
        res['launches'] = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
        return res

    reset_launches = report['phases']['planning_reset_memory'].get('launches', {})

    # -- 33. the vector runner over a world-size-1 NCCL mesh ----------------------------------
    @phase('vector_env_mesh')
    def _():
        """``envs/runner.VectorRunner`` (the vector envs' runner) over a
        world-size-1 NCCL mesh at 4096 envs for pushing, box pushing, 1- and
        4-mover planning, ``T_MESH`` steps after a reset: the sharded fused
        step (C, C box, F, H), counters set to 0 before and read after, the
        collectives a step (``runner.all_gather_flat``: one) and their host ms, ms a
        step through the numpy boundary and the gather's host ms in it; then the
        unsharded runner from the same seed (its ms a step beside), every
        output of the reset and the steps, and the final state, bit-equal."""
        mesh = sharding.make_mesh(dev)
        real = env_runner.all_gather_flat
        res = {'card': card, 'B': B_MAIN, 'steps': T_MESH, 'world': mesh.size(), 'backend': torch_dist.get_backend()}
        launches = {}
        for name in ('pushing', 'pushing_box', 'planning_m1', 'planning_m4'):
            cfg, prm = adapter_envs[name]()
            mv = env_runner.VectorRunner(cfg, prm, B_MAIN, mesh)
            require(mv.using_fused, f'{name}: the mesh runner would step eagerly')
            rng = np.random.default_rng(33)
            limit = float(prm.j_max if cfg.learn_jerk else prm.a_max)
            acts = [rng.uniform(-limit, limit, (B_MAIN, 2 * getattr(cfg, 'num_movers', 1))).astype(np.float32)
                    for _ in range(T_MESH + 1)]
            calls, coll_ms = [0], []

            def counting(*a, **kw):  # and the collective's host time
                calls[0] += 1
                t0 = time.perf_counter()
                real(*a, **kw)
                coll_ms.append((time.perf_counter() - t0) * 1e3)

            gather, gather_ms = mv._gather, []

            def timed_gather(tree):  # the gather's host time within a step (its enqueue)
                t0 = time.perf_counter()
                out = gather(tree)
                gather_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            mv._gather = timed_gather
            mv.seed(33)
            outs = [mv.reset()]
            outs.append(mv.step(acts[0]))  # warm-up
            del gather_ms[:]
            env_runner.all_gather_flat = counting
            kernels.reset_launches()
            ms = []
            try:
                for a in acts[1:]:
                    t0 = time.perf_counter()
                    outs.append(mv.step(a))
                    ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                env_runner.all_gather_flat = real
            torch.cuda.synchronize()
            launched = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
            require(launched == {adapter_kernel[name]: T_MESH}, f'{name}: launches {launched}')
            require(calls[0] == T_MESH, f'{name}: {calls[0]} collectives in {T_MESH} steps, expected one a step')
            for k_, v in launched.items():
                launches[k_] = launches.get(k_, 0) + v
            # the unsharded twin, after the count
            uv = env_runner.VectorRunner(cfg, prm, B_MAIN)
            uv.seed(33)
            want, un_ms = [uv.reset(), uv.step(acts[0])], []
            for a in acts[1:]:
                t0 = time.perf_counter()
                want.append(uv.step(a))
                un_ms.append((time.perf_counter() - t0) * 1e3)
            got_l = [x for x in env_runner.leaves(outs, []) if isinstance(x, np.ndarray)]
            want_l = [x for x in env_runner.leaves(want, []) if isinstance(x, np.ndarray)]
            require(len(got_l) == len(want_l) and all(np.array_equal(x, y) for x, y in zip(got_l, want_l)),
                    f'{name}: the mesh runner differs from the unsharded runner')
            require(leaves_equal(as_tree(mv.device_state), as_tree(uv.device_state)), f'{name}: states differ')
            med = statistics.median(ms)
            res[name] = {'using_fused': mv.using_fused, 'ms_median': med, 'ms_min': min(ms), 'ms_max': max(ms),
                         'unsharded_ms_median': statistics.median(un_ms), 'unsharded_ms_min': min(un_ms),
                         'gather_host_ms_median': statistics.median(gather_ms),
                         'collective_host_ms_median': statistics.median(coll_ms),
                         'env_steps_per_s': B_MAIN / (med / 1e3), 'collectives_per_step': calls[0] / T_MESH,
                         'launches_per_step': {k_: v / T_MESH for k_, v in launched.items()}, 'bit_equal': True}
        res['launches'] = launches
        return res

    mesh_launches = report['phases']['vector_env_mesh'].get('launches', {})

    # -- 34. the transfer protocol's in-engine half: tools/transfer_eval.py ----------------------
    from gymnasium_planar_robotics_tpu_torch.tools import transfer_eval

    @phase('transfer_engine')
    def _():
        """``tools/transfer_eval.py`` on the card: the scripted pursuit
        policy's in-engine eval at 512 episodes (the eager
        ``step_autoreset``, kernel A), success and success_any; then
        ``train_planning`` and ``train_pushing_ppo`` for 2 iterations at 256
        envs each, ms an iteration, finite actions of the trained policies;
        counters set to 0 before and read after."""
        kernels.reset_launches()
        policy, (cfg, prm) = transfer_eval.scripted_pursuit_policy(dev)
        t0 = time.perf_counter()
        ev = transfer_eval.eval_in_engine(P, cfg, prm, policy, 512, seed=100)
        eval_s = time.perf_counter() - t0
        # it pushes: well above the ~3% of episodes whose object starts at its goal (tests/test_transfer.py:75-77;
        # both packages read 0.13-0.16 at 512 episodes on the CPU)
        require(ev['success_any'] > 0.08, f'the scripted policy never pushes: {ev}')
        res = {'card': card, 'scripted_eval': dict(ev, seconds=eval_s)}
        for name, fn, dim in (('train_planning', transfer_eval.train_planning, 6),
                              ('train_pushing_ppo', transfer_eval.train_pushing_ppo, 8)):
            timings = {}
            t0 = time.perf_counter()
            pol, (c, p) = fn(iters=2, batch=256, seed=0, log=None, device=dev, timings=timings)
            act = pol(torch.rand((64, dim), device=dev))
            require(bool(torch.isfinite(act).all()) and c.reward_mode == 'sparse', f'{name}: actions {act[:2]}')
            res[name] = {'iters': 2, 'batch': 256, 'iter_ms': timings['iter_ms'], 'seconds': time.perf_counter() - t0}
        torch.cuda.synchronize()
        res['launches'] = {k_: v for k_, v in kernels.LAUNCHES.items() if v}
        require(res['launches'].get('noise_probe', 0) > 0, f'kernel A never launched: {res["launches"]}')
        return res

    transfer_launches = report['phases']['transfer_engine'].get('launches', {})

    report['card'] = card
    # the profiler's takes that came back short of kernel records (each taken again) and the
    # timings that then fell back to CUDA events (``rollout_rates.launch_device_runs``)
    report['profiler_misses'] = PROFILER_MISSES
    kernel_rows = []
    for name, (src, replaces) in KERNELS.items():
        st = kstats[name]
        # each kernel's launches on its own path: A-D on the pushing main
        # path, E-G on the planning main path, H on the M-mover main path,
        # C-feat on the PPO training path, I on the roofline's peaks, the
        # box variants of B-D and C-feat on the box main path, H's
        # many-mover variant on the adapters' path
        path, path_launches = (
            ('planning_main_path', planning_launches) if name in PLANNING_KERNELS
            else ('multi_planning_main_path', multi_launches) if name in MULTI_KERNELS
            else ('ppo_train_main_path', train_launches) if name in TRAIN_KERNELS
            else ('box_pushing_main_path', box_launches) if name in BOX_KERNELS
            else ('adapters_main_path', adapter_launches) if name in ADAPTER_KERNELS
            else ('kernel_I_peaks', measured.get('launches', {})) if name in PEAK_KERNELS
            else ('main_path', main_launches))
        # and on every other path that launches it, each counted in its own phase: the sharded
        # path (28), the reset (32), the mesh vector runner (33), the transfer protocol (34)
        by_phase = {phase_name: int(d.get(name, 0)) for phase_name, d in (
            (path, path_launches), ('sharded_main_path', sharded_launches), ('planning_reset_memory', reset_launches),
            ('vector_env_mesh', mesh_launches), ('transfer_engine', transfer_launches)) if d.get(name, 0)}
        kernel_rows.append({
            'name': name, 'route': 'cuda', 'source': f'{PKG}/{src}', 'replaces': replaces,
            'launches': int(path_launches.get(name, 0)), 'launches_by_phase': by_phase,
            'max_abs_err': st.get('max_abs_err'),
            'ms': st.get('ms'), 'plain_ms': st.get('plain_ms'), 'bound_ms': st.get('bound_ms'),
            'bound_by': st.get('bound_by'),
            # torch.randn beside kernel A (another stream, never called by
            # the port) and the torch ops' busy time beside kernel P; no
            # PyTorch call computes any of the others
            'library_ms': st.get('library_ms'),
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
