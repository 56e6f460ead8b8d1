"""Port parity: kernel C's ``emit_features`` variant (C-feat), the two
``[12, B]`` policy feature blocks of the reactive rollout.

The plain C-feat is held against the JAX package's Pallas kernel C
(interpret mode, injected uniforms, ``cand_k=2``): the 24 feature rows are
built in numpy f32 from the JAX kernel's 36 outputs in the order of
``pallas_step.py:1073-1078``, and that order is pinned on the JAX kernel's
own ``emit_features=True`` build (``raw_planes``, interpret mode, whose
hardware PRNG gives all-zero bits, at ``std_noise=0``).  The port's blocks
equal the numpy f32 assembly from its own 36 planes bit for bit, and its 36
planes do not change with the flag.  The CUDA kernel is held against the
plain version on the card in ``test_torch_reactive_gpu.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.models import pushing as jpush
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.models import pushing as tpush
from gymnasium_planar_robotics_tpu_torch.ops.kernels import pushing as kpush

from test_torch_pushing_autoreset import ACC_PLANES, CAND_K, KW, TOL, TOL_ACC, episode_state, jax_raw_planes

LANES = 128


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_features(state: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The 24 feature rows ``[2, 12, B]`` from kernel C's input state ``[19,
    B]`` and its 36 outputs, in numpy f32 (``pallas_step.py:1073-1078``)."""

    def block(mpx, mpy, mvx, mvy, agx, agy, gx, gy):
        return np.stack([mpx, mpy, mvx, mvy, agx, agy, gx, gy, agx - mpx, agy - mpy, gx - agx, gy - agy])

    post = block(*out[19:25], out[16], out[17])  # post-reset obs, post-reset goal
    pre = block(*out[25:31], state[16], state[17])  # pre-reset obs, the goal loaded at entry
    return np.stack([post, pre]).astype(np.float32)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_plain_features_match_pallas_kernel_c(learn_jerk):
    kw = dict(KW, learn_jerk=learn_jerk)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b = 128
    state = episode_state(tcfg, tprm, b, seed=3)
    limit = 80.0 if learn_jerk else 8.0
    rng = np.random.default_rng(6)
    act = rng.uniform(-limit, limit, (b, 2)).astype(np.float32)
    n = kpush.autoreset_noise_planes(tcfg.num_cycles, CAND_K)
    u = rng.random((n, b), dtype=np.float32)

    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                            inject_noise=True)
    d = tpush.state_to_numpy(state)
    want_out = jax_raw_planes(fused(
        *(jnp.asarray(d[k]) for k in ('pos', 'vel', 'acc', 'act', 'obj_pos', 'obj_vel', 'obj_yaw', 'obj_w',
                                      'mover_z', 'mover_vz', 'goal', 'steps')),
        jnp.asarray(act), 0, noise=jnp.asarray(u),
    ))
    st = tpush.state_to_planes(state)
    want = numpy_features(st.numpy(), want_out)

    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    action, uniforms = torch.from_numpy(act.T.copy()), torch.from_numpy(u)
    out, feat = kpush.pushing_autoreset(st, action, kc, uniforms=uniforms, emit_features=True)
    assert feat.shape == (2, kpush.N_FEATURES, b) and feat.dtype == torch.float32
    # the 36 planes do not change with the flag, and the blocks are built
    # from exactly those planes
    torch.testing.assert_close(out, kpush.pushing_autoreset(st, action, kc, uniforms=uniforms), rtol=0, atol=0)
    np.testing.assert_array_equal(feat.numpy(), numpy_features(st.numpy(), out.numpy()))
    # against the JAX kernel's rows at kernel C's plane tolerance (the FMA
    # contraction of the two programs differs at the ulp level)
    for blk in range(2):
        for i in range(kpush.N_FEATURES):
            np.testing.assert_allclose(feat[blk, i].numpy(), want[blk, i], **TOL, err_msg=f'block {blk} row {i}')
    for i in range(kpush.N_AUTORESET_OUT):
        np.testing.assert_allclose(out[i].numpy(), want_out[i], **(TOL_ACC if i in ACC_PLANES else TOL),
                                   err_msg=f'plane {i}')
    # restarts fired: the post-reset block carries new goals, the pre-reset
    # block the old ones
    restarted = (out[18] == 0) & (st[18] > 0)
    assert int(restarted.sum()) >= b // 8
    assert (feat[0, 6:8, restarted] != st[16:18, restarted]).all()
    torch.testing.assert_close(feat[1, 6:8], st[16:18], rtol=0, atol=0)


def test_jax_emit_features_row_order():
    """The JAX kernel's own ``emit_features`` blocks (outputs 36/37 of
    ``raw_planes``) are the numpy assembly of its 36 planes, and the port's
    plain C-feat on the same all-zero uniforms matches them."""
    kw = dict(std_noise=0.0, num_cycles=6)
    jcfg, jprm = jpush.make_pushing_env(dtype=jnp.float32, **kw)
    tcfg, tprm = tpush.make_pushing_env(**kw, device='cpu')
    b = LANES
    state = episode_state(tcfg, tprm, b, seed=7)
    rng = np.random.default_rng(8)
    act = rng.uniform(-8.0, 8.0, (2, b)).astype(np.float32)
    st = tpush.state_to_planes(state)

    fused = pallas_step.make_fused_pushing_autoreset_cycles(jcfg, jprm, interpret=True, cand_k=CAND_K,
                                                            emit_features=True)
    outs = fused.raw_planes([jnp.asarray(p.numpy().reshape(1, LANES)) for p in st],
                            (jnp.asarray(act[0].reshape(1, LANES)), jnp.asarray(act[1].reshape(1, LANES))), 0)
    assert len(outs) == kpush.N_AUTORESET_OUT + 2
    jout = np.stack([np.asarray(o).reshape(b) for o in outs[:kpush.N_AUTORESET_OUT]])
    jfeat = np.stack([np.asarray(outs[36]).reshape(kpush.N_FEATURES, b), np.asarray(outs[37]).reshape(kpush.N_FEATURES, b)])
    np.testing.assert_array_equal(jfeat, numpy_features(st.numpy(), jout))

    kc = kpush.make_kernel_consts(tcfg, tprm, CAND_K)
    zeros = torch.zeros((kpush.autoreset_noise_planes(tcfg.num_cycles, CAND_K), b))
    out, feat = kpush.pushing_autoreset(st, torch.from_numpy(act), kc, uniforms=zeros, emit_features=True)
    np.testing.assert_allclose(feat.numpy(), jfeat, **TOL)
    for i in range(kpush.N_AUTORESET_OUT):
        np.testing.assert_allclose(out[i].numpy(), jout[i], **(TOL_ACC if i in ACC_PLANES else TOL),
                                   err_msg=f'plane {i}')
    # every-8th env truncates: its restart stalls on all-zero draws in both
    # (mover and object candidates at their boxes' corners, too close)
    assert (out[34].numpy() == jout[34]).all() and jout[34].sum() >= b // 8
