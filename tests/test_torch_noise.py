"""Port parity: the noise machinery and kernel A (noise probe).

The plain Box-Muller is held against the JAX package's Pallas noise probe
(interpret mode, injected uniforms); the mantissa-trick uniform against a
NumPy oracle bit for bit; the host Philox4x32-10 against the published
known-answer vectors.  The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu_torch.ops import kernels
from gymnasium_planar_robotics_tpu_torch.ops.kernels import noise


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_box_muller_matches_pallas_probe():
    """Same uniforms into the Pallas probe (interpret, injected) and the
    port's plain probe: equal up to the libm differences of log/cos/sin
    (tolerance rtol 2e-6, atol 2e-6, a few f32 ulp of values up to ~5.6)."""
    draws, b = 4, 256
    u = np.random.default_rng(0).random((2 * draws, b), dtype=np.float32)
    u[0, :3] = [0.0, np.float32(1.0) - np.float32(2**-23), 0.5]  # log(1), log(2^-23) edges
    probe = pallas_step.make_noise_probe(draws=draws, interpret=True, inject_noise=True)
    want = np.asarray(probe(0, noise=jnp.asarray(u)))
    got = noise.noise_probe(draws, b, 'cpu', uniforms=torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32 and got.shape == (2 * draws, b)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_mantissa_uniform_bit_exact_and_below_one():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, size=65536, dtype=np.uint64).astype(np.uint32)
    bits[:4] = [0, 0xFFFFFFFF, 0x1FF, 0x200]
    oracle = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    got = noise.uniform_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), oracle.view(np.uint32))
    assert got.max() < 1.0 and got.min() >= 0.0
    assert got[1] == np.float32(1.0) - np.float32(2**-23) and got[0] == 0.0 and got[2] == 0.0


@pytest.mark.parametrize('ctr, key, want', [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's Philox4x32-10 known-answer vectors."""
    out = noise.philox4x32_10(np.array(ctr, np.uint32).reshape(4, 1), key)
    assert tuple(int(x) for x in out[:, 0]) == want


def test_philox_stream_layout():
    """Draw d of env e is word d % 4 of the block at counter (d // 4, e)."""
    seed = (7 << 32) | 12345
    bits = noise.philox_bits(seed, 10, 3)
    assert bits.shape == (10, 3)
    for d in (0, 3, 4, 9):
        for e in range(3):
            blk = noise.philox4x32_10(np.array([[d // 4], [e], [0], [0]], np.uint32), (12345, 7))
            assert bits[d, e] == blk[d % 4, 0]


def test_generator_normals_have_standard_moments():
    g = torch.Generator().manual_seed(0)
    z = noise.noise_probe(8, 4096, 'cpu', generator=g).double().reshape(-1)  # 65k samples
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    assert abs(float((z.abs() > 2).double().mean()) - 0.0455) < 0.006
    # the host copy of the kernels' Philox stream gives the same moments
    zp = noise.noise_probe_plain(noise.philox_uniforms(3, 16, 4096)).double().reshape(-1)
    assert abs(float(zp.mean())) < 0.02 and abs(float(zp.std()) - 1.0) < 0.02


def test_uniform_stream_asserts_its_draw_count():
    s = noise.UniformStream(torch.zeros((3, 4)))
    s.normal_pair()
    with pytest.raises(AssertionError, match='drew 2 noise planes but 3'):
        s.finalize()
    s.uniform()
    s.finalize()
    with pytest.raises(AssertionError, match='drew more'):
        s.uniform()


def test_dispatch_rejects_mixed_devices():
    with pytest.raises(ValueError, match='must all be on the CPU'):
        kernels.on_cuda(torch.zeros(1), torch.zeros(1, device='meta'))


def test_draw_seed_keeps_a_cpu_seed_an_int():
    """A CPU generator (or none) gives the launch seed as a Python int, the
    value the kernels have always been keyed with."""
    got = kernels.draw_seed(torch.Generator().manual_seed(5))
    assert isinstance(got, int)
    assert got == int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(5)))
    torch.manual_seed(6)
    got = kernels.draw_seed()
    torch.manual_seed(6)
    assert isinstance(got, int) and got == int(torch.randint(0, 2**31 - 1, ()))


def test_seed_args_by_value_or_by_address():
    """An int seed goes by value (masked to 64 bits), a one-element int64
    tensor by its address on the launch's device; anything else raises."""
    assert kernels.seed_args(7, 'cpu') == (7, None)
    assert kernels.seed_args(-1, 'cpu') == (2**64 - 1, None)
    t = torch.tensor([7], dtype=torch.int64)
    assert kernels.seed_args(t, 'cpu') == (0, t.data_ptr())
    for bad in (torch.tensor([7], dtype=torch.int32), torch.tensor([7, 8]), torch.tensor([7], device='meta')):
        with pytest.raises(ValueError, match='seed tensor'):
            kernels.seed_args(bad, 'cpu')


def test_dispatch_hands_the_kernel_the_drawn_seed(monkeypatch):
    """The card path gets ``draw_seed(generator)`` untouched (an int here, a
    card tensor for a card generator: no ``int()`` of it), or 0 beside
    injected uniforms."""
    monkeypatch.setattr(kernels, 'on_cuda', lambda *t: True)
    x = torch.zeros((2, 4))
    seen = []
    kernels.dispatch((x,), 2, None, None, torch.Generator().manual_seed(5), None, lambda u, s: seen.append((u, s)))
    kernels.dispatch((x,), 2, None, 11, None, None, lambda u, s: seen.append((u, s)))
    u = torch.zeros((2, 4))
    kernels.dispatch((x,), 2, u, None, None, None, lambda u, s: seen.append((u, s)))
    assert seen[0] == (None, kernels.draw_seed(torch.Generator().manual_seed(5)))
    assert seen[1] == (None, 11) and seen[2][0] is u and seen[2][1] == 0


@pytest.mark.parametrize('inject', [False, True], ids=['philox', 'injected'])
@pytest.mark.parametrize('b', [1, 33, 4097])
@pytest.mark.parametrize('draws', [1, 3, 4, 258, 774])
def test_kernel_a_grid_writes_every_draw_once(draws, b, inject):
    """The mirror of kernel A's map from thread to work (``probe_writes``)
    on the wrapper's grid (``probe_grid``): at odd and even pair counts and
    ragged widths, every normal ``(row, env)`` is written exactly once, from
    word ``row % 4`` of the Philox block ``row // 4`` of its env (the layout
    ``philox_bits`` gives the stream), both rows of a pair by one thread,
    and neighbouring lanes take neighbouring envs."""
    thread, row, env, block, word = noise.probe_writes(draws, b, inject)
    gx, gy, threads = noise.probe_grid(draws, b, inject)
    assert gx * threads >= b > (gx - 1) * threads and 1 <= gy <= 65535
    assert row.min() >= 0 and row.max() < 2 * draws and env.min() >= 0 and env.max() < b
    np.testing.assert_array_equal(np.bincount(row * b + env, minlength=2 * draws * b), 1)
    np.testing.assert_array_equal(block * 4 + word, row)
    by_cell = np.empty(2 * draws * b, np.int64)
    by_cell[row * b + env] = thread
    pairs = by_cell.reshape(draws, 2, b)
    np.testing.assert_array_equal(pairs[:, 0], pairs[:, 1])  # a pair's two normals: one thread
    assert ((thread // threads) % gx * threads + thread % threads == env).all()  # env = blockIdx.x * T + tid


@pytest.mark.parametrize('draws, b, rows', [(3, 4096, 2), (3, 65536, 2), (8, 1, 4), (258, 4096, 66),
                                             (774, 4096, 66), (774, 65536, 5)])
def test_kernel_a_grid_caps_its_rows_at_a_wave(draws, b, rows):
    """The Philox mode's rows of blocks: one a Philox block while the launch
    fits a wave of the card's resident threads, then capped there, so a
    thread walks its env's blocks (the round keys formed once)."""
    gx, gy, threads = noise.probe_grid(draws, b, False)
    assert (gx, gy) == (-(-b // threads), rows)
    assert gy == -(-draws // 2) or gx * gy * threads >= noise.A_WAVES * noise.H100_RESIDENT


def test_noise_probe_on_the_cpu_is_the_plain_version_over_the_generators_uniforms():
    """On the CPU ``noise_probe(..., generator=g)`` is unchanged: the plain
    version over ``torch.rand`` of ``g``, bit for bit."""
    got = noise.noise_probe(5, 33, 'cpu', generator=torch.Generator().manual_seed(9))
    u = torch.rand((10, 33), generator=torch.Generator().manual_seed(9))
    assert torch.equal(got, noise.noise_probe_plain(u))


def test_noise_probe_on_the_card_keys_the_philox_mode_by_the_generators_seed(monkeypatch):
    """On a CUDA device ``noise_probe(..., generator=g)`` hands kernel A
    ``draw_seed(g)`` and no uniforms (no ``torch.rand``, no host copy);
    given uniforms or a seed, it passes them on as before."""
    seen = []
    monkeypatch.setattr(noise, 'noise_probe_cuda', lambda *a: seen.append(a))
    monkeypatch.setattr(kernels, 'draw_uniforms', lambda *a, **k: pytest.fail('drew uniforms for the card'))
    noise.noise_probe(258, 16, 'cuda', generator=torch.Generator().manual_seed(5))
    noise.noise_probe(3, 16, 'cuda', seed=11)
    u = torch.zeros((6, 16))
    noise.noise_probe(3, 16, 'cuda', uniforms=u)
    dev = torch.device('cuda')
    assert seen[0] == (258, 16, dev, None, kernels.draw_seed(torch.Generator().manual_seed(5)))
    assert seen[1] == (3, 16, dev, None, 11)
    assert seen[2][3] is u and seen[2][4] == 0
