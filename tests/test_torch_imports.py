"""The port and ``chip_smoke.py`` import neither JAX nor the JAX package.

Reads the source of every ``.py`` file of ``gymnasium_planar_robotics_tpu_torch``,
of ``chip_smoke.py`` and of the test modules that run on gloo ranks, and checks every import statement (comments and
docstrings may name the JAX package), then imports every module of the port
in a fresh interpreter and checks that neither ``jax`` nor the JAX package
(nor ``triton``) was loaded.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'gymnasium_planar_robotics_tpu_torch'
# the port, the smoke script, and the test modules that run on gloo ranks
# (and on the card's machine) without JAX
FILES = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py'] + [
    ROOT / 'tests' / f'{m}.py' for m in ('torch_sharding_worker', 'torch_sharding_cases', 'torch_vector_mesh_cases')]
FORBIDDEN = ('jax', 'jaxlib', 'gymnasium_planar_robotics_tpu')


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, 'id', getattr(node.func, 'attr', None)) in (
                'import_module', '__import__') and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


@pytest.mark.parametrize('path', FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    names = list(_imported(ast.parse(path.read_text(), filename=str(path))))
    assert not [n for n in names if _forbidden(n)], names


def test_every_module_imports_without_jax():
    modules = sorted('.'.join(p.relative_to(ROOT).with_suffix('').parts).removesuffix('.__init__')
                     for p in PKG.rglob('*.py'))
    code = (
        'import importlib, sys\n'
        f'for m in {modules!r}:\n'
        '    importlib.import_module(m)\n'
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton',"
        " 'gymnasium_planar_robotics_tpu')]\n"
        'assert not bad, bad\n'
    )
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)


def test_runner_and_package_import_without_gym_pettingzoo_mujoco():
    """The package, its lazy surface's registry, ``envs/runner`` and
    ``tools/transfer_eval`` import with ``gymnasium``, ``pettingzoo`` and
    ``mujoco`` hidden (the card's machine has none of them), and the
    runners step on the CPU there, the vector runner also over a
    world-size-1 gloo mesh."""
    code = (
        'import sys\n'
        "for name in ('gymnasium', 'pettingzoo', 'mujoco', 'matplotlib'):\n"
        '    sys.modules[name] = None\n'
        'import numpy as np\n'
        'import gymnasium_planar_robotics_tpu_torch as pkg\n'
        'from gymnasium_planar_robotics_tpu_torch import envs\n'
        'from gymnasium_planar_robotics_tpu_torch.envs import registration, runner\n'
        'from gymnasium_planar_robotics_tpu_torch.models import planning, pushing\n'
        "cfg, prm = pushing.make_pushing_env(device='cpu', num_cycles=2)\n"
        'r = runner.EnvRunner(cfg, prm)\n'
        'r.seed(0)\n'
        'obs, info = r.reset()\n'
        'out = r.step(np.zeros(2))\n'
        "assert out[0]['observation'].shape == (4,) and r.steps == 1\n"
        "cfg, prm = planning.make_planning_env(np.ones((4, 4)), 2, device='cpu', num_cycles=2)\n"
        'v = runner.VectorRunner(cfg, prm, 3)\n'
        'v.reset()\n'
        'out = v.step(np.zeros((3, 4)))\n'
        "assert not v.using_fused and out[1].shape == (3,) and 'final_observation' in out[4]\n"
        'from gymnasium_planar_robotics_tpu_torch.parallel import sharding\n'
        "vm = runner.VectorRunner(cfg, prm, 4, sharding.make_mesh('cpu'))\n"
        'vm.reset()\n'
        'out = vm.step(np.zeros((4, 4)))\n'
        "assert vm.local_envs == 4 and out[1].shape == (4,) and vm.env0().pos.shape == (1, 2, 2)\n"
        'from gymnasium_planar_robotics_tpu_torch.tools import transfer_eval\n'
        "policy, _ = transfer_eval.scripted_pursuit_policy('cpu')\n"
        'try:\n'
        '    envs.register_gymnasium_envs()\n'
        'except ImportError:\n'
        '    pass\n'
        'else:\n'
        "    raise AssertionError('registration needs gymnasium')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gymnasium_planar_robotics_tpu') and sys.modules[m]]\n"
        'assert not bad, bad\n'
    )
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True, timeout=120)
