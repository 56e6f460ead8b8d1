"""A run loads neither JAX nor the JAX package (top-level module names
compared whole: the program's name begins with the JAX package's), and the
reference imports nothing of the program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'gymnasium_planar_robotics_tpu'}
PROGRAM = 'gymnasium_planar_robotics_tpu_torch'


def loaded_after(code: str) -> set:
    prog = (f'import sys, json; sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]\n{code}\n'
            'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    out = subprocess.run([sys.executable, '-c', prog], capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env={'PATH': '/usr/bin:/bin', 'HOME': str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded_after('import torch; torch.set_num_threads(2); import harness\n'
                         "harness.run('push-open-k32-4k', 9, 0.01, False, 'cpu', "
                         "overrides={'envs': 8, 'steps_per_call': 4})\n"
                         'assert harness.forbidden_modules() == [], harness.forbidden_modules()')
    assert PROGRAM in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = sorted(p.stem for p in (HERE / 'reference').glob('*.py') if p.stem != '__init__')
    names = loaded_after('\n'.join(f'import reference.{m}' for m in mods))
    assert not {n for n in names if n.startswith('gymnasium_planar_robotics_tpu')}
    assert not names & FORBIDDEN
    allowed = {'__future__', 'math', 'numpy', 'torch', 'reference'}
    for path in (HERE / 'reference').glob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split('.')[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or '').split('.')[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)


def test_no_benchmark_source_names_jax():
    for path in HERE.rglob('*.py'):
        if path.parent.name == 'tests':
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or '']
                assert not {n.split('.')[0] for n in names} & FORBIDDEN, path
