"""BENCHMARK.json against the benchmark's contract, and a cell, a
configuration and a per-layer metric added as files with no file edited."""

import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import manifest  # noqa: E402


def test_manifest_meets_the_contract():
    bench = manifest.load()
    assert manifest.check(bench) == []
    for m in bench['end_to_end'] + bench['per_layer']:
        assert manifest.NAME.fullmatch(m['name']) and manifest.UNIT.fullmatch(m['unit'])
    for w in bench['workloads']:
        assert all(manifest.NAME.fullmatch(w[k]) for k in ('name', 'config', 'traffic'))
        assert w['chips'] == 1


def test_every_per_layer_metric_is_reported_where_it_moves():
    bench = manifest.load()
    cells = [w['name'] for w in bench['workloads']]
    e2e = {m['name']: m for m in bench['end_to_end']}
    for m in bench['per_layer']:
        for cell in m.get('workloads', cells):
            assert cell in e2e[m['moves']].get('workloads', cells)
    for cell in cells:
        spec = manifest.cell(bench, cell)
        assert {m['name'] for m in spec['end_to_end']} >= {'setup_s', 'env_steps_per_s'}
        assert spec['per_layer']


def test_the_contract_refuses_a_broken_manifest():
    bench = manifest.load()
    bad = json.loads(json.dumps(bench))
    bad['end_to_end'][0]['bound'] = 0.5
    bad['per_layer'][0]['moves'] = 'no_such_metric'
    bad['workloads'][0]['name'] = 'a name with spaces'
    bad['configs'][0]['reduced'] = ['hidden_size']
    errors = manifest.check(bad)
    assert any('bound' in e for e in errors) and any('moves' in e for e in errors)
    assert any('not a name' in e for e in errors) and any('width' in e for e in errors)


def test_a_new_cell_configuration_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(HERE, root / 'perfbench', ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(HERE.parent / 'BENCHMARK.json', root / 'BENCHMARK.json')
    pb = root / 'perfbench'
    cfg = json.loads((pb / 'configs' / 'planning-4mover.json').read_text())
    cfg['name'], cfg['env']['num_movers'] = 'planning-6mover', 6
    (pb / 'configs' / 'planning-6mover.json').write_text(json.dumps(cfg))
    (pb / 'costs' / 'planning-6mover.json').write_text((pb / 'costs' / 'planning-4mover.json').read_text())
    (pb / 'traffic' / 'open-k1-16k.json').write_text(json.dumps(
        {'kind': 'open_loop', 'envs': 16384, 'steps_per_call': 64, 'steps_per_launch': 1}))
    (pb / 'workloads' / 'plan6-open-k1-16k.json').write_text((pb / 'workloads' / 'plan4-open-k1-64k.json').read_text())
    (pb / 'metrics' / 'calls_traced.py').write_text(
        'def read(ctx):\n    return None if ctx["traced_counts"] is None else len(ctx["traced_counts"])\n')
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    before = {p: p.read_bytes() for p in pb.rglob('*') if p.is_file()}
    bench['configs'].append({'name': 'planning-6mover', 'source': 'https://github.com/ubi-coro/gymnasium-planar-robotics',
                             'file': 'perfbench/configs/planning-6mover.json', 'reduced': [], 'why': 'six movers'})
    bench['workloads'].append({'name': 'plan6-open-k1-16k', 'config': 'planning-6mover', 'traffic': 'open-k1-16k',
                               'chips': 1, 'why': 'six movers, 16,384 envs'})
    bench['per_layer'].append({'name': 'calls_traced', 'unit': 'calls', 'better': 'higher', 'source': 'host_clock',
                               'layer': 'rollout loop', 'moves': 'env_steps_per_s',
                               'workloads': ['plan6-open-k1-16k']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert manifest.check(bench, root) == []
    spec = manifest.cell(bench, 'plan6-open-k1-16k', root)
    assert spec['config']['env']['num_movers'] == 6 and spec['mix']['envs'] == 16384
    assert [m['name'] for m in spec['per_layer']][-1] == 'calls_traced'
    assert 'calls_traced' not in [m['name'] for m in manifest.cell(bench, 'plan4-open-k1-64k', root)['per_layer']]
    sys.path.insert(0, str(pb))
    try:
        import importlib.util
        s = importlib.util.spec_from_file_location('calls_traced', pb / 'metrics' / 'calls_traced.py')
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert mod.read({'traced_counts': [1, 2, 3]}) == 3
    finally:
        sys.path.remove(str(pb))
    # nothing that was there was edited
    assert all(p.read_bytes() == b for p, b in before.items())
