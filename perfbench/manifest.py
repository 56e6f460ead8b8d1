"""``BENCHMARK.json``: load it, check it against the benchmark's contract,
and find the files that belong to each name in it.

Every configuration, traffic mix, cell and per-layer metric lives in files
of its own, found by name: ``configs/<config>.json`` (named by the entry's
``file``), ``traffic/<traffic>.json`` (a mix's parameters, read by the
generator of its ``kind``, ``traffic/<kind>.py``), ``workloads/<cell>.json``
(the limits of the numbers the cell's check compares),
``metrics/<metric>.py`` (a reader) and ``costs/<config>.json`` (the counted
work of one env step).  Adding one of them is adding files and entries.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}')
UNIT = re.compile(r'[A-Za-z0-9_/%.-]{1,16}')
PATH = re.compile(r'[A-Za-z0-9_./-]{1,200}')
TOP_KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads', 'end_to_end', 'per_layer'}
CONFIG_KEYS = {'name', 'source', 'file', 'reduced', 'why'}
CELL_KEYS = {'name', 'config', 'traffic', 'chips', 'why'}
E2E_KEYS = {'name', 'unit', 'better', 'bound', 'source'}
LAYER_KEYS = {'name', 'unit', 'better', 'source', 'layer', 'moves'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
#: what a reduced key may never name: a width
WIDTH = re.compile(r'(hidden|intermediate|latent|state|projection|head|expansion|experts_per_token|_dim$|_rank$)')


def load(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def _text(value, what: str, errors: list) -> None:
    if not isinstance(value, str) or not 1 <= len(value) <= 200 or '\n' in value or '\t' in value:
        errors.append(f'{what}: 1 to 200 characters on one line with no tab, got {value!r}')


def _name(value, what: str, errors: list) -> None:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        errors.append(f'{what}: not a name: {value!r}')


def check(bench: dict, root: Path = ROOT) -> list[str]:
    """Every breach of the contract that can be seen without a run, as
    messages (none: the manifest is sound), with each file a name needs."""
    here = root / HERE.name
    errors: list[str] = []
    if set(bench) != TOP_KEYS:
        errors.append(f'top-level keys {sorted(bench)}, expected {sorted(TOP_KEYS)}')
        return errors
    paths = bench['paths']
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        errors.append('paths: 1 to 16 directories')
        paths = []
    for p in paths:
        if not PATH.fullmatch(p) or p.startswith('/') or '..' in p.split('/'):
            errors.append(f'paths: {p!r} is no relative path of the allowed characters')
    cmd = bench['command']
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        errors.append('command: a list of 1 to 32 strings')
        cmd = []
    for word in cmd:
        _text(word, 'command word', errors)
        if isinstance(word, str) and (word.startswith('/') or '..' in word.split('/')):
            errors.append(f'command: {word!r} leads out of the checkout')
        if isinstance(word, str) and '/' in word and not any(word.startswith(p.rstrip('/') + '/') for p in paths):
            errors.append(f'command: {word!r} is no file under paths')
    rs = bench['run_seconds']
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append(f'run_seconds: a whole number from 1 to 51, got {rs!r}')

    def under_paths(f: str) -> bool:
        return any(f.startswith(p.rstrip('/') + '/') for p in paths)

    configs = bench['configs']
    if not 1 <= len(configs) <= 24:
        errors.append('configs: 1 to 24 entries')
    files = set()
    for c in configs:
        if set(c) != CONFIG_KEYS:
            errors.append(f'config {c.get("name")}: keys {sorted(c)}, expected {sorted(CONFIG_KEYS)}')
            continue
        _name(c['name'], 'config name', errors)
        _text(c['source'], f'config {c["name"]} source', errors)
        _text(c['why'], f'config {c["name"]} why', errors)
        if not under_paths(c['file']) or not (root / c['file']).is_file():
            errors.append(f'config {c["name"]}: file {c["file"]} is no file under paths')
        if c['file'] in files:
            errors.append(f'config {c["name"]}: file {c["file"]} is another configuration\'s')
        files.add(c['file'])
        if not isinstance(c['reduced'], list) or len(c['reduced']) > 16:
            errors.append(f'config {c["name"]}: reduced is a list of at most 16 keys')
        for k in c['reduced'] if isinstance(c['reduced'], list) else []:
            _name(k, f'config {c["name"]} reduced key', errors)
            if isinstance(k, str) and WIDTH.search(k):
                errors.append(f'config {c["name"]}: reduced names a width, {k!r}')
    config_names = [c.get('name') for c in configs]

    cells = bench['workloads']
    if not 1 <= len(cells) <= 24:
        errors.append('workloads: 1 to 24 cells')
    pairs = set()
    for w in cells:
        if set(w) != CELL_KEYS:
            errors.append(f'cell {w.get("name")}: keys {sorted(w)}, expected {sorted(CELL_KEYS)}')
            continue
        for k in ('name', 'config', 'traffic'):
            _name(w[k], f'cell {w["name"]} {k}', errors)
        _text(w['why'], f'cell {w["name"]} why', errors)
        if w['config'] not in config_names:
            errors.append(f'cell {w["name"]}: no configuration {w["config"]!r}')
        if w['chips'] not in (1, 4):
            errors.append(f'cell {w["name"]}: chips 1 or 4')
        if (w['config'], w['traffic']) in pairs:
            errors.append(f'cell {w["name"]}: configuration and traffic pair again')
        pairs.add((w['config'], w['traffic']))
        for f in (here / 'traffic' / f'{w["traffic"]}.json', here / 'workloads' / f'{w["name"]}.json'):
            if not f.is_file():
                errors.append(f'cell {w["name"]}: no file {f.relative_to(root)}')
    cell_names = [w.get('name') for w in cells]
    for c in configs:
        if c.get('name') not in {w.get('config') for w in cells}:
            errors.append(f'config {c.get("name")}: used by no cell')
        if not (here / 'costs' / f'{c.get("name")}.json').is_file():
            errors.append(f'config {c.get("name")}: no file perfbench/costs/{c.get("name")}.json')

    e2e, layer = bench['end_to_end'], bench['per_layer']
    if not 1 <= len(e2e) <= 16:
        errors.append('end_to_end: 1 to 16 metrics')
    if not 1 <= len(layer) <= 128:
        errors.append('per_layer: 1 to 128 metrics')
    for m in e2e:
        extra = set(m) - E2E_KEYS - {'workloads'}
        if extra or not E2E_KEYS <= set(m):
            errors.append(f'end-to-end metric {m.get("name")}: keys {sorted(m)}')
            continue
        if m['source'] not in ('host_clock', 'device_trace'):
            errors.append(f'end-to-end metric {m["name"]}: source host_clock or device_trace')
        if not (isinstance(m['bound'], (int, float)) and 0.01 <= m['bound'] <= 0.25):
            errors.append(f'end-to-end metric {m["name"]}: bound from 0.01 to 0.25')
    if 'setup_s' not in [m.get('name') for m in e2e]:
        errors.append('end_to_end: no setup_s')
    for m in layer:
        extra = set(m) - LAYER_KEYS - {'workloads'}
        if extra or not LAYER_KEYS <= set(m):
            errors.append(f'per-layer metric {m.get("name")}: keys {sorted(m)}')
            continue
        if m['source'] not in SOURCES:
            errors.append(f'per-layer metric {m["name"]}: source {m["source"]!r}')
        _text(m['layer'], f'per-layer metric {m["name"]} layer', errors)
        if m['moves'] not in [e.get('name') for e in e2e]:
            errors.append(f'per-layer metric {m["name"]}: moves {m["moves"]!r} is no end-to-end metric')
        if not (here / 'metrics' / f'{m["name"]}.py').is_file():
            errors.append(f'per-layer metric {m["name"]}: no reader perfbench/metrics/{m["name"]}.py')
        moved = next((e for e in e2e if e.get('name') == m['moves']), {})
        for cell in m.get('workloads', cell_names):
            if cell not in cell_names:
                errors.append(f'per-layer metric {m["name"]}: no cell {cell!r}')
            elif cell not in moved.get('workloads', cell_names):
                errors.append(f'per-layer metric {m["name"]}: cell {cell} does not report {m["moves"]}')
    names = [m.get('name') for m in e2e + layer]
    for what, seq in (('metric', names), ('cell', cell_names), ('configuration', config_names)):
        for n in {x for x in seq if seq.count(x) > 1}:
            errors.append(f'two of a {what} named {n!r}')
    for m in e2e + layer:
        _name(m.get('name'), 'metric name', errors)
        if not isinstance(m.get('unit'), str) or not UNIT.fullmatch(m['unit']):
            errors.append(f'metric {m.get("name")}: unit {m.get("unit")!r}')
        if m.get('better') not in ('lower', 'higher'):
            errors.append(f'metric {m.get("name")}: better lower or higher')
    per_cell_layer = {w: [m['name'] for m in layer if w in m.get('workloads', cell_names)] for w in cell_names}
    for w, ms in per_cell_layer.items():
        if not ms:
            errors.append(f'cell {w}: no per-layer metric')
    if len([w for w in cells if w.get('chips') == 4]) > max(1, len(cells) // 4):
        errors.append('more four-chip cells than a quarter of the cells')
    if len(json.dumps(bench)) > 64 * 1024:
        errors.append('BENCHMARK.json is over 64 KiB')
    return errors


def cell(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration's entry, the three files'
    contents (configuration, traffic mix, cell) and its metrics' entries."""
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no cell {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    names = [w['name'] for w in bench['workloads']]
    here = root / HERE.name
    return {
        'entry': entry,
        'config_entry': conf,
        'config': json.loads((root / conf['file']).read_text()),
        'mix': json.loads((here / 'traffic' / f'{entry["traffic"]}.json').read_text()),
        'cell': json.loads((here / 'workloads' / f'{name}.json').read_text()),
        'costs': json.loads((here / 'costs' / f'{entry["config"]}.json').read_text()),
        'end_to_end': [m for m in bench['end_to_end'] if name in m.get('workloads', names)],
        'per_layer': [m for m in bench['per_layer'] if name in m.get('workloads', names)],
        'run_seconds': bench['run_seconds'],
    }
