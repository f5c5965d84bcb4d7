"""The port's runners of the co-located demos of ``demos/run-all.sh``.

Each runner checks its own results against Python and exits 1 otherwise;
here each runs on the CPU at a small size (its JAX demo's defaults on
the card: ``chip_smoke.py``'s phase "co-located demos"): secretsanta at
n = 4, SecretSantaExplained at n = 3, indextounitvector at n = 3 (GF(5),
SecInt(32), SecFxp(32, 16)), unanimous with votes yes-yes, yes-no and
no-yes, PrefixOrExplained at n = 4, sort at n = 3 with its secure list.
PrefixOrExplained at its default n = 8 prints the JAX demo's table of
depth and work line for line (``demos/PrefixOrExplained.py -M3 --sim``,
a subprocess, no trace cache).

Tolerance: exact.
"""
import contextlib
import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from mpyc_tpu_torch.demos import (PrefixOrExplained, SecretSantaExplained,
                                  indextounitvector, secretsanta, sort,
                                  unanimous)
from mpyc_tpu_torch.parallel.simulator import SimRuntime

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_prefix_or():
    """The JAX demo's lines, run in the background (no trace cache)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', MPYC_TPU_CACHE='0')
    res = {}

    def run():
        proc = subprocess.run(
            [sys.executable, str(ROOT / 'demos' / 'PrefixOrExplained.py'),
             '-M3', '--sim'], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        res['out'] = (proc.returncode, proc.stdout.splitlines(),
                      proc.stderr[-2000:])
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield lambda: (th.join(600), res['out'])[1]


def _main(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv + ['--device', 'cpu'])
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize('case', ['secretsanta', 'indextounitvector',
                                  'sort', 'unanimous yes-yes',
                                  'unanimous yes-no', 'unanimous no-yes'])
def test_runner_checks_itself(case):
    argv = {'secretsanta': ['-n', '4', '--trials', '2'],
            'indextounitvector': ['3'], 'sort': ['3'],
            'unanimous yes-yes': ['1', '1'], 'unanimous yes-no': ['1', '0'],
            'unanimous no-yes': ['0', '1']}[case]
    module = {'secretsanta': secretsanta,
              'indextounitvector': indextounitvector,
              'sort': sort}.get(case, unanimous)
    rc, lines = _main(module, argv)
    assert rc == 0, lines
    if case == 'secretsanta':
        assert sum('derangement' in ln and 'OK' in ln for ln in lines) == 2
    if case.startswith('unanimous'):
        assert ('MATCH' in lines[0]) == (case == 'unanimous yes-yes')
    if case == 'indextounitvector':
        assert lines[0] == 'Using unit_vector with type SecFld3(GF(5)):'
        assert sum(ln.startswith('Using') for ln in lines) == 5
    if case == 'sort':
        assert any('Sorted by descending value' in ln for ln in lines)


def test_secret_santa_explained_checks_itself():
    rt = SimRuntime(3, device='cpu')
    lines = []
    res = SecretSantaExplained.run(rt, 3, units=4, perms=1, ders=1,
                                   out=lines.append)
    assert res['ok'] and res['trials'] >= 1, lines
    assert lines[0] == 'stage 1: random unit vectors of length 3'


def test_prefix_or_table_is_the_jax_demos(jax_prefix_or):
    rc, lines = _main(PrefixOrExplained, [])
    assert rc == 0
    jrc, jlines, err = jax_prefix_or()
    assert jrc == 0, err
    assert lines[:6] == jlines[:6]
    rt = SimRuntime(3, device='cpu')
    res = PrefixOrExplained.run(rt, 4, out=lambda s: None)
    assert res['ok']
    assert [r[1:3] for r in res['rows']] == [(3, 3), (2, 4), (2, 4),
                                             (2, 4), (2, 4)]
