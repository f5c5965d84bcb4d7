"""Secure sorting and extrema on the port, against the JAX package.

A JAX ``SimRuntime(3)`` and the port's take the same inputs and open the
same values (the JAX package's CPU plane compares eagerly, with PRSS
draws of its own, so sorting is held by the opened values):

* ``np_sort`` of 19 values (an odd n: a ragged Batcher network), of a
  (3, 5) array along each axis and flattened, and of 11 values with the
  key a**2 (ties of v and -v broken by the network alike in both);
* ``sorted`` with a key and reversed, ``if_swap`` of numbers and lists,
  ``np_if_swap`` with a secure and a public condition, ``min_max``,
  ``np_amin`` and ``np_amax`` over all axes, one axis and with keepdims;
* ``random.shuffle`` of numbers and of rows opens to a permutation of
  its input (rows moved whole).

The port's runner ``mpyc_tpu_torch.demos.sort`` prints the JAX demo's
sorted lines (``demos/sort.py -M3 --sim``, a subprocess; the shuffled
input is random in both) and checks itself.

Tolerance: exact equality (integers).
"""
import contextlib
import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import random as trandom
from mpyc_tpu_torch.demos import sort as demo
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

ROOT = Path(__file__).resolve().parents[1]
VALUES = np.array([13, -7, 0, 25, -7, 3, 99, -100, 42, 7, 0, 1, -1, 64,
                   -64, 5, 8, -3, 21])
GRID = VALUES[:15].reshape(3, 5)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_demo():
    """The JAX demo's lines, run in the background (no trace cache)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', MPYC_TPU_CACHE='0')
    res = {}

    def run():
        proc = subprocess.run(
            [sys.executable, str(ROOT / 'demos' / 'sort.py'), '-M3',
             '--sim'], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        res['out'] = (proc.returncode, proc.stdout.splitlines(),
                      proc.stderr[-2000:])
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield lambda: (th.join(600), res['out'])[1]


@pytest.fixture(scope='module')
def rts():
    """A JAX SimRuntime(3), wired into the JAX package's type layer (its
    own runtime wired back after), and the port's."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        jr.start()
        try:
            yield jr, TorchSim(3, device='cpu')
        finally:
            jr.shutdown()
            if old is not None:
                old._wire_modules()


def _input(rt, values):
    values = np.asarray(values)
    sec = rt.SecInt(32)
    if values.ndim:
        return rt.input(sec.array(values), senders=0)
    return rt.input(sec(int(values)), senders=0)


def _open(rt, x):
    if isinstance(x, list):
        return [_open(rt, v) for v in x]
    return np.asarray(rt.output(x)).astype(np.int64).tolist()


def _both(rts, fn, values):
    """fn(rt, input) on both runtimes, opened."""
    return [_open(rt, fn(rt, _input(rt, values))) for rt in rts]


@pytest.mark.parametrize('case', ['odd', 'axis 0', 'axis 1', 'flat', 'key'])
def test_np_sort_matches_jax(rts, case):
    values = {'odd': VALUES, 'key': VALUES[:11]}.get(case, GRID)
    axis = {'axis 0': 0, 'axis 1': 1, 'flat': None}.get(case, -1)
    key = (lambda a: a * a) if case == 'key' else None
    got, want = _both(rts, lambda rt, a: rt.np_sort(a, axis=axis, key=key),
                      values)
    assert got == want
    if key is None:
        assert got == np.sort(values, axis=axis).tolist()
    else:
        assert [v * v for v in got] == sorted(v * v for v in values)
        assert sorted(got) == sorted(values.tolist())


def test_sorted_if_swap_and_min_max_match_jax(rts):
    values = VALUES[:8].tolist()
    res = []
    for rt in rts:
        xs = [_input(rt, v) for v in values]
        out = [_open(rt, rt.sorted(xs, key=lambda a: a * a)),
               _open(rt, rt.sorted(xs, reverse=True)),
               _open(rt, list(rt.min_max(xs)))]
        c0, c1 = _input(rt, 0), _input(rt, 1)
        out += [_open(rt, rt.if_swap(c, xs[0], xs[1])) for c in (c0, c1)]
        out += [_open(rt, rt.if_swap(c1, xs[:3], xs[3:6]))]
        a, b = _input(rt, values[:4]), _input(rt, values[4:8])
        cs = _input(rt, [1, 0, 1, 0])
        out += [_open(rt, rt.np_if_swap(cs, a, b)),
                _open(rt, rt.np_if_swap(np.array([0, 1, 1, 0]), a, b))]
        res.append(out)
    assert res[0] == res[1]
    srt, rev, mm, keep, swap, rows, np_sec, np_pub = res[1]
    assert [v * v for v in srt] == sorted(v * v for v in values)
    assert rev == sorted(values, reverse=True)
    assert mm == [min(values), max(values)]
    assert keep == values[:2] and swap == values[1::-1]
    assert rows == [values[3:6], values[:3]]
    assert np_sec == [[values[4], values[1], values[6], values[3]],
                      [values[0], values[5], values[2], values[7]]]
    assert np_pub == [[values[0], values[5], values[6], values[3]],
                      [values[4], values[1], values[2], values[7]]]


@pytest.mark.parametrize('axis,keepdims', [(None, False), (0, False),
                                           (1, True)])
def test_np_amin_np_amax_match_jax(rts, axis, keepdims):
    values = GRID
    for op, ref in (('np_amin', np.amin), ('np_amax', np.amax)):
        got, want = _both(rts, lambda rt, a: getattr(rt, op)(
            a, axis=axis, keepdims=keepdims), values)
        assert got == want == ref(values, axis=axis,
                                  keepdims=keepdims).tolist()


def test_shuffle_opens_to_a_permutation():
    tr = TorchSim(3, device='cpu')
    secint = tr.SecInt(32)
    values = VALUES[:7].tolist()
    xs = [secint(v) for v in values]
    trandom.shuffle(secint, xs)
    assert sorted(_open(tr, xs)) == sorted(values)
    rows = [[v, 10 * v] for v in values[:5]]
    xrows = [[secint(v) for v in row] for row in rows]
    trandom.shuffle(secint, xrows)
    got = [_open(tr, row) for row in xrows]
    assert sorted(got) == sorted(rows)


def test_runner_prints_the_jax_demos_sorted_lines(jax_demo):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = demo.main(['--device', 'cpu'])
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines[-1].endswith(': True')
    j_rc, j_lines, err = jax_demo()
    assert j_rc == 0, err
    for prefix in ('Setting input', 'Sorted by absolute value',
                   'np_sort ascending', 'Using secure integer arrays'):
        got = [ln for ln in lines if ln.startswith(prefix)]
        assert got and got == [ln for ln in j_lines
                               if ln.startswith(prefix)], prefix
