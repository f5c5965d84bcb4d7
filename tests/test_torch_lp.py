"""The LP solver's runner on the port, against the JAX package's demo.

The port's runner (``mpyc_tpu_torch.demos.np_lpsolver``) on datasets 0-4
on the CPU prints the same lines as the JAX package's demo
(``demos/np_lpsolver.py -M3 --sim``, run as a subprocess): the bit
length and field, the max, denominator and pivot count, the certificate
(True) and the solution; its opened results also equal the plain exact
solver's (``plain_solve``, Python ints). Dataset 4 (LPExample_R20) runs
on SecInt(70)'s four-limb field and takes the [NO07] zero test for its
certificate's c.x == y.b. The plain exact solver takes the demo's pivot
counts on every dataset the card runs. Module parity is in
``tests/test_torch_lp_parity.py``.

Tolerance: exact equality (printed lines, integers).
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from mpyc_tpu_torch.demos import np_lpsolver as lp
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

ROOT = Path(__file__).resolve().parents[1]
# the port's runs, the longest first: the JAX demo's on 4 take one thread
# and 0-3 another, so both are done about when the port's on 4 is
JAX_DATASETS = (4, 0, 1, 2, 3)


@pytest.fixture(scope='module')
def jax_demo_lines():
    """The JAX demo's printed lines on datasets 0-4, run in the
    background (no trace cache written: it would land in the checkout),
    each read when a test asks for it."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', MPYC_TPU_CACHE='0')
    done = {i: threading.Event() for i in JAX_DATASETS}
    results = {}
    procs = []

    def run(datasets):
        for i in datasets:
            proc = subprocess.Popen(
                [sys.executable, str(ROOT / 'demos' / 'np_lpsolver.py'),
                 '-M3', '--sim', '-i', str(i)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(proc)
            out, err = proc.communicate(timeout=900)
            results[i] = (proc.returncode, out.splitlines(), err[-2000:])
            done[i].set()
    threads = [threading.Thread(target=run, args=(part,), daemon=True)
               for part in (JAX_DATASETS[:1], JAX_DATASETS[1:])]
    for th in threads:
        th.start()

    def lines(i):
        assert done[i].wait(timeout=900), f'the JAX demo on {i} hangs'
        rc, out, err = results[i]
        assert rc == 0, err
        return out
    yield lines
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for th in threads:
        th.join(timeout=60)


@pytest.fixture
def one_thread():
    """The port's plain versions on tiny tensors gain nothing from torch's
    threads; one leaves the cores to the JAX demo and other tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('dataset', JAX_DATASETS)
def test_lp_runner_prints_the_jax_demos_lines(jax_demo_lines, one_thread,
                                              dataset):
    """Same lines as the JAX demo (including R20's max = 14428618776 /
    4192931952 in 9 pivots), and the plain exact solver's results."""
    printed = []
    res = lp.solve(TorchSim(3, device='cpu'), dataset, out=printed.append)
    assert printed == jax_demo_lines(dataset)
    name, _, scale, n_iter = lp.DATASETS[dataset]
    assert res['ok'] and res['iterations'] == n_iter
    assert (res['iterations'], res['mx'], res['cd'], res['x']) == \
        lp.plain_solve(lp.tableau_ints(name, scale))
    if dataset == 4:
        assert (res['mx'], res['cd']) == (14428618776, 4192931952)


def test_plain_solver_pivots_as_the_demo_expects():
    """The plain exact solver takes the demo's pivot counts on every
    dataset the card runs (sc50b and LPExample too)."""
    for i in (0, 1, 2, 3, 4, 5, 7):
        name, _, scale, n_iter = lp.DATASETS[i]
        assert lp.plain_solve(lp.tableau_ints(name, scale))[0] == n_iter
