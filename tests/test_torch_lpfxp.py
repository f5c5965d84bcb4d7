"""The fixed-point LP solver's runner on the port against the JAX
package's demo.

``demos/np_lpsolverfxp.py`` runs in this process on a JAX
``SimRuntime(3)`` (its ``mpc`` pointed at it), and the port's runner
(``mpyc_tpu_torch.demos.np_lpsolverfxp.solve``) on a port runtime that
starts from the JAX runtime's PRSS keys and program counter
(``load_state``). Both print the same lines on uvlp, wiki and tb2x2 (the
opened maximum, its error and the pivot count, the certificate, True,
and the opened solution, all fixed-point values to the last bit), and
end at the same program counter: every truncation draws the same PRSS
randomness, so the probabilistic roundings agree.

One adapter on the JAX side: on the CPU its comparisons of fields above
32 bits take its eager plane, which draws PRSS random bits, where its
device plane and the port run the fused comparison on their own stream
(``mpyc_tpu/parallel/simulator.py:433-453``). A comparison's opened
result does not depend on those draws, so the test restores the JAX
runtime's program counter after each comparison, and both runtimes draw
the same PRSS sequence for everything else.

The runner's own checks hold too: the pivots those of the plain float
solver, the opened max within 1% of the optimum and the solution within
``solution_tol`` of the float solver's (``check_solution``).

Tolerance: exact equality of the printed lines and counters.
"""
import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

import mpyc_tpu.runtime as jruntime
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.demos import np_lpsolverfxp as lpf
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'demos', 'np_lpsolverfxp.py')


@pytest.fixture(scope='module')
def jax_demo():
    """The JAX demo bound to a JAX SimRuntime (wired into the JAX
    package's type layer, its own runtime wired back after), whose
    comparisons leave the program counter as they found it."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        mp.setattr(jruntime, 'mpc', jr)
        np_sgn = jr.np_sgn

        def np_sgn_same_pc(*args, **kwargs):
            pc = jr._program_counter[0]
            try:
                return np_sgn(*args, **kwargs)
            finally:
                jr._program_counter[0] = pc
        mp.setattr(jr, 'np_sgn', np_sgn_same_pc)
        spec = importlib.util.spec_from_file_location('jax_lpfxp_demo', DEMO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        try:
            yield jr, mod
        finally:
            if old is not None:
                old._wire_modules()


@pytest.fixture
def one_thread():
    """The port's plain versions on tiny tensors gain nothing from torch's
    threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('dataset', [0, 1, 2])
def test_lpfxp_runner_prints_the_jax_demos_lines(jax_demo, one_thread,
                                                 dataset):
    jr, mod = jax_demo
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['np_lpsolverfxp.py', '-i', str(dataset)])
        with contextlib.redirect_stdout(buf):
            mod.main()
    printed = []
    res = lpf.solve(tr, dataset, out=printed.append)
    assert printed == buf.getvalue().splitlines()
    assert tr._program_counter[0] == jr._program_counter[0]
    name, bit_length, _ = lpf.DATASETS[dataset]
    iters, err, tol = lpf.check_solution(name, bit_length,
                                         res['iterations'], res['x'])
    assert res['ok'] and res['iterations'] == iters
    assert abs(res['rel_error']) <= lpf.REL_ERROR
    assert err <= tol


def test_plain_solver_pivots_as_the_float_simplex():
    """The plain float solver reaches each dataset's optimum within 1e-4
    (relative; kb2's CSV rounds its data: 1.2e-5 off) in a pivot count
    of its own: the solutions the card's runs are held to."""
    want = {'uvlp': 2, 'wiki': 1, 'tb2x2': 2, 'woody': 3,
            'LPExample_R20': 9, 'sc50b': 54, 'kb2': 153, 'LPExample': 175}
    for name, _, exact in lpf.DATASETS:
        iters, mx, _ = lpf.plain_solve(lpf.read_csv(name))
        assert iters == want[name]
        assert abs(mx - exact) <= 1e-4 * abs(exact)
