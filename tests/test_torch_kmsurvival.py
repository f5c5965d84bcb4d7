"""The survival test's runner on the port against the JAX package's demo.

``demos/kmsurvival.py`` runs in this process on a JAX ``SimRuntime(3)``
(its ``mpc`` pointed at it), and the port's runner
(``mpyc_tpu_torch.demos.np_kmsurvival.run``) on a port runtime that
starts from the JAX runtime's PRSS keys and program counter
(``load_state``): on btrial (SecFxp(56, 28); zero tests by the comparison
in EQ mode) and on aml with ``--agg`` (SecFxp(64, 32), a four-limb field
with 4p >= R; zero tests by [NO07]'s probabilistic test, with PRSS
draws). Both print the same lines (the secure chi-squared statistic to
six digits, the plain one, the aggregated one) and end at the same
program counter, and each statistic lies within 1e-3 (relative) of the
plain logrank test, as the demo asserts.

As in ``tests/test_torch_lpfxp.py``, the JAX runtime's comparisons, which
on the CPU draw PRSS random bits where the port's fused comparison does
not, leave its program counter as they found it; their opened results
do not depend on those draws.

Tolerance: exact equality of the printed lines and counters; the demo's
1e-3 against the plain statistic.
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
from mpyc_tpu_torch.demos import np_kmsurvival as km
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'demos', 'kmsurvival.py')


@pytest.fixture(autouse=True)
def one_thread():
    """The port's plain versions on tiny tensors gain nothing from torch's
    threads, and the JAX package's CPU plane keeps its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        spec = importlib.util.spec_from_file_location('jax_km_demo', DEMO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        try:
            yield jr, mod
        finally:
            if old is not None:
                old._wire_modules()


@pytest.mark.parametrize('dataset,agg', [(0, False), (2, True)])
def test_kmsurvival_runner_prints_the_jax_demos_lines(jax_demo, dataset,
                                                      agg):
    jr, mod = jax_demo
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['kmsurvival.py', '-i', str(dataset)]
                   + ['--agg'] * agg)
        with contextlib.redirect_stdout(buf):
            mod.main()
    printed = []
    res = km.run(tr, dataset, agg=agg, out=printed.append)
    assert printed == buf.getvalue().splitlines()
    assert tr._program_counter[0] == jr._program_counter[0]
    assert km.close(res['chi'], res['chi_ref'])
    assert res['chi_agg'] is None if not agg else \
        km.close(res['chi_agg'], res['chi_ref'])
