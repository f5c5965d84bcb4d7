"""Secure random on the port (``mpyc_tpu_torch.random``), against the JAX
package's ``mpyc_tpu.random``.

Both runtimes start from the same PRSS keys and program counter
(``load_state``), so their random bits are the same values; the
functions open the same values where nothing else draws PRSS values
between them:

* ``getrandbits`` (value and bits), ``randrange`` and ``randint`` at
  SecInt(32) (a power of two and the batched rejection test of
  ``_randbelow``, one opening an attempt), ``randrange`` over
  SecFld(1031) and of its order (one random element);
* ``choice``, ``random_permutation``, ``random_derangement`` (a public
  zero test a draw, one PRSS value in both), ``sample`` of a list and of
  a range;
* ``random`` and ``uniform`` at SecFxp(24, 12).

``choices`` by weights compares, which the JAX package's CPU plane does
with PRSS draws of its own, so it is held by its properties: elements of
the population, none of weight 0. Every result is also held by its
properties: in range, a permutation, a derangement, distinct samples.

Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from mpyc_tpu import random as jrandom
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import random as trandom
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jr():
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        rt = JaxSim(3, _Options())
        rt._wire_modules()
        rt.start()
        try:
            yield rt
        finally:
            rt.shutdown()
            if old is not None:
                old._wire_modules()


def _port(jr):
    """A port runtime with the JAX runtime's PRSS keys and program
    counter."""
    tr = TorchSim(3, device='cpu')
    tr.load_state(bytes(32), np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return tr


def _open(rt, x):
    if isinstance(x, list):
        return [_open(rt, v) for v in x]
    v = rt.output(x)
    return float(v) if isinstance(v, float) else int(v)


def _types(jr, tr, kind):
    if kind == 'int':
        return jr.SecInt(32), tr.SecInt(32)
    if kind == 'fxp':
        return jr.SecFxp(24, 12), tr.SecFxp(24, 12)
    return jr.SecFld(1031), tr.SecFld(1031)


CASES = {
    'getrandbits': ('int', lambda R, t: R.getrandbits(t, 7)),
    'getrandbits bits': ('int', lambda R, t: R.getrandbits(t, 4, bits=True)),
    'randrange': ('int', lambda R, t: [R.randrange(t, 3, 40, 5)
                                       for _ in range(3)]),
    'randint': ('int', lambda R, t: [R.randint(t, -6, 6) for _ in range(3)]),
    'randrange secfld': ('fld', lambda R, t: [R.randrange(t, 1000),
                                              R.randrange(t, 1031)]),
    'choice': ('int', lambda R, t: R.choice(t, [10, 20, 30, 40, 50])),
    'random_permutation': ('int', lambda R, t: R.random_permutation(t, 5)),
    'random_derangement': ('int', lambda R, t: R.random_derangement(t, 4)),
    'sample list': ('int', lambda R, t: R.sample(t, [4, 8, 15, 16, 23], 3)),
    'sample range': ('int', lambda R, t: R.sample(t, range(0, 21, 2), 3)),
    'random': ('fxp', lambda R, t: R.random(t)),
    'uniform': ('fxp', lambda R, t: R.uniform(t, -1.5, 0.25)),
}


def _holds(name, got):
    """The property each function's opened result must have."""
    if name == 'getrandbits':
        return 0 <= got < 128
    if name == 'getrandbits bits':
        return len(got) == 4 and set(got) <= {0, 1}
    if name == 'randrange':
        return all(v in range(3, 40, 5) for v in got)
    if name == 'randint':
        return all(-6 <= v <= 6 for v in got)
    if name == 'randrange secfld':
        return 0 <= got[0] < 1000 and 0 <= got[1] < 1031
    if name == 'choice':
        return got in (10, 20, 30, 40, 50)
    if name == 'random_permutation':
        return sorted(got) == list(range(5))
    if name == 'random_derangement':
        return sorted(got) == list(range(4)) and \
            all(v != i for i, v in enumerate(got))
    if name == 'sample list':
        return len(set(got)) == 3 and set(got) <= {4, 8, 15, 16, 23}
    if name == 'sample range':
        return len(set(got)) == 3 and set(got) <= set(range(0, 21, 2))
    if name == 'random':
        return 0 <= got < 1 and (got * 4096).is_integer()
    return -1.5 <= got <= 0.25 and (got * 4096).is_integer()


@pytest.mark.parametrize('name', list(CASES))
def test_random_matches_jax(jr, name):
    kind, fn = CASES[name]
    tr = _port(jr)
    jt, tt = _types(jr, tr, kind)
    want = _open(jr, fn(jrandom, jt))
    got = _open(tr, fn(trandom, tt))
    assert got == want
    assert _holds(name, got), got


def test_choices_by_weights_hold_their_properties():
    """Weighted choices (secure comparisons of r against the cumulative
    weights) pick elements of the population, never one of weight 0, and
    uniform choices any element."""
    tr = TorchSim(3, device='cpu')
    secint = tr.SecInt(32)
    got = [int(tr.output(v)) for v in trandom.choices(
        secint, [7, 8, 9], weights=[2, 0, 3], k=3)]
    assert set(got) <= {7, 9}
    got = [int(tr.output(v)) for v in trandom.choices(
        secint, [7, 8, 9], cum_weights=[0, 4, 4], k=2)]
    assert got == [8, 8]
    assert int(tr.output(trandom.choices(secint, [5, 6], k=1)[0])) in (5, 6)
    with pytest.raises(TypeError):
        trandom.random(secint)
