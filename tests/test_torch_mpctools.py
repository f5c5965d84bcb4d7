"""``mpyc_tpu_torch.mpctools`` (reduce, accumulate) against the JAX
package's ``mpyc_tpu.mpctools``.

On public values both give the same results for associative and
non-commutative functions (string concatenation, 2 x 2 matrix products
mod 101), by each network, with and without an initial value; the
default network follows the same cost rule (Sklansky, or Brent-Kung for
a runtime without PRSS from 32 values on). On secure numbers the prefix
OR of bits and the prefix sums open to the JAX package's values and to
itertools'. Each network applies f as often as its schedule says
(Sklansky (n / 2) log2 n, Brent-Kung 2n - 2 - log2 n for n a power of 2).

Tolerance: exact.
"""
import itertools
import operator

import numpy as np
import pytest
import torch

from mpyc_tpu import mpctools as jmpctools
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import mpctools as tmpctools
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


def _matmul(a, b):
    return ((a[0] * b[0] + a[1] * b[2]) % 101,
            (a[0] * b[1] + a[1] * b[3]) % 101,
            (a[2] * b[0] + a[3] * b[2]) % 101,
            (a[2] * b[1] + a[3] * b[3]) % 101)


def _inputs(n):
    g = np.random.default_rng(n)
    mats = [tuple(int(v) for v in g.integers(0, 101, 4)) for _ in range(n)]
    return {'concat': (operator.add, [chr(97 + i % 26) for i in range(n)]),
            'matmul': (_matmul, mats)}


@pytest.mark.parametrize('method', ['Sklansky', 'Brent-Kung', None])
@pytest.mark.parametrize('n', [1, 2, 7, 16, 33])
def test_accumulate_and_reduce_match_jax(jr, n, method):
    for f, x in _inputs(n).values():
        want = list(jmpctools.accumulate(x, f, method=method))
        got = list(tmpctools.accumulate(x, f, method=method))
        assert got == want == list(itertools.accumulate(x, f))
        assert list(tmpctools.accumulate(x, f, initial=x[0], method=method)) \
            == list(jmpctools.accumulate(x, f, initial=x[0], method=method))
        assert tmpctools.reduce(f, x) == jmpctools.reduce(f, x) == want[-1]
        assert tmpctools.reduce(f, x, x[-1]) == jmpctools.reduce(f, x, x[-1])


class _NoPrss:
    no_prss = True


class _Counted:
    """A value whose runtime has no PRSS, counting f's applications."""

    def __init__(self, v, runtime=None):
        self.v, self.runtime = v, runtime


@pytest.mark.parametrize('n', [16, 32, 64])
def test_cost_rule_and_work(n):
    """Sklansky's and Brent-Kung's numbers of applications, and the
    default: Brent-Kung only for a runtime without PRSS and n >= 32."""
    calls = []

    def f(a, b):
        calls.append(1)
        return _Counted(a.v + b.v, a.runtime)
    x = [_Counted(1, _NoPrss()) for _ in range(n)]
    k = n.bit_length() - 1
    for method, work in (('Sklansky', n // 2 * k),
                         ('Brent-Kung', 2 * n - 2 - k)):
        calls.clear()
        out = [c.v for c in tmpctools.accumulate(x, f, method=method)]
        assert out == list(range(1, n + 1)) and len(calls) == work
    calls.clear()
    list(tmpctools.accumulate(x, f))
    assert len(calls) == (2 * n - 2 - k if n >= 32 else n // 2 * k)
    calls.clear()
    list(tmpctools.accumulate([_Counted(1) for _ in range(n)], f))
    assert len(calls) == n // 2 * k
    with pytest.raises(ValueError):
        tmpctools.accumulate(x, f, method='Kogge-Stone')
    with pytest.raises(TypeError):
        tmpctools.reduce(f, [])


def test_secure_prefix_or_and_sums_match_jax(jr):
    tr = TorchSim(3, device='cpu')
    bits = [0, 1, 0, 0, 1, 1, 0]
    res = []
    for rt in (jr, tr):
        t = rt.SecInt(32)
        x = [rt.input(t(b), senders=0) for b in bits]

        def or2(a, b):
            return a + b - a * b
        mod = jmpctools if rt is jr else tmpctools
        res.append([[int(rt.output(v)) for v in
                     mod.accumulate(x, or2, method=m)]
                    for m in ('Sklansky', 'Brent-Kung')]
                   + [int(rt.output(mod.reduce(operator.add, x)))])
    assert res[0] == res[1]
    want = list(itertools.accumulate(bits, operator.or_))
    assert res[1] == [want, want, sum(bits)]
