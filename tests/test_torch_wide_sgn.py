"""Comparisons over wide prime fields (7 to 48 limbs) on the port, against
Python and the JAX package.

The port's ``SimRuntime`` compares SecInt(192) values (a 224-bit field,
seven limbs) at (t, m) = (1, 3) and (2, 5): ``np_less`` (the comparison
in LT mode), ``np_sgn`` of the difference (sgn mode), ``np_sgn(...,
EQ=True)`` (EQ mode) and ``np_equal`` (above 60 bits [NO07]'s zero test),
on 12 values with 0, equal pairs and the range's ends; every opened
output is Python's comparison of the inputs. On the first four values the
JAX package's ``SimRuntime``, loaded with the same randomness state
(``_pair``), opens the same outputs: its CPU plane compares fields wider
than 32 bits eagerly (``mpyc_tpu/parallel/simulator.py:438-442``), so
wide parity goes by opened values; the bit-exact stream parity of the
comparison step stays at one limb (``tests/test_torch_sgn_step.py``), and
the wide kernel is held against the step's plain version bit for bit by
``tests/test_torch_kernels_host.py`` and on the card. One case at 19
limbs (SecInt(560), kb2's width) compares at l = 32, so that its plain
version runs in seconds.

On the CPU the port runs the comparison's plain version
(``pipelines._sgn_step_plain``); on the card the same calls launch the
wide K5 (``csrc/sgn_wide.cu``).

Tolerance: exact equality.
"""
import random

import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_runtime_wired_back(monkeypatch):
    """No trace cache written into the repository; the JAX package's own
    runtime wired back after each test (other test files use it)."""
    monkeypatch.setenv('MPYC_TPU_CACHE', '0')
    old = jsectypes.runtime
    yield
    if old is not None:
        old._wire_modules()


def _pair(m, t):
    """A JAX SimRuntime(m) at threshold t wired into its type layer, and
    the port's at the same (t, m), loaded with the JAX one's state."""
    jr = JaxSim(m, _Options(threshold=t))
    jr._wire_modules()
    jr.start()
    tr = TorchSim(m, device='cpu', threshold=t)
    tr.start()
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr if
                                            jr._fused_ctr is not None
                                            else np.zeros(2, np.uint32)),
                  jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return jr, tr


def _values(bits, n, seed):
    """n pairs of signed ints below 2^(bits - 2) (so a - b fits bits):
    0 = 0, the range's ends, an equal pair, the rest random."""
    g = random.Random(seed)
    lim = (1 << bits - 2) - 1
    a = [0, lim, -lim, 5] + [g.randrange(-lim, lim) for _ in range(n - 4)]
    b = [0, -lim, lim, 5] + [g.randrange(-lim, lim) for _ in range(n - 4)]
    b[6] = a[6]
    return (np.array(a[:n], dtype=object), np.array(b[:n], dtype=object))


OPS = {
    'np_less': (lambda rt, A, B: rt.np_less(A, B),
                lambda x, y: int(x < y)),
    'np_sgn': (lambda rt, A, B: rt.np_sgn(A - B),
               lambda x, y: (x > y) - (x < y)),
    'np_sgn EQ': (lambda rt, A, B: rt.np_sgn(A - B, EQ=True),
                  lambda x, y: int(x == y)),
    'np_equal': (lambda rt, A, B: rt.np_equal(A, B),
                 lambda x, y: int(x == y)),
}


@pytest.mark.parametrize('op,tm', [(op, (1, 3)) for op in OPS] + [
    (op, (2, 5)) for op in OPS if op != 'np_equal'])
def test_wide_comparison_opens_to_python_and_jax(op, tm):
    """SecInt(192) (seven limbs): the opened comparison of 12 values is
    Python's; the JAX package's SimRuntime opens the same on the first
    four. Each mode at (1, 3) and (2, 5); np_equal ([NO07]) at (1, 3)."""
    t, m = tm
    jr, tr = _pair(m, t)
    ts, js = tr.SecInt(192), jr.SecInt(192)
    assert ts.field.modulus == js.field.modulus
    assert ts.field.array.ctx.L == 7
    a, b = _values(192, 12, seed=7 + m)
    secure, plain = OPS[op]
    want = [plain(x, y) for x, y in zip(a, b)]
    A, B = tr.input(ts.array(a))[0], tr.input(ts.array(b))[1]
    got = [int(v) for v in tr.output(secure(tr, A, B))]
    assert got == want
    JA, JB = jr.input(js.array(a[:4]))[0], jr.input(js.array(b[:4]))[1]
    assert [int(v) for v in jr.output(secure(jr, JA, JB))] == got[:4]


@pytest.mark.parametrize('mode', ['sgn', 'LT', 'EQ'])
def test_nineteen_limb_comparison_at_32_bits(mode):
    """SecInt(560) (kb2's 592-bit field, 19 limbs) compared at l = 32:
    the opened outputs are Python's."""
    tr = TorchSim(3, device='cpu')
    tr.start()
    ts = tr.SecInt(560)
    assert ts.field.array.ctx.L == 19
    a, b = _values(32, 8, seed=19)
    A, B = tr.input(ts.array(a))[0], tr.input(ts.array(b))[1]
    d = A - B
    out = tr.np_sgn(d, l=32, LT=mode == 'LT', EQ=mode == 'EQ')
    got = [int(v) for v in tr.output(out)]
    op = {'sgn': 'np_sgn', 'LT': 'np_less', 'EQ': 'np_sgn EQ'}[mode]
    assert got == [OPS[op][1](x, y) for x, y in zip(a, b)]
