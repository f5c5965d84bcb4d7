"""Port's comparison step (mpyc_tpu_torch.models.pipelines.make_sgn_step,
kernel K5's plain version on the CPU) against the JAX package's
make_sgn_step, which runs its XLA step on the CPU, for the same shares,
state and counter.

The JAX step's first call compiles for seconds even at these small
parameters (one-limb field p = next_prime(2^17), l = 6, k = 8), so the
full width (SecInt(32), l = 32, k = 30) is checked by opening the
outputs (tests/test_torch_compare.py), and on the card against the plain
version (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: exact equality (bit patterns of Montgomery limbs)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops import limb as tlimb
from mpyc_tpu_torch.ops.fieldops import (limbs_from_numpy, limbs_to_numpy,
                                         prime_field_ctx)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P17 = 131101          # next_prime(2^17): a one-limb field
L_BITS, K = 6, 8
N = 64
MODES = {'sgn': {}, 'LT': {'LT': True}, 'EQ': {'EQ': True}}


@functools.cache
def _jax_step(p, l, k, mode, f=0):
    return jpipe.make_sgn_step(p, 1, 3, l, k, f=f, **MODES[mode])


def state() -> np.ndarray:
    hi, lo = jkeccak._absorb_host(bytes(range(60, 92)) + bytes(8))
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


def shares_of(p, vals, seed) -> np.ndarray:
    """Degree-1 Shamir shares at x = 1, 2, 3 of vals, Montgomery limbs."""
    ctx = prime_field_ctx(p)
    g = np.random.default_rng(seed)
    coef = [int(c) for c in g.integers(0, p, len(vals), dtype=np.uint64)]
    rows = [[(int(v) + c * x) % p * ctx.R % p for v, c in zip(vals, coef)]
            for x in (1, 2, 3)]
    return tlimb.ints_to_limbs(np.array(rows, dtype=object), ctx.L)


def opened(p, out) -> list:
    """Signed values of (3, n, L) degree-1 shares (Lagrange from x = 1, 2)."""
    ctx = prime_field_ctx(p)
    v = tlimb.limbs_to_ints(out)
    r_inv = pow(ctx.R, -1, p)
    res = [(2 * int(v[0, e]) - int(v[1, e])) * r_inv % p
           for e in range(v.shape[1])]
    return [x - p if x > p // 2 else x for x in res]


def run_both(p, l, k, mode, a, ctr, f=0):
    st = state()
    jout, jctr = _jax_step(p, l, k, mode, f)(jnp.asarray(a), jnp.asarray(st),
                                             jnp.asarray(ctr))
    tstep = tpipe.make_sgn_step(p, 1, 3, l, k, f=f, **MODES[mode])
    tout, tctr = tstep(limbs_from_numpy(a, 'cpu'),
                       tkeccak.state_tensor(st, 'cpu'), ctr)
    return np.asarray(jout), np.asarray(jctr), limbs_to_numpy(tout), tctr


def values(l, seed):
    g = np.random.default_rng(seed)
    v = g.integers(-(1 << (l - 1)), 1 << (l - 1), N)
    v[:4] = [-(1 << (l - 1)), (1 << (l - 1)) - 1, 0, -1]
    return v


@pytest.mark.parametrize('mode', list(MODES))
def test_small_field_matches_jax(mode):
    """(a) p = next_prime(2^17), l = 6, k = 8, n = 64: shares and counter
    bit for bit; the shares open to the plaintext result."""
    v = values(L_BITS, 1)
    a = shares_of(P17, v, 2)
    jout, jctr, tout, tctr = run_both(P17, L_BITS, K, mode, a,
                                      np.array([5, 0], np.uint32))
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tctr, jctr)
    want = {'sgn': np.sign(v), 'LT': v < 0, 'EQ': v == 0}[mode]
    assert opened(P17, tout) == [int(x) for x in want]


def test_counter_carry_matches_jax():
    """A counter of (0xFFFFFFFF, 0): the call's stream and the carry into
    the high word are the JAX package's."""
    a = shares_of(P17, values(L_BITS, 3), 4)
    jout, jctr, tout, tctr = run_both(P17, L_BITS, K, 'sgn', a,
                                      np.array([0xFFFFFFFF, 0], np.uint32))
    np.testing.assert_array_equal(tout, jout)
    assert tctr.tolist() == np.asarray(jctr).tolist() == [0, 1]


def test_fixed_point_scale_matches_jax():
    """(c) f = 3: the result times 2^3, bit for bit."""
    v = values(L_BITS, 5)
    a = shares_of(P17, v, 6)
    jout, _, tout, _ = run_both(P17, L_BITS, K, 'LT', a,
                                np.array([9, 2], np.uint32), f=3)
    np.testing.assert_array_equal(tout, jout)
    assert opened(P17, tout) == [8 * int(x < 0) for x in v]


def test_stream_budget_at_full_width():
    """Draws and stream-A words per element at l = 32, k = 30 (SecInt(32)),
    as the XLA step budgets them (pipelines.py:859-870): sgn 100 and 3, LT
    68 and 3, EQ 64 and 2."""
    p = 18446744073709551427
    got = {}
    for mode, kw in MODES.items():
        spec = tpipe.SgnSpec(p, 1, 3, 32, 30, **kw)
        got[mode] = (spec.draws_per_element(), spec.wpe)
    assert got == {'sgn': (100, 3), 'LT': (68, 3), 'EQ': (64, 2)}


P46 = 70368744177643   # SecInt(14)'s field: the BNN's, two limbs


@pytest.mark.parametrize('l', [14, 10])
def test_bnn_widths_match_jax_beyond_the_range(l):
    """LT mode at the BNN's widths on SecInt(14)'s field (k = 30), with
    inputs beyond [-2^l, 2^l) as the demo's layer sums are (fc1's reach
    -27,486..25,986 at l = 14): shares and counter bit for bit with the
    JAX step, and the rule both follow: the step opens to
    LT(a) = -floor(a / 2^l), which is the bit a < 0 inside the range and
    a negative or larger integer outside it (the masked open
    c = a + 2^l + r does not wrap mod p while |a| << 2^(l + k))."""
    g = np.random.default_rng(l)
    v = g.integers(-(1 << (l + 2)), 1 << (l + 2), N)
    v[:8] = [-27486, 25986, -(1 << l), (1 << l) - 1, 1 << l, -(1 << l) - 1,
             0, -1]
    a = shares_of(P46, v, 7)
    jout, jctr, tout, tctr = run_both(P46, l, 30, 'LT', a,
                                      np.array([3, 0], np.uint32))
    np.testing.assert_array_equal(tout, jout)
    np.testing.assert_array_equal(tctr, jctr)
    assert opened(P46, tout) == [-(int(x) >> l) for x in v]


@pytest.mark.parametrize('l,k', [(33, 30), (1, 62), (20, 43)])
def test_widths_past_the_field_are_not_ported(l, k):
    """l + k + 2 above p's bit length (64 at SecInt(32)'s field): the JAX
    package compares such values with its eager np_sgn
    (``mpyc_tpu/runtime.py:2728``), which the port has not, so the spec
    raises NotImplementedError naming it; l + k + 2 = 64 is taken, and
    l < 1 is a ValueError."""
    p = 18446744073709551427
    with pytest.raises(NotImplementedError, match='eager np_sgn'):
        tpipe.SgnSpec(p, 1, 3, l, k, LT=True)
    assert tpipe.SgnSpec(p, 1, 3, l, 62 - l, LT=True).l == l
    with pytest.raises(ValueError, match='l >= 1'):
        tpipe.SgnSpec(p, 1, 3, 0, k)
