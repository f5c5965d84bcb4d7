"""The LP solver's modules on the port, against the JAX package.

On inputs made from a seed with numpy: ``find_prime_root(l + 32, n)`` at
the LP's five (l, m + n) pairs; ``legendre`` and the public inverse, bit
for bit, on four and five limbs; the draws of a [NO07] test (random
bits, PRSS values) and ``np_fromlist`` share for share with the JAX
runtime after ``load_state`` (its PRSS keys and program counter);
``_np_is_zero``, ``reciprocal`` and ``np_outer`` by their opened values
against the JAX runtime's (on the CPU it reshares these fields' arrays
in its eager plane, another stream layout) and the plaintext;
``np_all``/``all``, ``np_append``, ``np_column_stack``, ``np.stack`` with
a Fortran-order reshape, division by public values, SecInt(l, p) and the
keyed ``np_argmin`` (``FracKey``) by their opened values; K5's plain
version at l = 70 and 110 on four and five limbs, opened against the
plaintext (the JAX package's fused step is compared at small l only: its
CPU compile time). The runner is in ``tests/test_torch_lp.py``.

Tolerance: exact equality (integers; bit patterns of Montgomery limbs).
"""
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jfinfields
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import finfields
from mpyc_tpu_torch.demos import np_lpsolver as lp
from mpyc_tpu_torch.ops.fieldops import (limbs_from_numpy, limbs_to_numpy,
                                         prime_field_ctx)
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (l, m + n) of the LP's datasets 0-5 and 7
LP_FIELDS = ((8, 5), (6, 5), (70, 40), (104, 118), (110, 490))


@pytest.mark.parametrize('l,n', LP_FIELDS)
def test_find_prime_root_matches_the_jax_package(l, n):
    got = finfields.find_prime_root(l + 32, n=n)
    assert got == tuple(int(v) for v in jfinfields.find_prime_root(l + 32,
                                                                   n=n))
    p, nth, w = got
    assert p % 4 == 3 and pow(w, nth, p) == 1 and w != 1
    field = finfields.GF(got)
    assert (field.nth, field.root) == (nth, w)
    assert field(w) * field(pow(w, nth - 1, p)) == field(1)


def _field_data(p, n, seed):
    """n random elements of GF(p), 0 and 1 among them: (JAX data, the
    port's limbs)."""
    g = np.random.default_rng(seed)
    vals = [0, 1] + [int(v) % p for v in
                     (g.integers(1, 1 << 62, n - 2).astype(object)
                      * g.integers(1, 1 << 62, n - 2).astype(object)
                      * g.integers(1, 1 << 62, n - 2).astype(object))]
    jarr = jfinfields.GF(p).array(np.array(vals, dtype=object))
    return jarr, limbs_from_numpy(np.asarray(jarr.data), 'cpu'), vals


@pytest.mark.parametrize('l,n', LP_FIELDS[2:])
def test_legendre_and_inverse_match_the_jax_package(l, n):
    """Bit for bit on the LP's four- and five-limb fields (K6's plain
    version: a^((p - 1) / 2) and a^(p - 2))."""
    p = finfields.find_prime_root(l + 32, n=n)[0]
    jarr, data, vals = _field_data(p, 40, l)
    ctx = prime_field_ctx(p)
    leg = ctx.legendre(data).numpy()
    np.testing.assert_array_equal(leg, np.asarray(jarr.ctx.legendre(
        jarr.data)))
    np.testing.assert_array_equal(
        leg, [0 if v == 0 else 1 if pow(v, (p - 1) // 2, p) == 1 else -1
              for v in vals])
    inv = finfields.GF(p).array.from_data(data).reciprocal()
    np.testing.assert_array_equal(limbs_to_numpy(inv.data),
                                  np.asarray(jarr.reciprocal().data))


@pytest.fixture(scope='module')
def runtimes():
    """A JAX SimRuntime(3) (wired into the JAX package's type layer for the
    module, the package's own runtime wired back after) and the port's."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        try:
            jr.start()
            yield jr, TorchSim(3, device='cpu')
            jr.shutdown()
        finally:
            if old is not None:
                old._wire_modules()


def _sync(jr, tr):
    """The port continues from the JAX runtime's randomness state: fused
    key and counter, input generator, PRSS keys and program counter."""
    jr._fused_state()
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])


def _same(jax_share, torch_share):
    np.testing.assert_array_equal(limbs_to_numpy(torch_share.data),
                                  np.asarray(jax_share.data))


# The JAX runtime on the CPU keeps these fields' arrays on its host plane
# and reshares them in its eager plane, another stream layout than its
# device plane's fused rounds, which the port's follow. So its PRSS draws
# (the same layout on both planes) are compared share for share, and the
# protocols built on them by their opened values.

def _zero_test_values(n, seed):
    g = np.random.default_rng(seed)
    v = g.integers(-1 << 60, 1 << 60, n).astype(object) * 512
    v[::3] = 0
    v[1] = 2 ** 69 - 1
    return v


def _port_share(tr, ts, jarr):
    """The JAX runtime's party-stacked shares as the port's secure array
    of type ts."""
    data = limbs_from_numpy(np.asarray(jarr.share.data), 'cpu')
    return tr._wrap(tr._sectype(ts(0)), ts.field.array.from_data(data))


@pytest.mark.parametrize('l,n', [(70, 40), (110, 490)])
def test_zero_test_draws_match_the_jax_package(runtimes, l, n):
    """The draws of a [NO07] test on the LP's four- and five-limb fields,
    share for share after load_state: k n random bits and the two PRSS
    draws of k n values (12 values, k = 30)."""
    jr, tr = runtimes
    jf, tf = jsectypes.SecInt(l, n=n).field, tr.SecInt(l, n=n).field
    _sync(jr, tr)
    for _ in range(2):
        _same(jr.np_random_bits(jf, 360), tr.np_random_bits(tf, 360))
        _same(jr._np_randoms(jf, 360), tr._np_randoms(tf, 360))
    assert tr._program_counter[0] == jr._program_counter[0]


def test_np_is_zero_opens_as_the_jax_package(runtimes):
    """[NO07] on SecInt(70) (four limbs) on 12 values: k = 30 trials an
    element, each with blinders of its own, 1 exactly at the zeros, as the
    JAX runtime's; the program counter advances by the same three draws."""
    jr, tr = runtimes
    js = jsectypes.SecInt(70, n=40)
    ts = tr.SecInt(70, n=40)
    assert ts.field.modulus == js.field.modulus
    x = _zero_test_values(12, 70)
    _sync(jr, tr)
    want = jr.output(jr._np_is_zero(js.array(x)))
    got = tr._np_is_zero(ts.array(x))
    assert tr._program_counter[0] == jr._program_counter[0]
    assert list(tr.output(got)) == [int(v) for v in want] == \
        [int(v == 0) for v in x]


@pytest.mark.parametrize('value', [3, 0, -2 ** 69])
def test_equality_of_secure_numbers_takes_no07(runtimes, value):
    """A secure number's == on SecInt(110) (five limbs) takes [NO07] (the
    LP certificate's c.x == y.b): a secure number, opened to the JAX
    runtime's answer."""
    jr, tr = runtimes
    js, ts = jsectypes.SecInt(110, n=490), tr.SecInt(110, n=490)
    got = tr.np_equal(ts(value), ts(0))
    assert isinstance(got, ts)
    want = jr.output(jr.np_equal(js(value), js(0)))
    assert tr.output(got) == int(want) == int(value == 0)


@pytest.mark.parametrize('l,n', [(8, 5), (110, 490)])
def test_reciprocal_opens_as_the_jax_package(runtimes, l, n):
    """Reciprocals of 300 values (PRSS r, the product r a reshared and
    opened, its public inverse, r / (r a)) open to the inverses mod p,
    and a * (1 / a) to 1; a secure number's (the LP's 1 / denom) opens to
    the JAX runtime's, with the same program counter after."""
    jr, tr = runtimes
    js, ts = jsectypes.SecInt(l, n=n), tr.SecInt(l, n=n)
    p = ts.field.modulus
    x = np.random.default_rng(l).integers(1, 1 << 20, 300).astype(object)
    x[::2] *= -1
    got = tr.reciprocal(ts.array(x))
    inv = tr.output(got, raw=True).value
    assert [int(v) for v in inv] == [pow(int(a), -1, p) for a in x]
    assert all(int(v) == 1 for v in tr.output(tr.mul(got, ts.array(x))))
    _sync(jr, tr)
    want = jr.output(1 / js(7), raw=True)
    got = tr.output(1 / ts(7), raw=True)
    assert tr._program_counter[0] == jr._program_counter[0]
    assert int(got.value[()]) == int(np.asarray(want.value).reshape(-1)[0]) \
        == pow(7, -1, p)
    assert int(tr.output(ts(21) * (1 / ts(7)))) == 3


def test_outer_and_fromlist_match_the_jax_package(runtimes):
    """np_outer of the JAX runtime's input shares opens to the JAX
    runtime's outer product and numpy's; np_fromlist of secure numbers
    (indexed out of them, and a public one) equals the JAX runtime's
    share for share."""
    jr, tr = runtimes
    js, ts = jsectypes.SecInt(70, n=40), tr.SecInt(70, n=40)
    g = np.random.default_rng(61)
    a = g.integers(-1000, 1000, 30).astype(object)
    b = g.integers(-1000, 1000, 26).astype(object)
    ja, jb = jr.input(js.array(a), 0), jr.input(js.array(b), 0)
    ta, tb = _port_share(tr, ts, ja), _port_share(tr, ts, jb)
    got = np.outer(ta, tb)
    assert got.shape == (30, 26)
    want = jr.output(jr.np_outer(ja, jb))
    np.testing.assert_array_equal(tr.output(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(tr.output(got).astype(np.int64),
                                  np.outer(a, b).astype(np.int64))
    items = [ta[1], ta[3], tb[0], ts(9)]
    jitems = [ja[1], ja[3], jb[0], js(9)]
    _same(jr.np_fromlist(jitems).share, tr.np_fromlist(items).share)
    assert list(tr.output(tr.np_fromlist(items))) == [a[1], a[3], b[0], 9]


def test_all_append_column_stack_open_as_numpy(runtimes):
    """np_all over axes and all of a list of secure numbers (products of
    0/1 values), np_append and np_column_stack with public operands,
    np.stack and the Fortran-order reshape, opened against numpy."""
    jr, tr = runtimes
    ts = tr.SecInt(8, n=5)
    bits = np.array([[1, 1, 0], [1, 1, 1]])
    B = tr.input(ts.array(bits), 0)
    assert tr.output(tr.np_all(B)) == 0
    np.testing.assert_array_equal(tr.output(tr.np_all(B, axis=1)), [0, 1])
    np.testing.assert_array_equal(tr.output(tr.np_all(B, axis=0)),
                                  [1, 1, 0])
    ones = [B[0, 0], B[1, 2], ts(1)]
    assert tr.output(tr.all(ones)) == 1
    assert tr.output(tr.all(ones + [B[0, 2]])) == 0
    x = tr.input(ts.array(np.arange(6)), 0)
    np.testing.assert_array_equal(
        tr.output(np.append(x, np.array([7, 8]))), [0, 1, 2, 3, 4, 5, 7, 8])
    np.testing.assert_array_equal(
        tr.output(np.column_stack((x[:3], np.array([5, 6, 7])))),
        np.column_stack((np.arange(3), [5, 6, 7])))
    np.testing.assert_array_equal(
        tr.output(np.stack((x[:3], x[3:])).reshape(6, order='F')),
        np.stack((np.arange(3), np.arange(3, 6))).reshape(6, order='F'))
    np.testing.assert_array_equal(
        tr.output(np.concatenate((x[:2], np.array([0])))), [0, 1, 0])


@pytest.mark.parametrize('seed', [0, 1])
def test_keyed_argmin_matches_the_jax_package(runtimes, seed):
    """ratios.argmin(key=FracKey): the unit vector of the least fraction
    (first occurrence), rows of denominator <= 0 keyed (b + 1, d) as the
    demo builds them, and the picked pair; the JAX runtime's opened
    values, the plain tournament's and numpy's agree."""
    jr, tr = runtimes
    js, ts = jsectypes.SecInt(8, n=5), tr.SecInt(8, n=5)
    g = np.random.default_rng(seed)
    den = g.integers(-3, 6, 7)
    num = g.integers(0, 9, 7) + (den <= 0)
    pairs = np.stack([num, den], axis=1)
    for rt, st in ((tr, ts), (jr, js)):
        X = rt.input(st.array(pairs.astype(object)), 0)
        sel, picked = X.argmin(key=lp.FracKey)
        sel, picked = rt.output(sel), rt.output(picked)
        sel = [int(v) for v in np.asarray(sel).tolist()]
        picked = [int(v) for v in np.asarray(picked).tolist()]
        i = lp._plain_argmin([tuple(r) for r in pairs.tolist()],
                             lambda u, v: u[0] * v[1] < v[0] * u[1])
        assert sel == [int(k == i) for k in range(7)], rt
        assert picked == list(pairs[i])
    valid = [k for k in range(7) if den[k] > 0]
    if valid:
        best = min(valid, key=lambda k: (num[k] / den[k], k))
        assert i == best


@pytest.mark.parametrize('l,n,limbs', [(70, 40, 4), (110, 490, 5)])
def test_sgn_plain_at_the_lp_widths_opens_to_the_plaintext(l, n, limbs):
    """K5's plain version at l = 70 (four limbs) and l = 110 (five), LT
    and EQ modes through np_less and np_sgn, values across the width."""
    rt = TorchSim(3, device='cpu')
    st = rt.SecInt(l, n=n)
    assert st.field.array.ctx.L == limbs
    g = np.random.default_rng(l)
    half = 1 << (l - 2)
    a = [int(v) for v in g.integers(-1 << 60, 1 << 60, 6)] + \
        [half - 1, -half, 0, 5]
    b = [int(v) for v in g.integers(-1 << 60, 1 << 60, 6)] + \
        [-half, half - 1, 0, 5]
    A = rt.input(st.array(np.array(a, dtype=object)), 0)
    B = rt.input(st.array(np.array(b, dtype=object)), 0)
    assert [int(v) for v in rt.output(A < B)] == \
        [int(x < y) for x, y in zip(a, b)]
    d = rt.sub(A, B)
    assert [int(v) for v in rt.output(rt.np_sgn(d, EQ=True))] == \
        [int(x == y) for x, y in zip(a, b)]


def test_division_by_public_values_and_given_primes():
    """div by a public divisor: an integer type's local product by its
    inverse mod p (21 / 7 opens to 3), a fixed-point type's product by
    1 / b (truncated: x / 4 or one step of 2^-f more); SecInt(l, p) on a
    given prime, which needs more than l + k + 1 bits."""
    rt = TorchSim(3, device='cpu')
    s8 = rt.SecInt(8)
    x = rt.input(s8.array(np.array([21, -14, 0])), 0)
    assert list(rt.output(x / 7)) == [3, -2, 0]
    assert list(rt.output(x / np.array([7, 7, 5]))) == [3, -2, 0]
    fx = rt.SecFxp(14, 6)
    y = rt.output(rt.input(fx.array(np.array([3.0, -5.5])), 0) / 4)
    assert all(abs(v - w) <= 2 ** -6 for v, w in zip(y, [0.75, -1.375]))
    p = s8.field.modulus
    given = rt.SecInt(8, p=p)
    assert given.field.modulus == p and given is not s8
    assert int(rt.output(given(5) * given(-3))) == -15
    with pytest.raises(ValueError, match='too small'):
        rt.SecInt(40, p=p)
