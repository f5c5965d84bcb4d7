"""Secure type conversion (``convert``) on the port, against the JAX
package.

A JAX ``SimRuntime(3)`` and the port's take the same inputs, from the
same randomness state (``load_state``; the JAX shares moved to jax
arrays, so both take the fused rounds):

* from secure integers (to a wide prime field of 7 limbs, to SecFxp(32),
  to SecInt(16); numbers, lists of numbers, arrays, a list of arrays)
  the masks are one PRSS draw of values below a power of two, each
  field's device stream: the converted shares equal the JAX package's
  bit for bit, and the opened values Python's;
* from a secure field (through the host PRF stream
  ``DevicePRF.host_integers``, then a reduction mod its order, ``_mod``)
  and from fixed point with a truncation, whose zero tests and random
  bits the JAX package draws on its host plane, by opened values, as
  ``tests/test_runtime.py:147-196`` holds them;
* ``_embed_field_values`` and ``host_integers`` equal the JAX package's.

Tolerance: exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu import thresha as jthresha
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import sectypes, thresha
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

WIDE = dict(min_order=1 << 220, signed=True)     # a 7-limb field


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
    """A JAX SimRuntime(3), wired into the JAX package's type layer (its
    own runtime wired back after)."""
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
    """A port runtime continuing from the JAX runtime's randomness."""
    jr._fused_state()
    jr._rng._pool = jr._rng._byte_pool = None
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.asarray(
        jr._fused_ctr if jr._fused_ctr is not None else np.zeros(2)),
        jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
        pc=jr._program_counter[0])
    return tr


def _same(jx, tx):
    np.testing.assert_array_equal(limbs_to_numpy(tx.share.data),
                                  np.asarray(jx.share.data))


def _on_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


def _types(rt, name):
    return {'SecFld7': lambda: rt.SecFld(**WIDE),
            'SecFxp32': lambda: rt.SecFxp(32),
            'SecInt16': lambda: rt.SecInt(16)}[name]()


V = np.array([5, -7, 1234, 0, -1], dtype=object)


@pytest.mark.parametrize('target', ['SecFld7', 'SecFxp32', 'SecInt16'])
@pytest.mark.parametrize('form', ['numbers', 'array', 'arrays'])
def test_convert_from_secure_integers_bit_identical(jr, target, form):
    """SecInt(32) values to each target as a list of numbers, one array
    (2 x 2 and 5) and a list of arrays: the JAX package's shares, the
    program counter after, and the values."""
    tr = _port(jr)
    ji, ti = jr.SecInt(32), tr.SecInt(32)
    jt, tt = _types(jr, target), _types(tr, target)
    assert jt.field.modulus == tt.field.modulus
    if target == 'SecFld7':
        assert tt.field.array.ctx.L == 7
    ja = _on_device(jr.input(ji.array(V), senders=0))
    ta = tr.input(ti.array(V), senders=0)
    if form == 'numbers':
        jx, tx = jr.np_tolist(ja), tr.np_tolist(ta)
    elif form == 'array':
        jx, tx = ja, ta
    else:
        jb = _on_device(jr.input(ji.array(V[:4].reshape(2, 2)), senders=1))
        tb = tr.input(ti.array(V[:4].reshape(2, 2)), senders=1)
        jx, tx = [jb, ja], [tb, ta]
    jc, tc = jr.convert(jx, jt), tr.convert(tx, tt)
    jc = jc if isinstance(jc, list) else [jc]
    tc = tc if isinstance(tc, list) else [tc]
    for a, b in zip(jc, tc):
        _same(a, b)
        assert tuple(getattr(a, 'shape', ())) == tuple(b.shape)
    assert tr._program_counter[0] == jr._program_counter[0]
    got = [v for x in tc for v in _flat(tr, x)]
    assert got == (list(V[:4]) + list(V) if form == 'arrays' else list(V))


def _flat(rt, x):
    """The opened values of a port secure number or array, flat."""
    y = rt.output(x)
    if hasattr(y, 'signed'):                # a field array
        return [int(v) for v in np.asarray(y.signed()).reshape(-1)]
    if isinstance(y, np.ndarray):
        return [float(v) for v in y.reshape(-1)]
    return [float(y) if isinstance(y, float) else int(y)]


@pytest.mark.parametrize('case', ['fxp->int', 'fld->int', 'fld->int arrays',
                                  'fld->fld7', 'fxp32->fxp16'])
def test_convert_by_opened_values(jr, case):
    """Conversions that truncate (fixed point with more fractional bits
    than the target) or reduce mod a field's order (from a secure field,
    through a secure integer type between two fields): the opened values
    equal the JAX package's and Python's."""
    tr = _port(jr)
    if case == 'fxp->int':
        jx = jr.input(jr.SecFxp(32).array(np.array([-42.0, 7.0, 3.0])))[0]
        tx = tr.input(tr.SecFxp(32).array(np.array([-42.0, 7.0, 3.0])))[0]
        jy, ty = jr.convert(jx, jr.SecInt(32)), tr.convert(tx, tr.SecInt(32))
        want = [-42, 7, 3]
    elif case.startswith('fld->int'):
        vals = np.array([[0, 1], [100, 256]], dtype=object)
        jf, tf = jr.SecFld(257), tr.SecFld(257)
        if case == 'fld->int':
            jx = [jr.input(jf(200))[0], jr.input(jf(3))[0]]
            tx = [tr.input(tf(200))[0], tr.input(tf(3))[0]]
            want = [200, 3]
        else:
            jx = jr.input(jf.array(vals))[0]
            tx = tr.input(tf.array(vals))[0]
            want = [0, 1, 100, 256]
        jy, ty = jr.convert(jx, jr.SecInt(32)), tr.convert(tx, tr.SecInt(32))
    elif case == 'fld->fld7':
        jf, tf = jr.SecFld(1031), tr.SecFld(1031)
        jx = [jr.input(jf(v))[0] for v in (3, 1000, 0)]
        tx = [tr.input(tf(v))[0] for v in (3, 1000, 0)]
        jy, ty = jr.convert(jx, jr.SecFld(**WIDE)), tr.convert(
            tx, tr.SecFld(**WIDE))
        want = [3, 1000, 0]
    else:
        v = np.array([1.5, -2.25])
        jx = jr.input(jr.SecFxp(32).array(v))[0]
        tx = tr.input(tr.SecFxp(32).array(v))[0]
        jy, ty = jr.convert(jx, jr.SecFxp(16)), tr.convert(tx, tr.SecFxp(16))
        assert isinstance(ty, sectypes.SecureFixedPointArray)
        want = [1.5, -2.25]

    def opened(rt, y):
        if isinstance(y, list):
            return [float(int(rt.output(a))) for a in y]
        return [float(a) for a in np.asarray(rt.output(y)).reshape(-1)]
    assert opened(tr, ty) == opened(jr, jy) == [float(w) for w in want]


def test_embed_field_values_equal_the_jax_packages(jr):
    """A public array of a two-limb field embedded into a seven-limb one
    and back (``_embed_field_values``): the JAX package's limbs."""
    tr = TorchSim(3, device='cpu')
    ti, tf = tr.SecInt(32), tr.SecFld(**WIDE)
    ji, jf = jr.SecInt(32), jr.SecFld(**WIDE)
    v = np.array([0, 1, 12345, ti.field.modulus - 1], dtype=object)
    for (js, jt), (ts, tt) in (((ji, jf), (ti, tf)), ((jf, ji), (tf, ti))):
        c_t = ts.field.array(v % ts.field.modulus, 'cpu')
        c_j = js.field.array(v % js.field.modulus)
        got = tr._embed_field_values(c_t, tt.field)
        want = jr._embed_field_values(c_j, jt.field)
        np.testing.assert_array_equal(limbs_to_numpy(got.data),
                                      np.asarray(want.data))


@pytest.mark.parametrize('bound', [257, 1 << 61, (1 << 127) - 1])
def test_host_integers_equal_the_jax_packages(bound):
    """DevicePRF.host_integers: the JAX package's integers for the same
    key, input and bound."""
    key, s = bytes(range(16)), (42).to_bytes(8, 'little')
    got = thresha.DevicePRF(key, bound).host_integers(s, (37,))
    want = jthresha.DevicePRF(key, bound).host_integers(s, (37,))
    assert list(got) == list(want)
    assert all(0 <= int(v) < bound for v in got)
