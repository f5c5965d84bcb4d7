"""Prime-field bits, the Newton reciprocal, unit vectors and the list
operations on the port, share for share against the JAX package.

A JAX ``SimRuntime(3)`` and the port's, the port loaded with the JAX
runtime's randomness (fused reshare key and counter, input generator,
PRSS keys and program counter: ``load_state``), take the same inputs and
give the same shares bit for bit, and end with the same counters:

* ``np_to_bits`` over prime fields (``mpyc_tpu/runtime.py:3279``): of
  SecInt(16) arrays with negative values, at the type's width and below
  it (l = 8); of SecFxp(24) arrays (bits times 2^f), of an integral one
  (shifted down by f, its f low bits 0) and of one whose f >= l (all
  zero); of a secure number; and ``to_bits`` of a number;
* ``_prefix_mul_raw``, ``_norm``, ``_rec``, and ``div`` by a secure
  fixed-point array and number (array / array, array / number, number /
  number, 1 / number);
* ``np_unit_vector`` of SecInt and SecFxp registers at n = 4, 5 and 7
  (for n not a power of two a random draw is rejected when its slot
  overflows: the opened bits agree, and so do the draws);
* ``input_each``, ``sum``, ``scalar_mul`` and ``if_else`` on numbers
  and lists of numbers.

The JAX package keeps small arrays on its CPU host plane, where its
reshare draws from its input generator; here its reshares take its
device plane's fused round (the one its TPU takes, and the port's), so
that the streams agree. ``max`` compares, which the JAX package's CPU
plane does eagerly with PRSS draws of its own, so it is held by the
opened value. Each opened result is also checked against plain
arithmetic: the bits of the values, |x v| in [1/2, 1], 1 / x within
2^(4 - f) (times x where x > 1), the quotients within 2^(5 - f) relative,
the unit vector at a mod n.

Tolerance: exact equality of shares and counters.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The port's plain versions on tiny tensors gain nothing from torch's
    threads, and the JAX package's CPU plane keeps its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jr():
    """A JAX SimRuntime(3) (wired into the JAX package's type layer, its
    own runtime wired back after) whose reshares run on its device
    plane."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        rt = JaxSim(3, _Options())
        rt._wire_modules()
        reshare = rt._reshare

        def device(x):
            return x.from_data(jnp.asarray(x.data)) \
                if isinstance(x.data, np.ndarray) else x

        def reshare_on_device(x):
            return reshare([device(v) for v in x] if isinstance(x, list)
                           else device(x))
        mp.setattr(rt, '_reshare', reshare_on_device)
        rt.start()
        try:
            yield rt
        finally:
            rt.shutdown()
            if old is not None:
                old._wire_modules()


def _port(jr):
    """A port runtime continuing from the JAX runtime's randomness, both
    input generators from a clean point (their pools dropped)."""
    jr._fused_state()
    jr._rng._pool = jr._rng._byte_pool = None
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return tr


def _same(j, t):
    """Equal shares (secure objects or field arrays) bit for bit."""
    tj = j.share if hasattr(j, 'share') else j
    tt = t.share if hasattr(t, 'share') else t
    np.testing.assert_array_equal(limbs_to_numpy(tt.data),
                                  np.asarray(tj.data))


def _same_state(jr, tr):
    assert tr._program_counter[0] == jr._program_counter[0]
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))


def _types(jr, tr, kind, l):
    if kind == 'int':
        return jr.SecInt(l), tr.SecInt(l)
    return jr.SecFxp(l), tr.SecFxp(l)


def _inputs(jr, tr, jt, tt, values):
    """values input by party 0 on both runtimes (a secure number for a
    0-d array), shares equal."""
    values = np.asarray(values)
    if values.ndim:
        jx = jr.input(jt.array(values), senders=0)
        tx = tr.input(tt.array(values), senders=0)
    else:
        jx = jr.input(jt(values.item()), senders=0)
        tx = tr.input(tt(values.item()), senders=0)
    _same(jx, tx)
    return jx, tx


VALUES = {
    'int': np.array([0, 1, -1, 13, -200, 32767, -32768, 12345]),
    'fxp': np.array([0.5, -2.25, 3.0, 100.75, -0.001, 1 / 3, 2047.0]),
    'fxp integral': np.array([0.0, 1.0, -1.0, 7.0, -2048.0, 100.0]),
}


@pytest.mark.parametrize('kind,l,bits', [
    ('int', 16, None), ('int', 16, 8), ('fxp', 24, None),
    ('fxp integral', 24, None), ('fxp integral', 24, 12),
    ('fxp number', 24, None)])
def test_np_to_bits_matches_jax(jr, kind, l, bits):
    tr = _port(jr)
    jt, tt = _types(jr, tr, 'int' if kind == 'int' else 'fxp', l)
    values = VALUES['fxp'][3] if kind == 'fxp number' else VALUES[kind]
    jx, tx = _inputs(jr, tr, jt, tt, values)
    jb, tb = jr.np_to_bits(jx, bits), tr.np_to_bits(tx, bits)
    _same(jb, tb)
    _same_state(jr, tr)
    assert tb.integral if kind != 'int' else True
    nb = l if bits is None else bits
    f = 0 if kind == 'int' else l // 2
    got = np.rint(np.asarray(tr.output(tb), dtype=np.float64)).astype(
        np.int64)
    enc = np.rint(np.asarray(values, dtype=np.float64) * 2**f).astype(
        np.int64)
    if kind == 'fxp integral':
        enc = enc >> f << f
        want = (enc[..., None] >> np.arange(nb)) & 1 if f < nb else \
            np.zeros(enc.shape + (nb,), np.int64)
    else:
        want = (enc[..., None] >> np.arange(nb)) & 1
    np.testing.assert_array_equal(got, want)


def test_to_bits_of_a_number_matches_jax(jr):
    tr = _port(jr)
    jt, tt = _types(jr, tr, 'int', 16)
    jx, tx = _inputs(jr, tr, jt, tt, np.array(-1234))
    jb, tb = jr.to_bits(jx), tr.to_bits(tx)
    assert len(jb) == len(tb) == 16
    for a, b in zip(jb, tb):
        _same(a, b)
    _same_state(jr, tr)
    assert [tr.output(b) for b in tb] == \
        [(-1234 >> i) & 1 for i in range(16)]


def test_prefix_mul_raw_matches_jax(jr):
    """Prefix products of 0/1 shares along the last axis, 13 wide (four
    doubling rounds, the last one partial)."""
    tr = _port(jr)
    jt, tt = _types(jr, tr, 'int', 16)
    bits = np.random.default_rng(3).integers(0, 2, (4, 13))
    bits[:, :3] = 1
    jx, tx = _inputs(jr, tr, jt, tt, bits)
    jp = jr._prefix_mul_raw(jr._share(jx))
    tp = tr._prefix_mul_raw(tr._share(tx))
    _same(jp, tp)
    _same_state(jr, tr)
    np.testing.assert_array_equal(tr.output(tp).value.astype(np.int64),
                                  np.cumprod(bits, axis=1))


@pytest.mark.parametrize('shape', ['array', 'number'])
def test_norm_and_reciprocal_match_jax(jr, shape):
    tr = _port(jr)
    jt, tt = _types(jr, tr, 'fxp', 24)
    values = VALUES['fxp'][1:] if shape == 'array' else VALUES['fxp'][3]
    jx, tx = _inputs(jr, tr, jt, tt, values)
    jv, tv = jr._norm(jx), tr._norm(tx)
    _same(jv, tv)
    jc, tc = jr._rec(jx), tr._rec(tx)
    _same(jc, tc)
    _same_state(jr, tr)
    x = np.round(np.asarray(values, dtype=np.float64) * 2**12) / 2**12
    v = np.asarray(tr.output(tv), dtype=np.float64)
    assert np.all((np.abs(x * v) >= 0.5) & (np.abs(x * v) <= 1))
    rec = np.asarray(tr.output(tc), dtype=np.float64)
    assert np.all(np.abs(rec * x - 1) <= 2.0**(4 - 12) * np.maximum(1, x))


@pytest.mark.parametrize('case', ['array/array', 'array/number',
                                  'number/number', '1/number'])
def test_division_by_a_secure_fixed_point_value_matches_jax(jr, case):
    tr = _port(jr)
    jt, tt = _types(jr, tr, 'fxp', 24)
    num = np.array([3.5, -2.25, 0.75, 100.0, 1.0])
    den = np.array([1.5, 4.0, -3.0, 7.0, 0.125])
    if case == 'array/array':
        ja, ta = _inputs(jr, tr, jt, tt, num)
        jb, tb = _inputs(jr, tr, jt, tt, den)
        want = num / den
    elif case == 'array/number':
        ja, ta = _inputs(jr, tr, jt, tt, num)
        jb, tb = _inputs(jr, tr, jt, tt, np.array(-2.5))
        want = num / -2.5
    elif case == 'number/number':
        ja, ta = _inputs(jr, tr, jt, tt, np.array(7.0))
        jb, tb = _inputs(jr, tr, jt, tt, np.array(0.375))
        want = 7.0 / 0.375
    else:
        ja = ta = 1
        jb, tb = _inputs(jr, tr, jt, tt, np.array(-6.0))
        want = -1 / 6
    jq, tq = ja / jb, ta / tb
    _same(jq, tq)
    _same_state(jr, tr)
    got = np.asarray(tr.output(tq), dtype=np.float64)
    assert np.all(np.abs(got - want) <= 2.0**(5 - 12) * np.maximum(
        1, np.abs(want)))


@pytest.mark.parametrize('kind', ['int', 'fxp'])
@pytest.mark.parametrize('n', [4, 5, 7])
def test_np_unit_vector_matches_jax(jr, kind, n):
    tr = _port(jr)
    jt, tt = _types(jr, tr, kind, 16 if kind == 'int' else 24)
    for a in (0, 3, 6):
        jx, tx = _inputs(jr, tr, jt, tt, np.array(a))
        ju, tu = jr.np_unit_vector(jx, n), tr.np_unit_vector(tx, n)
        _same(ju, tu)
        _same_state(jr, tr)
        want = np.zeros(n)
        want[a % n] = 1
        np.testing.assert_array_equal(
            np.asarray(tr.output(tu), dtype=np.float64), want)


def test_list_operations_match_jax(jr):
    """input_each, sum (with a start), scalar_mul, if_else on numbers and
    lists (a public branch among them), and max, on SecInt(32) and
    integral SecFxp(24) numbers (the port resynchronised for each type:
    the JAX package's CPU plane compares with other draws)."""
    for kind, l in (('int', 32), ('fxp', 24)):
        tr = _port(jr)
        jt, tt = _types(jr, tr, kind, l)
        vals = [5, -3, 11]
        jx = jr.input_each(lambda i: jt(vals[i]))
        tx = tr.input_each(lambda i: tt(vals[i]))
        for a, b in zip(jx, tx):
            _same(a, b)
        js, ts = jr.sum(jx, start=2), tr.sum(tx, start=2)
        _same(js, ts)
        assert tr.output(ts) == sum(vals) + 2
        jm, tm = jr.scalar_mul(jx[0], jx[1:]), tr.scalar_mul(tx[0], tx[1:])
        for a, b in zip(jm, tm):
            _same(a, b)
        jc = jr.input(jt(1), senders=1)
        tc = tr.input(tt(1), senders=1)
        jy = jr.if_else(jc, jx, [jx[2], jt(4), jx[0]])
        ty = tr.if_else(tc, tx, [tx[2], tt(4), tx[0]])
        for a, b in zip(jy, ty):
            _same(a, b)
        jz, tz = jr.if_else(1 - jc, jx[0], 9), tr.if_else(1 - tc, tx[0], 9)
        _same(jz, tz)
        _same_state(jr, tr)
        assert [tr.output(v) for v in ty] == vals
        assert tr.output(tz) == 9
        assert tr.output(tr.max(tx)) == jr.output(jr.max(jx)) == 11
        assert tr.output(tr.min(tx)) == -3
