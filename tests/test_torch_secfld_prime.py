"""Secure prime fields SecFld(p) on the port, against the JAX package.

A JAX ``SimRuntime(3)`` and the port's take the same inputs, with the same
randomness state (``load_state``: the fused reshare key and counter, the
input generator's key and nonce, the PRSS keys and program counter; the
JAX generator's pools dropped, so both draw from a new nonce):

* ``SecFld(min_order=10)``, ``SecFld(1031)``, ``SecFld(2^31 - 1)`` and
  ``SecFld(modulus=2^61 - 1)`` resolve to the JAX package's fields (one
  limb for the first three, two for the last), unsigned;
* 300 values input, their product, a power, the zero test of a - b by
  Fermat's little theorem (1 - d^(p - 1)) and the openings equal the JAX
  package's share for share. The JAX package keeps small arrays on its
  CPU host plane, whose products take another reshare stream; the test
  moves its shares to jax arrays, as they are on its TPU, so that its
  SimRuntime takes the fused round the port takes;
* powers by 0 and by -1 (a reciprocal), and random bits, by their opened
  values, also over GF(13), GF(257) and GF(101) (p = 1 mod 4: the
  Tonelli-Shanks root);
* odd extension fields and too-small prime fields raise
  NotImplementedError; the module-level ``sectypes.SecFld`` places its
  arrays on the card by default, so without one it raises the package's
  RuntimeError.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import sectypes
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

FIELDS = {'GF(11)': dict(min_order=10), 'GF(1031)': dict(order=1031),
          'GF(2^31-1)': dict(modulus=(1 << 31) - 1),
          'GF(2^61-1)': dict(modulus=(1 << 61) - 1)}


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
    """A port runtime continuing from the JAX runtime's randomness, both
    input generators from a clean point."""
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


def _values(p, n, seed):
    g = np.random.default_rng(seed)
    return np.array([int(v) for v in g.integers(0, min(p, 1 << 62), n)],
                    dtype=object)


@pytest.mark.parametrize('name', list(FIELDS))
def test_fields_resolve_as_the_jax_package(jr, name):
    tr = TorchSim(3, device='cpu')
    jf, tf = jr.SecFld(**FIELDS[name]), tr.SecFld(**FIELDS[name])
    assert tf.field.modulus == jf.field.modulus
    assert tf.bit_length == jf.bit_length
    assert tf.__name__ == jf.__name__
    assert tf.field.array.ctx.L == (2 if '61' in name else 1)
    assert tf.subfield is None and jf.subfield is None
    assert int(tf.field(tf.field.modulus - 1)) == tf.field.modulus - 1


@pytest.mark.parametrize('name', list(FIELDS))
def test_input_product_power_zero_test_and_output_bit_identical(jr, name):
    """300 values (the first five 0, five equal pairs): input shares, the
    product a b, a^5, the zero test of a - b (Fermat) and the openings
    equal the JAX package's share for share and as values."""
    tr = _port(jr)
    jf, tf = jr.SecFld(**FIELDS[name]), tr.SecFld(**FIELDS[name])
    p = tf.field.modulus
    v, w = _values(p, 300, 1), _values(p, 300, 2)
    v[:5] = 0
    w[3:8] = v[3:8]
    ja = jr.input(jf.array(v), senders=0)
    jb = jr.input(jf.array(w), senders=1)
    ta = tr.input(tf.array(v), senders=0)
    tb = tr.input(tf.array(w), senders=1)
    _same(ja, ta)
    _same(jb, tb)
    _on_device(ja)
    _on_device(jb)
    jc, tc = ja * jb, ta * tb
    _same(jc, tc)
    jp, tp = jr.pow(ja, 5), tr.pow(ta, 5)
    _same(jp, tp)
    jd, td = _on_device(ja - jb), ta - tb
    _same(jd, td)
    je, te = jr.is_zero(jd), tr.is_zero(td)
    _same(je, te)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))
    for jx, tx, want in ((jc, tc, [a * b % p for a, b in zip(v, w)]),
                         (jp, tp, [pow(int(a), 5, p) for a in v]),
                         (je, te, [int(a == b) for a, b in zip(v, w)])):
        got = [int(x) for x in tr.output(tx).value]
        assert got == [int(x) for x in jr.output(jx).value] == want


def test_wide_input_draws_bit_identical(jr):
    """GF(2^31 - 1) at 1,200 values: 20-byte draws past the pool, which
    the JAX package squeezes into the field and the port squeezes (K1 on
    the card) and splits: the same shares."""
    tr = _port(jr)
    jf, tf = jr.SecFld((1 << 31) - 1), tr.SecFld((1 << 31) - 1)
    v = _values(tf.field.modulus, 1200, 3)
    _same(jr.input(jf.array(v), senders=0), tr.input(tf.array(v), senders=0))
    assert tr._rng._nonce == jr._rng._nonce


@pytest.mark.parametrize('name', ['GF(11)', 'GF(1031)', 'GF(2^31-1)'])
def test_powers_by_zero_and_minus_one_and_equality_operators(jr, name):
    """a^0 is 1 and a^-1 the reciprocal (its random r and opened r a: the
    same PRSS draw in both runtimes), ``==`` and ``!=`` of numbers, and
    random bits: opened values equal the JAX package's and Python's."""
    tr = _port(jr)
    jf, tf = jr.SecFld(**FIELDS[name]), tr.SecFld(**FIELDS[name])
    p = tf.field.modulus
    v = [3, 7, p - 1]
    for x in v:
        ja, ta = jr.input(jf(x), senders=0), tr.input(tf(x), senders=0)
        assert int(tr.output(ta ** 0)) == int(jr.output(ja ** 0)) == 1
        inv = int(tr.output(ta ** -1))
        assert inv == int(jr.output(ja ** -1)) == pow(x, -1, p)
        assert int(tr.output(ta == 7)) == int(x == 7)
        assert int(tr.output(ta != 7)) == int(x != 7)
    jbits = jr.random_bits(jf, 8)
    tbits = tr.random_bits(tf, 8)
    got = [int(tr.output(b)) for b in tbits]
    assert got == [int(jr.output(b)) for b in jbits]
    assert set(got) <= {0, 1}


@pytest.mark.parametrize('kw', [dict(order=13), dict(order=257),
                                dict(min_order=100)],
                         ids=['GF(13)', 'GF(257)', 'GF(101)'])
def test_random_bits_over_p_1_mod_4_match_the_jax_package(jr, kw):
    """Over fields with p = 1 mod 4 (``SecFld(min_order=100)`` is GF(101))
    a bit's inverse square root is the JAX package's Tonelli-Shanks root:
    ``random_bits`` and ``random_bit`` open to the JAX package's values,
    each 0 or 1."""
    tr = _port(jr)
    jf, tf = jr.SecFld(**kw), tr.SecFld(**kw)
    p = tf.field.modulus
    assert p == jf.field.modulus and p % 4 == 1
    got = [int(tr.output(b)) for b in tr.random_bits(tf, 24)]
    assert got == [int(jr.output(b)) for b in jr.random_bits(jf, 24)]
    got += [int(tr.output(tr.random_bit(tf))) for _ in range(4)]
    assert got[24:] == [int(jr.output(jr.random_bit(jf))) for _ in range(4)]
    assert set(got) <= {0, 1}


def test_is_zero_public_and_random_values(jr):
    """is_zero_public of SecFld(1031) numbers, and a uniformly random
    element (``_random``), opened: in range."""
    tr = TorchSim(3, device='cpu')
    tf = tr.SecFld(1031)
    assert tr.is_zero_public(tf(5) - tf(5))
    assert not tr.is_zero_public(tr.input(tf(4), senders=0))
    assert 0 <= int(tr.output(tr._random(tf))) < 1031


def test_fields_the_port_does_not_have_raise():
    """GF(p^e) of odd p, and a prime field too small for m = 3 parties at
    t = 1 (its shares would live in GF(p^e)), raise NotImplementedError;
    GF(2) at m = 3 takes its binary extension GF(4) as before."""
    tr = TorchSim(3, device='cpu')
    with pytest.raises(NotImplementedError, match='odd characteristic'):
        tr.SecFld(9)
    with pytest.raises(NotImplementedError, match='odd characteristic'):
        tr.SecFld(char=5, ext_deg=2)
    with pytest.raises(NotImplementedError, match='GF\\(p\\^e\\)'):
        tr.SecFld(3)
    assert int(tr.SecFld(2).field.modulus) == 0b111


def test_module_secfld_defaults_to_the_card():
    """``sectypes.SecFld`` places its arrays on the card unless asked for
    the CPU, as the package's entry points do: without a card it raises
    the package's RuntimeError."""
    assert sectypes.SecFld(11, device='cpu').array.device == 'cpu'
    if torch.cuda.is_available():
        assert sectypes.SecFld(11).array.device.startswith('cuda')
    else:
        with pytest.raises(RuntimeError, match='no card'):
            sectypes.SecFld(11)
