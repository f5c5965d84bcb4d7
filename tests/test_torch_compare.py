"""Secure comparison on the port's co-located plane, at full width.

``SimRuntime(3, device='cpu')`` at SecInt(32) (its 64-bit field, l = 32,
k = 30): every comparison of the port's surface, the BNN sign and the six
operators are opened and compared with the plaintext, on about 100 values
with planted equal pairs and the ends of the range (a - b must fit 32
bits: values in [-2^30, 2^30)). On the CPU each comparison is the plain
version of kernel K5.

Bit for bit against the JAX package, where its XLA comparison step
compiles in seconds (l = 4): the step alone on SecInt(32)'s field, and
the runtime's np_sgn after an np_multiply with both runtimes' randomness
state loaded (load_state), which shows that padding, state and the shared
call counter match.

Tolerance: exact equality (integers; bit patterns of Montgomery limbs)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops import limb as tlimb
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


P = 18446744073709551427   # SecInt(32)'s field
N = 100
HALF = 1 << 30


@functools.cache
def _jax_sgn_step(l):
    return jpipe.make_sgn_step(P, 1, 3, l, 30)


@pytest.fixture(scope='module')
def rt():
    r = TorchSim(3, device='cpu')
    r.start()
    yield r
    r.shutdown()


@pytest.fixture(scope='module')
def inputs(rt):
    gen = np.random.default_rng(11)
    a = gen.integers(-HALF, HALF, N)
    b = gen.integers(-HALF, HALF, N)
    b[::8] = a[::8]                                   # planted equal pairs
    a[:5] = [-HALF, HALF - 1, -HALF, HALF - 1, 0]     # the range ends
    b[:5] = [HALF - 1, -HALF, -HALF, HALF - 1, 0]
    secint = rt.SecInt(32)
    A = rt.input(secint.array(a))[0]
    B = rt.input(secint.array(b))[1]
    return a, b, A, B


CASES = {
    'np_less': (lambda rt, A, B: rt.np_less(A, B), lambda a, b: a < b),
    'np_equal': (lambda rt, A, B: rt.np_equal(A, B), lambda a, b: a == b),
    'np_sgn': (lambda rt, A, B: rt.np_sgn(A - B), lambda a, b: np.sign(a - b)),
    'np_minimum': (lambda rt, A, B: rt.np_minimum(A, B), np.minimum),
    'np_maximum': (lambda rt, A, B: rt.np_maximum(A, B), np.maximum),
    'np_absolute': (lambda rt, A, B: rt.np_absolute(A), lambda a, b: abs(a)),
    'bnn_sign': (lambda rt, A, B: rt.np_sgn(A, LT=True) * -2 + 1,
                 lambda a, b: np.where(a < 0, -1, 1)),
    '<': (lambda rt, A, B: A < B, lambda a, b: a < b),
    '<=': (lambda rt, A, B: A <= B, lambda a, b: a <= b),
    '>': (lambda rt, A, B: A > B, lambda a, b: a > b),
    '>=': (lambda rt, A, B: A >= B, lambda a, b: a >= b),
    '==': (lambda rt, A, B: A == B, lambda a, b: a == b),
    '!=': (lambda rt, A, B: A != B, lambda a, b: a != b),
}


@pytest.mark.parametrize('case', list(CASES))
def test_comparison_opens_to_plaintext(rt, inputs, case):
    a, b, A, B = inputs
    secure, plain = CASES[case]
    got = rt.output(secure(rt, A, B))
    assert got.dtype == np.int64 and got.shape == (N,)
    np.testing.assert_array_equal(got, np.asarray(plain(a, b), np.int64))


LOCAL = {
    'add': (lambda A, B: A + B, lambda a, b: a + b),
    'sub': (lambda A, B: A - B, lambda a, b: a - b),
    'neg': (lambda A, B: -A, lambda a, b: -a),
    'int - x': (lambda A, B: 7 - A, lambda a, b: 7 - a),
    'int + x': (lambda A, B: 7 + B, lambda a, b: 7 + b),
    'x + array': (lambda A, B: A + np.arange(N), lambda a, b: a + np.arange(N)),
}


@pytest.mark.parametrize('case', list(LOCAL))
def test_local_arithmetic_opens_to_plaintext(rt, inputs, case):
    a, b, A, B = inputs
    ctr = rt._fused_ctr.copy()
    secure, plain = LOCAL[case]
    np.testing.assert_array_equal(rt.output(secure(A, B)), plain(a, b))
    np.testing.assert_array_equal(rt._fused_ctr, ctr)   # no protocol round


def test_mul_by_public_operand_is_a_local_scale(rt, inputs):
    """An int, an integer array, a secure array not yet input, and a row
    that broadcasts: each scales the shares locally, with no reshare."""
    a, b, A, _ = inputs
    secint = rt.SecInt(32)
    ctr = rt._fused_ctr.copy()
    c = np.arange(N) - 50
    assert list(rt.output(rt.mul(A, -3))) == list(-3 * a)
    assert list(rt.output(5 * A)) == list(5 * a)
    assert list(rt.output(rt.np_multiply(A, c))) == list(a * c)
    assert list(rt.output(rt.mul(secint.array(c), A))) == list(a * c)
    rows = rt.input(secint.array(np.arange(6).reshape(2, 3)))[0]
    got = rt.output(rt.mul(rows, np.array([1, -2, 3])))
    np.testing.assert_array_equal(got, np.arange(6).reshape(2, 3) * [1, -2, 3])
    np.testing.assert_array_equal(rt._fused_ctr, ctr)


def test_equal_of_wide_integers_is_not_ported(rt):
    """SecInt(l) with l / 2 > k takes the [NO07] zero test, as in the JAX
    package (the port refused it until it had one): equal and unequal
    values, opened against the plaintext. A width past the field still
    raises NotImplementedError, naming the JAX package's eager np_sgn,
    which is not ported."""
    s64 = rt.SecInt(64)
    X = rt.input(s64.array(np.arange(4)))[0]
    Y = rt.input(s64.array(np.array([0, 5, 2, -3])))[0]
    assert list(rt.output(rt.np_equal(X, X))) == [1, 1, 1, 1]
    assert list(rt.output(rt.np_equal(X, Y))) == [1, 0, 1, 0]
    with pytest.raises(NotImplementedError,
                       match='l \\+ k \\+ 2.*eager np_sgn'):
        rt.np_sgn(rt.input(rt.SecInt(32).array(np.arange(4)))[0], l=40)


def _state():
    hi, lo = jkeccak._absorb_host(bytes(range(1, 33)) + bytes(8))
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


def test_sgn_step_on_the_64_bit_field_matches_jax():
    """(b) SecInt(32)'s field, l = 4, k = 30, sgn mode, n = 128 (the shape
    of the runtime check below, so the JAX step compiles once)."""
    ctx = prime_field_ctx(P)
    gen = np.random.default_rng(12)
    v = gen.integers(-8, 8, 128)
    coef = [int(c) for c in gen.integers(0, 1 << 62, 128)]
    a = tlimb.ints_to_limbs(np.array(
        [[(int(x) + c * j) % P * ctx.R % P for x, c in zip(v, coef)]
         for j in (1, 2, 3)], dtype=object), 2)
    st = _state()
    ctr = np.array([3, 1], np.uint32)
    jout, jctr = _jax_sgn_step(4)(jnp.asarray(a), jnp.asarray(st),
                                  jnp.asarray(ctr))
    tout, tctr = tpipe.make_sgn_step(P, 1, 3, 4, 30)(
        limbs_from_numpy(a, 'cpu'), tkeccak.state_tensor(st, 'cpu'), ctr)
    np.testing.assert_array_equal(limbs_to_numpy(tout), np.asarray(jout))
    np.testing.assert_array_equal(tctr, np.asarray(jctr))


def test_runtime_sgn_matches_jax_step_bit_for_bit(monkeypatch):
    """After an np_multiply, the port's np_sgn(x, l=4) equals the JAX
    step run on the same bucket-padded shares with the JAX runtime's fused
    state and counter (both runtimes loaded with one randomness state)."""
    monkeypatch.setenv('MPYC_TPU_CACHE', '0')
    old = jsectypes.runtime   # wired back after: other test files use it
    jr = JaxSim(3, _Options())
    jr._wire_modules()
    try:
        _runtime_sgn_matches_jax_step(jr)
    finally:
        if old is not None:
            old._wire_modules()


def _runtime_sgn_matches_jax_step(jr):
    jr.start()
    tr = TorchSim(3, device='cpu')
    tr.start()
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce)
    js, ts = jr.SecInt(32), tr.SecInt(32)
    gen = np.random.default_rng(13)
    x = gen.integers(-2, 3, N)
    y = gen.integers(-2, 3, N)
    JX, JY = (jr.input(js.array(v.astype(object)))[0] for v in (x, y))
    for J in (JX, JY):                     # the device path, as on a TPU
        J.share = J.share.from_data(jnp.asarray(J.share.data))
    TX, TY = (tr.input(ts.array(v))[0] for v in (x, y))
    JZ, TZ = jr.np_multiply(JX, JY), tr.np_multiply(TX, TY)
    np.testing.assert_array_equal(limbs_to_numpy(TZ.share.data),
                                  np.asarray(JZ.share.data))

    TS = tr.np_sgn(TZ, l=4)
    pad = jnp.concatenate([jnp.asarray(JZ.share.data),
                           jnp.zeros((3, 128 - N, 2), jnp.uint32)], axis=1)
    jout, jctr = _jax_sgn_step(4)(pad, jr._fused_state(), jr._fused_ctr)
    np.testing.assert_array_equal(limbs_to_numpy(TS.share.data),
                                  np.asarray(jout)[:, :N])
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jctr))
    assert tr._fused_ctr.tolist() == [2, 0]
    np.testing.assert_array_equal(tr.output(TS), np.sign(x * y))
    jr.shutdown()
    tr.shutdown()


def _jax_bucket(n, chunk):
    """mpyc_tpu/parallel/simulator.py:516-523, the CPU branch."""
    n_pad, growth = 64, 2
    while n_pad < n:
        n_pad *= growth
    return min(n_pad, chunk)


def test_bucket_and_chunk_rule(monkeypatch):
    """Chunks of _SGN_CHUNK elements (the JAX package's 2^20), each one
    step call on its bucket-padded shares that advances the counter; shown
    here with the chunk lowered to 128."""
    assert TorchSim._SGN_CHUNK == JaxSim._SGN_CHUNK == 1 << 20
    seen = []
    real = tpipe.sgn_step

    def spy(a, state, nonce, spec):
        seen.append((a.shape[1], nonce))
        return real(a, state, nonce, spec)
    monkeypatch.setattr(tpipe, 'sgn_step', spy)
    monkeypatch.setattr(TorchSim, '_SGN_CHUNK', 128)
    rt = TorchSim(3, device='cpu')
    secint = rt.SecInt(32)
    for n in (1, 64, 65, 300):
        v = np.arange(n) - n // 2
        seen.clear()
        ctr = int(rt._fused_ctr[0])
        Z = rt.np_sgn(rt.input(secint.array(v))[0])
        chunks = [min(128, n - j0) for j0 in range(0, n, 128)]
        assert [s for s, _ in seen] == [_jax_bucket(c, 128) for c in chunks]
        assert [c for (_, (c, _)) in seen] == \
            list(range(ctr, ctr + len(chunks)))
        np.testing.assert_array_equal(rt.output(Z), np.sign(v))


@pytest.mark.parametrize('l', [16, 23, 30, 37])
def test_three_limb_comparison_at_the_cnn_widths(l):
    """SecInt(37) (the CNN's 69-bit field) with its bit length set to each
    width the CNN compares at: np_less, a >= b and ReLU's (x >= 0) * x
    opened against the plaintext, a - b within [-2^l, 2^l) and the ends
    of the range planted."""
    rt = TorchSim(3, device='cpu')
    secint = rt.SecInt(37)
    assert secint.field.modulus.bit_length() == 69
    gen = np.random.default_rng(l)
    half = 1 << (l - 1)
    a = gen.integers(-half, half, N)
    b = gen.integers(-half, half, N)
    b[::8] = a[::8]
    a[:4] = [-half, half - 1, -half, half - 1]
    b[:4] = [half - 1, -half, -half, half - 1]
    A = rt.input(secint.array(a))[0]
    B = rt.input(secint.array(b))[1]
    secint.bit_length = l
    try:
        np.testing.assert_array_equal(rt.output(rt.np_less(A, B)), a < b)
        np.testing.assert_array_equal(rt.output(A >= B), a >= b)
        np.testing.assert_array_equal(rt.output((A >= 0) * A),
                                      np.maximum(a, 0))
    finally:
        secint.bit_length = 37


@pytest.mark.parametrize('case', ['np_less', 'np_sgn'])
def test_wide_field_comparison_chunks_at_1024(case):
    """SecInt(64) (a three-limb field) at n = 1,100: cut into chunks of
    1024 and 76 as the JAX package cuts them (simulator.py:475), so the
    call counter advances by two steps; every output opened."""
    rt = TorchSim(3, device='cpu')
    s64 = rt.SecInt(64)
    gen = np.random.default_rng(14)
    n = 1100
    a = gen.integers(-(1 << 62), 1 << 62, n)
    b = gen.integers(-(1 << 62), 1 << 62, n)
    b[::9] = a[::9]
    A = rt.input(s64.array(a))[0]
    B = rt.input(s64.array(b))[1]
    ctr = int(rt._fused_ctr[0])
    if case == 'np_less':
        got, want = rt.output(rt.np_less(A, B)), a < b
    else:
        got, want = rt.output(rt.np_sgn(A - B)), np.sign(a - b)
    assert int(rt._fused_ctr[0]) == ctr + 2
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))


@pytest.mark.parametrize('bits,l,n', [(32, 32, 300), (37, 16, 3 * 128 + 37),
                                      (37, 37, 2 * 128), (37, 23, 50)])
def test_batched_plain_chunks_equal_a_call_per_chunk(bits, l, n):
    """``_sgn_chunks_plain`` (the full chunks as one vmapped batch, the
    reference a K5 launch of many chunks is held against on the card)
    equals ``sgn_chunks`` on the CPU, one plain call per chunk: chunks of
    128 with a ragged tail, all full, and one short chunk, the counter
    carried into its high word; outputs and counters bit for bit."""
    p = TorchSim(3, device='cpu').SecInt(bits).field.modulus
    L = prime_field_ctx(p).L
    spec = tpipe.SgnSpec(p, 1, 3, l, 30, LT=l != 32)
    gen = np.random.default_rng(n)
    words = gen.integers(0, 1 << 32, (3, n, L), dtype=np.uint64)
    words[..., -1] = gen.integers(0, p >> 32 * (L - 1), (3, n))
    a = limbs_from_numpy(words, 'cpu')
    st = tkeccak.state_tensor(tkeccak._absorb_host(bytes(range(40))), 'cpu')
    ctr = (0xFFFFFFFE, 6)
    want, want_ctr = tpipe.sgn_chunks(a, st, ctr, spec, 128)
    got, got_ctr = tpipe._sgn_chunks_plain(a, st, ctr, spec, 128)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got_ctr, want_ctr)
    v = (ctr[0] | ctr[1] << 32) + -(-n // 128)
    np.testing.assert_array_equal(want_ctr, [v & 0xFFFFFFFF, v >> 32])
