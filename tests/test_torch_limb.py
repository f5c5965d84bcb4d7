"""Port's limb arithmetic (mpyc_tpu_torch.ops.limb, fieldops) against the
JAX package's (mpyc_tpu.ops.limb), on the same seeded inputs.

Tolerance: exact equality (integer arithmetic, canonical results)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu.ops import limb as jlimb
from mpyc_tpu.ops.fieldops import prime_field_ctx as jctx
from mpyc_tpu_torch.ops import limb as tlimb
from mpyc_tpu_torch.ops.fieldops import (limbs_from_numpy, limbs_to_numpy,
                                         prime_field_ctx as tctx)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# SecInt(32)'s 64-bit field, a one-limb and a three-limb prime, the LP
# solver's four- and five-limb fields (SecInt(70), SecInt(110)) and
# SecFxp(96)'s six-limb one
PRIMES = [18446744073709551427, 4294967291, (1 << 89) - 1,
          2535301200456458802993406413211,
          2787593149816327892691964784081045188544327,
          95780971304118053647396689196894323976171195136474903]
N = 512


def _rand_field(p, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), 'little') % p for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    return vals


def _rand_wide(L, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, shape + (L,), dtype=np.uint64) \
        .astype(np.uint32)


@functools.cache
def _jax_op(name, p, n_chunks=0):
    c = jctx(p)
    L = c.L
    if name == 'reduce_wide':
        radix = [jlimb.int_to_limbs(pow(2, 32 * L * i, p) * c.R2 % p, L)
                 for i in range(n_chunks)]

        def f(w):
            chunks = [jlimb.unstack(w[:, i, :], L) for i in range(n_chunks)]
            return jlimb.stack(jlimb.reduce_wide(chunks, radix, c.p_limbs,
                                                 c.n0inv))
        return jax.jit(f)
    if name == 'neg_mod':
        return jax.jit(lambda a: jlimb.stack(
            jlimb.neg_mod(jlimb.unstack(a, L), c.p_limbs)))
    fn = getattr(jlimb, name)
    if name == 'mont_mul':
        return jax.jit(lambda a, b: jlimb.stack(fn(
            jlimb.unstack(a, L), jlimb.unstack(b, L), c.p_limbs, c.n0inv)))
    return jax.jit(lambda a, b: jlimb.stack(fn(
        jlimb.unstack(a, L), jlimb.unstack(b, L), c.p_limbs)))


def _torch_op(name, p):
    c = tctx(p)
    if name == 'mont_mul':
        return lambda a, b: tlimb.stack(tlimb.mont_mul(
            tlimb.unstack(a), tlimb.unstack(b), c.p_limbs, c.n0inv))
    if name == 'neg_mod':
        return lambda a: tlimb.stack(tlimb.neg_mod(tlimb.unstack(a),
                                                   c.p_limbs))
    fn = getattr(tlimb, name)
    return lambda a, b: tlimb.stack(fn(tlimb.unstack(a), tlimb.unstack(b),
                                       c.p_limbs))


@pytest.mark.parametrize('p', PRIMES)
@pytest.mark.parametrize('name', ['mont_mul', 'add_mod', 'sub_mod',
                                  'neg_mod'])
def test_elementwise_matches_jax(name, p):
    L = jctx(p).L
    a = jlimb.ints_to_limbs(np.array(_rand_field(p, N, 1), object), L)
    b = jlimb.ints_to_limbs(np.array(_rand_field(p, N, 2), object), L)
    args = (a,) if name == 'neg_mod' else (a, b)
    want = np.asarray(_jax_op(name, p)(*map(jnp.asarray, args)))
    got = _torch_op(name, p)(*(limbs_from_numpy(x, 'cpu') for x in args))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize('p', PRIMES)
@pytest.mark.parametrize('n_chunks', [2, 3])
def test_reduce_wide_matches_jax(p, n_chunks):
    """Wide values (chunks may exceed p) -> Montgomery form of value mod p."""
    L = jctx(p).L
    w = _rand_wide(L, (N, n_chunks), 3)
    want = np.asarray(_jax_op('reduce_wide', p, n_chunks)(jnp.asarray(w)))
    got = tctx(p).reduce_chunks(limbs_from_numpy(w, 'cpu'))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    vals = jlimb.limbs_to_ints(w)
    for i in range(0, N, 61):
        value = sum(int(vals[i, c]) << (32 * L * c) for c in range(n_chunks))
        assert int(tctx(p).decode(got[i:i + 1])[0]) == value % p


@pytest.mark.parametrize('p', PRIMES)
@pytest.mark.parametrize('kind', ['int64', 'uint64', 'object'])
def test_encode_decode_matches_jax(p, kind):
    """Encoding public values (no Python loop for numeric arrays) gives the
    JAX package's Montgomery limbs; decoding gives the values mod p."""
    rng = np.random.default_rng(4)
    if kind == 'int64':
        xs = rng.integers(-(1 << 63), (1 << 63) - 1, N, dtype=np.int64)
        xs[:3] = [-(1 << 63), -1, (1 << 63) - 1]
    elif kind == 'uint64':
        xs = rng.integers(0, (1 << 64) - 1, N, dtype=np.uint64)
        xs[:2] = [0, (1 << 64) - 1]
    else:
        xs = np.array([int(v) * 7 ** 30 for v in range(-N // 2, N // 2)],
                      dtype=object)
    want = jctx(p).encode_ints(xs.astype(object))
    got = tctx(p).encode(xs, 'cpu')
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    dec = tctx(p).decode(got)
    assert [int(v) for v in dec] == [int(v) % p for v in xs.astype(object)]


def test_mul32_is_exact_at_the_extremes():
    a = torch.tensor([0, 1, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000, 12345],
                     dtype=torch.int64)
    b = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 1, 0x80000000,
                      0xDEADBEEF], dtype=torch.int64)
    lo, hi = tlimb.mul32(a, b)
    for x, y, l_, h in zip(a.tolist(), b.tolist(), lo.tolist(), hi.tolist()):
        assert (h << 32) | l_ == x * y


@pytest.mark.parametrize('p', PRIMES)
def test_is_zero_matches_jax(p):
    """limb.iszero_ll (K5's blinded zero test, csrc/limb.cuh is_zero)."""
    L = jctx(p).L
    vals = _rand_field(p, N, 5)
    vals[4:10] = [0, 0, (1 << 32) % p, p - 1, 0, 1 << (32 * (L - 1))]
    a = jlimb.ints_to_limbs(np.array(vals, object), L)
    want = np.asarray(jax.jit(lambda x: jlimb.iszero_ll(
        jlimb.unstack(x, L)))(jnp.asarray(a)))
    got = tctx(p).is_zero(limbs_from_numpy(a, 'cpu'))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().tolist() == [v == 0 for v in vals]


@pytest.mark.parametrize('p', PRIMES)
def test_public_constant_operands(p):
    """add/sub with a constant's Montgomery limbs on either side, neg."""
    c = tctx(p)
    vals = _rand_field(p, N, 6)
    data = c.encode(np.array(vals, object), 'cpu')
    k = p - 5
    kc = c.encode_const(k)

    def ints(t):
        return [int(v) for v in c.decode(t)]
    assert ints(c.add(data, kc)) == [(v + k) % p for v in vals]
    assert ints(c.sub(data, kc)) == [(v - k) % p for v in vals]
    assert ints(c.sub(kc, data)) == [(k - v) % p for v in vals]
    assert ints(c.neg(data)) == [(-v) % p for v in vals]
    assert ints(c.add(kc, data)) == ints(c.add(data, kc))

