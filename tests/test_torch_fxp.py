"""The fixed-point slice on the port, against the JAX package.

PRSS (pseudorandom secret sharing), random bits and truncation: with the
JAX ``SimRuntime(3)``'s PRSS keys and program counter loaded into the
port's (``load_state``), ``_np_randoms`` (bound None and 2^44),
``np_random_bits`` and ``_trunc_field`` give the same shares bit for bit
and leave the same program counter, at n = 1, 7, 300 and 1000 (the JAX
package draws up to 256 values on the host and more on its device plane;
the port draws up to 256 blocks with hashlib and more with K1's plain
version: the same bits). In GF(23), where r^2 = 0 one time in 23,
``np_random_bits``' rejection loop runs several rounds, with the same
shares and program counter.

Powers: the port's ``limb.mont_pow_const`` (K6's plain version),
``fieldops.pow_const`` and ``sqrt(INV)`` against the JAX package's at two
and three limbs (SecFxp(14, 6)'s 52-bit field, SecInt(37)'s 69-bit one),
e = 0, 1, p - 2, (3p - 5) / 4 and (p + 1) / 4 and exponents it reduces,
on inputs with 0 and 1; ``sqrt(INV)`` over fields with p = 1 mod 4
(the JAX package's Tonelli-Shanks root) at one and two limbs, and
``np_random_bits`` over such fields share for share; ``mod_pow2``. The
program of K6's plan (``fieldops.pow_plan``, a sliding window) with the
plain limb product against the ladders, the JAX package's included, at
named and at exponents drawn from a seeded generator, also on
SecInt(32)'s 64-bit field.

SecFxp(14, 6) arithmetic through the port's operators on the CPU, opened
against numpy: +, -, products (truncated: floor(v / 2^6) or one more, v
the exact product at 2^12), products by integral operands and by public
values (exact, or truncated for a float), ``np_matmul`` with truncation,
<, >=, ``np_where``, ``np_maximum``, ``np_argmax``.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jfinfields
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.ops import fieldops as jfieldops
from mpyc_tpu.ops import limb as jlimb
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import finfields, sectypes
from mpyc_tpu_torch.ops import fieldops, limb
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy, prime_field_ctx
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P52 = 4503599627370323        # SecFxp(14, 6)'s field: two limbs, 3 mod 4
P69 = 590295810358705651619   # SecInt(37)'s field: three limbs, 3 mod 4
P64 = 18446744073709551427    # SecInt(32)'s field: two limbs, 4p > R
F = 6
SIZES = (1, 7, 300, 1000)


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
    """The port continues from the JAX runtime's randomness state."""
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])


def _same(jax_arr, torch_arr):
    np.testing.assert_array_equal(limbs_to_numpy(torch_arr.data),
                                  np.asarray(jax_arr.data))


def test_secfxp_field_is_the_jax_packages():
    field = sectypes.SecFxp(14, F, 'cpu').field
    assert field.modulus == P52 == jsectypes.SecFxp(14, F).field.modulus
    assert prime_field_ctx(P52).L == 2


@pytest.mark.parametrize('bound', [None, 1 << 44])
@pytest.mark.parametrize('n', SIZES)
def test_np_randoms_match_the_jax_package(runtimes, n, bound):
    jr, tr = runtimes
    _sync(jr, tr)
    got = tr._np_randoms(finfields.GF(P52), n, bound)
    want = jr._np_randoms(jfinfields.GF(P52), n, bound)
    assert got.shape == (3, n)
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0]


@pytest.mark.parametrize('n', SIZES)
def test_np_random_bits_match_the_jax_package(runtimes, n):
    jr, tr = runtimes
    _sync(jr, tr)
    pc = jr._program_counter[0]
    got = tr.np_random_bits(finfields.GF(P52), n)
    want = jr.np_random_bits(jfinfields.GF(P52), n)
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0] == pc + 2
    bits = tr.output(got).value
    assert set(bits.tolist()) <= {0, 1}


@pytest.mark.parametrize('n', (300, 1000))
def test_np_random_bits_rejection_rounds_match_the_jax_package(runtimes, n):
    """In GF(23) (a Blum prime) r^2 = 0 one time in 23, so the rejection
    loop runs more rounds (a first round of n = 300 keeps all with
    probability (22/23)^300 < 2e-6): the kept values' gather and
    concatenation and two program-counter values a round, as in the JAX
    package."""
    jr, tr = runtimes
    _sync(jr, tr)
    pc = jr._program_counter[0]
    got = tr.np_random_bits(finfields.GF(23), n)
    want = jr.np_random_bits(jfinfields.GF(23), n)
    _same(want, got)
    rounds = (jr._program_counter[0] - pc) // 2
    assert rounds >= 2
    assert tr._program_counter[0] == jr._program_counter[0]
    bits = tr.output(got).value
    assert set(bits.tolist()) <= {0, 1}


@pytest.mark.parametrize('n', (7, 300))
@pytest.mark.parametrize('p', (13, 101, 257))
def test_np_random_bits_over_p_1_mod_4_match_the_jax_package(runtimes, p,
                                                              n):
    """Over GF(13), GF(101) and GF(257) (p = 1 mod 4) the bits take the
    inverse square root by Tonelli-Shanks: shares, rejection rounds and
    program counter equal the JAX package's, and the bits open to 0 and
    1."""
    jr, tr = runtimes
    _sync(jr, tr)
    got = tr.np_random_bits(finfields.GF(p), n)
    want = jr.np_random_bits(jfinfields.GF(p), n)
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0]
    bits = tr.output(got).value
    assert set(bits.tolist()) <= {0, 1} and len(bits) == n
    signed = tr.output(tr.np_random_bits(finfields.GF(p), n, signed=True))
    assert set(signed.signed().tolist()) <= {-1, 1}


@pytest.mark.parametrize('n', SIZES)
def test_trunc_field_matches_the_jax_package(runtimes, n):
    """The same input shares (a fixed-point product at 2^12, l = 20) give
    the same truncated shares: f n random bits and one bounded draw."""
    jr, tr = runtimes
    g = np.random.default_rng(n)
    x = g.integers(-(1 << 19), 1 << 19, n)
    X = tr._share(tr.input(tr.SecFxp(14, F).array(x / (1 << F)))[0])
    _sync(jr, tr)
    pc = jr._program_counter[0]
    got = tr._trunc_field(X, F, 14 + F)
    want = jr._trunc_field(
        jfinfields.GF(P52).array.from_data(
            jnp.asarray(limbs_to_numpy(X.data))), F, 14 + F,
        jsectypes.SecFxp(14, F))
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0] == pc + 3
    y = tr.output(got).signed()
    assert np.isin(y - np.floor_divide(x, 1 << F), (0, 1)).all()


EXPONENTS = ('0', '1', 'p-2', '(3p-5)/4', '(p+1)/4', '-1', 'p-1', '2p+3')


def _exponent(name, p):
    return {'0': 0, '1': 1, 'p-2': p - 2, '(3p-5)/4': (3 * p - 5) // 4,
            '(p+1)/4': (p + 1) // 4, '-1': -1, 'p-1': p - 1,
            '2p+3': 2 * p + 3}[name]


def _inputs(p, n=40, seed=0):
    """Canonical values with 0, 1 and p - 1 first, then random ones."""
    g = np.random.default_rng(seed)
    vals = [0, 1, p - 1] + [int(v) % p for v in
                            g.integers(0, 1 << 62, n - 3, dtype=np.int64)]
    return np.array(vals, dtype=object)


def _jax_ladder(p, e, data):
    """The JAX package's lax.scan ladder (``mpyc_tpu/ops/limb.py:330``),
    jitted, on the port's limb data."""
    jctx = jfieldops.prime_field_ctx(p)
    ladder = jax.jit(lambda a: jlimb.stack(jlimb.mont_pow_const(
        jlimb.unstack(a, jctx.L), e, jctx.p_limbs, jctx.n0inv,
        jctx.one_mont)))
    return np.asarray(ladder(jnp.asarray(limbs_to_numpy(data))))


@pytest.mark.parametrize('e', EXPONENTS)
@pytest.mark.parametrize('p', [P52, P69])
def test_pow_const_matches_the_jax_package(p, e):
    """fieldops.pow_const against the JAX package's (on the CPU its host
    kernel, whose native modexp refuses e = 0: there its limb ladder)."""
    ctx, jctx = prime_field_ctx(p), jfieldops.prime_field_ctx(p)
    data = ctx.encode(_inputs(p), 'cpu')
    e = _exponent(e, p)
    got = ctx.pow_const(data, e)
    want = _jax_ladder(p, e, data) if e == 0 else np.asarray(
        jctx.pow_const(e)(jnp.asarray(limbs_to_numpy(data))))
    np.testing.assert_array_equal(limbs_to_numpy(got), want)
    ee = e % (p - 1) or p - 1 if not 0 <= e < p - 1 else e
    np.testing.assert_array_equal(
        ctx.decode(got).astype(object),
        [pow(int(v), ee, p) for v in _inputs(p)])


@pytest.mark.parametrize('p', [P52, P69])
def test_mont_pow_const_matches_the_jax_limb_ladder(p):
    """K6's plain version against the JAX package's lax.scan ladder
    (``mpyc_tpu/ops/limb.py:330``) at the Blum inverse-sqrt exponent."""
    ctx = prime_field_ctx(p)
    data = ctx.encode(_inputs(p), 'cpu')
    e = (3 * p - 5) // 4
    got = limb.stack(limb.mont_pow_const(limb.unstack(data), e, ctx.p_limbs,
                                         ctx.n0inv, ctx.one_mont))
    np.testing.assert_array_equal(limbs_to_numpy(got),
                                  _jax_ladder(p, e, data))
    assert fieldops.pow_products(e) == {P52: 99, P69: 132}[p]


def _plan_pow(data, e, ctx):
    """x^e R mod p by the program of e's plan (``fieldops.pow_plan``, as K6
    and K7 run it) with the plain limb product."""
    def mul(a, b):
        return limb.mont_mul(a, b, ctx.p_limbs, ctx.n0inv)
    a = limb.unstack(data)
    if e == 0:
        return limb.stack([torch.full_like(a[0], x) for x in ctx.one_mont])
    plan = fieldops.pow_plan(e)
    table = [a]
    if plan.n_table > 1:
        x2 = mul(a, a)
        for _ in range(plan.n_table - 1):
            table.append(mul(table[-1], x2))
    res = table[plan.first]
    for sq, j in plan.steps:
        for _ in range(sq):
            res = mul(res, res)
        res = mul(res, table[j])
    for _ in range(plan.tail):
        res = mul(res, res)
    return limb.stack(res)


PLAN_EXPONENTS = ('0', '1', '2', '2^k', '2^k-1', 'p-2', '(p-1)/2',
                  '(p+1)/4', '(3p-5)/4')


@pytest.mark.parametrize('e', PLAN_EXPONENTS)
@pytest.mark.parametrize('p', [P52, P64, P69])
def test_pow_plan_matches_the_ladders(p, e):
    """The plan's program equals the port's ladder (K6's plain version),
    the JAX package's jitted lax.scan ladder and Python's pow, in no more
    products than the ladder; 2^k is the largest power of two below
    2^(32 L), 2^k - 1 the largest exponent K6 takes."""
    ctx = prime_field_ctx(p)
    k = 32 * ctx.L
    e = {'0': 0, '1': 1, '2': 2, '2^k': 1 << k - 1, '2^k-1': (1 << k) - 1,
         'p-2': p - 2, '(p-1)/2': (p - 1) // 2, '(p+1)/4': (p + 1) // 4,
         '(3p-5)/4': (3 * p - 5) // 4}[e]
    data = ctx.encode(_inputs(p), 'cpu')
    got = _plan_pow(data, e, ctx)
    assert torch.equal(got, fieldops._mont_pow_plain(data, e, ctx))
    np.testing.assert_array_equal(limbs_to_numpy(got),
                                  _jax_ladder(p, e, data))
    np.testing.assert_array_equal(
        ctx.decode(got).astype(object),
        np.array([pow(int(v), e, p) for v in _inputs(p)], dtype=object))
    assert fieldops.plan_products(e) <= fieldops.pow_products(e)


def test_pow_plan_of_the_inverse_square_root():
    """At SecFxp(14, 6)'s e = (3p - 5) / 4 (52 bits, 49 set) the plan is 4-bit
    windows over a table of x^1..x^15: 8 products to build it, 48
    squarings and 12 products, 68 in all (the ladder's 99)."""
    e = (3 * P52 - 5) // 4
    plan = fieldops.pow_plan(e)
    assert plan.n_table == 8 and len(plan.steps) == 12 and plan.tail == 0
    assert sum(sq for sq, _ in plan.steps) == 48
    assert fieldops.plan_products(e) == 68
    assert fieldops.pow_plan(0) == fieldops.PowPlan(1, 0, (), 0)


@pytest.mark.parametrize('p', [P52, P64, P69])
def test_pow_plan_matches_the_ladder_on_drawn_exponents(p):
    """25 exponents drawn below 2^(32 L), of every bit length: the
    plan's program equals the port's ladder and Python's pow."""
    ctx = prime_field_ctx(p)
    g = np.random.default_rng(p % 1000)
    for _ in range(25):
        e = int.from_bytes(g.bytes(4 * ctx.L), 'little')
        e >>= int(g.integers(0, 32 * ctx.L))
        x = _inputs(p, 8, seed=e % 1000)
        got = _plan_pow(ctx.encode(x, 'cpu'), e, ctx)
        assert torch.equal(got, fieldops._mont_pow_plain(
            ctx.encode(x, 'cpu'), e, ctx))
        np.testing.assert_array_equal(
            ctx.decode(got).astype(object),
            np.array([pow(int(v), e, p) for v in x], dtype=object))
        assert fieldops.plan_products(e) <= fieldops.pow_products(e)


@pytest.mark.parametrize('INV', [False, True])
@pytest.mark.parametrize('p', [P52, P69])
def test_sqrt_matches_the_jax_package(p, INV):
    """Square roots (and inverse ones) of squares; sqrt(0) = 0, and the
    inverse root of an array with a 0 raises."""
    ctx = prime_field_ctx(p)
    field = finfields.GF(p)
    x = _inputs(p)[1:]
    sq = field.array(x * x % p, 'cpu')
    got = sq.sqrt(INV)
    want = jfinfields.GF(p).array(x * x % p).sqrt(INV)
    np.testing.assert_array_equal(limbs_to_numpy(got.data),
                                  np.asarray(want._data))
    r = got.value.astype(object)
    if INV:
        assert ((r * r % p) * (x * x % p) % p == 1).all()
    else:
        assert (r * r % p == x * x % p).all()
    with pytest.raises(ZeroDivisionError):
        field.array(np.array([4, 0], dtype=object), 'cpu').sqrt(INV=True)
    assert field.array(np.array([0], dtype=object), 'cpu').sqrt().value[0] \
        == 0
    assert ctx.any_zero(field.array(_inputs(p), 'cpu').data)


@pytest.mark.parametrize('f', [0, 6, 33])
@pytest.mark.parametrize('p', [P52, P69])
def test_mod_pow2_matches_the_jax_package(p, f):
    if f >= p.bit_length():
        pytest.skip('f beyond the field')
    data = prime_field_ctx(p).encode(_inputs(p), 'cpu')
    got = finfields.GF(p).array.from_data(data).mod_pow2(f)
    want = jfieldops.prime_field_ctx(p).mod_pow2(f)(
        jnp.asarray(limbs_to_numpy(data)))
    np.testing.assert_array_equal(limbs_to_numpy(got.data), np.asarray(want))


# p = 1 mod 4: the Tonelli-Shanks fields, p - 1 = q 2^s with s = 2 (13,
# 101), 5 (97), 8 (257: q = 1) and 32 (2^64 - 2^32 + 1, two limbs)
P64_1 = (1 << 64) - (1 << 32) + 1
TS_PRIMES = (13, 97, 101, 257, P64_1)


def _mont_ints(data) -> list:
    """Montgomery values of (..., L) limbs (numpy or torch) as ints."""
    limbs = np.asarray(data).astype(np.uint64).reshape(-1, np.shape(data)[-1])
    return [sum(int(w) << 32 * q for q, w in enumerate(row))
            for row in limbs]


@pytest.mark.parametrize('INV', [False, True])
@pytest.mark.parametrize('p', TS_PRIMES)
def test_tonelli_shanks_sqrt_matches_the_jax_package(p, INV):
    """For p = 1 mod 4 the port's sqrt (and inverse sqrt) of squares of
    seeded values and of 0 is the JAX package's constant-round
    Tonelli-Shanks root, word for word of its Montgomery form (the JAX
    package keeps the two-limb field's small arrays as ints on its host
    plane: compared as the limbs' integers), and a root."""
    assert p % 4 == 1
    g = np.random.default_rng(p % 997)
    x = np.array([int(v) for v in g.integers(1, min(p, 1 << 62), 24)],
                 dtype=object)
    sq = x * x % p
    if not INV:
        sq = np.concatenate([np.array([0], dtype=object), sq])
    got = finfields.GF(p).array(sq, 'cpu').sqrt(INV)
    want = jfinfields.GF(p).array(sq).sqrt(INV)
    jdata = np.asarray(want._data)
    wants = [int(v) for v in jdata.reshape(-1)] if jdata.dtype == object \
        else _mont_ints(jdata)
    assert _mont_ints(limbs_to_numpy(got.data)) == wants
    r = got.value.astype(object)
    if INV:
        assert ((r * r % p) * sq % p == 1).all()
    else:
        assert (r * r % p == sq).all() and r[0] == 0


def test_shifts_by_powers_of_two():
    field = finfields.GF(P52)
    x = np.array([3, -5, 64 * 7, 0])
    a = field.array(x, 'cpu')
    np.testing.assert_array_equal((a << 6).signed(), x << 6)
    np.testing.assert_array_equal(((a << 6) >> 6).signed(), x)


# -- SecFxp(14, 6) through the operators --------------------------------------

@pytest.fixture(scope='module')
def rt():
    r = TorchSim(3, device='cpu')
    r.start()
    yield r
    r.shutdown()


def _fx(v):
    """Values at 2^6 as int64 (the encoding, v exactly representable)."""
    return np.round(np.asarray(v) * (1 << F)).astype(np.int64)


def _truncated(got, exact):
    """got (opened floats) is exact / 2^6 rounded down or up: floor(v /
    2^6) or one more, v the exact product at 2^12."""
    low = np.floor_divide(exact, 1 << F)
    return np.isin(_fx(got) - low, (0, 1)).all()


def _operands(rt, shape=(6, 7), seed=1):
    g = np.random.default_rng(seed)
    a = _fx(g.uniform(-30, 30, shape)) / (1 << F)
    b = _fx(g.uniform(-30, 30, shape)) / (1 << F)
    b.flat[:3] = a.flat[:3]
    sf = rt.SecFxp(14, F)
    A = rt.input(sf.array(a), senders=0)
    B = rt.input(sf.array(b), senders=1)
    return sf, a, b, A, B


def test_secfxp_add_sub_and_integral_flags(rt):
    sf, a, b, A, B = _operands(rt)
    assert not A.integral and not B.integral
    np.testing.assert_array_equal(rt.output(A + B), a + b)
    np.testing.assert_array_equal(rt.output(A - B), a - b)
    np.testing.assert_array_equal(rt.output(-A + 2.5), 2.5 - a)
    with pytest.raises(TypeError, match='fixed-point'):
        rt.SecInt(14).array(np.array([0.5]))
    assert sf.array(np.arange(3)).integral
    assert sf.array(np.array([1.0, -2.0])).integral
    assert not sf.array(np.array([1.0, 0.5])).integral
    C = A < B
    assert C.integral and (C + 1).integral and not (C + 0.5).integral
    assert rt.np_reshape(C, (-1,)).integral and C[1:, 2].integral


def test_secfxp_products(rt):
    """Secure products truncated; by an integral secure operand, by a
    public int and by a public integral array exact; by a public float
    (array) truncated."""
    sf, a, b, A, B = _operands(rt)
    pc = rt._program_counter[0]
    C = A * B
    assert rt._program_counter[0] == pc + 3 and not C.integral
    assert _truncated(rt.output(C), _fx(a) * _fx(b))
    ints = np.arange(42).reshape(6, 7) - 20
    pc = rt._program_counter[0]
    for got in (A * rt.input(sf.array(ints))[2], A * ints, ints * A,
                A * sf.array(ints)):
        assert got.integral is False
        np.testing.assert_array_equal(rt.output(got), a * ints)
    np.testing.assert_array_equal(rt.output(A * 3), a * 3)
    assert rt._program_counter[0] == pc
    for w in (0.3, np.full((6, 7), -1.7)):
        assert _truncated(rt.output(A * w), _fx(a) * _fx(w))


def test_secfxp_np_matmul_truncates(rt):
    """A secure and a public-valued secure matrix of floats: the product
    at 2^12, one reshare, truncated; by an integral matrix exact."""
    g = np.random.default_rng(2)
    sf = rt.SecFxp(14, F)
    x = _fx(g.uniform(-4, 4, (5, 9))) / (1 << F)
    w = _fx(g.uniform(-1, 1, (9, 4))) / (1 << F)
    X = rt.input(sf.array(x))[0]
    Y = X @ sf.array(w)
    assert Y.shape == (5, 4) and not Y.integral
    assert _truncated(rt.output(Y), _fx(x) @ _fx(w))
    k = g.integers(-3, 4, (9, 4))
    np.testing.assert_array_equal(rt.output(X @ sf.array(k)), x @ k)


def test_secfxp_comparisons_select_and_argmax(rt):
    """<, >= (K5's plain version with the 2^6 scale), np_where,
    np_maximum and np_argmax, opened against numpy."""
    sf, a, b, A, B = _operands(rt)
    np.testing.assert_array_equal(rt.output(A < B), (a < b) * 1.0)
    np.testing.assert_array_equal(rt.output(A >= B), (a >= b) * 1.0)
    np.testing.assert_array_equal(rt.output(rt.np_where(A >= B, A, B)),
                                  np.maximum(a, b))
    np.testing.assert_array_equal(rt.output(rt.np_maximum(A, B)),
                                  np.maximum(a, b))
    np.testing.assert_array_equal(rt.output((A >= 0) * A),
                                  np.maximum(a, 0))
    np.testing.assert_array_equal(rt.output(rt.np_argmax(A, axis=1)),
                                  np.argmax(a, axis=1))


def test_trunc_and_np_trunc(rt):
    """rt.trunc and rt.np_trunc of secure arrays (a list too): floor(x /
    2^f) or one more, one truncation round each."""
    si = rt.SecInt(14)
    x = np.arange(-600, 600, 7)
    X = rt.input(si.array(x))[0]
    pc = rt._program_counter[0]
    for got in (rt.np_trunc(X, 3), *rt.trunc([X, X[:5]], 3)):
        assert np.isin(rt.output(got) - np.floor_divide(x[:got.size], 8),
                       (0, 1)).all()
    assert rt._program_counter[0] == pc + 3 * 3     # a round each array
    sf = rt.SecFxp(14, F)
    Y = rt.input(sf.array(x / 8))[0]
    Z = rt.trunc(Y)
    assert not Z.integral and _truncated(rt.output(Z), _fx(x / 8))


def test_output_with_threshold_and_raw(rt):
    """A secure array opens raw to its field array (the values at 2^6); a
    field array of degree-2t shares (a product of two degree-t sharings,
    no reshare) opens at threshold 2t to the product and not at t."""
    sf, a, b, A, B = _operands(rt)
    raw = rt.output(A, raw=True)
    assert isinstance(raw, finfields.PrimeFieldArray)
    np.testing.assert_array_equal(raw.signed(), _fx(a))
    sa, sb = rt._share(A), rt._share(B)
    prod = sa * sb
    np.testing.assert_array_equal(
        rt.output(prod, threshold=2).signed(), _fx(a) * _fx(b))
    assert not np.array_equal(rt.output(prod).signed(), _fx(a) * _fx(b))


def test_random_bits_of_a_fixed_point_type(rt):
    """Secure random bits of SecFxp(14, 6): 0 or 1, about half ones;
    signed ones -1 or 1."""
    sf = rt.SecFxp(14, F)
    bits = rt.output(rt.np_random_bits(sf, 2000))
    assert set(bits.tolist()) <= {0.0, 1.0}
    assert 800 < bits.sum() < 1200
    pm = rt.output(rt.np_random_bits(sf, 500, signed=True))
    assert set(pm.tolist()) <= {-1.0, 1.0}
    r = rt.output(rt._np_randoms(rt.SecInt(14), 300, 1 << 20))
    assert (r >= 0).all() and (r < 3 * (1 << 18)).all()
