"""Binary fields GF(2^d) on the port, against the JAX package.

``find_irreducible`` and the polynomial arithmetic of ``gfpx`` (a copy in
the port), the field arithmetic of ``ops/binary.py`` (``BinaryFieldCtx``:
XOR sums, carry-less products with their reduction, powers, inverses,
matrix products, the encoding of ints as polynomials) at d = 1, 2, 8 and
32 on seeded numpy inputs, host elements (products, inverses, shifts),
``SecFld(2)`` at m = 3 (its GF(4) modulus and the subfield) and
``SecFld(2^8)``, and ``np.linalg.inv`` of AES's matrices A and C.

Tolerance: exact equality (field elements as ints)."""
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jff
from mpyc_tpu import gfpx as jgfpx
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.ops.binary import binary_field_ctx as jax_ctx
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import finfields, gfpx
from mpyc_tpu_torch.ops.binary import binary_field_ctx
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEGREES = (1, 2, 8, 32)


def _modulus(d):
    """The field modulus the JAX package takes for GF(2^d) (GF(2): x)."""
    return 2 if d == 1 else int(jff.find_irreducible(2, d))


def _tensor(v):
    return torch.from_numpy(np.asarray(v, np.uint32).view(np.int32)
                            .copy())


def _ints(t):
    return t.numpy().view(np.uint32).astype(np.int64)


@pytest.mark.parametrize('d', [1, 2, 3, 8, 12, 32])
def test_find_irreducible(d):
    assert int(finfields.find_irreducible(2, d)) == \
        int(jff.find_irreducible(2, d))


@pytest.mark.parametrize('p', [2, 3, 7])
def test_gfpx_arithmetic(p):
    """Products, divisions with remainder, gcds, inverses, powers and the
    irreducibility test of random polynomials over GF(p)."""
    g = np.random.default_rng(p)
    P, J = gfpx.GFpX(p), jgfpx.GFpX(p)
    for _ in range(40):
        a, b = (int(v) for v in g.integers(1, p ** 9, 2))
        for op in ('__add__', '__sub__', '__mul__', '__floordiv__',
                   '__mod__'):
            assert int(getattr(P(a), op)(P(b))) == \
                int(getattr(J(a), op)(J(b))), (a, b, op)
        assert int(P.gcd(P(a), P(b))) == int(J.gcd(J(a), J(b)))
        assert P.is_irreducible(P(a)) == J.is_irreducible(J(a))
        assert int(P.powmod(P(a), 5, P(b))) == int(J.powmod(J(a), 5, J(b)))
        if int(J.gcd(J(a), J(b))) == 1 and J(b).degree() > 0:
            assert int(P.invert(P(a), P(b))) == int(J.invert(J(a), J(b)))
        assert str(P(a)) == str(J(a))


@pytest.mark.parametrize('d', DEGREES)
def test_binary_field_ops(d):
    """XOR sums, products, powers (1, 2, 254, 2^d - 2 and a negative
    one), inverses and a matrix product, each against the JAX package's
    BinaryFieldCtx on the same seeded elements (the powers on 60 of them:
    the JAX package compiles a power's whole chain, minutes at d = 32)."""
    md = _modulus(d)
    ctx, jc = binary_field_ctx(md), jax_ctx(md)
    assert ctx.d == jc.d == d
    assert ctx.red == [int(r) for r in jc._red]
    g = np.random.default_rng(d)
    a = g.integers(0, 1 << d, 300, dtype=np.uint64).astype(np.uint32)
    b = g.integers(0, 1 << d, 300, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, (1 << d) - 1]
    ta, tb = _tensor(a), _tensor(b)
    np.testing.assert_array_equal(_ints(ctx.add(ta, tb)),
                                  np.asarray(jc.add(a, b)))
    np.testing.assert_array_equal(_ints(ctx.mul(ta, tb)),
                                  np.asarray(jc.mul(a, b)))
    for e in (1, 2, 254, (1 << d) - 2, -3):
        np.testing.assert_array_equal(_ints(ctx.pow_const(ta[:60], e)),
                                      np.asarray(jc.pow_const(e)(a[:60])))
    np.testing.assert_array_equal(_ints(ctx.inv(ta[:60])),
                                  np.asarray(jc.inv(a[:60])))
    A = g.integers(0, 1 << d, (2, 4, 5), dtype=np.uint64).astype(np.uint32)
    B = g.integers(0, 1 << d, (5, 3), dtype=np.uint64).astype(np.uint32)
    got = ctx.matmul(_tensor(A).unsqueeze(-1), _tensor(B).unsqueeze(-1))
    np.testing.assert_array_equal(_ints(got[..., 0]),
                                  np.asarray(jc.matmul(A, B)))
    vals = np.array([0, 1, 5, -7, (1 << 40) + 3, 3 << d], dtype=object)
    np.testing.assert_array_equal(ctx.encode_ints(vals),
                                  jc.encode_ints(vals))


@pytest.mark.parametrize('d', [2, 8])
def test_binary_field_elements(d):
    """Host elements: products, quotients, powers, shifts (x^n), and the
    array of a field against the JAX package's."""
    md = _modulus(d)
    F = finfields.GF(gfpx.GFpX(2)(md))
    J = jff.GF(jgfpx.GFpX(2)(md))
    assert int(F.modulus) == int(J.modulus) and F.order == J.order
    for x in range(1, 1 << d, max(1, (1 << d) // 40)):
        for y in (1, 2, 3, (1 << d) - 1):
            assert int(F(x) * F(y)) == int((J(x) * J(y)).value)
            assert int(F(x) / F(y)) == int((J(x) / J(y)).value)
        assert int(F(x) ** 254) == int((J(x) ** 254).value)
        assert int(F(x).reciprocal()) == int(J(x).reciprocal().value)
    for k in range(2 * d):
        assert int(F(1) << k) == int((J(1) << k).value)
    vals = np.arange(1 << min(d, 6), dtype=object)
    arr = F.array(vals, 'cpu')
    jarr = J.array(vals)
    np.testing.assert_array_equal(arr.value, [int(v) for v in jarr.value])
    np.testing.assert_array_equal((arr * arr).value,
                                  [int(v) for v in (jarr * jarr).value])
    np.testing.assert_array_equal((arr ** 254).value,
                                  [int(v) for v in (jarr ** 254).value])


@pytest.fixture(scope='module')
def jax_runtime():
    """A JAX SimRuntime(3) wired into the JAX package's type layer for
    the module, the package's own runtime wired back after."""
    old = jsectypes.runtime
    jr = JaxSim(3, _Options())
    jr._wire_modules()
    try:
        yield jr
    finally:
        if old is not None:
            old._wire_modules()


def test_secfld_moduli(jax_runtime):
    """SecFld(2) at m = 3 computes in GF(4) = GF(2)[x] / (x^2 + x + 1), as
    the JAX package's, with GF(2) as the subfield its openings convert
    to; SecFld(2^8) in AES's field, without one."""
    rt = TorchSim(3, device='cpu')
    for order in (2, 2**8):
        sf, jf = rt.SecFld(order), jax_runtime.SecFld(order)
        assert int(sf.field.modulus) == int(jf.field.modulus)
        assert sf.bit_length == jf.bit_length
        assert (sf.subfield is None) == (jf.subfield is None)
        if sf.subfield is not None:
            assert int(sf.subfield.modulus) == int(jf.subfield.modulus) == 2
    assert int(rt.SecFld(2).field.modulus) == 0b111
    assert int(rt.SecFld(2**8).field.modulus) == 0x11B
    x = rt.input(rt.SecFld(2).array(np.array([0, 1, 1, 0], dtype=object)),
                 senders=0)
    got = rt.output(x)
    assert got.field is rt.SecFld(2).subfield
    np.testing.assert_array_equal(got.value, [0, 1, 1, 0])


def _circulant(field_array, r, device=None):
    r = np.array(r, dtype=object)
    rows = np.stack([np.roll(r, j) for j in range(len(r))])
    return field_array(rows) if device is None else \
        field_array(rows, device)


@pytest.mark.parametrize('row', [[1, 0, 0, 0, 1, 1, 1, 1], [2, 3, 1, 1]])
def test_aes_matrix_inverses(row):
    """np.linalg.inv of AES's S-box matrix A and MixColumns matrix C over
    GF(2^8), as the JAX package inverts them."""
    F = finfields.GF(gfpx.GFpX(2)(0x11B))
    J = jff.GF(jgfpx.GFpX(2)(0x11B))
    inv = np.linalg.inv(_circulant(F.array, row, 'cpu'))
    jinv = np.linalg.inv(_circulant(J.array, row))
    np.testing.assert_array_equal(inv.value,
                                  np.vectorize(int)(jinv.value))
    eye = _circulant(F.array, row, 'cpu') @ inv
    np.testing.assert_array_equal(eye.value, np.eye(len(row), dtype=int))
