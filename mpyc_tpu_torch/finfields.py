"""Finite fields: prime fields GF(p) and binary fields GF(2^d), with
arrays backed by torch tensors.

Port of the part of ``mpyc_tpu/finfields.py`` that secure multiplication,
comparison, truncation, the LP solver and the binary-field demos use.

Prime fields: ``GF(p)`` (or of ``find_prime_root``'s (p, n, w), kept as
the field's ``nth`` and ``root``), ``find_prime_root`` (same construction,
so the moduli agree with the JAX package's), scalar elements ``GF(p)(x)``
on the host (``*``, ``==``, ``int()``, ``reciprocal``), and
``PrimeFieldArray``, whose data is a ``(..., L)`` int32 tensor of
Montgomery limbs on the CPU or the card, with elementwise +, -, * and
negation (public int, element or integer-array operands included), ``==``
(a host bool array), fancy indexing, matrix products of field arrays,
reciprocals (a power by p - 2, K6 on the card), (inverse) square roots,
shifts by a public power of two and the values mod 2^f.

Binary fields: ``GF`` of an irreducible binary polynomial (``gfpx``),
``find_irreducible`` (the smallest irreducible polynomial of a degree, as
the JAX package finds it), ``GF(2)`` as GF(2^1), scalar elements
(``BinaryFieldElement``: +, -, *, /, **, <<) and ``BinaryFieldArray``,
one d-bit element a lane in a ``(..., 1)`` int32 tensor (a limb axis of
one, so that the shape operations of the co-located plane take both kinds
of array alike), with XOR addition, carry-less products
(``ops/binary.py``), powers, matrix products and ``np.linalg.inv`` of a
public matrix (Gauss-Jordan on the host).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpyc_tpu_torch import gfpx
from mpyc_tpu_torch import gmpy as gmpy2
from mpyc_tpu_torch.ops.binary import binary_field_ctx
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx


def find_prime_root(l, blum=True, n=1):
    """Find prime p of bit length >= l, p % 4 == 3 if blum, with a primitive
    root w of prime order >= n. Returns (p, n, w)."""
    if l <= 2:
        if not blum:
            p = 2
            if n != 1:
                raise ValueError('GF(2) has no root of order > 1')
            w = 1
        else:
            p = 3
            n, w = 2, p - 1
    elif n <= 2:
        p = gmpy2.prev_prime(1 << l)
        if blum:
            while p % 4 != 3:
                p = gmpy2.prev_prime(p)
        w = p - 1 if n == 2 else 1
    else:
        if not blum:
            raise ValueError('roots of order > 2 need a Blum prime')
        if not gmpy2.is_prime(n):
            n = gmpy2.next_prime(n)
        p = 1 + 2 * n * (3 + 2 * ((1 << (l - 3)) // n))
        while not gmpy2.is_prime(p):
            p += 4 * n
        a = 2
        while (w := gmpy2.powmod(a, (p - 1) // n, p)) == 1:
            a += 1
    return int(p), int(n), int(w)


class FieldElement:
    """Base of the scalar field elements (prime and binary)."""

    __slots__ = ()


class PrimeField(FieldElement):
    """GF(p) element on the host: ``value`` in [0, p) (``mpyc_tpu/
    finfields.py:392 PrimeFieldElement``). The class carries the modulus,
    the root of unity of ``find_prime_root`` (``nth``, ``root``) and the
    field's array type."""

    __slots__ = ('value',)

    modulus: int = None
    nth: int = None
    root: int = None
    array: type = None
    characteristic: int = None
    ext_deg = 1
    order: int = None
    is_signed = True    # int() in (-p/2, p/2); else in [0, p)

    def __init__(self, value):
        if not isinstance(value, (int, np.integer)):
            raise TypeError(f'int required, got {type(value).__name__}')
        self.value = int(value) % self.modulus

    def _v(self, other):
        """The value of an element of this field or of an int; None for
        anything else."""
        if isinstance(other, PrimeField):
            if other.modulus != self.modulus:
                raise TypeError('elements of different fields')
            return other.value
        if isinstance(other, (int, np.integer)):
            return int(other)
        return None

    def __mul__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return type(self)(self.value * v)

    __rmul__ = __mul__

    def __eq__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return self.value == v % self.modulus

    def __hash__(self):
        return hash((self.modulus, self.value))

    def __int__(self):
        """The signed value, in (-p/2, p/2), or in an unsigned field (a
        secure prime field's, ``SecFld(p)``) the value in [0, p)
        (``mpyc_tpu/finfields.py:406 PrimeFieldElement.__int__``)."""
        p = self.modulus
        if not self.is_signed:
            return self.value
        return self.value - p if self.value > p >> 1 else self.value

    def reciprocal(self):
        return type(self)(pow(self.value, -1, self.modulus))

    def __repr__(self):
        return f'{int(self)}'


def find_irreducible(p: int, d: int):
    """The smallest irreducible polynomial of degree d over GF(p)
    (``mpyc_tpu/finfields.py:82``)."""
    return gfpx.GFpX(p).next_irreducible(p ** d - 1)


def GF(modulus, signed: bool = True) -> type:
    """The field type GF(p) for an odd prime p (with the root of unity
    w = p - 1 of order 2, as the JAX package's ``GF(p)``), or of
    find_prime_root's (p, n, w) tuple; GF(2^d) for an irreducible binary
    polynomial (``gfpx``), and GF(2) as GF(2^1). A prime field's elements
    convert to signed ints unless ``signed`` is False (a type of its own:
    the JAX package sets ``is_signed`` on its one type). Extension fields
    of odd characteristic are not ported."""
    if isinstance(modulus, gfpx.Polynomial):
        if type(modulus).p != 2:
            raise NotImplementedError('extension fields of odd '
                                      'characteristic are not ported')
        return _BinaryGF(int(modulus))
    if modulus == 2:
        return _BinaryGF(2)
    if isinstance(modulus, tuple):
        p, n, w = (int(v) for v in modulus)
    else:
        p = int(modulus)
        n, w = 2, p - 1
    return _GF(p, n, w % p, bool(signed))


@functools.cache
def _GF(p: int, n: int, w: int, signed: bool = True) -> type:
    field = type(f'GF({p})', (PrimeField,), {'__slots__': (), 'modulus': p,
                                              'nth': n, 'root': w,
                                              'characteristic': p,
                                              'order': p,
                                              'is_signed': signed})
    field.array = type(f'ArrayGF({p})', (PrimeFieldArray,),
                       {'__slots__': (), 'field': field,
                        'ctx': prime_field_ctx(p)})
    return field


class FieldArray:
    """Base of the field arrays: ``data`` is a (..., L) int32 tensor, L
    limbs an element (one for a binary field); ``shape`` is the logical
    shape (without the limb axis)."""

    __slots__ = ('data',)

    field: type = None
    ctx = None

    @classmethod
    def from_data(cls, data: torch.Tensor) -> 'FieldArray':
        """Wrap element data (no validation)."""
        a = cls.__new__(cls)
        a.data = data
        return a

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.from_data(self.data.reshape(shape + self.data.shape[-1:]))

    def flatten(self):
        return self.from_data(self.data.reshape((-1,) + self.data.shape[-1:]))

    def __getitem__(self, idx):
        """Indexing along the logical axes; lists (nested ones too) index
        as integer arrays, as numpy's fancy indexing."""
        if isinstance(idx, list):
            idx = torch.as_tensor(idx, dtype=torch.int64,
                                  device=self.device)
        return self.from_data(self.data[idx])


class PrimeFieldArray(FieldArray):
    """GF(p) array: ``data`` is a (..., L) int32 Montgomery limb tensor."""

    __slots__ = ()

    def __init__(self, values, device):
        """Encode public values (numpy ints or an object array of ints)."""
        self.data = self.ctx.encode(np.asarray(values), device)

    def _operand(self, other):
        """Data of a field array of this field, the Montgomery limbs of a
        public int or element (a tuple), or the encoded data of a public
        integer array on this array's device; None for anything else."""
        if isinstance(other, PrimeFieldArray):
            if other.field.modulus != self.field.modulus:
                raise TypeError('arrays of different fields')
            return other.data
        if isinstance(other, PrimeField):
            if other.modulus != self.field.modulus:
                raise TypeError('an element of another field')
            return self.ctx.encode_const(other.value)
        if isinstance(other, (int, np.integer)):
            return self.ctx.encode_const(int(other))
        if isinstance(other, (list, tuple, np.ndarray)):
            return self.ctx.encode(np.asarray(other), self.device)
        return None

    def __add__(self, other):
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.ctx.add(self.data, o))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.ctx.sub(self.data, o))

    def __rsub__(self, other):
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.ctx.sub(o, self.data))

    def __neg__(self):
        return self.from_data(self.ctx.neg(self.data))

    def __mul__(self, other):
        if isinstance(other, (int, np.integer)):
            return self.from_data(self.ctx.mul_int(self.data, int(other)))
        if isinstance(other, PrimeField) and \
                other.modulus == self.field.modulus:
            return self.from_data(self.ctx.mul_limbs_const(
                self.data, other.value * self.ctx.R))
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.ctx.mul(self.data, o))

    __rmul__ = __mul__

    def __matmul__(self, other):
        """Matrix product of field arrays (numpy's matmul on the logical
        shapes, vectors promoted); other operands (secure arrays) take
        their reflected product."""
        if not isinstance(other, PrimeFieldArray):
            return NotImplemented
        a, b = self.data, self._operand(other)
        a_vec, b_vec = a.dim() == 2, b.dim() == 2
        if a_vec:
            a = a.unsqueeze(0)
        if b_vec:
            b = b.unsqueeze(1)
        c = self.ctx.matmul(a, b)
        if a_vec:
            c = c[..., 0, :, :]
        if b_vec:
            c = c[..., 0, :]
        return self.from_data(c)

    def __eq__(self, other):
        """Elementwise equality with a field array, element or int, as a
        numpy bool array (read back to the host)."""
        o = self._operand(other)
        if o is None:
            return NotImplemented
        if isinstance(o, tuple):
            o = torch.tensor(o, dtype=torch.int64).to(torch.int32).to(
                self.device)
        return (self.data == o).all(-1).cpu().numpy()

    __hash__ = None

    def reciprocal(self):
        """Multiplicative inverses, a^(p - 2) (the inverse of 0 is 0;
        ``mpyc_tpu/ops/limb.py:366 mont_inv``): K6 on the card."""
        return self.from_data(self.ctx.inv(self.data))

    def __lshift__(self, n):
        """Times 2^n (``mpyc_tpu/finfields.py:1450``)."""
        if not isinstance(n, (int, np.integer)):
            return NotImplemented
        return self * (1 << int(n))

    def __rshift__(self, n):
        """Times 2^-n mod p (``mpyc_tpu/finfields.py:1455``): an exact
        division for a multiple of 2^n."""
        if not isinstance(n, (int, np.integer)):
            return NotImplemented
        return self * pow(1 << int(n), -1, self.field.modulus)

    def sqrt(self, INV=False):
        """Square roots of quadratic residues (with INV their inverses,
        and then no element may be 0)."""
        if INV and self.ctx.any_zero(self.data):
            raise ZeroDivisionError('no inverse sqrt of 0')
        return self._sqrt_unchecked(INV)

    def _sqrt_unchecked(self, INV=False):
        """sqrt without the read back of the zero test, for callers that
        have rejected zeros already (``np_random_bits``)."""
        return self.from_data(self.ctx.sqrt(self.data, INV))

    def mod_pow2(self, f: int):
        """Each value mod 2^f (``mpyc_tpu/finfields.py:1511``)."""
        return self.from_data(self.ctx.mod_pow2(self.data, f))

    def to_bits_public(self, l: int) -> torch.Tensor:
        """The low l bits of each value, least significant first: an
        int64 0/1 tensor of shape self.shape + (l,) on the array's device
        (``mpyc_tpu/finfields.py:1497``)."""
        std = self.ctx.to_standard(self.data).to(torch.int64) & 0xFFFFFFFF
        j = torch.arange(l, device=std.device)
        return (std[..., j // 32] >> (j % 32)) & 1

    @classmethod
    def from_uint32(cls, v: torch.Tensor) -> 'PrimeFieldArray':
        """Small nonnegative integers (below 2^31, any integer dtype) as a
        field array of their values (``mpyc_tpu/finfields.py:1507``)."""
        one = torch.tensor(cls.ctx.one_mont, dtype=torch.int64,
                           device=v.device)
        std = torch.zeros(v.shape + (cls.ctx.L,), dtype=torch.int64,
                          device=v.device)
        std[..., 0] = v.to(torch.int64)
        if not std.numel():
            return cls.from_data(std.to(torch.int32))
        return cls.from_data(cls.ctx.mul_limbs_const(std.to(torch.int32),
                                                     cls.ctx.R2))

    @property
    def value(self) -> np.ndarray:
        """Values in [0, p) on the host (uint64 for fields below 2^64)."""
        return self.ctx.decode(self.data)

    def signed(self) -> np.ndarray:
        """Values as signed ints in (-p/2, p/2): int64 for fields below
        2^64, else object."""
        v = self.value
        p = self.field.modulus
        if v.dtype == np.uint64:
            half = np.uint64(p // 2)
            neg = v > half
            mag = np.where(neg, np.uint64(p) - v, v).astype(np.int64)
            return np.where(neg, -mag, mag)
        return np.where(v > p // 2, v - p, v)

    def __repr__(self):
        return f'{type(self).__name__}({self.value!r})'


# -- binary fields GF(2^d) -------------------------------------------------------

class BinaryFieldElement(FieldElement):
    """GF(2^d) element on the host (``mpyc_tpu/finfields.py:673``):
    ``value``, the int bitmask of a binary polynomial reduced mod the
    field's modulus. Ints and polynomials mix in as polynomials (3 is
    x + 1)."""

    __slots__ = ('value',)

    modulus = None        # the gfpx polynomial f
    order: int = None
    characteristic = 2
    ext_deg: int = None
    ctx = None
    array: type = None

    def __init__(self, value):
        if isinstance(value, BinaryFieldElement):
            value = value.value
        self.value = self.ctx.reduce_int(int(value))

    @classmethod
    def _v(cls, other):
        """The value of an element of this field, an int or a polynomial
        (reduced); None for anything else."""
        if isinstance(other, BinaryFieldElement):
            if other.modulus != cls.modulus:
                raise TypeError('elements of different fields')
            return other.value
        if isinstance(other, (int, np.integer, gfpx.Polynomial)):
            return cls.ctx.reduce_int(int(other))
        return None

    def __add__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return type(self)(self.value ^ v)

    __radd__ = __sub__ = __rsub__ = __add__

    def __neg__(self):
        return self

    def __mul__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return type(self)(self.ctx.mul_int(self.value, v))

    __rmul__ = __mul__

    def reciprocal(self):
        if not self.value:
            raise ZeroDivisionError('no inverse of 0')
        return self ** (self.order - 2)

    def __truediv__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return self * type(self)(v).reciprocal()

    def __pow__(self, e):
        if not isinstance(e, (int, np.integer)):
            return NotImplemented
        e = int(e)
        base = self.reciprocal() if e < 0 else self
        r, b, e = 1, base.value, abs(e)
        while e:
            if e & 1:
                r = self.ctx.mul_int(r, b)
            b = self.ctx.mul_int(b, b)
            e >>= 1
        return type(self)(r)

    def __lshift__(self, n):
        """Times x^n (``mpyc_tpu/finfields.py:283``)."""
        if not isinstance(n, (int, np.integer)):
            return NotImplemented
        return type(self)(self.value << int(n))

    def __eq__(self, other):
        v = self._v(other)
        if v is None:
            return NotImplemented
        return self.value == v

    def __hash__(self):
        return hash((int(self.modulus), self.value))

    def __int__(self):
        return self.value

    def __bool__(self):
        return bool(self.value)

    def __repr__(self):
        return repr(gfpx.GFpX(2)(self.value))


@functools.cache
def _BinaryGF(modulus: int) -> type:
    """GF(2^d) for the irreducible binary polynomial of int ``modulus``
    (GF(2) for 2, the polynomial x)."""
    poly = gfpx.GFpX(2)(modulus)
    if modulus != 2 and not gfpx.GFpX(2).is_irreducible(poly):
        raise ValueError('modulus is not irreducible')
    ctx = binary_field_ctx(modulus)
    name = 'GF(2)' if modulus == 2 else f'GF(2^{ctx.d})'
    field = type(name, (BinaryFieldElement,), {
        '__slots__': (), 'modulus': poly, 'order': ctx.order,
        'ext_deg': ctx.d, 'ctx': ctx})
    field.array = type(f'Array{name}', (BinaryFieldArray,),
                       {'__slots__': (), 'field': field, 'ctx': ctx})
    return field


def _i32(v: int) -> int:
    """A uint32 value as the int32 that stores it."""
    return v - (1 << 32) if v >= 1 << 31 else v


class BinaryFieldArray(FieldArray):
    """GF(2^d) array (``mpyc_tpu/finfields.py:1611``): ``data`` is a
    (..., 1) int32 tensor, one d-bit polynomial a lane."""

    __slots__ = ()
    __array_ufunc__ = None   # numpy operands defer to the operators

    def __init__(self, values, device):
        """Encode public values: ints (reduced mod f as polynomials),
        elements of this field or polynomials, in any nesting numpy
        takes."""
        arr = np.asarray(values)
        if arr.dtype == object and arr.size:
            try:        # ints, elements and polynomials below 2^63
                arr = arr.astype(np.int64)
            except OverflowError:
                arr = np.vectorize(int, otypes=[object])(arr)
        enc = self.ctx.encode_ints(arr)
        self.data = torch.from_numpy(
            np.ascontiguousarray(enc, np.uint32).view(np.int32)
            .reshape(enc.shape + (1,))).to(device)

    def _operand(self, other):
        """Data of a field array of this field, or a public element, int
        or integer array of this array's device broadcastable against its
        data; None for anything else."""
        if isinstance(other, BinaryFieldArray):
            if other.field is not self.field:
                raise TypeError('arrays of different fields')
            return other.data
        if isinstance(other, (BinaryFieldElement, int, np.integer,
                              gfpx.Polynomial)):
            v = self.field(other).value
            return torch.full((1,), _i32(v), dtype=torch.int32,
                              device=self.device)
        if isinstance(other, (list, tuple, np.ndarray)):
            return type(self)(other, self.device).data
        return None

    def __add__(self, other):
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.data ^ o)

    __radd__ = __sub__ = __rsub__ = __add__

    def __neg__(self):
        return self

    def __mul__(self, other):
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return self.from_data(self.ctx.clmul_reduce(self.data, o))

    __rmul__ = __mul__

    def __pow__(self, e):
        if not isinstance(e, (int, np.integer)):
            return NotImplemented
        return self.from_data(self.ctx.pow_const(self.data, int(e)))

    def reciprocal(self):
        """Inverses, a^(2^d - 2) (the inverse of 0 is 0)."""
        return self.from_data(self.ctx.inv(self.data))

    def _matmul(self, a, b):
        a_vec, b_vec = a.dim() == 2, b.dim() == 2
        if a_vec:
            a = a.unsqueeze(0)
        if b_vec:
            b = b.unsqueeze(1)
        c = self.ctx.matmul(a, b)
        if a_vec:
            c = c[..., 0, :, :]
        if b_vec:
            c = c[..., 0, :]
        return self.from_data(c)

    def __matmul__(self, other):
        """Matrix product with a field array (numpy's matmul on the logical
        shapes, vectors promoted); secure operands take their reflected
        product."""
        if not isinstance(other, BinaryFieldArray):
            return NotImplemented
        return self._matmul(self.data, self._operand(other))

    def __rmatmul__(self, other):
        if not isinstance(other, BinaryFieldArray):
            return NotImplemented
        return self._matmul(self._operand(other), self.data)

    def __eq__(self, other):
        """Elementwise equality, as a numpy bool array (read back to the
        host)."""
        o = self._operand(other)
        if o is None:
            return NotImplemented
        return (self.data == o).all(-1).cpu().numpy()

    __hash__ = None

    @property
    def value(self) -> np.ndarray:
        """The elements' ints on the host (int64)."""
        return self.data[..., 0].cpu().numpy().view(np.uint32).astype(
            np.int64)

    def __repr__(self):
        return f'{type(self).__name__}({self.value!r})'

    def __array_function__(self, func, types, args, kwargs):
        """np.linalg.inv of a square public matrix; no other numpy
        function."""
        if func is np.linalg.inv:
            return self.gauss_inv()
        return NotImplemented

    def gauss_inv(self):
        """The inverse of a square matrix by Gauss-Jordan elimination on
        the host (``mpyc_tpu/finfields.py:910``); ZeroDivisionError for a
        singular one."""
        n = self.shape[0]
        if self.shape != (n, n):
            raise np.linalg.LinAlgError('array must be square')
        field = self.field
        vals = self.value.tolist()
        W = [[field(v) for v in row] + [field(int(i == j)) for j in range(n)]
             for i, row in enumerate(vals)]
        for k in range(n):
            piv = next((r for r in range(k, n) if W[r][k]), None)
            if piv is None:
                raise ZeroDivisionError('no inverse exists')
            W[k], W[piv] = W[piv], W[k]
            inv = W[k][k].reciprocal()
            W[k] = [x * inv for x in W[k]]
            for r in range(n):
                if r != k and W[r][k]:
                    f_ = W[r][k]
                    W[r] = [x - f_ * y for x, y in zip(W[r], W[k])]
        X = np.array([[int(x) for x in row[n:]] for row in W], dtype=object)
        return type(self)(X, self.device)
