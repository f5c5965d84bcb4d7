"""Secure types: SecInt(l), SecFxp(l, f), SecFld(q), their numbers and
their arrays.

Port of the part of ``mpyc_tpu/sectypes.py`` that secure multiplication,
comparison, truncation, matrix products and the LP solver use:
``SecInt(l, p=None, n=2)`` and ``SecFxp(l, f)``, whose instances are
secure scalars (``SecureNumber``) and whose ``.array`` classes are secure
arrays. A secure object holds a ``PrimeFieldArray`` share: logical shape
before input (``secint(5)``, ``secint.array(values)`` of public values,
the constant sharing), (m, ...) party stacked after it; a scalar's
logical shape is (). A fixed-point object holds its values times 2^f and
an ``integral`` flag: whether every value is known to be an integer, so
that a product by it is exact and needs no truncation. The operators of a
secure object (-x, +, -, *, /, @, <, <=, >, >=, ==, !=, and an array's
indexing, reshape, argmin and argmax; the comparisons give secure 0/1
values, times 2^f in a fixed-point type) call the runtime whose
``SecInt`` or ``SecFxp`` made its type (``bind``); np.stack,
np.column_stack, np.concatenate, np.outer and np.append of secure arrays
do too. A type's ``bit_length`` may be reassigned; comparisons read it at
call time. ``SecFld(q)`` over a binary field (``mpyc_tpu/sectypes.py:749``,
``:806``): secure elements of GF(2^d), whose arrays take +, -, * (XOR and
carry-less products), ``**``, and ``@`` with public field matrices from
either side; where the field has fewer than m + 1 elements (GF(2) at
m = 3) the shares live in an extension (GF(4)), and opened values convert
back to the subfield. ``SecFld(p)`` over a prime field (by order,
modulus or ``min_order``): +, -, * (a product of two secure elements one
reshare round), ``**`` and ==, the zero test by Fermat's little theorem.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from mpyc_tpu_torch import finfields, gfpx
from mpyc_tpu_torch import gmpy as gmpy2


class SecureObject:
    """Base of the secure types; ``share`` holds the field data. A secure
    object's operators call the runtime whose ``SecInt`` or ``SecFxp``
    made its type (``bind``); a type no runtime made has none."""

    __slots__ = ('share',)

    field: type = None
    runtime = None    # the runtime the operators call (bind)
    __array_ufunc__ = None   # numpy operands defer to the operators below

    def __init__(self, share=None):
        self.share = share

    # arithmetic and comparison, forwarded to the runtime; public operands
    # (ints, floats, numpy arrays, field arrays) pass as they are, and the
    # runtime encodes them.

    def _coerce(self, other):
        """other if it may meet self in an operator: a secure object of
        the same secure type (array or scalar), or a public value."""
        if isinstance(other, SecureObject):
            return other if _sectype_of(other) is _sectype_of(self) \
                else NotImplemented
        if isinstance(other, (int, float, np.integer, np.floating, list,
                              tuple, np.ndarray, finfields.FieldArray,
                              finfields.FieldElement)):
            return other
        return NotImplemented

    def __neg__(self):
        return self.runtime.neg(self)

    def __abs__(self):
        return self.runtime.abs(self)

    def __add__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.sub(self, other)

    def __rsub__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.sub(other, self)

    def __mul__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.mul(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        """Division (``mpyc_tpu/sectypes.py:202``, ``:1089``): by a secure
        divisor its secure reciprocal, by a public one its public
        reciprocal."""
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.div(self, other)

    def __rtruediv__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.div(other, self)

    def __pow__(self, other):
        """a ** e for a public int e (``mpyc_tpu/runtime.py:1540``)."""
        if not isinstance(other, (int, np.integer)):
            return NotImplemented
        return self.runtime.pow(self, int(other))

    def __matmul__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.np_matmul(self, other)

    def __rmatmul__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.np_matmul(other, self)

    def __lt__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.np_less(self, other)

    def __le__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return 1 - self.runtime.np_less(other, self)

    def __gt__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.np_less(other, self)

    def __ge__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return 1 - self.runtime.np_less(self, other)

    def __eq__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.np_equal(self, other)

    def __ne__(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return 1 - self.runtime.np_equal(self, other)

    __hash__ = None

    def __bool__(self):
        raise TypeError('cannot use secure type in Boolean expressions')


def _sectype_of(x) -> type:
    """The scalar secure type of a secure array or number."""
    return x.sectype if isinstance(x, SecureArray) else type(x)


class SecureNumber(SecureObject):
    """Secure scalar (``mpyc_tpu/sectypes.py:135``): its share is a 0-d
    field array (a public value's, before input) or the (m,) shares of the
    parties. Its class carries field and bit length; ``array`` is the
    class of its arrays."""

    __slots__ = ()

    shape = ()
    bit_length: int = None
    frac_length = 0
    array: type = None

    def __init__(self, value=None):
        if value is not None and not isinstance(
                value, finfields.FieldArray):
            value = self.array._encode_public(value)
        super().__init__(value)

    @classmethod
    def _output_conversion(cls, a):
        """Opened 0-d field array -> the value (``_output_conversion`` of
        the class's arrays, unboxed)."""
        v = cls.array._output_conversion(a)[()]
        return v.item() if isinstance(v, np.generic) else v

    # integer division by a public value (``mpyc_tpu/sectypes.py:214-252``):
    # a public int or float operand becomes a number of this type first

    def _coerce_number(self, other):
        if isinstance(other, SecureObject):
            return other if type(other) is type(self) else NotImplemented
        if isinstance(other, (int, float, np.integer, np.floating)):
            return type(self)(other)
        return NotImplemented

    def __mod__(self, other):
        """a mod b for a public b (``runtime.mod``), in the raw domain:
        a fixed-point residue keeps a's fraction."""
        other = self._coerce_number(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.mod(self, other)

    def __rmod__(self, other):
        other = self._coerce_number(other)
        if other is NotImplemented:
            return NotImplemented
        return self.runtime.mod(other, self)

    def __floordiv__(self, other):
        q, _ = self.__divmod__(other)
        return q

    def __rfloordiv__(self, other):
        other = self._coerce_number(other)
        if other is NotImplemented:
            return NotImplemented
        q, _ = other.__divmod__(self)
        return q

    def __divmod__(self, other):
        """(q, r) with r = a mod b and q = (a - r) times b's secure
        reciprocal, an exact multiple (``mpyc_tpu/sectypes.py:233``)."""
        other = self._coerce_number(other)
        if other is NotImplemented:
            return NotImplemented
        r = self.runtime.mod(self, other)
        q = self.runtime.mul(self - r, self.runtime.reciprocal(other))
        return q, r

    def __rdivmod__(self, other):
        other = self._coerce_number(other)
        if other is NotImplemented:
            return NotImplemented
        return other.__divmod__(self)


class SecureInteger(SecureNumber):
    """Secret-shared integer (its class carries field and bit length)."""

    __slots__ = ()


class SecureFixedPoint(SecureNumber):
    """Secret-shared fixed-point number: l bits in all, f of them after
    the point (its class carries field, bit length and f); ``integral``:
    whether the value is an integer."""

    __slots__ = ('integral',)

    frac_length: int = None

    def __init__(self, value=None, integral=None):
        if integral is None and value is not None and not isinstance(
                value, finfields.FieldArray):
            integral = _all_integral(np.asarray(value))
        self.integral = integral
        super().__init__(value)


# numpy functions on secure arrays (``mpyc_tpu/sectypes.py:1407
# _secure_array_function``): the runtime method each calls
_ARRAY_FUNCTIONS = {np.stack: 'np_stack', np.column_stack: 'np_column_stack',
                    np.concatenate: 'np_concatenate', np.outer: 'np_outer',
                    np.append: 'np_append', np.roll: 'np_roll',
                    np.hsplit: 'np_hsplit', np.split: 'np_split',
                    np.where: 'np_where'}


class SecureArray(SecureObject):
    """Secure array: ``shape`` is the logical shape (no party axis)."""

    __slots__ = ('shape',)

    sectype: type = None
    device = None

    def __init__(self, value=None, shape=None):
        if value is not None and not isinstance(
                value, finfields.FieldArray):
            value = self._encode_public(value)
        if value is not None:
            shape = value.shape
        self.shape = tuple(shape) if shape is not None else None
        super().__init__(value)

    @classmethod
    def _encode_public(cls, value):
        """Public values as a field array on the type's device
        (``mpyc_tpu/sectypes.py:943``): integers as they are, and in a
        fixed-point type times 2^f, floats as round(v 2^f) (half to even,
        numpy's and Python's rounding)."""
        f = cls.sectype.frac_length
        arr = np.asarray(value)
        if not f and arr.dtype.kind == 'f':
            raise TypeError('float values need a fixed-point type')
        if f:
            if arr.dtype.kind in 'iub':
                arr = arr.astype(np.int64) << f
            elif arr.dtype.kind == 'f':
                arr = np.round(arr * (1 << f)).astype(np.int64)
            else:
                arr = np.vectorize(
                    lambda v: round(v * (1 << f)) if isinstance(v, float)
                    else int(v) << f, otypes=[object])(arr)
        return cls.sectype.field.array(arr, cls.device)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of unsized secure array')
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, idx):
        return self.runtime.np_getitem(self, idx)

    def reshape(self, *shape, order='C'):
        return self.runtime.np_reshape(
            self, shape if len(shape) != 1 else shape[0], order=order)

    def tolist(self):
        return self.runtime.np_tolist(self)

    def sum(self, axis=None, keepdims=False):
        return self.runtime.np_sum(self, axis=axis, keepdims=keepdims)

    def argmin(self, *args, **kwargs):
        """Unit vectors of the minima and the minima: defaults arg_unary
        and not arg_only, unlike np_argmin (``mpyc_tpu/sectypes.py:1235``)."""
        kwargs.setdefault('arg_unary', True)
        kwargs.setdefault('arg_only', False)
        return self.runtime.np_argmin(self, *args, **kwargs)

    def argmax(self, *args, **kwargs):
        """As argmin, for the maxima."""
        kwargs.setdefault('arg_unary', True)
        kwargs.setdefault('arg_only', False)
        return self.runtime.np_argmax(self, *args, **kwargs)

    def __array_function__(self, func, types, args, kwargs):
        """np.stack, np.column_stack, np.concatenate, np.outer, np.append,
        np.roll, np.split and np.hsplit of secure arrays (public operands
        among them) run on the runtime; any other numpy function is not
        supported."""
        name = _ARRAY_FUNCTIONS.get(func)
        if name is None:
            return NotImplemented
        return getattr(self.runtime, name)(*args, **kwargs)


class SecureIntegerArray(SecureArray):
    __slots__ = ()

    @classmethod
    def _output_conversion(cls, a):
        """Opened field array -> signed integers (int64 for fields below
        2^64)."""
        return a.signed()


class SecureFixedPointArray(SecureArray):
    """Secure fixed-point array; ``integral``: every value is an integer.
    Public values given without the flag decide it (floats that are whole
    numbers count as integers)."""

    __slots__ = ('integral',)

    def __init__(self, value=None, shape=None, integral=None):
        if integral is None and value is not None and not isinstance(
                value, finfields.FieldArray):
            integral = _all_integral(np.asarray(value))
        self.integral = integral
        super().__init__(value, shape)

    @classmethod
    def _output_conversion(cls, a):
        """Opened field array -> float64 values v / 2^f
        (``mpyc_tpu/sectypes.py:1328``), exact below 2^53."""
        return a.signed().astype(np.float64) / (1 << cls.sectype.frac_length)


def _all_integral(arr: np.ndarray) -> bool:
    """Whether every value of a public array is an integer."""
    if arr.dtype.kind in 'iub':
        return True
    if arr.dtype.kind == 'f':
        return bool(np.all(np.mod(arr, 1) == 0))
    return all(isinstance(v, (int, np.integer))
               or (isinstance(v, (float, np.floating)) and
                   float(v).is_integer()) for v in arr.reshape(-1))


_SEC_PARAM = 30   # the JAX package's default security parameter


def SecInt(l: int, device, p: int = None, n: int = 2) -> type:
    """Secure l-bit integers over GF(p), with arrays encoded on ``device``.
    Without p the JAX package's field (``mpyc_tpu/sectypes.py:845
    _pfield``, :857): find_prime_root(l + k + 2, n=n) at its default
    security parameter k = 30, the largest Blum prime below 2^(l + 32)
    for n <= 2, else a Blum prime of l + 32 bits with a root of unity of
    prime order at least n. A given p needs more than l + k + 1 bits."""
    if p is not None and int(p).bit_length() <= l + _SEC_PARAM + 1:
        raise ValueError(f'prime {p} too small')
    return _SecInt(int(l), str(device), None if p is None else int(p),
                   int(n))


@functools.cache
def _SecInt(l, device, p, n):
    field = finfields.GF(p if p is not None else
                         finfields.find_prime_root(l + _SEC_PARAM + 2, n=n))
    name = f'SecInt{l}' if p is None else f'SecInt{l}({p})'
    secint = type(name, (SecureInteger,), {'__slots__': (), 'field': field,
                                            'bit_length': l})
    secint.array = type(f'Array{name}', (SecureIntegerArray,), {
        '__slots__': (), 'sectype': secint, 'field': field,
        'device': device})
    return secint


def SecFxp(l: int, f: int, device) -> type:
    """Secure l-bit fixed-point numbers with f fractional bits over GF(p),
    p the largest Blum prime below 2^(l + f + 32) (the JAX package's
    ``_pfield`` at its default security parameter; SecFxp(14, 6): a 52-bit
    field of two limbs), with arrays encoded on ``device``."""
    return _SecFxp(int(l), int(f), str(device))


@functools.cache
def _SecFxp(l, f, device):
    field = finfields.GF(finfields.find_prime_root(l + f + _SEC_PARAM + 2,
                                                   n=2))
    name = f'SecFxp{l}:{f}'
    secfxp = type(name, (SecureFixedPoint,), {
        '__slots__': (), 'field': field, 'bit_length': l, 'frac_length': f})
    secfxp.array = type(f'Array{name}', (SecureFixedPointArray,), {
        '__slots__': (), 'sectype': secfxp, 'field': field,
        'device': device})
    return secfxp


def bind(secint: type, runtime) -> type:
    """A subtype of secint whose numbers' and arrays' operators call
    ``runtime``."""
    sub = type(secint.__name__, (secint,), {'__slots__': (),
                                            'runtime': runtime})
    sub.array = type(secint.array.__name__, (secint.array,), {
        '__slots__': (), 'sectype': sub, 'runtime': runtime})
    return sub


# -- secure finite fields --------------------------------------------------

class SecureFiniteField(SecureNumber):
    """Secure field element (``mpyc_tpu/sectypes.py:359``). Its class
    carries ``field`` (where shares live) and ``subfield`` (where values
    live, when the shares' field extends it)."""

    __slots__ = ()

    subfield = None

    @classmethod
    def _output_conversion(cls, a):
        """Opened 0-d field array -> its element (of the subfield, if
        any)."""
        return (cls.subfield or cls.field)(int(a.value[()]))


class SecureFiniteFieldArray(SecureArray):
    """Secure array of field elements (``mpyc_tpu/sectypes.py:1252``)."""

    __slots__ = ()

    subfield = None

    @classmethod
    def _encode_public(cls, value):
        """Public values as a field array on the type's device: ints as
        polynomials (a subfield's values embed as they are), elements by
        their values."""
        return cls.sectype.field.array(np.asarray(value, dtype=object),
                                       cls.device)

    @classmethod
    def _output_conversion(cls, a):
        """Opened field array -> itself, or its values in the subfield."""
        if cls.subfield is None:
            return a
        return cls.subfield.array(a.value, a.device)


def SecFld(order=None, modulus=None, char=None, ext_deg=None,
           min_order=None, signed=False, m: int = 1, t: int = 0,
           device=None) -> type:
    """Secure finite field of order q = p^d (``mpyc_tpu/sectypes.py:749``)
    for a runtime of m parties at threshold t, with arrays encoded on
    ``device`` (default: the card, ``resolve_device``). The field is
    resolved as the JAX package resolves it: by its order, by its modulus
    (an int: a prime, or with a smaller ``char`` a polynomial's int; a
    binary polynomial's string; a ``gfpx`` polynomial), or by ``min_order``
    (with no ``char``, the least prime p >= min_order^(1 / ext_deg)), by
    default GF(2); a binary field's modulus is ``find_irreducible(2, d)``.
    A prime field's values open unsigned, in [0, p), unless ``signed``.
    Where q <= m at t > 0, the shares live in an extension GF(p^e), e =
    max(2, ceil(log_q(m + 1))), so that Shamir's points 1..m exist
    (``:806-840``), and opened values convert back: ported for p = 2 (GF(2)
    in GF(4)); for an odd p that extension, and every extension field of
    odd characteristic (ext_deg > 1), raise NotImplementedError."""
    if order is not None:
        p, d = gmpy2.factor_prime_power(order)
        char = char or p
        ext_deg = ext_deg or d
        if (char, ext_deg) != (p, d):
            raise ValueError('order, char and ext_deg disagree')
    if isinstance(modulus, str):
        char = char or 2
        modulus = gfpx.GFpX(char)(modulus)
    if isinstance(modulus, int) and char and modulus > char:
        modulus = gfpx.GFpX(char)(modulus)
    if isinstance(modulus, gfpx.Polynomial):
        char = char or modulus.p
        ext_deg = ext_deg or modulus.degree()
        if (char, ext_deg) != (modulus.p, modulus.degree()):
            raise ValueError('modulus, char and ext_deg disagree')
    elif isinstance(modulus, int):
        char = char or modulus
        ext_deg = ext_deg or 1
        if (char, ext_deg) != (modulus, 1):
            raise ValueError('modulus, char and ext_deg disagree')
    else:
        if modulus is not None:
            raise TypeError('modulus: an int, a string or a polynomial')
        if min_order is None:
            char = char or 2
            ext_deg = ext_deg or 1
        elif char is None:
            ext_deg = ext_deg or 1
            root, exact = gmpy2.iroot(min_order, ext_deg)
            char = int(gmpy2.next_prime(root + (not exact) - 1))
        elif ext_deg is None:
            ext_deg = math.ceil(math.log(min_order, char))
        modulus = char if ext_deg == 1 else \
            finfields.find_irreducible(char, ext_deg)
    if char != 2 and ext_deg != 1:
        raise NotImplementedError('extension fields of odd characteristic '
                                  'are not ported')
    if char == 2:
        field = finfields.GF(modulus if isinstance(modulus, gfpx.Polynomial)
                             or modulus == 2 else gfpx.GFpX(2)(modulus))
    else:
        field = finfields.GF(int(modulus), signed=signed)
    from mpyc_tpu_torch import resolve_device
    return _SecFld(field, int(m), int(t), str(resolve_device(device)))


@functools.cache
def _SecFld(field, m, t, device):
    l = (field.order - 1).bit_length()
    name = f'SecFld{l}({field.__name__})'
    subfield = None
    if t and m >= field.order:
        if field.characteristic != 2:
            raise NotImplementedError(
                f'{field.__name__} has too few points for {m} parties: its '
                'shares would live in GF(p^e), which is not ported')
        subfield = field
        e = max(2, math.ceil(math.log(m + 1, field.order)))
        field = finfields.GF(finfields.find_irreducible(2, e))
    secfld = type(name, (SecureFiniteField,), {
        '__slots__': (), 'field': field, 'subfield': subfield,
        'bit_length': l})
    secfld.array = type(f'Array{name}', (SecureFiniteFieldArray,), {
        '__slots__': (), 'sectype': secfld, 'field': field,
        'subfield': subfield, 'device': device})
    return secfld
