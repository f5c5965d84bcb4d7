"""Secure types: SecInt(l), SecFxp(l, f) and their arrays.

Port of the part of ``mpyc_tpu/sectypes.py`` that secure multiplication,
comparison, truncation and matrix products use: ``SecInt(l)`` and
``SecFxp(l, f)`` with their ``.array`` classes, enough to input public
values, compute and open the result. A secure array holds a
``PrimeFieldArray`` share: logical shape before input
(``secint.array(values)`` of public values, the constant sharing), (m, ...)
party stacked after it. A fixed-point array holds its values times 2^f
and an ``integral`` flag: whether every value is known to be an integer,
so that a product by it is exact and needs no truncation. The operators
of a secure array (-x, +, -, *, @, <, <=, >, >=, ==, !=, indexing; the
comparisons give secure 0/1 arrays, times 2^f in a fixed-point type) call
the runtime whose ``SecInt`` or ``SecFxp`` made its type (``bind``). A
type's ``bit_length`` may be reassigned; comparisons read it at call
time.
"""

from __future__ import annotations

import functools

import numpy as np

from mpyc_tpu_torch import finfields


class SecureObject:
    """Base of the secure types; ``share`` holds the field data."""

    __slots__ = ('share',)

    field: type = None

    def __init__(self, share=None):
        self.share = share


class SecureInteger(SecureObject):
    """Secret-shared integer (its class carries field and bit length)."""

    __slots__ = ()

    bit_length: int = None
    frac_length = 0
    array: type = None


class SecureFixedPoint(SecureObject):
    """Secret-shared fixed-point number: l bits in all, f of them after
    the point (its class carries field, bit length and f)."""

    __slots__ = ()

    bit_length: int = None
    frac_length: int = None
    array: type = None


class SecureArray(SecureObject):
    """Secure array: ``shape`` is the logical shape (no party axis)."""

    __slots__ = ('shape',)

    sectype: type = None
    device = None
    runtime = None    # the runtime the operators call (bind)
    __array_ufunc__ = None   # numpy operands defer to the operators below

    def __init__(self, value=None, shape=None):
        if value is not None and not isinstance(
                value, finfields.PrimeFieldArray):
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

    def __getitem__(self, idx):
        return self.runtime.np_getitem(self, idx)

    # arithmetic and comparison, forwarded to the runtime; public operands
    # (ints, floats, numpy arrays) pass as they are, and the runtime
    # encodes them.
    # Arrays of a type that no runtime made (SecInt(l, device)) have none.

    def _coerce(self, other):
        if isinstance(other, SecureArray):
            return other if type(other) is type(self) else NotImplemented
        if isinstance(other, (int, float, np.integer, np.floating, list,
                              tuple, np.ndarray)):
            return other
        return NotImplemented

    def __neg__(self):
        return self.runtime.neg(self)

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
                value, finfields.PrimeFieldArray):
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


def SecInt(l: int, device) -> type:
    """Secure l-bit integers over GF(p), p the largest Blum prime below
    2^(l + 32) (the JAX package's field for the same l at its default
    security parameter), with arrays encoded on ``device``."""
    return _SecInt(int(l), str(device))


@functools.cache
def _SecInt(l, device):
    field = finfields.GF(finfields.find_prime_root(l + _SEC_PARAM + 2, n=2))
    name = f'SecInt{l}'
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
    """A subtype of secint whose arrays' operators call ``runtime``."""
    sub = type(secint.__name__, (secint,), {'__slots__': ()})
    sub.array = type(secint.array.__name__, (secint.array,), {
        '__slots__': (), 'sectype': sub, 'runtime': runtime})
    return sub
