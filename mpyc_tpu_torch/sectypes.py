"""Secure types: SecInt(l) and its arrays.

Port of the part of ``mpyc_tpu/sectypes.py`` that secure multiplication,
comparison and matrix products use: ``SecInt(l)`` with its ``.array``
class, enough to input public values, compute and open the result. A
secure array holds a ``PrimeFieldArray`` share: logical shape before input
(``secint.array(values)`` of public values, the constant sharing), (m, ...)
party stacked after it. The operators of a secure array (-x, +, -, *, @,
<, <=, >, >=, ==, !=, indexing; the comparisons give secure 0/1 arrays)
call the runtime whose ``SecInt`` made its type (``bind``). A type's
``bit_length`` may be reassigned; comparisons read it at call time.
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
            value = self.sectype.field.array(value, self.device)
        if value is not None:
            shape = value.shape
        self.shape = tuple(shape) if shape is not None else None
        super().__init__(value)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __getitem__(self, idx):
        return self.runtime.np_getitem(self, idx)

    # arithmetic and comparison, forwarded to the runtime; public operands
    # (ints, integer arrays) pass as they are, and the runtime encodes them.
    # Arrays of a type that no runtime made (SecInt(l, device)) have none.

    def _coerce(self, other):
        if isinstance(other, SecureArray):
            return other if type(other) is type(self) else NotImplemented
        if isinstance(other, (int, np.integer, list, tuple, np.ndarray)):
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


def bind(secint: type, runtime) -> type:
    """A subtype of secint whose arrays' operators call ``runtime``."""
    sub = type(secint.__name__, (secint,), {'__slots__': ()})
    sub.array = type(secint.array.__name__, (secint.array,), {
        '__slots__': (), 'sectype': sub, 'runtime': runtime})
    return sub
