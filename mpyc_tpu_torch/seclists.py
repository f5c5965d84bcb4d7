"""Secure lists: lists of secure numbers read and written at secret
indices.

The port's counterpart of ``mpyc_tpu/seclists.py`` (``seclist``,
``secindex``). An index may be public (an int or a slice: plain list
access) or secret: a secure number, or a ``secindex`` (a unit vector
with an offset). A secret index becomes a unit vector u of the list's
length (``Runtime.unit_vector``: one batched zero test), a read is the
inner product of the list with u (one reshare round), a write adds u
times (value - old value) to every entry, an insertion or deletion
shifts the entries past the index by a prefix sum of u, so that the
access pattern says nothing of the index. Searches (``find``, ``index``,
``count``, ``contains``) and the lexicographic comparisons give secure
results; ``remove`` and ``index`` make public only whether the value
occurs.

The list's secure type is bound to a runtime (``Runtime.SecInt``,
``Runtime.SecFxp``, ``Runtime.SecFld``), whose operations it calls.
"""

from __future__ import annotations

from mpyc_tpu_torch import random as _random
from mpyc_tpu_torch import sectypes


class secindex:
    """A secure index: a unit vector (a list of secure 0/1 numbers) with a
    public offset, or a secure number expanded against a length when used
    (``mpyc_tpu/seclists.py:15``)."""

    __slots__ = ('value', 'offset', 'sectype', '_num')

    def __init__(self, *args, offset=0, sectype=None):
        self._num = None
        if sectype is not None:
            self.value = list(*args) if args else []
            self.sectype = sectype
        else:
            x = args[0]
            if isinstance(x, secindex):
                self.value = list(x.value) if x.value is not None else None
                self._num = x._num
                self.sectype = x.sectype
                offset += x.offset
            elif isinstance(x, sectypes.SecureNumber):
                self.sectype = type(x)
                self.value = None    # expanded against a length when used
                self._num = x
            elif isinstance(x, (list, tuple)):
                xs = seclist(x)
                self.sectype = xs.sectype
                self.value = list(xs)
            else:
                raise TypeError('secindex expects a unit vector or a '
                                'secure number')
        self.offset = offset

    def __add__(self, other):
        """An offset added (an int), or the index of the sum of two unit
        vectors' indices, expanded again (``mpyc_tpu/seclists.py:56``)."""
        if isinstance(other, int):
            return secindex(self, offset=other)
        if isinstance(other, secindex):
            runtime = self.sectype.runtime
            sv, ov = self.value, other.value
            i = runtime.sum([sv[k] * k for k in range(1, len(sv))]) \
                if len(sv) > 1 else self.sectype(0)
            j = runtime.sum([ov[k] * k for k in range(1, len(ov))]) \
                if len(ov) > 1 else other.sectype(0)
            u = runtime.unit_vector(i + j, len(sv) + len(ov) - 1)
            return secindex(u, sectype=self.sectype,
                            offset=self.offset + other.offset)
        return NotImplemented

    __radd__ = __add__

    @staticmethod
    def random(sectype, length: int, offset: int = 0) -> 'secindex':
        """A uniformly random secure index over range(offset, offset +
        length) (``mpyc_tpu/seclists.py:76``)."""
        return secindex(_random.random_unit_vector(sectype, length),
                        sectype=sectype, offset=offset)


def _unit(i, n: int) -> list:
    """The unit vector (a list of n secure 0/1 numbers) of a secret index
    i over a list of length n (``mpyc_tpu/seclists.py:84``)."""
    if isinstance(i, secindex):
        runtime = i.sectype.runtime
        u = list(i.value) if i.value else \
            runtime.unit_vector(i._num, n - i.offset)
        zero = type(u[0])(0)
        u = [zero] * i.offset + u
        return u + [zero] * (n - len(u))
    if isinstance(i, sectypes.SecureNumber):
        return type(i).runtime.unit_vector(i, n)
    if isinstance(i, (list, tuple)):
        u = list(i)
        if len(u) != n:
            raise IndexError('inconsistent index length')
        return u
    raise TypeError('secret index expected')


class seclist(list):
    """A list of secure numbers of one secure type, read and written at
    public or secret indices (``mpyc_tpu/seclists.py:106``)."""

    sectype = None

    def __init__(self, x=(), sectype=None):
        super().__init__(x)
        for a in self:
            if isinstance(a, sectypes.SecureObject):
                if sectype is None:
                    sectype = type(a)
                elif not isinstance(a, sectype):
                    raise TypeError('inconsistent sectypes')
        if sectype is None:
            raise ValueError('sectype missing')
        self.sectype = sectype
        for j, a in enumerate(self):
            if not isinstance(a, sectypes.SecureObject):
                super().__setitem__(j, sectype(a))

    @property
    def runtime(self):
        return self.sectype.runtime

    def _coerce_value(self, value):
        return value if isinstance(value, sectypes.SecureObject) else \
            self.sectype(value)

    # -- reads ---------------------------------------------------------------

    def __getitem__(self, key):
        """Public ints and slices as a list's; a secret index by the inner
        product with its unit vector."""
        if isinstance(key, (int, slice)):
            r = super().__getitem__(key)
            return seclist(r, sectype=self.sectype) \
                if isinstance(key, slice) else r
        u = _unit(key, len(self))
        return self.runtime.in_prod(list(self), u)

    # -- writes --------------------------------------------------------------

    def __setitem__(self, key, value):
        """Public ints and slices as a list's; at a secret index i every
        entry j gains u_j (value - x_i), u the unit vector of i."""
        if isinstance(key, (int, slice)):
            if isinstance(key, slice):
                if isinstance(value, seclist) and \
                        not issubclass(value.sectype, self.sectype):
                    raise TypeError('inconsistent sectypes')
                value = [self._coerce_value(v) for v in value]
            else:
                value = self._coerce_value(value)
            super().__setitem__(key, value)
            return
        runtime = self.runtime
        value = self._coerce_value(value)
        u = _unit(key, len(self))
        x_u = runtime.in_prod(list(self), u)
        d = runtime.scalar_mul(value - x_u, u)
        for j in range(len(self)):
            super().__setitem__(j, super().__getitem__(j) + d[j])

    def append(self, value):
        super().append(self._coerce_value(value))

    def extend(self, values):
        for v in values:
            self.append(v)

    def insert(self, key, value):
        """value inserted before the (possibly secret) index key: entry j
        of the new list is old[j] before the index, value at it and
        old[j - 1] after it, selected by u and its prefix sums z
        (``mpyc_tpu/seclists.py:176``)."""
        value = self._coerce_value(value)
        if isinstance(key, int):
            super().insert(key, value)
            return
        runtime = self.runtime
        n = len(self)
        u = _unit(key, n + 1)
        z = []
        acc = None
        for j in range(n + 1):
            acc = u[j] if acc is None else acc + u[j]
            z.append(acc)
        zero = self.sectype(0)
        old = list(self) + [zero]
        prev = [zero] + list(self)
        new = [old[j] + runtime.mul(z[j], prev[j] - old[j])
               + runtime.mul(u[j], value - prev[j]) for j in range(n + 1)]
        super().__init__(new)

    def delete(self, key):
        """The entry at the (possibly secret) index key removed: from the
        index on, each entry takes the next one's value
        (``mpyc_tpu/seclists.py:203``)."""
        if isinstance(key, (int, slice)):
            super().__delitem__(key)
            return
        runtime = self.runtime
        n = len(self)
        u = _unit(key, n)
        z = []
        acc = None
        for j in range(n):
            acc = u[j] if acc is None else acc + u[j]
            z.append(acc)
        new = [runtime.if_else(z[j], super(seclist, self).__getitem__(j + 1),
                               super(seclist, self).__getitem__(j))
               for j in range(n - 1)]
        super().__init__(new)

    def __delitem__(self, key):
        self.delete(key)

    def pop(self, key=-1):
        """Remove and return the entry at the (possibly secret) index."""
        if isinstance(key, int):
            return super().pop(key)
        r = self[key]
        self.delete(key)
        return r

    # -- the rest ------------------------------------------------------------

    def sort(self, key=None, reverse=False):
        """Sorted in place, obliviously (``Runtime.sorted``: Batcher's
        merge-exchange network)."""
        if len(self) < 2:
            return
        super().__init__(self.runtime.sorted(list(self), key=key,
                                             reverse=reverse))

    def copy(self):
        return seclist(list(self), sectype=self.sectype)

    def count(self, value):
        """The secure number of entries equal to value."""
        value = self._coerce_value(value)
        return self.runtime.sum([self.runtime.eq(a, value) for a in self])

    def contains(self, item):
        """Secure 0/1: whether item occurs (``in`` would have to be a
        public bool)."""
        return self.count(item) != 0

    def find(self, value):
        """The secure index of the first entry equal to value, or -1
        (``Runtime.find``)."""
        if not self:
            return self.sectype(-1)
        value = self._coerce_value(value)
        return self.runtime.find(list(self), value, bits=False, e=-1)

    def remove(self, value):
        """The first entry equal to value removed; ValueError where there
        is none, which is made public."""
        i = self.find(value)
        if self.runtime.eq_public(i, -1):
            raise ValueError('value is not in list')
        self.delete(i)

    def index(self, value):
        """The secure index of the first entry equal to value; ValueError
        where there is none (``Runtime.indexOf``)."""
        value = self._coerce_value(value)
        return self.runtime.indexOf(list(self), value, bits=False)

    def __contains__(self, item):
        """Not supported: Python makes ``in`` a public bool; use
        ``contains`` for a secure one."""
        raise NotImplementedError('use seclist.contains()')

    def __add__(self, other):
        if isinstance(other, seclist) and other.sectype != self.sectype:
            raise TypeError('inconsistent sectypes')
        out = seclist(self, sectype=self.sectype)
        out.extend(other)
        return out

    def __radd__(self, other):
        return seclist(list(other) + list(self), self.sectype)

    def __iadd__(self, other):
        self.extend(other)
        return self

    def __mul__(self, other):
        return seclist(list(self) * other, self.sectype)

    __rmul__ = __mul__

    def __imul__(self, other):
        super().__init__(list(self) * other)
        return self

    def __lt__(self, other):
        """Lexicographic secure comparison: the first differing entry
        decides, and a proper prefix is less."""
        runtime = self.runtime
        n = min(len(self), len(other))
        lt = eq = None
        for j in range(n):
            a, b = self[j], self._coerce_value(other[j])
            l_j, e_j = runtime.lt(a, b), runtime.eq(a, b)
            if lt is None:
                lt, eq = l_j, e_j
            else:
                lt = lt + runtime.mul(eq, l_j)
                eq = runtime.mul(eq, e_j)
        if lt is None:
            lt, eq = self.sectype(0), self.sectype(1)
        if len(self) < len(other):
            lt = lt + eq
        return lt

    def __le__(self, other):
        o = other if isinstance(other, seclist) else \
            seclist(other, self.sectype)
        return 1 - o.__lt__(self)

    def __ge__(self, other):
        return 1 - self.__lt__(other)

    def __gt__(self, other):
        o = other if isinstance(other, seclist) else \
            seclist(other, self.sectype)
        return o.__lt__(self)

    def __eq__(self, other):
        if len(self) != len(other):
            return self.sectype(0)
        return self.runtime.all([a == self._coerce_value(b)
                                 for a, b in zip(self, other)])

    def __ne__(self, other):
        return 1 - self.__eq__(other)

    __hash__ = None
