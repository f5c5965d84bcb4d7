"""The MPC runtime's user surface: secure multiplication and comparison.

Port of the part of ``mpyc_tpu/runtime.py`` that the port's slices need:
``input``, ``SecInt``, ``start`` and ``shutdown``; the local share
arithmetic ``add``, ``sub``, ``neg`` (public operands broadcast as the
constant polynomial); ``np_multiply``; and the comparison surface
``np_less``, ``np_equal``, ``np_minimum``, ``np_maximum``,
``np_absolute`` on top of ``np_sgn``. The co-located plane
(``parallel/simulator.py``) adds the protocol steps ``_distribute``,
``mul``, ``np_sgn`` and ``output``, and the share bookkeeping ``_share``,
``_share2`` and ``_wrap``.
"""

from __future__ import annotations

import time

import numpy as np

from mpyc_tpu_torch import resolve_device, sectypes


class Party:
    """One party of the computation."""

    __slots__ = ('pid',)

    def __init__(self, pid: int):
        self.pid = pid


class Runtime:
    """MPC runtime for m parties holding Shamir shares over GF(p), with
    threshold t = (m - 1) // 2 and statistical security parameter k = 30
    (``sec_param``), the JAX package's defaults.

    ``device``: where shares live (default: the card)."""

    def __init__(self, m: int, device=None):
        self.parties = [Party(i) for i in range(m)]
        self.threshold = (m - 1) // 2
        self.sec_param = sectypes._SEC_PARAM
        self.device = resolve_device(device)
        self.start_time = None
        self._secints = {}

    def start(self):
        self.start_time = time.time()

    def shutdown(self):
        self.start_time = None

    def SecInt(self, l: int = 32) -> type:
        """Secure l-bit integers on this runtime's device, whose arrays'
        operators call this runtime."""
        secint = self._secints.get(l)
        if secint is None:
            secint = self._secints[l] = sectypes.bind(
                sectypes.SecInt(l, self.device), self)
        return secint

    def input(self, x, senders=None):
        """Input x; every sender Shamir-splits it. Returns one secure object
        (or list) per sender, or one if ``senders`` is an int."""
        x_is_list = isinstance(x, list)
        xl = list(x) if x_is_list else [x]
        senders_is_int = isinstance(senders, int)
        if senders is None:
            senders = range(len(self.parties))
        senders = [senders] if senders_is_int else list(senders)
        y = self._distribute(xl, senders)
        if senders_is_int:
            y = y[0]
            if not x_is_list:
                y = y[0]
        elif not x_is_list:
            y = [a[0] for a in y]
        return y

    # -- local arithmetic (no communication) --------------------------------

    @staticmethod
    def _sectype(*xs) -> type:
        """The secure array type of the operands (the first one wins)."""
        for x in xs:
            if isinstance(x, sectypes.SecureArray):
                return type(x)
        raise TypeError('no secure operand')

    @staticmethod
    def _coerce_op(stype, x):
        """A secure array of type stype as it is; a public int or integer
        array as an un-input secure array of its values."""
        if isinstance(x, sectypes.SecureArray):
            if type(x) is not stype:
                raise TypeError('secure operands of different types')
            return x
        return stype(np.asarray(x))

    def add(self, a, b):
        """Secure elementwise a + b (either may be public)."""
        stype = self._sectype(a, b)
        sa, sb = self._share2(self._coerce_op(stype, a),
                              self._coerce_op(stype, b))
        return self._wrap(stype, sa + sb)

    def sub(self, a, b):
        """Secure elementwise a - b (either may be public)."""
        stype = self._sectype(a, b)
        sa, sb = self._share2(self._coerce_op(stype, a),
                              self._coerce_op(stype, b))
        return self._wrap(stype, sa - sb)

    def neg(self, a):
        """Secure elementwise -a."""
        return self._wrap(self._sectype(a), -self._share(a))

    def np_add(self, a, b):
        return self.add(a, b)

    def np_subtract(self, a, b):
        return self.sub(a, b)

    def np_multiply(self, a, b):
        """Elementwise secure product (b may be public: a local scale)."""
        return self.mul(a, b)

    # -- comparison (np_sgn: the co-located plane's fused step, K5) ----------

    def sgn(self, a, l=None, LT=False, EQ=False):
        """Secure signum of a secure integer array (LT: a < 0, EQ: a == 0)."""
        return self.np_sgn(a, l=l, LT=LT, EQ=EQ)

    def np_less(self, a, b):
        """Secure elementwise a < b, as 0/1 (a - b must fit l bits)."""
        return self.np_sgn(self.sub(a, b), LT=True)

    def lt(self, a, b):
        return self.np_less(a, b)

    def np_equal(self, a, b):
        """Secure elementwise a == b, as 0/1."""
        d = self.sub(a, b)
        stype = self._sectype(d)
        if stype.bit_length / 2 > self.sec_param >= 8 and \
                stype.field.modulus % 4 == 3:
            # the JAX package takes the [NO07] probabilistic zero test
            # (_np_is_zero) here; the port has no counterpart yet
            raise NotImplementedError(
                f'np_equal for SecInt({stype.bit_length}): the [NO07] zero '
                'test is not ported')
        return self.np_sgn(d, EQ=True)

    def np_minimum(self, a, b):
        """Secure elementwise minimum."""
        c = self.np_less(a, b)
        return self.add(b, self.mul(c, self.sub(a, b)))

    def np_maximum(self, a, b):
        """Secure elementwise maximum."""
        c = self.np_less(a, b)
        return self.add(a, self.mul(c, self.sub(b, a)))

    def np_absolute(self, a, l=None):
        """Secure elementwise |a|."""
        return self.mul(self.np_sgn(a, l=l, LT=True) * -2 + 1, a)
