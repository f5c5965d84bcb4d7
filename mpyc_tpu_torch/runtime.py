"""The MPC runtime's user surface: secure multiplication and comparison.

Port of the part of ``mpyc_tpu/runtime.py`` that the port's slices need:
``input``, ``SecInt``, ``SecFxp``, ``start``, ``shutdown``, ``run``,
``barrier`` and ``gather``; the local share arithmetic ``add``, ``sub``,
``neg`` (public operands broadcast as the constant polynomial);
``np_multiply``; division (``div``: a secure divisor's reciprocal, a
public divisor's inverse); the comparison surface ``np_less``,
``np_equal``, ``is_zero``, ``np_minimum``, ``np_maximum``,
``np_absolute`` on top of ``np_sgn``, and for wide integers [NO07]'s
probabilistic zero test (``_np_is_zero``); ``np_all`` and ``all``;
``np_where``; ``np_argmax`` and ``np_argmin``, with comparison keys of
one or more components; the local shape operations (``np_reshape``, C
or Fortran order, ``np_transpose``, ``np_swapaxes``, ``np_expand_dims``,
``np_concatenate``, ``np_stack``, ``np_column_stack``, ``np_append``;
public numpy and field-array operands enter as constant sharings);
``np_outer``; the PRSS keys' PRFs (``prfs``) and program counter
(``_prss_uci``); secure truncation (``trunc``, ``np_trunc``); and for
secure binary fields (``SecFld``) ``pow``/``np_pow`` (AES's addition
chain for x^254), ``np_to_bits``, ``np_from_bits``, ``np_roll``,
``np_split``/``np_hsplit`` and ``np_update``.
The co-located plane (``parallel/simulator.py``) adds the protocol steps
``_distribute``, ``mul``, ``np_matmul``, ``np_sgn``, ``_reshare``,
``output``, ``reciprocal``, the PRSS draws ``_np_randoms`` and
``np_random_bits`` and the truncation round ``_trunc_field``, the local
``np_getitem``, ``np_sum``, ``np_fromlist`` and ``np_tolist``, and the
share bookkeeping ``_share``, ``_share2``, ``_local`` and ``_wrap``.

Secure scalars (``SecureNumber``) come out of whatever gives a 0-d
result without an array operand, as in the JAX package: indexing down to
one element, products and sums of scalars, ``np_all`` over everything;
a matrix product always gives an array.

Fixed-point arrays (``SecFxp``) keep an ``integral`` flag through every
operation, as the JAX package does: a sum or a shape operation is
integral where all its operands are, a comparison always; a product by an
integral operand is exact (a division by 2^f before the reshare), any
other product of fixed-point values is truncated.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from mpyc_tpu_torch import finfields, resolve_device, sectypes, thresha


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
        self._secfxps = {}
        # PRSS: one key per (m - t)-subset of the parties (the co-located
        # plane holds them all) and the program counter, whose every
        # increment names one PRSS draw
        self._prss_keys = {}
        self._program_counter = [0]
        self._prfs = {}

    def start(self):
        self.start_time = time.time()

    def shutdown(self):
        self.start_time = None

    @staticmethod
    def run(obj):
        """The result of a computation: the port's runtime computes
        eagerly, so it is obj itself (the JAX package's ``run`` awaits
        it)."""
        return obj

    def barrier(self, name=None):
        """Synchronisation point of the parties: nothing to wait for when
        one process plays them all."""

    def gather(self, *obj):
        """The local shares of secure objects (lists and tuples walked)."""
        def g(x):
            if isinstance(x, sectypes.SecureObject):
                return self._share(x)
            if isinstance(x, (list, tuple)):
                return type(x)(map(g, x))
            return x
        if len(obj) == 1:
            return g(obj[0])
        return tuple(map(g, obj))

    def SecInt(self, l: int = 32, p: int = None, n: int = 2) -> type:
        """Secure l-bit integers on this runtime's device (over GF(p), by
        default the JAX package's field for l with a root of unity of
        order at least n: ``sectypes.SecInt``), whose numbers' and arrays'
        operators call this runtime."""
        key = (l, p, n)
        secint = self._secints.get(key)
        if secint is None:
            secint = self._secints[key] = sectypes.bind(
                sectypes.SecInt(l, self.device, p=p, n=n), self)
        return secint

    def SecFxp(self, l: int = 32, f: int = None) -> type:
        """Secure l-bit fixed-point numbers with f fractional bits
        (default l // 2) on this runtime's device, whose arrays' operators
        call this runtime."""
        f = l // 2 if f is None else f
        secfxp = self._secfxps.get((l, f))
        if secfxp is None:
            secfxp = self._secfxps[l, f] = sectypes.bind(
                sectypes.SecFxp(l, f, self.device), self)
        return secfxp

    def SecFld(self, order=None, modulus=None) -> type:
        """Secure elements of a binary field GF(2^d) on this runtime's
        device, in the extension GF(4) for GF(2) at t > 0 and m = 3
        (``sectypes.SecFld``), whose operators call this runtime."""
        key = ('fld', order, str(modulus))
        secfld = self._secints.get(key)
        if secfld is None:
            secfld = self._secints[key] = sectypes.bind(sectypes.SecFld(
                order, modulus, len(self.parties), self.threshold,
                self.device), self)
        return secfld

    def prfs(self, bound: int) -> dict:
        """Map from party subsets to PRFs with codomain range(bound)
        (``mpyc_tpu/runtime.py:232``)."""
        res = self._prfs.get(bound)
        if res is None:
            res = self._prfs[bound] = {
                S: thresha.DevicePRF(key, bound)
                for S, key in self._prss_keys.items()}
        return res

    def _prss_uci(self) -> bytes:
        """Unique common input of a PRSS draw: the program counter, first
        incremented (``mpyc_tpu/runtime.py:237``)."""
        self._program_counter[0] += 1
        return self._program_counter[0].to_bytes(8, 'little', signed=True)

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
        """The secure array type of the operands (the first secure one
        wins; a secure number's is its type's array class)."""
        for x in xs:
            if isinstance(x, sectypes.SecureArray):
                return type(x)
            if isinstance(x, sectypes.SecureNumber):
                return type(x).array
        raise TypeError('no secure operand')

    @staticmethod
    def _is_array_op(*xs) -> bool:
        """Whether a secure array is among the operands: the result of an
        operation of secure numbers and public values is a number."""
        return any(isinstance(x, sectypes.SecureArray) for x in xs)

    @staticmethod
    def _integral(x) -> bool:
        """Whether x is known to hold integers: a fixed-point array by its
        flag, any other secure array always, a public value by its values
        (a float array never, as in the JAX package: its products get a
        proper truncation)."""
        if isinstance(x, (sectypes.SecureFixedPointArray,
                          sectypes.SecureFixedPoint)):
            return bool(x.integral)
        if isinstance(x, sectypes.SecureObject):
            return True
        if isinstance(x, (float, np.floating)):
            return float(x).is_integer()
        if isinstance(x, np.ndarray):
            if x.dtype.kind == 'f':
                return False
            if x.dtype == object:
                return sectypes._all_integral(x)
        if isinstance(x, (list, tuple)):
            return all(Runtime._integral(v) for v in x)
        return True

    def _coerce_op(self, stype, x):
        """A secure object of array type stype (an array or one of its
        numbers) as it is; a public int or integer array as an un-input
        secure array of its values, a field array of its field as an
        un-input secure array holding it."""
        if isinstance(x, sectypes.SecureObject):
            if self._sectype(x) is not stype:
                raise TypeError('secure operands of different types')
            return x
        if isinstance(x, finfields.FieldArray):
            return stype(x)
        if isinstance(x, finfields.FieldElement):
            return stype(np.array(x.value, dtype=object))
        return stype(np.asarray(x))

    def add(self, a, b):
        """Secure elementwise a + b (either may be public)."""
        stype = self._sectype(a, b)
        a, b = self._coerce_op(stype, a), self._coerce_op(stype, b)
        sa, sb = self._share2(a, b)
        return self._wrap(stype, sa + sb,
                          self._integral(a) and self._integral(b),
                          self._is_array_op(a, b))

    def sub(self, a, b):
        """Secure elementwise a - b (either may be public)."""
        stype = self._sectype(a, b)
        a, b = self._coerce_op(stype, a), self._coerce_op(stype, b)
        sa, sb = self._share2(a, b)
        return self._wrap(stype, sa - sb,
                          self._integral(a) and self._integral(b),
                          self._is_array_op(a, b))

    def neg(self, a):
        """Secure elementwise -a."""
        return self._wrap(self._sectype(a), -self._share(a),
                          self._integral(a), self._is_array_op(a))

    def np_add(self, a, b):
        return self.add(a, b)

    def np_subtract(self, a, b):
        return self.sub(a, b)

    def np_multiply(self, a, b):
        """Elementwise secure product (b may be public: a local scale)."""
        return self.mul(a, b)

    def pow(self, a, b: int):
        """Secure a ** b for a public int b >= 1 (``mpyc_tpu/runtime.py:
        1540``): AES's addition chain for b = 254 (11 products in 9
        rounds), else square and multiply, every product a secure one."""
        if b == 254:
            d = a
            c = self.mul(d, d)
            c = self.mul(c, c)
            c = self.mul(c, c)
            c = self.mul(c, d)
            c = self.mul(c, c)
            c, d = self.mul(c, c), self.mul(c, d)
            c, d = self.mul(c, c), self.mul(c, d)
            c = self.mul(c, d)
            c = self.mul(c, c)
            return c
        if b < 1:
            raise NotImplementedError('the port takes exponents of 1 or '
                                      'more')
        res = None
        d = a
        for i in range(b.bit_length()):
            if (b >> i) & 1:
                res = d if res is None else self.mul(res, d)
            if i < b.bit_length() - 1:
                d = self.mul(d, d)
        return res

    def np_pow(self, a, b):
        """Elementwise a ** b for a secure a and a public int b
        (``mpyc_tpu/runtime.py:2010``)."""
        if not isinstance(b, (int, np.integer)):
            raise NotImplementedError('the port takes public int exponents')
        if b == 2:
            return self.mul(a, a)
        return self.pow(a, int(b))

    def div(self, a, b):
        """Secure a / b (``mpyc_tpu/runtime.py:1597``). A secure divisor
        of an integer type is a product by its secure reciprocal; a public
        divisor (int or integer array) of an integer type a local product
        by its inverse mod p; a public divisor of a fixed-point type a
        product by 1 / b. Fixed-point secure divisors (the JAX package's
        Newton iteration ``_rec``) are not ported."""
        stype = self._sectype(a, b)
        f = stype.sectype.frac_length
        if isinstance(b, sectypes.SecureObject):
            if f:
                raise NotImplementedError('division by a secure '
                                          'fixed-point value is not ported')
            return self.mul(self.reciprocal(b), a)
        if f:
            if isinstance(b, (list, tuple, np.ndarray)):
                c = np.vectorize(lambda v: 1 / v, otypes=[object])(
                    np.asarray(b, dtype=object))
            else:
                c = 1 / b
                if c.is_integer():
                    c = round(c)
            return self.mul(a, c)
        field = stype.field
        inv = np.vectorize(lambda v: pow(int(v), -1, field.modulus),
                           otypes=[object])(np.asarray(b, dtype=object))
        c = field.array(inv, stype.device)
        return self._wrap(stype, self._share(a) * c, False,
                          self._is_array_op(a))

    # -- bits of binary field elements ----------------------------------------

    def np_to_bits(self, a, l=None):
        """Secure bits of the elements of a secure binary-field array:
        shape a.shape + (l,), l the field's degree by default
        (``mpyc_tpu/runtime.py:3299``, ``_np_to_bits_char2`` :3316). PRSS
        random bits r_j (``np_random_bits``), r = sum_j r_j x^j, c = a + r
        opened, and bit j of a is r_j + c_j, with c's public bits c_j
        extracted on the device. Prime fields' bits are not ported."""
        stype = self._sectype(a)
        field = stype.field
        if field.characteristic != 2:
            raise NotImplementedError('the port takes the bits of binary '
                                      'field elements only')
        l = stype.sectype.bit_length if l is None else l
        shape = tuple(a.shape)
        n = math.prod(shape)
        m = len(self.parties)
        r_bits = self.np_random_bits(field, n * l).reshape(m, n, l)
        r_modl = self._dot_pow2_last(r_bits)
        c = self.output(self._share(a).reshape(m, n) + r_modl)
        d = c.data.reshape(-1)
        c_bits = torch.stack([(d >> i) & 1 for i in range(l)], dim=-1)
        out = r_bits + field.array.from_data(c_bits.unsqueeze(-1))
        return self._wrap(stype, out.reshape((m,) + shape + (l,)), True)

    def np_from_bits(self, x):
        """Secure numbers of secure bits along the last axis, bit j times
        2^j (x^j in a binary field; ``mpyc_tpu/runtime.py:3425``)."""
        stype = self._sectype(x)
        acc = self._dot_pow2_last(self._share(x))
        return self._wrap(stype, acc, True, bool(acc.shape[1:]))

    @staticmethod
    def _dot_pow2_last(u):
        """sum_j u[..., j] 2^j over the last logical axis of party-stacked
        field shares: one local product by the public weights and a sum
        (``mpyc_tpu/runtime.py:4143``)."""
        field = u.field
        n = u.shape[-1]
        w = [1 << j for j in range(n)]
        if field.characteristic != 2:
            w = [v % field.modulus for v in w]
        w = field.array(np.array(w, dtype=object), u.device)
        prod = u * w
        return prod.from_data(prod.ctx.sum(prod.data, prod.data.dim() - 2))

    # -- truncation -----------------------------------------------------------

    def trunc(self, x, f=None, l=None):
        """Secure truncation of the f (default: the type's) least
        significant bits of secure arrays of l-bit values (default: the
        type's bit length, plus f for fixed point): floor(x / 2^f), or one
        more, with probability the f bits over 2^f
        (``mpyc_tpu/runtime.py:1663``). A list is truncated array by
        array, a round each, as the JAX package's co-located plane does
        (``mpyc_tpu/parallel/simulator.py:931``)."""
        if isinstance(x, list):
            return [self.np_trunc(xi, f, l) for xi in x]
        return self.np_trunc(x, f, l)

    def np_trunc(self, a, f=None, l=None):
        """Elementwise secure truncation of a secure array
        (``mpyc_tpu/runtime.py:1691``); see trunc."""
        stype = self._sectype(a)
        f, l = self._trunc_widths(stype, f, l)
        return self._wrap(stype, self._trunc_field(self._share(a), f, l),
                          False)

    @staticmethod
    def _trunc_widths(stype, f, l) -> tuple:
        """(f, l) of a truncation: by default the type's f and bit length,
        l plus f for fixed point."""
        f = stype.sectype.frac_length if f is None else f
        if l is None:
            l = stype.sectype.bit_length
            if issubclass(stype, sectypes.SecureFixedPointArray):
                l += f
        return f, l

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
        """Secure elementwise a == b, as 0/1 (``mpyc_tpu/runtime.py:2924``):
        is_zero of a - b."""
        return self.is_zero(self.sub(a, b))

    def is_zero(self, a):
        """Secure a == 0, as 0/1 (``mpyc_tpu/runtime.py:2934``): for bit
        lengths above twice the security parameter k (and k >= 8) on a
        Blum prime, [NO07]'s probabilistic test (``_np_is_zero``), else the
        comparison in EQ mode."""
        stype = self._sectype(a)
        if stype.sectype.bit_length / 2 > self.sec_param >= 8 and \
                stype.field.modulus % 4 == 3:
            return self._np_is_zero(a)
        return self.np_sgn(a, EQ=True)

    def _np_is_zero(self, a):
        """[NO07]'s zero test of every element of a (``mpyc_tpu/
        runtime.py:2944``), with k = sec_param trials an element, each
        with blinders of its own (no blinder is shared between elements):
        k random bits z, random r and r', and u = r'^2 reshared; open
        c = a r + (1 - 2 z) u at threshold 2t. For a = 0, c = +-u is a
        square exactly when z = 0; for a != 0, c is uniform. A trial gives
        1 - z where c is a square, z where it is not (Legendre symbols of
        the opened values, K6 on the card), 1 where c = 0; the result is
        the product of the k trials, in log depth. Wrong with probability
        about 2^-k for a != 0."""
        stype = self._sectype(a)
        field = stype.field
        shape = a.shape
        n = max(math.prod(shape), 1)
        k = self.sec_param
        m = len(self.parties)
        z = self.np_random_bits(field, k * n)
        r = self._np_randoms(field, k * n)
        u2 = self._reshare(r * r)
        r = self._np_randoms(field, k * n)
        a_sh = self._share(a).reshape(m, 1, n)
        z, r, u2 = (x.reshape(m, k, n) for x in (z, r, u2))
        c = a_sh * r + (1 - z * 2) * u2
        c = self.output(c, threshold=2 * self.threshold)    # public (k, n)
        ctx = field.array.ctx
        sq_f = field.array.from_data(ctx.encode_bits(
            ctx.legendre(c.data) >= 0))
        isz_f = field.array.from_data(ctx.encode_bits(ctx.is_zero(c.data)))
        cand = sq_f + z - (sq_f * z) * 2     # 1 - z where square, else z
        cand = cand * (1 - isz_f) + isz_f    # 1 where c = 0
        e = self._prod_last_axis(cand.from_data(cand.data.transpose(1, 2)))
        f = stype.sectype.frac_length
        if f:
            e = e << f
        e = e.reshape((m,) + tuple(shape))
        return self._wrap(stype, e, True, bool(shape))

    def _prod_last_axis(self, s):
        """Product along the last logical axis of party-stacked field
        shares, in log depth, each level a local product and one reshare
        round (``mpyc_tpu/runtime.py:2847``)."""
        while s.shape[-1] > 1:
            w = s.shape[-1]
            half = w // 2
            x = self._reshare(s[..., :half, :] * s[..., half:2 * half, :])
            if w % 2:
                x = x.from_data(torch.cat([x.data, s.data[..., 2 * half:, :]],
                                          dim=-2))
            s = x
        return s[..., 0, :]

    def np_all(self, a, axis=None):
        """Secure all() of 0/1 values over axes: their product, in log
        depth (``mpyc_tpu/runtime.py:2988``); a fixed-point array's values
        are brought to 0/1 (exactly: they are integral) and back."""
        stype = self._sectype(a)
        s = self._share(a)
        m = len(self.parties)
        f = stype.sectype.frac_length
        if f:
            s = s >> f
        nd = len(a.shape)
        if axis is None:
            s = s.reshape(m, -1)
        else:
            axes = (axis % nd,) if isinstance(axis, int) else \
                tuple(sorted(i % nd for i in axis))
            rest = [i for i in range(nd) if i not in axes]
            data = s.data.permute((0,) + tuple(i + 1 for i in rest + list(
                axes)) + (nd + 1,))
            s = s.from_data(data.reshape(
                (m,) + tuple(a.shape[i] for i in rest) + (-1, s.ctx.L)))
        out = self._prod_last_axis(s)
        if f:
            out = out << f
        return self._wrap(stype, out, True, bool(out.shape[1:]))

    def all(self, x):
        """Secure all() of a secure array, or of a list of secure 0/1
        numbers (``mpyc_tpu/runtime.py:3019``)."""
        if isinstance(x, sectypes.SecureArray):
            return self.np_all(x)
        x = list(x)
        if not x:
            return 1
        return self.np_all(self.np_fromlist(x))

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

    def np_where(self, c, a, b):
        """Secure selection c * a + (1 - c) * b for a secure 0/1 array c
        (numpy broadcasting): one secure product, c * (a - b) + b, as the
        JAX package computes it (``mpyc_tpu/runtime.py`` np_where)."""
        return self.add(self.mul(c, self.sub(a, b)), b)

    # -- shape operations (local) --------------------------------------------

    def np_reshape(self, a, shape, order='C'):
        """Secure array reshaped to ``shape`` (one -1 allowed), its values
        read and written in C order, or in Fortran order with order='F'
        (x.reshape(shape, 'F') is x.T.reshape(shape[::-1]).T)."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if order == 'F':
            a = self.np_transpose(self.np_reshape(self.np_transpose(a),
                                                  shape[::-1]))
            return a
        if order != 'C':
            raise ValueError(f'order {order!r}: C or F')
        return self._local(a, lambda d: d.reshape(
            d.shape[:1] + shape + d.shape[-1:]))

    def np_transpose(self, a, axes=None):
        """Secure array with its logical axes permuted (default: reversed)."""
        nd = len(a.shape)
        axes = tuple(range(nd))[::-1] if axes is None else \
            tuple(ax % nd for ax in axes)
        return self._local(a, lambda d: d.permute(
            (0,) + tuple(ax + 1 for ax in axes) + (nd + 1,)))

    def np_roll(self, a, shift, axis=None):
        """Secure circular shift along a logical axis, or of the flattened
        array (``mpyc_tpu/runtime.py:1832``), local."""
        if axis is None:
            return self.np_reshape(self.np_roll(self.np_reshape(a, -1),
                                                shift, 0), a.shape)
        nd = len(a.shape)
        return self._local(a, lambda d: torch.roll(d, shift, axis % nd + 1))

    def np_split(self, a, parts, axis=0):
        """The parts of a along an axis: ``parts`` equal ones, or cut at
        the given indices (``mpyc_tpu/runtime.py:2258``)."""
        n = a.shape[axis]
        if isinstance(parts, (int, np.integer)):
            if n % parts:
                raise ValueError('array split does not result in equal '
                                 'division')
            bounds = [(i * n // parts, (i + 1) * n // parts)
                      for i in range(parts)]
        else:
            edges = [0] + [int(i) for i in parts] + [n]
            bounds = list(zip(edges[:-1], edges[1:]))
        pre = (slice(None),) * (axis % len(a.shape))
        return [self.np_getitem(a, pre + (slice(i, j),)) for i, j in bounds]

    def np_hsplit(self, a, parts):
        return self.np_split(a, parts, axis=0 if len(a.shape) == 1 else 1)

    def np_update(self, a, idx, value):
        """a with a[idx] = value, a new secure array
        (``mpyc_tpu/runtime.py:3433``); value secure or public."""
        stype = self._sectype(a)
        share = self._share(a)
        v = self._share(self._coerce_op(stype, value)).data
        data = share.data.clone()
        idx = idx if isinstance(idx, tuple) else (idx,)
        target = data[(slice(None),) + idx]
        data[(slice(None),) + idx] = v.reshape(
            v.shape[:1] + (1,) * (target.dim() - v.dim()) + v.shape[1:]) \
            if v.dim() < target.dim() else v
        return self._wrap(stype, share.from_data(data),
                          self._integral(a) and self._integral(value))

    def np_swapaxes(self, a, i, j):
        nd = len(a.shape)
        return self._local(a, lambda d: d.transpose(i % nd + 1, j % nd + 1))

    def np_expand_dims(self, a, axis):
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        out_nd = len(a.shape) + len(axes)
        norm = [ax % out_nd for ax in axes]
        it = iter(a.shape)
        return self.np_reshape(a, tuple(1 if i in norm else next(it)
                                        for i in range(out_nd)))

    def _shares_of(self, arrays):
        """The type and party-stacked shares of secure arrays, public
        integer arrays and field arrays (constant sharings)."""
        stype = self._sectype(*arrays)
        return stype, [self._share(self._coerce_op(stype, x))
                       for x in arrays]

    def np_concatenate(self, arrays, axis=0):
        stype, shares = self._shares_of(arrays)
        nd = len(shares[0].shape) - 1
        data = torch.cat([s.data for s in shares], dim=axis % nd + 1)
        return self._wrap(stype, shares[0].from_data(data),
                          self._integral(list(arrays)))

    def np_stack(self, arrays, axis=0):
        stype, shares = self._shares_of(arrays)
        nd = len(shares[0].shape)             # logical ndim of the result
        data = torch.stack([s.data for s in shares], dim=axis % nd + 1)
        return self._wrap(stype, shares[0].from_data(data),
                          self._integral(list(arrays)))

    def np_column_stack(self, tup):
        """1-D arrays as columns, 2-D ones as they are, side by side
        (``mpyc_tpu/runtime.py:2253``)."""
        def col(x):
            if not isinstance(x, sectypes.SecureArray):
                x = np.asarray(x)
                return x.reshape(-1, 1) if x.ndim == 1 else x
            return self.np_reshape(x, (x.shape[0], 1)) if x.ndim == 1 else x
        return self.np_concatenate([col(x) for x in tup], axis=1)

    def np_append(self, a, b, axis=None):
        """a with b appended along axis, both flattened first without one
        (``mpyc_tpu/runtime.py:2212``)."""
        if axis is None:
            a, b = (self.np_reshape(x, (-1,))
                    if isinstance(x, sectypes.SecureArray)
                    else np.asarray(x).reshape(-1) for x in (a, b))
            axis = 0
        return self.np_concatenate([a, b], axis=axis)

    def np_outer(self, a, b):
        """Secure outer product of a and b, both flattened: one product
        round of the broadcast column and row (``mpyc_tpu/runtime.py:
        2453``); either may be public, or a secure number."""
        def col(x, shape):
            if isinstance(x, sectypes.SecureArray):
                return self.np_reshape(x, shape)
            if isinstance(x, sectypes.SecureNumber):
                return self.np_reshape(self.np_fromlist([x]), shape)
            return np.asarray(x).reshape(shape)
        ar, br = col(a, (-1, 1)), col(b, (1, -1))
        if isinstance(ar, sectypes.SecureArray):
            return self.mul(ar, br)
        return self.mul(br, ar)

    # -- arg extrema ---------------------------------------------------------

    def np_argmax(self, a, axis=None, keepdims=False, key=None,
                  arg_unary=False, arg_only=True):
        """Secure indices of the maximum values along an axis, the first
        occurrence on ties; unit vectors when arg_unary; with the maxima
        when not arg_only (``mpyc_tpu/runtime.py:3661``). ``key``: a class
        whose instances wrap secure arrays and compare with ``<``; with
        key.size = s > 1 the last axis of a holds the s components of each
        key and is kept in the maxima."""
        return self._np_argminmax(a, axis, keepdims, key, arg_unary,
                                  arg_only, is_min=False)

    def np_argmin(self, a, axis=None, keepdims=False, key=None,
                  arg_unary=False, arg_only=True):
        """Secure indices of the minimum values along an axis
        (``mpyc_tpu/runtime.py:3652``); see np_argmax."""
        return self._np_argminmax(a, axis, keepdims, key, arg_unary,
                                  arg_only, is_min=True)

    def _np_argminmax(self, a, axis, keepdims, key, arg_unary, arg_only,
                      is_min):
        """The reference's shape semantics (``mpyc_tpu/runtime.py:3668``
        ``_np_argminmax``): the axis goes last (before a key's component
        axis), the rest flattens into rows, and one odd-even tournament
        runs on every row at once."""
        ks = getattr(key, 'size', 1) if key is not None else 1
        if ks != 1 and ks != a.shape[-1]:
            raise ValueError(f'a key of {ks} components on an axis of '
                             f'{a.shape[-1]}')
        shape = a.shape
        ndim = len(shape) - (ks > 1)
        if axis is None:
            a = self.np_reshape(a, (1, a.size // ks) + ((ks,) if ks > 1
                                                        else ()))
        elif ks == 1:
            a = self.np_swapaxes(a, axis, -1)
            a = self.np_reshape(a, (-1, a.shape[-1]))
        else:
            if (axis + 1) % len(shape) == 0:
                raise ValueError('the key\'s component axis is no axis to '
                                 'reduce')
            a = self.np_swapaxes(a, axis, -2)
            a = self.np_reshape(a, (-1, a.shape[-2], ks))
        u, m = self._np_argext(a, is_min, key, ks)
        if not arg_unary:
            u = self.np_sum(self.mul(u, np.arange(u.shape[1])), axis=-1)
        if axis is None:
            if not arg_unary and keepdims:
                u = self.np_reshape(u, (1,) * ndim)
            else:
                u = self.np_getitem(u, 0)
        else:
            shape = list(shape)
            if ks > 1:
                del shape[-1]
            if arg_unary:
                shape[axis], shape[-1] = shape[-1], shape[axis]
            elif keepdims:
                shape[axis] = 1
            else:
                del shape[axis]
            u = self.np_reshape(u, tuple(shape))
            if arg_unary:
                u = self.np_swapaxes(u, axis, -1)
        if arg_only:
            return u
        if axis is None:
            m = self.np_reshape(m, (1,) * ndim) if keepdims else \
                self.np_getitem(m, (0, 0))
        elif keepdims:
            if arg_unary:
                shape[axis], shape[-1] = shape[-1], shape[axis]
                shape[axis] = 1
            if ks > 1:
                shape = shape + [ks]
            m = self.np_reshape(m, tuple(shape))
        return u, m

    def _np_argext(self, a, is_min, key=None, ks=1):
        """(unit vectors u, extrema m) along axis 1 of a 2D secure array
        (3D with a key's component axis last when ks > 1): neighbours
        (odd, even) are compared, by key(.) < key(.) when a key is given,
        the winners recurse, and u is unfolded level by level; pairing
        from the end makes the first occurrence win a tie
        (``mpyc_tpu/runtime.py:3734`` ``_np_argext``)."""
        stype = type(a)
        n = a.shape[1]
        if n == 1:
            ones = self._share(stype(np.ones(a.shape[:2], np.int64)))
            return self._wrap(stype, ones.from_data(
                ones.data.contiguous()), True), a
        n0 = n % 2
        a1 = self.np_getitem(a, (slice(None), slice(n0, None, 2)))
        a2 = self.np_getitem(a, (slice(None), slice(n0 + 1, None, 2)))
        if key is None:
            c = self.np_less(a2, a1) if is_min else self.np_less(a1, a2)
        else:
            c = key(a2) < key(a1) if is_min else key(a1) < key(a2)
        cc = c if ks == 1 else self.np_expand_dims(c, -1)
        m = self.add(self.mul(cc, self.sub(a2, a1)), a1)
        if n0:
            m = self.np_concatenate(
                [self.np_getitem(a, (slice(None), slice(0, 1))), m], axis=1)
        u, m = self._np_argext(m, is_min, key, ks)
        if n0:
            u0 = self.np_getitem(u, (slice(None), slice(0, 1)))
            u = self.np_getitem(u, (slice(None), slice(1, None)))
        u2 = self.mul(u, c)
        inter = self.np_stack([self.sub(u, u2), u2], axis=-1)
        u = self.np_reshape(inter, (inter.shape[0], 2 * u2.shape[1]))
        if n0:
            u = self.np_concatenate([u0, u], axis=1)
        return u, m
