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
(``_prss_uci``); secure truncation (``trunc``, ``np_trunc``); the bits
of secure numbers over prime and binary fields (``np_to_bits``,
``to_bits``: random bits, one opening, a carry-prefix adder over prime
fields), ``np_from_bits``; fixed-point division by a secure value
(Newton's reciprocal: ``_norm``, ``_rec``); secure unit vectors
(``np_unit_vector``); operations on lists of secure numbers
(``input_each``, ``sum``, ``prod``, ``scalar_mul``, ``vector_add``,
``vector_sub``, ``if_else``, ``min``, ``max``, ``abs``, ``in_prod``,
``matrix_prod``, ``matrix_add``); the aggregates
(``min_max``, ``argmin``/``argmax`` of lists with keys, ``if_swap``,
``sorted`` by Batcher's merge-exchange; over arrays ``np_prod``,
``np_amin``/``np_amax``, ``np_if_swap``, ``np_sort`` with every stage
one batched comparison, ``np_copy``, ``np_flatten``); for secure
binary fields (``SecFld``) ``pow``/``np_pow`` (AES's addition chain for
x^254), ``np_roll``, ``np_split``/``np_hsplit`` and ``np_update``; for
secure prime fields ``SecFld(p)`` (``min_order`` too) products, powers
(by 0 and negative exponents too) and the zero test by Fermat's little
theorem; and for secure lists and integer division the list
``unit_vector``, ``find``, ``indexOf``, ``eq``, ``eq_public``,
``from_bits``, ``random_bit``, ``lsb``/``np_lsb`` and ``mod`` (``%``,
``//`` and ``divmod`` by a public value: ``_mod``, ``_randbelow_bits``,
``_bits_lt_public``); and for linear algebra ``convert`` (secure
integers, fixed-point numbers and prime fields, ``_embed_field_values``)
and ``np_det`` (``_field_det_public``).
The co-located plane (``parallel/simulator.py``) adds the protocol steps
``_distribute``, ``mul``, ``np_matmul``, ``np_sgn``, ``_reshare``,
``output``, ``reciprocal``, ``is_zero_public``, the PRSS draws
``_np_randoms`` and ``np_random_bits`` (and their list forms
``_randoms``, ``_random``,
``random_bits``) and the truncation round ``_trunc_field``, the local
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
    threshold t (default (m - 1) // 2, as the JAX package's ``-T``
    defaults, ``mpyc_tpu/runtime.py:144-145``) and statistical security
    parameter k = 30 (``sec_param``), the JAX package's defaults.

    ``device``: where shares live (default: the card)."""

    def __init__(self, m: int, device=None, threshold=None):
        self.parties = [Party(i) for i in range(m)]
        # the party whose view a call returns: one process plays them all,
        # and the JAX package's co-located plane is party 0
        self.pid = 0
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
        self.threshold = (m - 1) // 2 if threshold is None else threshold

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

    def SecFld(self, order=None, modulus=None, char=None, ext_deg=None,
               min_order=None, signed=False) -> type:
        """Secure elements of a finite field on this runtime's device: a
        prime field GF(p), or a binary field GF(2^d), in the extension
        GF(4) for GF(2) at t > 0 and m = 3 (``sectypes.SecFld``, the JAX
        package's keywords: ``SecFld(min_order=10)`` is GF(11)), whose
        operators call this runtime."""
        key = ('fld', order, str(modulus), char, ext_deg, min_order,
               bool(signed))
        secfld = self._secints.get(key)
        if secfld is None:
            secfld = self._secints[key] = sectypes.bind(sectypes.SecFld(
                order, modulus, char, ext_deg, min_order, signed,
                m=len(self.parties), t=self.threshold, device=self.device),
                self)
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

    def convert(self, x, t_type):
        """Secure conversion of a secure number or array, or of a list of
        them, to the secure type t_type (``mpyc_tpu/runtime.py:1011``):
        between secure integers, fixed-point numbers and prime fields, one
        masked opening (``_convert``); from one secure field to another
        through a secure integer type wide enough for both. An array of
        one value converts as a secure number."""
        x_is_list = isinstance(x, list)
        xl = list(x) if x_is_list else [x]
        if not xl:
            return []
        xl = [self._wrap(type(xi), self._logical_reshape(self._share(xi),
                                                         ()),
                         self._integral(xi), array=False)
              if isinstance(xi, sectypes.SecureArray) and
              math.prod(xi.shape) == 1 else xi for xi in xl]
        s_ctype = getattr(type(xl[0]), 'sectype', type(xl[0]))
        t_ctype = getattr(t_type, 'sectype', t_type)
        if issubclass(s_ctype, sectypes.SecureFiniteField) and \
                issubclass(t_ctype, sectypes.SecureFiniteField):
            size = max(s_ctype.field.order, t_ctype.field.order)
            secint = self.SecInt(l=max(32, size.bit_length()))
            y = self._convert(self._convert(xl, secint), t_type)
        else:
            y = self._convert(xl, t_type)
        return y if x_is_list else y[0]

    @staticmethod
    def _embed_field_values(c, t_field):
        """A public array of a prime field -> the array of t_field with
        the same integer values (mod t_field's p), on its device
        (``mpyc_tpu/runtime.py:1033``): the source's standard-form limbs
        cut into chunks of the target's limb count and reduced there
        (``reduce_chunks``: K9's products and adds on the card)."""
        if c.field.characteristic == 2 or t_field.characteristic == 2:
            raise NotImplementedError('conversions of binary fields are '
                                      'not ported')
        s_ctx, t_ctx = c.ctx, t_field.array.ctx
        std = s_ctx.to_standard(c.data)
        nc = -(-s_ctx.L // t_ctx.L)
        pad = nc * t_ctx.L - s_ctx.L
        if pad:
            std = torch.cat([std, std.new_zeros(std.shape[:-1] + (pad,))],
                            dim=-1)
        wide = std.reshape(std.shape[:-1] + (nc, t_ctx.L))
        return t_field.array.from_data(t_ctx.reduce_chunks(wide))

    def np_det(self, A):
        """Secure determinant of a nonsingular secure square matrix
        (``mpyc_tpu/runtime.py:2501``): PRSS-random triangular L (unit
        diagonal) and U, redrawn until det U (the product of its diagonal)
        opens as nonzero in a zero test; L U A opened, its determinant
        computed in public (``_field_det_public``) and divided by the
        secure det U."""
        stype = self._sectype(A)
        field = stype.sectype.field
        n = A.shape[-1]
        while True:
            U = self._logical_reshape(self._np_randoms(field, n * n), (n, n))
            diag = U.from_data(torch.diagonal(U.data, dim1=1, dim2=2)
                               .movedim(-1, 1))            # (m, n, L)
            detU = self.prod([self._wrap(stype, diag.from_data(
                diag.data[:, i]), True, array=False) for i in range(n)])
            if not self.is_zero_public(detU):
                break
        low = torch.ones((n, n), dtype=torch.bool,
                         device=U.data.device).tril(-1)[..., None]
        eye = field.array(np.eye(n, dtype=object), self.device)
        zero = torch.zeros_like(U.data)
        L_ = self._wrap(stype, U.from_data(torch.where(low, U.data, zero))
                        + eye, True)
        U_ = self._wrap(stype, U.from_data(torch.where(low, zero, U.data)),
                        True)
        LUA = self.output(self.np_matmul(L_, self.np_matmul(U_, A)),
                          raw=True)
        return self.div(_field_det_public(field, LUA), detU)

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
        array = self._is_array_op(a, b)
        a, b = self._coerce_op(stype, a), self._coerce_op(stype, b)
        sa, sb = self._share2(a, b)
        return self._wrap(stype, sa + sb,
                          self._integral(a) and self._integral(b), array)

    def sub(self, a, b):
        """Secure elementwise a - b (either may be public)."""
        stype = self._sectype(a, b)
        array = self._is_array_op(a, b)
        a, b = self._coerce_op(stype, a), self._coerce_op(stype, b)
        sa, sb = self._share2(a, b)
        return self._wrap(stype, sa - sb,
                          self._integral(a) and self._integral(b), array)

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
        """Secure a ** b for a public int b (``mpyc_tpu/runtime.py:1540``):
        AES's addition chain for b = 254 (11 products in 9 rounds); b = 0
        the public 1; b < 0 the power -b of a's reciprocal (``_rec`` for
        fixed point, else ``reciprocal``); else square and multiply, every
        product a secure one."""
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
        if b == 0:
            stype = self._sectype(a)
            return stype(np.ones(a.shape, np.int64)) \
                if self._is_array_op(a) else stype.sectype(1)
        if b < 0:
            a = self._rec(a) if self._sectype(a).sectype.frac_length else \
                self.reciprocal(a)
            b = -b
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
        is a product by its secure reciprocal: for an integer type
        ``reciprocal``, for a fixed-point type Newton's iteration
        (``_rec``); a public divisor (int or integer array) of an integer
        type a local product by its inverse mod p; a public divisor of a
        fixed-point type a product by 1 / b."""
        stype = self._sectype(a, b)
        f = stype.sectype.frac_length
        if isinstance(b, sectypes.SecureObject):
            c = self._rec(b) if f else self.reciprocal(b)
            return self.mul(c, a)
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

    # -- bits --------------------------------------------------------------

    def to_bits(self, a, l=None):
        """Secure bits of a, least significant first, as a list of l
        secure numbers (of arrays, for an array a; ``mpyc_tpu/runtime.py:
        3260``)."""
        stype = self._sectype(a)
        if (stype.sectype.bit_length if l is None else l) == 0:
            return []
        arr = self.np_to_bits(a, l)
        return [self.np_getitem(arr, (Ellipsis, i))
                for i in range(arr.shape[-1])]

    def np_to_bits(self, a, l=None):
        """Secure bits of the elements of a secure array (or number),
        least significant first: shape a.shape + (l,), l the type's bit
        length by default (``mpyc_tpu/runtime.py:3279``).

        Prime fields (:3279-3338): l random bits r_j (``np_random_bits``)
        and a PRSS value r' below 2^(bit_length + k - l), c = a + 2^bit_length
        + 2^l r' - sum_j r_j 2^j opened, and the bits of a are those of
        c mod 2^l added to the r_j by a carry-prefix adder
        (``_np_add_bits_shares``). A fixed-point type's bits are fixed-point
        0/1 values (times 2^f); an integral fixed-point a is shifted down by
        f first, its f low bits 0.

        Binary fields (``_np_to_bits_char2`` :3316): bit j of a is r_j +
        c_j, c = a + sum_j r_j x^j opened, with c's public bits c_j
        extracted on the device."""
        stype = self._sectype(a)
        field = stype.field
        if field.characteristic != 2:
            return self._np_to_bits_prime(a, l)
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
    def _dot_public_last(u, weights):
        """sum_j u[..., j] w_j over the last logical axis of party-stacked
        field shares, for public weights w: one local product and a sum
        (``mpyc_tpu/runtime.py:4134``)."""
        field = u.field
        if field.characteristic != 2:
            weights = [v % field.modulus for v in weights]
        w = field.array(np.array(weights, dtype=object), u.device)
        prod = u * w
        return prod.from_data(prod.ctx.sum(prod.data, prod.data.dim() - 2))

    @staticmethod
    def _dot_pow2_last(u):
        """sum_j u[..., j] 2^j over the last logical axis (x^j in a binary
        field; ``mpyc_tpu/runtime.py:4143``)."""
        return Runtime._dot_public_last(u, [1 << j for j in
                                            range(u.shape[-1])])

    @staticmethod
    def _last(u, idx):
        """u[..., idx] along the last logical axis of field data (an int
        drops the axis, a slice keeps it)."""
        return u.from_data(u.data[..., idx, :])

    @staticmethod
    def _cat_last(parts):
        """Field arrays joined along their last logical axis."""
        return parts[0].from_data(torch.cat([x.data for x in parts], dim=-2))

    @staticmethod
    def _set_first(u, d: int, value: int):
        """u with its first d entries along the last logical axis set to
        the public value (a new array)."""
        data = u.data.clone()
        data[..., :d, :] = torch.tensor(u.ctx.encode_const(value),
                                        dtype=torch.int64).to(torch.int32)
        return u.from_data(data)

    def _np_to_bits_prime(self, a, l=None):
        """np_to_bits over a prime field (``mpyc_tpu/runtime.py:
        3279-3338``); see np_to_bits."""
        stype = self._sectype(a)
        sec = stype.sectype
        field = stype.field
        f = sec.frac_length
        l = sec.bit_length if l is None else l
        if l > sec.bit_length + f:
            raise ValueError(f'{l} bits of a {sec.bit_length + f}-bit type')
        shape = tuple(a.shape)
        m = len(self.parties)
        rshift_f = bool(f) and self._integral(a)
        l_eff = l
        if rshift_f:
            if f >= l:
                zero = stype(np.zeros(shape + (l,), np.int64))
                return self._wrap(stype, self._share(zero), True)
            l_eff = l - f
        n = max(math.prod(shape), 1)
        r_bits = self.np_random_bits(field, n * l_eff).reshape(m, n, l_eff)
        r_modl = self._dot_pow2_last(r_bits)
        r_divl = self._np_randoms(
            field, n, 1 << (sec.bit_length + self.sec_param - l_eff))
        a_sh = self._share(a).reshape(m, n)
        if rshift_f:
            a_sh = a_sh >> f
        c = self.output(a_sh + ((1 << sec.bit_length) + (r_divl << l_eff)
                                - r_modl))
        c_bits = c.mod_pow2(l_eff).to_bits_public(l_eff)
        a_bits = self._np_add_bits_shares(r_bits, c_bits)
        if f:
            a_bits = a_bits << f
        if rshift_f:
            a_bits = a_bits.from_data(torch.cat(
                [a_bits.data.new_zeros((m, n, f, a_bits.data.shape[-1])),
                 a_bits.data], dim=-2))
        return self._wrap(stype, a_bits.reshape((m,) + shape + (l,)), True)

    def _np_add_bits_shares(self, a_bits, c_bits):
        """Secure bits a (party-stacked (m, n, l)) plus the public bits c
        ((n, l) 0/1 integers), bit by bit with carries
        (``mpyc_tpu/runtime.py:3361``)."""
        c_f = a_bits.field.array.from_uint32(c_bits)
        return self._add_bits_prefix(a_bits, c_f)

    def _add_bits_prefix(self, x, y):
        """The bits of x + y (the carry out dropped) for bit arrays along
        the last logical axis, y possibly public: a carry-prefix network of
        log depth, each product of bits a reshare round (``_mul_bits``) in
        the JAX package's order (``mpyc_tpu/runtime.py:3371``)."""
        last, cat, mul_bits = self._last, self._cat_last, self._mul_bits

        def f(i, j, high=False):
            nn = j - i
            if nn == 1:
                x_i, y_i = last(x, slice(i, i + 1)), last(y, slice(i, i + 1))
                c = mul_bits(x_i, y_i)
                if high:
                    return c, x_i + y_i - c * 2
                return c
            h = i + nn // 2
            e1 = f(i, h, high=high)
            c2, d2 = f(h, j, high=True)
            c1 = e1[0] if high else e1
            c2 = c2 + mul_bits(last(c1, slice(-1, None)), d2)
            c = cat([c1, c2])
            if high:
                d1 = e1[1]
                return c, cat([d1, mul_bits(last(d1, slice(-1, None)), d2)])
            return c

        c = f(0, x.shape[-1])
        c_1 = self._set_first(c.from_data(torch.roll(c.data, 1, dims=-2)),
                              1, 0)
        return x + y - c * 2 + c_1

    def _mul_bits(self, u, v):
        """Product of bit arrays, reshared (``mpyc_tpu/runtime.py:3406``):
        one fused round (``_mul_reshared``)."""
        return self._mul_reshared(u, v)

    # -- normalisation and the reciprocal (fixed point) ----------------------

    def _prefix_mul_raw(self, s):
        """Inclusive prefix products along the last logical axis of
        party-stacked field shares of 0/1 values: ceil(log2 n) reshare
        rounds, Hillis-Steele (``mpyc_tpu/runtime.py:4148``)."""
        n = s.shape[-1]
        d = 1
        while d < n:
            shifted = self._set_first(
                s.from_data(torch.roll(s.data, d, dims=-2)), d, 1)
            s = self._mul_reshared(s, shifted)
            d *= 2
        return s

    def _norm(self, a):
        """Secure signed normalisation factor v of a fixed-point a, with
        a v in [1/2, 1) (``mpyc_tpu/runtime.py:4161``): a's bits
        (``np_to_bits``), the first bit from the top (below the sign) that
        differs from the sign's complement by a prefix product, its
        one-hot position u, v = (2 s - 1) sum_i u_i 2^i scaled to the
        type's 2^f."""
        stype = self._sectype(a)
        sec = stype.sectype
        f, l = sec.frac_length, sec.bit_length
        rb = self._share(self.np_to_bits(a, l))
        if f:
            rb = rb >> f                                 # 0/1 field bits
        s_raw = 1 - self._last(rb, l - 1)                # 1 iff a >= 0
        x = self._last(rb, slice(None, l - 1))
        x = x.from_data(torch.flip(x.data, dims=(-2,)))  # MSB first
        s_col = s_raw.from_data(s_raw.data.unsqueeze(-2))
        q = x + s_col - self._mul_reshared(x, s_col) * 2  # x_i XOR s
        P = self._prefix_mul_raw(q)                      # 1 until a match
        prev = self._set_first(P.from_data(torch.roll(P.data, 1, dims=-2)),
                               1, 1)
        nf = self._dot_pow2_last(prev - P)               # the first match
        v_raw = self._mul_reshared(s_raw * 2 - 1, nf)
        shift = 2 * f - l + 1
        sv = v_raw << shift if shift >= 0 else v_raw >> -shift
        return self._wrap(stype, sv, False,
                          isinstance(a, sectypes.SecureArray))

    def _rec(self, a):
        """Secure reciprocal of a fixed-point a (every value of an array)
        by Newton's iteration (``mpyc_tpu/runtime.py:4199``): b = a v in
        [1/2, 1) (``_norm``), c = 2.914... - 2 b, then theta = ceil(log2((f
        + 1) / 3.54)) steps c = c (2 - c b), and 1 / a = c v."""
        f = self._sectype(a).sectype.frac_length
        v = self._norm(a)
        b = self.mul(a, v)
        theta = int(math.ceil(math.log2((f + 1) / 3.54)))
        c = self.sub(self._public_fxp(a, 2.9142135623731), self.mul(b, 2))
        for _ in range(theta):
            c = self.mul(c, self.sub(self._public_fxp(a, 2),
                                     self.mul(c, b)))
        return self.mul(c, v)

    def _public_fxp(self, like, value):
        """A public constant as a secure number of like's type
        (``mpyc_tpu/runtime.py:4472``)."""
        return self._sectype(like).sectype(value)

    # -- operations on lists of secure numbers -------------------------------

    def input_each(self, f):
        """One secret of each party: party i inputs f(i); the list of the
        m secure objects (``mpyc_tpu/runtime.py:529``, the co-located
        plane's branch)."""
        return [self.input(f(i), senders=i) for i in range(len(self.parties))]

    def scalar_mul(self, a, x):
        """Secure a times each element of the list x
        (``mpyc_tpu/runtime.py:1484``)."""
        return [self.mul(xi, a) for xi in x]

    def sum(self, x, start=0):
        """Secure sum of a list of secure numbers (local), or of a secure
        array's values (``mpyc_tpu/runtime.py:1488``)."""
        if isinstance(x, sectypes.SecureArray):
            return self.np_sum(x)
        x = list(x)
        if not x:
            return start
        if isinstance(start, sectypes.SecureObject) or start != 0:
            x[0] = self.add(x[0], start)
        stype = self._sectype(*x)
        acc = self._share(x[0])
        for xi in x[1:]:
            acc = acc + self._share(xi)
        return self._wrap(stype, acc, all(self._integral(xi) for xi in x),
                          False)

    def prod(self, x, start=1):
        """Secure product of a list of secure numbers, in log depth
        (``mpyc_tpu/runtime.py:1523``)."""
        if not x:
            return start
        x = list(x)
        if start != 1:
            x.append(start if isinstance(start, sectypes.SecureObject)
                     else type(x[0])(start))
        while len(x) > 1:
            nxt = [self.mul(x[i], x[i + 1]) for i in range(0, len(x) - 1, 2)]
            if len(x) % 2:
                nxt.append(x[-1])
            x = nxt
        return x[0]

    def vector_add(self, x, y):
        return [self.add(a, b) for a, b in zip(x, y)]

    def vector_sub(self, x, y):
        return [self.sub(a, b) for a, b in zip(x, y)]

    def if_else(self, c, x, y):
        """Secure selection c x + (1 - c) y for a secure 0/1 c, of numbers
        or elementwise of lists (``mpyc_tpu/runtime.py:2682``): one
        product, c (x - y) + y."""
        if isinstance(c, sectypes.SecureFixedPoint) and not c.integral:
            raise ValueError('condition must be integral')
        if x is y:
            return x
        if isinstance(x, list):
            return [self.if_else(c, xi, yi) for xi, yi in zip(x, y)]
        secure = isinstance(y, sectypes.SecureObject)
        d = self.sub(x, y) if secure or \
            isinstance(x, sectypes.SecureObject) else x - y
        return self.add(self.mul(c, d), y if secure else
                        self._sectype(c).sectype(y))

    def min(self, *x, key=None):
        """Secure minimum of numbers, a tournament of comparisons
        (``mpyc_tpu/runtime.py:3456``)."""
        if len(x) == 1:
            x = x[0]
        x = list(x)
        if not x:
            raise ValueError('min() arg is an empty sequence')
        if len(x) == 1:
            return x[0]
        key = key or (lambda a: a)
        min0 = self.min(x[:len(x) // 2], key=key)
        min1 = self.min(x[len(x) // 2:], key=key)
        return self.if_else(key(min0) < key(min1), min0, min1)

    def max(self, *x, key=None):
        """Secure maximum (``mpyc_tpu/runtime.py:3473``); see min."""
        if len(x) == 1:
            x = x[0]
        x = list(x)
        if not x:
            raise ValueError('max() arg is an empty sequence')
        if len(x) == 1:
            return x[0]
        key = key or (lambda a: a)
        max0 = self.max(x[:len(x) // 2], key=key)
        max1 = self.max(x[len(x) // 2:], key=key)
        return self.if_else(key(max0) < key(max1), max1, max0)

    def abs(self, a, l=None):
        """Secure |a| (``mpyc_tpu/runtime.py:3061``)."""
        return self.np_absolute(a, l)

    def min_max(self, *x, key=None):
        """Secure (min, max) of numbers in (3n - 3) // 2 comparisons
        (``mpyc_tpu/runtime.py:3490``): the pairs (x[i], x[n - 1 - i])
        are ordered first, then min of the first half and max of the
        second."""
        if len(x) == 1:
            x = x[0]
        x = list(x)
        n = len(x)
        if not n:
            raise ValueError('min_max() arg is an empty sequence')
        key = key or (lambda a: a)
        for i in range(n // 2):
            a, b = x[i], x[-1 - i]
            x[i], x[-1 - i] = self.if_swap(key(a) >= key(b), a, b)
        return (self.min(x[:(n + 1) // 2], key=key),
                self.max(x[n // 2:], key=key))

    def argmin(self, *x, key=None):
        """Secure (index, minimum) of numbers or of lists of numbers (a
        key then orders them), the first occurrence on ties
        (``mpyc_tpu/runtime.py:3506``)."""
        if len(x) == 1:
            x = x[0]
        x = list(x)
        if not x:
            raise ValueError('argmin() arg is an empty sequence')
        key = key or (lambda a: a)
        return self._argminmax(x, lambda c0, c1: key(c1) < key(c0))

    def argmax(self, *x, key=None):
        """Secure (index, maximum); see argmin
        (``mpyc_tpu/runtime.py:3518``)."""
        if len(x) == 1:
            x = x[0]
        x = list(x)
        if not x:
            raise ValueError('argmax() arg is an empty sequence')
        key = key or (lambda a: a)
        return self._argminmax(x, lambda c0, c1: key(c0) < key(c1))

    def _argminmax(self, x, better1):
        """The halves' winners, the second taken where ``better1`` holds
        of the pair: a tournament of len(x) - 1 comparisons
        (``mpyc_tpu/runtime.py:3530``)."""
        n = len(x)
        if n == 1:
            m = x[0]
            return type(m[0] if isinstance(m, list) else m)(0), m
        i0, m0 = self._argminmax(x[:n // 2], better1)
        i1, m1 = self._argminmax(x[n // 2:], better1)
        c = better1(m0, m1)
        return (self.if_else(c, self.add(i1, n // 2), i0),
                self.if_else(c, m1, m0))

    def if_swap(self, c, x, y):
        """Secure swap: [x, y] where c is 0, [y, x] where it is 1, of
        numbers or elementwise of lists (``mpyc_tpu/runtime.py:2697``):
        one product, d = c (y - x), then [x + d, y - d]."""
        if isinstance(c, sectypes.SecureFixedPoint) and not c.integral:
            raise ValueError('condition must be integral')
        if isinstance(x, list):
            d = [c * (yi - xi) for xi, yi in zip(x, y)]
            return [[xi + di for xi, di in zip(x, d)],
                    [yi - di for yi, di in zip(y, d)]]
        d = c * (y - x)
        return [x + d, y - d]

    def sorted(self, x, key=None, reverse=False):
        """A securely sorted copy of a list of numbers (or of lists, by
        key): Batcher's merge-exchange network, not stable
        (``mpyc_tpu/runtime.py:3544``)."""
        x = list(x)
        if len(x) < 2:
            return x
        self._sort(x, key or (lambda a: a))
        if reverse:
            x.reverse()
        return x

    def _sort(self, x, key):
        """Batcher's merge-exchange (Knuth, TAOCP 5.2.2 M) in place, one
        if_swap a comparator (``mpyc_tpu/runtime.py:3556``)."""
        n = len(x)
        t = (n - 1).bit_length()
        p = 1 << (t - 1)
        while p:
            d, q, r = p, 1 << (t - 1), 0
            while d:
                for i in range(n - d):
                    if i & p == r:
                        a, b = x[i], x[i + d]
                        x[i], x[i + d] = self.if_swap(key(a) < key(b), b, a)
                d, q, r = q - p, q >> 1, p
            p >>= 1
        return x

    def in_prod(self, x, y):
        """Secure dot product of two lists of numbers: the local products
        summed and one reshare round (``mpyc_tpu/runtime.py:1504``)."""
        if not x:
            return 0
        stype = self._sectype(*x, *y)
        f = stype.sectype.frac_length
        a_int = all(self._integral(xi) for xi in x)
        b_int = all(self._integral(yi) for yi in y)
        acc = None
        for xi, yi in zip(x, y):
            t = self._share(self._coerce_op(stype, xi)) * \
                self._share(self._coerce_op(stype, yi))
            acc = t if acc is None else acc + t
        if f and (a_int or b_int):
            acc = acc >> f
        acc = self._reshare(acc)
        if f and not (a_int or b_int):
            acc = self._trunc_field(acc, f, stype.sectype.bit_length + f)
        return self._wrap(stype, acc, a_int and b_int, False)

    def matrix_prod(self, A, B, tr=False):
        """Secure product of matrices given as lists of lists, one of
        them may be public (``mpyc_tpu/runtime.py:2585``): one matrix
        product of the arrays (``np_matmul``), B transposed with tr."""
        stype = self._sectype(*(A[0] + B[0]))

        def lift(M):
            flat = [v for row in M for v in row]
            if any(isinstance(v, sectypes.SecureObject) for v in flat):
                return self.np_reshape(self.np_fromlist(
                    [v if isinstance(v, sectypes.SecureObject)
                     else stype.sectype(v) for v in flat]),
                    (len(M), len(M[0])))
            return np.array([list(row) for row in M], dtype=object)

        An, Bn = lift(A), lift(B)
        if tr:
            Bn = self.np_transpose(Bn) if isinstance(
                Bn, sectypes.SecureArray) else Bn.T
        C = self.np_matmul(An, Bn)
        return [[self.np_getitem(C, (i, j)) for j in range(C.shape[1])]
                for i in range(C.shape[0])]

    def matrix_add(self, A, B, tr=False):
        """Secure A + B (B transposed with tr) of lists of lists
        (``mpyc_tpu/runtime.py:2638``)."""
        return [[self.add(A[i][j], B[j][i] if tr else B[i][j])
                 for j in range(len(A[0]))] for i in range(len(A))]

    # -- secure unit vectors -------------------------------------------------

    def np_unit_vector(self, a, n: int):
        """Secure length-n unit vector with its 1 at the secret position a
        mod n (``mpyc_tpu/runtime.py:2541``): a random unit vector u
        (``random.np_random_unit_vector``) rotated by c = a - r + (R + 1) n
        opened, r the position of u's 1 and R a PRSS value below 2^k; a
        fixed-point a and r have their scale 2^f divided out first."""
        from mpyc_tpu_torch import random
        sec = self._sectype(a).sectype
        field = sec.field
        f = sec.frac_length
        u = random.np_random_unit_vector(sec, n)
        r = self._dot_public_last(self._share(u), list(range(n)))
        sa = self._share(a)
        if f:
            r = r >> f
            sa = sa >> f
        R = self._random(sec, 1 << self.sec_param)
        c = self.output(sa - r + (self._share(R) + 1) * n)
        c = int(np.asarray(c.value).reshape(-1)[0]) % n
        return self.np_roll(u, c)

    def unit_vector(self, a, n: int) -> list:
        """Secure length-n unit vector, as a list of n secure numbers, with
        its 1 at the secret index a, 0 <= a < n (``mpyc_tpu/runtime.py:
        3771``): a broadcast over n slots minus the public 0..n-1, and one
        batched zero test (``np_equal``: Fermat's in a secure field, the
        comparison or [NO07] in an integer or fixed-point type)."""
        stype = self._sectype(a)
        if stype.sectype.frac_length and not a.integral:
            raise ValueError('nonintegral fixed-point number')
        sa = self._share(a)
        arr = self._wrap(stype, sa.from_data(sa.data.unsqueeze(1).expand(
            (sa.data.shape[0], n) + tuple(sa.data.shape[1:]))), True)
        diff = self.sub(arr, np.arange(n))
        return self.np_tolist(self.np_equal(diff, np.zeros(n, np.int64)))

    def random_bit(self, stype, signed=False):
        """One secret random bit (-1/1 with ``signed``) of a secure type
        (``mpyc_tpu/runtime.py:1252``)."""
        return self.random_bits(stype, 1, signed)[0]

    def eq_public(self, a, b) -> bool:
        """Whether a == b, made public and nothing more
        (``mpyc_tpu/runtime.py:1730``): ``is_zero_public`` of a - b."""
        return self.is_zero_public(self.sub(a, b))

    def find(self, x, a, bits=True, e='len(x)', f=None, cs_f=None):
        """Secure index of the first occurrence of a in the list x
        (``mpyc_tpu/runtime.py:3801``). With ``bits`` x and a hold 0/1
        values; otherwise any values, compared by ``!=``. Where a does not
        occur the result is e (an int, or an expression over len(x)); with
        e None the pair (nf, f(ix)), nf = 1 where a was not found. f maps
        the index to the value(s) returned; cs_f(b, i) = f(i + b) for b in
        {0, 1} may be given instead. A log-depth cascade of if_else
        merges, each level's halves at once."""
        if bits:
            if isinstance(a, int):
                if a == 1:
                    x = [1 - b for b in x]
            else:
                x = [a + (1 - 2 * a) * b for b in x]
        else:
            x = [b != a for b in x]
        # locate the first 0 in x
        type_f = None
        if cs_f is None:
            if f is None:
                type_f = int
                f = lambda i: [i]                       # noqa: E731
                cs_f = lambda b, i: [i + b]             # noqa: E731
            else:
                type_f = type(f(0))
                if issubclass(type_f, int):
                    f_int = f
                    f = lambda i: [f_int(i)]            # noqa: E731
                cs_f = lambda b, i: [b * (y1 - y0) + y0  # noqa: E731
                                     for y0, y1 in zip(f(i), f(i + 1))]
        elif f is None:
            type_f = type(cs_f(0, 0))
            if issubclass(type_f, int):
                cs_int = cs_f
                cs_f = lambda b, i: [cs_int(b, i)]      # noqa: E731
            elif issubclass(type_f, tuple):
                cs_tup = cs_f
                cs_f = lambda b, i: list(cs_tup(b, i))  # noqa: E731
            f = lambda i: cs_f(0, i)                    # noqa: E731
        else:
            type_f = type(f(0))
            if issubclass(type_f, int):
                f_int = f
                f = lambda i: [f_int(i)]                # noqa: E731
        if isinstance(e, str):
            e = eval(e)  # an expression over len(x)  # noqa: S307
        if not x:
            nf = 1
            y = f(0) if e is None else f(e)
        else:
            def scan(i, j):
                # [nf, *value]: nf = 1 where x[i:j] holds no 0
                if j - i == 1:
                    b = x[i]
                    return [b] + cs_f(b, i)
                h = i + (j - i) // 2
                left = scan(i, h)
                return self.if_else(left[0], scan(h, j), left)
            nf, *f_ix = scan(0, len(x))
            if e is None:
                y = f_ix
            else:
                y = self.if_else(nf, [v if isinstance(v, sectypes.SecureObject)
                                      else type(nf)(v) for v in f(e)], f_ix)
        if issubclass(type_f, int):
            y = y[0]
        elif issubclass(type_f, tuple):
            y = tuple(y)
        return (nf, y) if e is None else y

    def indexOf(self, x, a, bits=False):
        """Secure index of the first occurrence of a in the list x; raises
        ValueError where a does not occur, which is made public
        (``mpyc_tpu/runtime.py:3982``)."""
        if not x:
            raise ValueError('value is not in list')
        ix = self.find(x, a, e=-1, bits=bits)
        if self.eq_public(ix, -1):
            raise ValueError('value is not in list')
        return ix

    def from_bits(self, x):
        """The secure number of a list of secure bits, least significant
        first (``mpyc_tpu/runtime.py:3412``): ``np_from_bits`` of their
        array."""
        if not x:
            return 0
        return self.np_from_bits(self.np_fromlist(list(x)))

    # -- least significant bit and reduction mod a public value ---------------

    def lsb(self, a):
        """Secure least significant bit of a (``mpyc_tpu/runtime.py:3067``,
        a la [ST06]); see np_lsb."""
        return self.np_lsb(a)

    def np_lsb(self, a):
        """Secure least significant bits of a number or array
        (``mpyc_tpu/runtime.py:3071``): a random bit b and a PRSS value r
        below 2^(l + k - 1), c = a + 2^l + 2 r + b opened, and the bit is
        c's lowest XOR b. A fixed-point value's bit is that of its raw
        value (times 2^f f bits above it, as the JAX package computes
        it), scaled by 2^f."""
        stype = self._sectype(a)
        sec = stype.sectype
        field = stype.field
        l, f = sec.bit_length, sec.frac_length
        shape = tuple(a.shape)
        m = len(self.parties)
        n = max(math.prod(shape), 1)
        b = self.np_random_bits(field, n)
        r = self._np_randoms(field, n, 1 << (l + self.sec_param - 1))
        a_sh = self._share(a).reshape(m, n)
        c = self.output(a_sh + ((1 << l) + (r << 1) + b))
        c_lsb = field.array.from_uint32(c.to_bits_public(1)[..., 0])
        x = c_lsb + b - (c_lsb * b) * 2
        if f:
            x = x << f
        return self._wrap(stype, x.reshape((m,) + shape), True, bool(shape))

    def mod(self, a, b):
        """Secure a mod b for a public b (``mpyc_tpu/runtime.py:3096``), in
        the raw domain: a fixed-point a and b are both times 2^f, so the
        residue keeps a's fraction. A raw b of 2 is the least significant
        bit; any other b takes ``_mod``."""
        sec = self._sectype(a).sectype
        f = sec.frac_length
        if isinstance(b, sectypes.SecureObject):
            b_raw = int(self.output(b, raw=True).signed()[()])
        elif isinstance(b, float):
            b_raw = round(b * (1 << f))
        else:
            b_raw = int(b) << f
        if b_raw == 2:
            r = self.lsb(a)
            return self.mul(r, 2 ** -f) if f else r
        return self._mod(a, b_raw)

    def _mod(self, a, b: int):
        """Secure a mod b for a public raw b a la [GMS10]
        (``mpyc_tpu/runtime.py:3124``): r < b by its bits
        (``_randbelow_bits``), c = a + 2^l - (2^l mod b) + b r' - r opened
        (r' a PRSS value below 2^k), and a mod b = (c mod b) + r - z b,
        with z = [r >= b - (c mod b)] from one product of lb + 1 terms
        (a signed random bit s masks which term is 0) and one public zero
        test of it, a blinder of its own a value (``is_zero_public``)."""
        stype = self._sectype(a)
        sec = stype.sectype
        field = stype.field
        l, k = sec.bit_length, self.sec_param
        shape = tuple(a.shape)
        m = len(self.parties)
        n = max(math.prod(shape), 1)
        r_bits = self._randbelow_bits(field, b, n)          # (m, n, lb)
        lb = r_bits.shape[-1]
        r_modb = self._dot_pow2_last(r_bits)
        r_divb = self._np_randoms(field, n, 1 << k)
        a_sh = self._share(a).reshape(m, n)
        c = self.output(a_sh + ((1 << l) - ((1 << l) % b) + r_divb * b
                                - r_modb))
        c_vals = np.array([int(v) % b for v in c.value.reshape(-1)],
                          dtype=object)
        c_vals[c_vals == 0] = b
        s_sign = self.np_random_bits(field, n, signed=True)  # (m, n)
        bc = b - c_vals
        bc_bits = torch.tensor(np.array([[(int(v) >> i) & 1 for i in
                                          range(lb)] for v in bc],
                                        dtype=np.int64).reshape(n, lb),
                               device=self.device)
        bc_f = field.array.from_uint32(bc_bits)              # (n, lb)
        xor = bc_f + r_bits - (bc_f * r_bits) * 2
        last = self._last
        sums = [None] * lb
        acc = None
        for i in range(lb - 1, -1, -1):
            sums[i] = acc
            x_i = last(xor, i)
            acc = x_i if acc is None else acc + x_i
        terms = []
        for i in range(lb):
            e_i = s_sign + (last(r_bits, i) - last(bc_f, i))
            if sums[i] is not None:
                e_i = e_i + sums[i] * 3
            terms.append(e_i)
        terms.append(s_sign + 1 + (acc * 3 if acc is not None else 0))
        E = terms[0].from_data(torch.stack([t.data for t in terms], dim=-2))
        g = self.is_zero_public(self._prod_last_axis(E))
        g_f = field.array.from_uint32(torch.as_tensor(
            np.asarray(g, dtype=np.int64).reshape(n), device=self.device))
        z = (s_sign - (s_sign * g_f) * 2 + 1) >> 1
        c_f = field.array(c_vals, self.device)
        res = c_f + r_modb - z * b
        return self._wrap(stype, res.reshape((m,) + shape), self._integral(a),
                          bool(shape))

    def _randbelow_bits(self, field, b: int, n: int):
        """The bits of n secure values uniform below a public b, least
        significant first, party-stacked (m, n, lb), lb = bit length of
        b - 1 (``mpyc_tpu/runtime.py:3183``): random bits for a power of
        two; otherwise lb random bits a value, tested [bits < b] by a
        public opening (``_bits_lt_public``), and the values rejected
        drawn again until all n are kept, in order."""
        lb = (b - 1).bit_length()
        m = len(self.parties)
        if b & (b - 1) == 0:
            return self.np_random_bits(field, n * lb).reshape(m, n, lb)
        out = None
        remaining = torch.arange(n, device=self.device)
        while remaining.numel():
            h = remaining.numel()
            bits = self.np_random_bits(field, h * lb).reshape(m, h, lb)
            ok = torch.as_tensor(self.output(self._bits_lt_public(bits, b))
                                 .value.astype(np.int64) != 0,
                                 device=self.device)
            if out is None:
                out = bits.data.new_zeros((m, n, lb, bits.data.shape[-1]))
            out[:, remaining[ok]] = bits.data[:, ok]
            remaining = remaining[~ok]
        return field.array.from_data(out)

    def _bits_lt_public(self, bits, b: int):
        """Secure [x < b] for the secure bits of x (least significant
        first, party-stacked (m, h, lb)) and a public b
        (``mpyc_tpu/runtime.py:3236``): a scan from the top bit, lt the
        sum over b's set bits i of [x's bits above i equal b's] (1 -
        x_i), each product of two secure bits one reshare round."""
        lb = bits.shape[-1]
        lt = eq = None
        for i in range(lb - 1, -1, -1):
            x_i = self._last(bits, i)
            if (b >> i) & 1:
                term = 1 - x_i if eq is None else \
                    self._mul_reshared(eq, 1 - x_i)
                lt = term if lt is None else lt + term
                eq = x_i if eq is None else self._mul_reshared(eq, x_i)
            else:
                eq = 1 - x_i if eq is None else \
                    self._mul_reshared(eq, 1 - x_i)
        return lt if lt is not None else self._last(bits, 0) * 0

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

    def eq(self, a, b):
        """Secure a == b (``mpyc_tpu/runtime.py:2920``)."""
        return self.is_zero(self.sub(a, b))

    def is_zero(self, a):
        """Secure a == 0, as 0/1 (``mpyc_tpu/runtime.py:2934``): in a
        secure finite field by Fermat's little theorem, 1 - a^(q - 1)
        (``pow``: square and multiply, each product a reshare round); for
        bit lengths above twice the security parameter k (and k >= 8) on a
        Blum prime, [NO07]'s probabilistic test (``_np_is_zero``), else the
        comparison in EQ mode."""
        stype = self._sectype(a)
        if issubclass(stype, sectypes.SecureFiniteFieldArray):
            return self.sub(1, self.pow(a, stype.field.order - 1))
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

    def np_if_swap(self, c, a, b):
        """Secure swap of arrays a and b where c holds (c secure or
        public; ``mpyc_tpu/runtime.py:1980``): d = c (b - a), then
        [a + d, b - d]."""
        d = self.sub(b, a)
        if isinstance(c, sectypes.SecureObject):
            d = self.mul(c, d)
        else:
            d = self.mul(d, np.asarray(c, dtype=object) * 1)
        return [self.add(a, d), self.sub(b, d)]

    def _reduce_prep(self, a, axis):
        """a with the axes ``axis`` (default: all) moved last and merged
        into one, and those axes (``mpyc_tpu/runtime.py:3609``)."""
        nd = len(a.shape)
        if axis is None:
            axes = tuple(range(nd))
        elif isinstance(axis, int):
            axes = (axis % nd,)
        else:
            axes = tuple(sorted(i % nd for i in axis))
        order = [i for i in range(nd) if i not in axes] + list(axes)
        if order != list(range(nd)):
            a = self.np_transpose(a, axes=order)
        return self.np_reshape(a, tuple(a.shape[:nd - len(axes)]) + (-1,)), \
            axes

    def np_prod(self, a, axis=None):
        """Secure product of the values of a over axes (default: all) in
        log depth (``mpyc_tpu/runtime.py:3040``, ``_np_prod`` ``:3044``):
        the two halves of the last axis multiplied, one product round a
        level, an odd one out kept first."""
        a, _ = self._reduce_prep(a, axis)
        while (n := a.shape[-1]) > 1:
            n0 = n % 2
            h = (n + 1) // 2
            w = self.mul(self.np_getitem(a, (..., slice(n0, h))),
                         self.np_getitem(a, (..., slice(h, n))))
            if n0:
                w = self.np_concatenate(
                    [self.np_getitem(a, (..., slice(0, 1))), w], axis=-1)
            a = w
        return self.np_getitem(a, (..., 0))

    def np_amin(self, a, axis=None, keepdims=False):
        """Secure minimum over axes (default: all), a tournament of
        batched comparisons (``mpyc_tpu/runtime.py:3602``)."""
        return self._np_extremum(a, axis, True, keepdims)

    def np_amax(self, a, axis=None, keepdims=False):
        """Secure maximum over axes (``mpyc_tpu/runtime.py:3606``)."""
        return self._np_extremum(a, axis, False, keepdims)

    def _np_extremum(self, a, axis, is_min, keepdims=False):
        """The halves of the last axis compared at once and the winners
        kept, an odd one out last, until one is left
        (``mpyc_tpu/runtime.py:3626``)."""
        shape = a.shape
        a, axes = self._reduce_prep(a, axis)
        while (n := a.shape[-1]) > 1:
            half = n // 2
            b0 = self.np_getitem(a, (..., slice(0, half)))
            b1 = self.np_getitem(a, (..., slice(half, 2 * half)))
            c = self.np_less(b1, b0) if is_min else self.np_less(b0, b1)
            w = self.add(self.mul(c, self.sub(b1, b0)), b0)
            if n % 2:
                w = self.np_concatenate(
                    [w, self.np_getitem(a, (..., slice(2 * half, n)))],
                    axis=-1)
            a = w
        if keepdims:
            return self.np_reshape(a, tuple(1 if i in axes else s
                                            for i, s in enumerate(shape)))
        return self.np_getitem(a, (..., 0))

    def np_sort(self, a, axis=-1, key=None):
        """A securely sorted copy of a along an axis (None: flattened),
        by key (``mpyc_tpu/runtime.py:3572``): Batcher's merge-exchange
        network with every stage's comparators at once, one batched
        comparison and one product a stage over the pairs (I, I + d)
        gathered by index arrays and written back. I = {i < n - d: i & p
        == r} is made on the shares' device from its closed form (runs of
        p from r, every 2p), so that no stage waits for the host."""
        if axis is None:
            a, axis = self.np_flatten(a), 0
        else:
            a = self.np_copy(a)
        key = key or (lambda v: v)
        n = a.shape[axis]
        if a.size == 0 or n <= 1:
            return a
        a = self.np_swapaxes(a, axis, -1)
        dev = self._share(a).data.device
        t = (n - 1).bit_length()
        p = 1 << (t - 1)
        while p:
            d, q, r = p, 1 << (t - 1), 0
            while d:
                full, rem = divmod(n - d, 2 * p)
                j = torch.arange(full * p + max(0, min(p, rem - r)),
                                 device=dev)
                i0 = j // p * (2 * p) + r + j % p
                i1 = i0 + d
                b0 = self.np_getitem(a, (..., i0))
                b1 = self.np_getitem(a, (..., i1))
                h = self.mul(self.np_less(key(b1), key(b0)),
                             self.sub(b1, b0))
                a = self.np_update(a, (..., i0), self.add(b0, h))
                a = self.np_update(a, (..., i1), self.sub(b1, h))
                d, q, r = q - p, q >> 1, p
            p >>= 1
        return self.np_swapaxes(a, axis, -1)

    def np_where(self, c, a, b):
        """Secure selection c * a + (1 - c) * b (numpy broadcasting): one
        product, c * (a - b) + b, as the JAX package computes it
        (``mpyc_tpu/runtime.py:1963``). a and b may both be public; a
        public condition selects from the secure difference."""
        try:
            d = self.sub(a, b)
        except TypeError:
            d = np.asarray(a) - np.asarray(b)        # both public
        if not isinstance(c, sectypes.SecureObject):
            return self.add(self.mul(d, np.asarray(c, dtype=object) * 1), b)
        return self.add(self.mul(c, d), b)

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
        idx = self._logical_index(idx, len(a.shape))
        target = data[(slice(None),) + idx]
        data[(slice(None),) + idx] = v.reshape(
            v.shape[:1] + (1,) * (target.dim() - v.dim()) + v.shape[1:]) \
            if v.dim() < target.dim() else v
        return self._wrap(stype, share.from_data(data),
                          self._integral(a) and self._integral(value))

    def np_copy(self, a):
        """A copy of a secure array (``mpyc_tpu/runtime.py:1829``)."""
        return self._local(a, torch.clone)

    def np_flatten(self, a):
        """a as a 1-D secure array (``mpyc_tpu/runtime.py:1819``)."""
        return self.np_reshape(a, -1)

    @staticmethod
    def _logical_index(idx, nd: int) -> tuple:
        """An index of the logical axes as a tuple, its Ellipsis (if any)
        spelled out as slices, so that it never reaches the limb axis."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        k = next((j for j, i in enumerate(idx) if i is Ellipsis), None)
        if k is None:
            return idx
        used = sum(i is not None for i in idx) - 1
        return idx[:k] + (slice(None),) * (nd - used) + idx[k + 1:]

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


def _field_det_public(field, arr):
    """The determinant mod p of an opened square field array, as a field
    element, by Gaussian elimination over Python ints
    (``mpyc_tpu/runtime.py:4480``)."""
    p = field.modulus
    a = [[int(v) % p for v in row] for row in
         np.asarray(arr.value, dtype=object).tolist()]
    n = len(a)
    det = 1
    for i in range(n):
        piv = next((r for r in range(i, n) if a[r][i] % p), None)
        if piv is None:
            return field(0)
        if piv != i:
            a[i], a[piv] = a[piv], a[i]
            det = -det
        det = det * a[i][i] % p
        inv = pow(a[i][i], -1, p)
        for r in range(i + 1, n):
            f = a[r][i] * inv % p
            if f:
                for c in range(i, n):
                    a[r][c] = (a[r][c] - f * a[i][c]) % p
    return field(det % p)
