"""Co-located simulator plane: all m parties in one process, on one device.

Port of the part of ``mpyc_tpu/parallel/simulator.py`` that secure
multiplication, comparison and matrix products use. A share array carries
a leading party axis, (m, ...) plus the limb axis, so the whole m-party
protocol runs as dense tensor programs: input is a Shamir split per
sender, a secure product is one fused reshare round (kernel K3 on the
card), a product with a public operand a local scale, a matrix product of
two secure operands a field matmul and one reshare round (K3 without the
product), a comparison one fused step per chunk of up to 2^20 elements
(kernel K5; on the card the chunks of one comparison are one launch), and
output recombines the first t+1 shares at 0. Over a binary field GF(2^d)
(``SecFld``) a secure product is one fused round too: K1 squeezes its
stream and kernel K8 computes the carry-less product and the reshare
(``_mul_reshare2_fused``), and random bits are single PRSS draws of one
bit. A secure prime field's product (``SecFld(p)``) is K3's fused round,
on one limb for p < 2^32.

The fused rounds draw their coefficients from an independent SHAKE key
(``_fused_key``) with a call counter (``_fused_ctr``), as in the JAX
package. Pseudorandom secret sharing (PRSS) draws from one key per
(m - t)-subset of the parties, named by the program counter: random
values (``_np_randoms``), random bits (``np_random_bits``: a PRSS value r
and zero-sharing z, r^2 + z opened at threshold 2t and r / sqrt(r^2 +
z), the round's tail one launch of kernel K7 on the card) and the
truncation of fixed-point products (``_trunc_field``). ``load_state`` takes the JAX runtime's key, counter
and input generator, and its PRSS keys and program counter, after which
both runtimes give the same shares bit for bit. ``transfer`` and
``output(..., receivers=)`` give the one process every party's view;
``_convert`` masks a conversion with PRSS values of one draw in both
fields (``_stacked_prss``, or from a secure field ``_stacked_prss_host``
over the PRFs' host integers).

Trust model: one process holds all shares, so this plane is for
benchmarks, tests and co-located deployments only.
"""

from __future__ import annotations

import itertools
import math
import pickle
import secrets as _secrets

import numpy as np
import torch

from mpyc_tpu_torch import finfields, sectypes, thresha
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import keccak
from mpyc_tpu_torch.ops.rng import KeccakRNG
from mpyc_tpu_torch.runtime import Runtime


class SimRuntime(Runtime):
    """All parties in one runtime, with party-stacked shares."""

    def __init__(self, m: int, device=None, threshold=None):
        super().__init__(m, device, threshold)
        self._rng = KeccakRNG(device=self.device)
        self._fused_key = _secrets.token_bytes(32)
        self._fused_state = None
        self._fused_ctr = np.zeros(2, np.uint32)
        self._fused_steps = {}
        self._sgn_specs = {}

    # the co-located plane of the JAX package fails at t = 0 on every PRSS
    # draw (its f_S is None there: mpyc_tpu/parallel/simulator.py:667), so
    # on every comparison and random bit; the port raises there
    _AT_T0 = ('comparisons, random bits and other PRSS draws need t >= 1: '
              'the reference\'s co-located plane fails at t = 0 too '
              '(mpyc_tpu/parallel/simulator.py:667)')

    def prfs(self, bound: int) -> dict:
        """The PRSS keys' PRFs of codomain range(bound); raises
        NotImplementedError at t = 0 (``_AT_T0``)."""
        if self.threshold == 0:
            raise NotImplementedError(self._AT_T0)
        return super().prfs(bound)

    @property
    def threshold(self) -> int:
        return self._threshold

    @threshold.setter
    def threshold(self, t: int) -> None:
        """Set the threshold t and draw new PRSS keys, all of them, one
        per (m - t)-subset of the parties (``mpyc_tpu/parallel/
        simulator.py:68-74``). A product needs 2t + 1 <= m (its
        ``ReshareSpec`` raises otherwise); the card takes 1 <= t <= 4 and
        m <= 16, and t = 0 computes products locally."""
        m = len(self.parties)
        if not 0 <= t < max(m, 1):
            raise ValueError(f'threshold {t} outside [0, {m})')
        self._threshold = t
        self._prfs = {}
        self._prss_keys = {
            S: _secrets.token_bytes(16)
            for S in itertools.combinations(range(m), m - t)}

    def load_state(self, fused_key: bytes, ctr, rng_key: bytes,
                   rng_nonce: int, prss_keys=None, pc=None) -> None:
        """Continue from another runtime's randomness state: the fused
        reshare key and call counter (lo, hi), the input generator's key
        and nonce, and, if given, the PRSS keys (subset -> 16-byte key)
        and the program counter (the JAX package's
        ``SimRuntime._fused_key``, ``_fused_ctr``, ``_rng.key``,
        ``_rng._nonce``, ``_prss_keys`` and ``_program_counter[0]``)."""
        self._fused_key = bytes(fused_key)
        self._fused_state = None
        self._fused_ctr = np.array(np.asarray(ctr, dtype=np.uint32)
                                   .reshape(2))
        self._rng.load(rng_key, rng_nonce)
        if prss_keys is not None:
            self._prss_keys = {tuple(S): bytes(k)
                               for S, k in prss_keys.items()}
            self._prfs = {}
        if pc is not None:
            self._program_counter[0] = int(pc)

    def transfer(self, obj, senders=None, receivers=None,
                 sender_receivers=None):
        """Exchange of plain Python objects (``mpyc_tpu/parallel/
        simulator.py:94``): the one process plays every party, so each
        sender's object is obj itself, a copy by a pickle round trip. One
        object for an int ``senders``, a list of one a sender otherwise;
        with ``sender_receivers`` (pairs (s, r), or a dict s -> receivers)
        a dict sender -> object of the pairs whose receiver is party 0, the
        party whose view the co-located plane returns, as the JAX package
        does."""
        dup = lambda: pickle.loads(pickle.dumps(obj))  # noqa: E731
        if sender_receivers is not None:
            pairs = [(s, r) for s, rs in sender_receivers.items()
                     for r in rs] if isinstance(sender_receivers, dict) \
                else sender_receivers
            return {s: dup() for s, r in pairs if r == self.pid}
        if isinstance(senders, int):
            return dup()
        snd = list(range(len(self.parties)) if senders is None else senders)
        return [dup() for _ in snd]

    # the leading party axis of every share (``mpyc_tpu/parallel/
    # simulator.py:61``): the demos' plane-agnostic helpers read it
    _pax = 1

    def _logical_reshape(self, share, shape):
        """Reshape the logical axes of party-stacked shares, the party
        axis kept (``mpyc_tpu/runtime.py:2717``)."""
        if isinstance(shape, int):
            shape = (shape,)
        return share.reshape(tuple(share.shape[:self._pax]) + tuple(shape))

    def _share_like(self, field_arr):
        """A public field array broadcast over the party axis: the
        constant polynomial's shares (``mpyc_tpu/parallel/simulator.py:
        160``)."""
        m = len(self.parties)
        return field_arr.from_data(field_arr.data.unsqueeze(0).expand(
            (m,) + tuple(field_arr.data.shape)))

    def _distribute(self, x, senders):
        m = len(self.parties)
        t = self.threshold
        y = []
        for _peer in senders:
            objs = []
            for xi in x:
                stype = self._sectype(xi)
                field = stype.field
                secret = xi.share
                flat = secret.flatten() if secret.shape else secret.reshape(1)
                sh = thresha.np_random_split(field, flat, t, m, self._rng)
                objs.append(self._wrap(stype, sh.reshape((m,) + xi.shape),
                                       self._integral(xi),
                                       self._is_array_op(xi)))
            y.append(objs)
        return y

    @staticmethod
    def _wrap(stype, share, integral=None, array=True):
        """Secure array of type stype holding party-stacked shares, or
        with ``array`` False and no logical axes a secure number of its
        type; a fixed-point one gets the flag ``integral`` (None:
        False)."""
        if array or share.shape[1:]:
            res = stype(share)
            res.shape = share.shape[1:]
        else:
            res = stype.sectype(share)
        if issubclass(stype, sectypes.SecureFixedPointArray):
            res.integral = bool(integral)
        return res

    @staticmethod
    def _is_public(x) -> bool:
        """x is a secure object not yet input: its share has no party
        axis."""
        return tuple(x.share.shape) == tuple(x.shape)

    def _share(self, x):
        """Party-stacked share of x; public-valued (unshared) arrays are
        the constant polynomial, a broadcast over the party axis."""
        s = x.share
        if self._is_public(x):
            m = len(self.parties)
            return s.from_data(s.data.unsqueeze(0).expand(
                (m,) + tuple(s.data.shape)))
        return s

    @staticmethod
    def _broadcast(data, lead: int, shape) -> torch.Tensor:
        """(lead axes) + logical + (L,) data -> (lead axes) + shape + (L,),
        the logical axes aligned on the right as numpy broadcasts them."""
        logical = data.shape[lead:-1]
        ones = (1,) * (len(shape) - len(logical))
        data = data.reshape(data.shape[:lead] + ones + logical
                            + data.shape[-1:])
        return data.expand(data.shape[:lead] + tuple(shape)
                           + data.shape[-1:])

    def _share2(self, a, b):
        """Party-stacked shares of a and b, broadcast to one shape."""
        sa, sb = self._share(a), self._share(b)
        if sa.shape != sb.shape:
            shape = torch.broadcast_shapes(sa.shape[1:], sb.shape[1:])
            sa = sa.from_data(self._broadcast(sa.data, 1, shape))
            sb = sb.from_data(self._broadcast(sb.data, 1, shape))
        return sa, sb

    def _fused_state_tensor(self) -> torch.Tensor:
        """Absorbed state of ``_fused_key || 0^8`` on the device (cached)."""
        if self._fused_state is None:
            state = keccak._absorb_host(self._fused_key + bytes(8))
            self._fused_state = keccak.state_tensor(state, self.device)
        return self._fused_state

    def _fused_flat(self, key, build, datas):
        """Run a fused step on flattened, bucket-padded party-stacked data.

        Every fused round flattens its logical dims to (m, n, L) and pads n
        to a power-of-two bucket (floor 64), as the JAX package does on the
        CPU, so the same padded shapes (and zero rows, valid sharings of 0)
        reach the step. datas: equally shaped (m, ..., L) tensors."""
        d0 = datas[0]
        m, L = d0.shape[0], d0.shape[-1]
        n = math.prod(d0.shape[1:-1])
        n_pad = pipelines.bucket(n)
        flats = []
        for d in datas:
            f = d.reshape(m, n, L)
            if n_pad != n:
                f = torch.cat([f, f.new_zeros((m, n_pad - n, L))], dim=1)
            flats.append(f)
        step = self._fused_steps.get(key)
        if step is None:
            step = self._fused_steps[key] = build()
        out, self._fused_ctr = step(*flats, self._fused_state_tensor(),
                                    self._fused_ctr)
        return out[:, :n].reshape(d0.shape)

    def _local(self, a, fn, array=True):
        """Secure array of fn(party-stacked share data): a local shape
        operation that keeps the party axis first and the limb axis last
        (with ``array`` False a secure number where no logical axis is
        left: ``_wrap``)."""
        share = self._share(a)
        data = fn(share.data)
        return self._wrap(self._sectype(a), share.from_data(data),
                          self._integral(a), array)

    def np_getitem(self, a, idx):
        """a[idx] along the logical axes (local): integers, slices with a
        positive step, None, one Ellipsis and integer index arrays (numpy
        or torch); a 0-d result is a secure number."""
        idx = self._logical_index(idx, len(a.shape))
        return self._local(a, lambda d: d[(slice(None),) + idx],
                           array=False)

    def np_fromlist(self, x):
        """A list of secure numbers as a secure 1-D array
        (``mpyc_tpu/parallel/simulator.py:968``)."""
        stype = self._sectype(*x)
        datas = [self._share(xi).data for xi in x]
        share = self._share(x[0]).from_data(torch.stack(datas, dim=1))
        return self._wrap(stype, share,
                          all(self._integral(xi) for xi in x))

    def np_tolist(self, a):
        """A secure array as a (nested) list of secure numbers
        (``mpyc_tpu/parallel/simulator.py:976``)."""
        if len(a.shape) == 1:
            return [self.np_getitem(a, i) for i in range(a.shape[0])]
        return [self.np_tolist(self.np_getitem(a, i))
                for i in range(a.shape[0])]

    def np_sum(self, a, axis=None, keepdims=False):
        """Secure sum over the logical axes ``axis`` (int, tuple or None:
        all), local."""
        share = self._share(a)
        nd = len(a.shape)
        if axis is None:
            axes = list(range(nd))
        elif isinstance(axis, int):
            axes = [axis % nd]
        else:
            axes = sorted(i % nd for i in axis)
        data = share.data
        for ax in reversed(axes):
            data = share.ctx.sum(data, ax + 1)
        if keepdims:
            data = data.reshape(data.shape[:1] + tuple(
                1 if i in axes else s for i, s in enumerate(a.shape))
                + data.shape[-1:])
        return self._wrap(type(a), share.from_data(data), self._integral(a))

    def _reshare(self, x):
        """GRR98 degree reduction of party-stacked field-array shares, one
        fused round (K3 without the local product; over GF(2^d) K8 without
        it) of any logical shape."""
        if self.threshold == 0:
            return x
        field = x.field
        t, m = self.threshold, len(self.parties)
        if field.characteristic == 2:
            md = int(field.modulus)
            out = self._fused_flat(
                (2, md, t, 'reshare'),
                lambda: pipelines.make_reshare2_step(md, t, m), [x.data])
            return field.array.from_data(out)
        out = self._fused_flat(
            (field.modulus, t, 'reshare'),
            lambda: pipelines.make_reshare_step(field.modulus, t, m),
            [x.data])
        return field.array.from_data(out)

    def np_matmul(self, a, b):
        """Secure matrix product, numpy's matmul semantics on the logical
        shapes (vectors promoted; the party axis broadcasts as the leading
        batch axis). Two secure operands (public-valued secure arrays
        included) take a field matmul of the shares and one reshare; a
        public operand (an integer array) gives a local product."""
        stype = self._sectype(a, b)
        both_sec = all(isinstance(x, sectypes.SecureArray) for x in (a, b))
        a_int, b_int = self._integral(a), self._integral(b)
        m = len(self.parties)
        ops = []
        for x in (a, b):
            x = self._coerce_op(stype, x)
            # public-valued arrays enter without a party axis: the matmul
            # broadcasts them, as the constant sharing would be
            party = not self._is_public(x)
            d = x.share.data
            ops.append([d, party, tuple(d.shape[1 if party else 0:-1])])
        (da, pa, la), (db, pb, lb) = ops
        a_vec, b_vec = len(la) == 1, len(lb) == 1
        if a_vec:
            da, la = da.unsqueeze(-3), (1,) + la
        if b_vec:
            db, lb = db.unsqueeze(-2), lb + (1,)
        rank = max(len(la), len(lb))
        L = da.shape[-1]
        if pa and len(la) < rank:
            da = da.reshape((m,) + (1,) * (rank - len(la)) + la + (L,))
        if pb and len(lb) < rank:
            db = db.reshape((m,) + (1,) * (rank - len(lb)) + lb + (L,))
        c = stype.field.array.ctx.matmul(da, db)
        if a_vec:
            c = c[..., 0, :, :]
        if b_vec:
            c = c[..., 0, :]
        c = stype.field.array.from_data(c)
        f = stype.sectype.frac_length
        if not (pa or pb):
            if not (both_sec or f):
                return stype(c)
            c = c.from_data(c.data.expand((m,) + tuple(c.data.shape)))
        # fixed point (mpyc_tpu/parallel/simulator.py:890-929): by an
        # integral operand an exact division by 2^f before the reshare,
        # else a truncation after it
        if f and (a_int or b_int):
            c = c >> f
        if both_sec:
            c = self._reshare(c)
        if f and not (a_int or b_int):
            c = self._trunc_field(c, f, stype.sectype.bit_length + f)
        return self._wrap(stype, c, a_int and b_int)

    def _mul_reshare_fused(self, sa, sb):
        """Whole secure multiplication (local product + GRR98 reshare) as
        one fused step: kernel K3 on the card. At t = 0 the local product
        alone, as the JAX package computes it there (its ``_reshare``
        returns the shares, ``mpyc_tpu/parallel/simulator.py:223``)."""
        field = sa.field
        t = self.threshold
        m = len(self.parties)
        if t == 0:
            return sa.from_data(sa.ctx.mul(sa.data, sb.data))
        out = self._fused_flat(
            (field.modulus, t, 'mul'),
            lambda: pipelines.make_reshare_step(field.modulus, t, m,
                                                fuse_mul=True),
            [sa.data, sb.data])
        return field.array.from_data(out)

    def _mul_reshared(self, u, v):
        """The product of field shares u (party-stacked) and v (party-
        stacked, or public without the party axis), shapes broadcast,
        reshared in one fused round (K3 on the card): the same shares as
        the local product reshared (``_reshare(u * v)``, as the JAX package
        computes it), since the round's stream does not depend on its
        input."""
        shape = torch.broadcast_shapes(u.data.shape[:-1], v.data.shape[:-1])
        L = u.data.shape[-1]
        return self._mul_reshare_fused(
            u.from_data(u.data.expand(shape + (L,))),
            v.from_data(v.data.expand(shape + (L,))))

    def _mul_reshare2_fused(self, sa, sb):
        """Whole GF(2^d) secure multiplication (carry-less product and
        GRR98 reshare) as one fused step (``mpyc_tpu/parallel/simulator.py:
        346``): K1's stream and one launch of K8 on the card; at t = 0 the
        local product alone."""
        field = sa.field
        t, m = self.threshold, len(self.parties)
        if t == 0:
            return sa * sb
        md = int(field.modulus)
        out = self._fused_flat(
            (2, md, t, 'mul'),
            lambda: pipelines.make_reshare2_step(md, t, m, fuse_mul=True),
            [sa.data, sb.data])
        return field.array.from_data(out)

    def _mul_field(self, a, b, stype):
        """Secure product over a finite field (``mpyc_tpu/parallel/
        simulator.py:396-417``): by a public operand (an int or element,
        a public array, or a secure array not yet input) a local product;
        of two secure operands one fused round, over GF(2^d) K8's
        (``_mul_reshare2_fused``), over GF(p) K3's (``_mul_reshare_fused``,
        one limb for p < 2^32)."""
        array = self._is_array_op(a, b)
        if not isinstance(b, sectypes.SecureObject) or self._is_public(b):
            if isinstance(b, sectypes.SecureObject):
                b = b.share
            elif not isinstance(b, finfields.FieldArray):
                b = self._coerce_op(stype, b).share
            sa = self._share(a)
            shape = torch.broadcast_shapes(sa.shape[1:], b.shape)
            c = sa.from_data(sa.ctx.mul(self._broadcast(sa.data, 1, shape),
                                        self._broadcast(b.data, 0, shape)))
            return self._wrap(stype, c, True, array)
        sa, sb = self._share2(a, b)
        fused = self._mul_reshare2_fused if stype.field.characteristic == 2 \
            else self._mul_reshare_fused
        return self._wrap(stype, fused(sa, sb), True, array)

    def mul(self, a, b):
        """Secure elementwise product of secure arrays: one fused round
        (K3) for two secure operands; a local scale, with no reshare, when
        one of them is public (an int, a numpy array, or a secure array
        not yet input). Fixed point (``mpyc_tpu/runtime.py:1415``,
        ``parallel/simulator.py:388-419``): by an integral operand the
        local product is divided by 2^f, exactly, and then reshared (K3
        without the product); any other product is truncated after it."""
        if not isinstance(a, sectypes.SecureObject):
            a, b = b, a
        stype = self._sectype(a, b)
        if issubclass(stype, sectypes.SecureFiniteFieldArray):
            if self._is_public(a):
                a, b = b, a
            return self._mul_field(a, b, stype)
        if not issubclass(stype, (sectypes.SecureIntegerArray,
                                  sectypes.SecureFixedPointArray)):
            raise NotImplementedError('the port multiplies secure integers '
                                      'and fixed-point numbers')
        f = stype.sectype.frac_length
        array = self._is_array_op(a, b)
        if isinstance(b, (int, np.integer)):
            return self._wrap(stype, self._share(a) * int(b),
                              self._integral(a), array)
        a_int, b_int = self._integral(a), self._integral(b)
        l_f = stype.sectype.bit_length + f
        b = self._coerce_op(stype, b)
        if self._is_public(a):
            a, b = b, a
        if self._is_public(b):
            sa = self._share(a)
            shape = torch.broadcast_shapes(sa.shape[1:], b.shape)
            c = sa.from_data(sa.ctx.mul(
                self._broadcast(sa.data, 1, shape),
                self._broadcast(b.share.data, 0, shape)))
            if f:
                c = c >> f if a_int or b_int else \
                    self._trunc_field(c, f, l_f)
            return self._wrap(stype, c, a_int and b_int, array)
        sa, sb = self._share2(a, b)
        if f and (a_int or b_int):
            c = self._reshare(sa.from_data(sa.ctx.mul(sa.data, sb.data))
                              >> f)
        else:
            c = self._mul_reshare_fused(sa, sb)
            if f:
                c = self._trunc_field(c, f, l_f)
        return self._wrap(stype, c, a_int and b_int, array)

    # Largest flat batch of one comparison step: inputs are cut into
    # chunks of 2^20 elements, each one step call that advances the
    # counter (the JAX package's _SGN_CHUNK, simulator.py:459).
    _SGN_CHUNK = 1 << 20
    # Chunk of fields of more than two limbs (SecInt(37)'s 69-bit field,
    # SecInt(64)'s 96-bit one). The JAX package cuts these to 1024 for its
    # compile time (simulator.py:470-475); the port has no such cost but
    # cuts the same, so that its call counter, and with it the stream, stays
    # the JAX package's. On the card one launch of K5 takes all the chunks.
    _SGN_CHUNK_WIDE = 1024

    def _sgn_chunk(self, L: int) -> int:
        return self._SGN_CHUNK if L <= 2 else self._SGN_CHUNK_WIDE

    def np_sgn(self, a, l=None, LT=False, EQ=False):
        """Secure signum of a secure integer array of l-bit values (default
        l: its type's bit length, read at call time): shares of -1, 0 or 1;
        with LT of the bit a < 0, with EQ of a == 0. The input is cut into
        chunks of up to 2^20 elements (1024 for fields of more than two
        limbs), each one comparison call on its shares padded to the bucket
        of the JAX package's CPU plane, with a counter of its own
        (``pipelines.sgn_chunks``): on the CPU one call of the plain
        version a chunk, on the card one launch of kernel K5 for all."""
        if LT and EQ:
            raise ValueError('LT and EQ exclude each other')
        stype = self._sectype(a)
        if not issubclass(stype, (sectypes.SecureIntegerArray,
                                  sectypes.SecureFixedPointArray)):
            raise NotImplementedError('the port compares secure integers '
                                      'and fixed-point numbers')
        if self.threshold == 0:
            raise NotImplementedError(self._AT_T0)
        p = stype.field.modulus
        l = l or stype.sectype.bit_length
        t, m, k = self.threshold, len(self.parties), self.sec_param
        f = stype.sectype.frac_length
        key = (p, t, l, k, LT, EQ, f)
        spec = self._sgn_specs.get(key)
        if spec is None:
            spec = self._sgn_specs[key] = pipelines.SgnSpec(
                p, t, m, l, k, LT=LT, EQ=EQ, f=f)
        sh = self._share(a)
        L = sh.ctx.L
        n = math.prod(a.shape)
        out, self._fused_ctr = pipelines.sgn_chunks(
            sh.data.reshape(m, n, L), self._fused_state_tensor(),
            self._fused_ctr, spec, self._sgn_chunk(L))
        return self._wrap(stype, stype.field.array.from_data(
            out.reshape((m,) + tuple(a.shape) + (L,))), True,
            self._is_array_op(a))

    def output(self, x, receivers=None, threshold=None, raw=False):
        """Open secure objects, or party-stacked field arrays: recombine
        the shares of parties 1..threshold+1 (default t + 1) at 0
        (``mpyc_tpu/parallel/simulator.py:183``). Secure arrays open to
        their values (SecInt: signed int64 below 2^64, else Python ints;
        SecFxp: float64), secure numbers to one int or float, or with
        ``raw`` to the field array; field arrays to field arrays. The one
        process plays every receiver, so ``receivers`` (an int or a list
        of parties) opens the values to it as to all, as in the JAX
        package's co-located plane."""
        if receivers is not None and not all(
                0 <= r < len(self.parties) for r in (
                    [receivers] if isinstance(receivers, int)
                    else receivers)):
            raise ValueError(f'receivers outside the {len(self.parties)} '
                             'parties')
        x_is_list = isinstance(x, list)
        xl = list(x) if x_is_list else [x]
        t = self.threshold if threshold is None else threshold
        ys = []
        for xi in xl:
            secure = isinstance(xi, sectypes.SecureObject)
            s = self._share(xi) if secure else xi
            pts = [(i + 1, s[i].flatten()) for i in range(t + 1)]
            rec = thresha.np_recombine(s.field, pts).reshape(s.shape[1:])
            ys.append(type(xi)._output_conversion(rec)
                      if secure and not raw else rec)
        return ys if x_is_list else ys[0]

    def reciprocal(self, a):
        """Secure reciprocal of a nonzero secure integer, or of each value
        of an array (``mpyc_tpu/parallel/simulator.py:947``): PRSS random
        r, the product r a reshared (K3 without the product) and opened,
        its public inverse (a power by p - 2, K6 on the card), and r / (r
        a); again with new r while an opened product is 0. A fixed-point
        value's is scaled by 2^(2 f)."""
        stype = self._sectype(a)
        field = stype.field
        m = len(self.parties)
        sa = self._share(a)
        logical = tuple(sa.shape[1:])
        n = max(math.prod(logical), 1)
        while True:
            r = self._np_randoms(field, n).reshape((m,) + logical)
            c = self.output(self._reshare(r * sa))
            if not c.ctx.any_zero(c.data):
                break
        res = r * c.reciprocal()
        f = stype.sectype.frac_length
        if f:
            res = res * (1 << 2 * f)
        return self._wrap(stype, res, False, self._is_array_op(a))

    def is_zero_public(self, a):
        """Whether a secure number is 0, or which values of a secure array
        are, made public and nothing more (``mpyc_tpu/runtime.py:1737``,
        ``parallel/simulator.py:792``): a times a random nonzero r,
        opened at threshold 2t. A number follows the JAX package's draws:
        in a field of at least 2k bits one PRSS value r (nonzero but with
        probability 1/p); in a smaller one PRSS values r and s until the
        opened r s is nonzero (with a PRSS zero-sharing added below k
        bits, and added to a r too). An array takes a blinder of its own
        for every value, drawn the same way (the smaller fields' pairs
        redrawn where their product opened to 0), so that the opened
        values do not reveal the ratios of a's values, as one r for all
        of them would. A bool, or a numpy bool array of a's shape."""
        field = a.field if isinstance(a, finfields.FieldArray) else \
            self._sectype(a).field
        share = a if isinstance(a, finfields.FieldArray) else self._share(a)
        m = len(self.parties)
        logical = tuple(share.shape[1:])
        n = math.prod(logical)
        rel_size = field.order.bit_length() // self.sec_param
        threshold = 2 * self.threshold
        prfs = self.prfs(field.order) if rel_size < 2 else None
        if rel_size >= 2:
            r = self._np_randoms(field, n)
        else:
            r = None
            todo = torch.arange(n, device=self.device)
            while todo.numel():
                rs = self._np_randoms(field, 2 * todo.numel())
                k = todo.numel()
                ri = rs.from_data(rs.data[:, :k])
                rs_prod = ri * rs.from_data(rs.data[:, k:])
                if rel_size == 0:
                    rs_prod = rs_prod + self._stacked_prss(
                        field, prfs, self._prss_uci(), k, zero=True)
                zero = rs_prod.ctx.is_zero(
                    self.output(rs_prod, threshold=threshold).data)
                if r is None:
                    r = ri
                else:
                    data = r.data.clone()
                    data[:, todo] = ri.data
                    r = r.from_data(data)
                todo = todo[zero]
        b = share * r.reshape((m,) + logical)
        if rel_size == 0:
            b = b + self._stacked_prss(field, prfs, self._prss_uci(),
                                       max(n, 1), zero=True).reshape(
                                           (m,) + logical)
        c = self.output(b, threshold=threshold)
        zero = c.ctx.is_zero(c.data).cpu().numpy()
        return bool(zero) if not logical else zero

    # -- PRSS, random bits and truncation -------------------------------------

    def _stacked_prss(self, field, prfs, uci: bytes, n: int, zero=False):
        """Party-stacked PRSS shares (m, n) of n pseudorandom values, or
        with ``zero`` of n zeros at degree 2t (``mpyc_tpu/parallel/
        simulator.py:648``): per subset S its PRF's values, times f_S at
        each member of S."""
        m = len(self.parties)
        acc = None
        for S, prf in prfs.items():
            d = m - len(S)
            vals = prf.field_array(field, uci, (n, d) if zero else (n,),
                                   self.device)
            rows = []
            for i in range(m):
                if i not in S:
                    rows.append(None)
                    continue
                y = vals
                if zero:
                    y = None
                    for j in range(d):
                        v = vals[:, j]
                        y = v if y is None else y + v
                        y = y * (i + 1)
                rows.append((y * thresha._f_S_i(field, m, i, S)).data)
            zeros = torch.zeros_like(next(r for r in rows if r is not None))
            stacked = field.array.from_data(torch.stack(
                [zeros if r is None else r for r in rows]))
            acc = stacked if acc is None else acc + stacked
        return acc

    def _stacked_prss_host(self, field, prfs, uci: bytes, n: int):
        """Party-stacked PRSS shares (m, n) of n pseudorandom values from
        the PRFs' host integer stream (``DevicePRF.host_integers``), for
        any bound, so that the same integers embed into every field
        (``mpyc_tpu/parallel/simulator.py:631``; ``thresha.py:515
        np_pseudorandom_share_host``)."""
        m = len(self.parties)
        acc = None
        for S, prf in prfs.items():
            vals = field.array(prf.host_integers(uci, (n,)), self.device)
            zeros = torch.zeros_like(vals.data)
            stacked = field.array.from_data(torch.stack(
                [(vals * thresha._f_S_i(field, m, i, S)).data if i in S
                 else zeros for i in range(m)]))
            acc = stacked if acc is None else acc + stacked
        return acc

    def _convert(self, x, t_type):
        """Conversion of the secure numbers or arrays x to t_type by one
        masked opening (``mpyc_tpu/parallel/simulator.py:536``), all items
        flattened into one batch: PRSS masks r drawn with one input in
        both fields, so that they hold the same integers (from an integer
        or fixed-point type values below a power of two, each field's
        device stream; from a secure field values below its order, the
        host stream), x + offset + r opened in the source field and
        embedded into the target (``_embed_field_values``), r and the
        offset subtracted there. From a secure field the opened value is
        reduced mod the source's order in the target, a secure integer
        type (``_mod``). A fixed-point source with more fractional bits
        than the target is truncated first; fewer, scaled after."""
        s_type = type(x[0])
        is_arr = issubclass(s_type, sectypes.SecureArray)
        s_ctype = s_type.sectype if is_arr else s_type
        t_ctype = getattr(t_type, 'sectype', t_type)
        s_field, t_field = s_ctype.field, t_ctype.field
        s_is_ff = issubclass(s_ctype, sectypes.SecureFiniteField)
        sizes = [math.prod(xi.shape) if is_arr else 1 for xi in x]
        shapes = [tuple(xi.shape) if is_arr else None for xi in x]
        n = sum(sizes)
        m, t = len(self.parties), self.threshold
        if s_is_ff:
            bound, l = s_field.order, None
        else:
            l = min(s_ctype.bit_length, t_ctype.bit_length)
            bound = 1 << max(0, (self.sec_param + l)
                             - math.comb(m, t).bit_length() + 1)
        prfs = self.prfs(bound)
        uci = self._prss_uci()
        if s_is_ff:
            s_r = self._stacked_prss_host(s_field, prfs, uci, n)
            t_r = self._stacked_prss_host(t_field, prfs, uci, n)
        else:
            s_r = self._stacked_prss(s_field, prfs, uci, n)
            t_r = self._stacked_prss(t_field, prfs, uci, n)
        d = t_ctype.frac_length - s_ctype.frac_length
        datas = [self._share(xi).data for xi in x]
        stacked = s_field.array.from_data(torch.cat(
            [dt.reshape(m, sz, dt.shape[-1]) for dt, sz in zip(datas, sizes)],
            dim=1))
        if d < 0:
            stacked = self._trunc_field(stacked, -d, s_ctype.bit_length)
        if s_field.is_signed:
            offset = s_field.order // 2 if s_is_ff else 1 << (l - 1)
        else:
            offset = 0
        c = self.output(stacked + offset + s_r)     # public, (n,)
        if s_is_ff:
            c_ints = np.array([int(v) for v in np.asarray(
                c.value, dtype=object).reshape(-1)], dtype=object)
            v = self._share_like(t_field.array(c_ints, self.device)) - t_r
            sec = self._mod(self._wrap(t_ctype.array, v, True),
                            int(s_field.modulus))
            v = self._share(sec) - offset
        else:
            v = self._share_like(self._embed_field_values(c, t_field)) \
                - t_r - offset
        if d > 0:
            v = v * (1 << d)
        integral = not s_ctype.frac_length
        out, off = [], 0
        for size, shape in zip(sizes, shapes):
            piece = v.from_data(v.data[:, off:off + size])
            off += size
            if shape is not None:
                out.append(self._wrap(t_ctype.array, piece.reshape(
                    (m,) + shape), integral))
            else:
                out.append(self._wrap(t_ctype.array, piece.reshape((m,)),
                                      integral, array=False))
        return out

    def _np_randoms(self, sftype, n: int, bound=None):
        """n PRSS random values of a field type (party-stacked field
        array) or a secure type (secure array), uniform mod p, or with a
        bound the sum over the C(m, t) subsets of values below 1 <<
        ((bound // C(m, t)).bit_length() - 1), a power of two
        (``mpyc_tpu/parallel/simulator.py:697``). One PRSS draw."""
        secure = issubclass(sftype, sectypes.SecureObject)
        field = sftype.field if secure else sftype
        m, t = len(self.parties), self.threshold
        if bound is None:
            bound = field.modulus
        else:
            bound = 1 << max(0, (bound // math.comb(m, t)).bit_length() - 1)
        x = self._stacked_prss(field, self.prfs(bound), self._prss_uci(), n)
        return self._wrap(sftype.array, x) if secure else x

    def _randoms(self, sftype, n: int, bound=None):
        """n PRSS random values as a list of secure numbers of sftype (a
        field type: the party-stacked field array), one PRSS draw
        (``mpyc_tpu/parallel/simulator.py:678``); see _np_randoms."""
        secure = issubclass(sftype, sectypes.SecureObject)
        x = self._np_randoms(sftype.field if secure else sftype, n, bound)
        if not secure:
            return x
        return [self._wrap(sftype.array, x.from_data(x.data[:, i]), False,
                           False) for i in range(n)]

    def _random(self, sftype, bound=None):
        """One PRSS random value (``mpyc_tpu/runtime.py:1235``)."""
        x = self._randoms(sftype, 1, bound)
        return x[0] if isinstance(x, list) else x.reshape(())

    def random_bits(self, sftype, n: int, signed=False):
        """n secret random bits as a list of secure numbers of sftype
        (fixed point: integral, times 2^f) or of 0-d field arrays
        (``mpyc_tpu/parallel/simulator.py:716``); see np_random_bits."""
        secure = issubclass(sftype, sectypes.SecureObject)
        arr = self.np_random_bits(sftype, n, signed)
        share = self._share(arr) if secure else arr
        pieces = [share.from_data(share.data[:, i]) for i in range(n)]
        if not secure:
            return pieces
        return [self._wrap(sftype.array, x, True, False) for x in pieces]

    def np_random_bits(self, sftype, n: int, signed=False):
        """n secret random bits (-1/1 with ``signed``), in a fixed-point
        type times 2^f (``mpyc_tpu/parallel/simulator.py:732``). A round
        draws PRSS values r and a PRSS zero-sharing z (two draws); its
        tail (``pipelines.random_bits_tail``, one launch of K7 on the card)
        opens u = r^2 + z at threshold 2t, flags u = 0 and counts the
        flags, and gives the bit of every r, (r / sqrt(u) + 1) / 2. A first
        round with no flag is the result (one read back, the count);
        otherwise the unflagged bits of each round are kept, in order,
        until n are kept."""
        secure = issubclass(sftype, sectypes.SecureObject)
        field = sftype.field if secure else sftype
        if field.characteristic == 2:
            # a PRSS value of one bit (``mpyc_tpu/parallel/simulator.py:
            # 744-751``): K1's stream above 256 blocks
            bits = self._stacked_prss(field, self.prfs(2), self._prss_uci(),
                                      n)
            return self._wrap(sftype.array, bits) if secure else bits
        f = sftype.frac_length if secure else 0
        prfs = self.prfs(field.modulus)
        parts = []
        need = n
        while need:
            r = self._stacked_prss(field, prfs, self._prss_uci(), need)
            z = self._stacked_prss(field, prfs, self._prss_uci(), need,
                                   zero=True)
            bits, flags, zeros = pipelines.random_bits_tail(
                r.data, z.data, field, signed, f, self.threshold)
            if not parts and int(zeros) == 0:
                parts = [bits]
                break
            idx = torch.nonzero(flags == 0).flatten()
            parts.append(bits[:, idx])
            need -= int(idx.numel())
        bits = field.array.from_data(parts[0] if len(parts) == 1
                                     else torch.cat(parts, dim=1))
        return self._wrap(sftype.array, bits) if secure else bits

    def _trunc_field(self, arr, f: int, l: int):
        """Party-stacked shares of l-bit values x -> shares of
        floor((x + r) / 2^f), r < 2^f from f secret random bits: x
        truncated, rounded up with probability (x mod 2^f) / 2^f
        (``mpyc_tpu/parallel/simulator.py:988``). Opens x + r + 2^(l - 1)
        + 2^f r', r' a PRSS value below 2^(k + l - f); f n random bits
        and one PRSS draw."""
        field = arr.field
        m = len(self.parties)
        logical = arr.shape[1:]
        n = math.prod(logical)
        flat = arr.reshape(m, n)
        bits = self.np_random_bits(field, f * n).reshape(m, n, f)
        r_modf = self._dot_pow2_last(bits)   # sum of bit j times 2^j
        r_divf = self._np_randoms(field, n, 1 << (self.sec_param + l - f))
        ar = flat + r_modf
        c = self.output(ar + ((1 << (l - 1)) + (r_divf << f)))
        y = (ar - c.mod_pow2(f)) >> f
        return y.reshape((m,) + logical)
