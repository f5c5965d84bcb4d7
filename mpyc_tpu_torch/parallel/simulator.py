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
output recombines the first t+1 shares at 0.

The fused rounds draw their coefficients from an independent SHAKE key
(``_fused_key``) with a call counter (``_fused_ctr``), as in the JAX
package. ``load_state`` takes the JAX runtime's key, counter and input
generator, after which both runtimes give the same shares bit for bit.

Trust model: one process holds all shares, so this plane is for
benchmarks, tests and co-located deployments only.
"""

from __future__ import annotations

import math
import secrets as _secrets

import numpy as np
import torch

from mpyc_tpu_torch import sectypes, thresha
from mpyc_tpu_torch.models import pipelines
from mpyc_tpu_torch.ops import keccak
from mpyc_tpu_torch.ops.rng import KeccakRNG
from mpyc_tpu_torch.runtime import Runtime


class SimRuntime(Runtime):
    """All parties in one runtime, with party-stacked shares."""

    def __init__(self, m: int, device=None):
        super().__init__(m, device)
        self._rng = KeccakRNG(device=self.device)
        self._fused_key = _secrets.token_bytes(32)
        self._fused_state = None
        self._fused_ctr = np.zeros(2, np.uint32)
        self._fused_steps = {}
        self._sgn_specs = {}

    def load_state(self, fused_key: bytes, ctr, rng_key: bytes,
                   rng_nonce: int) -> None:
        """Continue from another runtime's randomness state: the fused
        reshare key and call counter (lo, hi), and the input generator's
        key and nonce (the JAX package's ``SimRuntime._fused_key``,
        ``_fused_ctr``, ``_rng.key`` and ``_rng._nonce``)."""
        self._fused_key = bytes(fused_key)
        self._fused_state = None
        self._fused_ctr = np.array(np.asarray(ctr, dtype=np.uint32)
                                   .reshape(2))
        self._rng.load(rng_key, rng_nonce)

    def _distribute(self, x, senders):
        m = len(self.parties)
        t = self.threshold
        y = []
        for _peer in senders:
            objs = []
            for xi in x:
                stype = type(xi)
                field = stype.field
                secret = xi.share
                flat = secret.flatten() if secret.shape else secret.reshape(1)
                sh = thresha.np_random_split(field, flat, t, m, self._rng)
                objs.append(self._wrap(stype, sh.reshape((m,) + xi.shape)))
            y.append(objs)
        return y

    @staticmethod
    def _wrap(stype, share):
        res = stype(share)
        res.shape = share.shape[1:]
        return res

    @staticmethod
    def _is_public(x) -> bool:
        """x is a secure array not yet input: its share has no party axis."""
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

    def _local(self, a, fn):
        """Secure array of fn(party-stacked share data): a local shape
        operation that keeps the party axis first and the limb axis last."""
        share = self._share(a)
        return self._wrap(type(a), share.from_data(fn(share.data)))

    def np_getitem(self, a, idx):
        """a[idx] along the logical axes (local): integers, slices with a
        positive step, None and one Ellipsis."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        if Ellipsis in idx:
            k = idx.index(Ellipsis)
            used = sum(i is not None for i in idx) - 1
            idx = idx[:k] + (slice(None),) * (len(a.shape) - used) + \
                idx[k + 1:]
        return self._local(a, lambda d: d[(slice(None),) + idx])

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
        return self._wrap(type(a), share.from_data(data))

    def _reshare(self, x):
        """GRR98 degree reduction of party-stacked field-array shares, one
        fused round (K3 without the local product) of any logical shape."""
        if self.threshold == 0:
            return x
        field = x.field
        t, m = self.threshold, len(self.parties)
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
        if not (pa or pb):
            if not both_sec:
                return stype(c)
            c = c.from_data(c.data.expand((m,) + tuple(c.data.shape)))
        if both_sec:
            c = self._reshare(c)
        return self._wrap(stype, c)

    def _mul_reshare_fused(self, sa, sb):
        """Whole secure multiplication (local product + GRR98 reshare) as
        one fused step: kernel K3 on the card."""
        field = sa.field
        t = self.threshold
        m = len(self.parties)
        out = self._fused_flat(
            (field.modulus, t, 'mul'),
            lambda: pipelines.make_reshare_step(field.modulus, t, m,
                                                fuse_mul=True),
            [sa.data, sb.data])
        return field.array.from_data(out)

    def mul(self, a, b):
        """Secure elementwise product of secure integer arrays: one fused
        round (K3) for two secure operands; a local scale, with no reshare,
        when one of them is public (an int, an integer array, or a secure
        array not yet input)."""
        if not isinstance(a, sectypes.SecureIntegerArray):
            a, b = b, a
        if not isinstance(a, sectypes.SecureIntegerArray):
            raise NotImplementedError('the port multiplies secure integer '
                                      'arrays')
        stype = type(a)
        if isinstance(b, (int, np.integer)):
            return self._wrap(stype, self._share(a) * int(b))
        b = self._coerce_op(stype, b)
        if self._is_public(a):
            a, b = b, a
        if self._is_public(b):
            sa = self._share(a)
            shape = torch.broadcast_shapes(sa.shape[1:], b.shape)
            return self._wrap(stype, sa.from_data(sa.ctx.mul(
                self._broadcast(sa.data, 1, shape),
                self._broadcast(b.share.data, 0, shape))))
        if self.threshold == 0:
            raise NotImplementedError('the port needs t >= 1')
        sa, sb = self._share2(a, b)
        return self._wrap(stype, self._mul_reshare_fused(sa, sb))

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
        if not isinstance(a, sectypes.SecureIntegerArray):
            raise NotImplementedError('the port compares secure integer '
                                      'arrays')
        if self.threshold == 0:
            raise NotImplementedError('the port needs t >= 1')
        stype = type(a)
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
            out.reshape((m,) + tuple(a.shape) + (L,))))

    def output(self, x):
        """Open secure arrays: recombine the shares of parties 1..t+1 at 0;
        SecInt arrays open to signed int64 values."""
        x_is_list = isinstance(x, list)
        xl = list(x) if x_is_list else [x]
        t = self.threshold
        ys = []
        for xi in xl:
            field = type(xi).field
            s = self._share(xi)
            pts = [(i + 1, s[i].flatten()) for i in range(t + 1)]
            rec = thresha.np_recombine(field, pts).reshape(s.shape[1:])
            ys.append(type(xi)._output_conversion(rec))
        return ys if x_is_list else ys[0]
