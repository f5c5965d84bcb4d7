"""Fused protocol rounds, each one step: reshare, split/recombine, compare.

Port of ``mpyc_tpu/models/pipelines.py``: ``make_reshare_step`` (the GRR98
round with the local product, kernel K3), ``make_reshare2_step`` (its
twin over GF(2^d), kernel K8), ``make_split_recombine``
(the Shamir round trip, kernel K4) and ``make_sgn_step`` (the whole
secure comparison, kernel K5), and the tail of a round of random bits
around its inverse square root (``random_bits_tail``, kernel K7, which the
JAX package leaves to XLA). On the card each step is one launch of its kernel
(``csrc/kernels.cu``, ``csrc/sgn.cuh``, ``csrc/pow.cuh``, ``csrc/gf2.cu``;
from 7 to 48 limbs ``csrc/wide.cu`` and ``csrc/sgn_wide.cu``);
on the CPU its plain version (``_reshare_mul_plain``,
``_reshare2_plain``, ``_split_recombine_plain``, ``_sgn_step_plain``,
``_random_bits_tail_plain``) runs the same arithmetic in torch. The plain versions draw their
randomness through the plain versions of K1 and K2 on every device.

Stream layout. The JAX package lays out the coefficient stream one way in
its Pallas kernel (element g*S*1024 + e*1024 + r*128 + c takes slot e of
sponge g*1024 + r*128 + c, pipelines.py:185-193) and another in its XLA
twin ``step_xla`` (draw k*n + e comes from block (k*n + e) // epb of the
``squeeze_mont`` stream, pipelines.py:151). The port follows the XLA
layout, which is the one the JAX package runs on the CPU, so the port's
steps equal ``mpyc_tpu``'s bit for bit there, for the same shares, state
and counter. The same holds for the comparison (Pallas pipelines.py:616-641
against XLA :859-892).

Launch counts. Each wrapper of a kernel adds one to its ``launches`` where
it launches the kernel, and to ``by_key[instantiation]`` beside it (K3:
(L, fused); K5: (mode, l, L, f); K7: (L, lazy); K8: (d, fused)), so a
caller can tell which instantiations a path ran. K5 also adds the launch's comparison calls (chunks) to
``sgn_step.chunks``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from mpyc_tpu_torch import finfields, gfpx, thresha
from mpyc_tpu_torch.ops import fieldops, keccak, limb
from mpyc_tpu_torch.ops import rng as rng_mod
from mpyc_tpu_torch.ops.binary import binary_field_ctx
from mpyc_tpu_torch.ops.fieldops import prime_field_ctx


def _lagrange_consts_mont(p: int, xs, x_r: int = 0) -> list:
    """Lagrange coefficients at x_r for the points xs, as Montgomery limbs."""
    ctx = prime_field_ctx(p)
    vec = thresha._recombination_vector(finfields.GF(p), tuple(xs), x_r)
    return [ctx.encode_const(c) for c in vec]


def parties_key(t: int, m: int) -> tuple:
    """The end of a kernel's ``by_key`` key for threshold t and m
    parties: nothing at (1, 3), the instantiations of the earlier slices
    (whose keys stay as they were), else (t, m)."""
    return () if (t, m) == (1, 3) else (t, m)


class ReshareSpec:
    """The constants of one (p, t, m) reshare round."""

    def __init__(self, p: int, t: int, m: int):
        if 2 * t + 1 > m:
            raise ValueError('GRR98 needs 2t+1 <= m')
        self.p, self.t, self.m = p, t, m
        self.ctx = ctx = prime_field_ctx(p)
        self.n_send = 2 * t + 1
        self.lag = _lagrange_consts_mont(p, range(1, self.n_send + 1))
        self.xs_mont = [ctx.encode_const(i) for i in range(1, m + 1)]
        self.l_bytes = rng_mod.fused_draw_bytes(p)

    def field_ops(self, fused: bool) -> tuple:
        """(Montgomery products, modular adds) per element as K3 computes
        them (csrc/kernels.cu reshare_kernel), the reduction of its t draws
        left out: the 2t + 1 senders' local products (fused), their
        Lagrange sum, and Horner's t steps at each of the m points."""
        t, m, ns = self.t, self.m, self.n_send
        return ns * (2 if fused else 1) + m * t, ns - 1 + m * t

    def wide_consts(self, device) -> torch.Tensor:
        """The wide K3's device buffer (csrc/wide.cu reshare_wide_kernel):
        p, the radix table of its two-chunk draws, the 2t + 1 Lagrange
        coefficients and the m points, L words each; made once for each
        device."""
        from mpyc_tpu_torch import _build
        W, L = self.l_bytes // 4, self.ctx.L
        if not _build.wide(L) or W != L + 2:
            raise NotImplementedError(
                f'the wide CUDA reshare is built for {_build.WIDE_MIN_NL} to '
                f'{_build.WIDE_MAX_NL} limbs with draws of 4 (L + 2) bytes; '
                f'not L={L} ({self.l_bytes}-byte draws)')
        _build.check_parties('wide reshare', self.t, self.m)
        cache = self.__dict__.setdefault('_wide', {})
        if str(device) not in cache:
            cache[str(device)] = _build.wide_words(
                device, self.ctx.p_limbs, *self.ctx.radix_limbs(2),
                *self.lag, *self.xs_mont)
        return cache[str(device)]

    def params(self, nonce):
        """Kernel parameter block for a call with counter (lo, hi)."""
        from mpyc_tpu_torch import _build
        W, L = self.l_bytes // 4, self.ctx.L
        if L not in _build.BUILT_NL or W != L + 2:
            raise NotImplementedError(
                f'the CUDA reshare is built for fields of {_build.BUILT_NL} '
                f'limbs with draws of 4 (L + 2) bytes; not L={L} '
                f'({self.l_bytes}-byte draws)')
        _build.check_parties('reshare', self.t, self.m)
        P = _build.ReshareParams()
        P.draw = _build.draw_params(self.ctx, -(-W // L))
        for i, c in enumerate(self.lag):
            _build.set_limbs(P.lag[i], c)
        for j, x in enumerate(self.xs_mont):
            _build.set_limbs(P.xs[j], x)
        P.nonce_lo, P.nonce_hi = int(nonce[0]), int(nonce[1])
        P.t, P.m, P.n_send = self.t, self.m, self.n_send
        return P


def _add_ctr(ctr, k: int = 1) -> np.ndarray:
    """The call counter (lo, hi) advanced by k, with the carry."""
    v = (int(ctr[0]) | int(ctr[1]) << 32) + k
    return np.array([v & 0xFFFFFFFF, v >> 32 & 0xFFFFFFFF], np.uint32)


def _nonce_state(state: torch.Tensor, nonce) -> torch.Tensor:
    """The state with the per-call counter XORed into lane 4 (lo, hi)."""
    st = state.clone()
    st[1, 4] ^= int(np.array(nonce[0], np.uint32).view(np.int32))
    st[0, 4] ^= int(np.array(nonce[1], np.uint32).view(np.int32))
    return st


def _check_aligned(*tensors) -> None:
    """K3 and K5 load and store an element of a two-limb field as one
    8-byte word (more limbs as 4-byte words)."""
    if any(t is not None and t.shape[-1] == 2 and t.data_ptr() % 8
           for t in tensors):
        raise ValueError('shares must start on an 8-byte boundary')


def _reshare_mul_plain(a: torch.Tensor, b, state: torch.Tensor, nonce,
                       spec: ReshareSpec) -> torch.Tensor:
    """Plain version of K3, the JAX package's ``step_xla``: (m, n, L) shares
    (times b's when b is given) -> (m, n, L) reshared shares."""
    ctx, t, m = spec.ctx, spec.t, spec.m
    n = a.shape[1]
    p_l, n0 = ctx.p_limbs, ctx.n0inv
    if b is not None:
        a = limb.stack(limb.mont_mul(limb.unstack(a), limb.unstack(b), p_l,
                                     n0))
    coefs = rng_mod._squeeze_mont_plain(_nonce_state(state, nonce), t * n,
                                        spec.l_bytes, spec.p)
    coefs = coefs.reshape(t, n, ctx.L)
    S = None
    for i in range(spec.n_send):
        term = limb.mont_mul(limb.unstack(a[i]), spec.lag[i], p_l, n0)
        S = term if S is None else limb.add_mod(S, term, p_l)
    C = [limb.unstack(coefs[k]) for k in range(t)]
    rows = []
    for j in range(m):
        y = None
        for k in range(t):
            y = C[k] if y is None else limb.add_mod(y, C[k], p_l)
            y = limb.mont_mul(y, spec.xs_mont[j], p_l, n0)
        rows.append(limb.stack(limb.add_mod(y, S, p_l)))
    return torch.stack(rows, dim=0)


def reshare_mul(a: torch.Tensor, b, state: torch.Tensor, nonce,
                spec: ReshareSpec) -> torch.Tensor:
    """K3: one GRR98 round on (m, n, L) int32 shares, with the local
    product a*b first when b is given.

    Replaces ``mpyc_tpu/models/pipelines.py:make_reshare_step`` ->
    ``make_pallas.kernel``. nonce: the call counter (lo, hi). CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (``csrc/kernels.cu reshare_kernel``; from 7 to 48 limbs ``csrc/
    wide.cu reshare_wide_kernel``)."""
    m, L = spec.m, spec.ctx.L
    if a.dim() != 3 or a.shape[0] != m or a.shape[2] != L or \
            a.dtype != torch.int32:
        raise ValueError(f'shares must be ({m}, n, {L}) int32')
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or b.device != a.device):
        raise ValueError('both operands must have the same shape and device')
    if state.device != a.device:
        raise ValueError('state and shares must be on one device')
    if a.device.type == 'cpu':
        return _reshare_mul_plain(a, b, state, nonce, spec)
    from mpyc_tpu_torch import _build
    wide = _build.wide(L)
    if wide:
        consts = spec.wide_consts(a.device)
    else:
        params = spec.params(nonce)
    a = a.contiguous()
    b = b.contiguous() if b is not None else None
    _check_aligned(a, b)
    state = state.contiguous()
    out = torch.empty_like(a)
    if wide:
        _build.call('mtt_reshare_wide', a.data_ptr(),
                    b.data_ptr() if b is not None else None, out.data_ptr(),
                    state.data_ptr(), a.shape[1], int(b is not None),
                    consts.data_ptr(), spec.ctx.n0inv, L, int(nonce[0]),
                    int(nonce[1]), spec.t, spec.m,
                    _build.stream_of(a.device))
    else:
        _build.call('mtt_reshare', a.data_ptr(),
                    b.data_ptr() if b is not None else None, out.data_ptr(),
                    state.data_ptr(), a.shape[1], int(b is not None),
                    ctypes.addressof(params), _build.stream_of(a.device))
    reshare_mul.launches += 1
    reshare_mul.by_key[(L, b is not None)
                       + parties_key(spec.t, spec.m)] += 1
    return out


reshare_mul.launches = 0
reshare_mul.by_key = collections.Counter()   # (L, fused) + parties_key


def make_reshare_step(p: int, t: int, m: int, fuse_mul: bool = False):
    """Single-step GRR98 degree reduction on party-stacked shares.

    step(shares, state, ctr) -> (out, ctr'), or with fuse_mul
    step(a, b, state, ctr) -> (out, ctr'):
      shares, a, b: (m, ..., L) int32 Montgomery limbs, degree 2t (or the
        degree-t factors of the product when fuse_mul);
      state: (2, 25) int32 absorbed SHAKE128 prefix (key || 8-byte zero
        nonce slot), on the shares' device;
      ctr: (2,) uint32 numpy call counter (lo, hi), kept on the host, so a
        call needs no transfer from the card; it advances as in the JAX
        package (lo + 1, with a carry into hi).

    The round (pipelines.py:87 docstring): out_j = Horner(C, x_j) + S with
    S = sum_{i<=2t} lag_i s_i and the t aggregated coefficients C_k drawn
    directly from the stream.
    """
    spec = ReshareSpec(p, t, m)

    def _step(shares, state, ctr, shares_b=None):
        orig_shape = shares.shape
        n = math.prod(orig_shape[1:-1])
        flat = shares.reshape(m, n, spec.ctx.L)
        flat_b = shares_b.reshape(m, n, spec.ctx.L) \
            if shares_b is not None else None
        ctr = np.asarray(ctr, dtype=np.uint32)
        out = reshare_mul(flat, flat_b, state, (int(ctr[0]), int(ctr[1])),
                          spec)
        return out.reshape(orig_shape), _add_ctr(ctr)

    if fuse_mul:
        def step(a, b, state, ctr):
            return _step(a, state, ctr, shares_b=b)
    else:
        def step(shares, state, ctr):
            return _step(shares, state, ctr)
    return step


# ---------------------------------------------------------------------------
# K8: the GRR98 round over GF(2^d), squeezing its own stream
# ---------------------------------------------------------------------------

class Reshare2Spec:
    """The constants of one (f, t, m) reshare round over GF(2^d), d <= 32
    (``mpyc_tpu/models/pipelines.py:1065 make_reshare2_step``): the
    Lagrange coefficients at 0 of the points 1..2t+1 and the party points
    1..m, all read as polynomials (3 is x + 1), and the draws' width,
    ceil(d / 8) bytes."""

    def __init__(self, modulus: int, t: int, m: int):
        if 2 * t + 1 > m:
            raise ValueError('GRR98 needs 2t+1 <= m')
        self.modulus, self.t, self.m = int(modulus), t, m
        self.field = finfields.GF(gfpx.GFpX(2)(self.modulus))
        self.ctx = binary_field_ctx(self.modulus)
        self.d = self.ctx.d
        self.n_send = 2 * t + 1
        self.lag = thresha._recombination_vector(
            self.field, tuple(range(1, self.n_send + 1)), 0)
        self.xs = [self.field(j + 1).value for j in range(m)]
        self.l_bytes = (self.d + 7) // 8

    def n_draws(self, n: int) -> int:
        """The coefficient draws of a call on n elements: t (2t + 1) n."""
        return self.t * self.n_send * n

    def n_blocks(self, n: int) -> int:
        """The stream's blocks a call on n elements takes."""
        return max(rng_mod.blocks_needed(self.n_draws(n), self.l_bytes), 1)

    def field_ops(self, fused: bool) -> int:
        """General carry-less products of an element as K8 computes them:
        the 2t + 1 local ones (fused). At the points 1, x, x + 1 every
        Lagrange coefficient is 1 and Horner's products by x and x + 1
        are a shift and XORs, none of them a general product."""
        return self.n_send if fused else 0

    @functools.cached_property
    def _params(self):
        from mpyc_tpu_torch import _build
        if (self.t, self.m) != (1, 3):
            raise NotImplementedError(
                f'the CUDA GF(2^d) reshare is built for (t, m) = (1, 3), '
                f'not ({self.t}, {self.m})')
        if any(int(c) != 1 for c in self.lag) or \
                [int(x) for x in self.xs] != [1, 2, 3]:
            raise NotImplementedError(
                'the CUDA GF(2^d) reshare is built for the points 1, x, '
                'x + 1 with Lagrange coefficients 1')
        P = _build.Reshare2Params()
        for j, r in enumerate(self.ctx.red):
            P.red[j] = r
        P.d = self.d
        return P

    def params(self, nonce):
        """K8's parameter block for a call with counter (lo, hi)."""
        from mpyc_tpu_torch import _build
        P = _build.Reshare2Params.from_buffer_copy(self._params)
        P.nonce_lo, P.nonce_hi = int(nonce[0]), int(nonce[1])
        return P


def _reshare2_stream_plain(state: torch.Tensor, nonce, n: int,
                           spec: Reshare2Spec) -> torch.Tensor:
    """The stream of a call on n elements as K1's plain version squeezes
    it: blocks 0.. of the absorbed state with the call's counter (lo, hi)
    XORed into lane 4, the block counter in lane 19 ((n_blocks, 42) int32
    words)."""
    return keccak._keccak_ctr_plain(_nonce_state(state, nonce),
                                    spec.n_blocks(n), 19)


def _reshare2_plain(a: torch.Tensor, b, state: torch.Tensor, nonce,
                    spec: Reshare2Spec) -> torch.Tensor:
    """Plain version of K8, ``make_reshare2_step``'s arithmetic: (m, n, 1)
    int32 GF(2^d) shares (times b's when b is given) -> (m, n, 1) reshared
    shares, the coefficients drawn from the call's stream
    (``_reshare2_stream_plain``). Coefficient k, sender i of element e is
    draw (k (2t + 1) + i) n + e: ceil(d / 8) little-endian bytes, masked
    to d bits."""
    ctx, t, m, ns = spec.ctx, spec.t, spec.m, spec.n_send
    n = a.shape[1]
    flat = a.reshape(m, n)
    if b is not None:
        flat = ctx.clmul_reduce(flat, b.reshape(m, n))
    blocks = _reshare2_stream_plain(state, nonce, n, spec)
    coefs = rng_mod.words_to_elements(blocks, spec.n_draws(n),
                                      spec.l_bytes, 1)[:, 0, 0]
    if spec.d < 32:
        coefs = coefs & ctx.mask
    coefs = coefs.reshape(t, ns, n)

    def cmul(c, x):     # c x; at the points 1..3 every lag is 1
        if c == 1:
            return x
        return ctx.clmul_reduce(x, torch.full((), finfields._i32(c),
                                              dtype=torch.int32,
                                              device=x.device))
    S = None
    for i in range(ns):
        term = cmul(spec.lag[i], flat[i])
        S = term if S is None else S ^ term
    C = []
    for k in range(t):
        acc = None
        for i in range(ns):
            term = cmul(spec.lag[i], coefs[k, i])
            acc = term if acc is None else acc ^ term
        C.append(acc)
    rows = []
    for j in range(m):
        y = None
        for k in range(t):
            y = C[k] if y is None else y ^ C[k]
            y = cmul(spec.xs[j], y)
        rows.append(y ^ S)
    return torch.stack(rows, dim=0).reshape(m, n, 1)


def reshare2(a: torch.Tensor, b, state: torch.Tensor, nonce,
             spec: Reshare2Spec) -> torch.Tensor:
    """K8: one GRR98 round over GF(2^d) on (m, n, 1) int32 shares, with
    the carry-less product a*b first when b is given, its coefficients
    drawn from the call's stream of the absorbed state ((2, 25) int32)
    and the call counter nonce (lo, hi), which the kernel squeezes
    itself.

    Replaces ``mpyc_tpu/models/pipelines.py:1065 make_reshare2_step`` (an
    XLA program around K1). CPU tensors take the plain version; CUDA
    tensors launch the kernel (``csrc/gf2.cu``)."""
    m = spec.m
    if a.dim() != 3 or a.shape[0] != m or a.shape[2] != 1 or \
            a.dtype != torch.int32:
        raise ValueError(f'shares must be ({m}, n, 1) int32')
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or b.device != a.device):
        raise ValueError('both operands must have the same shape and device')
    if state.device != a.device:
        raise ValueError('state and shares must be on one device')
    if a.device.type == 'cpu':
        return _reshare2_plain(a, b, state, nonce, spec)
    from mpyc_tpu_torch import _build
    params = spec.params(nonce)
    a = a.contiguous()
    b = b.contiguous() if b is not None else None
    state = state.contiguous()
    out = torch.empty_like(a)
    _build.call('mtt_reshare2', a.data_ptr(),
                b.data_ptr() if b is not None else None, out.data_ptr(),
                state.data_ptr(), a.shape[1], int(b is not None),
                ctypes.addressof(params), _build.stream_of(a.device))
    reshare2.launches += 1
    reshare2.by_key[(spec.d, b is not None)] += 1
    return out


reshare2.launches = 0
reshare2.by_key = collections.Counter()   # launches by (d, fused)


def make_reshare2_step(modulus: int, t: int, m: int, fuse_mul: bool = False):
    """Single-step GRR98 degree reduction over GF(2^d) on party-stacked
    shares (``mpyc_tpu/models/pipelines.py:1065``).

    step(shares, state, ctr) -> (out, ctr'), or with fuse_mul
    step(a, b, state, ctr) -> (out, ctr'): shares, a, b (m, ..., 1) int32
    elements; state (2, 25) int32 absorbed SHAKE128 prefix on their
    device; ctr the (2,) uint32 host counter (lo, hi), advanced by one.
    The round is one K8 launch, which squeezes the call's stream itself:
    out_j = Horner(C, x_j) + S, S = sum_{i <= 2t} lag_i s_i, C_k =
    sum_i lag_i r_{k,i}, as the JAX package's XLA program computes it."""
    spec = Reshare2Spec(modulus, t, m)

    def _step(shares, state, ctr, shares_b=None):
        orig_shape = shares.shape
        n = math.prod(orig_shape[1:-1])
        flat = shares.reshape(m, n, 1)
        flat_b = shares_b.reshape(m, n, 1) if shares_b is not None else None
        ctr = np.asarray(ctr, dtype=np.uint32)
        out = reshare2(flat, flat_b, state, (int(ctr[0]), int(ctr[1])),
                       spec)
        return out.reshape(orig_shape), _add_ctr(ctr)

    if fuse_mul:
        def step(a, b, state, ctr):
            return _step(a, state, ctr, shares_b=b)
    else:
        def step(shares, state, ctr):
            return _step(shares, state, ctr)
    return step


# ---------------------------------------------------------------------------
# K4: the Shamir round trip (split at x = 1..m, recombine at 0)
# ---------------------------------------------------------------------------

class SplitSpec:
    """The constants of one (p, t, m) split/recombine round."""

    def __init__(self, p: int, t: int, m: int):
        if not 1 <= t < m:
            raise ValueError('the round needs 1 <= t < m')
        self.p, self.t, self.m = p, t, m
        self.ctx = ctx = prime_field_ctx(p)
        self.lag = _lagrange_consts_mont(p, range(1, t + 2))
        self.xs_mont = [ctx.encode_const(i) for i in range(1, m + 1)]
        self.l_bytes = rng_mod.fused_draw_bytes(p)

    def field_ops(self) -> tuple:
        """(Montgomery products, modular adds) per element as K4 computes
        them, the reduction of its draws left out: m Horner rows of t
        steps, then the Lagrange sum of t + 1 of them."""
        t, m = self.t, self.m
        return m * t + t + 1, m * t + t

    def params(self):
        """Kernel parameter block (``ReshareParams``, lag of t + 1)."""
        from mpyc_tpu_torch import _build
        if self.ctx.L != 2:
            raise NotImplementedError(
                f'the CUDA split/recombine is built for 2-limb fields, not '
                f'L = {self.ctx.L}')
        _build.check_parties('split/recombine', self.t, self.m)
        P = _build.ReshareParams()
        P.draw = _build.draw_params(self.ctx, 2)
        for i, c in enumerate(self.lag):
            _build.set_limbs(P.lag[i], c)
        for j, x in enumerate(self.xs_mont):
            _build.set_limbs(P.xs[j], x)
        P.t, P.m, P.n_send = self.t, self.m, self.t + 1
        return P


def _split_recombine_plain(secrets: torch.Tensor, state: torch.Tensor,
                           spec: SplitSpec):
    """Plain version of K4, the JAX package's ``make_split_recombine``:
    (n, L) Montgomery secrets -> (recombined (n, L), shares (m, n, L)).

    Coefficient k of element e is draw k*n + e of the ``squeeze_mont``
    stream of ``state`` (counter in lane 19, no call nonce)."""
    ctx, t, m = spec.ctx, spec.t, spec.m
    n = secrets.shape[0]
    p_l, n0 = ctx.p_limbs, ctx.n0inv
    coefs = rng_mod._squeeze_mont_plain(state, t * n, spec.l_bytes, spec.p)
    C = [limb.unstack(c) for c in coefs.reshape(t, n, ctx.L)]
    s = limb.unstack(secrets)
    rows = []
    for j in range(m):
        y = None
        for k in range(t):
            y = C[k] if y is None else limb.add_mod(y, C[k], p_l)
            y = limb.mont_mul(y, spec.xs_mont[j], p_l, n0)
        rows.append(limb.add_mod(y, s, p_l))
    acc = None
    for i in range(t + 1):
        term = limb.mont_mul(rows[i], spec.lag[i], p_l, n0)
        acc = term if acc is None else limb.add_mod(acc, term, p_l)
    return limb.stack(acc), torch.stack([limb.stack(r) for r in rows])


def split_recombine(secrets: torch.Tensor, state: torch.Tensor,
                    spec: SplitSpec, shares: torch.Tensor | None = None):
    """K4: Shamir-split (n, L) int32 Montgomery secrets at x = 1..m with
    coefficients from the stream of ``state``, and recombine them at 0 from
    the shares of parties 1..t+1. The output equals the input.

    Replaces ``mpyc_tpu/models/pipelines.py:make_split_recombine_fused`` ->
    ``kernel``. ``shares``: an optional (m, n, L) int32 tensor that receives
    the shares (for checks; the round trip passes none). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    L = spec.ctx.L
    if secrets.dim() != 2 or secrets.shape[1] != L or \
            secrets.dtype != torch.int32:
        raise ValueError(f'secrets must be (n, {L}) int32')
    if state.device != secrets.device:
        raise ValueError('state and secrets must be on one device')
    n = secrets.shape[0]
    if shares is not None and (
            shares.shape != (spec.m, n, L) or shares.dtype != torch.int32
            or shares.device != secrets.device
            or not shares.is_contiguous()):
        raise ValueError(f'shares must be a contiguous ({spec.m}, {n}, {L}) '
                         'int32 tensor on the secrets\' device')
    if secrets.device.type == 'cpu':
        out, sh = _split_recombine_plain(secrets, state, spec)
        if shares is not None:
            shares.copy_(sh)
        return out
    from mpyc_tpu_torch import _build
    params = spec.params()
    secrets = secrets.contiguous()
    state = state.contiguous()
    out = torch.empty_like(secrets)
    if n:
        _build.call('mtt_split_recombine', secrets.data_ptr(),
                    out.data_ptr(),
                    shares.data_ptr() if shares is not None else None,
                    state.data_ptr(), n, ctypes.addressof(params),
                    _build.stream_of(secrets.device))
        split_recombine.launches += 1
        split_recombine.by_key[(spec.t, spec.m)] += 1
    return out


split_recombine.launches = 0
split_recombine.by_key = collections.Counter()   # launches by (t, m)


def make_split_recombine(p: int, t: int, m: int):
    """One Shamir round per element: step(secrets, state) -> recombined.

    secrets: (n, L) int32 Montgomery limbs; state: (2, 25) int32 absorbed
    SHAKE128 state on the same device. The counterpart of both
    ``make_split_recombine`` (XLA) and ``make_split_recombine_fused``
    (Pallas) of the JAX package: the coefficient randomness is generated
    inside the step, so its cost covers stream + split (Horner at m
    points) + recombination (Lagrange at 0 from t + 1 shares)."""
    spec = SplitSpec(p, t, m)

    def step(secrets, state):
        return split_recombine(secrets, state, spec)
    return step


# ---------------------------------------------------------------------------
# K5: the whole Toft-style secure comparison as one step
# ---------------------------------------------------------------------------

def _tree_levels(w: int) -> list:
    """Secure products of each level of a log-depth product tree of width
    w (a level of h products is one call of h draws per element)."""
    levels = []
    while w > 1:
        h = w // 2
        levels.append(h)
        w = h + (w % 2)
    return levels


def _point_adds(k: int) -> int:
    """Adds that multiply a field element by the small integer k >= 1 by
    doubling and adding (csrc/sgn_wide.cu mul_pt): a doubling for each bit
    below the top, an add for each set one."""
    return k.bit_length() - 1 + bin(k).count('1') - 1


def _lag_adds(n: int) -> int:
    """Adds that multiply a field element by each Lagrange coefficient at
    0 of the points 1..n, (-1)^(i - 1) C(n, i) (csrc/sgn_wide.cu
    mul_lag): the size's ``_point_adds``, and a subtraction from 0 for
    each negative one."""
    return sum(_point_adds(math.comb(n, i)) + (i + 1) % 2
               for i in range(1, n + 1))


def _powers_below(n: int) -> list:
    """1, 2, 4, ... below n: the steps of a Hillis-Steele scan of n."""
    out, h = [], 1
    while h < n:
        out.append(h)
        h *= 2
    return out


SGN_MODES = ('sgn', 'LT', 'EQ')


class SgnSpec:
    """The constants and stream budget of one comparison step.

    mode 'sgn' gives shares of sgn(a) in {-1, 0, 1}, 'LT' of a < 0, 'EQ'
    of a == 0, each times 2^f. Inputs are degree-t shares of l-bit signed
    integers; k is the statistical security parameter of the mask."""

    def __init__(self, p: int, t: int, m: int, l: int, k: int = 30,
                 LT: bool = False, EQ: bool = False, f: int = 0):
        if LT and EQ:
            raise ValueError('LT and EQ exclude each other')
        if 2 * t + 1 > m or t < 1:
            raise ValueError('GRR98 needs 1 <= t and 2t+1 <= m')
        if l < 1:
            raise ValueError('a comparison needs l >= 1')
        if l + k + 2 > p.bit_length():
            raise NotImplementedError(
                f'the masked open needs l + k + 2 <= bit length of p; the '
                f'JAX package compares wider values (l={l}, k={k}, '
                f'{p.bit_length()}-bit p) with its eager np_sgn '
                f'(mpyc_tpu/runtime.py:2728), which is not ported')
        self.p, self.t, self.m, self.l, self.k, self.f = p, t, m, l, k, f
        self.mode = 'LT' if LT else 'EQ' if EQ else 'sgn'
        self.ctx = ctx = prime_field_ctx(p)
        self.n_send = 2 * t + 1
        self.lb = l + (0 if EQ else 1)        # random bits (+ sign bit)
        self.l_bytes = rng_mod.fused_draw_bytes(p)
        self.lag_t = _lagrange_consts_mont(p, range(1, t + 2))
        self.lag_2t = _lagrange_consts_mont(p, range(1, self.n_send + 1))
        self.xs = [ctx.encode_const(i) for i in range(1, m + 1)]
        self.one = ctx.one_mont
        self.two = ctx.encode_const(2)
        self.three = ctx.encode_const(3)
        self.r2 = ctx.r2_limbs                # standard -> Montgomery
        self.pow2 = [ctx.encode_const(pow(2, j, p)) for j in range(l + 1)]
        self.inv2l = ctx.encode_const(pow(pow(2, l, p), -1, p))
        self.pow2l1 = ctx.encode_const(pow(2, l - 1, p))
        self.powf = ctx.encode_const(pow(2, f, p)) if f else None
        # stream A: per element wb words of bits, then wk words of r_divl
        self.wb = -(-self.lb // 32)
        self.wk = -(-k // 32)
        self.wpe = self.wb + self.wk

    def blocks_a(self, n: int) -> int:
        """Blocks of stream A (counter 0 on); stream B starts after."""
        return max(-(-n * self.wpe // (keccak.RATE // 4)), 1)

    def draw_calls(self) -> list:
        """The calls of stream B in the order they are taken, each as
        (sets, c): a call gives element e of n the draws
        off + kk*n*c + e*c + i (kk < sets, i < c). Bit-split coefficients,
        r_divl's, then (unless EQ) each level of the E tree, the blinder
        and its coefficients, (unless LT) each level of the ones-minus-xor
        tree, and in sgn mode the final reshare's."""
        t, l = self.t, self.l
        calls = [(t, self.lb), (t, 1)]
        if self.mode != 'EQ':
            calls += [(t, h) for h in _tree_levels(l + 1)] + [(1, 1), (t, 1)]
        if self.mode != 'LT':
            calls += [(t, h) for h in _tree_levels(l)]
        if self.mode == 'sgn':
            calls.append((t, 1))
        return calls

    def draws_per_element(self) -> int:
        """Stream-B field draws per element."""
        return sum(sets * c for sets, c in self.draw_calls())

    def blocks(self, n: int) -> int:
        """Sponge blocks of the whole stream of a call on n elements."""
        return self.blocks_a(n) + max(rng_mod.blocks_needed(
            n * self.draws_per_element(), self.l_bytes), 1)

    def field_ops(self, c_ones: float, groups: int | None = None) -> tuple:
        """(Montgomery products, modular adds and subtracts) per element of
        the comparison as K5 computes it (csrc/sgn.cuh; with ``groups``, as
        the wide K5 of csrc/sgn_wide.cu does with that many groups of lanes
        a CTA: ``_wide_field_ops``), the reduction of
        its stream draws left out: public bits enter by selects, r mod 2^l
        by doubling, products by 2 and 3 as additions. c_ones is the mean
        number of ones among the l bits of the opened c mod 2^l, each of
        which costs a subtraction in the senders' xor vector and, unless
        EQ, in their E vector (and at l = 1 in EQ mode one more for each
        party past the senders); c mod 2^l is uniform (r mod 2^l is), so
        it is l/2. The value arrays hold the 2t + 1 senders' shares: the
        x = m - 2t - 1 parties past them take their bit shares where the
        output needs them (LT mode: a_r and rb_l; EQ mode at l = 1: rb_0)
        and otherwise their output from the last reshare's coefficients."""
        if groups is not None:
            return self._wide_field_ops(c_ones, groups)
        t, m, l = self.t, self.m, self.l
        ns = 2 * t + 1
        x = m - ns
        split = ns * t                           # products = adds
        reshare = (ns + split, ns - 1 + split)
        node = (ns + reshare[0], reshare[1])     # one product of a tree
        # bit splits, r_divl, a + r mod 2^l + 2^l, open c, c mod 2^l
        mont = self.lb * split + 1 + split + 2 * (t + 1) + 2
        adds = self.lb * split + split + 2 * l * ns + 2 * t + 1 + ns
        adds += ns * c_ones                      # xor vector
        if self.mode == 'LT':
            # the parties past the senders: their bit shares, a_r, c mod
            # 2^l - a_r, and their output as the senders'
            mont += x * ((l + 1) * t + 2)
            adds += x * ((l + 1) * t + 2 * l + 5)
        elif self.mode == 'EQ' and l == 1:
            mont += x * t
            adds += x * (t + 1 + c_ones)
        else:
            mont += x * t                        # Horner(C, x_j) + S
            adds += x * t
        if self.mode != 'EQ':
            trees = sum(_tree_levels(l + 1))
            # E vector, its tree, the blinded zero test, h and z
            mont += trees * node[0] + split + 2 * ns + 2 * ns
            adds += (5 * l * ns + ns * c_ones + 6 * ns + trees * node[1]
                     + split + ns - 1 + 2 * ns)
        if self.mode != 'LT':
            trees = sum(_tree_levels(l))
            mont += trees * node[0]
            adds += l * ns + trees * node[1]
            if self.mode == 'sgn':
                mont += ns + reshare[0]
                adds += 3 * ns + reshare[1]
        if self.f:
            mont += m
        return mont, adds

    def _wide_field_ops(self, c_ones: float, groups: int) -> tuple:
        """The wide K5's (products, adds) per element, groups the groups of
        lanes of its CTA (``_build.sgn_wide_groups``): its algebra takes
        r mod 2^l's shares from the sums R_k of 2^j C_{k, j} (each group
        doubles its run of bits and scales it by one product, the groups'
        sums added in a tree) rather than by one doubling chain, computes c
        mod 2^l's and r mod 2^l's values once, runs the E vector's suffix
        sums as a scan over the groups' runs (E_j from a running s + 3
        times the xor bits' sum above j), and multiplies by a party's
        point and by a Lagrange coefficient by doubling and adding
        (``_point_adds``, ``_lag_adds``). c_ones as
        ``field_ops``: each one costs a subtraction in the xor vector (not
        LT), and in the E vector's runs three (LT) or one (sgn), and at l
        = 1 in EQ mode one for each party past the senders."""
        from mpyc_tpu_torch import _build
        t, m, l, lb = self.t, self.m, self.l, self.lb
        ns = 2 * t + 1
        x = m - ns
        LT, EQ = self.mode == 'LT', self.mode == 'EQ'
        # a Horner form at the senders' points, and at the other parties'
        pt_s = t * sum(_point_adds(i + 1) for i in range(ns))
        pt_x = t * sum(_point_adds(i + 1) for i in range(ns, m))
        # Horner(C, x_i) + v: t adds and the point's
        mont, adds = 0, lb * (ns * t + pt_s)         # the bit split
        if LT or (EQ and l == 1):
            adds += x * t + pt_x
        # R_k by runs, their tree over the groups, times R^2
        runs = 0
        for j0 in range(0, lb, _build.SGN_WIDE_STAGE):
            nb = min(lb - j0, _build.SGN_WIDE_STAGE, l - j0)
            if nb > 0:
                runs += -(-nb // -(-nb // groups))
        mont += runs * t + t
        adds += (2 * l - runs) * t + t * (groups - 1)
        # r_divl and r mod 2^l to Montgomery form, r_divl's t + 1 shares,
        # a_r at every party, the opening of c, c to standard form, c mod
        # 2^l, z at every party
        mont += 2 + (t + 1) + 2
        adds += (t + 1) * t + t * sum(_point_adds(i + 1)
                                      for i in range(t + 1)) + _lag_adds(t + 1)
        adds += m * (t + 2) + pt_s + pt_x + (t + 1) + t + m
        adds += c_ones * (ns if not LT else 0)
        if EQ and l == 1:                        # 1 - xor_0 past the senders
            adds += x * (1 + c_ones)
        lag = _lag_adds(ns)
        node = (ns, ns - 1 + ns * t + pt_s + lag)
        if not EQ:
            # the E vector: each group's run of bits, the scan of the runs'
            # sums, then E_j from T_j = s + 3 (the xor bits' sum above j)
            scan = sum(groups - h for h in _powers_below(groups))
            qb = -(-l // groups)
            adds += 2 * ns                       # s
            adds += ns * (5 * l + 4 + scan + 3 * -(-l // qb)) \
                + ns * c_ones * (3 if LT else 1)
            trees = sum(_tree_levels(l + 1))
            mont += trees * node[0]
            adds += trees * node[1]
            # the blinded zero test, h and z
            mont += ns + 2 * ns
            adds += ns * t + pt_s + lag + ns - 1 + 2 * ns
        if not LT:
            trees = sum(_tree_levels(l))
            mont += trees * node[0]
            adds += l * ns + trees * node[1]
            if self.mode == 'sgn':
                mont += ns
                adds += 3 * ns + lag + ns - 1 + ns * t + pt_s
        if LT:
            mont += 2 * x
            adds += 4 * x
        elif not (EQ and l == 1):
            adds += x * t + pt_x
        if self.f:
            mont += m
        return mont, adds

    def params(self, nonce):
        """Kernel parameter block for a call with counter (lo, hi); raises
        NotImplementedError for a configuration the card has no
        instantiation of: (t, m) outside 1 <= t <= 4, 2t + 1 <= m <= 16,
        k above 64, a field of a limb count not built
        (``_build.SGN_BUILT_NL``; 7 to 48 limbs take ``wide_params``),
        random bits past what t of their draws leave room for
        (``_build.sgn_lb_fit``). Any l the spec takes (l + k + 2 <= bit
        length of p) is a launch parameter at t = 1."""
        from mpyc_tpu_torch import _build
        L = self.ctx.L
        if self.k > 64 or L not in _build.SGN_BUILT_NL or \
                self.l_bytes != 4 * (L + 2):
            raise NotImplementedError(
                f'the CUDA comparison is built for k <= 64 and fields of '
                f'{_build.SGN_BUILT_NL[0]} to {_build.WIDE_MAX_NL} limbs '
                f'({_build.SGN_BUILT_NL[-1] + 1} to {_build.WIDE_MAX_NL}: '
                f'the wide kernel) with draws of 4 (L + 2) bytes; not '
                f'k={self.k}, L={L} ({self.l_bytes}-byte draws)')
        _build.check_parties('comparison', self.t, self.m)
        lb_max = _build.sgn_lb_fit(self.t, L)
        if self.lb > lb_max:
            raise NotImplementedError(
                f'the CUDA comparison takes at most {lb_max} random bits at '
                f't={self.t} on {L} limbs (t lb draws an element in a CTA '
                f'of one warp), not {self.lb} (l={self.l})')
        P = _build.SgnParams()
        P.draw = _build.draw_params(self.ctx, 2)
        for i, c in enumerate(self.lag_t):
            _build.set_limbs(P.lag_t[i], c)
        for i, c in enumerate(self.lag_2t):
            _build.set_limbs(P.lag_2t[i], c)
        for j, x in enumerate(self.xs):
            _build.set_limbs(P.xs[j], x)
        for name, v in (('one', self.one), ('three', self.three),
                        ('r2', self.r2), ('pow2l', self.pow2[self.l]),
                        ('inv2l', self.inv2l), ('pow2l1', self.pow2l1),
                        ('powf', self.powf or ())):
            _build.set_limbs(getattr(P, name), v)
        P.nonce_lo, P.nonce_hi = int(nonce[0]), int(nonce[1])
        P.t, P.m, P.l, P.k = self.t, self.m, self.l, self.k
        P.mode, P.has_f = SGN_MODES.index(self.mode), int(bool(self.f))
        return P

    def wide_params(self, nonce):
        """The wide K5's parameter block (csrc/sgn_wide.cu SgnWide) for a
        call with counter (lo, hi), with the workspace words of a CTA
        (``_build.sgn_wide_layout``: 0 where the element's vectors fit in
        shared memory); raises NotImplementedError for a
        configuration it does not take: (t, m) outside 1 <= t <= 4, 2t + 1
        <= m <= 16, k above 64, a field outside 7 to 48 limbs. Every l the
        spec takes is a launch parameter, at every (t, m)."""
        from mpyc_tpu_torch import _build
        L = self.ctx.L
        if self.k > 64 or not _build.wide(L) or \
                self.l_bytes != 4 * (L + 2):
            raise NotImplementedError(
                f'the wide CUDA comparison is built for k <= 64 and fields '
                f'of {_build.WIDE_MIN_NL} to {_build.WIDE_MAX_NL} limbs with '
                f'draws of 4 (L + 2) bytes; not k={self.k}, L={L} '
                f'({self.l_bytes}-byte draws)')
        return self._wide_block(nonce, _build.SGN_WIDE_THREADS,
                                _build.wide_group(L))

    def cta_params(self, nonce, n: int):
        """The parameter block of K5's CTA route (csrc/sgn_wide.cu
        ``mtt_sgn_cta``: the wide kernel's at two to six limbs, one element
        a CTA of ``_build.sgn_cta_shape(n)``: threads, and lanes a group)
        for a launch of n elements, as ``wide_params``; raises
        NotImplementedError for a configuration it does not take. It keeps
        the element's vectors in shared memory or its workspace, so every
        lb the spec takes runs at every (t, m)."""
        from mpyc_tpu_torch import _build
        L = self.ctx.L
        if self.k > 64 or L not in _build.SGN_CTA_NL or \
                self.l_bytes != 4 * (L + 2):
            raise NotImplementedError(
                f'K5\'s CTA route is built for k <= 64 and fields of '
                f'{_build.SGN_CTA_NL[0]} to {_build.SGN_CTA_NL[-1]} limbs '
                f'with draws of 4 (L + 2) bytes; not k={self.k}, L={L} '
                f'({self.l_bytes}-byte draws)')
        return self._wide_block(nonce, *_build.sgn_cta_shape(n))

    def _wide_block(self, nonce, threads: int, group: int):
        """The SgnWide block of a CTA of ``threads`` threads in groups of
        ``group`` lanes, with its workspace words (``_build.
        sgn_wide_layout``: 0 where the vectors fit in shared memory)."""
        from mpyc_tpu_torch import _build
        _build.check_parties('comparison', self.t, self.m)
        L = self.ctx.L
        P = _build.SgnWide()
        P.nl, P.t, P.m, P.l, P.k = L, self.t, self.m, self.l, self.k
        P.mode, P.has_f = SGN_MODES.index(self.mode), int(bool(self.f))
        P.n0inv = self.ctx.n0inv
        P.nonce_lo, P.nonce_hi = int(nonce[0]), int(nonce[1])
        P.group, P.threads = group, threads
        P.ws_stride = _build.sgn_wide_layout(self.t, self.m, L, self.l,
                                             P.mode, threads // group)[1]
        return P

    def wide_consts(self, device) -> torch.Tensor:
        """The wide K5's device buffer (csrc/sgn_wide.cu SGN_WIDE_CONSTS):
        p, the radix table of its two-chunk draws (radix_1 times 2^64
        R^-1: the kernel takes a draw's top two words by a product of two
        rows), one, three, r2, 2^l, 2^-l, 2^(l-1) and 2^f (1 without a
        scale), L words each; made once for each device. The Lagrange
        coefficients and the points are small integers there."""
        from mpyc_tpu_torch import _build
        cache = self.__dict__.setdefault('_wide', {})
        if str(device) not in cache:
            ctx = self.ctx
            rad1 = limb.const_limbs((ctx.R2 << 64) % ctx.p, ctx.L)
            cache[str(device)] = _build.wide_words(
                device, ctx.p_limbs, ctx.radix_limbs(1)[0], rad1, self.one,
                self.three, self.r2, self.pow2[self.l], self.inv2l,
                self.pow2l1, self.powf or self.one)
        return cache[str(device)]


def _sgn_step_plain(a: torch.Tensor, state: torch.Tensor, nonce,
                    spec: SgnSpec) -> torch.Tensor:
    """Plain version of K5, the JAX package's XLA comparison step
    (pipelines.py:847-1061): (m, n, L) degree-t shares -> (m, n, L).

    Randomness: with the call counter XORed into lane 4, stream A is
    blocks 0..blocks_a-1 (per element wpe words: its random bits, then its
    r_divl word), stream B the ``squeeze_mont`` draws from block blocks_a
    on, taken call by call: a call of c draws per element gives element e
    the draws off + kk*n*c + e*c + i."""
    ctx = spec.ctx
    L, t, m, l, lb = ctx.L, spec.t, spec.m, spec.l, spec.lb
    P, N0 = ctx.p_limbs, ctx.n0inv
    n = a.shape[1]

    def add(x, y):
        return limb.add_mod(x, y, P)

    def sub(x, y):
        return limb.sub_mod(x, y, P)

    def mul(x, y):
        return limb.mont_mul(x, y, P, N0)

    def at(x, idx):
        return [v[idx] for v in x]

    def stack(rows, dim):
        return [torch.stack([r[q] for r in rows], dim) for q in range(L)]

    st = _nonce_state(state, nonce)
    blocks_a = spec.blocks_a(n)
    words = keccak._keccak_ctr_plain(st, blocks_a, 19).to(torch.int64) \
        & limb.M32
    words = words.reshape(-1)[:n * spec.wpe].reshape(n, spec.wpe)
    pool = rng_mod._squeeze_mont_plain(st, n * spec.draws_per_element(),
                                       spec.l_bytes, spec.p, base=blocks_a)
    cursor = [0]

    def draw(shape):
        c0 = cursor[0]
        cursor[0] = c0 + math.prod(shape)
        return limb.unstack(pool[c0:cursor[0]].reshape(shape + (L,)))

    def split(v, coefs):            # dealer split: (...) -> (m, ...)
        rows = []
        for x in spec.xs:
            y = None
            for kk in range(t):
                ck = at(coefs, kk)
                y = ck if y is None else add(y, ck)
                y = mul(y, x)
            rows.append(add(y, v))
        return stack(rows, 0)

    def open_deg(x, lag):           # (m, ...) -> (...) public
        acc = None
        for i, lg in enumerate(lag):
            term = mul(at(x, i), lg)
            acc = term if acc is None else add(acc, term)
        return acc

    def reshare(x):                 # (m, ...) degree 2t -> degree t
        return split(open_deg(x, spec.lag_2t),
                     draw((t,) + tuple(x[0].shape[1:])))

    def prod_tree(x):               # (m, n, w) -> (m, n)
        while x[0].shape[2] > 1:
            w = x[0].shape[2]
            h = w // 2
            y = reshare(mul(at(x, (..., slice(0, h))),
                            at(x, (..., slice(h, 2 * h)))))
            if w % 2:
                y = [torch.cat([u, v[..., 2 * h:]], dim=2)
                     for u, v in zip(y, x)]
            x = y
        return at(x, (..., 0))

    def bits_of(w, count):          # (n, words) -> (n, count) bits
        jj = torch.arange(count, device=w.device)
        return (w[:, jj // 32] >> (jj % 32)) & 1

    def scan(x):                    # inclusive prefix sums on the last axis
        off = 1
        while off < x[0].shape[-1]:
            x = add(x, [torch.cat([torch.zeros_like(v[..., :off]),
                                   v[..., :-off]], dim=-1) for v in x])
            off *= 2
        return x

    # random bits: a dealer split of stream bits
    bits = bits_of(words, lb)                                # (n, lb)
    zero = torch.zeros_like(bits)
    rb = split(mul([bits] + [zero] * (L - 1), spec.r2),
               draw((t, n, lb)))                             # (m, n, lb)

    # r_divl, uniform below 2^k
    k_limbs = []
    for q in range(L):
        col = torch.zeros_like(words[:, 0])
        if q < spec.wk:
            col = words[:, spec.wb + q]
            if spec.k - 32 * q < 32:
                col = col & ((1 << (spec.k - 32 * q)) - 1)
        k_limbs.append(col)
    r_divl_sh = split(mul(k_limbs, spec.r2), draw((t, n)))   # (m, n)

    # mask and open: c = a + 2^l + r_modl + 2^l r_divl, r_modl the sum of
    # rb_j 2^j (a scan of the products, its last position)
    pow2 = [torch.tensor([c[q] for c in spec.pow2[:l]], dtype=torch.int64,
                         device=a.device) for q in range(L)]
    r_modl = at(scan(mul(at(rb, (..., slice(0, l))), pow2)), (..., l - 1))
    a_r = add(add(limb.unstack(a), r_modl), spec.pow2[l])
    c_in = add(a_r, mul(r_divl_sh, spec.pow2[l]))
    c_std = mul(open_deg(c_in, spec.lag_t), (1,) + (0,) * (L - 1))
    cm = []
    for q in range(L):
        rem = l - 32 * q
        col = c_std[q]
        if rem <= 0:
            col = torch.zeros_like(col)
        elif rem < 32:
            col = col & ((1 << rem) - 1)
        cm.append(col)
    z = sub(mul(cm, spec.r2), a_r)                           # (m, n)

    # public bits of c mod 2^l; xor = c_bits XOR r_bits
    cb = bits_of(torch.stack(c_std, dim=-1), l)              # (n, l)
    cb_m = [cb * c for c in spec.one]
    rbl = at(rb, (..., slice(0, l)))
    xor = add(sub(rbl, mul(rbl, [cb * c for c in spec.two])), cb_m)

    if spec.mode != 'EQ':
        s_sign = sub(add(at(rb, (..., l)), at(rb, (..., l))), spec.one)
        incl = scan(xor)                                     # (m, n, l)
        total = at(incl, (..., l - 1))
        suffix = sub(at(total, (..., None)), incl)
        e_bits = add(add(at(s_sign, (..., None)), sub(rbl, cb_m)),
                     mul(suffix, spec.three))
        e_last = add(sub(s_sign, spec.one), mul(total, spec.three))
        E = [torch.cat([u, v[..., None]], dim=2)
             for u, v in zip(e_bits, e_last)]
        prod_e = prod_tree(E)
        # blinded public zero test, one blinder per element
        blind = draw((n,))
        bz = limb.iszero_ll(blind)
        blind = [torch.where(bz, torch.full_like(v, c), v)
                 for v, c in zip(blind, spec.one)]
        pb = mul(prod_e, split(blind, draw((t, n))))         # degree 2t
        g = limb.iszero_ll(open_deg(pb, spec.lag_2t)).to(torch.int64)
        h = add(sub(s_sign, mul(s_sign, [g * c for c in spec.two])),
                spec.three)
        z = mul(add(z, mul(h, spec.pow2l1)), spec.inv2l)

    if spec.mode != 'LT':
        h_all = prod_tree(sub(spec.one, xor))
        if spec.mode == 'EQ':
            z = h_all
        else:
            u = sub(h_all, spec.one)
            v = sub(add(z, z), spec.one)
            z = reshare(mul(u, v))

    if spec.powf is not None:
        z = mul(z, spec.powf)
    return limb.stack(z)


# The tag that ``sgn_step.by_key`` appends to a launch of K5's CTA route
SGN_CTA = 'cta'


def sgn_route(L: int, n: int) -> str:
    """K5's kernel for a launch of n elements at L limbs: 'wide' (csrc/
    sgn_wide.cu, 7 to 48 limbs), 'cta' (its CTA route, two to six limbs,
    calls of at most ``_build.SGN_CTA_MAX[L]`` elements) or 'narrow'
    (csrc/sgn.cuh)."""
    from mpyc_tpu_torch import _build
    if _build.wide(L):
        return 'wide'
    return SGN_CTA if _build.sgn_cta(L, n) else 'narrow'


def _launch_sgn(a: torch.Tensor, state: torch.Tensor, nonce,
                spec: SgnSpec, chunk: int, n_last: int,
                route: str | None = None) -> torch.Tensor:
    """K5 on the card: the calls of a's chunks in one launch, on the
    kernel ``sgn_route`` picks from the limbs and the elements (or
    ``route``: 'cta' or 'narrow', for measurements): ``mtt_sgn``,
    ``mtt_sgn_cta`` or from 7 to 48 limbs ``mtt_sgn_wide``, the latter two
    with their workspace where the element's vectors do not fit in shared
    memory; counted on ``sgn_step`` (the CTA route's keys end in
    ``SGN_CTA``)."""
    from mpyc_tpu_torch import _build
    n = a.shape[1]
    route = route or sgn_route(spec.ctx.L, n)
    params = spec.wide_params(nonce) if route == 'wide' else \
        spec.cta_params(nonce, n) if route == SGN_CTA else spec.params(nonce)
    a = a.contiguous()
    _check_aligned(a)
    state = state.contiguous()
    out = torch.empty_like(a)
    if n:
        if route == 'narrow':
            _build.call('mtt_sgn', a.data_ptr(), out.data_ptr(),
                        state.data_ptr(), n, chunk, n_last,
                        ctypes.addressof(params), _build.stream_of(a.device))
        else:
            consts = spec.wide_consts(a.device)
            grid = _build.sgn_wide_grid(n, params.ws_stride)
            ws = torch.empty(grid * params.ws_stride, dtype=torch.int32,
                             device=a.device) if params.ws_stride else None
            _build.call('mtt_sgn_wide' if route == 'wide' else 'mtt_sgn_cta',
                        a.data_ptr(), out.data_ptr(), state.data_ptr(), n,
                        chunk, n_last, consts.data_ptr(),
                        ws.data_ptr() if ws is not None else None, grid,
                        ctypes.addressof(params), _build.stream_of(a.device))
        sgn_step.launches += 1
        sgn_step.by_key[(spec.mode, spec.l, spec.ctx.L, spec.f)
                        + parties_key(spec.t, spec.m)
                        + ((SGN_CTA,) if route == SGN_CTA else ())] += 1
        sgn_step.chunks += -(-n // chunk)
    return out


def _check_sgn_operands(a: torch.Tensor, state: torch.Tensor,
                        spec: SgnSpec) -> None:
    m, L = spec.m, spec.ctx.L
    if a.dim() != 3 or a.shape[0] != m or a.shape[2] != L or \
            a.dtype != torch.int32:
        raise ValueError(f'shares must be ({m}, n, {L}) int32')
    if state.device != a.device:
        raise ValueError('state and shares must be on one device')


def sgn_step(a: torch.Tensor, state: torch.Tensor, nonce,
             spec: SgnSpec) -> torch.Tensor:
    """K5: the whole secure comparison on (m, n, L) int32 degree-t shares
    -> (m, n, L) degree-t shares of the result (``SgnSpec``).

    Replaces ``mpyc_tpu/models/pipelines.py:make_sgn_step`` ->
    ``_build_pallas.kernel``, in the stream layout of its XLA step.
    nonce: the call counter (lo, hi). CPU tensors take the plain version;
    CUDA tensors launch the kernel (``csrc/sgn.cuh``; from 7 to 48 limbs,
    and for calls of few elements from two to six, ``csrc/sgn_wide.cu``:
    ``sgn_route``), or raise NotImplementedError for a configuration it is
    not built for."""
    _check_sgn_operands(a, state, spec)
    if a.device.type == 'cpu':
        return _sgn_step_plain(a, state, nonce, spec)
    n = a.shape[1]
    return _launch_sgn(a, state, nonce, spec, n, n)


sgn_step.launches = 0
sgn_step.by_key = collections.Counter()
sgn_step.chunks = 0


def bucket(n: int, cap: int | None = None) -> int:
    """The padded size of a fused call on n elements: the least power of
    two >= n, at least 64 (and at most cap); the JAX package's CPU buckets
    (mpyc_tpu/parallel/simulator.py:300-302, :516-523)."""
    n_pad = 64
    while n_pad < n:
        n_pad *= 2
    return n_pad if cap is None else min(n_pad, cap)


def sgn_chunks(a: torch.Tensor, state: torch.Tensor, ctr, spec: SgnSpec,
               chunk: int, route: str | None = None):
    """The comparison of (m, n, L) shares cut into chunks of ``chunk``
    elements, each one comparison call on its shares padded with zero rows
    to its bucket (``bucket(size, chunk)``), with the counters ctr, ctr +
    1, ...: -> (out, ctr + number of chunks), as the JAX package's
    ``SimRuntime._np_sgn_fused`` calls its step chunk by chunk.

    On the CPU each chunk is one call of ``sgn_step`` (the plain version);
    on the card all of them are one launch of K5, bit for bit the same, on
    the kernel ``sgn_route`` picks (or ``route``, for measurements)."""
    _check_sgn_operands(a, state, spec)
    n = a.shape[1]
    ctr = np.asarray(ctr, dtype=np.uint32)
    if n == 0:
        return a, ctr
    starts = range(0, n, chunk)
    n_last = bucket(n - starts[-1], chunk)
    if a.device.type != 'cpu':
        out = _launch_sgn(a, state, (int(ctr[0]), int(ctr[1])), spec, chunk,
                          n_last, route)
        return out, _add_ctr(ctr, len(starts))
    outs = []
    for c, j0 in enumerate(starts):
        part = a[:, j0:j0 + chunk]
        size = part.shape[1]
        pad = chunk if j0 + chunk < n else n_last
        if pad != size:
            part = torch.cat([part, part.new_zeros((a.shape[0], pad - size,
                                                    a.shape[2]))], dim=1)
        nonce = _add_ctr(ctr, c)
        outs.append(sgn_step(part, state, (int(nonce[0]), int(nonce[1])),
                             spec)[:, :size])
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out, _add_ctr(ctr, len(outs))


def _sgn_chunks_plain(a: torch.Tensor, state: torch.Tensor, ctr,
                      spec: SgnSpec, chunk: int):
    """Plain version of K5's launch of many chunks (``sgn_chunks``), on
    any device: chunk c is one call of ``_sgn_step_plain`` with the
    counter ctr + c, as ``sgn_chunks`` makes them on the CPU, but the full
    chunks run as one batch (``torch.func.vmap`` over them, each with its
    own counter's state) and the ragged last one alone on its bucket. On
    the card it is the reference a launch is held against: one batch of
    small operations, not one for each of a thousand chunks. From seven
    limbs on the full chunks run one by one: the vector product's carries
    (``limb._carry``) loop until nothing moves, which vmap does not take."""
    m, n, L = a.shape
    n_full = n // chunk
    outs = []
    if n_full and L >= limb._VEC_MIN_L:
        for c in range(n_full):
            nonce = _add_ctr(ctr, c)
            outs.append(_sgn_step_plain(
                a[:, c * chunk:(c + 1) * chunk], state,
                (int(nonce[0]), int(nonce[1])), spec))
    elif n_full:
        states = torch.stack([_nonce_state(state, _add_ctr(ctr, c))
                              for c in range(n_full)])
        parts = a[:, :n_full * chunk].reshape(m, n_full, chunk, L)
        step = torch.func.vmap(
            lambda x, st: _sgn_step_plain(x, st, (0, 0), spec),
            in_dims=(1, 0), out_dims=1)
        outs.append(step(parts, states).reshape(m, n_full * chunk, L))
    size = n - n_full * chunk
    if size:
        part = torch.cat([a[:, n_full * chunk:], a.new_zeros(
            (m, bucket(size, chunk) - size, L))], dim=1)
        nonce = _add_ctr(ctr, n_full)
        outs.append(_sgn_step_plain(part, state, (int(nonce[0]),
                                                  int(nonce[1])),
                                    spec)[:, :size])
    out = torch.cat(outs, dim=1) if outs else a
    return out, _add_ctr(ctr, -(-n // chunk))


def make_sgn_step(p: int, t: int, m: int, l: int, k: int = 30,
                  LT: bool = False, EQ: bool = False, f: int = 0):
    """Whole Toft-style secure comparison as one step.

    step(a_sh, state, ctr) -> (out_sh, ctr'):
      a_sh: (m, n, L) int32 Montgomery degree-t shares of l-bit integers;
      state: (2, 25) int32 absorbed SHAKE128 prefix, on the shares' device;
      ctr: (2,) uint32 numpy call counter (lo, hi), kept on the host;
      out_sh: (m, n, L) degree-t shares of sgn(a), or of the bit a < 0
        (LT) or a == 0 (EQ), times 2^f.

    The protocol (the JAX package's make_sgn_step): a dealer split of l
    (+1) stream bits and of r_divl < 2^k; the masked open of
    c = a + 2^l + r_modl + 2^l r_divl; public bit algebra and prefix sums;
    log-depth product trees with GRR98 reshares; a blinded public zero
    test with one blinder per element. Constraints: prime field,
    1 <= t, 2t+1 <= m, l + k + 2 <= bit length of p."""
    spec = SgnSpec(p, t, m, l, k, LT=LT, EQ=EQ, f=f)

    def step(a_sh, state, ctr):
        ctr = np.asarray(ctr, dtype=np.uint32)
        out = sgn_step(a_sh, state, (int(ctr[0]), int(ctr[1])), spec)
        return out, _add_ctr(ctr)
    return step


def _random_bits_tail_plain(r: torch.Tensor, z: torch.Tensor, field,
                            signed: bool, f: int, t: int = 1):
    """Plain version of K7, the tail of a round of ``np_random_bits``
    (``mpyc_tpu/parallel/simulator.py:759-785``): party-stacked PRSS
    shares r and zero-sharing z ((m, n, L) int32 limbs of ``field``) ->
    the shares of the bits, the n flags of the opening u = r^2 + z at
    threshold 2t equal to 0 (uint8) and their count ((1,) int32). The bit
    of r is (r / sqrt(u) + 1) / 2 (with ``signed`` r / sqrt(u)), times
    2^f; where u is 0 it is not a bit, and the caller drops it. 1 / sqrt(u)
    is u^((3p - 5) / 4) for p = 3 mod 4, else the JAX package's
    Tonelli-Shanks (``fieldops.tonelli_shanks``), whose root fixes the
    bit; K7 takes only the former."""
    ctx, p = field.array.ctx, field.modulus
    P, N0 = ctx.p_limbs, ctx.n0inv
    ra = [limb.unstack(r[i]) for i in range(2 * t + 1)]
    u = None    # u = r^2 + z recombined at 0 from the points 1..2t+1
    for i, lag in enumerate(_lagrange_consts_mont(p, range(1, 2 * t + 2))):
        s = limb.add_mod(limb.mont_mul(ra[i], ra[i], P, N0),
                         limb.unstack(z[i]), P)
        term = limb.mont_mul(s, lag, P, N0)
        u = term if u is None else limb.add_mod(u, term, P)
    flags = limb.iszero_ll(u).to(torch.uint8)
    if p % 4 == 3:
        inv = fieldops._mont_pow_plain(limb.stack(u), (3 * p - 5) // 4, ctx)
    else:   # the JAX package's Tonelli-Shanks, and so its root
        inv = fieldops.tonelli_shanks(
            limb.stack(u), ctx, True,
            lambda x, y: fieldops._field_op_plain(x, y, 'mul', ctx),
            lambda x, e: fieldops._mont_pow_plain(x, e, ctx))
    # bits in {0, 1}: (r s + 1) / 2 * 2^f = r s c + c with c = 2^f / 2
    c = pow(2, f, p) * (1 if signed else pow(2, -1, p)) % p
    c_mont = list(ctx.encode_const(c))
    bits = []
    for i in range(r.shape[0]):
        b = limb.mont_mul(limb.unstack(r[i]), limb.unstack(inv), P, N0)
        if c != 1:
            b = limb.mont_mul(b, c_mont, P, N0)
        if not signed:
            b = limb.add_mod(b, c_mont, P)
        bits.append(limb.stack(b))
    return torch.stack(bits), flags, flags.sum(dtype=torch.int32).reshape(1)


def _tail_params(field, t: int, m: int, signed: bool, f: int):
    """K7's parameter block: the plan of (3p - 5) / 4, the recombination
    vector at 0 of points 1..2t+1, a bit's scale and offset, t and m."""
    from mpyc_tpu_torch import _build
    p, ctx = field.modulus, field.array.ctx
    _build.check_parties('random bits\' tail (K7)', t, m)
    if p % 4 != 3:
        raise NotImplementedError('the random bits\' inverse square root '
                                  'needs p = 3 mod 4')
    P = _build.TailParams()
    P.pow = _build.pow_params(ctx, (3 * p - 5) // 4)
    for i, c in enumerate(_lagrange_consts_mont(p, range(1, 2 * t + 2))):
        _build.set_limbs(P.lag[i], c)
    # bits in {0, 1}: (r s + 1) / 2 * 2^f = r s c + c with c = 2^f / 2
    c = pow(2, f, p) * (1 if signed else pow(2, -1, p)) % p
    P.has_scale = int(c != 1)
    _build.set_limbs(P.scale, ctx.encode_const(c))
    P.has_offset = int(not signed)
    _build.set_limbs(P.offset, ctx.encode_const(c))
    P.t, P.m = t, m
    return P


def _wide_tail_params(field, t: int, m: int, signed: bool, f: int,
                      device) -> tuple:
    """The wide K7's WideTail and device buffer (csrc/wide.cu: p, R mod
    p, the recombination vector at 0 of points 1..2t + 1, a bit's scale
    and offset, then the plan's steps of (3p - 5) / 4), made once for each
    field, threshold, kind of bit and device."""
    from mpyc_tpu_torch import _build
    p, ctx = field.modulus, field.array.ctx
    _build.check_parties('wide random bits\' tail (K7)', t, m)
    if p % 4 != 3:
        raise NotImplementedError('the random bits\' inverse square root '
                                  'needs p = 3 mod 4')
    cache = ctx.__dict__.setdefault('_wide_tail', {})
    key = (t, signed, f, str(device))
    if key not in cache:
        P = _build.WideTail()
        P.pow, steps = _build.wide_pow(ctx, (3 * p - 5) // 4)
        c = pow(2, f, p) * (1 if signed else pow(2, -1, p)) % p
        P.has_scale, P.has_offset = int(c != 1), int(not signed)
        P.t = t
        cache[key] = P, _build.wide_words(
            device, ctx.p_limbs, ctx.one_mont,
            *_lagrange_consts_mont(p, range(1, 2 * t + 2)),
            ctx.encode_const(c), ctx.encode_const(c), steps)
    P, consts = cache[key]
    P = _build.WideTail.from_buffer_copy(P)
    P.m = m
    return P, consts


def random_bits_tail_ops(p: int, signed: bool, f: int, t: int = 1,
                        m: int = 3) -> tuple:
    """(Montgomery products, modular adds) of K7 an element, as its source
    computes them (held against it by tests/test_torch_kernels_host.py):
    per sender (2t + 1 of them) r_i^2, + z_i, times lag_i, the opening's
    2t adds; the power by its plan (``fieldops.plan_products``); a bit's
    scale, once, unless it is 1; per party (m) r_i s and the offset of
    bits in {0, 1}."""
    from mpyc_tpu_torch.ops.fieldops import plan_products
    ns = 2 * t + 1
    scale = int(not signed or f > 0)
    return (2 * ns + plan_products((3 * p - 5) // 4) + scale + m,
            2 * ns - 1 + (0 if signed else m))


def random_bits_tail(r: torch.Tensor, z: torch.Tensor, field, signed: bool,
                     f: int, t: int = 1):
    """K7: the tail of a round of ``np_random_bits`` on party-stacked PRSS
    shares r and zero-sharing z ((m, n, L) int32 limbs of ``field``) ->
    (bits (m, n, L), flags (n,) uint8 of the opening u = r^2 + z at
    threshold 2t equal to 0, their count (1,) int32), as
    ``_random_bits_tail_plain``.

    Replaces the XLA tail of ``mpyc_tpu/parallel/simulator.py:732
    np_random_bits`` (:759-785): no Pallas kernel computes it. CPU tensors
    take the plain version; CUDA tensors launch the kernel
    (``csrc/pow.cuh random_bits_tail_kernel``; from 7 to 48 limbs
    ``csrc/wide.cu random_bits_tail_wide_kernel``), or raise
    NotImplementedError for a configuration it is not built for ((t, m)
    outside ``_build.check_parties``, fields of other limb counts than
    ``_build.BUILT_NL`` and 7 to 48, p = 1 mod 4)."""
    m = r.shape[0]
    L = field.array.ctx.L
    if r.dim() != 3 or r.shape[2] != L or r.dtype != torch.int32 or \
            z.shape != r.shape or z.dtype != r.dtype or z.device != r.device:
        raise ValueError(f'r and z must be ({m}, n, {L}) int32 on one '
                         'device')
    if 2 * t + 1 > m:
        raise ValueError('the opening at 2t needs 2t + 1 <= m')
    if r.device.type == 'cpu':
        return _random_bits_tail_plain(r, z, field, signed, f, t)
    from mpyc_tpu_torch import _build
    wide = _build.wide(L)
    if wide:
        params, consts = _wide_tail_params(field, t, m, signed, f, r.device)
    else:
        params = _tail_params(field, t, m, signed, f)
    r, z = r.contiguous(), z.contiguous()
    _check_aligned(r, z)
    n = r.shape[1]
    bits = torch.empty_like(r)
    flags = torch.empty(n, dtype=torch.uint8, device=r.device)
    count = torch.zeros(1, dtype=torch.int32, device=r.device)
    if n:
        if wide:
            _build.call('mtt_random_bits_tail_wide', r.data_ptr(),
                        z.data_ptr(), bits.data_ptr(), flags.data_ptr(),
                        count.data_ptr(), n, consts.data_ptr(),
                        ctypes.addressof(params), _build.stream_of(r.device))
        else:
            _build.call('mtt_random_bits_tail', r.data_ptr(), z.data_ptr(),
                        bits.data_ptr(), flags.data_ptr(), count.data_ptr(),
                        n, ctypes.addressof(params),
                        _build.stream_of(r.device))
        random_bits_tail.launches += 1
        random_bits_tail.by_key[(L, field.array.ctx.lazy and not wide)
                                + parties_key(t, m)] += 1
    return bits, flags, count


random_bits_tail.launches = 0
random_bits_tail.by_key = collections.Counter()   # (L, lazy) + parties_key
