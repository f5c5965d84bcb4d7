"""GF(p) context: Montgomery constants, encode/decode and elementwise ops.

Port of the part of ``mpyc_tpu/ops/fieldops.py`` (``PrimeFieldCtx``) that
secure multiplication, comparison and matrix products use. Field data are
stored limb tensors: ``(..., L)`` int32 holding uint32 Montgomery limbs
(R = 2^(32 L)), on the CPU or the card. The ops here are plain PyTorch
(``ops/limb.py``); the JAX package runs them as XLA, not as Pallas
kernels. The matrix product contracts 4-bit planes of its operands with
one int8 GEMM (``torch._int_mm``, as the JAX package leaves its plane
contractions to XLA's integer matmul) and assembles and folds the sums in
plain torch. A power with a public exponent (``pow_const``, and through
it ``sqrt``) is the one program here with a hand-written kernel, K6
(``mont_pow``), though the JAX package leaves it to XLA too: it is dozens
of Montgomery products an element, thousands of small launches in plain
torch. The kernel runs a plan of the exponent made here on the host
(``pow_plan``: a sliding window, 68 products at SecFxp(14, 6)'s inverse
square root where the plain ladder does 99).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import typing

import numpy as np
import torch

from mpyc_tpu_torch.ops import limb


# The plane contractions are exact in int32 while K * 15 * 15 * 16 < 2^31
# (the JAX package's _matmul_mxu limit); longer contractions are cut.
_MATMUL_K_MAX = 70000
# Rows of a are cut into blocks whose plane GEMM output (int32, 64 L^2 N
# words a row) stays below this many bytes: each row's product is
# computed alone, so the bits are the same, and device memory holds one
# block's planes, GEMM output and bucket sums at a time.
_MATMUL_BLOCK_BYTES = 1 << 31


def _nibble_planes(x: torch.Tensor) -> torch.Tensor:
    """(..., L) int32 limbs -> (8 L, ...) int8 4-bit planes, plane 8 i + s
    holding bits 4 s .. 4 s + 3 of limb i."""
    L = x.shape[-1]
    return torch.stack([(x[..., i] >> 4 * s) & 0xF
                        for i in range(L) for s in range(8)]).to(torch.int8)


def _int8_gemm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a @ bt.T for (M, K) and (N, K) int8 -> (M, N) int32, exact. The
    second operand enters column-major, the layout of cuBLAS's int8 GEMM;
    zero rows and columns pad the operands to what ``torch._int_mm`` takes
    on the card (M > 16; K and N multiples of 8); zero planes add
    nothing."""
    M, K = a.shape
    N = bt.shape[0]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        bt = torch.nn.functional.pad(bt, (0, Kp - K, 0, Np - N))
    out = torch._int_mm(a, bt.t())
    return out[:M, :N] if (Mp, Np) != (M, N) else out


class PowPlan(typing.NamedTuple):
    """A left-to-right sliding-window program for x^e: the odd
    powers x^1, x^3, .., x^(2 n_table - 1) in a table (x^2 and n_table - 1
    products to build, none for n_table = 1); start from entry ``first``
    (x^(2 first + 1)); per step (s, j) square s times and multiply by
    entry j; then square ``tail`` times."""
    n_table: int
    first: int
    steps: tuple
    tail: int


# the widest window of a plan: K6's table holds x^1, x^3, .., x^15
# (POW_WINDOW in csrc/pow.cuh)
POW_WINDOW = 4


@functools.cache
def pow_plan(e: int) -> PowPlan:
    """The plan of x^e with windows of at most POW_WINDOW bits, the width
    of the fewest products (``plan_products``; width 1 is the binary
    ladder, so a plan never takes more products than the ladder). e = 0
    has the empty plan (the kernels give R mod p for it)."""
    if e < 0:
        raise ValueError('a plan needs e >= 0')
    if e == 0:
        return PowPlan(1, 0, (), 0)
    return min((_window_plan(e, v) for v in range(1, POW_WINDOW + 1)),
               key=_products)


def _window_plan(e: int, w: int) -> PowPlan:
    """x^e's left-to-right sliding window of w bits: from the top bit
    down, each window is the next w bits from a set bit, cut after its
    lowest set bit, so its value is odd; the bits between windows are
    squarings."""
    bits = bin(e)[2:]
    n, i, zeros = len(bits), 0, 0
    windows = []            # (squarings before it, its odd value)
    while i < n:
        if bits[i] == '0':
            zeros += 1
            i += 1
            continue
        j = min(i + w, n)
        while bits[j - 1] == '0':
            j -= 1
        windows.append((zeros + j - i, int(bits[i:j], 2)))
        zeros, i = 0, j
    n_table = (max(v for _, v in windows) + 1) // 2
    return PowPlan(n_table, windows[0][1] // 2,
                   tuple((s, v // 2) for s, v in windows[1:]), zeros)


def _products(plan: PowPlan) -> int:
    return ((plan.n_table if plan.n_table > 1 else 0) + plan.tail
            + sum(s + 1 for s, _ in plan.steps))


def plan_products(e: int) -> int:
    """Montgomery products K6 and K7 spend on x^e by its plan (``pow_plan``:
    x^2 and a product for each odd power of the table past x, then each
    step's squarings and product, then the tail's squarings)."""
    return _products(pow_plan(e))


_FIELD_OPS = ('mul', 'add', 'sub')


def _mont_pow_plain(data: torch.Tensor, e: int, ctx) -> torch.Tensor:
    """Plain version of K6: a^e R mod p elementwise
    (``limb.mont_pow_const``)."""
    return limb.stack(limb.mont_pow_const(limb.unstack(data), e, ctx.p_limbs,
                                          ctx.n0inv, ctx.one_mont))


def mont_pow(data: torch.Tensor, e: int, ctx) -> torch.Tensor:
    """K6: a^e R mod p for every Montgomery element of ``data`` ((..., L)
    int32 limbs of ``ctx``'s field) and a public exponent 0 <= e < 2^(32 L).

    No Pallas kernel of the JAX package computes it: XLA runs its
    ``mpyc_tpu/ops/limb.py:330 mont_pow_const`` (via ``fieldops.py:550
    pow_const``). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (``csrc/pow.cuh``, ``mont_pow_kernel``, by e's
    plan; from 7 to 48 limbs ``csrc/wide.cu mont_pow_wide_kernel``), or
    raises NotImplementedError for a limb count it is not built for."""
    if data.dtype != torch.int32 or data.shape[-1:] != (ctx.L,):
        raise ValueError(f'data must be (..., {ctx.L}) int32 limbs')
    if not 0 <= e < 1 << 32 * ctx.L:
        raise ValueError('exponent outside [0, 2^(32 L))')
    if data.device.type == 'cpu':
        return _mont_pow_plain(data, e, ctx)
    from mpyc_tpu_torch import _build
    wide = _build.wide(ctx.L)
    if wide:
        params, consts = _wide_pow_consts(ctx, e, data.device)
    else:
        params = _build.pow_params(ctx, e)
    data = data.contiguous()
    out = torch.empty_like(data)
    n = data.numel() // ctx.L
    if n:
        if wide:
            _build.call('mtt_mont_pow_wide', data.data_ptr(), out.data_ptr(),
                        n, consts.data_ptr(), ctypes.addressof(params),
                        _build.stream_of(data.device))
        else:
            _build.call('mtt_mont_pow', data.data_ptr(), out.data_ptr(), n,
                        ctypes.addressof(params),
                        _build.stream_of(data.device))
        mont_pow.launches += 1
        # the wide kernel has no lazy form: its products are canonical
        mont_pow.by_key[(ctx.L, ctx.lazy and not wide)] += 1
    return out


def _wide_pow_consts(ctx, e: int, device) -> tuple:
    """K6's plan and device buffer (p, R mod p, the plan's steps) for a^e
    in a wide field, made once for each exponent and device."""
    from mpyc_tpu_torch import _build
    cache = ctx.__dict__.setdefault('_wide_pow', {})
    key = (e, str(device))
    if key not in cache:
        params, steps = _build.wide_pow(ctx, e)
        cache[key] = params, _build.wide_words(device, ctx.p_limbs,
                                               ctx.one_mont, steps)
    return cache[key]


def wide_field_consts(ctx, device) -> torch.Tensor:
    """K9's device buffer for a wide field: p's limbs."""
    from mpyc_tpu_torch import _build
    cache = ctx.__dict__.setdefault('_wide_p', {})
    key = str(device)
    if key not in cache:
        cache[key] = _build.wide_words(device, ctx.p_limbs)
    return cache[key]


mont_pow.launches = 0
mont_pow.by_key = collections.Counter()   # launches by (limbs, lazy)


@functools.cache
def ts_params(p: int) -> tuple:
    """(q, s, z) with p - 1 = q 2^s, q odd, and z = b^q for the smallest
    quadratic non-residue b (``mpyc_tpu/ops/fieldops.py:602``)."""
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    b = 2
    while pow(b, (p - 1) // 2, p) != p - 1:
        b += 1
    return q, s, pow(b, q, p)


def tonelli_shanks(a: torch.Tensor, ctx, INV: bool, mul, power):
    """Square roots (INV: their inverses) of the quadratic residues a
    ((..., L) Montgomery limbs) for p = 1 mod 4 by the JAX package's
    constant-round Tonelli-Shanks (``mpyc_tpu/ops/fieldops.py:616``), so
    that the root is the same: w = a^((q - 1) / 2), x = a w, t = x w, then
    s - 1 rounds k, each squaring t s - k - 2 times and, where that is not
    1, multiplying x by z^(2^k) and t by z^(2^(k + 1)); with INV the
    inverse of x, x^(p - 2) (0 for 0). mul(x, y) is a Montgomery product
    and power(x, e) x^e: K9 and K6, or their plain versions."""
    p = ctx.p
    q, s, z = ts_params(p)
    zk = [ctx.encode_const(pow(z, 1 << k, p)) for k in range(s)]
    one = torch.tensor(ctx.one_mont, dtype=torch.int64).to(
        torch.int32).to(a.device)
    w = power(a, (q - 1) >> 1)
    x = mul(a, w)
    t = mul(x, w)
    for k in range(s - 1):
        y = t
        for _ in range(s - k - 2):
            y = mul(y, y)
        flip = (y != one).any(-1, keepdim=True)
        x = torch.where(flip, mul(x, zk[k]), x)
        t = torch.where(flip, mul(t, zk[k + 1]), t)
    return power(x, p - 2) if INV else x


def _field_op_plain(a, b, op: str, ctx) -> torch.Tensor:
    """Plain version of K9: a op b elementwise (shapes broadcast; either
    operand may be a tuple of limbs, a constant) in ``limb``'s arithmetic:
    a Montgomery product, or an add or subtraction mod p."""
    a, b = ctx._limbs(a), ctx._limbs(b)
    if op == 'mul':
        return limb.stack(limb.mont_mul(a, b, ctx.p_limbs, ctx.n0inv))
    fn = limb.add_mod if op == 'add' else limb.sub_mod
    return limb.stack(fn(a, b, ctx.p_limbs))


def field_op(a, b, op: str, ctx) -> torch.Tensor:
    """K9: a op b elementwise in GF(p) on Montgomery limbs ((..., L) int32
    tensors of ``ctx``'s field, or tuples of limbs for a constant; shapes
    broadcast as numpy's): op 'mul' a Montgomery product (a may be below
    R, b below p), 'add' or 'sub' mod p, each result canonical.

    No Pallas kernel of the JAX package computes it: XLA fuses its limb
    arithmetic (``mpyc_tpu/ops/limb.py:247 mont_mul``, ``:217 add_mod``,
    ``:227 sub_mod``). CPU tensors take the plain version
    (``_field_op_plain``); CUDA tensors launch the kernel
    (``csrc/kernels.cu field_op_kernel``; from 7 to 48 limbs ``csrc/
    wide.cu field_op_wide_kernel``), an operand of one element (a
    constant) read by every thread, or raise NotImplementedError for a
    limb count it is not built for."""
    like = a if isinstance(a, torch.Tensor) else b
    if like.device.type == 'cpu':
        return _field_op_plain(a, b, op, ctx)
    from mpyc_tpu_torch import _build
    L = ctx.L
    wide = _build.wide(L)
    if wide:
        consts = wide_field_consts(ctx, like.device)
    else:
        params = ctx.__dict__.get('_field_op_params')
        if params is None:
            params = ctx._field_op_params = _build.draw_params(ctx, 1)

    def operand(x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(x, dtype=torch.int64,
                             device=like.device).to(torch.int32)
        return x
    A, B = operand(a), operand(b)
    shape = torch.broadcast_shapes(A.shape[:-1], B.shape[:-1])
    n = math.prod(shape)

    def flat(x):
        if math.prod(x.shape[:-1]) == 1:
            return x.reshape(1, L).contiguous(), 0
        return x.expand(shape + (L,)).contiguous(), 1
    (A, a_step), (B, b_step) = flat(A), flat(B)
    out = torch.empty(shape + (L,), dtype=torch.int32, device=like.device)
    if n:
        if wide:
            _build.call('mtt_field_op_wide', A.data_ptr(), B.data_ptr(),
                        out.data_ptr(), n, a_step, b_step,
                        _FIELD_OPS.index(op), consts.data_ptr(), ctx.n0inv,
                        L, _build.stream_of(like.device))
        else:
            _build.call('mtt_field_op', A.data_ptr(), B.data_ptr(),
                        out.data_ptr(), n, a_step, b_step,
                        _FIELD_OPS.index(op), ctypes.addressof(params),
                        _build.stream_of(like.device))
        field_op.launches += 1
        field_op.by_key[L] += 1
    return out


field_op.launches = 0
field_op.by_key = collections.Counter()   # launches by limbs


def pow_products(e: int) -> int:
    """Montgomery products the plain ladder (``limb.mont_pow_const``)
    spends on an exponent e: a squaring per bit below the top one and a
    product per set bit below it."""
    return max(e.bit_length() - 1, 0) + max(bin(e).count('1') - 1, 0)


@functools.cache
def prime_field_ctx(p: int) -> 'PrimeFieldCtx':
    return PrimeFieldCtx(p)


def limbs_from_numpy(arr, device) -> torch.Tensor:
    """(..., L) uint32 limb array (e.g. the JAX package's Montgomery data)
    -> stored int32 limb tensor on ``device``, bit for bit."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Stored int32 limb tensor -> (..., L) uint32 numpy array, bit for bit."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


class PrimeFieldCtx:
    """Montgomery context for GF(p), p an odd prime."""

    def __init__(self, p: int):
        if p <= 2 or p % 2 == 0:
            raise ValueError('PrimeFieldCtx requires an odd prime')
        self.p = p
        self.L = L = (p.bit_length() + 31) // 32
        self.R = R = 1 << (32 * L)
        self.R2 = R * R % p
        self.n0inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        self.p_limbs = limb.const_limbs(p, L)
        self.one_limbs = limb.const_limbs(1, L)
        self.one_mont = tuple(limb.const_limbs(R % p, L))
        self.r2_limbs = tuple(limb.const_limbs(self.R2, L))
        # 4p < R: K6 and K7 chain products below 2p with no final
        # subtraction (csrc/limb.cuh mont_mul_lazy)
        self.lazy = 4 * p < R

    # -- host encode / decode ----------------------------------------------

    def _standard_limbs(self, xs) -> np.ndarray:
        """Values (int64/uint64/bool numpy, or ints) -> (..., L) uint32 limbs
        of x mod p in standard form; numeric arrays, and object arrays of
        ints that fit int64, without a Python loop."""
        p, L = self.p, self.L
        arr = np.asarray(xs)
        if arr.dtype == object and arr.size:
            try:
                ints = arr.astype(np.int64)
                if (ints == arr).all():     # ints only, none cut
                    arr = ints
            except (OverflowError, TypeError):
                pass
        if arr.dtype.kind in 'iu' and L > 2:
            # p > 2^64: x >= 0 is its own residue; x < 0 is p - |x|
            u = arr.astype(np.int64).view(np.uint64) if arr.dtype.kind == \
                'i' else arr.astype(np.uint64)
            neg = (arr < 0) if arr.dtype.kind == 'i' else \
                np.zeros(arr.shape, bool)
            with np.errstate(over='ignore'):     # -x as 2^64 - x
                mag = np.where(neg, ~u + np.uint64(1), u)
            out = np.zeros(arr.shape + (L,), np.int64)
            out[..., 0] = (mag & np.uint64(limb.M32)).astype(np.int64)
            out[..., 1] = (mag >> np.uint64(32)).astype(np.int64)
            borrow = np.zeros(arr.shape, np.int64)
            for q, pq in enumerate(limb.const_limbs(p, L)):
                d = pq - out[..., q] - borrow
                borrow = (d < 0).astype(np.int64)
                out[..., q] = np.where(neg, d + (borrow << 32), out[..., q])
            return out.astype(np.uint32)
        if arr.dtype.kind in 'iub' and L <= 2:
            if arr.dtype.kind == 'i':
                neg = arr < 0
                u = arr.astype(np.int64).view(np.uint64) % np.uint64(p)
                # a negative x reads as 2^64 + x: subtract 2^64 mod p
                c = np.uint64((1 << 64) % p)
                with np.errstate(over='ignore'):   # unselected branches
                    u = np.where(neg & (u >= c), u - c,
                                 np.where(neg, u + (np.uint64(p) - c), u))
            else:
                u = arr.astype(np.uint64) % np.uint64(p)
            u = np.asarray(u, dtype=np.uint64)
            out = np.empty(u.shape + (L,), np.uint32)
            out[..., 0] = (u & np.uint64(limb.M32)).astype(np.uint32)
            if L == 2:
                out[..., 1] = (u >> np.uint64(32)).astype(np.uint32)
            return out
        vals = np.asarray(arr, dtype=object) % p
        return limb.ints_to_limbs(vals, L)

    def encode(self, xs, device) -> torch.Tensor:
        """Values -> Montgomery limb tensor on ``device``: limbs of x mod p
        are moved once, then multiplied by R^2 there."""
        std = limbs_from_numpy(self._standard_limbs(xs), device)
        return self.mul_limbs_const(std, self.R2)

    def to_standard(self, data: torch.Tensor) -> torch.Tensor:
        """Montgomery limbs -> standard-form limbs (x R^-1), same device."""
        return field_op(data, tuple(self.one_limbs), 'mul', self)

    def decode(self, data: torch.Tensor) -> np.ndarray:
        """Montgomery limb tensor -> values in [0, p): uint64 for L <= 2,
        else object ints."""
        std = limbs_to_numpy(self.to_standard(data))
        if self.L == 1:
            return std[..., 0].astype(np.uint64)
        if self.L == 2:
            return (std[..., 0].astype(np.uint64)
                    | (std[..., 1].astype(np.uint64) << np.uint64(32)))
        return limb.limbs_to_ints(std)

    def encode_const(self, x: int) -> tuple:
        """One int -> its Montgomery limbs as Python ints."""
        return tuple(limb.const_limbs(int(x) % self.p * self.R % self.p,
                                      self.L))

    # -- elementwise ops on stored limb tensors ------------------------------
    # add and sub also take a public constant for either operand, as the
    # tuple of its Montgomery limbs (encode_const); shapes broadcast. On the
    # card each is one launch of K9 (field_op), on the CPU its plain
    # version.

    @staticmethod
    def _limbs(x) -> list:
        return list(x) if isinstance(x, tuple) else limb.unstack(x)

    def add(self, a, b):
        return field_op(a, b, 'add', self)

    def sub(self, a, b):
        return field_op(a, b, 'sub', self)

    def neg(self, a):
        return field_op((0,) * self.L, a, 'sub', self)

    def is_zero(self, a) -> torch.Tensor:
        """Boolean tensor of the elements equal to 0."""
        return limb.iszero_ll(limb.unstack(a))

    def any_zero(self, a) -> bool:
        """Whether any element of the array is 0 (one read back)."""
        return bool(self.is_zero(a).any())

    def pow_const(self, a, e: int):
        """a^e elementwise for a public integer e (K6 on the card). As in
        ``mpyc_tpu/ops/fieldops.py:550``, e outside [0, p - 1) is reduced
        mod p - 1 to a positive exponent, so that 0^e stays 0."""
        e = int(e)
        if e < 0 or e >= self.p - 1:
            e = e % (self.p - 1) or self.p - 1
        return mont_pow(a, e, self)

    def encode_bits(self, b: torch.Tensor) -> torch.Tensor:
        """A 0/1 integer tensor -> Montgomery limbs of its values, on its
        device (1 is R mod p)."""
        one = torch.tensor(self.one_mont, dtype=torch.int64,
                           device=b.device)
        return (b.to(torch.int64)[..., None] * one).to(torch.int32)

    def inv(self, a):
        """Multiplicative inverses by Fermat, a^(p - 2); the inverse of 0
        is 0 (``mpyc_tpu/ops/limb.py:366 mont_inv``). K6 on the card."""
        return mont_pow(a, self.p - 2, self)

    def legendre(self, a) -> torch.Tensor:
        """Legendre symbols as an int32 tensor: 0 for 0, 1 for a quadratic
        residue, -1 for a non-residue (``mpyc_tpu/ops/fieldops.py:591``):
        a^((p - 1) / 2), K6 on the card, against R mod p."""
        r = mont_pow(a, (self.p - 1) >> 1, self)
        one = torch.tensor(self.one_mont, dtype=torch.int64).to(
            torch.int32).to(a.device)
        is_one = (r == one).all(-1)
        return torch.where(self.is_zero(a), 0, torch.where(
            is_one, 1, -1)).to(torch.int32)

    def sqrt(self, a, INV=False):
        """Square roots (or their inverses) of quadratic residues, as
        ``mpyc_tpu/ops/fieldops.py:616``: by the exponent (p + 1) / 4 (INV:
        (3 p - 5) / 4) for p = 3 mod 4, else by the constant-round
        Tonelli-Shanks (``tonelli_shanks``: K6's powers and K9's products
        on the card), which picks the JAX package's root; sqrt(0) = 0."""
        if self.p % 4 == 3:
            return self.pow_const(a, (3 * self.p - 5) >> 2 if INV
                                  else (self.p + 1) >> 2)
        return tonelli_shanks(
            a, self, INV, lambda x, y: field_op(x, y, 'mul', self),
            lambda x, e: mont_pow(x, e, self))

    def mod_pow2(self, a, f: int):
        """Each value mod 2^f, Montgomery in and out
        (``mpyc_tpu/ops/fieldops.py:867``): the standard form's low f bits,
        back into Montgomery form."""
        if not 0 <= f < 32 * self.L:
            raise ValueError('f outside [0, 32 L)')
        w, rem = divmod(f, 32)
        mask = torch.tensor([-1] * w + [(1 << rem) - 1] + [0] * (
            self.L - w - 1), dtype=torch.int32, device=a.device)
        return field_op(self.to_standard(a) & mask, tuple(self.r2_limbs),
                        'mul', self)

    def mul(self, a, b):
        return field_op(a, b, 'mul', self)

    def mul_limbs_const(self, a, c: int):
        """Montgomery product of a with the constant whose limbs are c."""
        return field_op(a, tuple(limb.const_limbs(c % self.p, self.L)),
                        'mul', self)

    def mul_int(self, a, x: int):
        """a * x for a public integer x (a in Montgomery form)."""
        return self.mul_limbs_const(a, int(x) % self.p * self.R)

    def radix_limbs(self, n_chunks: int) -> list:
        """Per chunk c the limbs of 2^(32 L c) R^2 mod p (reduce_wide)."""
        return [limb.const_limbs(pow(2, 32 * self.L * c, self.p) * self.R2
                                 % self.p, self.L)
                for c in range(n_chunks)]

    def reduce_chunks(self, wide: torch.Tensor) -> torch.Tensor:
        """(..., n_chunks, L) wide little-endian values -> Montgomery form of
        (value mod p), value = sum_c chunk_c 2^(32 L c)."""
        acc = None
        for c, rad in enumerate(self.radix_limbs(wide.shape[-2])):
            term = field_op(wide[..., c, :], tuple(rad), 'mul', self)
            acc = term if acc is None else field_op(acc, term, 'add', self)
        return acc

    def sum(self, a: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum of stored limb data along logical axis ``dim`` (modular adds
        in a halving tree)."""
        a = a.movedim(dim % (a.dim() - 1), 0)
        if a.shape[0] == 0:
            return torch.zeros_like(a[0:1].sum(0))
        while a.shape[0] > 1:
            h = a.shape[0] // 2
            s = self.add(a[:h], a[h:2 * h])
            a = torch.cat([s, a[2 * h:]]) if a.shape[0] % 2 else s
        return a[0]

    # -- matrix product --------------------------------------------------------

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(..., M, K, L) @ (..., K, N, L) -> (..., M, N, L), batch axes
        broadcast as numpy's matmul does.

        Counterpart of ``mpyc_tpu/ops/fieldops.py`` ``PrimeFieldCtx.matmul``
        (its ``_matmul_mxu`` for every K). The outputs are canonical
        Montgomery limbs, so they equal the JAX package's bit for bit in
        all of its branches. A batch of a's against a b without one folds
        into a's rows: one GEMM."""
        L = self.L
        M, K = a.shape[-3], a.shape[-2]
        N = b.shape[-2]
        if b.shape[-3] != K:
            raise ValueError(f'matmul: contraction {K} against '
                             f'{b.shape[-3]}')
        if b.dim() == 3:
            lead = a.shape[:-3]
            out = self._matmul2d(a.reshape(-1, K, L), b)
            return out.reshape(lead + (M, N, L))
        batch = torch.broadcast_shapes(a.shape[:-3], b.shape[:-3])
        a = a.expand(batch + a.shape[-3:]).reshape(-1, M, K, L)
        b = b.expand(batch + b.shape[-3:]).reshape(-1, K, N, L)
        return torch.stack([self._matmul2d(x, y) for x, y in zip(a, b)]
                           ).reshape(batch + (M, N, L))

    def _matmul2d(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(M, K, L) @ (K, N, L) -> (M, N, L) by the JAX package's
        nibble-plane scheme (``plane_gemm``, then ``fold_planes``), in
        chunks of K that keep the plane sums exact and blocks of rows that
        bound the GEMM's output (``_MATMUL_BLOCK_BYTES``)."""
        M, K, L = a.shape
        N = b.shape[1]
        rows = max(1, _MATMUL_BLOCK_BYTES // (64 * L * L * max(N, 1) * 4))
        if M > rows:
            return torch.cat([self._matmul2d(a[r0:r0 + rows], b)
                              for r0 in range(0, M, rows)])
        out = None
        for k0 in range(0, max(K, 1), _MATMUL_K_MAX):
            part = self.fold_planes(self.plane_gemm(
                a[:, k0:k0 + _MATMUL_K_MAX], b[k0:k0 + _MATMUL_K_MAX]))
            out = part if out is None else self.add(out, part)
        return out

    def plane_gemm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(M, K, L) @ (K, N, L) -> (P, M, P, N) int32 contractions of all
        pairs of 4-bit planes, P = 8 L (plane 8 i + s holds bits 4 s ..
        4 s + 3 of limb i), as one int8 GEMM over stacked planes,
        (P M, K) @ (K, P N); exact for K <= _MATMUL_K_MAX."""
        M, K, L = a.shape
        N = b.shape[1]
        P = 8 * L
        pa = _nibble_planes(a).reshape(P * M, K)
        pb = _nibble_planes(b.transpose(0, 1)).reshape(P * N, K)
        return _int8_gemm(pa, pb).view(P, M, P, N)

    def fold_planes(self, prod: torch.Tensor) -> torch.Tensor:
        """(P, M, P, N) plane contractions -> (M, N, L) Montgomery limbs of
        the product:

        * bucket sums S_e = sum_{d1 + d2 = e} prod[d1, :, d2], the
          anti-diagonals, in int64 (each < 2^28);
        * the wide value V = sum_e S_e 16^e as 32-bit limbs, by a carry
          chain;
        * a fold of V's L-limb chunks by Montgomery products with
          2^(32 L i) mod p, which also removes one R of the product of two
          Montgomery operands: the output is a b R mod p."""
        P, M, _, N = prod.shape
        L = self.L
        dev = prod.device
        E = 2 * P - 1                        # buckets, d1 + d2 = e
        nj = -(-E // 8)                      # 32-bit limbs they start in
        S = torch.zeros((M, nj * 8, N), dtype=torch.int64, device=dev)
        for d1 in range(P):
            S[:, d1:d1 + P] += prod[d1]
        shifts = 4 * torch.arange(8, device=dev).view(1, 1, 8, 1)
        T = S.view(M, nj, 8, N) << shifts    # < 2^56
        lo = (T & limb.M32).sum(2)           # limb j gets the low words
        hi = (T >> 32).sum(2)                # of its buckets, limb j + 1
        W = torch.cat([lo, lo.new_zeros((M, 1, N))], 1)  # the high ones
        W[:, 1:] += hi
        for j in range(nj):                  # carry chain
            W[:, j + 1] += W[:, j] >> 32
            W[:, j] &= limb.M32
        n_c = -(-(nj + 1) // L)
        W = torch.nn.functional.pad(W, (0, 0, 0, n_c * L - nj - 1))
        acc = None
        for c in range(n_c):
            term = self.mul_limbs_const(
                W[:, c * L:(c + 1) * L].transpose(1, 2).to(torch.int32),
                pow(2, 32 * L * c, self.p))
            acc = term if acc is None else self.add(acc, term)
        return acc
