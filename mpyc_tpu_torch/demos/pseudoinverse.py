"""Demo: the secure Moore-Penrose pseudoinverse over the rationals, on
the port.

    python -m mpyc_tpu_torch.demos.pseudoinverse [-m M] [-n N] [-r R]
        [-b B] [--seed S] [--device cuda|cpu]

The co-located path of ``demos/pseudoinverse.py`` (Bouman, de Vreede) on
``SimRuntime(3)``: the pseudoinverse of an integer m x n matrix A of rank
r, exactly over a prime field, as X = A^T (U^T Z U) (A A^T) with Z a
reflexive generalized inverse of U (A A^T)^2 U^T (U a public random
preconditioner), built by recursive 2 x 2 block Schur complements whose
only nonlinear steps are the reciprocals 1 / (d + [d == 0]) at the 1 x 1
leaves; the common denominator d = det(I + A (A^T - X)) both from that
recursion and from ``np_det``. Secure integers of Springer's bound, 1 +
ceil(r log2(|A|_F^2 / r)) bits: the default 5 x 5 takes a two-limb field,
a 20 x 20 matrix of rank 16 a six- or seven-limb one (its zero tests
[NO07]'s, its products and reciprocals the wide kernels on the card past
six limbs).

The random matrix comes from ``--seed`` (numpy), the preconditioner too.
The result is checked as the JAX demo checks it: the four Penrose
equations A X A = A, X A X = X, (A X)^T = A X, (X A)^T = X A exactly mod
p, the two denominators equal, and d X / d over the rationals against
``numpy.linalg.pinv``; the runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from mpyc_tpu_torch.demos import parties


def blocks(mpc, TL, TR, BL, BR):
    top = mpc.np_concatenate((TL, TR), axis=1)
    bot = mpc.np_concatenate((BL, BR), axis=1)
    return mpc.np_concatenate((top, bot), axis=0)


def reflexive_generalized_inverse(mpc, A):
    """A reflexive generalized inverse Z of the m x m secure matrix A, and
    det A (the JAX demo's recursion)."""
    m = int(A.shape[0])
    if m == 1:
        d = mpc.np_getitem(A, (0, 0))
        b = d == 0
        z = mpc.reciprocal(d + b) - b     # 0 where d == 0
        return mpc.np_reshape(mpc.np_fromlist([z]), (1, 1)), d
    t = m // 2
    E = mpc.np_getitem(A, (slice(0, t), slice(0, t)))
    F = mpc.np_getitem(A, (slice(0, t), slice(t, m)))
    FT = mpc.np_getitem(A, (slice(t, m), slice(0, t)))
    H = mpc.np_getitem(A, (slice(t, m), slice(t, m)))
    X, d1 = reflexive_generalized_inverse(mpc, E)
    FTX = mpc.np_matmul(FT, X)
    Y, d2 = reflexive_generalized_inverse(mpc, H - mpc.np_matmul(FTX, F))
    XFY = mpc.np_matmul(mpc.np_transpose(FTX), Y)
    Z = blocks(mpc, X + mpc.np_matmul(XFY, FTX), -XFY,
               -mpc.np_transpose(XFY), Y)
    return Z, d1 * d2


def pseudo_inverse(mpc, A, U, UT):
    """The n x m pseudoinverse of the m x n secure matrix A, with the
    public preconditioner U (and its transpose UT)."""
    m, n = (int(s) for s in A.shape)
    AT = mpc.np_transpose(A)
    if m > n:
        return mpc.np_transpose(pseudo_inverse(mpc, AT, U, UT))
    A_AT = mpc.np_matmul(A, AT)
    M = mpc.np_matmul(A_AT, A_AT)
    X = mpc.np_matmul(mpc.np_matmul(U, M), UT)
    X = reflexive_generalized_inverse(mpc, X)[0]
    X = mpc.np_matmul(mpc.np_matmul(UT, X), U)
    return mpc.np_matmul(AT, mpc.np_matmul(X, A_AT))


def signed(v, p):
    v = int(v) % p
    return v - p if v > p // 2 else v


def random_matrix(m, n, r, b, gen):
    """An m x n integer matrix of rank r with entries of about b bits
    (the JAX demo's draw: a product of m x r and r x n matrices of
    entries in [-beta, beta), redrawn until its rank is r)."""
    if r == 0:
        return np.zeros((m, n), dtype=np.int64)
    beta = 1 + math.floor(math.sqrt((2 ** (b - 1) - 1) / r))
    while True:
        A = gen.integers(-beta, beta, (m, r)) @ gen.integers(-beta, beta,
                                                             (r, n))
        if np.linalg.matrix_rank(A) == r:
            return A


def secint_bits(A, r):
    """Springer's bound for the pseudoinverse of A of rank r, in terms
    of its Frobenius norm: 1 + ceil(r log2(|A|_F^2 / r)) bits (one for
    the sign)."""
    fro2 = float(np.linalg.norm(A, 'fro')) ** 2
    return 1 + (0 if r == 0 else math.ceil(r * math.log(fro2 / r, 2)))


def run(mpc, m=5, n=None, r=None, b=4, seed=None, out=print) -> dict:
    """The JAX demo's run, checked: -> {'ok', 'l', 'L', 's', ...}."""
    n = n or m
    r = min(m, n) if r is None else r
    gen = np.random.default_rng(seed)
    A_pub = random_matrix(m, n, r, b, gen)
    out(f'Matrix A, {m}x{n} of rank {r}, entries up to bit length {b}')
    A1 = np.linalg.pinv(A_pub)
    l = secint_bits(A_pub, r)
    secint = mpc.SecInt(l)
    field = secint.field
    p = field.modulus
    out(f'Using secure integers: {secint.__name__} '
        f'({field.array.ctx.L} limbs)')
    sync = torch.cuda.synchronize if mpc.device.type == 'cuda' else \
        (lambda: None)
    sync()
    t0 = time.perf_counter()
    A = secint.array(A_pub.astype(object))
    rnd = gen.integers(0, min(p, 2 ** 63), size=(min(m, n),) * 2,
                       dtype=np.int64).astype(object)
    U = field.array(rnd, mpc.device)
    UT = field.array(rnd.T.copy(), mpc.device)
    X = pseudo_inverse(mpc, A, U, UT)
    I = secint.array(np.eye(m, dtype=object))
    D = I + mpc.np_matmul(A, mpc.np_transpose(A) - X)
    d_rgi = reflexive_generalized_inverse(mpc, D)[1]
    d_det = mpc.np_det(D)
    X = mpc.output(X, raw=True)
    d = int(mpc.output(d_rgi, raw=True).value)
    d_ = int(mpc.output(d_det, raw=True).value)
    sync()
    secs = time.perf_counter() - t0
    Xv = np.vectorize(int, otypes=[object])(np.asarray(X.value,
                                                       dtype=object))
    Xv = Xv.reshape(n, m) % p
    Av = A_pub.astype(object)
    AX, XA = Av @ Xv % p, Xv @ Av % p
    penrose = (np.array_equal(AX @ Av % p, Av % p)
               and np.array_equal(Xv @ AX % p, Xv % p)
               and np.array_equal(AX.T % p, AX)
               and np.array_equal(XA.T % p, XA))
    dX = np.vectorize(lambda v: signed(d * int(v), p), otypes=[object])(Xv)
    Xq = dX.astype(float) / signed(d, p)
    close = bool(np.allclose(A1, Xq))
    out(f'common denominator vol^2(A) {signed(d, p)}, from the recursion '
        f'and np_det: {d == d_}; Penrose equations: {penrose}; equal to '
        f'numpy.linalg.pinv: {close}; {secs:.4f} s')
    return dict(ok=bool(d == d_ and penrose and close), l=l,
                L=field.array.ctx.L, s=secs, m=m, n=n, r=r)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-m', type=int, help='rows (default N or R or 5)')
    parser.add_argument('-n', type=int, help='columns (default M or R or 5)')
    parser.add_argument('-r', type=int, help='rank (default min(M, N))')
    parser.add_argument('-b', type=int, default=4,
                        help='bit length of the entries (default 4)')
    parser.add_argument('--seed', type=int, default=None,
                        help='seed of A and U (default: fresh)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    m = args.m or args.n or args.r or 5
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, m, args.n or m, args.r, args.b, args.seed)
    mpc.run(mpc.shutdown())
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
