"""Demo: vectorized LP solver with exact secure integer arithmetic, on the
port.

    python -m mpyc_tpu_torch.demos.np_lpsolver [-i I] [-l L]
        [--max-pivots K] [-M m] [-T t] [--device cuda|cpu]

The co-located path of ``demos/np_lpsolver.py`` on ``SimRuntime(3)``
(t = 1), line for line (``solve`` is the body of its ``main``): the
whole simplex tableau is one secure integer array, so each pivot step is
a constant number of batched rounds: an oblivious argmin over the cost
row, an oblivious argmin over secure fractions (row ratios) with a
two-component comparison key, and a rank-1 integer-pivoting update of
the tableau. The certificate (LP duality) extracts the primal and dual
solutions with powers of the field's root of unity (an inverse DFT of
secure registers) and checks c.x == y.b, A.x <= b, x >= 0, y.A >= c and
y >= 0 securely.

Datasets (``demos/data/lp``): 0 = uvlp (default), 1 = wiki, 2 = tb2x2,
3 = woody, 4 = LPExample_R20, 5 = sc50b, 6 = kb2, 7 = LPExample. Their
fields have l + 32 bits (SecInt(l) with a root of unity of order at
least m + n): two limbs at l = 6-8, four at l = 70 (LPExample_R20), five
at l = 104 and 110 (sc50b, LPExample); kb2's SecInt(560) takes 19 limbs,
whose products and comparisons the wide kernels take on the card
(csrc/wide.cu, csrc/sgn_wide.cu), at every (t, m) of ``-M``/``-T``.
``--max-pivots K`` stops the solve after K pivots and opens its tableau
(``solve``'s ``max_pivots``), which the runner holds against
``plain_solve``'s after as many.

``plain_solve`` runs the same integer-pivoting simplex on the host in
Python ints (the same pivot rules: the first least cost, the first least
ratio among rows of positive pivot), independent of both packages; the
runner holds its opened results to it.
"""

from __future__ import annotations

import argparse
import logging
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np

from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data' / 'lp'

# name, bit length, scale factor, expected iteration count
DATASETS = [
    ('uvlp', 8, 1, 2), ('wiki', 6, 1, 1), ('tb2x2', 6, 1, 2),
    ('woody', 8, 1, 3), ('LPExample_R20', 70, 1, 9), ('sc50b', 104, 10, 55),
    ('kb2', 560, 100000, 154), ('LPExample', 110, 1, 175),
]


class FracKey:
    """Batched argmin key over (numerator, denominator) pairs."""

    size = 2  # components along the last axis

    def __init__(self, a):
        self.a = a

    def __lt__(self, other):
        lhs = self.a[..., 0] * other.a[..., 1]
        rhs = other.a[..., 0] * self.a[..., 1]
        return lhs < rhs


def geometric_array(mpc, first, ratio, n):
    """Secure array [first, first*ratio, ..., first*ratio^(n-1)],
    built by repeated squaring in ~2 log2 n rounds."""
    if n <= 2:
        seq = [first] + ([first * ratio] if n == 2 else [])
        return mpc.np_fromlist(seq)
    half = geometric_array(mpc, first, ratio * ratio, (n + 1) // 2)
    tail = half[-1:] if n % 2 else None
    if n % 2:
        half = half[:-1]
    woven = np.stack((half, ratio * half)).reshape(2 * len(half), order='F')
    return np.append(woven, tail) if tail is not None else woven


def read_csv(name):
    """A dataset's CSV as floats: the cost row, then the constraints'
    rows [A | b]."""
    return np.genfromtxt(DATA / (name + '.csv'), dtype=float, delimiter=',')


def tableau_ints(name, scale):
    """CSV -> scaled, gcd-reduced integer tableau (object ints)."""
    raw = read_csv(name)
    raw[0, -1] = 0.0                       # objective starts at 0
    ints = np.vectorize(int, otypes='O')(raw * scale)
    factors = np.maximum(np.gcd.reduce(ints[1:], axis=1, keepdims=True), 1)
    ints[1:] //= factors                   # reduce rows, keep cost row
    return ints


def load_tableau(name, scale, secint):
    """CSV -> scaled, gcd-reduced secure integer tableau."""
    return secint.array(tableau_ints(name, scale))


def root_powers(secint):
    """All N powers of the field's Nth root of unity, as a public array."""
    Zp = secint.field
    N = Zp.nth
    vals = [pow(Zp.root, i, Zp.modulus) for i in range(N)]
    arr = Zp.array(np.array(vals, dtype=object), secint.array.device)
    assert arr[-1] * Zp(Zp.root) == Zp(1)
    return arr, N


def idft_extract(mpc, w_powers, N, scaled, registers, offsets):
    """Read values out of power-of-w registers with an inverse DFT."""
    spectrum = geometric_array(mpc, scaled[0] / N, registers[0], N)
    for v, reg in zip(list(scaled)[1:], list(registers)[1:]):
        spectrum = spectrum + geometric_array(mpc, v / N, reg, N)
    coefs = w_powers[[[(-j * k) % N for k in range(N)] for j in offsets]]
    return coefs @ spectrum


def solve(mpc, dataset, bit_length=0, out=print, on_pivot=None,
          max_pivots=0):
    """Solve dataset I on runtime mpc as ``demos/np_lpsolver.py``'s main
    does, printing its lines through ``out`` (and calling ``on_pivot``
    with the pivot's number before each pivot's work, if given). Returns
    the opened results: iterations, max (mx), common denominator (cd),
    solution x (ints, the values times cd) and the certificate. With
    ``max_pivots`` the solve stops after that many pivots and returns its
    opened tableau then (T, a list of rows of ints) and common denominator
    (cd; ``stopped`` True), no solution or certificate."""
    name, bit_length_, scale, n_iter = DATASETS[dataset]
    if bit_length:
        bit_length_ = bit_length
    bit_length = bit_length_
    probe = read_csv(name)
    m, n = probe.shape[0] - 1, probe.shape[1] - 1
    secint = mpc.SecInt(bit_length, n=m + n)  # field with (m+n)th root
    out(f'Using secure {bit_length}-bit integers: {secint.__name__}')
    out(f'dataset: {name} with {m} constraints and {n} variables '
        f'(scale factor {scale})')
    T = load_tableau(name, scale, secint)
    c, A, b = -T[0, :-1], T[1:, :-1], T[1:, -1]  # max c.x s.t. A.x<=b, x>=0
    w_powers, N = root_powers(secint)

    mpc.run(mpc.start())

    cobasis = w_powers[:n]
    basis = w_powers[N - m:N]
    denom = secint(1)                      # common denominator of T

    iteration = 0
    while True:
        if on_pivot is not None:
            on_pivot(iteration + 1)
        col_sel, low = T[0, :-1].argmin()
        if not mpc.run(mpc.output(low < 0)):
            break
        col = T[:, :-1] @ col_sel
        ratios = np.column_stack((T[1:, -1] + (col[1:] <= 0), col[1:]))
        row_sel, picked = ratios.argmin(key=FracKey)
        pivot = picked[1]

        iteration += 1
        if logging.root.isEnabledFor(logging.INFO):
            mx, cd, p = (mpc.run(mpc.output(v))
                         for v in (T[0, -1], denom, pivot))
            logging.info('Iteration %d/%d: %s pivot=%s',
                         iteration, n_iter, mx / cd, p / cd)

        # registers swap obliviously
        move = basis @ row_sel - cobasis @ col_sel
        cobasis, basis = cobasis + move * col_sel, basis - move * row_sel

        # rank-1 integer-pivoting update of the whole tableau
        col_ext = np.concatenate((col_sel, np.array([0])))
        row_ext = np.concatenate((np.array([0]), row_sel))
        inv_d = 1 / denom
        drop = col * inv_d - row_ext
        mix = row_ext @ T + denom * col_ext
        T = T * (pivot * inv_d) - np.outer(drop, mix)
        denom = pivot
        if iteration == max_pivots:
            T = np.asarray(mpc.run(mpc.output(T)))
            cd = mpc.run(mpc.output(denom))
            out(f'objective {T[0, -1]} / {cd} after {iteration} pivots '
                '(stopped)')
            mpc.run(mpc.shutdown())
            return dict(iterations=iteration, stopped=True, cd=int(cd),
                        T=[[int(v) for v in row] for row in T.tolist()])

    mx = mpc.run(mpc.output(T[0, -1]))
    cd = mpc.run(mpc.output(denom))
    out(f'max = {mx} / {cd} / {scale} = {mx / cd / scale} '
        f'in {iteration} iterations')

    x = idft_extract(mpc, w_powers, N, T[1:, -1], basis, range(n))
    y = idft_extract(mpc, w_powers, N, T[0, :n], cobasis, range(N - m, N))
    conditions = [c @ x == y @ b,
                  mpc.np_all(A @ x <= b * cd),
                  mpc.np_all(x >= 0),
                  mpc.np_all(y @ A >= c * cd),
                  mpc.np_all(y >= 0)]
    ok = bool(mpc.run(mpc.output(mpc.all(conditions))))
    out(f'verification c.x == y.b, A.x <= b, x >= 0, y.A >= c, '
        f'y >= 0: {ok}')

    x = mpc.run(mpc.output(x))
    x = [int(a) for a in np.asarray(x).tolist()]
    out(f'solution = {[a / cd for a in x]}')

    mpc.run(mpc.shutdown())
    return dict(iterations=iteration, mx=mx, cd=cd, x=x, ok=ok)


# -- the plain exact solver ---------------------------------------------------

def _plain_argmin(keys, less):
    """Index of the least key by the secure argmin's odd-even tournament
    (``np_argmin``: neighbours compared by ``less``, the earlier one kept
    unless the later is less, the winners paired again; an odd one out
    first): the first occurrence of the least key of a total order."""
    idx = list(range(len(keys)))
    while len(idx) > 1:
        n0 = len(idx) % 2
        won = [j if less(keys[j], keys[i]) else i
               for i, j in zip(idx[n0::2], idx[n0 + 1::2])]
        idx = idx[:n0] + won
    return idx[0]


def plain_solve(T, max_pivots=0):
    """The integer-pivoting simplex of ``solve`` in Python ints on the
    tableau ``T`` ((m + 1) x (n + 1) ints: the cost row, then [A | b]):
    the entering column is the first least cost (while it is negative),
    the leaving row the first least ratio b_i / col_i among rows with
    col_i > 0 (ratios compared as the secure key compares them, rows with
    col_i <= 0 keyed (b_i + 1, col_i)). Each pivot step replaces T by
    (T pivot - col row) / denom outside the pivot row and column, the
    column by -col and its pivot by the old denom, and denom by the
    pivot. Returns (iterations, mx, cd, x): the objective and the
    solution times the common denominator cd. With ``max_pivots``, as
    ``solve``'s, it stops after that many pivots and returns (iterations,
    T, cd): the tableau then (a list of rows of ints)."""
    T = [[int(v) for v in row] for row in T]
    m, n = len(T) - 1, len(T[0]) - 1
    basis = [n + i for i in range(m)]      # variable of each row
    cobasis = list(range(n))               # variable of each column
    denom = 1
    iterations = 0
    while True:
        j = _plain_argmin(T[0][:n], lambda u, v: u < v)
        if T[0][j] >= 0:
            break
        keys = [(T[i][n] + (T[i][j] <= 0), T[i][j]) for i in range(1, m + 1)]
        i = 1 + _plain_argmin(keys, lambda u, v: u[0] * v[1] < v[0] * u[1])
        pivot = T[i][j]
        iterations += 1
        basis[i - 1], cobasis[j] = cobasis[j], basis[i - 1]
        new = []
        for r in range(m + 1):
            if r == i:
                row = list(T[i])
                row[j] = denom
            else:
                row = []
                for k in range(n + 1):
                    if k == j:
                        row.append(-T[r][j])
                        continue
                    num = T[r][k] * pivot - T[r][j] * T[i][k]
                    q, rem = divmod(num, denom)
                    assert rem == 0, 'integer pivoting lost exactness'
                    row.append(q)
            new.append(row)
        T, denom = new, pivot
        if iterations == max_pivots:
            return iterations, T, denom
    x = [0] * n
    for r, v in enumerate(basis):
        if v < n:
            x[v] = T[r + 1][n]
    return iterations, T[0][n], denom, x


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, metavar='I', default=0,
                        help=('dataset 0=uvlp (default), 1=wiki, 2=tb2x2, '
                              '3=woody, 4=LPExample_R20, 5=sc50b, 6=kb2, '
                              '7=LPExample'))
    parser.add_argument('-l', '--bit-length', type=int, metavar='L',
                        default=0)
    parser.add_argument('--max-pivots', type=int, metavar='K', default=0,
                        help='stop after K pivots and check the tableau')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    res = solve(mpc, args.dataset, args.bit_length,
                max_pivots=args.max_pivots)
    name, _, scale, _ = DATASETS[args.dataset]
    if res.get('stopped'):
        want = plain_solve(tableau_ints(name, scale), args.max_pivots)
        same = want == (res['iterations'], res['T'], res['cd'])
        print(f'plain exact solver after {want[0]} pivots: the same '
              f'tableau and denominator: {same}')
        return 0 if same else 1
    assert res['ok']
    want = plain_solve(tableau_ints(name, scale))
    got = (res['iterations'], res['mx'], res['cd'], res['x'])
    print(f'plain exact solver: {want[0]} iterations, max = '
          f'{Fraction(want[1], want[2] * scale)}, equal to the secure '
          f'run: {got == want}')
    return 0 if got == want else 1


if __name__ == '__main__':
    sys.exit(main())
