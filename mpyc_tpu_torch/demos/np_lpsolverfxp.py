"""Demo: vectorized LP solver with secure fixed-point arithmetic, on the
port.

    python -m mpyc_tpu_torch.demos.np_lpsolverfxp [-i I] [-l L]
        [--device cuda|cpu]

The co-located path of ``demos/np_lpsolverfxp.py`` on ``SimRuntime(3)``
(t = 1), line for line (``solve`` is the body of its ``main``): the
simplex tableau is one secure fixed-point array, so each pivot step is a
constant number of batched rounds: an oblivious argmin over the cost row,
an oblivious argmin over the rows' ratios with a three-component key
(numerator, denominator, positivity guard: ``GuardedRatioKey``), the
basis registers swapped obliviously, and a rank-1 update of the tableau
with one batched fixed-point division by the pivot (Newton's reciprocal:
the pivot's bits, its normalisation, a few truncated products). The
solution is read out of the secret registers with secure unit vectors
(``unit_vector_sum``) and certified approximately by LP duality: c.x
within 1% of y.b, A.x <= 1.01 b + 0.0001, x >= 0, y.A >= c scaled by
1/1.01 or 1.01 less 0.0001, y >= 0.

Datasets (``demos/data/lp``) and their fixed-point types SecFxp(l) (f = l
/ 2, a field of l + f + 32 bits): 0 = uvlp, 1 = wiki (SecFxp(24), three
limbs), 2 = tb2x2 (SecFxp(18), two), 3 = woody (SecFxp(36), three), 4 =
LPExample_R20 and 5 = sc50b (SecFxp(52), four), 6 = kb2 and 7 =
LPExample (SecFxp(96), six).

The runner checks itself (``main``; exit 1 otherwise): the certificate
is true, the opened maximum lies within ``REL_ERROR`` (1%, the
certificate's own tolerance) of the dataset's exact optimum, and the
opened solution equals that of ``plain_solve`` (the same pivot rules in
float64 on the host, independent of both packages) within
``solution_tol`` (``check_solution``: where the two take other pivots, the
opened solution is held to the float data's constraints and optimum).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import numpy as np

from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data' / 'lp'

# name, fixed-point bit length, exact optimum
DATASETS = [
    ('uvlp', 24, 37 / 3), ('wiki', 24, 20), ('tb2x2', 18, 10.5),
    ('woody', 36, 540), ('LPExample_R20', 52, 3.441176), ('sc50b', 52, 70),
    ('kb2', 96, 1749.9204734889486), ('LPExample', 96, 1188806595),
]
REL_ERROR = 0.01    # the opened max against the exact optimum
# the certificate's conditions (LP duality, with the demo's tolerances)
CONDITIONS = ('c.x == y.b', 'A.x <= b', 'x >= 0', 'y.A >= c', 'y >= 0')


class GuardedRatioKey:
    """Batched argmin key over (num, den, guard) triples.

    Triples whose guard is 0 compare as +infinity; otherwise num/den
    ordered by cross-multiplication (all den > 0 where guard is 1).
    """

    size = 3  # components along the last axis

    def __init__(self, a):
        self.a = a

    def __lt__(self, other):
        smaller = self.a[..., 0] * other.a[..., 1] < \
            other.a[..., 0] * self.a[..., 1]
        mine, theirs = self.a[..., 2], other.a[..., 2]
        mine.integral = theirs.integral = True
        smaller = smaller * mine           # guard self
        return theirs * (smaller - 1) + 1  # guard other


def read_csv(name):
    """A dataset's CSV as floats, the objective's entry set to 0: the
    cost row, then the constraints' rows [A | b]."""
    raw = np.genfromtxt(DATA / (name + '.csv'), dtype=float, delimiter=',')
    raw[0, -1] = 0.0                       # objective starts at 0
    return raw


def load_tableau(name, secfxp):
    return secfxp.array(read_csv(name), integral=False)


def unit_vector_sum(mpc, scaled, registers, total, lo, hi):
    """Sum_i scaled_i * onehot(register_i)[lo:hi] via secure unit vectors."""
    acc = None
    for v, reg in zip(list(scaled), registers):
        term = v * mpc.np_unit_vector(reg, total)[lo:hi]
        acc = term if acc is None else acc + term
    return acc


def solve(mpc, dataset, bit_length=0, out=print, on_pivot=None,
          max_pivots=0):
    """Solve dataset I on runtime mpc as ``demos/np_lpsolverfxp.py``'s main
    does, printing its lines through ``out`` (and calling ``on_pivot``
    with the pivot's number before each pivot's work, if given). Returns
    the opened results: iterations, max (mx), its relative error, the
    solution x (floats), the certificate (ok) and, where it is false, the
    names of its conditions that fail (each opened on its own). With
    ``max_pivots`` the solve stops after that many pivots and returns its
    opened tableau and registers then (T, basis, cobasis; ``stopped``
    True), no solution or certificate."""
    name, bit_length_, exact_max = DATASETS[dataset]
    if bit_length:
        bit_length_ = bit_length
    bit_length = bit_length_
    secfxp = mpc.SecFxp(bit_length)
    out(f'Using secure {bit_length}-bit fixed-point numbers: '
        f'{secfxp.__name__}')
    T = load_tableau(name, secfxp)
    m, n = T.shape[0] - 1, T.shape[1] - 1
    out(f'dataset: {name} with {m} constraints and {n} variables')
    c, A, b = -T[0, :-1], T[1:, :-1], T[1:, -1]  # max c.x s.t. A.x<=b, x>=0

    mpc.run(mpc.start())

    cobasis = np.arange(n)
    basis = np.arange(n, n + m)

    iteration = 0
    while True:
        if on_pivot is not None:
            on_pivot(iteration + 1)
        col_sel, low = T[0, :-1].argmin()
        if not mpc.run(mpc.output(low < 0)):
            break
        col = T[:, :-1] @ col_sel
        den = col[1:]
        ratios = np.column_stack((T[1:, -1], den, den > 0.0001))
        row_sel, picked = ratios.argmin(key=GuardedRatioKey)
        pivot = picked[1]

        iteration += 1
        if logging.root.isEnabledFor(logging.INFO):
            mx = mpc.run(mpc.output(T[0, -1]))
            logging.info('Iteration %d: %s pivot=%s', iteration, mx,
                         mpc.run(mpc.output(pivot)))

        # registers swap obliviously
        move = basis @ row_sel - cobasis @ col_sel
        cobasis, basis = cobasis + move * col_sel, basis - move * row_sel

        # rank-1 update of the whole tableau
        col_ext = np.concatenate((col_sel, np.array([0])))
        row_ext = np.concatenate((np.array([0]), row_sel))
        drop = (col - row_ext) / pivot
        mix = row_ext @ T + col_ext
        T = T - np.outer(drop, mix)
        if iteration == max_pivots:
            T, basis, cobasis = (np.asarray(mpc.run(mpc.output(v)))
                                 for v in (T, basis, cobasis))
            out(f'objective {T[0, -1]} after {iteration} pivots (stopped)')
            return dict(iterations=iteration, T=T, stopped=True,
                        basis=np.rint(basis).astype(int),
                        cobasis=np.rint(cobasis).astype(int))

    mx = mpc.run(mpc.output(T[0, -1]))
    rel_error = (mx - exact_max) / exact_max
    out(f'max = {mx} (error {rel_error:.3%}) in {iteration} iterations')

    x = unit_vector_sum(mpc, T[1:, -1], basis, n + m, 0, n)
    y = unit_vector_sum(mpc, T[0, :n], cobasis, n + m, n, n + m)
    cx = c @ x
    dual_slack = np.where(c > 0, 1 / 1.01, 1.01) * c - 0.0001
    conditions = [abs(cx - y @ b) <= 0.01 * abs(cx),
                  mpc.np_all(A @ x <= 1.01 * b + 0.0001),
                  mpc.np_all(x >= 0),
                  mpc.np_all(y @ A >= dual_slack),
                  mpc.np_all(y >= 0)]
    ok = bool(mpc.run(mpc.output(mpc.all(conditions))))
    out(f'verification c.x == y.b, A.x <= b, x >= 0, y.A >= c, '
        f'y >= 0: {ok}')
    failed = [] if ok else [name for name, v in zip(CONDITIONS, conditions)
                            if not mpc.run(mpc.output(v))]

    x = mpc.run(mpc.output(x))
    out(f'solution = {np.asarray(x).tolist()}')

    mpc.run(mpc.shutdown())
    return dict(iterations=iteration, mx=mx, rel_error=rel_error,
                x=np.asarray(x).tolist(), ok=ok, failed=failed)


# -- the plain float solver ---------------------------------------------------

def _plain_argmin(keys, less):
    """Index of the least key by the secure argmin's odd-even tournament
    (neighbours compared by ``less``, the earlier one kept unless the
    later is less, the winners paired again; an odd one out first)."""
    idx = list(range(len(keys)))
    while len(idx) > 1:
        n0 = len(idx) % 2
        won = [j if less(keys[j], keys[i]) else i
               for i, j in zip(idx[n0::2], idx[n0 + 1::2])]
        idx = idx[:n0] + won
    return idx[0]


def plain_tableau(T, basis, cobasis):
    """The tableau ``solve`` holds at a basis, in float64, whatever the
    pivots that reached it: of the LP max c.x, A.x <= b, x >= 0 in ``T``
    (the cost row -c, then [A | b]) with slack variables n.., the basis
    matrix B of [A | I]'s columns ``basis`` (the variable of each row) and
    the columns N of ``cobasis``: rows B^-1 [N | b] under the costs c_B
    B^-1 [N | b] - [c_N | 0]."""
    T = np.array(T, dtype=np.float64)
    m = T.shape[0] - 1
    full = np.hstack([T[1:, :-1], np.eye(m)])
    cost = np.concatenate([-T[0, :-1], np.zeros(m)])
    rows = np.linalg.solve(full[:, basis], np.hstack([full[:, cobasis],
                                                      T[1:, -1:]]))
    top = cost[basis] @ rows - np.concatenate([cost[cobasis], [0.0]])
    return np.vstack([top, rows])


def plain_solve(T):
    """The simplex of ``solve`` in float64 on the tableau ``T`` (the cost
    row, then [A | b]): the entering column is the first least cost
    (while it is negative), the leaving row the first least ratio b_i /
    col_i among rows with col_i > 0.0001 (``GuardedRatioKey``: ratios by
    cross-multiplication, guarded rows above every other), the tableau's
    rank-1 update as ``solve`` computes it. Returns (iterations, max,
    solution)."""
    T = np.array(T, dtype=np.float64)
    m, n = T.shape[0] - 1, T.shape[1] - 1
    basis = list(range(n, n + m))          # variable of each row
    cobasis = list(range(n))               # variable of each column

    def less(u, v):
        return not v[2] or (u[2] and u[0] * v[1] < v[0] * u[1])
    iterations = 0
    while True:
        j = _plain_argmin(list(T[0, :-1]), lambda u, v: u < v)
        if T[0, j] >= 0:
            break
        col = T[:, j].copy()
        keys = [(T[i, -1], col[i], col[i] > 0.0001) for i in range(1, m + 1)]
        i = 1 + _plain_argmin(keys, less)
        iterations += 1
        basis[i - 1], cobasis[j] = cobasis[j], basis[i - 1]
        row_ext = np.zeros(m + 1)
        row_ext[i] = 1
        col_ext = np.zeros(n + 1)
        col_ext[j] = 1
        T = T - np.outer((col - row_ext) / col[i], T[i] + col_ext)
    x = [0.0] * n
    for r, v in enumerate(basis):
        if v < n:
            x[v] = float(T[r + 1, -1])
    return iterations, float(T[0, -1]), x


def solution_tol(bit_length: int, x_plain) -> float:
    """How far an opened solution value may lie from the float solver's:
    2^(-f / 2) times the largest value of the solution (at least 1), f =
    l // 2: half the type's fractional bits. Each pivot's truncated
    reciprocal and products err by a few units of 2^-f, and a small pivot
    amplifies them by the tableau's magnitudes."""
    return 2.0 ** (-(bit_length // 2) / 2) * max(1.0, *map(abs, x_plain))


def check_solution(name, bit_length, iterations, x):
    """The opened solution x against the plain float solver on dataset
    ``name``: (its pivots, the error, the tolerance ``solution_tol``).
    Where the pivots agree, the error is x's largest distance from the
    float solver's solution; otherwise (ties among ratios may break
    another way in fixed point, and a degenerate LP has other optimal
    vertices) the largest of x's violation of A.x <= b and x >= 0 and of
    the gap between c.x and the float solver's maximum."""
    T = read_csv(name)
    iters, mx, x_plain = plain_solve(T)
    x = np.asarray(x, dtype=np.float64)
    if iterations == iters:
        err = float(np.max(np.abs(x - x_plain)))
    else:
        c, A, b = -T[0, :-1], T[1:, :-1], T[1:, -1]
        err = float(max(np.max(A @ x - b), np.max(-x), abs(c @ x - mx), 0))
    return iters, err, solution_tol(bit_length, x_plain)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, metavar='I', default=0,
                        help=('dataset 0=uvlp (default), 1=wiki, 2=tb2x2, '
                              '3=woody, 4=LPExample_R20, 5=sc50b, 6=kb2, '
                              '7=LPExample'))
    parser.add_argument('-l', '--bit-length', type=int, metavar='L',
                        default=0)
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    t0 = time.perf_counter()
    res = solve(mpc, args.dataset, args.bit_length)
    s = time.perf_counter() - t0
    name, bit_length, _ = DATASETS[args.dataset]
    iters, err, tol = check_solution(name, args.bit_length or bit_length,
                                     res['iterations'], res['x'])
    good = res['ok'] and abs(res['rel_error']) <= REL_ERROR and err <= tol
    print(f'plain float solver: {iters} iterations; the opened solution '
          f'{err:.3g} off (tolerance {tol:.3g}); {s:.3f} s, '
          f'{s / max(res["iterations"], 1):.3f} s a pivot; '
          f'{"ok" if good else "FAILED"}')
    return 0 if good else 1


if __name__ == '__main__':
    sys.exit(main())
