"""Demo: secure ridge regression by a blinded Bareiss solve, on the port.

    python -m mpyc_tpu_torch.demos.ridgeregression [-i I] [-a A] [-l L]
        [-n N] [-d D] [-e E] [--field-bits B] [--seed S]
        [--device cuda|cpu]

The co-located path of ``demos/ridgeregression.py`` (Blom, Bouman,
Schoenmakers, de Vreede) on ``SimRuntime(3)``: the model W = A^-1 B of A =
Z^T Z + lambda I and B = Z^T W, Z = [round(beta X) | beta] and W =
round(beta Y) at accuracy beta = 2^alpha. The Gram block is computed in
public over SecInt(bit length of gamma + 1), shared by one reshare and
converted (``convert``) into SecFld(min_order=2 bound + 1, signed) with
bound = d^(d/2) gamma^d, the Hadamard bound of (adj A) B and det A. The
system is solved by ``linear_solve``: a secret random R = L U of known
secret determinant (PRSS draws), R A opened, Bareiss's division-free
elimination run in public on R A against the parties' share columns of R
B (linear in the shares), det A = det(R A) / det R. The field has 7 to 12
limbs on the synthetic set and the wine data, 42 on student-mat; on the
card its products, reshares, reciprocal and draws run the wide kernels
(``csrc/wide.cu``).

Datasets: 0 synthetic (default; n = 1,000, d = 10, e = 1 at accuracies
4-7: a numpy stand-in for scikit-learn's ``make_regression``, the same
shape of data, from ``--seed``), 1 student-mat (``student.zip``), 2
winequality-red, 3 winequality-white, read from ``demos/data/regr`` with
``csv`` and ``zipfile``; a seeded 70/30 train/test split. Each solve is
checked exactly, (adj A) B and det A against a plain integer Bareiss
elimination of the same A and B, and its relative train error against a
plain ridge solve (``numpy.linalg.solve``, the intercept unregularized as
in scikit-learn's Ridge) within the JAX demo's 0.2; the runner exits 1
otherwise. ``--field-bits`` raises the field to at least 2^B (the tests
force a small set into a wide field). Left out: the JAX demo's
``--ratrec`` (rational reconstruction in a second field).
"""

from __future__ import annotations

import argparse
import csv
import io
import math
import os
import sys
import time
import zipfile
from fractions import Fraction

import numpy as np
import torch

from mpyc_tpu_torch.demos import parties

DATA = os.path.join(os.path.dirname(__file__), '..', '..', 'demos', 'data',
                    'regr')
DATASETS = {1: ('student-mat', 6), 2: ('winequality-red', 7),
            3: ('winequality-white', 8)}
SYNTHETIC_ALPHAS = (4, 5, 6, 7)


def _rescale(cols):
    """Affine map of each column onto [-1, 1]."""
    lo, hi = cols.min(axis=0), cols.max(axis=0)
    return (cols - (lo + hi) / 2) * (2 / (hi - lo))


def synthesize_data(n_samples, n_features, n_targets, seed):
    """A regression problem of the JAX demo's shape (scikit-learn's
    ``make_regression`` with n_informative = d - 5, bias 42,
    effective_rank = d - 3, tail_strength 0.5, noise 1.2), from numpy
    alone: a low-rank matrix of the same singular profile, a linear
    target on its first n_informative columns, then every column
    rescaled onto [-1, 1]."""
    g = np.random.default_rng(seed)
    k = min(n_samples, n_features)
    rank = max(1, n_features - 3)
    u, _ = np.linalg.qr(g.standard_normal((n_samples, k)))
    v, _ = np.linalg.qr(g.standard_normal((n_features, k)))
    sv = np.arange(k) / rank
    s = 0.5 * np.exp(-sv ** 2) + 0.5 * np.exp(-0.1 * sv)
    X = (u * s) @ v.T
    n_inf = max(1, n_features - 5)
    coef = np.zeros((n_features, n_targets))
    coef[:n_inf] = 100 * g.random((n_inf, n_targets))
    Y = X @ coef + 42 + 1.2 * g.standard_normal((n_samples, n_targets))
    return _rescale(np.hstack([X, Y]))


def load_dataset(infofile):
    """An info CSV and its data file (``csv``; a ``zip!member`` name read
    with ``zipfile``) -> (X with the targets last, d, e, split): numerical
    features mapped onto [-1, 1] by the info's range, categorical ones
    one-hot with +1/-1 levels, excluded ones dropped (the JAX demo's
    ``load_dataset``)."""
    with open(infofile, newline='') as fh:
        meta = csv.reader(fh)
        fname, delim, hdr, split, n, d_in, e = next(meta)
        hdr, split, d_in, e = (int(v) for v in (hdr, split, d_in, e))
        specs = []
        for _ in range(d_in + e):
            line = next(meta)
            if line[0] == 'numerical':
                specs.append(('num', float(line[1]), float(line[2])))
            elif line[0] == 'categorical':
                specs.append(('cat', [v for v in line[1:] if v]))
            elif line[0] == 'exclude':
                specs.append(('skip',))
            else:
                raise ValueError(f'bad feature spec: {line[0]}')
    path = os.path.join(DATA, fname)
    if '!' in path:
        zpath, inner = path.split('!')
        fh = io.TextIOWrapper(zipfile.ZipFile(zpath).open(inner),
                              newline='')
    else:
        fh = open(path, newline='')
    with fh:
        rows = [r[:len(specs)] for r in csv.reader(fh, delimiter=delim)]
    raw = np.array(rows[hdr:], dtype=object)
    cols = []
    for j, spec in enumerate(specs):
        if spec[0] == 'num':
            lo, hi = spec[1], spec[2]
            col = raw[:, j].astype(float)
            cols.append((col - (lo + hi) / 2) * (2 / (hi - lo)))
        elif spec[0] == 'cat':
            for level in spec[1]:
                cols.append(np.where(raw[:, j] == level, 1.0, -1.0))
    X = np.column_stack(cols)
    return X, X.shape[1] - e, e, split


def train_test(X, split, seed):
    """The first ``split`` rows against the rest, or with no split a
    seeded 70/30 split of a permutation of the rows."""
    if split:
        return X[:split], X[split:]
    perm = np.random.default_rng(seed).permutation(len(X))
    n1 = int(math.ceil(0.7 * len(X)))
    return X[perm[:n1]], X[perm[n1:]]


def gram_block(X1, Y1, beta, lambda_):
    """A | B = Z^T [Z | W] + lambda I on the first d columns, exact
    integers: Z = [round(beta X) | beta] (the intercept), W = round(beta
    Y), rounded toward zero as the JAX demo's ``normal_equations``."""
    n1 = len(X1)
    Z = np.hstack([(X1 * float(beta)).astype(np.int64).astype(object),
                   np.full((n1, 1), beta, dtype=object)])
    W = (Y1 * float(beta)).astype(np.int64).astype(object)
    G = Z.T @ np.hstack([Z, W])
    d = Z.shape[1]
    G[np.arange(d), np.arange(d)] += lambda_
    return G


def bareiss_batched(p, M):
    """Division-free elimination mod p on a (..., d, d + e) object array
    (the JAX demo's ``bareiss_batched``): the first d columns, public and
    equal across the batch, drive it; the trailing e columns may hold the
    parties' shares. -> (solution (..., d, e), determinant (...,))."""
    d = M.shape[-2]
    for k in range(d):
        piv = M[..., k:k + 1, k:k + 1]
        low = M[..., k + 1:, k + 1:]
        M[..., k + 1:, k + 1:] = (piv * low - M[..., k + 1:, k:k + 1]
                                  * M[..., k:k + 1, k + 1:]) % p
    inv_vec = np.vectorize(lambda v: pow(int(v), -1, p), otypes=[object])
    for i in range(d - 1, -1, -1):
        inv = inv_vec(M[..., i, i])
        rhs = M[..., i, d:]
        if i + 1 < d:
            rhs = rhs - (M[..., i, None, i + 1:d]
                         @ M[..., i + 1:d, d:])[..., 0, :]
        M[..., i, d:] = rhs % p * inv[..., None] % p
        if i < d - 2:
            M[..., i, i] = inv
    det = M[..., d - 1, d - 1]
    scale = np.ones(det.shape, dtype=object)
    for i in range(d - 2):
        scale = scale * M[..., i, i] % p
        det = det * scale % p
    return M[..., :, d:], det


def blinding_matrix(mpc, secnum, d):
    """A secret uniformly random R = L U of known secret determinant: L
    unit lower triangular, U upper triangular, their entries one PRSS draw
    (``mpc._np_randoms``), det R = prod(diag U), nonzero but with
    probability about d / p. -> (R, det R)."""
    strict = d * (d - 1) // 2
    r = mpc._share(mpc._np_randoms(secnum, 2 * strict + d))
    m, L = r.data.shape[0], r.data.shape[-1]
    lo = torch.zeros((m, d, d, L), dtype=torch.int32, device=r.data.device)
    up = torch.zeros_like(lo)
    li, lj = np.tril_indices(d, -1)
    ui, uj = np.triu_indices(d, 1)
    lo[:, li, lj] = r.data[:, :strict]
    up[:, ui, uj] = r.data[:, strict:2 * strict]
    up[:, np.arange(d), np.arange(d)] = r.data[:, 2 * strict:]
    arr = secnum.array
    low = mpc._wrap(arr, r.from_data(lo), True) + np.eye(d, dtype=object)
    upp = mpc._wrap(arr, r.from_data(up), True)
    diag = mpc._wrap(arr, r.from_data(r.data[:, 2 * strict:]), True)
    return mpc.np_matmul(low, upp), mpc.np_prod(diag)


def linear_solve(mpc, A, B):
    """Solve A w = B for secure (d, d) A and (d, e) B of one secure type:
    -> ((adj A) B, det A), secure. R A is opened (uniformly random where A
    is nonsingular); Bareiss runs on it against the share columns of R B,
    all parties' at once (a batch axis); det A = det(R A) / det R."""
    secnum = type(A).sectype
    field = secnum.field
    p = field.modulus
    d, e = A.shape[0], B.shape[1]
    R, det_r = blinding_matrix(mpc, secnum, d)
    RA = np.asarray(mpc.output(mpc.np_matmul(R, A), raw=True).value,
                    dtype=object).reshape(d, d) % p
    RB = mpc._share(mpc.np_matmul(R, B))
    rb = np.asarray(RB.value, dtype=object) % p           # (m, d, e)
    m = rb.shape[0]
    tableau = np.concatenate([np.broadcast_to(RA, (m, d, d)).copy(), rb],
                             axis=2)
    sol, det_batch = bareiss_batched(p, tableau)
    det_a = secnum(int(det_batch[0])) / det_r
    W = mpc._wrap(type(A), field.array(sol.astype(object), mpc.device),
                  True)
    return W * det_a, det_a


def plain_adj_det(A, B):
    """(adj A) B and det A of integer matrices, exactly: Bareiss's
    fraction-free elimination on [A | B] (Python ints), det A its last
    pivot, then back substitution in fractions, times det A."""
    d = len(A)
    M = [list(map(int, A[i])) + list(map(int, B[i])) for i in range(d)]
    prev = 1
    for k in range(d - 1):
        if M[k][k] == 0:
            raise ZeroDivisionError('a zero pivot: A is singular or '
                                    'needs pivoting')
        for i in range(k + 1, d):
            for j in range(k + 1, len(M[i])):
                M[i][j] = (M[i][j] * M[k][k] - M[i][k] * M[k][j]) // prev
            M[i][k] = 0
        prev = M[k][k]
    det = M[d - 1][d - 1]
    e = len(B[0])
    x = [[Fraction(0)] * e for _ in range(d)]
    for i in range(d - 1, -1, -1):
        for j in range(e):
            s = Fraction(M[i][d + j]) - sum(M[i][k] * x[k][j]
                                            for k in range(i + 1, d))
            x[i][j] = s / M[i][i]
    adj = [[x[i][j] * det for j in range(e)] for i in range(d)]
    if any(v.denominator != 1 for row in adj for v in row):
        raise ArithmeticError('(adj A) B is not integral')
    return [[int(v) for v in row] for row in adj], det


def ridge_plain(X1, Y1, lambda_):
    """The plain ridge solve with an unregularized intercept (scikit-
    learn's Ridge on centred data): -> (w, intercept)."""
    xm, ym = X1.mean(axis=0), Y1.mean(axis=0)
    Xc, Yc = X1 - xm, Y1 - ym
    w = np.linalg.solve(Xc.T @ Xc + lambda_ * np.eye(X1.shape[1]), Xc.T @ Yc)
    return w, ym - xm @ w


def rmse(Y, P):
    return np.sqrt(((Y - P) ** 2).mean(axis=0))


def field_sizes(n1, d, alpha, lambda_):
    """(bit length of the Gram block's secure integers, the secure
    field's min_order) of n1 training samples and a d x d system (the
    intercept's column included) at accuracy alpha: gamma = n1 beta^2 +
    lambda beta^2 bounds A's entries, bound = d^(d/2) gamma^d (Hadamard)
    those of (adj A) B and det A, and the field holds 2 bound + 1."""
    beta = 2 ** alpha
    gamma = n1 * beta ** 2 + round(lambda_ * beta ** 2)
    bound = round(d ** (d / 2)) * gamma ** d
    return gamma.bit_length() + 1, 2 * bound + 1


def training_sizes(dataset, n=1000, d=10, seed=0):
    """(samples in the training set, d of the system with the
    intercept) of a dataset as ``run`` splits it."""
    if dataset:
        name, _ = DATASETS[dataset]
        X, d, _, split = load_dataset(os.path.join(DATA,
                                                   f'info-{name}.csv'))
        n = len(X)
    else:
        split = 0
    return len(train_test(np.zeros((n, 1)), split, seed)[0]), d + 1


def solve(mpc, X1, Y1, alpha, lambda_, field_bits=0):
    """One secure solve at accuracy alpha, checked: -> dict with ok,
    the field's limbs, the model, and the seconds."""
    sync = torch.cuda.synchronize if mpc.device.type == 'cuda' else \
        (lambda: None)
    d, e = X1.shape[1] + 1, Y1.shape[1]
    beta = 2 ** alpha
    lam = round(lambda_ * beta ** 2)
    l, min_order = field_sizes(len(X1), d, alpha, lambda_)
    secint = mpc.SecInt(l)
    secnum = mpc.SecFld(min_order=max(min_order, 1 << field_bits),
                        signed=True)
    p = secnum.field.modulus
    G = gram_block(X1, Y1, beta, lam)
    sync()
    t0 = time.perf_counter()
    gram = secint.field.array(G.reshape(-1) % secint.field.modulus,
                              mpc.device)
    gram = mpc._reshare(mpc._share_like(gram))
    AB = mpc.convert(mpc._wrap(secint.array, gram, True), secnum)
    AB = mpc.np_reshape(AB, (d, d + e))
    A = mpc.np_getitem(AB, (slice(None), slice(0, d)))
    B = mpc.np_getitem(AB, (slice(None), slice(d, d + e)))
    adj_b, det_a = linear_solve(mpc, A, B)
    got = mpc.output(adj_b).signed().reshape(d, e)
    det = int(mpc.output(det_a))
    sync()
    secs = time.perf_counter() - t0
    want_adj, want_det = plain_adj_det(G[:, :d], G[:, d:])
    exact = det == want_det and [[int(v) for v in row] for row in got] == \
        want_adj
    w = np.array(got, dtype=float) / det
    w_ref, b_ref = ridge_plain(X1, Y1, lambda_)
    err = rmse(Y1, X1 @ w[:-1] + w[-1])
    err_ref = rmse(Y1, X1 @ w_ref + b_ref)
    rel = (err - err_ref) / err_ref
    return dict(ok=bool(exact and np.all(np.abs(rel) < 0.2)), exact=exact,
                L=secnum.field.array.ctx.L, bits=p.bit_length(), d=d, e=e,
                rel=[float(v) for v in rel], err=[float(v) for v in err],
                err_ref=[float(v) for v in err_ref], w=w, s=secs)


def run(mpc, dataset=0, alphas=None, lambda_=1.0, n=1000, d=10, e=1,
        field_bits=0, seed=0, out=print) -> dict:
    """The JAX demo's run on one dataset: a solve an accuracy, each
    checked (``solve``). -> {'ok', 'n', 'd', 'e', 'solves': {alpha:
    result}}."""
    if dataset:
        name, alpha0 = DATASETS[dataset]
        X, d, e, split = load_dataset(os.path.join(DATA,
                                                   f'info-{name}.csv'))
        alphas = alphas or (alpha0,)
    else:
        name = 'SYNTHETIC'
        X = synthesize_data(n, d, e, seed)
        split = 0
        alphas = alphas or SYNTHETIC_ALPHAS
    out(f'dataset: {name} with {len(X)} samples, {d} features, {e} '
        f'target(s); lambda {lambda_}')
    train, _ = train_test(X, split, seed)
    X1, Y1 = train[:, :d], train[:, d:]
    res = {'ok': True, 'n': len(X), 'd': d, 'e': e, 'solves': {}}
    for alpha in alphas:
        r = solve(mpc, X1, Y1, alpha, lambda_, field_bits)
        out(f'accuracy alpha {alpha}: SecFld of {r["bits"]} bits ({r["L"]} '
            f'limbs), (adj A) B and det A equal the plain Bareiss\'s: '
            f'{r["exact"]}; train error {r["err"]} (plain ridge '
            f'{r["err_ref"]}), relative {r["rel"]}; {r["s"]:.4f} s a solve')
        res['solves'][alpha] = r
        res['ok'] &= r['ok']
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, default=0,
                        help='0 synthetic (default), 1 student-mat, 2 '
                        'winequality-red, 3 winequality-white')
    parser.add_argument('-l', '--lambda_', type=float, default=1.0)
    parser.add_argument('-a', '--accuracy', type=int, default=-1,
                        help='one accuracy alpha (default: the dataset\'s)')
    parser.add_argument('-n', '--samples', type=int, default=1000)
    parser.add_argument('-d', '--features', type=int, default=10)
    parser.add_argument('-e', '--targets', type=int, default=1)
    parser.add_argument('--field-bits', type=int, default=0,
                        help='a field of at least 2^B (default: the bound\'s)')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the synthetic data and the split')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    res = run(mpc, args.dataset, (args.accuracy,) if args.accuracy >= 0
              else None, args.lambda_, args.samples, args.features,
              args.targets, args.field_bits, args.seed)
    mpc.run(mpc.shutdown())
    print(f'every solve exact and within 0.2 of the plain ridge: '
          f'{res["ok"]}')
    return 0 if res['ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
