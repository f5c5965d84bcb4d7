"""Demo: secure decision-tree learning (ID3 with Gini impurity), on the
port.

    python -m mpyc_tpu_torch.demos.np_id3gini [-i I] [-l L] [-e E] [-a A]
        [--no-pretty-tree] [--device cuda|cpu]

The co-located path of ``demos/id3gini.py`` on ``SimRuntime(3)`` (t = 1),
line for line (``SecureFraction`` ``:37``, ``GI`` ``:47``, ``id3``
``:61``): the parties build an ID3 tree from a one-hot encoded
transaction database. At each node the class sizes of the node's
transactions are one matrix product, their secure argmax and sum decide
whether the node is a leaf (a public zero test of the stop condition:
too few transactions, or one class only); otherwise every candidate
attribute's class contingency table is one matrix product, its Gini
fraction [D G, D] comes from a log-depth product (``np_prod``) and exact
field divisions D / y, and the best attribute is a secure argmax over
the fractions (``argmax`` with ``SecureFraction`` as key: products and
comparisons of secure numbers). Only the tree is opened.

Datasets (``demos/data/id3``), with the demo's bit lengths: 0 = tennis
(SecInt(32), two limbs), 1 = balance-scale (SecInt(77), four), 2 = car
(SecInt(95), four), 3 = SPECT (SecInt(42), three), 4 = KRKPA7 (SecInt(69),
four; 3,196 samples and 36 attributes), 5 = tic-tac-toe (SecInt(75),
four), 6 = house-votes-84 (SecInt(62), three).

``plain_id3`` builds the same tree in Python integers (the same Gini
fractions, the first occurrence on ties); the runner exits 1 unless the
secure tree equals it.
"""

from __future__ import annotations

import argparse
import csv
import logging
import sys
import time
from pathlib import Path

import numpy as np

from mpyc_tpu_torch.demos.np_sha3 import card_label, sync
from mpyc_tpu_torch.demos import parties

DATA = Path(__file__).resolve().parents[2] / 'demos' / 'data' / 'id3'

# name and the demo's bit length (demos/id3gini.py:124-126)
SETTINGS = [('tennis', 32), ('balance-scale', 77), ('car', 95),
            ('SPECT', 42), ('KRKPA7', 69), ('tic-tac-toe', 75),
            ('house-votes-84', 62)]


class SecureFraction:
    """Nonnegative fraction [numerator, denominator] ordered by cross
    products."""

    def __init__(self, a):
        self.a = a

    def __lt__(self, other):
        return self.a[0] * other.a[1] < self.a[1] * other.a[0]


def read_dataset(name: str):
    """(attribute names, transactions, class column C, each attribute's
    sorted values) of a dataset of ``demos/data/id3``."""
    with open(DATA / f'{name}.csv') as file:
        reader = csv.reader(file)
        attr_names = next(reader)
        transactions = list(reader)
    # the class attribute is the first or the last column
    C = 0 if attr_names[0].lower().startswith('class') else \
        len(attr_names) - 1
    ranges = [sorted({t[i] for t in transactions})
              for i in range(len(attr_names))]
    return attr_names, transactions, C, ranges


class ID3:
    """The demo's functions on a runtime, its one-hot encoding S and
    class column C."""

    def __init__(self, mpc, S, C, alpha, epsilon, on_node=None):
        self.mpc, self.S, self.C = mpc, S, C
        self.alpha, self.epsilon = alpha, epsilon
        self.on_node = on_node
        self.nodes = 0

    def GI(self, x):
        """Gini impurity of contingency table x as the fraction [D G, D]:
        D = prod_a y_a with y_a = alpha |T_a| + 1, D G = sum_a (sum_c
        x_ac^2) D / y_a, the quotients exact field divisions."""
        mpc = self.mpc
        y = mpc.np_sum(x, axis=1) * self.alpha + 1
        D = mpc.np_prod(y)
        sq = mpc.np_sum(x * x, axis=1)
        Dy = mpc.div(D, y)
        DG = mpc.np_sum(sq * Dy)
        return [DG, D]

    def id3(self, T, R):
        """The tree of the transactions T (a secure 0/1 vector) over the
        attributes R."""
        mpc, S, C = self.mpc, self.S, self.C
        if self.on_node is not None:
            self.on_node(self.nodes)
        self.nodes += 1
        sizes = S[C] @ T
        i, mx = mpc.np_argmax(sizes, arg_only=False)
        sizeT = mpc.np_sum(sizes)
        stop = (sizeT <= int(self.epsilon * int(T.shape[0]))) + \
            (mx == sizeT)
        if not (R and mpc.run(mpc.is_zero_public(stop))):
            i = int(mpc.run(mpc.output(i)))
            logging.info('Leaf node label %d', i)
            tree = i
        else:
            T_SC = mpc.np_transpose(T * S[C])
            fracs = [self.GI(S[A] @ T_SC) for A in sorted(R)]
            k, _ = mpc.argmax(fracs, key=SecureFraction)
            A = sorted(R)[int(mpc.run(mpc.output(k)))]
            logging.info('Attribute node %d', A)
            T_SA = T * S[A]
            subtrees = [self.id3(T_SA[j], R.difference([A]))
                        for j in range(int(T_SA.shape[0]))]
            tree = A, subtrees
        return tree


def depth(tree):
    return 0 if isinstance(tree, int) else max(map(depth, tree[1])) + 1


def size(tree):
    return 1 if isinstance(tree, int) else sum(map(size, tree[1])) + 1


def pretty(prefix, tree, names, ranges, C):
    """The tree as lines of text with attribute names and values."""
    if isinstance(tree, int):
        return ranges[C][tree]
    A, subtrees = tree
    s = ''
    for a, t in zip(ranges[A], subtrees):
        s += f'\n{prefix}{names[A]} == {a}: ' \
             f'{pretty("|   " + prefix, t, names, ranges, C)}'
    return s


def build(mpc, dataset, bit_length=0, alpha=8, epsilon=0.05, out=print,
          pretty_tree=True, on_node=None):
    """Learn dataset I's tree on runtime mpc as ``demos/id3gini.py``'s
    main does, printing its lines through ``out`` (and calling
    ``on_node`` with the node's number before each node's work, if
    given). Returns the tree, the node count and the seconds taken."""
    name, bit_length_ = SETTINGS[dataset]
    secint = mpc.SecInt(bit_length or bit_length_)
    out(f'Using secure integers: {secint.__name__}')
    attr_names, transactions, C, ranges = read_dataset(name)
    n, d = len(transactions), len(attr_names)
    S = [secint.array(np.array([[int(t[i] == j) for t in transactions]
                                for j in ranges[i]], dtype=object))
         for i in range(d)]
    T = secint.array(np.ones(n, dtype=object))
    out(f'dataset: {name} with {n} samples and {d-1} attributes')

    mpc.run(mpc.start())
    sync(mpc)
    t0 = time.perf_counter()
    learner = ID3(mpc, S, C, alpha, epsilon, on_node)
    tree = learner.id3(T, frozenset(range(d)).difference([C]))
    sync(mpc)
    seconds = time.perf_counter() - t0
    mpc.run(mpc.shutdown())

    out(f'Decision tree of depth {depth(tree)} and size {size(tree)}: '
        + (pretty('if ', tree, attr_names, ranges, C) if pretty_tree
           else str(tree)))
    return tree, learner.nodes, seconds


# -- the plain tree -----------------------------------------------------------

def _plain_argmax(values, less):
    """Index of the greatest value by the secure list argmax's tournament
    (``Runtime._argminmax``: the halves' winners, the second kept only
    where it is greater): the first occurrence of the greatest."""
    n = len(values)
    if n == 1:
        return 0
    i0 = _plain_argmax(values[:n // 2], less)
    i1 = n // 2 + _plain_argmax(values[n // 2:], less)
    return i1 if less(values[i0], values[i1]) else i0


def plain_id3(dataset, alpha=8, epsilon=0.05):
    """The tree of ``build`` in Python integers: class sizes, the stop
    condition, the Gini fractions [D G, D] (D / y_a exact) and the first
    occurrence of the greatest on ties, as the secure tree takes them."""
    name, _ = SETTINGS[dataset]
    _, transactions, C, ranges = read_dataset(name)
    n = len(transactions)
    codes = [[ranges[i].index(t[i]) for i in range(len(t))]
             for t in transactions]

    def node(rows, R):
        sizes = [0] * len(ranges[C])
        for r in rows:
            sizes[codes[r][C]] += 1
        i = sizes.index(max(sizes))        # np_argmax: the first greatest
        sizeT = sum(sizes)
        stop = (sizeT <= int(epsilon * n)) + (max(sizes) == sizeT)
        if not (R and stop == 0):
            return i
        fracs = []
        for A in sorted(R):
            x = [[0] * len(ranges[C]) for _ in ranges[A]]
            for r in rows:
                x[codes[r][A]][codes[r][C]] += 1
            y = [alpha * sum(row) + 1 for row in x]
            D = 1
            for v in y:
                D *= v
            DG = sum(sum(v * v for v in row) * (D // ya)
                     for row, ya in zip(x, y))
            fracs.append((DG, D))
        k = _plain_argmax(fracs, lambda u, v: u[0] * v[1] < u[1] * v[0])
        A = sorted(R)[k]
        return A, [node([r for r in rows if codes[r][A] == j],
                        R.difference([A]))
                   for j in range(len(ranges[A]))]

    return node(list(range(n)),
                frozenset(range(len(ranges))).difference([C]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('-i', '--dataset', type=int, metavar='I', default=0,
                        help=('dataset 0=tennis (default), 1=balance-scale, '
                              '2=car, 3=SPECT, 4=KRKPA7, 5=tic-tac-toe, '
                              '6=house-votes-84'))
    parser.add_argument('-l', '--bit-length', type=int, metavar='L',
                        default=0, help='override the preset bit length')
    parser.add_argument('-e', '--epsilon', type=float, metavar='E',
                        default=0.05,
                        help='minimum fraction E of samples for a split')
    parser.add_argument('-a', '--alpha', type=int, metavar='A', default=8,
                        help='scale factor A to prevent division by zero')
    parser.add_argument('--no-pretty-tree', action='store_true',
                        help='print the raw tree instead of the pretty one')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    tree, nodes, seconds = build(mpc, args.dataset, args.bit_length,
                                 args.alpha, args.epsilon,
                                 pretty_tree=not args.no_pretty_tree)
    want = plain_id3(args.dataset, args.alpha, args.epsilon)
    print(f'{nodes} nodes in {seconds:.3f} s ({seconds / nodes:.4f} s a '
          f'node) on {card_label(mpc.device)}; plain tree equal to the '
          f'secure tree: {tree == want}')
    return 0 if tree == want else 1


if __name__ == '__main__':
    sys.exit(main())
