"""Demo: a secret index to a secret unit vector, on the port.

    python -m mpyc_tpu_torch.demos.indextounitvector [n] [--device cuda|cpu]

The co-located path of ``demos/indextounitvector.py`` on ``SimRuntime(3)``
(t = 1): for every index i < n (default 10) the i-th unit vector of
length n from the secret i, by two constructions:

* ``Runtime.unit_vector``: a broadcast of i minus 0..n-1 and one batched
  zero test, over the secure prime field ``SecFld(min_order=max(m + 1,
  n))`` (GF(11) for n = 10: Fermat's test, products of one-limb shares,
  K3 on the card), SecInt(32) and SecFxp(32, 16) (the comparison in EQ
  mode);
* ``bit_kron`` below, over SecInt(32) and SecFxp(32, 16) (it needs
  integer ``divmod``): the low bit of i peeled ceil(log2 n) times
  (``divmod(a, 2)``: the secure least significant bit, or for fixed
  point a reduction mod 2^(f + 1)), then a one-hot vector doubled back
  up, each level interleaving its (1 - b) and b halves.

Each vector is opened and checked against the i-th unit vector; the
runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

from mpyc_tpu_torch.demos import parties


def bit_kron(mpc, a, n: int) -> list:
    """The a-th unit vector of length n (0 <= a < n) by a's binary
    expansion (``demos/indextounitvector.py:22``): u(a) is the Kronecker
    product of (1 - b_j, b_j) over a's bits, cut to n entries."""
    stype = type(a)
    levels = max((n - 1).bit_length(), 1)
    low_bits = []
    for _ in range(levels):
        a, bit = divmod(a, 2)
        low_bits.append(bit)
    one_hot = [stype(1)]
    for bit in reversed(low_bits):
        odd = mpc.scalar_mul(bit, one_hot)
        even = mpc.vector_sub(one_hot, odd)
        one_hot = [v for pair in zip(even, odd) for v in pair]
    return one_hot[:n]


def check_all(mpc, n: int, name: str, builder, sectype, out=print,
              indices=None) -> bool:
    """builder(sectype(i), n) opened for every index i (or the given
    ones), each against the i-th unit vector."""
    out(f'Using {name} with type {sectype.__name__}:')
    ok = True
    for i in range(n) if indices is None else indices:
        vec = [int(v) for v in mpc.output(builder(sectype(i), n))]
        good = vec == [int(j == i) for j in range(n)]
        ok = ok and good
        out(f'{i} {vec if n <= 16 else "(n = %d)" % n}'
            f'{"" if good else " FAILED"}')
    return ok


def run(mpc, n: int = 10, out=print) -> bool:
    """The demo's checks: unit_vector over the secure prime field, and
    unit_vector and bit_kron over SecInt(32) and SecFxp(32, 16)."""
    secfld = mpc.SecFld(min_order=max(len(mpc.parties) + 1, n))
    ok = check_all(mpc, n, 'unit_vector', mpc.unit_vector, secfld, out)
    for sectype in (mpc.SecInt(), mpc.SecFxp()):
        ok = check_all(mpc, n, 'unit_vector', mpc.unit_vector, sectype,
                       out) and ok
        ok = check_all(mpc, n, 'bit_kron',
                       lambda a, k: bit_kron(mpc, a, k), sectype, out) and ok
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('n', type=int, nargs='?', default=None,
                        help='length of the unit vectors (default 10)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    n = args.n
    if n is None:
        n = 10
        print('Setting input to default =', n)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = run(mpc, n)
    mpc.run(mpc.shutdown())
    print(f'every vector the unit vector of its index: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
