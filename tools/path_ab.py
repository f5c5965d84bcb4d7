#!/usr/bin/env python3
"""Time the prime-field paths of several checkouts of the port in one run
on one card, interleaved, to compare them.

    python3 tools/path_ab.py LABEL=DIR [LABEL=DIR ...] [--rounds 2]

Each DIR is the root of a checkout (an unpacked ``git archive``); its own
``chip_smoke.py`` and ``mpyc_tpu_torch`` are imported in a process of its
own, which builds its kernels on first use. A round runs every checkout
once, the order reversed every other round (a, b, b, a for two). Each
run prints, on the host clock after a synchronize:

* the BNN and the integer CNN at B = 100 (``chip_smoke.run_bnn`` and
  ``run_cnn``: one cold pass and three warm, every prediction checked
  against the plaintext model): the median warm pass;
* the LP solver on LPExample (dataset 7, SecInt(110) on five limbs)
  over its pivots 5 to 24: seconds a pivot (the solve stops there).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

LP_DATASET, LP_PIVOTS = 7, (5, 25)


def one(root: str, label: str) -> None:
    """Time the paths with the checkout at root."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as c
    from mpyc_tpu_torch.demos import np_lpsolver as lp
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    bnn = statistics.median(c.run_bnn('cuda')['pass_s'][1:])
    cnn = statistics.median(c.run_cnn('cuda')['pass_s'][1:])
    k0, k1 = LP_PIVOTS
    t = {}

    class Window(Exception):
        pass

    def on_pivot(k):
        if k in (k0, k1):
            torch.cuda.synchronize()
            t[k] = time.perf_counter()
        if k == k1:
            raise Window

    try:
        lp.solve(SimRuntime(3, device='cuda'), LP_DATASET,
                 out=lambda s: None, on_pivot=on_pivot)
    except Window:
        pass
    pivot = (t[k1] - t[k0]) / (k1 - k0)
    print(f'{label}: BNN {bnn:.4f} s, CNN {cnn:.4f} s a warm pass; '
          f'LPExample {pivot:.4f} s a pivot (pivots {k0}-{k1 - 1})',
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('trees', nargs='*', metavar='LABEL=DIR')
    parser.add_argument('--rounds', type=int, default=2)
    parser.add_argument('--one', nargs=2, metavar=('DIR', 'LABEL'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        one(*args.one)
        return 0
    if not args.trees:
        parser.error('name at least one LABEL=DIR')
    trees = [t.split('=', 1) for t in args.trees]
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for k in range(args.rounds):
        for label, root in (trees if k % 2 == 0 else trees[::-1]):
            rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                                  '--one', root, label]).returncode
    return rc


if __name__ == '__main__':
    sys.exit(main())
