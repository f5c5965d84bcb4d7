"""The party count and threshold of every runner: ``-M m`` and ``-T t``.

The JAX package's runners take them from its runtime's options
(``mpyc_tpu/runtime.py:4552-4559``: ``-M`` m local parties, ``-T`` the
threshold, default (m - 1) // 2); the port's runners all run the
co-located plane, so both only set up its ``SimRuntime``. The default is
m = 3. The card takes 1 <= t <= 4 and 2t + 1 <= m <= 16 (and products at
t = 0); on the CPU the plain versions take any (t, m) with 2t + 1 <= m.
"""

from __future__ import annotations

import argparse

from mpyc_tpu_torch.parallel.simulator import SimRuntime


def parse_args(parser: argparse.ArgumentParser, argv=None):
    """parser's arguments with ``-M`` and ``-T`` added."""
    group = parser.add_argument_group('parties')
    group.add_argument('-M', type=int, dest='M', default=3, metavar='m',
                       help='use m co-located parties (default 3)')
    group.add_argument('-T', '--threshold', type=int, metavar='t',
                       help='threshold t, 0 <= t < m/2 (default (m - 1) // '
                            '2)')
    return parser.parse_args(argv)


def runtime(args) -> SimRuntime:
    """The co-located runtime of args' m parties at threshold t on args'
    device."""
    return SimRuntime(args.M, device=args.device, threshold=args.threshold)
