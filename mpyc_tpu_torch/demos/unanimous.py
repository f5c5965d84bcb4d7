"""Demo: unanimous voting, matching without embarrassments, on the port.

    python -m mpyc_tpu_torch.demos.unanimous [vote ...] [--device cuda|cpu]

The co-located path of ``demos/unanimous.py`` on ``SimRuntime(3)`` (t = 1,
m = 2t + 1): the first t + 1 = 2 parties vote yes (1) or no (0), one
positional argument a voter (default 1), each vote a secret input of
party j over ``SecFld(2)`` (its shares in GF(4): GF(2) has no third
point), and only the AND of the votes (``Runtime.all``: their product,
K8's reshare on the card) is opened. The verdict is checked against
Python's ``all``; the runner exits 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys

from mpyc_tpu_torch.demos import parties


def run(mpc, votes=None, out=print) -> bool:
    """The voters' ballots input, their AND opened; whether it equals
    the plain AND. votes: one 0/1 a voter (default all 1)."""
    m = len(mpc.parties)
    n_voters = m // 2 + 1
    votes = list(votes or []) + [1] * (n_voters - len(votes or []))
    secbit = mpc.SecFld(2)
    ballots = [mpc.input(secbit(int(votes[j])), senders=j)
               for j in range(n_voters)]
    verdict = int(mpc.output(mpc.all(ballots)))
    if verdict:
        out(f'MATCH - all {n_voters} voter(s) said yes!')
    else:
        out(f'NO match - at least one of the {n_voters} voter(s) said no.')
    return verdict == int(all(votes[:n_voters]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('votes', type=int, nargs='*',
                        help='a 0/1 vote for each voter (default 1)')
    parser.add_argument('--device', default='cuda',
                        help='device of the shares (default: the card)')
    args = parties.parse_args(parser, argv)
    mpc = parties.runtime(args)
    mpc.run(mpc.start())
    ok = run(mpc, args.votes)
    mpc.run(mpc.shutdown())
    print(f'verdict equal to the plain AND: {ok}')
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
