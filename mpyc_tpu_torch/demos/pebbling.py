"""Binary pebbling for one-way hash chain reversal (shared demo module).

A copy of ``demos/pebbling.py`` (plain Python, no secure type), so that
the port's hash chain runner imports nothing of the JAX package's tree.

Reverses a hash chain x, f(x), ..., f^(n-1)(x) of length n = 2^k: after an
initial forward stage of n-1 rounds, the chain elements are produced one
per round in REVERSE order, while storing only O(k) chain values.

Two pebblers are provided, both this implementation's own segment-based
design (a chain segment of length 2^j snapshots its power-of-two
"distance stops" on the way forward and then delegates each half-,
quarter-, ... segment to a child reverser; one child produces an output
every round, the others run their forward stages):

  * reverse_chain       — forward work of every segment is spread by the
    explicit optimal schedule of [Schoenmakers, "Explicit Optimal Binary
    Pebbling for One-Way Hash Chain Reversal", Financial Cryptography
    2016] (closed-form round budgets; <= ceil(k/2) hashes in any output
    round).  Functional twin of MPyC's pebblers (its
    demos/onewayhashchains.py), different machinery.
  * reverse_chain_eager — plain speed-1 variant (every active segment
    hashes once per round); same total hash count k*2^(k-1) and the same
    output sequence, with a simpler schedule but a higher per-round peak.

Both yield None for each initial-stage round, then the chain elements
f^(n-1)(x) ... f^0(x), and finally report hash statistics via .stats.
"""


def _round_budget(j, r):
    """Hashes a 2^j-segment spends in forward-stage round r (1-based).

    Closed-form optimal schedule (Schoenmakers FC 2016, Theorem 2): zero
    during the first half, then a staggered catch-up summing to 2^j - 1.
    """
    if j == 0 or r < 1 << (j - 1):
        return 0
    rem = (1 << j) - r
    return ((j + r) % 2 + j + 1
            - ((2 * r) % (1 << rem.bit_length())).bit_length()) // 2


class _Counter:
    """Mutable hash counter shared across all segments of one reversal."""

    def __init__(self):
        self.total = 0
        self.round_peak = 0
        self._this_round = 0

    def tick(self):
        self.round_peak = max(self.round_peak, self._this_round)
        self._this_round = 0

    def hash_done(self):
        self.total += 1
        self._this_round += 1


def _segment(j, seed, f, counter, budget):
    """Reverse the length-2^j chain seeded by `seed`.

    Yields None for each of its 2^j - 1 forward rounds, then its 2^j
    elements in reverse, one per subsequent round.
    """
    n = 1 << j
    if j == 0:
        yield seed
        return

    stops = {}                    # stops[i] = value at distance 2^i from end
    v = seed
    pos = 0
    for r in range(1, n):
        for _ in range(budget(j, r)):
            if pos == n - 1:
                break
            ahead = n - pos
            if ahead & (ahead - 1) == 0:
                stops[ahead.bit_length() - 1] = v
            v = f(v)
            counter.hash_done()
            pos += 1
        yield None
    assert pos == n - 1, 'schedule did not complete the forward walk'
    yield v                       # the chain end f^(n-1)(seed)

    # the lower half-, quarter-, ... segments cover distances
    # (2^(i-1), 2^i]; child i is seeded by the stop at distance 2^i
    kids = [_segment(i - 1, stops[i], f, counter, budget)
            for i in range(1, j + 1)]
    while kids:
        value = None
        live = []
        for child in kids:
            try:
                out = next(child)
            except StopIteration:
                continue
            live.append(child)
            if out is not None:
                value = out
        if not live:
            break
        kids = live
        yield value


class _Reversal:
    """Iterator over reversal rounds with hash statistics attached."""

    def __init__(self, k, seed, f, budget):
        self.stats = _Counter()
        self._gen = _segment(k, seed, f, self.stats, budget)

    def __iter__(self):
        return self

    def __next__(self):
        out = next(self._gen)
        self.stats.tick()
        return out


def reverse_chain(k, seed, f):
    """Optimally scheduled reversal (<= ceil(k/2) hashes per output round)."""
    return _Reversal(k, seed, f, _round_budget)


def reverse_chain_eager(k, seed, f):
    """Speed-1 reversal: every active segment hashes once per round."""
    return _Reversal(k, seed, f, lambda j, r: 1)
