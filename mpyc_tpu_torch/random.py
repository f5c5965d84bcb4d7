"""Secure versions of the random module's functions
(``mpyc_tpu/random.py``): uniform secret integers, fixed-point numbers,
choices, unit vectors, permutations, derangements, samples and shuffles.

Random integers below n are drawn as k = bit length of n - 1 secret
random bits; where n is no power of two the draw is rejected when it
exceeds n - 1, tested for all of n - 1's zero bits at once from log-depth
partial products, in one opening an attempt (``_randbelow``, the JAX
package's batched test). A random unit vector of length n is built from
k = ceil(log2 n) secret random bits by tensor doubling: the indicator [1]
splits into (1 - x_i) u and x_i u for each bit x_i, one batch of
products a bit. Where n is not a power of two, the sum of the entries
past n (whether the slot overflowed) is opened, and the draw restarts
when it is 1: one opened bit a draw, as in the JAX package
(``mpyc_tpu/random.py:66``, ``:94``). A shuffle is a downward oblivious
Fisher-Yates over such unit vectors (``shuffle``), a derangement a
permutation drawn again while one public zero test of the product of
its differences from the identity says it has a fixed point. Rejection
loops reveal accept or reject and nothing else.

The functions take a secure type bound to a runtime (``Runtime.SecInt``,
``Runtime.SecFxp``, ``Runtime.SecFld``) and call that runtime.
"""

from __future__ import annotations

from mpyc_tpu_torch import sectypes


def random_unit_vector(sectype, n: int) -> list:
    """A uniformly random secret rotation of [1] + [0] * (n - 1), as a
    list of n secure numbers of sectype (``mpyc_tpu/random.py:66``)."""
    runtime = sectype.runtime
    if n == 1:
        return [sectype(1)]
    # the constant 1 as a sharing, so that its products by the bits are
    # secure products (reshared), as the JAX package computes them
    one = runtime._wrap(sectype.array, runtime._share(sectype(1)), True,
                        False)
    k = (n - 1).bit_length()
    while True:
        x = runtime.random_bits(sectype, k)
        u = [one]
        for x_i in x:
            hi = runtime.scalar_mul(x_i, u)
            u = runtime.vector_sub(u, hi) + hi
        if n == 1 << k:
            return u
        if not runtime.output(runtime.sum(u[n:])):
            return u[:n]


def np_random_unit_vector(sectype, n: int):
    """random_unit_vector as a secure array (``mpyc_tpu/random.py:94``)."""
    return sectype.runtime.np_fromlist(random_unit_vector(sectype, n))


def shuffle(sectype, x) -> None:
    """Secretly shuffle the list x in place (``mpyc_tpu/random.py:153``):
    for i = n - 1 down to 1 a random unit vector of length i + 1 selects
    a slot j <= i, slot i receives x[j] and x[j] the old x[i], both by
    adding sel (x[i] - x[j]) to the prefix. Elements may be numbers or
    lists of numbers of one length (rows move as wholes); public values
    enter as secure numbers of sectype."""
    runtime = sectype.runtime
    n = len(x)
    rows = isinstance(x[0], list)

    def coerce(v):
        return v if isinstance(v, sectype) else sectype(v)

    for i in range(n):
        x[i] = [coerce(v) for v in x[i]] if rows else coerce(x[i])
    for i in range(n - 1, 0, -1):
        sel = random_unit_vector(sectype, i + 1)
        if rows:
            chosen = runtime.matrix_prod([sel], x[:i + 1])[0]
            delta = runtime.matrix_prod(
                [[s] for s in sel], [runtime.vector_sub(x[i], chosen)])
            x[:i + 1] = runtime.matrix_add(x[:i + 1], delta)
        else:
            chosen = runtime.in_prod(x[:i + 1], sel)
            delta = runtime.scalar_mul(x[i] - chosen, sel)
            x[:i + 1] = runtime.vector_add(x[:i + 1], delta)
        x[i] = chosen


def getrandbits(sectype, k: int, bits=False):
    """A uniformly random secret k-bit integer, or its k secret bits
    (``mpyc_tpu/random.py:15``)."""
    runtime = sectype.runtime
    draws = runtime.random_bits(sectype, k)
    return draws if bits else runtime.from_bits(draws)


def _randbelow(sectype, n: int, bits=False):
    """A uniformly random secret integer in range(n), or its bits
    (``mpyc_tpu/random.py:21``). n a power of two: getrandbits. Else k
    random bits x are drawn and the draw rejected where x > n - 1: for
    each zero bit z of b = n - 1 (above its trailing ones) the indicator
    that x matches b on every higher one bit and has a 1 at z, from the
    partial products of the one bits from the top; all are opened in one
    round, and the draw is kept where none is 1. A secure field of order
    n is one random field element."""
    runtime = sectype.runtime
    if issubclass(sectype, sectypes.SecureFiniteField) and \
            n == sectype.field.order:
        if bits:
            raise ValueError('bits not available')
        return runtime._random(sectype)
    b = n - 1
    k = b.bit_length()
    if not n & b:
        return getrandbits(sectype, k, bits=bits)
    t = (n & -n).bit_length() - 1      # the low t bits of b are ones
    ones = [i for i in range(k) if i >= t and (b >> i) & 1]
    zeros = [i for i in range(k) if i >= t and not (b >> i) & 1]
    while True:
        x = runtime.random_bits(sectype, k)
        pp = {}
        acc = None
        for i in sorted(ones, reverse=True):
            acc = x[i] if acc is None else acc * x[i]
            pp[i] = acc
        tests = []
        for z in zeros:
            higher = [i for i in ones if i > z]
            h = pp[min(higher)] if higher else None
            tests.append(h * x[z] if h is not None else x[z])
        flags = runtime.output(tests)
        if not any(int(f) for f in flags):
            break
    return x if bits else runtime.from_bits(x)


def randrange(sectype, start: int, stop: int = None, step: int = 1):
    """A uniformly random secret integer in range(start, stop, step)
    (``mpyc_tpu/random.py:116``)."""
    if stop is None:
        start, stop = 0, start
    span = range(start, stop, step)
    if not span:
        raise ValueError('empty range for randrange()')
    return _randbelow(sectype, len(span)) * step + start


def randint(sectype, a: int, b: int):
    """A uniformly random secret integer in [a, b]
    (``mpyc_tpu/random.py:126``)."""
    return randrange(sectype, a, b + 1)


def choice(sectype, seq):
    """A uniformly random secret element of seq: its inner product with a
    random unit vector (``mpyc_tpu/random.py:131``)."""
    if not seq:
        raise IndexError('cannot choose from an empty sequence')
    sel = random_unit_vector(sectype, len(seq))
    return sum((s * v for s, v in zip(sel, seq)), start=0)


def choices(sectype, population, weights=None, *, cum_weights=None,
            k: int = 1) -> list:
    """k random secret elements of population with replacement, uniform
    or by (cumulative) weights (``mpyc_tpu/random.py:139``): a weighted
    draw is r < the total weight and the element whose cumulative weight
    first exceeds r, by secure comparisons."""
    runtime = sectype.runtime
    if cum_weights is None:
        if weights is None:
            return [choice(sectype, population) for _ in range(k)]
        cum_weights = list(weights)
        for i in range(1, len(cum_weights)):
            cum_weights[i] += cum_weights[i - 1]
    elif weights is not None:
        raise TypeError('cannot specify both weights and cumulative weights')
    if len(cum_weights) != len(population):
        raise ValueError('number of weights does not match the population')
    n = cum_weights[-1]
    out = []
    for _ in range(k):
        r = _randbelow(sectype, n)
        prev = 0
        sel = None
        for i, cw in enumerate(cum_weights):
            hit = runtime.sgn(r - cw, LT=True) - (
                runtime.sgn(r - prev, LT=True) if prev else 0)
            term = hit * population[i]
            sel = term if sel is None else sel + term
            prev = cw
        out.append(sel)
    return out


def random_permutation(sectype, x) -> list:
    """A uniformly random secret permutation of the list x, or of
    range(x) for an int (``mpyc_tpu/random.py:190``)."""
    if isinstance(x, int):
        x = list(range(x))
    x = list(x)
    shuffle(sectype, x)
    return x


def random_derangement(sectype, x) -> list:
    """A uniformly random secret derangement of the list x, or of
    range(x) for an int (``mpyc_tpu/random.py:199``): permutations drawn
    until the product of their differences from x is not 0, by one
    public zero test a draw (about e draws)."""
    runtime = sectype.runtime
    if isinstance(x, int):
        x = list(range(x))
    x = list(x)
    while True:
        y = random_permutation(sectype, x)
        t = runtime.prod([y[i] - x[i] for i in range(len(x))])
        if not runtime.is_zero_public(t):
            return y


def sample(sectype, population, k: int) -> list:
    """k random secret elements of population without replacement
    (``mpyc_tpu/random.py:213``): of a range, distinct randrange draws (a
    draw equal to an earlier one, by a public zero test of the product of
    the differences, is drawn again); of a list, the first k steps of a
    Fisher-Yates over random unit vectors."""
    runtime = sectype.runtime
    n = len(population)
    if not 0 <= k <= n:
        raise ValueError('sample larger than population or negative')
    if isinstance(population, range):
        x = []
        while len(x) < k:
            r = randrange(sectype, population.start, population.stop,
                          population.step)
            if x and runtime.is_zero_public(runtime.prod([r - a for a in
                                                          x])):
                continue
            x.append(r)
        return x

    def coerce(v):
        return v if isinstance(v, sectype) else sectype(v)
    x = list(population)
    for i in range(min(k, n - 1)):
        u = random_unit_vector(sectype, n - i)
        x_u = runtime.in_prod([coerce(xi) for xi in x[i:]], u)
        d = runtime.scalar_mul(coerce(x[i]) - x_u, u)
        x[i] = x_u
        x[i:] = runtime.vector_add([coerce(xi) for xi in x[i:]], d)
    return x[:k]


def _frac_bits(sectype) -> int:
    f = sectype.frac_length
    if not f:
        raise TypeError('secure fixed-point type required')
    return f


def random(sectype):
    """A uniformly random secret fixed-point number in [0, 1): f random
    bits over 2^f (``mpyc_tpu/random.py:244``)."""
    f = _frac_bits(sectype)
    return getrandbits(sectype, f) * (2 ** -f)


def uniform(sectype, a, b):
    """A uniformly random secret fixed-point number between a and b, both
    included, on the grid of 2^-f (``mpyc_tpu/random.py:250``)."""
    f = _frac_bits(sectype)
    lo, hi = sorted((a, b))
    steps = round((hi - lo) * (1 << f))
    return _randbelow(sectype, steps + 1) * (2 ** -f) + lo
