"""Secure random unit vectors and shuffles (the part of
``mpyc_tpu/random.py`` that ``np_unit_vector`` and the sorting demo use).

A random unit vector of length n is built from k = ceil(log2 n) secret
random bits by tensor doubling: the indicator [1] splits into (1 - x_i)
u and x_i u for each bit x_i, one batch of products a bit. Where n is not
a power of two, the sum of the entries past n (whether the slot overflowed)
is opened, and the draw restarts when it is 1: one opened bit a draw, as
in the JAX package (``mpyc_tpu/random.py:66``, ``:94``). A shuffle is an
oblivious Fisher-Yates over such unit vectors (``shuffle``).

The functions take a secure number type bound to a runtime
(``Runtime.SecInt``, ``Runtime.SecFxp``) and call that runtime.
"""

from __future__ import annotations


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
