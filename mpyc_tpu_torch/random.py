"""Secure random unit vectors (the part of ``mpyc_tpu/random.py`` that
``np_unit_vector`` uses).

A random unit vector of length n is built from k = ceil(log2 n) secret
random bits by tensor doubling: the indicator [1] splits into (1 - x_i)
u and x_i u for each bit x_i, one batch of products a bit. Where n is not
a power of two, the sum of the entries past n (whether the slot overflowed)
is opened, and the draw restarts when it is 1: one opened bit a draw, as
in the JAX package (``mpyc_tpu/random.py:66``, ``:94``).

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
