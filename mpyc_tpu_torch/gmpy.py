"""Host number theory: the helpers that ``finfields`` and ``gfpx`` use.

A copy of the part of ``mpyc_tpu/gmpy.py`` (pure Python, no GMP) that
``finfields.find_prime_root``, ``gfpx`` (``is_prime``, ``invert``) and
``sectypes.SecFld`` (``factor_prime_power``) need, so the port imports
nothing of the JAX package.
"""

import random

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113]

# Deterministic Miller-Rabin bases for n < 3.317e24
_MR_BASES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]
_MR_LIMIT = 3317044064679887385961981

_rng = random.Random(0xF1E1D)


def powmod(x, y, m):
    """x**y mod m (y may be negative if x invertible mod m)."""
    return pow(x, y, m)


def invert(x, m):
    """Multiplicative inverse of x modulo m; raises ZeroDivisionError if none."""
    try:
        return pow(x, -1, m)
    except ValueError:
        raise ZeroDivisionError('invert() no inverse exists') from None


def _miller_rabin(n, a):
    d = n - 1
    r = (d & -d).bit_length() - 1
    d >>= r
    x = pow(a, d, n)
    if x == 1 or x == n - 1:
        return True
    for _ in range(r - 1):
        x = x * x % n
        if x == n - 1:
            return True
    return False


def is_prime(n, _extra_rounds=16):
    """Primality test: deterministic MR below 3.3e24, MR+strong rounds above."""
    n = int(n)
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    if n < _MR_LIMIT:
        bases = _MR_BASES
    else:
        bases = _MR_BASES + [_rng.randrange(2, n - 1)
                             for _ in range(_extra_rounds)]
    return all(_miller_rabin(n, a) for a in bases if a % n != 0)


def next_prime(n):
    """Smallest prime > n."""
    n = int(n) + 1
    if n <= 2:
        return 2
    n |= 1
    while not is_prime(n):
        n += 2
    return n


def prev_prime(n):
    """Largest prime < n."""
    n = int(n) - 1
    if n < 2:
        raise ValueError('no prime below 2')
    if n == 2:
        return 2
    if n % 2 == 0:
        n -= 1
    while not is_prime(n):
        n -= 2
    return n


def iroot(x, n):
    """Integer n-th root of x: (root, exact?)."""
    if x < 0:
        raise ValueError('x must be >= 0')
    if x == 0:
        return 0, True
    if n == 1:
        return x, True
    r = 1 << -(-x.bit_length() // n)     # Newton on integers, from above
    while True:
        t = ((n - 1) * r + x // r ** (n - 1)) // n
        if t >= r:
            break
        r = t
    return r, r ** n == x


def factor_prime_power(x):
    """Return (p, d) with x == p**d for prime p, else raise ValueError."""
    if x <= 1:
        raise ValueError('number not a prime power')
    for d in range(x.bit_length(), 0, -1):
        r, exact = iroot(x, d)
        if exact and is_prime(r):
            return int(r), d
    raise ValueError('number not a prime power')
