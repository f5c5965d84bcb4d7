"""Host-side polynomial arithmetic over GF(p).

A copy of ``mpyc_tpu/gfpx.py`` (pure Python), so that the port's binary
fields (``finfields.GF`` of an irreducible polynomial, ``find_irreducible``)
import nothing of the JAX package. MPyC's conventions:

  * polynomials over odd-prime GF(p): little-endian coefficient lists with a
    nonzero leading coefficient ([] is the zero polynomial);
  * binary polynomials (p == 2): plain ints used as bitmasks;
  * int encoding of a polynomial = base-p positional value
    a_0 + a_1*p + ... + a_n*p^n;
  * ordering: by encoded integer (zero polynomial smallest);
  * `<<`/`>>` multiply/floor-divide by powers of X.

These objects are used at configuration time only (irreducible moduli,
field setup); batched device arithmetic over GF(2^d) lives in
``mpyc_tpu_torch/ops/binary.py``.
"""

import functools

from mpyc_tpu_torch import gmpy as gmpy2

X = 'x'  # symbol for the indeterminate


@functools.cache
def GFpX(p):
    """Create the polynomial ring type GF(p)[x] for prime p (cached so the
    class is unique per p — required for isinstance checks and pickling)."""
    if not gmpy2.is_prime(p):
        raise ValueError('number is not prime')

    if p == 2:
        cls = BinaryPolynomial
        cls.__name__ = f'GF({p})[{X}]'
    else:
        cls = type(f'GF({p})[{X}]', (Polynomial,), {'__slots__': ()})
        cls.p = p
    return cls


class Polynomial:
    """Polynomial over GF(p) as little-endian coefficient list (p odd)."""

    __slots__ = ('value',)

    p = None

    def __init__(self, value=0, check=True):
        if check:
            value = self._intern(value)
        self.value = value

    # -- conversions ------------------------------------------------------

    @classmethod
    def _intern(cls, a):
        a = cls._coerce(a)
        if a is NotImplemented:
            raise TypeError(f'polynomial over GF({cls.p}) expected')
        return a

    @classmethod
    def _coerce(cls, a):
        if isinstance(a, Polynomial):
            if not isinstance(a, cls):
                raise TypeError(f'polynomial of type {cls.__name__} expected')
            return a.value
        if isinstance(a, int):
            return cls._from_int(a)
        if isinstance(a, str):
            return cls._from_terms(a)
        if isinstance(a, tuple):
            a = list(a)
        if isinstance(a, list):
            p = cls.p
            if not all(isinstance(c, int) and 0 <= c < p for c in a):
                raise ValueError('polynomial coefficients invalid or out of range')
            return cls._norm(list(a))
        return NotImplemented

    @staticmethod
    def _norm(cs):
        while cs and cs[-1] == 0:
            cs.pop()
        return cs

    @classmethod
    def _from_int(cls, a):
        p = cls.p
        neg = a < 0
        if neg:
            a = -a
        cs = []
        while a:
            a, r = divmod(a, p)
            cs.append(p - r if neg and r else r)
        return cs

    @staticmethod
    def _to_list(a):
        # coefficient list view (MPyC's gfpx.py:171-174; no copy)
        return a.value

    @classmethod
    def _to_int(cls, cs):
        p = cls.p
        v = 0
        for c in reversed(cs):
            v = v * p + c
        return v

    @classmethod
    def _from_terms(cls, s):
        p = cls.p
        d = {}
        for term in s.replace(' ', '').replace('-', '+-').split('+'):
            if not term:
                continue
            if X in term:
                c, _, e = term.partition(X)
                c = int(c[:-1]) if c.endswith('*') else (int(c) if c not in ('', '-') else (-1 if c == '-' else 1))
                e = int(e[1:]) if e.startswith('^') else (1 if not e else int(e))
            else:
                c, e = int(term), 0
            d[e] = (d.get(e, 0) + c) % p
        if not d:
            return []
        cs = [0] * (max(d) + 1)
        for e, c in d.items():
            cs[e] = c
        return cls._norm(cs)

    @classmethod
    def _to_terms(cls, cs):
        if not cs:
            return '0'
        terms = []
        for e in range(len(cs) - 1, -1, -1):
            c = cs[e]
            if c == 0:
                continue
            if e == 0:
                terms.append(f'{c}')
            elif e == 1:
                terms.append(f'{X}' if c == 1 else f'{c}*{X}')
            else:
                terms.append(f'{X}^{e}' if c == 1 else f'{c}*{X}^{e}')
        return '+'.join(terms)

    def __int__(self):
        return self._to_int(self.value)

    def __iter__(self):
        yield from self.value

    def __getitem__(self, key):
        if not isinstance(key, int):
            raise IndexError('use int for indexing polynomials')
        if key == -1 and not self.value:
            return 0
        if key < 0:
            raise IndexError('negative index not allowed for nonzero polynomials')
        try:
            return self.value[key]
        except IndexError:
            return 0

    def __call__(self, x):
        p = type(self).p
        x %= p
        y = 0
        for c in reversed(self.value):
            y = (y * x + c) % p
        return y

    def to_bytes(self, length, byteorder):
        return int(self).to_bytes(length, byteorder)

    @classmethod
    def from_terms(cls, s):
        return cls(cls._from_terms(s), check=False)

    def to_terms(self):
        return self._to_terms(self.value)

    def degree(self):
        """Degree (-1 for the zero polynomial)."""
        return len(self.value) - 1

    # -- ring arithmetic --------------------------------------------------

    @classmethod
    def _add(cls, a, b):
        p = cls.p
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, c in enumerate(b):
            out[i] = (out[i] + c) % p
        return cls._norm(out)

    @classmethod
    def _neg(cls, a):
        p = cls.p
        return [(-c) % p for c in a]

    @classmethod
    def _sub(cls, a, b):
        return cls._add(a, cls._neg(b))

    @classmethod
    def _mul(cls, a, b):
        p = cls.p
        if not a or not b:
            return []
        out = [0] * (len(a) + len(b) - 1)
        if len(a) > len(b):
            a, b = b, a
        for i, c in enumerate(a):
            if c:
                for j, d in enumerate(b):
                    out[i + j] += c * d
        return cls._norm([v % p for v in out])

    @classmethod
    def _lshift(cls, a, n):
        return [0] * n + a if a else []

    @classmethod
    def _rshift(cls, a, n):
        return a[n:]

    @classmethod
    def _mod(cls, a, b):
        if b is None:  # for binary-compatible call signature
            return a
        return cls._divmod(a, b)[1]

    @classmethod
    def _divmod(cls, a, b):
        p = cls.p
        if not b:
            raise ZeroDivisionError('division by zero polynomial')
        r = list(a)
        db, dq = len(b) - 1, len(a) - len(b)
        if dq < 0:
            return [], r
        inv_lead = gmpy2.invert(b[-1], p)
        q = [0] * (dq + 1)
        for k in range(dq, -1, -1):
            c = (r[db + k] * inv_lead) % p
            q[k] = c
            if c:
                for j in range(db + 1):
                    r[k + j] = (r[k + j] - c * b[j]) % p
        return cls._norm(q), cls._norm(r[:db])

    @classmethod
    def _one(cls):
        return [1]

    @classmethod
    def _powmod(cls, a, n, modulus=None):
        if n == 0:
            return cls._one()
        if n < 0:
            if modulus is None:
                raise ValueError('negative exponent')
            a = cls._invert(a, modulus)
            n = -n
        b = a  # NB: n=1 returns a unreduced, as MPyC does
        for i in range(n.bit_length() - 2, -1, -1):
            b = cls._mod(cls._mul(b, b), modulus)
            if (n >> i) & 1:
                b = cls._mod(cls._mul(b, a), modulus)
        return b

    @classmethod
    def _gcd(cls, a, b):
        while b:
            a, b = b, cls._mod(a, b)
        return cls._monic(a)

    @classmethod
    def _monic(cls, a, lc_pinv=False):
        if not a or a[-1] == 1:
            return (a, 1 if a else 0) if lc_pinv else a
        inv = int(gmpy2.invert(a[-1], cls.p))
        b = [(c * inv) % cls.p for c in a]
        return (b, inv) if lc_pinv else b

    @classmethod
    def _gcdext(cls, a, b):
        s0, s1 = [1], []
        t0, t1 = [], [1]
        while b:
            q, r = cls._divmod(a, b)
            a, b = b, r
            s0, s1 = s1, cls._sub(s0, cls._mul(q, s1))
            t0, t1 = t1, cls._sub(t0, cls._mul(q, t1))
        if a and a[-1] != 1:  # normalize gcd to monic
            inv = gmpy2.invert(a[-1], cls.p)
            sc = [inv]
            a, s0, t0 = cls._mul(a, sc), cls._mul(s0, sc), cls._mul(t0, sc)
        return a, s0, t0

    @classmethod
    def _invert(cls, a, modulus):
        g, s, _ = cls._gcdext(a, modulus)
        if len(g) != 1:
            raise ZeroDivisionError('inverse does not exist')
        return s if g == [1] else cls._mul(s, [gmpy2.invert(g[0], cls.p)])

    # -- irreducibility ---------------------------------------------------

    @classmethod
    def _deg(cls, a):
        return len(a) - 1

    @classmethod
    def _x(cls):
        return [0, 1]

    @classmethod
    def _is_irreducible(cls, f):
        """Rabin's irreducibility test."""
        p = cls.p
        d = cls._deg(f)
        if d <= 0:
            return False
        if d == 1:
            return True
        x = cls._x()
        # x^(p^d) == x (mod f)
        h = x
        for _ in range(d):
            h = cls._powmod(h, p, f)
        if h != cls._mod(x, f):
            return False
        # for each prime divisor e of d: gcd(x^(p^(d/e)) - x, f) == 1
        n, divs = d, []
        e = 2
        while e * e <= n:
            if n % e == 0:
                divs.append(e)
                while n % e == 0:
                    n //= e
            e += 1
        if n > 1:
            divs.append(n)
        for e in divs:
            h = x
            for _ in range(d // e):
                h = cls._powmod(h, p, f)
            g = cls._gcd(cls._sub(h, x), f)
            if g != cls._one():
                return False
        return True

    @classmethod
    def is_irreducible(cls, f):
        f = cls._intern(f)
        return cls._is_irreducible(f)

    @classmethod
    def next_irreducible(cls, x):
        """Smallest monic irreducible polynomial with int encoding > x."""
        p = cls.p
        v = x if isinstance(x, int) else int(cls(x))
        while True:
            v += 1
            if v % p == 0:  # constant coefficient 0 => divisible by X
                v += 1
            a = cls._from_int(v)
            if p > 2 and a[-1] != 1:  # enforce monic (p=2 always monic)
                v = p ** len(a)  # jump to X^(len(a)): next monic candidate -1
                continue
            if cls._is_irreducible(a):
                return cls(a, check=False)

    # -- operators --------------------------------------------------------

    def _both(self, other):
        other = self._coerce(other)
        if other is NotImplemented:
            return None
        return other

    def __add__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._add(self.value, b), check=False)

    __radd__ = __add__

    def __sub__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._sub(self.value, b), check=False)

    def __rsub__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._sub(b, self.value), check=False)

    def __neg__(self):
        return type(self)(self._neg(self.value), check=False)

    def __pos__(self):
        return type(self)(self.value)

    def __mul__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._mul(self.value, b), check=False)

    __rmul__ = __mul__

    def __lshift__(self, n):
        if not isinstance(n, int):
            return NotImplemented
        return type(self)(self._lshift(self.value, n), check=False)

    def __rshift__(self, n):
        if not isinstance(n, int):
            return NotImplemented
        return type(self)(self._rshift(self.value, n), check=False)

    def __floordiv__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._divmod(self.value, b)[0], check=False)

    def __rfloordiv__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._divmod(b, self.value)[0], check=False)

    def __mod__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._mod(self.value, b), check=False)

    def __rmod__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        return type(self)(self._mod(b, self.value), check=False)

    def __divmod__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        q, r = self._divmod(self.value, b)
        cls = type(self)
        return cls(q, check=False), cls(r, check=False)

    def __rdivmod__(self, other):
        b = self._both(other)
        if b is None:
            return NotImplemented
        q, r = self._divmod(b, self.value)
        cls = type(self)
        return cls(q, check=False), cls(r, check=False)

    def __pow__(self, n, modulus=None):
        if not isinstance(n, int):
            return NotImplemented
        m = None if modulus is None else self._intern(modulus)
        return type(self)(self._powmod(self.value, n, m), check=False)

    # -- public classmethod API (MPyC's gfpx.py:580-760) ----------------

    @classmethod
    def add(cls, a, b):
        """Add polynomials a and b."""
        return cls(cls._add(cls._intern(a), cls._intern(b)), check=False)

    @classmethod
    def sub(cls, a, b):
        """Subtract polynomials a and b."""
        return cls(cls._sub(cls._intern(a), cls._intern(b)), check=False)

    @classmethod
    def mul(cls, a, b):
        """Multiply polynomials a and b."""
        return cls(cls._mul(cls._intern(a), cls._intern(b)), check=False)

    @classmethod
    def lshift(cls, a, n):
        """Multiply polynomial a by X^n."""
        return cls(cls._lshift(cls._intern(a), n), check=False)

    @classmethod
    def rshift(cls, a, n):
        """Quotient of polynomial a divided by X^n."""
        return cls(cls._rshift(cls._intern(a), n), check=False)

    @classmethod
    def mod(cls, a, b):
        """Reduce polynomial a modulo nonzero polynomial b."""
        b = cls._intern(b)
        if not b:
            raise ZeroDivisionError('division by zero polynomial')
        return cls(cls._mod(cls._intern(a), b), check=False)

    @classmethod
    def divmod(cls, a, b):
        """Divide polynomial a by nonzero polynomial b with remainder."""
        q, r = cls._divmod(cls._intern(a), cls._intern(b))
        return cls(q, check=False), cls(r, check=False)

    @classmethod
    def powmod(cls, a, n, b):
        """Polynomial a to the power of n modulo nonzero polynomial b."""
        return cls(cls._powmod(cls._intern(a), n,
                               modulus=cls._intern(b)), check=False)

    def truncate(self, d):
        """Truncate polynomial to degree < d (drop X^d and higher)."""
        cls = type(self)
        return cls(cls._truncate(self.value, d), check=False)

    @classmethod
    def _truncate(cls, a, d):
        return cls._norm(list(a[:d]))

    @classmethod
    def gcd(cls, a, b):
        a, b = cls._intern(a), cls._intern(b)
        return cls(cls._gcd(a, b), check=False)

    @classmethod
    def gcdext(cls, a, b):
        a, b = cls._intern(a), cls._intern(b)
        g, s, t = cls._gcdext(a, b)
        return cls(g, check=False), cls(s, check=False), cls(t, check=False)

    @classmethod
    def invert(cls, a, modulus):
        a, m = cls._intern(a), cls._intern(modulus)
        return cls(cls._invert(a, m), check=False)

    def monic(self, lc_pinv=False):
        """Monic version; with lc_pinv also return the inverse of the
        leading coefficient (0 for the zero polynomial) — MPyC's
        gfpx.py:535-547."""
        cls = type(self)
        if lc_pinv:
            a, a1 = cls._monic(self.value, lc_pinv=True)
            return cls(a, check=False), a1
        return cls(self._monic(self.value), check=False)

    def deriv(self, m=1):
        """Order-m formal derivative of the polynomial (m>=0)."""
        p = self.p
        cs = list(self.value)
        for _ in range(m):
            cs = [i * c % p for i, c in enumerate(cs)][1:]
        return type(self)(self._norm(cs), check=False)

    def reverse(self, d=None):
        """Reverse as degree-d polynomial: pad with zeros or truncate to
        degree d (>= -1) first, then reverse (MPyC's gfpx.py:549-558)."""
        cs = list(self.value)
        if d is None:
            d = len(cs) - 1
        cs = cs[:d + 1]
        cs = cs + [0] * (d + 1 - len(cs))
        return type(self)(self._norm(cs[::-1]), check=False)

    # -- comparisons (by int encoding; zero smallest) ----------------------

    def _cmp_key(self):
        return self._to_int(self.value)

    def __reduce__(self):
        return _unpickle_poly, (self.p, int(self))

    def __eq__(self, other):
        b = self._coerce(other)
        if b is NotImplemented:
            return NotImplemented
        return self.value == b

    def __hash__(self):
        return hash((type(self).__name__, tuple(self.value)))

    def __lt__(self, other):
        b = self._coerce(other)
        if b is NotImplemented:
            return NotImplemented
        return self._cmp_key() < self._to_int(b)

    def __le__(self, other):
        b = self._coerce(other)
        if b is NotImplemented:
            return NotImplemented
        return self._cmp_key() <= self._to_int(b)

    def __gt__(self, other):
        b = self._coerce(other)
        if b is NotImplemented:
            return NotImplemented
        return self._cmp_key() > self._to_int(b)

    def __ge__(self, other):
        b = self._coerce(other)
        if b is NotImplemented:
            return NotImplemented
        return self._cmp_key() >= self._to_int(b)

    def __bool__(self):
        return bool(self.value)

    def __repr__(self):
        return self._to_terms(self.value)


class BinaryPolynomial(Polynomial):
    """Polynomial over GF(2) represented as an int bitmask (carry-less ops)."""

    __slots__ = ()

    p = 2

    @staticmethod
    def _norm(v):
        return v

    @classmethod
    def _from_int(cls, a):
        return abs(a)

    @staticmethod
    def _to_list(a):
        c = []
        while a:
            a, r = divmod(a, 2)
            c.append(r)
        return c

    @classmethod
    def _to_int(cls, v):
        return v

    @classmethod
    def _coerce(cls, a):
        if isinstance(a, Polynomial):
            if not isinstance(a, cls):
                raise TypeError(f'polynomial of type {cls.__name__} expected')
            return a.value
        if isinstance(a, int):
            return cls._from_int(a)
        if isinstance(a, str):
            return cls._from_terms(a)
        if isinstance(a, (tuple, list)):
            if not all(isinstance(c, int) and 0 <= c < 2 for c in a):
                raise ValueError('polynomial coefficients invalid or out of range')
            v = 0
            for i, c in enumerate(a):
                v |= c << i
            return v
        return NotImplemented

    @classmethod
    def _from_terms(cls, s):
        cs = Polynomial._from_terms.__func__(cls, s)  # reuse parser with p=2
        v = 0
        for i, c in enumerate(cs):
            v |= c << i
        return v

    @classmethod
    def _to_terms(cls, v):
        if v == 0:
            return '0'
        terms = []
        for e in range(v.bit_length() - 1, -1, -1):
            if (v >> e) & 1:
                terms.append('1' if e == 0 else (X if e == 1 else f'{X}^{e}'))
        return '+'.join(terms)

    def __iter__(self):
        v = self.value
        while v:
            yield v & 1
            v >>= 1

    def __getitem__(self, key):
        if not isinstance(key, int):
            raise IndexError('use int for indexing polynomials')
        if key == -1 and not self.value:
            return 0
        if key < 0:
            raise IndexError('negative index not allowed for nonzero polynomials')
        return (self.value >> key) & 1

    def __call__(self, x):
        # MPyC-exact evaluation (gfpx.py:867-869, incl. its x-even
        # convention of returning 0 rather than the constant term)
        return bin(self.value).count('1', 2) % 2 if x % 2 else 0

    def degree(self):
        return self.value.bit_length() - 1

    def deriv(self, m=1):
        """Order-m formal derivative: only odd-degree terms survive mod 2."""
        v = self.value
        for _ in range(m):
            v >>= 1
            mask = sum(1 << i for i in range(0, v.bit_length(), 2))
            v &= mask
        return type(self)(v, check=False)

    @classmethod
    def _truncate(cls, a, d):
        return a & ((1 << d) - 1)

    @classmethod
    def _add(cls, a, b):
        return a ^ b

    _sub = _add

    @classmethod
    def _neg(cls, a):
        return a

    @classmethod
    def _mul(cls, a, b):
        if a.bit_length() > b.bit_length():
            a, b = b, a
        out = 0
        while a:
            if a & 1:
                out ^= b
            a >>= 1
            b <<= 1
        return out

    @classmethod
    def _lshift(cls, a, n):
        return a << n

    @classmethod
    def _rshift(cls, a, n):
        return a >> n

    @classmethod
    def _divmod(cls, a, b):
        if b == 0:
            raise ZeroDivisionError('division by zero polynomial')
        db = b.bit_length()
        q = 0
        while (sh := a.bit_length() - db) >= 0:
            q |= 1 << sh
            a ^= b << sh
        return q, a

    @classmethod
    def _mod(cls, a, b):
        if b is None:
            return a
        if b == 0:
            raise ZeroDivisionError('division by zero polynomial')
        db = b.bit_length()
        while (sh := a.bit_length() - db) >= 0:
            a ^= b << sh
        return a

    @classmethod
    def _one(cls):
        return 1

    @classmethod
    def _deg(cls, a):
        return a.bit_length() - 1

    @classmethod
    def _x(cls):
        return 2

    @classmethod
    def _monic(cls, a, lc_pinv=False):
        return (a, 1 if a else 0) if lc_pinv else a

    @classmethod
    def _gcd(cls, a, b):
        while b:
            a, b = b, cls._mod(a, b)
        return a

    @classmethod
    def _gcdext(cls, a, b):
        s0, s1, t0, t1 = 1, 0, 0, 1
        while b:
            q, r = cls._divmod(a, b)
            a, b = b, r
            s0, s1 = s1, s0 ^ cls._mul(q, s1)
            t0, t1 = t1, t0 ^ cls._mul(q, t1)
        return a, s0, t0

    @classmethod
    def _invert(cls, a, modulus):
        g, s, _ = cls._gcdext(a, modulus)
        if g != 1:
            raise ZeroDivisionError('inverse does not exist')
        return s

    @classmethod
    def next_irreducible(cls, x):
        """Smallest monic irreducible polynomial with int encoding > x.

        Matches MPyC's convention: X (encoding 2) is the first
        irreducible binary polynomial; subsequent candidates have nonzero
        constant term (odd encodings).
        """
        v = x if isinstance(x, int) else int(cls(x))
        if v <= 1:
            return cls(2, check=False)
        v += 1 + v % 2
        while not cls._is_irreducible(v):
            v += 2
        return cls(v, check=False)

    def reverse(self, d=None):
        """Reverse as degree-d bitmask polynomial: truncate or zero-pad to
        degree d (>= -1), then reverse (MPyC's gfpx.py:949-956)."""
        v = self.value
        if d is None:
            d = v.bit_length() - 1
        v &= (1 << max(d + 1, 0)) - 1
        out = 0
        for i in range(max(d + 1, 0)):
            if (v >> i) & 1:
                out |= 1 << (d - i)
        return type(self)(out, check=False)

    def __hash__(self):
        return hash((type(self).__name__, self.value))


def _unpickle_poly(p, value):
    """Recreate a polynomial from (p, int encoding) for the pickle module."""
    return GFpX(p)(value)
