"""Secure lists and the runtime functions under them, on the port,
against the JAX package.

A JAX ``SimRuntime(3)`` and the port's compute the same things on the
same inputs, and their results open to the same values (each is exact:
an index, a bit, a residue, a list), which are also held to Python's:

* ``unit_vector`` over SecFld(1031), SecInt(32) and SecFxp(32, 16) (a
  zero test of i - j: Fermat's, or the comparison in EQ mode);
* ``find`` (bits and values, found and not, e and f), ``indexOf``
  (raising where the value is absent), ``from_bits``;
* ``lsb``, ``mod`` (a power of two, and the rejection of ``_randbelow_bits``
  at 3, 5 and 10), ``//`` and ``divmod`` of SecInt(32) and SecFxp(32, 16)
  numbers by public values, negative ones too (the JAX package's
  ``lsb`` of a fixed-point number is that of its raw value: 0 for an
  integral one, and the port's mirrors it);
* ``seclist``: reads, writes, insertions, deletions and pops at secret
  indices (secure numbers and ``secindex`` unit vectors with offsets),
  count, find, index, contains, remove, sort, and the lexicographic
  comparisons.

The JAX package's reshares and comparisons on its CPU plane take other
random streams (and its ``_mod`` a zero test of its own), so the shares
differ; the opened values may not.

Tolerance: exact.
"""
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu import seclists as jseclists
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import seclists as tseclists
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def rts():
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        jr.start()
        try:
            yield jr, TorchSim(3, device='cpu')
        finally:
            jr.shutdown()
            if old is not None:
                old._wire_modules()


def _open(rt, x):
    if isinstance(x, (list, tuple)):
        return [_open(rt, v) for v in x]
    if isinstance(x, (int, bool)):
        return int(x)
    v = rt.output(x)
    return float(v) if isinstance(v, float) else int(v)


def _type(rt, kind):
    return {'fld': lambda: rt.SecFld(1031), 'int': lambda: rt.SecInt(32),
            'fxp': lambda: rt.SecFxp(32, 16)}[kind]()


def _both(rts, kind, fn):
    """fn(rt, sectype) on both runtimes, opened: (JAX's, the port's)."""
    return [_open(rt, fn(rt, _type(rt, kind))) for rt in rts]


@pytest.mark.parametrize('kind', ['fld', 'int', 'fxp'])
def test_unit_vector_matches_jax(rts, kind):
    n = 6
    for i in (0, 4):
        want, got = _both(rts, kind, lambda rt, t: rt.unit_vector(
            rt.input(t(i), senders=0), n))
        assert got == want == [int(j == i) for j in range(n)]


def test_find_index_of_and_from_bits_match_jax(rts):
    vals = [5, 3, 7, 3, 9]
    bits = [0, 0, 1, 0, 1]

    def fn(rt, t):
        x = [rt.input(t(v), senders=0) for v in vals]
        b = [t(v) for v in bits]
        return [rt.find(x, t(3), bits=False), rt.find(x, t(4), bits=False),
                rt.find(x, t(4), bits=False, e=-1),
                rt.find(b, 1), rt.find(b, 0), rt.find(b, t(1)),
                rt.find(b, 1, f=lambda i: 10 * i),
                rt.find(b, 1, e=None)[1], rt.find([], 1),
                rt.indexOf(x, t(9)), rt.from_bits(b)]
    want, got = _both(rts, 'int', fn)
    assert got == want == [1, 5, -1, 2, 0, 2, 20, 2, 0, 4, 20]
    for rt in rts:
        t = rt.SecInt(32)
        with pytest.raises(ValueError):
            rt.indexOf([t(1), t(2)], t(5))


@pytest.mark.parametrize('kind', ['int', 'fxp'])
def test_lsb_mod_and_divmod_match_jax(rts, kind):
    """Residues and quotients by 2 (the lsb, or for fixed point mod
    2^17), 3, 4, 5 and 10 of positive and negative values."""
    vals = [13, -7, 0, 22] if kind == 'int' else [13, -7, 22]

    def fn(rt, t):
        out = []
        for v in vals:
            a = rt.input(t(v), senders=0)
            out += [rt.lsb(a), a % 4, a % 3] + list(divmod(a, 2))
            if kind == 'int':
                out += [a // 5, a % 10]
        return out
    want, got = _both(rts, kind, fn)
    assert got == want
    if kind == 'int':
        assert got == [x for v in vals for x in
                       (v & 1, v % 4, v % 3, v // 2, v % 2, v // 5, v % 10)]
    else:
        assert got == [x for v in vals for x in
                       (0, v % 4, v % 3, v // 2, v % 2)]


def _ops(rt, sl, t):
    """A seclist of 6 values through reads, writes, insertions,
    deletions and pops at secret indices, and its searches."""
    x = sl.seclist([5, 3, 8, 1, 3, 6], t)
    out = [x[t(2)], x[sl.secindex(t(1), offset=1)]]
    x[t(4)] = 11
    x[sl.secindex([t(0), t(1), t(0)], sectype=t, offset=2)] = -2
    out.append(list(x))
    x.insert(t(3), 9)
    out.append(list(x))
    out.append(x.pop(t(0)))
    del x[t(5)]
    out.append(list(x))
    out += [x.count(9), x.find(9), x.find(4), x.index(-2), x.contains(8),
            x.contains(4)]
    x.remove(9)
    out.append(list(x))
    x.sort()
    out.append(list(x))
    y = sl.seclist([-2, 1, 4], t)
    out += [x < y, y < x, x <= list(x), x == list(x), x != y, x > y,
            x >= y, x[1:3] < [1, 4, 1]]
    return out


def test_seclist_matches_jax(rts):
    want, got = _both(rts, 'int', lambda rt, t: _ops(
        rt, jseclists if isinstance(rt, JaxSim) else tseclists, t))
    assert got == want
    assert got[:8] == [8, 8, [5, 3, 8, -2, 11, 6], [5, 3, 8, 9, -2, 11, 6],
                       5, [3, 8, 9, -2, 11], 1, 2]
    assert got[8:14] == [-1, 3, 1, 0, [3, 8, -2, 11], [-2, 3, 8, 11]]
    assert got[14:] == [0, 1, 1, 1, 1, 1, 1, 0]


def test_seclist_public_access_and_errors():
    tr = TorchSim(3, device='cpu')
    t = tr.SecInt(32)
    x = tseclists.seclist([1, 2], t)
    x.append(3)
    x += [4]
    y = [0] + x
    assert isinstance(y, tseclists.seclist) and len(y) == 5
    assert [int(tr.output(v)) for v in (x * 2)[::3]] == [1, 4, 3]
    with pytest.raises(NotImplementedError):
        _ = 3 in x
    with pytest.raises(ValueError):
        tseclists.seclist([1, 2])
    with pytest.raises(ValueError):
        x.remove(t(9))
