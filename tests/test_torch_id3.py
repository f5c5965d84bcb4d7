"""The secure aggregates of the ID3 trees on the port, against the JAX
package, and the tennis tree against the JAX demo.

A JAX ``SimRuntime(3)`` and the port's, the port loaded with the JAX
runtime's randomness (``load_state``), take the same inputs:

* ``np_prod`` over all axes and over one: the same shares bit for bit,
  opened to numpy's product;
* ``argmax`` and ``argmin`` of lists, of numbers and of [numerator,
  denominator] lists with the demo's ``SecureFraction`` as key, ties
  included: the same opened index and extremum, the first occurrence of
  it (the plain tournament ``np_id3gini._plain_argmax`` agrees);
* ``is_zero_public`` of a secure number: the same blinded value opened
  (the same PRSS draws: one r in a field of 2k bits or more, the r s
  loop below), the same answer and program counter; of an array: the
  same answers, each value blinded by its own r on the port (the opened
  ratios differ where the JAX package's single r repeats them). Below k
  bits (a zero-sharing added), which the JAX package takes for no
  secure integer type, the port alone is held to the values.

The port's runner ``mpyc_tpu_torch.demos.np_id3gini`` on tennis prints
the JAX demo's lines (``demos/id3gini.py -M3 --sim``, a subprocess) and
its tree equals ``plain_id3``'s.

Tolerance: exact equality (shares, integers, printed lines).
"""
import contextlib
import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.demos import np_id3gini as id3
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

ROOT = Path(__file__).resolve().parents[1]
P_SMALL = 1000003        # a 20-bit prime: below k = 30 bits


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_tennis():
    """The JAX demo's lines on tennis, run in the background (no trace
    cache written: it would land in the checkout)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', MPYC_TPU_CACHE='0')
    res = {}

    def run():
        proc = subprocess.run(
            [sys.executable, str(ROOT / 'demos' / 'id3gini.py'), '-M3',
             '--sim'], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        res['out'] = (proc.returncode, proc.stdout.splitlines(),
                      proc.stderr[-2000:])
    th = threading.Thread(target=run, daemon=True)
    th.start()
    yield lambda: (th.join(600), res['out'])[1]


@pytest.fixture(scope='module')
def jr():
    """A JAX SimRuntime(3) (wired into the JAX package's type layer, its
    own runtime wired back after) whose reshares run on its device
    plane."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        rt = JaxSim(3, _Options())
        rt._wire_modules()
        reshare = rt._reshare

        def device(x):
            return x.from_data(jnp.asarray(x.data)) \
                if isinstance(x.data, np.ndarray) else x

        def reshare_on_device(x):
            return reshare([device(v) for v in x] if isinstance(x, list)
                           else device(x))
        mp.setattr(rt, '_reshare', reshare_on_device)
        rt.start()
        try:
            yield rt
        finally:
            rt.shutdown()
            if old is not None:
                old._wire_modules()


def _port(jr):
    """A port runtime continuing from the JAX runtime's randomness."""
    jr._fused_state()
    jr._rng._pool = jr._rng._byte_pool = None
    tr = TorchSim(3, device='cpu')
    tr.load_state(jr._fused_key, np.asarray(jr._fused_ctr), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])
    return tr


def _same(j, t):
    np.testing.assert_array_equal(limbs_to_numpy(t.share.data),
                                  np.asarray(j.share.data))


def _inputs(jr, tr, jt, tt, values):
    values = np.asarray(values)
    if values.ndim:
        jx = jr.input(jt.array(values), senders=0)
        tx = tr.input(tt.array(values), senders=0)
    else:
        jx = jr.input(jt(values.item()), senders=0)
        tx = tr.input(tt(values.item()), senders=0)
    _same(jx, tx)
    return jx, tx


def _opened(mp, rt):
    """The values rt opens from now on, as lists of ints."""
    seen = []
    output = rt.output

    def spy(x, *args, **kwargs):
        y = output(x, *args, **kwargs)
        seen.append([int(v) for v in np.asarray(y.value).reshape(-1)])
        return y
    mp.setattr(rt, 'output', spy)
    return seen


@pytest.mark.parametrize('axis', [None, 0, 1])
def test_np_prod_matches_jax(jr, axis):
    tr = _port(jr)
    jt, tt = jr.SecInt(32), tr.SecInt(32)
    values = np.array([[1, -2, 3, 4, -1], [2, 5, -3, 1, 7], [1, 1, 2, 3, -2]])
    jx, tx = _inputs(jr, tr, jt, tt, values)
    jp, tp = jr.np_prod(jx, axis=axis), tr.np_prod(tx, axis=axis)
    _same(jp, tp)
    assert tr._program_counter[0] == jr._program_counter[0]
    np.testing.assert_array_equal(np.asarray(tr.output(tp)),
                                  np.prod(values, axis=axis))


def test_argmax_with_a_key_matches_jax(jr):
    """The Gini fractions' argmax: [num, den] lists keyed by
    SecureFraction, the greatest fraction twice (2/3 = 4/6): the first
    occurrence wins; then argmin and argmax of numbers with ties."""
    tr = _port(jr)
    jt, tt = jr.SecInt(32), tr.SecInt(32)
    fracs = [(1, 3), (2, 3), (1, 2), (4, 6), (0, 1), (3, 5)]
    jf, tf = [], []
    for num, den in fracs:
        pair = [_inputs(jr, tr, jt, tt, np.array(v)) for v in (num, den)]
        jf.append([p[0] for p in pair])
        tf.append([p[1] for p in pair])
    ji, jm = jr.argmax(jf, key=id3.SecureFraction)
    ti, tm = tr.argmax(tf, key=id3.SecureFraction)
    want = id3._plain_argmax(fracs, lambda u, v: u[0] * v[1] < u[1] * v[0])
    assert int(tr.output(ti)) == int(jr.output(ji)) == want == 1
    assert [int(tr.output(v)) for v in tm] == \
        [int(jr.output(v)) for v in jm] == [2, 3]
    values = [5, -3, 9, -3, 9, 0, 2]
    xs = [_inputs(jr, tr, jt, tt, np.array(v)) for v in values]
    for op, want in (('argmin', 1), ('argmax', 2)):
        j_i, j_m = getattr(jr, op)([x[0] for x in xs])
        t_i, t_m = getattr(tr, op)([x[1] for x in xs])
        assert int(tr.output(t_i)) == int(jr.output(j_i)) == want
        assert int(tr.output(t_m)) == int(jr.output(j_m)) == values[want]


@pytest.mark.parametrize('l', [32, 8])
@pytest.mark.parametrize('value', [0, -37])
def test_is_zero_public_of_a_number_matches_jax(jr, l, value):
    """SecInt(32): a 64-bit field (one r); SecInt(8): 40 bits (the r s
    loop)."""
    tr = _port(jr)
    jt, tt = jr.SecInt(l), tr.SecInt(l)
    assert tt.field.order.bit_length() // 30 == {32: 2, 8: 1}[l]
    jx, tx = _inputs(jr, tr, jt, tt, np.array(value))
    with pytest.MonkeyPatch.context() as mp:
        j_open, t_open = _opened(mp, jr), _opened(mp, tr)
        jz, tz = jr.is_zero_public(jx), tr.is_zero_public(tx)
    assert bool(jz) is tz is (value == 0)
    assert t_open == j_open
    assert tr._program_counter[0] == jr._program_counter[0]


ARRAY = np.array([[0, 3, 3, -5], [6, 0, 9, 0]])


def _blinders(opened, values, mod):
    """The distinct ratios opened / value of the nonzero values."""
    c = np.array(opened, dtype=object).reshape(values.shape)
    return {int(cv) * pow(int(v) % mod, -1, mod) % mod
            for cv, v in zip(c.flat, values.flat) if v}


@pytest.mark.parametrize('l', [32, 8])
def test_is_zero_public_of_an_array_blinds_each_value(jr, l):
    tr = _port(jr)
    jt, tt = jr.SecInt(l), tr.SecInt(l)
    jx, tx = _inputs(jr, tr, jt, tt, ARRAY)
    with pytest.MonkeyPatch.context() as mp:
        t_open = _opened(mp, tr)
        tz = tr.is_zero_public(tx)
    jz = jr.is_zero_public(jx)
    np.testing.assert_array_equal(tz, ARRAY == 0)
    np.testing.assert_array_equal(np.asarray(jz), tz)
    assert len(_blinders(t_open[-1], ARRAY, tt.field.modulus)) == \
        np.count_nonzero(ARRAY)


@pytest.mark.parametrize('shape', [(), ARRAY.shape])
def test_is_zero_public_below_k_bits(shape):
    """A 20-bit field (below k = 30 bits: r s opened with a zero-sharing
    added, the blinded value too), shares of the constant polynomial as
    a field array; the JAX package takes no such field for SecInt, nor
    field arrays here, so the port is held to the values."""
    from mpyc_tpu_torch import finfields
    tr = TorchSim(3, device='cpu')
    field = finfields.GF(P_SMALL)
    assert field.order.bit_length() // 30 == 0
    values = ARRAY if shape else np.array(0)
    for vals in (values, values + (values == 0)):
        shares = field.array(np.broadcast_to(
            vals % P_SMALL, (3,) + shape).astype(object), 'cpu')
        with pytest.MonkeyPatch.context() as mp:
            t_open = _opened(mp, tr)
            z = tr.is_zero_public(shares)
        np.testing.assert_array_equal(z, vals == 0)
        if shape:
            assert len(_blinders(t_open[-1], vals, P_SMALL)) == \
                np.count_nonzero(vals)


def test_tennis_tree_prints_the_jax_demos_lines(jax_tennis):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = id3.main(['-i', '0', '--device', 'cpu'])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert lines[-1].endswith('plain tree equal to the secure tree: True')
    j_rc, j_lines, err = jax_tennis()
    assert j_rc == 0, err
    assert lines[:-1] == j_lines
    assert id3.plain_id3(0) == (0, [1, (3, [0, 1]), (2, [0, 1])])
