"""The secure determinant (``np_det``) on the port, against the JAX
package, and the helpers the demos call beside it.

A JAX ``SimRuntime(3)`` and the port's take the same matrix from the same
randomness state (``load_state``; the JAX shares moved to jax arrays):
``np_det`` (random triangular L and U from one PRSS draw, det U's zero
test, L U A opened, its public determinant ``_field_det_public``, one
division) gives the JAX package's shares bit for bit and the exact
determinant, after ``tests/test_npops.py:47``, over a secure integer
type and over a seven-limb secure field. ``_field_det_public`` equals the
JAX package's on nonsingular, singular and pivoting matrices;
``_logical_reshape`` and ``_share_like`` keep and add the party axis.

Tolerance: exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu.runtime import _field_det_public as jax_field_det_public
from mpyc_tpu_torch import finfields, runtime
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

M3 = [[2, 1, 3], [0, 4, 1], [5, 2, 2]]
M4 = [[3, -1, 0, 2], [1, 2, -2, 0], [0, 5, 1, -1], [4, 0, 3, 1]]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jr():
    """A JAX SimRuntime(3), wired into the JAX package's type layer (its
    own runtime wired back after)."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        rt = JaxSim(3, _Options())
        rt._wire_modules()
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
    tr.load_state(jr._fused_key, np.asarray(
        jr._fused_ctr if jr._fused_ctr is not None else np.zeros(2)),
        jr._rng.key, jr._rng._nonce, prss_keys=jr._prss_keys,
        pc=jr._program_counter[0])
    return tr


def _same(jx, tx):
    np.testing.assert_array_equal(limbs_to_numpy(tx.share.data),
                                  np.asarray(jx.share.data))


@pytest.mark.parametrize('matrix', ['M3', 'M4'])
@pytest.mark.parametrize('kind', ['SecInt32', 'SecFld7'])
def test_np_det_bit_identical(jr, kind, matrix):
    """det of the 3 x 3 of tests/test_npops.py and a 4 x 4 with negative
    entries: the JAX package's shares, program counter and value, equal
    to numpy's determinant rounded."""
    tr = _port(jr)
    M = np.array({'M3': M3, 'M4': M4}[matrix], dtype=object)
    if kind == 'SecInt32':
        jt, tt = jr.SecInt(32), tr.SecInt(32)
    else:
        jt = jr.SecFld(min_order=1 << 220, signed=True)
        tt = tr.SecFld(min_order=1 << 220, signed=True)
        assert tt.field.array.ctx.L == 7
    jA = jr.input(jt.array(M), senders=0)
    tA = tr.input(tt.array(M), senders=0)
    jA.share = jA.share.from_data(jnp.asarray(jA.share.data))
    jd, td = jr.np_det(jA), tr.np_det(tA)
    _same(jd, td)
    assert tr._program_counter[0] == jr._program_counter[0]
    want = round(np.linalg.det(M.astype(float)))
    assert int(tr.output(td)) == int(jr.output(jd)) == want


@pytest.mark.parametrize('case', ['random', 'singular', 'pivot', 'one'])
def test_field_det_public_equals_the_jax_packages(case):
    """The public determinant mod p of an opened field array: Gaussian
    elimination with row swaps (a zero leading entry), 0 for a singular
    matrix, the JAX package's value in every case."""
    p = 1000003
    g = np.random.default_rng(7)
    M = {'random': g.integers(0, p, (6, 6)),
         'singular': np.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]]),
         'pivot': np.array([[0, 2, 1], [3, 1, 0], [1, 1, 1]]),
         'one': np.array([[p - 5]])}[case].astype(object)
    tf = finfields.GF(p)
    jf = jsectypes.SecFld(p).field
    got = runtime._field_det_public(tf, tf.array(M % p, 'cpu'))
    want = jax_field_det_public(jf, jf.array(M % p))
    assert int(got) % p == int(want) % p
    if case != 'random':    # numpy's float determinant is exact here
        assert int(got) % p == round(np.linalg.det(M.astype(float))) % p


def test_logical_reshape_and_share_like():
    """``_logical_reshape`` keeps the party axis and reshapes the logical
    ones; ``_share_like`` puts a public field array on every party."""
    tr = TorchSim(3, device='cpu')
    secint = tr.SecInt(32)
    x = tr.input(secint.array(np.arange(6, dtype=object)), senders=0)
    sh = tr._share(x)
    r = tr._logical_reshape(sh, (2, 3))
    assert tuple(r.shape) == (3, 2, 3)
    assert tuple(tr._logical_reshape(sh[:, :1], ()).shape) == (3,)
    assert tr._pax == 1
    c = secint.field.array(np.array([4, 5], dtype=object), 'cpu')
    s = tr._share_like(c)
    assert tuple(s.shape) == (3, 2)
    opened = tr.output(tr._wrap(secint.array, s, True))
    assert list(opened) == [4, 5]
