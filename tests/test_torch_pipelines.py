"""Port's fused reshare round (mpyc_tpu_torch.models.pipelines) against the
JAX package's make_reshare_step, which runs its XLA twin step_xla on the
CPU, for the same shares, state and counter.

Tolerance: exact equality (bit patterns of Montgomery limbs)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops.fieldops import limbs_from_numpy, limbs_to_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P = 18446744073709551427   # SecInt(32)'s field
M, T = 3, 1


@functools.cache
def _jax_step(fuse):
    return jpipe.make_reshare_step(P, T, M, fuse_mul=fuse)


def _state() -> np.ndarray:
    hi, lo = jkeccak._absorb_host(bytes(range(100, 132)) + bytes(8))
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


def _shares(n, seed, shape=None):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 32, (M, n), dtype=np.uint64)
    hi = rng.integers(0, P >> 32, (M, n), dtype=np.uint64)
    a = np.stack([lo, hi], axis=-1).astype(np.uint32)
    return a.reshape((M,) + (shape or (n,)) + (2,))


@pytest.mark.parametrize('n', [64, 4096])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_step_matches_jax(n, fuse):
    """Two chained calls, starting from a counter whose low word wraps, give
    the JAX step's shares and counters."""
    st = _state()
    a, b = _shares(n, 1), _shares(n, 2)
    jstep, tstep = _jax_step(fuse), tpipe.make_reshare_step(P, T, M, fuse)
    jctr = jnp.asarray(np.array([0xFFFFFFFF, 6], np.uint32))
    tctr = np.array([0xFFFFFFFF, 6], np.uint32)
    tst = tkeccak.state_tensor(st, 'cpu')
    for _ in range(2):
        jargs = (jnp.asarray(a), jnp.asarray(b)) if fuse \
            else (jnp.asarray(a),)
        targs = (limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')) \
            if fuse else (limbs_from_numpy(a, 'cpu'),)
        jout, jctr = jstep(*jargs, jnp.asarray(st), jctr)
        tout, tctr = tstep(*targs, tst, tctr)
        np.testing.assert_array_equal(limbs_to_numpy(tout), np.asarray(jout))
        np.testing.assert_array_equal(tctr, np.asarray(jctr))
        a = np.asarray(jout)
    assert list(tctr) == [1, 7]


P69 = 590295810358705651619   # SecInt(37)'s field, three limbs


@functools.cache
def _jax_step_69(fuse):
    return jpipe.make_reshare_step(P69, T, M, fuse_mul=fuse)


def _shares69(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (M, n, 3), dtype=np.uint64)
    a[..., 2] = rng.integers(0, P69 >> 64, (M, n))
    return a.astype(np.uint32)


@pytest.mark.parametrize('n', [64, 1000])
@pytest.mark.parametrize('fuse', [True, False])
def test_reshare_step_matches_jax_at_three_limbs(n, fuse):
    """SecInt(37)'s 69-bit field: 20-byte draws, eight a block. Two
    chained calls from a counter whose low word wraps give the JAX step's
    shares and counters bit for bit."""
    st = _state()
    a, b = _shares69(n, 4), _shares69(n, 5)
    jstep, tstep = _jax_step_69(fuse), tpipe.make_reshare_step(P69, T, M,
                                                               fuse)
    jctr = jnp.asarray(np.array([0xFFFFFFFF, 2], np.uint32))
    tctr = np.array([0xFFFFFFFF, 2], np.uint32)
    tst = tkeccak.state_tensor(st, 'cpu')
    for _ in range(2):
        jargs = (jnp.asarray(a), jnp.asarray(b)) if fuse \
            else (jnp.asarray(a),)
        targs = (limbs_from_numpy(a, 'cpu'), limbs_from_numpy(b, 'cpu')) \
            if fuse else (limbs_from_numpy(a, 'cpu'),)
        jout, jctr = jstep(*jargs, jnp.asarray(st), jctr)
        tout, tctr = tstep(*targs, tst, tctr)
        np.testing.assert_array_equal(limbs_to_numpy(tout), np.asarray(jout))
        np.testing.assert_array_equal(tctr, np.asarray(jctr))
        a = np.asarray(jout)
    assert list(tctr) == [1, 3]


def test_reshare_step_keeps_logical_shape():
    st = tkeccak.state_tensor(_state(), 'cpu')
    a = limbs_from_numpy(_shares(60, 3, (4, 15)), 'cpu')
    out, ctr = tpipe.make_reshare_step(P, T, M, True)(a, a, st,
                                                      np.zeros(2, np.uint32))
    assert out.shape == a.shape and list(ctr) == [1, 0]


@pytest.mark.parametrize('t,m', [(1, 4), (2, 5)])
def test_reshare_general_t_opens_to_the_product(t, m):
    """The plain round for other (t, m): t+1 consecutive output shares
    recombine to the product of the shared secrets."""
    from mpyc_tpu_torch import finfields, thresha
    from mpyc_tpu_torch.ops.rng import KeccakRNG
    field = finfields.GF(P)
    rng = KeccakRNG(bytes(32), device='cpu')
    x = field.array(np.arange(1, 301, dtype=np.int64), 'cpu')
    y = field.array(np.arange(7, 307, dtype=np.int64), 'cpu')
    sx = thresha.np_random_split(field, x, t, m, rng)
    sy = thresha.np_random_split(field, y, t, m, rng)
    step = tpipe.make_reshare_step(P, t, m, fuse_mul=True)
    out, _ = step(sx.data, sy.data, tkeccak.state_tensor(_state(), 'cpu'),
                  np.zeros(2, np.uint32))
    for first in (0, m - t - 1):
        pts = [(i + 1, field.array.from_data(out[i]))
               for i in range(first, first + t + 1)]
        got = thresha.np_recombine(field, pts).value
        want = np.arange(1, 301, dtype=object) * np.arange(7, 307)
        assert [int(v) for v in got] == list(want)
