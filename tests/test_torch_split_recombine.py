"""Port's split/recombine round (mpyc_tpu_torch.models.pipelines
make_split_recombine, kernel K4's plain version on the CPU) against the
JAX package's make_split_recombine (XLA) on the same secrets and state.

A round trip returns its input whatever it computes in between, so the
shares are checked too: they are the Horner rows, at x = 1..m, of the
coefficients that the JAX package's rng.squeeze_mont draws from the
state. Tolerance: exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu.models import pipelines as jpipe
from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu.ops import rng as jrng
from mpyc_tpu_torch.models import pipelines as tpipe
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops import limb as tlimb
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


def _state() -> np.ndarray:
    hi, lo = jkeccak._absorb_host(bytes(range(200, 232)) + bytes(8))
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


def _secrets(n, seed):
    g = np.random.default_rng(seed)
    lo = g.integers(0, 1 << 32, n, dtype=np.uint64)
    hi = g.integers(0, P >> 32, n, dtype=np.uint64)
    return np.stack([lo, hi], -1).astype(np.uint32)


@pytest.mark.parametrize('n', [1000, 64])
def test_round_matches_jax_and_returns_its_input(n):
    sec, st = _secrets(n, n), _state()
    want = np.asarray(jpipe.make_split_recombine(P, 1, 3)(
        jnp.asarray(sec), jnp.asarray(st)))
    step = tpipe.make_split_recombine(P, 1, 3)
    got = limbs_to_numpy(step(limbs_from_numpy(sec, 'cpu'),
                              tkeccak.state_tensor(st, 'cpu')))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sec)


@pytest.mark.parametrize('t, m', [(1, 3), (2, 5)])
def test_shares_are_horner_rows_of_the_jax_stream(t, m):
    n = 1000
    sec, st = _secrets(n, 7), _state()
    coefs = np.asarray(jrng.squeeze_mont(jnp.asarray(st), t * n, 16, P))
    c = tlimb.limbs_to_ints(coefs).reshape(t, n)
    s = tlimb.limbs_to_ints(sec)
    shares = torch.empty((m, n, 2), dtype=torch.int32)
    spec = tpipe.SplitSpec(P, t, m)
    out = tpipe.split_recombine(limbs_from_numpy(sec, 'cpu'),
                                tkeccak.state_tensor(st, 'cpu'), spec,
                                shares=shares)
    np.testing.assert_array_equal(limbs_to_numpy(out), sec)
    got = tlimb.limbs_to_ints(limbs_to_numpy(shares))
    for j in range(1, m + 1):
        y = np.zeros(n, dtype=object)
        for k in range(t):
            y = (y + c[k]) * j
        # Montgomery form is linear: mont(c) * j + mont(s) = mont(c j + s)
        assert list(got[j - 1]) == list((y + s) % P)


def test_round_refuses_bad_shapes():
    spec = tpipe.SplitSpec(P, 1, 3)
    st = tkeccak.state_tensor(_state(), 'cpu')
    with pytest.raises(ValueError):
        tpipe.split_recombine(torch.zeros((10, 3), dtype=torch.int32), st,
                              spec)
    with pytest.raises(ValueError):
        tpipe.split_recombine(torch.zeros((10, 2), dtype=torch.int32), st,
                              spec, shares=torch.zeros((3, 9, 2),
                                                       dtype=torch.int32))
    with pytest.raises(ValueError):
        tpipe.SplitSpec(P, 3, 3)
