"""Port's counter-mode SHAKE128 (mpyc_tpu_torch.ops.keccak) against the JAX
package's (mpyc_tpu.ops.keccak) and hashlib, on the same inputs.

Tolerance: exact equality (bit patterns)."""
from hashlib import shake_128

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu.ops import keccak as jkeccak
from mpyc_tpu_torch.ops import keccak as tkeccak
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_state(data: bytes) -> np.ndarray:
    hi, lo = jkeccak._absorb_host(data)
    return np.stack([np.array(hi, np.uint32), np.array(lo, np.uint32)])


@pytest.mark.parametrize('data', [b'', b'abc', b'k' * 40, b'x' * 167,
                                  b'y' * 168, b'z' * 400])
def test_absorb_matches_jax(data):
    np.testing.assert_array_equal(tkeccak._absorb_host(data),
                                  _jax_state(data))


@pytest.mark.parametrize('prefix,n', [
    (p, n) for p in (b'', b'p' * 17, bytes(range(40)), b'q' * 144)
    for n in (5, 300)] + [(bytes(range(40)), 1030)])
def test_ctr_blocks_match_jax_and_hashlib(prefix, n):
    """hashlib path (n <= 256) and plain permutation (larger n) agree with
    the JAX package's shake128_ctr_blocks (its host path up to 512
    instances, its XLA squeeze above) and with hashlib."""
    got = limbs_to_numpy(tkeccak.shake128_ctr_blocks(prefix, n, 'cpu'))
    want = np.asarray(jkeccak.shake128_ctr_blocks(prefix, n))
    np.testing.assert_array_equal(got, want)
    pad = (-len(prefix)) % 8
    for j in (0, n // 2, n - 1):
        msg = prefix + bytes(pad) + j.to_bytes(8, 'little')
        assert got[j].astype('<u4').tobytes() == shake_128(msg).digest(168)


@pytest.mark.parametrize('ctr_lane,base', [(19, 0), (5, 1000), (4, 7)])
def test_keccak_ctr_plain_matches_jax_squeeze(ctr_lane, base):
    """K1's plain version equals the JAX package's XLA squeeze with a
    counter offset (the form its Pallas kernel is held to)."""
    st = _jax_state(b'key' * 11 + bytes(8))
    want = np.asarray(jkeccak._squeeze_ctr(jnp.asarray(st), 64, ctr_lane,
                                           base))
    got = tkeccak.keccak_ctr(tkeccak.state_tensor(st, 'cpu'), 64, ctr_lane,
                             base)
    np.testing.assert_array_equal(limbs_to_numpy(got), want)


def test_keccak_ctr_rejects_bad_arguments():
    st = tkeccak.state_tensor(_jax_state(b''), 'cpu')
    with pytest.raises(ValueError):
        tkeccak.keccak_ctr(st.to(torch.int64), 4, 19)
    with pytest.raises(ValueError):
        tkeccak.keccak_ctr(st, 4, 21)
