"""The fixed-point slice at five parties (t = 2) on the port, against the
JAX package.

With the JAX ``SimRuntime(5)``'s PRSS keys (one a 3-subset, C(5, 3) = 10)
and program counter loaded into the port's (``load_state``),
``np_random_bits`` and ``_trunc_field`` give the same shares bit for bit
and leave the same program counter (the opening at 2t = 4 from five
parties, the tail that kernel K7 computes on the card); a truncated
SecFxp(14, 6) product through the port's operators opens to floor(v /
2^6) or one more. The BNN runner's selftest runs through its ``-M 5``.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import finfields as jfinfields
from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch import finfields
from mpyc_tpu_torch.ops.fieldops import limbs_to_numpy
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P52 = 4503599627370323        # SecFxp(14, 6)'s field: two limbs, 3 mod 4
F = 6
T, M = 2, 5


@pytest.fixture(scope='module')
def runtimes():
    """A JAX SimRuntime(5) at t = 2 (wired into the JAX package's type
    layer for the module, the package's own runtime wired back after) and
    the port's."""
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(M, _Options(threshold=T))
        jr._wire_modules()
        try:
            jr.start()
            yield jr, TorchSim(M, device='cpu', threshold=T)
            jr.shutdown()
        finally:
            if old is not None:
                old._wire_modules()


def _sync(jr, tr):
    """The port continues from the JAX runtime's randomness state."""
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce, prss_keys=jr._prss_keys,
                  pc=jr._program_counter[0])


def _same(jax_arr, torch_arr):
    np.testing.assert_array_equal(limbs_to_numpy(torch_arr.data),
                                  np.asarray(jax_arr.data))


def test_prss_subsets_at_five_parties(runtimes):
    jr, tr = runtimes
    assert jr.threshold == tr.threshold == T
    _sync(jr, tr)
    assert len(tr._prss_keys) == 10
    assert all(len(S) == M - T for S in tr._prss_keys)


@pytest.mark.parametrize('n', (7, 300))
def test_np_random_bits_match_the_jax_package(runtimes, n):
    """n = 7: the JAX package's host draws; 300: its device plane (the
    port: hashlib, then K1's plain version, the same bits)."""
    jr, tr = runtimes
    _sync(jr, tr)
    pc = jr._program_counter[0]
    got = tr.np_random_bits(finfields.GF(P52), n)
    want = jr.np_random_bits(jfinfields.GF(P52), n)
    assert got.shape == (M, n)
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0] == pc + 2
    bits = tr.output(got).value
    assert set(bits.tolist()) <= {0, 1}


@pytest.mark.parametrize('n', (7, 300))
def test_trunc_field_matches_the_jax_package(runtimes, n):
    """The same input shares (a fixed-point value at 2^12, l = 20) give
    the same truncated shares: f n random bits and one bounded draw."""
    jr, tr = runtimes
    g = np.random.default_rng(n + 5)
    x = g.integers(-(1 << 19), 1 << 19, n)
    X = tr._share(tr.input(tr.SecFxp(14, F).array(x / (1 << F)))[0])
    _sync(jr, tr)
    pc = jr._program_counter[0]
    got = tr._trunc_field(X, F, 14 + F)
    want = jr._trunc_field(
        jfinfields.GF(P52).array.from_data(
            jnp.asarray(limbs_to_numpy(X.data))), F, 14 + F,
        jsectypes.SecFxp(14, F))
    _same(want, got)
    assert tr._program_counter[0] == jr._program_counter[0] == pc + 3
    y = tr.output(got).signed()
    assert np.isin(y - np.floor_divide(x, 1 << F), (0, 1)).all()


def test_secfxp_product_truncates(runtimes):
    """A product of SecFxp(14, 6) values opens to floor(v / 2^6) or one
    more at 2^6, v the exact product at 2^12; a product by an integral
    operand is exact."""
    _, tr = runtimes
    s = tr.SecFxp(14, F)
    g = np.random.default_rng(44)
    a = g.integers(-(1 << 9), 1 << 9, 200)
    b = g.integers(-(1 << 9), 1 << 9, 200)
    A, B = tr.input(s.array(a / (1 << F)))[0], tr.input(s.array(b / (1 << F)))[1]
    got = np.round(tr.output(A * B) * (1 << F)).astype(np.int64)
    assert np.isin(got - np.floor_divide(a * b, 1 << F), (0, 1)).all()
    K = tr.input(s.array(np.arange(200) % 5 - 2))[2]
    got = np.round(tr.output(A * K) * (1 << F)).astype(np.int64)
    assert (got == a * (np.arange(200) % 5 - 2)).all()


def test_bnn_selftest_at_five_parties():
    """The BNN runner's selftest (SecInt(14) input, 64 -> 32 -> 10) at
    ``-M 5`` on the CPU: its predictions equal the plaintext forward pass
    (the runner exits 1 otherwise)."""
    from mpyc_tpu_torch.demos import np_bnnmnist
    assert np_bnnmnist.main(['--selftest', '--device', 'cpu', '-M', '5',
                             '-b', '2']) == 0
