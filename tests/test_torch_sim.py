"""The whole slice: the port's SimRuntime against the JAX package's.

Both runtimes are loaded with the same randomness state (fused reshare key
and counter, input generator key and nonce); then input, np_multiply and
output give bit-identical shares and equal opened values.

On the CPU the JAX package keeps field data in host numpy arrays and then
multiplies through its generic (unfused) plane; on its device it runs the
fused round. The test moves the JAX input shares to jax arrays, as they
are on the TPU, so that its SimRuntime takes the fused round the port
always takes.

Tolerance: exact equality (bit patterns of Montgomery limbs, integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
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


@pytest.fixture(scope='module')
def runtimes():
    # the JAX plane would export its traced steps into the repo's cache
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        yield from _runtimes()


def _runtimes():
    # the JAX runtime is wired into the JAX package's type layer for the
    # module, and the package's own runtime wired back after it: other
    # test files in this process use that one
    old = jsectypes.runtime
    jr = JaxSim(3, _Options())
    jr._wire_modules()
    jr.start()
    tr = TorchSim(3, device='cpu')
    tr.start()
    tr.load_state(jr._fused_key, np.zeros(2, np.uint32), jr._rng.key,
                  jr._rng._nonce)
    try:
        yield jr, tr
    finally:
        jr.shutdown()
        tr.shutdown()
        if old is not None:
            old._wire_modules()


def _same(jax_share, torch_share):
    np.testing.assert_array_equal(limbs_to_numpy(torch_share.data),
                                  np.asarray(jax_share.data))


def _on_jax_device(x):
    x.share = x.share.from_data(jnp.asarray(x.share.data))
    return x


@pytest.mark.parametrize('n', [100, 4096])
def test_input_multiply_output_bit_identical(runtimes, n):
    """n=100: host-drawn input coefficients; 4096: coefficients squeezed
    straight into the field (K2's plain version here)."""
    jr, tr = runtimes
    js, ts = jr.SecInt(32), tr.SecInt(32)
    assert js.field.modulus == ts.field.modulus
    gen = np.random.default_rng(n)
    a = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    b = gen.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    JA, JB = (jr.input(js.array(v.astype(object)))[0] for v in (a, b))
    TA, TB = (tr.input(ts.array(v))[0] for v in (a, b))
    _same(JA.share, TA.share)
    _same(JB.share, TB.share)
    assert tr._rng._nonce == jr._rng._nonce

    JC = jr.np_multiply(_on_jax_device(JA), _on_jax_device(JB))
    TC = tr.np_multiply(TA, TB)
    _same(JC.share, TC.share)
    JC = jr.np_multiply(JC, JB)            # chained: the counter advances
    TC = tr.np_multiply(TC, TB)
    _same(JC.share, TC.share)
    np.testing.assert_array_equal(tr._fused_ctr, np.asarray(jr._fused_ctr))

    got = tr.output(TC)
    assert got.dtype == np.int64 and got.shape == (n,)
    assert [int(v) for v in got] == [int(v) for v in jr.output(JC)]
    p = ts.field.modulus
    want = [int(x) * int(y) ** 2 % p for x, y in zip(a, b)]
    assert [int(v) % p for v in got] == want


@pytest.mark.parametrize('n', [100, 4096])
def test_secint14_input_output_bit_identical(runtimes, n):
    """SecInt(14), the BNN's type: its 46-bit field draws 22 bytes a
    value. n=100: host-drawn coefficients; 4096: blocks squeezed (K1's
    plain version here) and split byte by byte. Shares, nonce, a product's
    shares and the opened values equal the JAX package's."""
    jr, tr = runtimes
    js, ts = jr.SecInt(14), tr.SecInt(14)
    assert js.field.modulus == ts.field.modulus == 70368744177643
    gen = np.random.default_rng(n + 14)
    a = gen.integers(-(1 << 13), 1 << 13, n, dtype=np.int64)
    b = gen.integers(-(1 << 13), 1 << 13, n, dtype=np.int64)
    JA, JB = (jr.input(js.array(v.astype(object)))[0] for v in (a, b))
    TA, TB = (tr.input(ts.array(v))[0] for v in (a, b))
    _same(JA.share, TA.share)
    _same(JB.share, TB.share)
    assert tr._rng._nonce == jr._rng._nonce
    JC = jr.np_multiply(_on_jax_device(JA), _on_jax_device(JB))
    TC = tr.np_multiply(TA, TB)
    _same(JC.share, TC.share)
    assert [int(v) for v in tr.output(TA)] == [int(v) for v in jr.output(JA)]
    assert [int(v) for v in tr.output(TC)] == [int(x) * int(y)
                                              for x, y in zip(a, b)]


def test_small_product_opens_to_plaintext():
    """bench.py's in-run check (object arrays) on the port alone."""
    rt = TorchSim(3, device='cpu')
    rt.start()
    secint = rt.SecInt(32)
    a = np.arange(4096, dtype=object)
    b = (a * 7 + 1) % 9999
    A = rt.input(secint.array(a))[0]
    B = rt.input(secint.array(b))[0]
    assert A.share.shape == (3, 4096) and rt.input(secint.array(a),
                                                   senders=0).shape == (4096,)
    got = rt.output(rt.np_multiply(A, B))
    assert (got.astype(object) == a * b).all()
    assert list(rt._fused_ctr) == [1, 0]
    rt.shutdown()


def test_public_operand_broadcasts_over_parties():
    """An array not yet input is the constant polynomial of its values."""
    rt = TorchSim(3, device='cpu')
    secint = rt.SecInt(32)
    A = rt.input(secint.array(np.arange(-50, 50, dtype=np.int64)))[1]
    C = rt.np_multiply(A, secint.array(np.full(100, -3, dtype=np.int64)))
    assert list(rt.output(C)) == [-3 * v for v in range(-50, 50)]


def test_entry_points_default_to_the_card():
    """No device named: the card, or an error where torch sees none."""
    if torch.cuda.is_available():
        assert TorchSim(3).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no card'):
            TorchSim(3)
