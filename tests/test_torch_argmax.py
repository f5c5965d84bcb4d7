"""The BNN's remaining operations on the port's co-located plane, opened
against numpy: np_sum, np_argmax and np_argmin (ties included: the first
occurrence wins), the local shape operations they use, the call-time bit
length of comparisons, and the runner
(``mpyc_tpu_torch/demos/np_bnnmnist.py``): its selftest and its plaintext
model of the protocol.

All on ``SimRuntime(3, device='cpu')`` at SecInt(14), the BNN's type; on
the CPU the comparisons run K5's plain version and the products K3's.

Tolerance: exact equality (integers)."""
import numpy as np
import pytest
import torch

from mpyc_tpu_torch.demos import np_bnnmnist as bnn
from mpyc_tpu_torch.parallel.simulator import SimRuntime


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def rt():
    r = SimRuntime(3, device='cpu')
    r.start()
    yield r
    r.shutdown()


def _ties(shape, seed):
    """Small values with many ties, a row of equal values and a row with
    its maximum and minimum at both ends."""
    g = np.random.default_rng(seed)
    x = g.integers(-4, 5, shape)
    x[0] = 3
    x[-1, 0] = x[-1, -1] = 9
    if shape[1] > 2:
        x[-1, 1] = x[-1, -2] = -9
    return x


@pytest.mark.parametrize('axis', [None, 0, 1, -1, (0, 1)])
@pytest.mark.parametrize('keepdims', [False, True])
def test_np_sum(rt, axis, keepdims):
    secint = rt.SecInt(14)
    x = np.random.default_rng(1).integers(-100, 100, (5, 7))
    X = rt.input(secint.array(x))[0]
    got = rt.output(rt.np_sum(X, axis=axis, keepdims=keepdims))
    np.testing.assert_array_equal(got, np.sum(x, axis=axis,
                                              keepdims=keepdims))


@pytest.mark.parametrize('cols', [1, 2, 3, 5, 10])
def test_np_argmax_rows_with_ties(rt, cols):
    """The BNN's batched argmax, (rows, cols) along axis 1; np.argmax
    picks the first occurrence of a maximum, and so must the protocol."""
    secint = rt.SecInt(14)
    x = _ties((6, cols), cols)
    X = rt.input(secint.array(x))[0]
    np.testing.assert_array_equal(rt.output(rt.np_argmax(X, axis=1)),
                                  np.argmax(x, axis=1))
    np.testing.assert_array_equal(rt.output(rt.np_argmin(X, axis=1)),
                                  np.argmin(x, axis=1))


def test_np_argmax_options(rt):
    """axis None (a secure number, as in the JAX package: it opens to an
    int) and 0, keepdims, the maxima (arg_only=False) and unit vectors
    (arg_unary)."""
    secint = rt.SecInt(14)
    x = _ties((4, 5), 7)
    X = rt.input(secint.array(x))[0]
    got = rt.output(rt.np_argmax(X))
    assert isinstance(got, int) and got == np.argmax(x)
    np.testing.assert_array_equal(
        rt.output(rt.np_argmax(X, axis=0, keepdims=True)),
        np.argmax(x, axis=0, keepdims=True))
    u, m = rt.np_argmax(X, axis=1, arg_only=False, keepdims=True)
    np.testing.assert_array_equal(rt.output(u),
                                  np.argmax(x, axis=1, keepdims=True))
    np.testing.assert_array_equal(rt.output(m), x.max(axis=1,
                                                      keepdims=True))
    unit = rt.output(rt.np_argmax(X, axis=1, arg_unary=True))
    np.testing.assert_array_equal(unit, np.eye(5, dtype=np.int64)[
        np.argmax(x, axis=1)])


def test_shape_operations(rt):
    """reshape, swapaxes, expand_dims, concatenate, stack (public arrays
    as constant sharings), indexing, and shape, size and ndim."""
    secint = rt.SecInt(14)
    x = np.arange(24).reshape(2, 3, 4) - 12
    X = rt.input(secint.array(x))[0]
    assert (X.shape, X.size, X.ndim) == ((2, 3, 4), 24, 3)
    checks = [
        (rt.np_reshape(X, (4, -1)), x.reshape(4, -1)),
        (rt.np_swapaxes(X, 0, -1), x.swapaxes(0, -1)),
        (rt.np_expand_dims(X, (0, -1)), np.expand_dims(x, (0, -1))),
        (rt.np_concatenate([X, x], axis=-1), np.concatenate([x, x], -1)),
        (rt.np_stack([X[0], x[1]], axis=-1), np.stack([x[0], x[1]], -1)),
        (X[1, ::2, 1:], x[1, ::2, 1:]),
        (X[:, 1], x[:, 1]),
    ]
    for Y, want in checks:
        assert Y.shape == want.shape
        np.testing.assert_array_equal(rt.output(Y), want)


def test_bit_length_is_read_at_call_time(rt):
    """The demo reassigns secint.bit_length around its hidden layers'
    signs: a comparison at l = 10 of a value beyond 2^10 gives
    -floor(a / 2^10), at l = 14 the sign bit."""
    secint = rt.SecInt(14)
    v = np.array([3000, -3000, 5, -5])
    X = rt.input(secint.array(v))[0]
    secint.bit_length = 10
    try:
        lt10 = rt.output(rt.np_sgn(X, LT=True))
    finally:
        secint.bit_length = 14
    np.testing.assert_array_equal(lt10, -(v >> 10))
    np.testing.assert_array_equal(rt.output(rt.np_sgn(X, LT=True)), v < 0)


def test_selftest_runner_matches_numpy():
    """The runner's --selftest on the CPU: the 64-32-10 network's
    predictions equal the numpy forward pass; one reshare per matmul,
    one comparison step, and the argmax's four comparisons and eight
    products: 15 fused steps."""
    rt = SimRuntime(3, device='cpu')
    got, expect = bnn.selftest(rt, rt.SecInt(14), 6)
    np.testing.assert_array_equal(got, expect)
    assert rt._fused_ctr.tolist() == [15, 0]
    assert bnn.main(['--selftest', '--device', 'cpu', '-b', '2']) == 0


def test_plaintext_model_follows_the_protocol():
    """plain_sign, plain_less and plain_argmax are the protocol's integer
    semantics: equal to the sign and np.argmax inside the comparison's
    range, and to -floor(d / 2^l) beyond it (the rule
    tests/test_torch_sgn_step.py holds the JAX step to)."""
    z = np.array([-(1 << 14) - 1, -(1 << 14), -1, 0, (1 << 14) - 1, 1 << 14,
                  25986, -27486])
    np.testing.assert_array_equal(bnn.plain_sign(z, 14),
                                  [-3, -1, -1, 1, 1, 3, 3, -3])
    np.testing.assert_array_equal(bnn.plain_less(z, 0, 14), -(z >> 14))
    x = _ties((50, 10), 3) * 100
    np.testing.assert_array_equal(bnn.plain_argmax(x, 14),
                                  np.argmax(x, axis=1))
