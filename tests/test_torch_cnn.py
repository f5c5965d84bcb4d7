"""The CNN of ``demos/cnnmnist.py`` on the port, against the JAX package.

A CNN of the demo's structure at a small size (two 8 x 8 images at 2^6;
conv 5x5 1 -> 2, maxpool, conv 5x5 2 -> 2, maxpool, fc 8 -> 4, fc 4 -> 3;
random small integer weights and biases, so every comparison's operands
fit its bit length) at SecInt(37), a 69-bit field of three limbs. The
JAX package's own demo functions (``conv2d``, ``maxpool``, ``relu`` of
``demos/cnnmnist.py``) run on its ``SimRuntime(3)`` on the CPU, the port's
runner (``mpyc_tpu_torch/demos/np_cnnmnist.py``) on ``SimRuntime(3,
device='cpu')``, with the bit length set to 16, 23, 30 and 37 between the
layers as the demo sets it. Every stage opens to the same values in both,
and to the runner's int64 model (``plain_stages``). On the CPU the JAX
package compares fields of more than 32 bits on its eager plane, with
randomness of its own, so the shares differ and the openings are what is
held equal.

Also: the shape operations the CNN needs (``np_transpose``,
``np_where``, ``np_concatenate`` and ``np_stack`` with public numpy
operands, strided ``np_getitem``) opened against numpy; the runner's
selftest; and its int64 model on the published weights (MNIST test
images 0-99).

Tolerance: exact equality (integers)."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mpyc_tpu import sectypes as jsectypes
from mpyc_tpu.parallel.simulator import SimRuntime as JaxSim
from mpyc_tpu.runtime import _Options
from mpyc_tpu_torch.demos import np_cnnmnist as cnn
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'demos', 'cnnmnist.py')


def _jax_demo():
    """demos/cnnmnist.py as a module of its own (its functions call the
    module's ``mpc``, which the test points at a JAX SimRuntime)."""
    spec = importlib.util.spec_from_file_location('jax_cnnmnist_demo', DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _network(seed=3, batch=2):
    gen = np.random.default_rng(seed)
    sweights = {name: (W.astype(object), b.astype(object)) for name, (W, b)
                in cnn.random_cnn(gen, 8, 2, 2, 4, 3).items()}
    x = gen.integers(0, 1 << cnn.F, (batch, 1, 8, 8)).astype(object)
    return x, sweights


def _stages(rt, mod, secint, x, sweights):
    """The network's stages through runtime rt with the layer functions of
    mod (conv2d, maxpool, relu taking the runtime or not), opened."""
    conv2d, maxpool = mod['conv2d'], mod['maxpool']
    S = {name: (secint.array(W), secint.array(b))
         for name, (W, b) in sweights.items()}
    out = {}
    X = secint.array(x)
    try:
        for i, name in enumerate(('conv1', 'conv2')):
            X = conv2d(X, *S[name])
            out[name] = rt.output(X)
            secint.bit_length = cnn.L_AFTER[name]
            X = cnn.relu(maxpool(X))
            out[f'pool{i + 1}'] = rt.output(X)
        X = rt.np_reshape(X, (X.shape[0], -1))
        X = X @ S['fc1'][0] + S['fc1'][1]
        out['fc1'] = rt.output(X)
        secint.bit_length = cnn.L_AFTER['fc1']
        X = cnn.relu(X)
        out['relu3'] = rt.output(X)
        X = X @ S['fc2'][0] + S['fc2'][1]
        out['fc2'] = rt.output(X)
        secint.bit_length = cnn.L_TYPE
        out['argmax'] = rt.output(rt.np_argmax(X, axis=1))
    finally:
        secint.bit_length = cnn.L_TYPE
    return {k: np.asarray(v).astype(np.int64) for k, v in out.items()}


@pytest.fixture(scope='module')
def jax_stages():
    """The JAX package's stages (its runtime wired into its type layer for
    the run, the package's own runtime wired back after)."""
    x, sweights = _network()
    mod = _jax_demo()
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        try:
            jr.start()
            mp.setattr(mod, 'mpc', jr)
            js = jr.SecInt(cnn.L_TYPE)
            yield _stages(jr, {'conv2d': mod.conv2d,
                               'maxpool': mod.maxpool}, js, x, sweights)
            jr.shutdown()
        finally:
            if old is not None:
                old._wire_modules()


@pytest.fixture(scope='module')
def torch_stages():
    x, sweights = _network()
    rt = TorchSim(3, device='cpu')
    rt.start()
    secint = rt.SecInt(cnn.L_TYPE)
    assert secint.field.modulus.bit_length() == 69
    res = _stages(rt, {'conv2d': lambda *a: cnn.conv2d(rt, *a),
                       'maxpool': lambda X: cnn.maxpool(rt, X)},
                  secint, x, sweights)
    rt.shutdown()
    return res


STAGES = ('conv1', 'pool1', 'conv2', 'pool2', 'fc1', 'relu3', 'fc2',
          'argmax')


@pytest.mark.parametrize('stage', STAGES)
def test_tiny_cnn_stage_opens_as_in_the_jax_package(jax_stages,
                                                    torch_stages, stage):
    np.testing.assert_array_equal(torch_stages[stage], jax_stages[stage])


@pytest.mark.parametrize('stage', STAGES)
def test_tiny_cnn_stage_opens_to_the_int64_model(torch_stages, stage):
    x, sweights = _network()
    np.testing.assert_array_equal(torch_stages[stage],
                                  cnn.plain_stages(x, sweights)[stage])


def test_tiny_cnn_secure_forward_gives_the_models_predictions():
    """The runner's secure_forward on the same network, its pixels public
    and then input by a party: the int64 model's predictions."""
    x, sweights = _network()
    rt = TorchSim(3, device='cpu')
    secint = rt.SecInt(cnn.L_TYPE)
    slayers = cnn.secure_layers(secint, sweights)
    want = cnn.plain_forward(x, sweights)
    for X in (secint.array(x), rt.input(secint.array(x), senders=1)):
        np.testing.assert_array_equal(
            cnn.secure_forward(rt, secint, X, slayers), want)
        assert secint.bit_length == cnn.L_TYPE


@pytest.fixture(scope='module')
def rt():
    r = TorchSim(3, device='cpu')
    r.start()
    yield r
    r.shutdown()


def test_shape_operations_of_the_cnn(rt):
    """np_transpose (axes given and reversed), np_concatenate and np_stack
    with public object-dtype numpy operands, strided and Ellipsis
    indexing: opened against numpy, no protocol round."""
    secint = rt.SecInt(cnn.L_TYPE)
    g = np.random.default_rng(4)
    x = g.integers(-(1 << 40), 1 << 40, (2, 3, 4, 5))
    X = rt.input(secint.array(x.astype(object)))[0]
    ctr = rt._fused_ctr.copy()
    z = np.zeros((2, 3, 1, 5), dtype=object)
    cases = [
        (rt.np_transpose(X, (0, 2, 3, 1)), x.transpose(0, 2, 3, 1)),
        (rt.np_transpose(X), x.transpose()),
        (rt.np_concatenate((z, X, z), axis=2),
         np.concatenate((z, x, z), axis=2)),
        (rt.np_stack([X[:, :, 1:3, :], np.ones((2, 3, 2, 5), dtype=object)],
                     axis=2), np.stack([x[:, :, 1:3, :],
                                        np.ones((2, 3, 2, 5))], axis=2)),
        (X[:, :, ::2, :], x[:, :, ::2, :]),
        (X[:, :, :, 1::2], x[:, :, :, 1::2]),
        (X[..., 1], x[..., 1]),
        (X[1, ..., ::3], x[1, ..., ::3]),
    ]
    for got, want in cases:
        assert got.shape == want.shape
        np.testing.assert_array_equal(rt.output(got), want.astype(np.int64))
    np.testing.assert_array_equal(rt._fused_ctr, ctr)


def test_np_where_is_one_secure_product(rt):
    """np_where(c, a, b) = c (a - b) + b: one reshare round; maxpool's
    np_where(a >= b, a, b) is the maximum."""
    secint = rt.SecInt(cnn.L_TYPE)
    g = np.random.default_rng(5)
    a = g.integers(-1000, 1000, (4, 6))
    b = g.integers(-1000, 1000, (4, 6))
    b[0] = a[0]
    A, B = (rt.input(secint.array(v))[0] for v in (a, b))
    C = rt.input(secint.array(g.integers(0, 2, (4, 6))))[0]
    c = rt.output(C)
    ctr = int(rt._fused_ctr[0])
    got = rt.output(rt.np_where(C, A, B))
    assert int(rt._fused_ctr[0]) == ctr + 1
    np.testing.assert_array_equal(got, np.where(c == 1, a, b))
    np.testing.assert_array_equal(rt.output(rt.np_where(A >= B, A, B)),
                                  np.maximum(a, b))


def test_runner_selftest():
    rt = TorchSim(3, device='cpu')
    got, expect = cnn.selftest(rt, rt.SecInt(cnn.L_TYPE), 3)
    np.testing.assert_array_equal(got, expect)


def test_int64_model_on_the_published_weights():
    """MNIST test images 0-99 through the int64 model of the protocol: 99
    of 100 correct, every comparison within its bit length (the demo's
    widths hold on these images), and the float model's predictions but
    for the images where the two round differently."""
    labels, images = cnn.load_mnist(0, 100)
    weights = cnn.load_weights()
    sweights = cnn.scaled_weights(weights)
    st = cnn.plain_stages(cnn.images_int(images), sweights)
    assert int((st['argmax'] == labels).sum()) == 99
    for name, l in cnn.L_AFTER.items():
        assert np.abs(st[name]).max() < 1 << l
    assert np.abs(st['fc2']).max() < 1 << cnn.L_TYPE
    floats = np.argmax(cnn.float_forward(images.reshape(-1, 1, 28, 28)
                                         / 255, weights), axis=1)
    assert int((st['argmax'] == floats).sum()) >= 99
