"""The fixed-point path of ``demos/cnnmnist.py`` on the port, against the
JAX package.

A CNN of the demo's structure at a small size (two 8 x 8 images; conv 5x5
1 -> 2, maxpool, conv 5x5 2 -> 2, maxpool, fc 8 -> 4, fc 4 -> 3; random
float weights and biases) at SecFxp(14, 6), a 52-bit field of two limbs.
The JAX package's own demo functions (``conv2d``, ``maxpool``, ``relu`` of
``demos/cnnmnist.py``) run on its ``SimRuntime(3)`` on the CPU, the port's
runner (``mpyc_tpu_torch/demos/np_cnnmnist.py``) on ``SimRuntime(3,
device='cpu')``, the pixels, weights and biases public-valued fixed-point
arrays as the demo makes them.

Every convolution and fc layer truncates its product with PRSS random
bits, so its opened output depends on its input value and on those bits
alone: before each such layer the port takes the JAX runtime's PRSS keys
and program counter at the same point (``load_state``). Then every stage
opens to the same values in both, though the JAX package compares a
52-bit field on its eager plane on the CPU (with PRSS randomness of its
own, which moves its program counter) and the port with its fused step.
Every stage of the port's pass also passes the runner's stage-local check
(``check_fxp_stages``), and so does its fixed-point selftest.

Tolerance: exact equality (fixed-point values, exact in float64)."""
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
    spec = importlib.util.spec_from_file_location('jax_cnnmnist_fxp', DEMO)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _network(seed=5, batch=2):
    gen = np.random.default_rng(seed)
    weights = cnn.random_fxp_cnn(gen, 8, 2, 2, 4, 3)
    x = gen.integers(0, 256, (batch, 1, 8, 8)) / 255
    return x, weights


def _stages(rt, layers, sfx, x, weights, before_product):
    """The network's stages through runtime rt with the layer functions
    ``layers`` (conv2d, maxpool), opened; ``before_product()`` runs before
    each convolution and fc layer."""
    conv2d, maxpool = layers['conv2d'], layers['maxpool']
    S = {name: (sfx.array(W), sfx.array(b))
         for name, (W, b) in weights.items()}
    out = {}
    X = sfx.array(x)
    for i, name in enumerate(('conv1', 'conv2')):
        before_product()
        X = conv2d(X, *S[name])
        out[name] = rt.output(X)
        X = cnn.relu(maxpool(X))
        out[f'pool{i + 1}'] = rt.output(X)
    X = rt.np_reshape(X, (X.shape[0], -1))
    before_product()
    X = X @ S['fc1'][0] + S['fc1'][1]
    out['fc1'] = rt.output(X)
    X = cnn.relu(X)
    out['relu3'] = rt.output(X)
    before_product()
    X = X @ S['fc2'][0] + S['fc2'][1]
    out['fc2'] = rt.output(X)
    out['argmax'] = rt.output(rt.np_argmax(X, axis=1))
    return {k: np.asarray(v).astype(np.float64) for k, v in out.items()}


@pytest.fixture(scope='module')
def both_stages():
    """The JAX package's stages, recording its randomness state before each
    product layer, then the port's, loading that state there (the JAX
    runtime wired into its type layer for the run, the package's own
    runtime wired back after)."""
    x, weights = _network()
    mod = _jax_demo()
    old = jsectypes.runtime
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('MPYC_TPU_CACHE', '0')
        jr = JaxSim(3, _Options())
        jr._wire_modules()
        try:
            jr.start()
            mp.setattr(mod, 'mpc', jr)
            states = []
            js = _stages(jr, {'conv2d': mod.conv2d, 'maxpool': mod.maxpool},
                         jr.SecFxp(cnn.L_FXP, cnn.F), x, weights,
                         lambda: states.append(
                             (dict(jr._prss_keys), jr._program_counter[0])))
            jr.shutdown()
        finally:
            if old is not None:
                old._wire_modules()
    rt = TorchSim(3, device='cpu')
    rt.start()
    replay = iter(states)

    def load():
        keys, pc = next(replay)
        rt.load_state(rt._fused_key, rt._fused_ctr, rt._rng.key,
                      rt._rng._nonce, prss_keys=keys, pc=pc)

    sfx = rt.SecFxp(cnn.L_FXP, cnn.F)
    assert sfx.field.modulus.bit_length() == 52
    ts = _stages(rt, {'conv2d': lambda *a: cnn.conv2d(rt, *a),
                      'maxpool': lambda X: cnn.maxpool(rt, X)},
                 sfx, x, weights, load)
    rt.shutdown()
    return js, ts


@pytest.mark.parametrize('stage', cnn.STAGES)
def test_tiny_fxp_cnn_stage_opens_as_in_the_jax_package(both_stages, stage):
    js, ts = both_stages
    np.testing.assert_array_equal(ts[stage], js[stage])


@pytest.mark.parametrize('stage', cnn.STAGES)
def test_tiny_fxp_cnn_stage_passes_the_stage_local_check(both_stages,
                                                         stage):
    x, weights = _network()
    _, ts = both_stages
    checks = cnn.check_fxp_stages(x, weights, ts)
    assert checks[stage]['bad'] == 0 and checks[stage]['n'] > 0


def test_stage_local_check_finds_a_wrong_stage(both_stages):
    """The check is not vacuous: a truncation off by two (up or down,
    whichever way the bits rounded it), a maxpool entry changed, a
    different argmax each fail."""
    x, weights = _network()
    _, ts = both_stages
    for name, delta in (('conv2', 2 / 64), ('pool1', 1 / 64),
                        ('fc2', -2 / 64), ('argmax', 1.0)):
        bad = dict(ts)
        bad[name] = ts[name].copy()
        bad[name].flat[0] += delta
        checks = cnn.check_fxp_stages(x, weights, bad)
        assert checks[name]['bad'] >= 1, name


def test_runner_fxp_selftest():
    """The runner's fixed-point selftest: pixels input by party 1 at
    SecFxp(14, 6), random float weights; every stage passes the check."""
    rt = TorchSim(3, device='cpu')
    preds, checks = cnn.selftest_fxp(rt, rt.SecFxp(cnn.L_FXP, cnn.F), 3)
    assert preds.shape == (3,)
    assert all(c['bad'] == 0 for c in checks.values()), checks
