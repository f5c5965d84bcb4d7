"""The one-way hash chains on the port, against the JAX package's demo.

* The port's copy of the pebbling scheduler (``mpyc_tpu_torch/demos/
  pebbling.py``) against ``demos/pebbling.py``: for k = 1-6, optimal
  and eager, the same outputs round by round (None in the forward
  stage, then the chain in reverse) and the same ``.stats`` (k 2^(k-1)
  hashes, the round peak), over a plain chain of ints.
* The runner's plain AES-128 against FIPS-197 C.1.
* The runner (``mpyc_tpu_torch.demos.np_onewayhashchains``) at k = 2
  with --no-random-seed prints the JAX demo's lines
  (``demos/np_onewayhashchains.py -M3 --sim``, subprocesses), by AES and
  by SHAKE128 (--sha3); from a random seed, and with the dummy one-way
  functions, every revealed value equals the plain chain's.

Tolerance: exact equality (printed lines, bytes).
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from mpyc_tpu_torch.demos import np_onewayhashchains as hc
from mpyc_tpu_torch.demos import pebbling
from mpyc_tpu_torch.parallel.simulator import SimRuntime as TorchSim

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_lines():
    """The JAX demo's lines at k = 2 with a fixed seed, by AES and by
    SHAKE128, both run in the background at once (no trace cache)."""
    env = dict(os.environ, JAX_PLATFORMS='cpu', MPYC_TPU_CACHE='0')
    res, threads = {}, []
    for name, extra in (('aes', []), ('sha3', ['--sha3'])):
        def run(name=name, extra=extra):
            proc = subprocess.run(
                [sys.executable, str(ROOT / 'demos' /
                                     'np_onewayhashchains.py'), '-M3',
                 '--sim', '-k', '2', '--no-random-seed', *extra], cwd=ROOT,
                env=env, capture_output=True, text=True, timeout=600)
            res[name] = (proc.returncode, proc.stdout.splitlines(),
                         proc.stderr[-2000:])
        th = threading.Thread(target=run, daemon=True)
        th.start()
        threads.append(th)

    def lines(name):
        for th in threads:
            th.join(600)
        return res[name]
    yield lines


def _jax_pebbling():
    spec = importlib.util.spec_from_file_location(
        'jax_demo_pebbling', ROOT / 'demos' / 'pebbling.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('eager', [False, True])
@pytest.mark.parametrize('k', [1, 2, 3, 4, 5, 6])
def test_pebbling_matches_the_jax_demos(k, eager):
    ref = _jax_pebbling()
    runs = []
    for mod in (ref, pebbling):
        make = mod.reverse_chain_eager if eager else mod.reverse_chain
        rev = make(k, 0, lambda x: x + 1)
        runs.append((list(rev), rev.stats.total, rev.stats.round_peak))
    assert runs[0] == runs[1]
    outputs, total, _ = runs[1]
    n = 1 << k
    assert outputs == [None] * (n - 1) + list(range(n - 1, -1, -1))
    assert total == k << (k - 1)


def test_plain_aes128_is_fips197():
    ct = hc.plain_aes128(bytes(range(16)),
                         bytes.fromhex('00112233445566778899aabbccddeeff'))
    assert ct.hex() == '69c4e0d86a7b0430d8cdb78070b4c55a'


@pytest.mark.parametrize('variant', ['aes', 'sha3'])
def test_runner_prints_the_jax_demos_lines(jax_lines, variant):
    out = io.StringIO()
    argv = ['-k', '2', '--no-random-seed', '--device', 'cpu']
    with contextlib.redirect_stdout(out):
        rc = hc.main(argv + (['--sha3'] if variant == 'sha3' else []))
    lines = out.getvalue().splitlines()
    assert rc == 0 and lines[-1].endswith(': True')
    j_rc, j_lines, err = jax_lines(variant)
    assert j_rc == 0, err
    assert lines[:-1] == j_lines


@pytest.mark.parametrize('k,eager,sha3,one_way', [
    (2, False, True, True), (3, True, False, False), (3, True, True, False),
    (1, False, False, True)])
def test_chain_from_a_random_seed_equals_the_plain_chain(k, eager, sha3,
                                                         one_way):
    rt = TorchSim(3, device='cpu')
    res = hc.run(rt, k, eager, sha3, one_way, out=lambda s: None)
    assert res['ok'] and res['hashes'] == k << (k - 1)
