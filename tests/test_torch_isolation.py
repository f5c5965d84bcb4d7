"""The port and chip_smoke.py run without JAX and without mpyc_tpu.

The card's machine has no JAX. In a fresh interpreter whose imports of
jax, jaxlib and mpyc_tpu (the package or any module of it, but not
mpyc_tpu_torch) raise, chip_smoke is imported and the port's paths run on
the CPU: the main path at 4096 elements, the comparison at 300, the
split/recombine round at 4096, the BNN runner's selftest at a batch of
4 (SecInt(14) input, matmul, sign, argmax), the SecInt(64) product at 500,
the CNN runner's selftest at a batch of 2 (SecInt(37) input, im2col
matmuls, maxpool, ReLU, argmax), random bits and a truncation at
SecFxp(14, 6) on 500 values, the CNN runner's fixed-point selftest at
a batch of 2 (PRSS, truncated matmuls, comparisons at 2^6), SHA3-256 and
SHAKE128 of 2 messages (GF(4) products) and AES-128 of 2 blocks (GF(2^8)
powers, bits and public matrices), the fixed-point LP solver on tb2x2
(SecFxp(18): prime-field bits, the Newton reciprocal, unit vectors), and
the survival test's logrank statistic on three time steps at SecFxp(40,
20) (one batched division) and a random unit vector, the ID3 tree of
tennis (np_prod, reciprocals, argmax with a key, is_zero_public) and
np_sort, np_amax, np_amin of 19 values with sorted of 5 shuffled ones.
In a second such interpreter the co-located demos' modules and runners
run: chip_smoke's phase "co-located demos" at small sizes (a Secret
Santa of 5, unit vectors of 12 over GF(13) and SecInt(32), a secure list
of 9, GF(1031) and GF(2^31 - 1) at 40 elements), mpctools, secure random,
the runners of secretsanta, unanimous, PrefixOrExplained,
indextounitvector and sort. In a third, with pandas and scikit-learn
blocked too, the linear algebra's: chip_smoke's phase "linear algebra"
at small sizes (the small runners, ridge regression, the 5 x 5
pseudoinverse, one measurement of multilateration), a dataset read and a
conversion into a wide field."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent('''
    import importlib.abc, sys

    BLOCKED = ('jax', 'jaxlib', 'mpyc_tpu')

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + '.') for b in BLOCKED):
                raise ImportError('blocked import: ' + name)
            return None

    sys.meta_path.insert(0, Block())
    for name in list(sys.modules):
        if any(name == b or name.startswith(b + '.') for b in BLOCKED):
            del sys.modules[name]

    import chip_smoke
    res = chip_smoke.run_main_path('cpu', n_small=4096, n_big=4096,
                                   rounds=2, sample=512)
    chip_smoke.run_compare('cpu', n=300, calls=0)
    chip_smoke.run_split_recombine('cpu', n=4096, rounds=2)
    chip_smoke.run_selftest('cpu', batch=4)
    chip_smoke.run_wide('cpu', n=500)
    chip_smoke.run_cnn_selftest('cpu', batch=2)
    chip_smoke.run_fxp_rounds('cpu', n=500)
    from mpyc_tpu_torch.demos import np_cnnmnist
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    rt = SimRuntime(3, device='cpu')
    _, checks = np_cnnmnist.selftest_fxp(rt, rt.SecFxp(14, 6), 2)
    assert all(c['bad'] == 0 for c in checks.values()), checks
    chip_smoke.run_sha3('cpu', b=2, passes=1)
    chip_smoke.run_aes('cpu', nb=2, passes=1, only128=True)
    chip_smoke.run_lp_fxp('cpu', datasets=(2,))
    from mpyc_tpu_torch import random
    from mpyc_tpu_torch.demos import np_kmsurvival as km
    rt = SimRuntime(3, device='cpu')
    secfxp = rt.SecFxp(40, 20)
    table = ([1, 0, 2], [0, 1, 1], [5, 4, 4], [6, 6, 5])
    chi = km.logrank_test(rt, secfxp, *([secfxp(v) for v in col]
                                        for col in table))
    assert abs(chi - km.plain_logrank(*table)) < 1e-2, chi
    assert len(random.random_unit_vector(secfxp, 3)) == 3
    from mpyc_tpu_torch.demos import np_id3gini as id3
    tree, _, _ = id3.build(SimRuntime(3, device='cpu'), 0,
                           out=lambda s: None)
    assert tree == id3.plain_id3(0), tree
    chip_smoke.run_sort('cpu', n=19, n_sorted=5)
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
    assert not loaded, loaded
    print('OK', res['p'])
''')


def test_main_path_runs_without_jax_or_mpyc_tpu():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        'OK 18446744073709551427'


_COLOCATED = _SCRIPT.split('import chip_smoke')[0] + textwrap.dedent('''
    import chip_smoke
    res = chip_smoke.run_colocated('cpu', n_santa=5, n_unit=12, n_list=9,
                                   n_fld=40, defaults=False)
    from mpyc_tpu_torch import mpctools, random, seclists
    from mpyc_tpu_torch.demos import (PrefixOrExplained, indextounitvector,
                                      secretsanta, sort, unanimous)
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    rt = SimRuntime(3, device='cpu')
    assert secretsanta.run(rt, 3, 1, out=lambda s: None)['ok']
    assert unanimous.run(rt, [1, 0], out=lambda s: None)
    assert PrefixOrExplained.run(rt, 3, out=lambda s: None)['ok']
    assert indextounitvector.check_all(
        rt, 3, 'unit_vector', rt.unit_vector, rt.SecFld(min_order=4),
        out=lambda s: None)
    assert sort.demo_seclist_descending(rt, sort.ramp(3), out=lambda s: None)
    x = seclists.seclist([4, 5], rt.SecInt(32))
    assert [int(rt.output(v)) for v in mpctools.accumulate(x)] == [4, 9]
    assert 0 <= int(rt.output(random.randint(rt.SecInt(32), 0, 5))) <= 5
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
    assert not loaded, loaded
    print('OK', sorted(res)[0])
''')


def test_colocated_demos_run_without_jax_or_mpyc_tpu():
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _COLOCATED], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith('OK GF(1031)')


_LINALG = _SCRIPT.split('import chip_smoke')[0].replace(
    "BLOCKED = ('jax', 'jaxlib', 'mpyc_tpu')",
    "BLOCKED = ('jax', 'jaxlib', 'mpyc_tpu', 'pandas', 'sklearn')") + \
    textwrap.dedent('''
    import chip_smoke
    res = chip_smoke.run_linalg('cpu', alphas=(4,), datasets=(),
                                pinv=((5, 5, 5, 4, 1),), k_mlat=1, n=60,
                                d=3)
    from mpyc_tpu_torch.demos import ridgeregression
    X, d, e, _ = ridgeregression.load_dataset(
        ridgeregression.DATA + '/info-student-mat.csv')
    assert (len(X), d, e) == (395, 56, 1)
    from mpyc_tpu_torch.parallel.simulator import SimRuntime
    rt = SimRuntime(3, device='cpu')
    secint = rt.SecInt(32)
    x = rt.input(secint.array(__import__('numpy').arange(4)), senders=0)
    y = rt.convert(x, rt.SecFld(min_order=1 << 220, signed=True))
    assert [int(v) for v in rt.output(y).value] == [0, 1, 2, 3]
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
    assert not loaded, loaded
    print('OK', sorted(res)[0])
''')


def test_linear_algebra_runs_without_jax_pandas_or_sklearn():
    """The linear algebra's modules and runners (transfer, output to
    receivers, convert, np_det; helloworld, oneliners, parallelsort, ot,
    ridgeregression, pseudoinverse, multilateration) run with jax,
    mpyc_tpu, pandas and scikit-learn blocked (the card's machine has
    none of them): chip_smoke's phase "linear algebra" at small sizes,
    student-mat's files read with csv and zipfile, a conversion into a
    seven-limb field."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _LINALG], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == 'OK helloworld'


def test_port_sources_never_name_jax_or_mpyc_tpu():
    """No module of the port, nor chip_smoke.py, imports jax, mpyc_tpu,
    pandas or scikit-learn."""
    import re
    pat = re.compile(r'^\s*(from|import)\s+(jax|jaxlib|mpyc_tpu|pandas|'
                     r'sklearn)(\.|\s|$)', re.M)
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(REPO, 'mpyc_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


_RUNNERS = _SCRIPT.split('import chip_smoke')[0] + textwrap.dedent('''
    import importlib, pkgutil
    import mpyc_tpu_torch.demos as demos
    names = sorted(m.name for m in pkgutil.iter_modules(demos.__path__))
    mods = {n: importlib.import_module('mpyc_tpu_torch.demos.' + n)
            for n in names}
    from mpyc_tpu_torch.demos import helloworld, np_bnnmnist, parties
    assert helloworld.main(['--device', 'cpu', '-M', '5']) == 0
    assert np_bnnmnist.main(['--selftest', '--device', 'cpu', '-M', '5',
                             '-T', '1', '-b', '2']) == 0
    parser = __import__('argparse').ArgumentParser()
    parser.add_argument('--device')
    rt = parties.runtime(parties.parse_args(parser,
                                            ['-M', '7', '--device', 'cpu']))
    assert (len(rt.parties), rt.threshold, len(rt._prss_keys)) == \\
        (7, 3, 35)
    loaded = [m for m in sys.modules
              if any(m == b or m.startswith(b + '.') for b in BLOCKED)]
    assert not loaded, loaded
    print('OK', len(names))
''')


def test_runners_take_parties_without_jax_or_mpyc_tpu():
    """Every runner of mpyc_tpu_torch/demos imports with jax and mpyc_tpu
    blocked, and takes -M and -T through the one helper
    (``demos/parties.py``): helloworld at -M 5, the BNN's selftest at -M 5
    -T 1, the helper's runtime at m = 7 (t = 3, C(7, 4) PRSS keys). No
    runner makes a SimRuntime of its own."""
    env = dict(os.environ, OMP_NUM_THREADS='1')
    env.pop('PYTHONPATH', None)
    proc = subprocess.run([sys.executable, '-c', _RUNNERS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == 'OK 24'
    demos = os.path.join(REPO, 'mpyc_tpu_torch', 'demos')
    runners = []
    for name in sorted(n for n in os.listdir(demos) if n.endswith('.py')):
        with open(os.path.join(demos, name)) as fh:
            src = fh.read()
        if 'def main(' in src:
            runners.append(name)
            assert 'parties.runtime(args)' in src, name
            assert 'parties.parse_args(parser, argv)' in src, name
            assert 'SimRuntime(' not in src.replace('``SimRuntime(3)``', ''), \
                name
    assert len(runners) == 22
