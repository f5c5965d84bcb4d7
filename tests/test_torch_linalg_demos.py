"""The linear-algebra runners on the port, at small sizes on the CPU.

Each runner checks itself exactly and returns its verdict:

* ``ridgeregression`` on a synthetic set of 60 samples and 3 features at
  accuracy 4, forced into a nine-limb field (``--field-bits 257``):
  ``convert`` from SecInt, the blinded Bareiss ``linear_solve``; (adj A)
  B and det A equal a plain integer Bareiss elimination's, the train
  error within 0.2 of a plain ridge solve's; and its data loaders on the
  wine and student files (``csv``, ``zipfile``);
* ``pseudoinverse`` of the default 5 x 5 (the four Penrose equations mod
  p, ``np_det`` and the recursion's denominator equal, the rationals
  against ``numpy.linalg.pinv``);
* ``multilateration -k 2`` at SecInt(335), 12 limbs: each solve equal to
  the plain integer solve, the median error under 2,000 m.

Tolerance: exact equality (the train error and the location error by the
JAX demos' bounds, 0.2 and 2,000 m).
"""
import numpy as np
import pytest
import torch

from mpyc_tpu_torch.demos import multilateration, pseudoinverse
from mpyc_tpu_torch.demos import ridgeregression as ridge
from mpyc_tpu_torch.parallel.simulator import SimRuntime


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_):
    pass


def test_ridgeregression_in_a_nine_limb_field():
    rt = SimRuntime(3, device='cpu')
    res = ridge.run(rt, 0, (4,), n=60, d=3, e=1, field_bits=257, seed=2,
                    out=_quiet)
    r = res['solves'][4]
    assert res['ok'] and r['exact'] and r['L'] == 9
    assert abs(r['rel'][0]) < 0.2
    assert ridge.main(['-n', '40', '-d', '2', '-a', '6', '--device',
                       'cpu']) == 0


@pytest.mark.parametrize('dataset,shape', [(1, (395, 57)), (2, (1599, 12)),
                                           (3, (4898, 12))])
def test_ridgeregression_reads_the_datasets(dataset, shape):
    """The info files and their data (student-mat from ``student.zip``):
    the JAX demo's sizes (57 columns of student-mat with the intercept:
    its categorical features one-hot), every value finite."""
    name, _ = ridge.DATASETS[dataset]
    X, d, e, split = ridge.load_dataset(
        f'{ridge.DATA}/info-{name}.csv')
    assert (len(X), d + 1) == shape and e == 1 and split == 0
    assert np.isfinite(X).all()
    train, test = ridge.train_test(X, split, 0)
    assert len(train) + len(test) == len(X)


def test_plain_adj_det_is_exact():
    """The plain check's (adj A) B and det A on a small integer system
    against Python's fractions directly."""
    A = [[4, 1, 2], [1, 5, 3], [2, 3, 6]]
    B = [[1], [-2], [7]]
    adj, det = ridge.plain_adj_det(A, B)
    assert det == round(np.linalg.det(np.array(A, float)))
    x = np.linalg.solve(np.array(A, float), np.array(B, float))
    assert np.allclose(np.array(adj, float) / det, x)


def test_pseudoinverse_default():
    rt = SimRuntime(3, device='cpu')
    res = pseudoinverse.run(rt, 5, seed=1, out=_quiet)
    assert res['ok'] and res['L'] == 2


def test_multilateration_two_measurements():
    rt = SimRuntime(3, device='cpu')
    res = multilateration.run(rt, k=2, out=_quiet)
    assert res['ok'] and res['n'] == 2 and res['L'] == 12
    assert res['median'] < 2000


def test_lpsolverfxp_stopped_tableau_is_its_bases():
    """The fixed-point LP solver stopped after a number of pivots (as
    chip_smoke.py stops kb2): its opened tableau equals, within the
    runner's ``solution_tol``, the float64 tableau of its opened basis
    (``plain_tableau``), which is the float solver's after as many
    pivots where they take the same ones."""
    from mpyc_tpu_torch.demos import np_lpsolverfxp as lpf
    rt = SimRuntime(3, device='cpu')
    got = lpf.solve(rt, 3, out=_quiet, max_pivots=2)      # woody
    assert got['stopped'] and got['iterations'] == 2
    T = lpf.plain_tableau(lpf.read_csv('woody'), got['basis'],
                          got['cobasis'])
    assert np.max(np.abs(got['T'] - T)) <= lpf.solution_tol(36, T.ravel())
    assert sorted(got['basis'].tolist() + got['cobasis'].tolist()) == \
        list(range(5))

