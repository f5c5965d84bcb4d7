"""K6's plan of a power (``fieldops.pow_plan``) at hypothesis-drawn
exponents: the plan's program, evaluated with Python integers, gives
x^e mod p in no more products than the binary ladder
(``fieldops.pow_products``), for every exponent K6 takes (below
2^(32 L)). The same program on Montgomery limbs is held against the
ladders at named and seeded exponents in tests/test_torch_fxp.py.

Tolerance: exact equality (integers).
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions on small tensors gain nothing from torch's
    threads, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytest.importorskip('hypothesis')
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from mpyc_tpu_torch.ops import fieldops  # noqa: E402

P52 = 4503599627370323        # SecFxp(14, 6)'s field: two limbs
P64 = 18446744073709551427    # SecInt(32)'s field: two limbs, 4p > R
P69 = 590295810358705651619   # SecInt(37)'s field: three limbs


def _plan_pow_int(x, e, p):
    """(x^e mod p, products) by the program of e's plan, as K6 runs it."""
    if e == 0:
        return 1, 0
    plan = fieldops.pow_plan(e)
    products = 0
    table = [x]
    if plan.n_table > 1:
        x2 = x * x % p
        products += 1
        for _ in range(plan.n_table - 1):
            table.append(table[-1] * x2 % p)
            products += 1
    res = table[plan.first]
    for sq, j in plan.steps:
        for _ in range(sq):
            res = res * res % p
        res = res * table[j] % p
        products += sq + 1
    for _ in range(plan.tail):
        res = res * res % p
    return res, products + plan.tail


@pytest.mark.parametrize('p,limbs', [(P52, 2), (P64, 2), (P69, 3)])
@settings(max_examples=200, deadline=None)
@given(data=st.data())
def test_pow_plan_program_on_drawn_exponents(p, limbs, data):
    e = data.draw(st.integers(0, (1 << 32 * limbs) - 1), label='e')
    x = data.draw(st.integers(0, p - 1), label='x')
    got, products = _plan_pow_int(x, e, p)
    assert got == pow(x, e, p)
    assert products == fieldops.plan_products(e) <= fieldops.pow_products(e)
    plan = fieldops.pow_plan(e)
    assert 1 <= plan.n_table <= 1 << fieldops.POW_WINDOW - 1
