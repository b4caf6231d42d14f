"""The port's copies of the carry theory, accumulator planning and the
radix-4 reduction plan equal the JAX package's modules."""
import dataclasses

import pytest

from repro.core import accum as jaccum
from repro.core import carry as jcarry
from repro.dist import plan as jplan
from repro_torch.core import accum as taccum
from repro_torch.core import carry as tcarry
from repro_torch.dist import plan as tplan


def _t(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def test_reduction_plans_equal_1_to_300():
    for n in range(1, 301):
        for kw in ({}, {"m_bits": 8}, {"payload_bits": 8},
                   {"m_bits": 16, "payload_bits": 4, "acc_bits": 24}):
            j, t = jplan.make_reduction_plan(n, **kw), \
                tplan.make_reduction_plan(n, **kw)
            assert [_t(l) for l in t.levels] == [_t(l) for l in j.levels]
            assert t.stages == j.stages
            assert _t(t.budget) == _t(j.budget) if j.budget else not t.budget
            assert _t(t.accum) == _t(j.accum) if j.accum else not t.accum
            assert (t.depth, t.carries_emitted, t.carry_value_bound,
                    t.carry_adder_bits) == (j.depth, j.carries_emitted,
                                            j.carry_value_bound,
                                            j.carry_adder_bits)
            assert t.sub_axis_names("x") == j.sub_axis_names("x")


@pytest.mark.parametrize("k", [2, 3, 4, 10, 16])
def test_carry_theory_equal(k):
    for n in range(1, 40):
        assert tcarry.exact_max_carry_1col(n, k) == \
            jcarry.exact_max_carry_1col(n, k)
        assert tcarry.tight_carry_bound(n, k) == jcarry.tight_carry_bound(n, k)
        assert tcarry.carry_digits_bound(n, k) == \
            jcarry.carry_digits_bound(n, k)
        for m in range(1, 6):
            assert tcarry.max_carry_multicolumn(n, m, k) == \
                jcarry.max_carry_multicolumn(n, m, k)
            assert tcarry.result_digits(n, m, k) == \
                jcarry.result_digits(n, m, k)
            assert _t(tcarry.carry_budget(n, m, k)) == \
                _t(jcarry.carry_budget(n, m, k))
    for m in range(1, 5):
        for p in range(1, 7):
            assert tcarry.column_transition_N(m, p, k) == \
                jcarry.column_transition_N(m, p, k)


def test_accum_planning_equal():
    for bits in range(1, 17):
        for acc in (8, 16, 24, 32):
            for signed in (False, True):
                assert taccum.max_operands_exact(acc, bits, signed) == \
                    jaccum.max_operands_exact(acc, bits, signed)
        for n in (1, 2, 3, 7, 100, 4096):
            assert taccum.bits_for_sum(n, bits, True) == \
                jaccum.bits_for_sum(n, bits, True)
    for k_total in (1, 100, 128, 4096, 8192, 1 << 20):
        for acc in (24, 32):
            assert _t(taccum.plan_dot_accumulation(k_total, acc_bits=acc)) == \
                _t(jaccum.plan_dot_accumulation(k_total, acc_bits=acc))
    for n in (1, 2, 8, 1000, 1 << 20):
        assert _t(taccum.plan_gradient_reduction(n)) == \
            _t(jaccum.plan_gradient_reduction(n))
    with pytest.raises(ValueError):
        taccum.plan_gradient_reduction(1 << 30)
