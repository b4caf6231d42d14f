"""The port's multi-operand adder library against the JAX package.

``repro_torch.core.{lut, moa, reconfig, planner}`` against ``repro.core``:
the Fig-3 table and Fig-4 netlist, the hierarchical popcount, the §10 gate
costs, the Python and tensor adders (serial Algorithm 2 with its trace,
the Fig-7 4xM adder and its (S, C) split, the §7 reconfigured adder with
its structure dict), the reconfiguration plan and Lemma 3 — all exact,
on operands made with numpy from a seed — and the paper's worked examples
(Figs 12-15).
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core import moa as jmoa
from repro.core import planner as jplanner
from repro.core import reconfig as jreconfig
from repro_torch.core import lut, moa, planner, reconfig

NS = [1, 3, 4, 16, 17, 64]


def _ops(batch, n, m_bits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** m_bits, (batch, n)).astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ LUT (Figs 3/4)
def test_lut_table_equals_jax():
    np.testing.assert_array_equal(lut.LUT4_TABLE, jlut.LUT4_TABLE)


def test_netlist_and_lookup_equal_jax():
    bits = np.array(list(itertools.product([0, 1], repeat=4)), np.int32)
    _eq(lut.lut4_netlist(torch.from_numpy(bits)),
        jlut.lut4_netlist(jnp.asarray(bits)))
    codes = np.arange(16, dtype=np.int32)
    _eq(lut.lut4_lookup(torch.from_numpy(codes)),
        jlut.lut4_lookup(jnp.asarray(codes)))
    _eq(lut.lut4_netlist(torch.from_numpy(bits)), bits.sum(axis=1))


@pytest.mark.parametrize("n", NS + [5, 31])
def test_popcount_tree_equals_jax(n):
    bits = np.random.default_rng(n).integers(0, 2, (9, n)).astype(np.int32)
    got = lut.popcount_tree(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    _eq(got, jlut.popcount_tree(jnp.asarray(bits)))


@pytest.mark.parametrize("n", NS + [2, 256])
@pytest.mark.parametrize("m_bits", [1, 4, 16, 24])
def test_gate_costs_equal_jax(n, m_bits):
    for name in ("lut_parallel_adder_cost", "cla_tree_cost", "lut_tree_cost"):
        got = getattr(lut, name)(n, m_bits)
        want = getattr(jlut, name)(n, m_bits)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), name
    assert dataclasses.astuple(lut.cla_adder_cost(m_bits)) == \
        dataclasses.astuple(jlut.cla_adder_cost(m_bits))
    assert lut.performance_advantage(n, m_bits) == \
        jlut.performance_advantage(n, m_bits)
    assert (lut.LUT_DELAY_GATES, lut.LUT_AREA_GATES, lut.CLA4_DELAY_GATES,
            lut.CLA4_AREA_GATES) == (jlut.LUT_DELAY_GATES,
                                     jlut.LUT_AREA_GATES,
                                     jlut.CLA4_DELAY_GATES,
                                     jlut.CLA4_AREA_GATES)


# ------------------------------------------------------------ Python layer
@pytest.mark.parametrize("k", [2, 10, 16])
@pytest.mark.parametrize("n", NS)
def test_serial_add_py_equals_jax(k, n):
    rng = np.random.default_rng(k * 100 + n)
    operands = [int(v) for v in rng.integers(0, k ** 5, n)]
    got = moa.serial_add_py(operands, k, m_digits=5)
    want = jmoa.serial_add_py(operands, k, m_digits=5)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.result == sum(operands)


# ------------------------------------------------------------ tensor layer
def test_max_supported_bits_equals_jax():
    for n in range(1, 301):
        assert moa.max_supported_bits(n) == jmoa.max_supported_bits(n)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m_bits", [1, 8, 16])
def test_serial_add_with_trace_equals_jax(n, m_bits):
    x = _ops(7, n, m_bits, n * 37 + m_bits)
    res, clocks, (cols, carries) = moa.serial_add(torch.from_numpy(x),
                                                  m_bits, return_trace=True)
    jres, jclocks, (jcols, jcarries) = jmoa.serial_add(
        jnp.asarray(x), m_bits, return_trace=True)
    assert clocks == jclocks == m_bits + 1
    for got, want in ((res, jres), (cols, jcols), (carries, jcarries)):
        assert got.dtype == torch.int32
        _eq(got, want)
    _eq(res, x.sum(axis=-1))
    res2, _ = moa.serial_add(torch.from_numpy(x), m_bits)
    assert torch.equal(res2, res)


@pytest.mark.parametrize("m_bits", [1, 4, 16, 28])
def test_parallel_add_4xm_and_sc_equal_jax(m_bits):
    x = _ops(33, 4, m_bits, m_bits)
    _eq(moa.parallel_add_4xm(torch.from_numpy(x), m_bits),
        jmoa.parallel_add_4xm(jnp.asarray(x), m_bits))
    s, c = moa.parallel_add_4xm_sc(torch.from_numpy(x), m_bits)
    js, jc = jmoa.parallel_add_4xm_sc(jnp.asarray(x), m_bits)
    _eq(s, js)
    _eq(c, jc)
    assert int(c.max()) <= 3                    # Theorem: 4-operand carry


@pytest.mark.parametrize("n", NS + [40])
@pytest.mark.parametrize("m_bits", [3, 16])
def test_reconfigured_add_with_structure_equals_jax(n, m_bits):
    x = _ops(12, n, m_bits, n + 1000 * m_bits)
    res, st = moa.reconfigured_add(torch.from_numpy(x), m_bits,
                                   return_structure=True)
    jres, jst = jmoa.reconfigured_add(jnp.asarray(x), m_bits,
                                      return_structure=True)
    _eq(res, jres)
    _eq(res, x.sum(axis=-1))
    assert set(st) == set(jst)
    for key in ("levels", "modules", "carry_value_bound"):
        assert st[key] == jst[key], key
    _eq(st["carry_total"], jst["carry_total"])


def test_width_guards_match_jax():
    for fn, jfn in ((moa.serial_add, jmoa.serial_add),
                    (moa.reconfigured_add, jmoa.reconfigured_add)):
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 16), dtype=torch.int32), 31)
        with pytest.raises(ValueError):
            jfn(jnp.zeros((1, 16), jnp.int32), 31)
    with pytest.raises(ValueError, match="exactly 4"):
        moa.parallel_add_4xm(torch.zeros((1, 5), dtype=torch.int32), 4)


# ------------------------------------------------------------ §7 plan, Lemma 3
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("m_bits", [4, 16, 20])
def test_plan_reconfig_equals_jax(n, m_bits):
    got = reconfig.plan_reconfig(n, m_bits)
    want = jreconfig.plan_reconfig(n, m_bits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.speedup_vs_serial == want.speedup_vs_serial
    assert reconfig.radix_stages(n) == jreconfig.radix_stages(n)


@pytest.mark.parametrize("n", NS)
def test_planner_equals_jax(n):
    for ra, rt in ((n + 1, 4), (3, n + 2), (20, 17), (12, 17)):
        ser = (1, rt)
        par = (ra, 1)
        assert planner.serial_beats_parallel(
            planner.UnitSpec(*ser), planner.UnitSpec(*par)) == \
            jplanner.serial_beats_parallel(jplanner.UnitSpec(*ser),
                                           jplanner.UnitSpec(*par))
        assert planner.throughput_curves(ra, rt, 10 * n) == \
            jplanner.throughput_curves(ra, rt, 10 * n)
    args = dict(global_batch=256, chips=256, chips_per_replica_parallel=64,
                step_time_parallel=1.0, step_time_serial=float(n))
    for per_serial in (4, 32):
        got = planner.plan_training_execution(
            chips_per_replica_serial=per_serial, **args)
        want = jplanner.plan_training_execution(
            chips_per_replica_serial=per_serial, **args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------------------------------------------ Figs 12-15
def test_fig12_serial_4x4():
    """A + F + 1 + 2 = 1C (hex): LUT outputs {2, 3, 1, 2}, 5 clocks, on
    both layers of the port."""
    tr = moa.serial_add_py([0xA, 0xF, 0x1, 0x2], k=2, m_digits=4)
    assert (tr.result, tr.clocks, tr.column_sums) == (0x1C, 5, [2, 3, 1, 2])
    ops = torch.tensor([[0xA, 0xF, 0x1, 0x2]], dtype=torch.int32)
    res, clocks, (cols, carries) = moa.serial_add(ops, 4, return_trace=True)
    assert (int(res[0]), clocks) == (0x1C, 5)
    assert cols[0].tolist() == [2, 3, 1, 2]
    assert carries[0].tolist() == tr.carries


def test_fig13_parallel_4x4():
    ops = torch.tensor([[0xA, 0xF, 0x1, 0x2]], dtype=torch.int32)
    assert int(moa.parallel_add_4xm(ops, 4)[0]) == 0x1C


def test_fig14_serial_4x16():
    """A234 + FFFF + 0A2D + FF7F = 2ABDF (hex) in 16 + 1 clocks."""
    operands = [0xA234, 0xFFFF, 0x0A2D, 0xFF7F]
    tr = moa.serial_add_py(operands, k=2, m_digits=16)
    assert (tr.result, tr.clocks) == (0x2ABDF, 17)
    res, clocks = moa.serial_add(torch.tensor([operands],
                                              dtype=torch.int32), 16)
    assert (int(res[0]), clocks) == (0x2ABDF, 17)


def test_fig15_reconfigured_16x16():
    """16 operands of 16 bits from 4-operand modules: U1..U4 then U5, carry
    at most N - 1 = 15; the all-FFFF worst case needs exactly 20 bits."""
    x = _ops(64, 16, 16, 0)
    res, st = moa.reconfigured_add(torch.from_numpy(x), 16,
                                   return_structure=True)
    _eq(res, x.sum(axis=-1))
    assert st["levels"] == 2 and st["carry_value_bound"] == 15
    assert int(st["carry_total"].max()) <= 15
    full = torch.full((1, 16), 0xFFFF, dtype=torch.int32)
    assert int(moa.reconfigured_add(full, 16)[0]) == 16 * 0xFFFF
    plan = reconfig.plan_reconfig(16, 16)
    assert [lv.sum_modules for lv in plan.levels] == [4, 1]
    assert plan.result_bits == 20
