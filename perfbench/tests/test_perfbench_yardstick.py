"""The benchmark's frozen copies give what the program gives today."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts the repository on the path)
from perfbench.yardstick import generators, peaks, step_bytes


@pytest.mark.parametrize("m,n,seed", [(8, 14, 0), (24, 40, 3), (40, 96, 11)])
def test_dense_generator_is_the_programs_bit_for_bit(m, n, seed):
    from repro_torch.lp import random_standard_lp

    ours = generators.make("rand", m, n, seed)
    theirs = random_standard_lp(m, n, seed=seed)
    for f in ("c", "K", "b", "lb", "ub", "x_opt"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f
    assert ours.obj_opt == theirs.obj_opt and ours.name == theirs.name


@pytest.mark.parametrize("m,n,density,seed",
                         [(96, 192, 0.05, 0), (128, 256, 0.02, 7),
                          (80, 160, 0.001, 2**31 + 5)])
def test_sparse_generator_is_the_programs_bit_for_bit(m, n, density, seed):
    from repro_torch.lp import sparse_random_standard_lp

    ours = generators.make("sprand", m, n, seed, density)
    theirs = sparse_random_standard_lp(m, n, density=density, seed=seed)
    for f in ("data", "row", "col"):
        assert np.array_equal(getattr(ours.K, f), getattr(theirs.K, f)), f
    assert ours.K.shape == theirs.K.shape
    for f in ("c", "b", "lb", "ub", "x_opt"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f
    assert ours.obj_opt == theirs.obj_opt and ours.name == theirs.name


@pytest.mark.parametrize("name", sorted(generators.TABLE1))
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_table1_generator_is_the_programs_bit_for_bit(name, seed):
    from repro_torch.lp import TABLE1_SIZES, table1_instance

    m, n, _ = generators.TABLE1[name]
    assert TABLE1_SIZES[name] == (m, n)
    ours = generators.make("table1", m, n, seed, name=name)
    theirs = table1_instance(name, seed=seed)
    for f in ("c", "K", "b", "lb", "ub"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f
    assert ours.obj_opt == theirs.obj_opt and ours.name == theirs.name
    with pytest.raises(ValueError, match="not an instance of Table 1"):
        generators.make("table1", m + 1, n, seed, name=name)


def test_unknown_family_is_refused():
    with pytest.raises(ValueError, match="unknown instance family"):
        generators.make("mps", 4, 8, 0)


def test_peaks_and_bound_are_the_smokes():
    import chip_smoke

    assert peaks.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert peaks.PEAK_OPS_PER_S == chip_smoke.PEAK_OPS_PER_S
    for b, ops, dt in ((236e6, 1e6, "float64"), (1e3, 1e12, "float32")):
        ms, by = chip_smoke.bound_ms(b, ops, dt)
        s, by2 = peaks.bound_s(b, ops, dt)
        assert s * 1e3 == pytest.approx(ms, rel=1e-15) and by == by2


def test_step_bytes_by_hand():
    # dense 3840 x 7680 f64: K once, 9 n + 6 m vector values
    assert step_bytes.step_bytes(3840, 7680, 8) == \
        235_929_600 + 737_280
    # sparse 16384 x 32768 with 536871 nonzeros: value and 4-byte index
    assert step_bytes.step_bytes(16384, 32768, 8, nnz=536_871) == \
        6_442_452 + 3_145_728
