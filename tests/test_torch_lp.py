"""The port's copy of the LP substrate against ``repro.lp``: the same
seed gives byte-identical instances, and ``interop`` carries an LP
across the two packages and onto a device."""
import numpy as np
import pytest
import torch

from repro_torch import lp as tlp
from repro_torch.interop import from_reference_lp, lp_tensors
from repro_torch.lp.problem import SparseCOO

CASES = (
    [("random_standard_lp", (12, 20), {"seed": 3}),
     ("random_standard_lp", (10, 18), {"seed": 6, "density": 0.5}),
     ("sparse_random_standard_lp", (16, 32), {"density": 0.2, "seed": 1}),
     ("assignment_lp", (4,), {}),
     ("pagerank_lp", (16,), {})]
    + [("table1_instance", (name,), {}) for name in tlp.TABLE1_SIZES])


def _ref_lp():
    pytest.importorskip("jax")
    from repro import lp as rlp

    return rlp


def _assert_same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _assert_same_lp(p, r):
    if isinstance(r.K, np.ndarray):
        _assert_same_array(p.K, r.K)
    else:
        for f in ("data", "row", "col"):
            _assert_same_array(getattr(p.K, f), getattr(r.K, f))
        assert tuple(p.K.shape) == tuple(r.K.shape)
    for f in ("c", "b", "lb", "ub"):
        _assert_same_array(getattr(p, f), getattr(r, f))
    if r.x_opt is None:
        assert p.x_opt is None
    else:
        _assert_same_array(p.x_opt, r.x_opt)
    assert p.obj_opt == r.obj_opt and p.name == r.name


@pytest.mark.parametrize("fn,args,kwargs", CASES,
                         ids=[f"{c[0]}-{'-'.join(map(str, c[1]))}"
                              for c in CASES])
def test_generators_are_byte_identical(fn, args, kwargs):
    rlp = _ref_lp()
    _assert_same_lp(getattr(tlp, fn)(*args, **kwargs),
                    getattr(rlp, fn)(*args, **kwargs))


def test_table1_sizes_match_reference():
    assert tlp.TABLE1_SIZES == _ref_lp().TABLE1_SIZES


@pytest.mark.parametrize("sparse", [False, True])
def test_from_reference_lp_round_trips(sparse):
    rlp = _ref_lp()
    ref = (rlp.sparse_random_standard_lp(12, 24, density=0.3, seed=2)
           if sparse else rlp.table1_instance("gen-ip002"))
    port = from_reference_lp(ref)
    assert isinstance(port, tlp.StandardLP)
    assert isinstance(port.K, SparseCOO) == sparse
    _assert_same_lp(port, ref)
    # and again from the port's own object
    _assert_same_lp(from_reference_lp(port), ref)


def test_lp_tensors_moves_to_device_and_dtype():
    lp = tlp.sparse_random_standard_lp(6, 10, density=0.4, seed=0)
    t = lp_tensors(lp, "cpu", torch.float32)
    assert t.K.shape == (6, 10) and t.K.dtype == torch.float32
    np.testing.assert_array_equal(t.K.numpy(), lp.K_dense.astype(np.float32))
    assert torch.isinf(t.ub).all() and t.ub.device.type == "cpu"
