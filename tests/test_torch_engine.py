"""The port's dense solve (``repro_torch.core.pdhg.solve_jit``) against the
reference's ``solve_jit`` in f64 on the CPU, with the reference's random
draws injected: x and y to 1e-10, and equal iterations, status and
``mvm_calls``, across step rule x restart, on both update backends and
with the check-window megakernel (its transpose form, which the solve
mounts when no ``K_adj`` is given, on the Table-1 and assignment
instances too).  The Table-1 and assignment instances are here;
``test_torch_engine_pagerank_rand.py`` holds the others."""
import pytest
from _torch_parity import (
    RULES,
    assert_matches,
    check_step_rule_case,
    port_solve,
    reference_solve,
)

from repro_torch.lp import assignment_lp, random_standard_lp, table1_instance

INSTANCES = {
    "gen-ip002": lambda: table1_instance("gen-ip002"),
    "assignment-4": lambda: assignment_lp(4),
}


@pytest.mark.parametrize("restart", [True, False], ids=["restart",
                                                        "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_jit_matches_reference(x64, name, rule, restart):
    check_step_rule_case(INSTANCES[name](), rule, restart)


def test_megakernel_matches_reference_megakernel(x64):
    lp = random_standard_lp(12, 20, seed=3)
    ref_opts, ref = reference_solve(lp, step_rule="strongly_convex",
                                    gamma=0.05, megakernel=True,
                                    max_iters=2000)
    assert_matches(port_solve(lp, ref_opts, megakernel=True), ref)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_megakernel_transpose_form_matches_reference(x64, name,
                                                     monkeypatch):
    """Without ``K_adj`` the megakernel solve runs B3's transpose form
    (its plain version here), once a window, and matches the
    reference's megakernel solve."""
    from repro_torch.kernels import pdhg_megakernel as tmk

    windows = []
    real = tmk.fused_dense_steps_kt

    def counted(*args, **kw):
        windows.append(kw["n_steps"])
        return real(*args, **kw)

    monkeypatch.setattr(tmk, "fused_dense_steps_kt", counted)
    lp = INSTANCES[name]()
    ref_opts, ref = reference_solve(lp, megakernel=True)
    port = port_solve(lp, ref_opts, megakernel=True)
    assert_matches(port, ref)
    assert windows == [ref_opts.check_every] * (port.iterations
                                                // ref_opts.check_every)
