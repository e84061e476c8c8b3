"""The port's dense solve (``repro_torch.core.pdhg.solve_jit``) against the
reference's ``solve_jit`` in f64 on the CPU, with the reference's random
draws injected: x and y to 1e-10, and equal iterations, status and
``mvm_calls``, across step rule x restart, on both update backends and
with the check-window megakernel.  The Table-1 and assignment instances
are here; ``test_torch_engine_pagerank_rand.py`` holds the others."""
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
