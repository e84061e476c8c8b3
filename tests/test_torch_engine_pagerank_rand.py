"""The port's dense solve against the reference's on the PageRank and
random standard-form instances: the step rule x restart cases of
``test_torch_engine.py`` (f64, reference draws injected)."""
import pytest
from _torch_parity import RULES, check_step_rule_case

from repro_torch.lp import pagerank_lp, random_standard_lp

INSTANCES = {
    "pagerank-16": lambda: pagerank_lp(16),
    "rand-12x20-s3": lambda: random_standard_lp(12, 20, seed=3),
}


@pytest.mark.parametrize("restart", [True, False], ids=["restart",
                                                        "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_jit_matches_reference(x64, name, rule, restart):
    check_step_rule_case(INSTANCES[name](), rule, restart)
