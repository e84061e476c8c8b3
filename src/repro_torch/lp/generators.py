"""Synthetic LP instance generators (a numpy-only copy of
``repro.lp.generators``: the same seed gives byte-identical arrays).

The paper benchmarks LP relaxations of MIPLIB-2017 instances (Table 1).
The MIPLIB files are not shipped with the repository, so we generate
instances with the *same shapes* (m, n) and
comparable conditioning, plus classic families (assignment, PageRank LP
from the PDLP paper) and random instances *with known optimal solutions*
constructed via complementary slackness (exact ground truth without any
external solver).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .problem import INF, LPProblem, SparseCOO, StandardLP

# (m, n) sizes from paper Table 1.  These drive the benchmark harness.
TABLE1_SIZES: Dict[str, Tuple[int, int]] = {
    "gen-ip002": (24, 41),
    "gen-ip016": (24, 28),
    "gen-ip021": (28, 35),
    "gen-ip036": (46, 29),
    "gen-ip054": (27, 30),
    "neos5": (402, 253),
    "assign1-5-8": (161, 156),
}


def random_standard_lp(
    m: int,
    n: int,
    seed: int = 0,
    density: float = 1.0,
    frac_basic: float | None = None,
    scale: float = 1.0,
) -> StandardLP:
    """Random standard-form LP with a *known* optimal solution.

    Construction (complementary slackness): pick primal ``x*`` with exactly
    ``m`` strictly-positive "basic" entries, pick any dual ``y*``, then set
    ``c = K^T y* + s`` with reduced costs ``s >= 0`` vanishing on the basic
    support.  (x*, y*) is then an optimal primal-dual pair for
    ``min c@x s.t. Kx = K x*, x >= 0``.
    """
    assert n >= m, "standard-form generator needs n >= m"
    rng = np.random.default_rng(seed)
    K = rng.normal(size=(m, n)) * scale
    if density < 1.0:
        mask = rng.random((m, n)) < density
        # keep at least one entry per row/col to avoid degenerate zero rows
        mask[np.arange(m), rng.integers(0, n, m)] = True
        mask[rng.integers(0, m, n), np.arange(n)] = True
        K = K * mask
    n_basic = m if frac_basic is None else max(1, int(round(frac_basic * n)))
    n_basic = min(n_basic, n)
    basic = rng.choice(n, size=n_basic, replace=False)
    x_opt = np.zeros(n)
    x_opt[basic] = rng.uniform(0.5, 2.0, size=n_basic)
    b = K @ x_opt
    y_opt = rng.normal(size=m)
    s = rng.uniform(0.1, 1.0, size=n)
    s[basic] = 0.0
    c = K.T @ y_opt + s
    return StandardLP(
        c=c,
        K=K,
        b=b,
        lb=np.zeros(n),
        ub=np.full(n, INF),
        name=f"rand-{m}x{n}-s{seed}",
        x_opt=x_opt,
        obj_opt=float(c @ x_opt),
    )


def sparse_random_standard_lp(
    m: int,
    n: int,
    density: float = 0.01,
    seed: int = 0,
    scale: float = 1.0,
    dtype=np.float64,
) -> StandardLP:
    """Random sparse standard-form LP with a *known* optimal solution.

    Same complementary-slackness construction as ``random_standard_lp``,
    but K is built DIRECTLY in COO form — positions sampled without ever
    allocating an (m, n) dense array, so paper-scale instances (millions
    of variables at sub-percent density) fit in nonzero-proportional host
    memory.  Coverage guarantee: at least one entry per row and per
    column (no degenerate zero rows/cols).
    """
    assert n >= m, "standard-form generator needs n >= m"
    assert 0.0 < density <= 1.0, density
    rng = np.random.default_rng(seed)
    # one guaranteed entry per row and per column ...
    flat = [rng.integers(0, n, m) + np.arange(m) * n,
            rng.integers(0, m, n) * n + np.arange(n)]
    # ... plus the remaining budget sampled with replacement and deduped
    # (collisions are rare at low density; exact nnz is not contractual)
    target = int(round(density * m * n))
    extra = max(target - m - n, 0)
    if extra:
        flat.append(rng.integers(0, m * n, extra))
    flat = np.unique(np.concatenate(flat))
    row, col = np.divmod(flat, n)
    data = (rng.normal(size=flat.size) * scale).astype(dtype)
    K = SparseCOO(data, row, col, (m, n))
    n_basic = min(m, n)
    basic = rng.choice(n, size=n_basic, replace=False)
    x_opt = np.zeros(n, dtype)
    x_opt[basic] = rng.uniform(0.5, 2.0, size=n_basic)
    b = K @ x_opt
    y_opt = rng.normal(size=m).astype(dtype)
    s = rng.uniform(0.1, 1.0, size=n).astype(dtype)
    s[basic] = 0.0
    c = (K.T @ y_opt) + s
    return StandardLP(
        c=c,
        K=K,
        b=b,
        lb=np.zeros(n, dtype),
        ub=np.full(n, INF, dtype),
        name=f"sprand-{m}x{n}-d{density:g}-s{seed}",
        x_opt=x_opt,
        obj_opt=float(c @ x_opt),
    )


# Paper-scale shapes for sparse stream serving: MIPLIB-2017-class LP
# relaxations run 1e4-1e6 nonzeros at fractions-of-a-percent density;
# these are the bucketable stand-ins the benchmarks cycle through.
SPARSE_STREAM_SHAPES: Tuple[Tuple[int, int], ...] = (
    (96, 192), (128, 256), (80, 160), (112, 224))


def sparse_lp_stream(
    n_instances: int,
    shapes: Sequence[Tuple[int, int]] = SPARSE_STREAM_SHAPES,
    density: float = 0.05,
    seed: int = 0,
    dtype=np.float64,
) -> List[StandardLP]:
    """A mixed-shape stream of sparse LPs at paper-scale densities (all
    with known optima), cycling through ``shapes`` — the sparse twin of
    the dense streams the throughput benchmark builds."""
    lps = []
    for i in range(n_instances):
        m, n = shapes[i % len(shapes)]
        lps.append(sparse_random_standard_lp(
            m, n, density=density, seed=seed + i, dtype=dtype))
    return lps


def table1_instance(name: str, seed: int = 0) -> StandardLP:
    """Instance with the same (m, n) as the named Table-1 problem.

    The MIPLIB originals are MIPs whose LP relaxations have inequality
    rows + box bounds; we generate inequality-form instances of the same
    (m, n) with a KNOWN optimum via primal-dual construction, then
    standardize (m slack columns), exactly the 'suitable projection' of
    paper §2.1.
    """
    m, n = TABLE1_SIZES[name]
    # the two larger MIPLIB instances are sparse (neos5: set-partition-
    # like rows; assign1-5-8: assignment structure, ~2 nz per column)
    density = {"neos5": 0.08, "assign1-5-8": 0.05}.get(name, 1.0)
    lp = random_inequality_lp_known(m, n, seed=seed, name=name,
                                    density=density)
    std = lp.to_standard()
    std.name = name
    # known optimum carries over (slacks don't change the objective)
    std.obj_opt = lp_known_objective(lp)
    return std


def lp_known_objective(lp: LPProblem) -> float:
    return float(getattr(lp, "_obj_opt"))


def random_inequality_lp_known(
    m: int, n: int, seed: int = 0, box: float = 10.0, name: str = "ineq",
    density: float = 1.0,
) -> LPProblem:
    """Inequality-form LP with a KNOWN optimal solution.

    KKT construction for  min c@x  s.t. Gx >= h, 0 <= x <= box:
      * choose x* with coordinates at lb / at ub / interior,
      * choose an active set of rows passing exactly through x*
        (y_i > 0 there), the rest strictly slack (y_i = 0),
      * choose bound multipliers lam_l (at lb) / lam_u (at ub),
      * stationarity fixes  c = G^T y + lam_l - lam_u.
    Complementary slackness holds by construction => x* optimal.
    """
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(m, n))
    if density < 1.0:
        # MIPLIB-class constraint matrices are sparse; keep >=2 nz/row
        mask = rng.random((m, n)) < density
        mask[np.arange(m), rng.integers(0, n, m)] = True
        mask[np.arange(m), rng.integers(0, n, m)] = True
        G = G * mask
    kind = rng.choice(3, size=n, p=[0.3, 0.3, 0.4])  # 0: lb, 1: ub, 2: interior
    x_opt = np.where(
        kind == 0, 0.0, np.where(kind == 1, box, rng.uniform(0.2 * box, 0.8 * box, n))
    )
    n_active = min(m, max(1, n // 2))
    active = rng.choice(m, size=n_active, replace=False)
    Gx = G @ x_opt
    h = Gx - rng.uniform(0.5, 2.0, size=m)      # slack rows by default
    h[active] = Gx[active]                      # active rows tight at x*
    y = np.zeros(m)
    y[active] = rng.uniform(0.1, 1.0, size=n_active)
    lam_l = np.where(kind == 0, rng.uniform(0.1, 1.0, n), 0.0)
    lam_u = np.where(kind == 1, rng.uniform(0.1, 1.0, n), 0.0)
    c = G.T @ y + lam_l - lam_u
    lp = LPProblem(
        c=c, G=G, h=h, lb=np.zeros(n), ub=np.full(n, box), name=name
    )
    lp._x_opt = x_opt
    lp._obj_opt = float(c @ x_opt)
    return lp


def random_inequality_lp(
    m: int, n: int, seed: int = 0, box: float = 10.0, name: str = "ineq"
) -> LPProblem:
    """Feasible-bounded inequality-form LP:  min c@x, Gx >= h, 0<=x<=box.

    Feasibility by construction: pick interior x0 in the box, set
    h = G x0 - margin (margin > 0).  Bounded by the box constraints.
    """
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(m, n))
    x0 = rng.uniform(0.25 * box, 0.75 * box, size=n)
    margin = rng.uniform(0.1, 1.0, size=m)
    h = G @ x0 - margin
    c = rng.normal(size=n)
    return LPProblem(
        c=c, G=G, h=h, lb=np.zeros(n), ub=np.full(n, box), name=name
    )


def assignment_lp(n_agents: int, seed: int = 0) -> StandardLP:
    """Assignment-problem LP (totally unimodular => LP optimum is integral).

    min sum_ij C_ij x_ij  s.t. rows sum to 1, cols sum to 1, x >= 0.
    Ground truth computable exactly by brute force for small n (tests) or
    simplex.  Shape: m = 2*n_agents rows, n = n_agents^2 variables.
    """
    rng = np.random.default_rng(seed)
    n = n_agents
    C = rng.uniform(0.0, 1.0, size=(n, n))
    nv = n * n
    K = np.zeros((2 * n, nv))
    for i in range(n):
        K[i, i * n : (i + 1) * n] = 1.0           # agent i assigned once
        K[n + i, i::n] = 1.0                      # task i assigned once
    b = np.ones(2 * n)
    return StandardLP(
        c=C.reshape(-1),
        K=K,
        b=b,
        lb=np.zeros(nv),
        ub=np.ones(nv),
        name=f"assign-{n}",
    )


def pagerank_lp(n: int, seed: int = 0, damping: float = 0.85, deg: int = 4) -> StandardLP:
    """PageRank as an LP (PDLP paper, §6 'a very large PageRank instance').

    Find x >= 0 with (I - damping * P^T) x = (1-damping)/n * 1 where P is a
    column-stochastic random-graph transition matrix; objective min sum(x)
    (any feasible point is the PageRank vector, unique).
    """
    rng = np.random.default_rng(seed)
    P = np.zeros((n, n))
    for j in range(n):
        outs = rng.choice(n, size=min(deg, n), replace=False)
        P[outs, j] = 1.0 / len(outs)
    K = np.eye(n) - damping * P
    b = np.full(n, (1.0 - damping) / n)
    c = np.ones(n)
    return StandardLP(
        c=c, K=K, b=b, lb=np.zeros(n), ub=np.full(n, INF),
        name=f"pagerank-{n}",
    )


def netlib_like(m: int, n: int, seed: int = 0, cond: float = 1e3) -> StandardLP:
    """Random LP with controlled condition number of K (tests preconditioning).

    K = U diag(logspace) V^T restricted to (m, n); known optimum as in
    random_standard_lp.
    """
    rng = np.random.default_rng(seed)
    k = min(m, n)
    U, _ = np.linalg.qr(rng.normal(size=(m, k)))
    V, _ = np.linalg.qr(rng.normal(size=(n, k)))
    sv = np.logspace(0, np.log10(cond), k)[::-1]
    K = (U * sv) @ V.T
    basic = rng.choice(n, size=m, replace=False)
    x_opt = np.zeros(n)
    x_opt[basic] = rng.uniform(0.5, 2.0, size=m)
    b = K @ x_opt
    y_opt = rng.normal(size=m)
    s = rng.uniform(0.1, 1.0, size=n)
    s[basic] = 0.0
    c = K.T @ y_opt + s
    return StandardLP(
        c=c, K=K, b=b, lb=np.zeros(n), ub=np.full(n, INF),
        name=f"netlib-like-{m}x{n}-c{cond:g}",
        x_opt=x_opt, obj_opt=float(c @ x_opt),
    )


def infeasible_lp(m: int = 8, n: int = 12, seed: int = 0) -> StandardLP:
    """Primal-infeasible instance: contradictory duplicated rows."""
    rng = np.random.default_rng(seed)
    base = random_standard_lp(m - 1, n, seed=seed)
    K = np.concatenate([base.K, base.K[-1:]], axis=0)
    b = np.concatenate([base.b, base.b[-1:] + 1.0])  # same row, different rhs
    return StandardLP(
        c=base.c, K=K, b=b, lb=np.zeros(n), ub=np.full(n, INF),
        name=f"infeasible-{m}x{n}",
    )


def crossbar_sized_lp(seed: int = 0) -> StandardLP:
    """An instance that exactly fills the paper's 256x256 logical crossbar.

    m + n = 256 (M is (m+n) x (m+n)); we use m=96, n=160.
    """
    return random_standard_lp(96, 160, seed=seed)
