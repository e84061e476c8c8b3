"""Known-optimum LP generators, frozen from ``repro_torch.lp.generators``
(``random_standard_lp`` and ``sparse_random_standard_lp``): the same
seed gives the same arrays, bit for bit (``tests/test_perfbench_
yardstick.py`` holds them to the program's copy at small sizes).

Both build a standard-form LP ``min c@x s.t. K x = b, x >= 0`` from a
chosen optimal pair by complementary slackness: ``x*`` with ``m``
positive basic entries, any ``y*``, and ``c = K^T y* + s`` with reduced
costs ``s >= 0`` that vanish on the basis.  ``obj_opt = c @ x*``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


class COO:
    """A host COO matrix (``data``, ``row``, ``col``, ``shape``); ``@``
    sums duplicates in the order ``np.add.at`` visits them, as the
    program's ``SparseCOO`` does."""

    __slots__ = ("data", "row", "col", "shape")

    def __init__(self, data, row, col, shape: Tuple[int, int]):
        self.data = np.asarray(data).reshape(-1)
        self.row = np.asarray(row, np.int32).reshape(-1)
        self.col = np.asarray(col, np.int32).reshape(-1)
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def T(self) -> "COO":
        return COO(self.data, self.col, self.row,
                   (self.shape[1], self.shape[0]))

    def __matmul__(self, x):
        x = np.asarray(x)
        out = np.zeros(self.shape[0], np.result_type(self.data.dtype,
                                                     x.dtype))
        np.add.at(out, self.row, self.data * x[self.col])
        return out


@dataclasses.dataclass
class Instance:
    """One LP with its known optimum.  ``K`` is a dense ndarray or a
    ``COO``; the program reads it through ``repro_torch.interop.
    from_reference_lp``."""

    c: np.ndarray
    K: object
    b: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    name: str
    x_opt: Optional[np.ndarray]
    obj_opt: float

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.K.shape)

    @property
    def nnz(self) -> int:
        return self.K.nnz if isinstance(self.K, COO) else int(
            self.K.shape[0] * self.K.shape[1])


def random_standard_lp(m: int, n: int, seed: int = 0) -> Instance:
    """Dense K of standard normals (the ``rand:MxN`` instance spec)."""
    assert n >= m, "standard-form generator needs n >= m"
    rng = np.random.default_rng(seed)
    K = rng.normal(size=(m, n)) * 1.0
    n_basic = m
    basic = rng.choice(n, size=n_basic, replace=False)
    x_opt = np.zeros(n)
    x_opt[basic] = rng.uniform(0.5, 2.0, size=n_basic)
    b = K @ x_opt
    y_opt = rng.normal(size=m)
    s = rng.uniform(0.1, 1.0, size=n)
    s[basic] = 0.0
    c = K.T @ y_opt + s
    return Instance(c=c, K=K, b=b, lb=np.zeros(n), ub=np.full(n, np.inf),
                    name=f"rand-{m}x{n}-s{seed}", x_opt=x_opt,
                    obj_opt=float(c @ x_opt))


def sparse_random_standard_lp(m: int, n: int, density: float,
                              seed: int = 0) -> Instance:
    """K in COO form: one entry per row and per column, then the rest of
    ``density * m * n`` drawn with replacement and deduplicated; values
    standard normal."""
    assert n >= m, "standard-form generator needs n >= m"
    assert 0.0 < density <= 1.0, density
    dtype = np.float64
    rng = np.random.default_rng(seed)
    flat = [rng.integers(0, n, m) + np.arange(m) * n,
            rng.integers(0, m, n) * n + np.arange(n)]
    target = int(round(density * m * n))
    extra = max(target - m - n, 0)
    if extra:
        flat.append(rng.integers(0, m * n, extra))
    flat = np.unique(np.concatenate(flat))
    row, col = np.divmod(flat, n)
    data = (rng.normal(size=flat.size) * 1.0).astype(dtype)
    K = COO(data, row, col, (m, n))
    basic = rng.choice(n, size=min(m, n), replace=False)
    x_opt = np.zeros(n, dtype)
    x_opt[basic] = rng.uniform(0.5, 2.0, size=basic.size)
    b = K @ x_opt
    y_opt = rng.normal(size=m).astype(dtype)
    s = rng.uniform(0.1, 1.0, size=n).astype(dtype)
    s[basic] = 0.0
    c = (K.T @ y_opt) + s
    return Instance(c=c, K=K, b=b, lb=np.zeros(n, dtype),
                    ub=np.full(n, np.inf, dtype),
                    name=f"sprand-{m}x{n}-d{density:g}-s{seed}",
                    x_opt=x_opt, obj_opt=float(c @ x_opt))


def make(family: str, m: int, n: int, seed: int,
         density: Optional[float] = None) -> Instance:
    """One instance of ``family`` (``rand`` | ``sprand``)."""
    if family == "rand":
        return random_standard_lp(m, n, seed=seed)
    if family == "sprand":
        return sparse_random_standard_lp(m, n, density, seed=seed)
    raise ValueError(f"unknown instance family {family!r}; expected "
                     f"'rand' or 'sprand'")
