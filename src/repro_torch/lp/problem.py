"""LP problem containers and canonicalization (a numpy-only copy of
``repro.lp.problem``; the port imports nothing of the JAX package).

The paper (Section 2.1) works with the general form

    min c^T x   s.t.  G x >= h,   A x = b,   l <= x_i <= u

and, "upon suitable projection", with the standard form

    min c^T x   s.t.  K x = b,    lb <= x <= ub        (eq. 3 + Alg. 4)

``LPProblem`` holds the general form; ``StandardLP`` the canonical form the
in-memory solver consumes.  Conversion introduces one slack variable per
inequality row (``G x - s = h``, ``s >= 0``).

``StandardLP.K`` may be either a dense ndarray or a host-side
``SparseCOO`` — the paper's headline workloads are large sparse LPs, and
carrying the nonzeros explicitly lets the batch scheduler pad, stack and
solve them without ever materializing an (m, n) dense matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

INF = np.inf


class SparseCOO:
    """Host-side COO sparse matrix (data/row/col triplet + shape).

    Deliberately dependency-free (no scipy in the tier-1 environment) and
    minimal: exactly the surface the LP containers and the batch
    scheduler need — matvec (``@``), transpose view (``.T``), dtype
    casts, shape-growing pads, and densification on demand.  Duplicate
    indices are allowed and sum (the scatter-add convention).
    """

    __slots__ = ("data", "row", "col", "shape")

    def __init__(self, data, row, col, shape: Tuple[int, int]):
        self.data = np.asarray(data).reshape(-1)
        if not np.issubdtype(self.data.dtype, np.floating):
            self.data = self.data.astype(np.float64)
        self.row = np.asarray(row, np.int32).reshape(-1)
        self.col = np.asarray(col, np.int32).reshape(-1)
        self.shape = (int(shape[0]), int(shape[1]))
        assert self.data.shape == self.row.shape == self.col.shape
        if self.data.size:
            assert int(self.row.max()) < self.shape[0], "row index out of range"
            assert int(self.col.max()) < self.shape[1], "col index out of range"

    # -- constructors --------------------------------------------------

    @classmethod
    def from_dense(cls, K) -> "SparseCOO":
        K = np.asarray(K)
        row, col = np.nonzero(K)
        return cls(K[row, col], row, col, K.shape)

    # -- properties ----------------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / max(m * n, 1)

    @property
    def T(self) -> "SparseCOO":
        return SparseCOO(self.data, self.col, self.row,
                         (self.shape[1], self.shape[0]))

    # -- ops -----------------------------------------------------------

    def __matmul__(self, x):
        x = np.asarray(x)
        assert x.ndim == 1 and x.shape[0] == self.shape[1], \
            (x.shape, self.shape)
        out = np.zeros(self.shape[0], np.result_type(self.dtype, x.dtype))
        np.add.at(out, self.row, self.data * x[self.col])
        return out

    def astype(self, dtype) -> "SparseCOO":
        return SparseCOO(self.data.astype(dtype), self.row, self.col,
                         self.shape)

    def with_shape(self, m: int, n: int) -> "SparseCOO":
        """Grow the logical shape (zero padding) without touching data."""
        assert m >= self.shape[0] and n >= self.shape[1], \
            (self.shape, (m, n))
        return SparseCOO(self.data, self.row, self.col, (m, n))

    def toarray(self) -> np.ndarray:
        out = np.zeros(self.shape, self.dtype)
        np.add.at(out, (self.row, self.col), self.data)
        return out

    def coalesce(self) -> "SparseCOO":
        """Sum duplicate (row, col) entries into one.  The batch
        pipeline's scatter preconditioners reduce over STORED entries,
        so duplicates must be merged before stacking for sparse/dense
        parity to hold."""
        flat = self.row.astype(np.int64) * self.shape[1] + self.col
        uniq, inv = np.unique(flat, return_inverse=True)
        if uniq.size == self.data.size:
            return self
        data = np.zeros(uniq.size, self.dtype)
        np.add.at(data, inv, self.data)
        row, col = np.divmod(uniq, self.shape[1])
        return SparseCOO(data, row, col, self.shape)

    def __repr__(self):
        return (f"SparseCOO(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype.name})")


@dataclasses.dataclass
class StandardLP:
    """min c@x  s.t.  K@x = b,  lb <= x <= ub   (host-side).

    ``K`` is either a dense ndarray or a ``SparseCOO``; the floating
    dtype of ``K`` is preserved (f32 streams stay f32 end-to-end — no
    silent f64 promotion) and the vector data follows it.  Non-floating
    input defaults to float64.
    """

    c: np.ndarray            # (n,)
    K: object                # (m, n) dense ndarray | SparseCOO
    b: np.ndarray            # (m,)
    lb: np.ndarray           # (n,)  may be -inf
    ub: np.ndarray           # (n,)  may be +inf
    # Optional metadata
    name: str = "lp"
    x_opt: Optional[np.ndarray] = None   # known optimal solution, if any
    obj_opt: Optional[float] = None      # known optimal objective, if any

    def __post_init__(self):
        if not isinstance(self.K, SparseCOO):
            self.K = np.asarray(self.K)
            if not np.issubdtype(self.K.dtype, np.floating):
                self.K = self.K.astype(np.float64)
        dt = self.K.dtype
        self.c = np.asarray(self.c, dtype=dt).reshape(-1)
        self.b = np.asarray(self.b, dtype=dt).reshape(-1)
        m, n = self.K.shape
        if self.lb is None:
            self.lb = np.zeros(n, dt)
        if self.ub is None:
            self.ub = np.full(n, INF, dt)
        self.lb = np.broadcast_to(np.asarray(self.lb, dt), (n,)).copy()
        self.ub = np.broadcast_to(np.asarray(self.ub, dt), (n,)).copy()
        assert self.c.shape == (n,), (self.c.shape, n)
        assert self.b.shape == (m,), (self.b.shape, m)

    @property
    def shape(self):
        return self.K.shape

    @property
    def is_sparse(self) -> bool:
        return isinstance(self.K, SparseCOO)

    @property
    def K_dense(self) -> np.ndarray:
        """Dense view of K for paths that need the full matrix (e.g.
        crossbar programming, which burns every physical cell anyway)."""
        return self.K.toarray() if self.is_sparse else self.K

    def densified(self) -> "StandardLP":
        """Copy with a dense K (identity for already-dense problems)."""
        if not self.is_sparse:
            return self
        return dataclasses.replace(self, K=self.K.toarray())

    def sparsified(self) -> "StandardLP":
        """Copy with a SparseCOO K (identity if already sparse)."""
        if self.is_sparse:
            return self
        return dataclasses.replace(self, K=SparseCOO.from_dense(self.K))

    def objective(self, x: np.ndarray) -> float:
        return float(self.c @ x)

    def feasibility_error(self, x: np.ndarray) -> float:
        """Scaled primal feasibility error (matches paper's r_pri)."""
        r = np.linalg.norm(self.K @ x - self.b) / (1.0 + np.linalg.norm(self.b))
        box = np.linalg.norm(np.maximum(self.lb - x, 0.0)) + np.linalg.norm(
            np.maximum(x - self.ub, 0.0)
        )
        return float(r + box)


@dataclasses.dataclass
class LPProblem:
    """General form (paper eq. 1):  min c@x, Gx>=h, Ax=b, l<=x<=u."""

    c: np.ndarray
    G: Optional[np.ndarray] = None   # (m1, n)
    h: Optional[np.ndarray] = None   # (m1,)
    A: Optional[np.ndarray] = None   # (m2, n)
    b: Optional[np.ndarray] = None   # (m2,)
    lb: Optional[np.ndarray] = None
    ub: Optional[np.ndarray] = None
    name: str = "lp"

    def __post_init__(self):
        self.c = np.asarray(self.c, np.float64).reshape(-1)
        n = self.c.shape[0]
        if self.G is None:
            self.G = np.zeros((0, n))
            self.h = np.zeros((0,))
        if self.A is None:
            self.A = np.zeros((0, n))
            self.b = np.zeros((0,))
        self.G = np.asarray(self.G, np.float64)
        self.h = np.asarray(self.h, np.float64).reshape(-1)
        self.A = np.asarray(self.A, np.float64)
        self.b = np.asarray(self.b, np.float64).reshape(-1)
        if self.lb is None:
            self.lb = np.full(n, -INF)
        if self.ub is None:
            self.ub = np.full(n, INF)
        self.lb = np.broadcast_to(np.asarray(self.lb, np.float64), (n,)).copy()
        self.ub = np.broadcast_to(np.asarray(self.ub, np.float64), (n,)).copy()

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m1(self) -> int:
        return self.G.shape[0]

    @property
    def m2(self) -> int:
        return self.A.shape[0]

    def saddle_data(self):
        """K = [G; A], q = [h; b] for the saddle problem (eq. 2)."""
        K = np.concatenate([self.G, self.A], axis=0)
        q = np.concatenate([self.h, self.b], axis=0)
        return K, q, self.m1, self.m2

    def to_standard(self) -> StandardLP:
        """Equality-only canonical form: add slacks s>=0 for Gx - s = h."""
        n, m1, m2 = self.n, self.m1, self.m2
        K = np.zeros((m1 + m2, n + m1))
        K[:m1, :n] = self.G
        K[:m1, n:] = -np.eye(m1)
        K[m1:, :n] = self.A
        b = np.concatenate([self.h, self.b])
        c = np.concatenate([self.c, np.zeros(m1)])
        lb = np.concatenate([self.lb, np.zeros(m1)])
        ub = np.concatenate([self.ub, np.full(m1, INF)])
        return StandardLP(c=c, K=K, b=b, lb=lb, ub=ub, name=self.name)


def split_standard_solution(lp: LPProblem, x_std: np.ndarray) -> np.ndarray:
    """Drop slack coordinates of a standard-form solution."""
    return np.asarray(x_std)[: lp.n]
