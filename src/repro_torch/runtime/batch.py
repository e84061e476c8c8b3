"""Shape-bucketed batch solving of heterogeneous LP streams; the port of
``repro.runtime.batch``.

The paper frames RRAM crossbars as *shared* linear-optimization
accelerators: many independent LP instances arrive with arbitrary shapes
and must be served together.  This scheduler

  1. rounds every instance up to a ``(m_pad, n_pad)`` bucket (padding is
     exact: extra primal coordinates are pinned at lb=ub=0, extra rows
     are all-zero with b=0, so the optimum is unchanged); buckets are
     powers of two by default, or multiples of the physical crossbar
     tile (``tile=``),
  2. stacks each bucket ((B, ...) tensors, B a power of two with filler
     lanes) and serves it through one bucket pipeline: Ruiz +
     diagonal preconditioning, the norm estimate and the batched PDHG
     loop (``engine.solve_core``) over every lane at once,
  3. caches the pipeline object per (bucket, batch, dtype, options,
     device) signature, keyed as the reference keys its executables, so
     repeat traffic builds nothing, and
  4. strips padding and returns per-instance results in input order.

Sparse instances (``lp.is_sparse``) route through a sparse pipeline
selected by ``PDHGOptions.sparse_kernel``: ``"ell"`` (the default)
stores the forward ELL form of K and the ELL form of K^T ((B, m, Wf)
and (B, n, Wa), widths power-of-two bucketed) and runs every MVM of the
norm estimate and of the solve on B4 (``kernels.sparse_mvm``), with
``megakernel`` one B5 launch a window; ``"bcoo"`` keeps the
nonzero-proportional COO stacking and torch sparse products.  Neither
ever builds a dense (B, m, n) stack.

Every lane draws its start iterate from its own ``torch.Generator``,
seeded from ``(opts.seed, position in the stream)`` (filler lanes take
the positions past the stream's end); the norm estimate starts every
lane from the same seeded vector.  ``draws=`` injects all of them instead
(the parity tests hand in the reference's).

Async serving: every bucket gets its own CUDA stream, and one host thread
enqueues check windows round-robin across the pending buckets; each
bucket's loop reads its stream once a window (``active.any()``), so the
card always has the other buckets' windows queued.  ``async_dispatch=
False`` serves one bucket at a time; both give the same numbers.

With a ``mesh`` (``runtime.mesh``), every rank of it serves the same
stream: each bucket's padded batch is a multiple of the ``batch_axes``
ranks, each rank solves its contiguous share of the lanes (no
collective during the solve), and the shares are gathered in bucket
order once every bucket has finished, so every rank returns the whole
stream's results.  The hooks ``_route``/``_bucket_served``/
``_gather_remote`` let ``runtime.cluster`` route whole buckets to pods.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import spans
from .._device import resolve_device
from ..core import engine
from ..core.lanczos import (
    NORM_BACKENDS,
    default_start,
    lanczos_svd_jit_mv,
    power_iteration_mv,
)
from ..core.pdhg import PDHGOptions, opts_static, torch_dtype
from ..core.precondition import apply_ruiz, diagonal_precondition
from ..core.symblock import build_sym_block
from ..kernels import _build
from ..kernels.sparse_mvm import (
    coo_row_widths,
    ell_from_coo,
    ell_matvec,
    ell_row_len,
    ell_width_bucket,
    lane_index,
)
from ..lp.problem import SparseCOO, StandardLP
from . import sanitize

MIN_BUCKET = 8
MIN_NNZ_BUCKET = 16
# free the raw stacked operator once its scaled copy exists past this
# size (on a card; the counterpart of the reference's buffer donation)
DONATE_MIN_BYTES = 32 << 20
# norm-reuse serving (``BatchSolver(norm_reuse=True)``): instances whose
# (shape bucket, sparsity fingerprint) already has a cached operator-norm
# estimate run this many power-iteration refinement MVMs instead of the
# full ``opts.lanczos_iters``-step estimate
NORM_REFINE_ITERS = 8


# ------------------------------------------------------------- bucketing ---

def _ceil_to(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def bucket_dims(m: int, n: int, min_size: int = MIN_BUCKET,
                tile: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """Round ``(m, n)`` up to its bucket.

    Default mode rounds to the enclosing power of two.  With
    ``tile=(rows, cols)`` (device-tile mode) dims snap to multiples of the
    physical crossbar tile instead, so a bucket always fills whole tiles:
    ``bucket_dims(8, 70, tile=(64, 64)) == (64, 128)``.
    """
    if tile is not None:
        tr, tc = tile
        return _ceil_to(max(int(m), 1), tr), _ceil_to(max(int(n), 1), tc)
    up = lambda v: max(min_size, 1 << (int(v) - 1).bit_length())  # noqa: E731
    return up(m), up(n)


def nnz_bucket(nnz: int, min_size: int = MIN_NNZ_BUCKET) -> int:
    """Round a nonzero count up to its power-of-two bucket (so repeat
    sparse traffic with drifting nnz reuses bucket pipelines)."""
    return max(min_size, 1 << (max(int(nnz), 1) - 1).bit_length())


def pad_problem(lp: StandardLP, m_pad: int, n_pad: int) -> StandardLP:
    """Embed ``lp`` in an (m_pad, n_pad) problem with identical optimum.

    Extra variables are pinned (lb=ub=0, c=0); extra rows are zero with
    b=0.  Any solution of the padded problem restricts to one of the
    original and vice versa.  Padding is dtype-preserving and
    sparse-preserving (a SparseCOO K just grows its logical shape; the
    nonzeros are never densified).
    """
    m, n = lp.K.shape
    assert m_pad >= m and n_pad >= n, ((m, n), (m_pad, n_pad))
    dt = lp.K.dtype
    if isinstance(lp.K, SparseCOO):
        K = lp.K.with_shape(m_pad, n_pad)
    else:
        K = np.zeros((m_pad, n_pad), dt)
        K[:m, :n] = lp.K
    b = np.zeros(m_pad, dt)
    b[:m] = lp.b
    c = np.zeros(n_pad, dt)
    c[:n] = lp.c
    lb = np.zeros(n_pad, dt)
    ub = np.zeros(n_pad, dt)
    lb[:n] = lp.lb
    ub[:n] = lp.ub
    x_opt = None
    if lp.x_opt is not None:
        x_opt = np.zeros(n_pad, np.asarray(lp.x_opt).dtype)
        x_opt[:n] = lp.x_opt
    return StandardLP(c=c, K=K, b=b, lb=lb, ub=ub, name=lp.name,
                      x_opt=x_opt, obj_opt=lp.obj_opt)


def stack_problems(lps: Sequence[StandardLP], m: Optional[int] = None,
                   n: Optional[int] = None) -> tuple:
    """Pad a list of StandardLPs to a common shape and DENSE-stack.

    Target dims default to the max over the list; buckets pass them
    explicitly.  Sparse members are densified — sparse streams go
    through ``stack_problems_sparse``/``stack_problems_ell`` instead,
    which never materialize (B, m, n).
    """
    lps = [lp.densified() for lp in lps]
    m = m if m is not None else max(lp.K.shape[0] for lp in lps)
    n = n if n is not None else max(lp.K.shape[1] for lp in lps)
    padded = [pad_problem(lp, m, n) for lp in lps]
    return tuple(
        np.stack([getattr(p, f) for p in padded])
        for f in ("K", "b", "c", "lb", "ub"))


def stack_problems_sparse(lps: Sequence[StandardLP],
                          m: Optional[int] = None,
                          n: Optional[int] = None,
                          nnz: Optional[int] = None) -> tuple:
    """Stack sparse StandardLPs WITHOUT densifying K.

    Returns ``(data (B, nnz), idx (B, nnz, 2) int32, b, c, lb, ub)``.
    Shape padding is purely logical (zero rows / pinned variables, as in
    ``pad_problem``); nnz padding appends explicit zero entries at
    (0, 0), which contribute nothing to any contraction or scaling.
    """
    assert lps and all(isinstance(lp.K, SparseCOO) for lp in lps), \
        "stack_problems_sparse needs SparseCOO operators"
    m = m if m is not None else max(lp.K.shape[0] for lp in lps)
    n = n if n is not None else max(lp.K.shape[1] for lp in lps)
    nnz = nnz if nnz is not None else max(lp.K.nnz for lp in lps)
    B = len(lps)
    dt = lps[0].K.dtype
    data = np.zeros((B, nnz), dt)
    idx = np.zeros((B, nnz, 2), np.int32)
    vecs = {f: np.zeros((B, dim), dt)
            for f, dim in (("b", m), ("c", n), ("lb", n), ("ub", n))}
    for k, lp in enumerate(lps):
        # coalesce duplicates: the pipeline's scatter preconditioners
        # reduce over stored entries, so parity with the densified
        # problem requires one entry per (row, col)
        K = lp.K.coalesce()
        assert K.shape[0] <= m and K.shape[1] <= n and K.nnz <= nnz, \
            (K.shape, K.nnz, (m, n, nnz))
        data[k, :K.nnz] = K.data
        idx[k, :K.nnz, 0] = K.row
        idx[k, :K.nnz, 1] = K.col
        for f, arr in vecs.items():
            v = getattr(lp, f)
            arr[k, :v.shape[0]] = v
    return (data, idx, vecs["b"], vecs["c"], vecs["lb"], vecs["ub"])


def stack_problems_ell(lps: Sequence[StandardLP],
                       m: Optional[int] = None,
                       n: Optional[int] = None,
                       wf: Optional[int] = None,
                       wa: Optional[int] = None) -> tuple:
    """Stack sparse StandardLPs in row-blocked ELL form.

    Returns ``(data_f (B, m, wf), cols_f (B, m, wf) int32,
    data_a (B, n, wa), cols_a (B, n, wa) int32, b, c, lb, ub)``.
    The forward layout is the ELL form of K, the adjoint layout the ELL
    form of K^T — storing both keeps every pipeline reduction and both
    solve MVMs scatter-free.  ``wf``/``wa`` default to the exact max
    row/column occupancy over the list (buckets pass their power-of-two
    widths explicitly).  ELL padding slots carry (data 0, col 0), the
    same inertness contract as ``stack_problems_sparse``'s (0, 0)
    entries; explicit zero nonzeros are dropped during conversion, so
    they never widen a row.
    """
    assert lps and all(isinstance(lp.K, SparseCOO) for lp in lps), \
        "stack_problems_ell needs SparseCOO operators"
    m = m if m is not None else max(lp.K.shape[0] for lp in lps)
    n = n if n is not None else max(lp.K.shape[1] for lp in lps)
    if wf is None or wa is None:
        widths = [coo_row_widths(lp.K.row, lp.K.col, lp.K.data,
                                 lp.K.shape) for lp in lps]
        wf = wf if wf is not None else max(w[0] for w in widths)
        wa = wa if wa is not None else max(w[1] for w in widths)
    B = len(lps)
    dt = lps[0].K.dtype
    data_f = np.zeros((B, m, wf), dt)
    cols_f = np.zeros((B, m, wf), np.int32)
    data_a = np.zeros((B, n, wa), dt)
    cols_a = np.zeros((B, n, wa), np.int32)
    vecs = {f: np.zeros((B, dim), dt)
            for f, dim in (("b", m), ("c", n), ("lb", n), ("ub", n))}
    for k, lp in enumerate(lps):
        # coalesce first: ELL stores one slot per (row, col), so
        # duplicates must merge for parity with the densified problem
        K = lp.K.coalesce()
        assert K.shape[0] <= m and K.shape[1] <= n, (K.shape, (m, n))
        # B4 trusts its column indices: one outside the operator would
        # read past the end of the vector on the card
        if np.size(K.row) and (min(K.row.min(), K.col.min()) < 0
                               or K.row.max() >= K.shape[0]
                               or K.col.max() >= K.shape[1]):
            raise ValueError(f"instance {k}: COO indices outside its "
                             f"{K.shape} operator")
        data_f[k], cols_f[k] = ell_from_coo(K.data, K.row, K.col,
                                            (m, n), width=wf)
        data_a[k], cols_a[k] = ell_from_coo(K.data, K.col, K.row,
                                            (n, m), width=wa)
        for f, arr in vecs.items():
            v = getattr(lp, f)
            arr[k, :v.shape[0]] = v
    return (data_f, cols_f, data_a, cols_a,
            vecs["b"], vecs["c"], vecs["lb"], vecs["ub"])


# ------------------------------------------------------------- the draws ---

class LaneDraws(NamedTuple):
    """One bucket's random inputs, on its device: ``x0`` (B, n) (clipped
    by the pipeline to the scaled bounds), ``y0`` (B, m), ``v0`` the norm
    estimate's (dim,) start shared by every lane, ``program`` the
    crossbar pipeline's programming draws — a (z_pos, z_neg) pair of
    (B, R, C) tensors, or the lanes' generators to draw them from — and
    ``noise`` the generator of the bucket's read noise (None when the
    pipeline is noiseless)."""

    x0: torch.Tensor
    y0: torch.Tensor
    v0: torch.Tensor
    program: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    noise: Optional[torch.Generator] = None


def lane_seed(seed: int, position: int) -> int:
    """The seed of one lane's generator, from the stream seed and the
    lane's position (distinct positions give unrelated streams)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), int(position)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def seeded_lane_draws(seeds: Sequence[int], mb: int, nb: int, dtype,
                      device) -> LaneDraws:
    """Each lane's start from its own generator (seeded ``seeds[i]``):
    x0 (nb,), then y0 (mb,); the norm estimate's shared seeded start;
    the generators as ``program`` (the crossbar pipeline draws each
    lane's programming error from them next)."""
    gens = [torch.Generator(device=device).manual_seed(k) for k in seeds]
    x0 = torch.stack([torch.randn(nb, generator=g, dtype=dtype,
                                  device=device) for g in gens])
    y0 = torch.stack([torch.randn(mb, generator=g, dtype=dtype,
                                  device=device) for g in gens])
    return LaneDraws(x0, y0, default_start(mb + nb, dtype, device), gens)


# -------------------------------------------------------------- pipeline ---

def prep_scale(K, b, c, lb, ub, opts: PDHGOptions):
    """Ruiz + diagonal preconditioning (Algorithm 4 step 0) over a
    (B, m, n) stack.  Returns the scaled problem, the diagonal step
    scalings (T, Sigma) and the unscaling diagonals (D1, D2).  The norm
    estimate is NOT included: callers estimate rho on whichever operator
    they actually execute."""
    scaled = apply_ruiz(K, b, c, lb, ub, iters=opts.ruiz_iters)
    T, Sigma = diagonal_precondition(scaled.K)
    return (scaled.K, scaled.b, scaled.c, scaled.lb, scaled.ub, T, Sigma,
            scaled.D1, scaled.D2)


def _check_norm_backend(opts: PDHGOptions) -> None:
    if opts.norm_backend not in NORM_BACKENDS:
        raise ValueError(f"unknown norm_backend {opts.norm_backend!r}; "
                         f"expected one of {NORM_BACKENDS}")


def _estimate_norm_mv(mv, dim: int, batch: int, v0, opts: PDHGOptions,
                      rho_seeds=None):
    """RAW (B,) operator-norm estimates (no Lemma-2 margin) on a batched
    symmetric matvec, per ``opts.norm_backend``.  With ``rho_seeds``
    (cached estimates of the same sparsity fingerprints) only a short
    power refinement runs, floored at the seeds."""
    kw = dict(v0=v0, device=v0.device, batch=batch)
    if rho_seeds is not None:
        est = power_iteration_mv(mv, dim, v0.dtype, iters=NORM_REFINE_ITERS,
                                 **kw)
        return torch.maximum(est, rho_seeds)
    if opts.norm_backend == "power":
        return power_iteration_mv(mv, dim, v0.dtype,
                                  iters=opts.lanczos_iters, **kw)
    return lanczos_svd_jit_mv(mv, dim, v0.dtype, k_max=opts.lanczos_iters,
                              **kw)


def _row_reduce(a, reduce_fn):
    """Reduction of (..., rows, W) ELL values over W, total-safe at
    W == 0 (an all-zero operator's ELL form has zero width)."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    return reduce_fn(a, dim=-1)


class BucketPipeline:
    """One bucket signature's pipeline (the reference's compiled
    executable): built once per cache key, with its options, its update
    and operator backends and, on a card, the loaded kernel library.

    ``run(arrays, draws, rho_seeds, donate, read)`` is a generator over
    one stacked bucket: it yields before each window's host read (see
    ``engine.pdhg_loop``) and returns ``(outputs, windows)`` with
    ``outputs`` the per-lane ``(x, y, its, merits, rhos)`` in the
    original coordinates, on the device.  ``arrays`` is a list the
    pipeline takes over: with ``donate`` it drops the raw stacked
    operator as soon as the scaled copy exists."""

    uses_kernels = False

    def __init__(self, opts: PDHGOptions, sigma_read: float = 0.0,
                 device=None):
        self.opts = opts
        self.sigma_read = float(sigma_read)
        self.static = opts_static(opts, sigma_read)
        _check_norm_backend(opts)
        self.torch_device = resolve_device(device)
        if self.torch_device.type == "cuda" and (
                self.uses_kernels or opts.kernel == "cuda"):
            _build.library()        # bind the kernels (built on first use)

    def _rho(self, mv, dim, batch, draws, rho_seeds, dtype):
        """(raw estimate, the estimate the solve uses)."""
        if self.opts.norm_override is not None:
            rho = torch.full((batch,), float(self.opts.norm_override),
                             dtype=dtype, device=self.torch_device)
            return rho, rho
        with spans.span("solve.norm"):
            raw = _estimate_norm_mv(mv, dim, batch, draws.v0, self.opts,
                                    rho_seeds)
            return raw, engine.lemma2_margin(raw, self.sigma_read)

    def run(self, arrays: list, draws: LaneDraws, rho_seeds=None,
            donate: bool = False, read: Callable = bool):
        K, b, c, lb, ub = arrays
        with spans.span("solve.prepare"):
            (Ks, bs, cs, lbs, ubs, T, Sigma, D1, D2) = prep_scale(
                K, b, c, lb, ub, self.opts)
        if donate:
            arrays[0] = K = None
        B, m, n = Ks.shape
        Keff = (torch.sqrt(Sigma)[..., :, None] * Ks
                * torch.sqrt(T)[..., None, :])
        M = build_sym_block(Keff)
        del Keff
        rho_raw, rho = self._rho(engine.matvec(M), m + n, B, draws,
                                 rho_seeds, Ks.dtype)
        del M
        x0 = torch.clamp(draws.x0, lbs, ubs)
        x, y, its, merit, windows = yield from engine.solve_core(
            Ks, None, bs, cs, lbs, ubs, T, Sigma, rho,
            draws.noise, self.static, x0=x0, y0=draws.y0, read=read)
        return (D2 * x, D1 * y, its, merit, rho_raw), windows


def make_bucket_pipeline(opts: PDHGOptions, sigma_read: float = 0.0,
                         device=None):
    """Prep + solve over a stacked dense (B, m, n) bucket."""
    return BucketPipeline(opts, sigma_read, device)


def _prep_one_sparse(data, idx, b, c, lb, ub, opts: PDHGOptions):
    """Sparse Ruiz + Pock–Chambolle diagonals on stacked COO nonzeros.

    Mirrors ``precondition.apply_ruiz``/``diagonal_precondition`` (same
    eps, same sqrt-of-inf-norm update), every row/col reduction a scatter
    over the stored entries of all lanes at once (indices offset by
    lane); padded zero entries at (0, 0) contribute nothing.  Returns the
    scaled nonzeros, the same layout as ``prep_scale`` after them, and
    the flattened row/col indices."""
    dt = data.dtype
    B, m, n = b.shape[0], b.shape[-1], c.shape[-1]
    lanes = torch.arange(B, device=data.device)[:, None]
    row = (idx[..., 0].long() + lanes * m).reshape(-1)
    col = (idx[..., 1].long() + lanes * n).reshape(-1)
    eps = 1e-12
    one = torch.ones((), dtype=dt, device=data.device)
    D1 = torch.ones(B * m, dtype=dt, device=data.device)
    D2 = torch.ones(B * n, dtype=dt, device=data.device)
    flat = data.reshape(-1)
    d = flat

    def scatter(index, size, values, how):
        out = torch.zeros(size, dtype=dt, device=data.device)
        if how == "max":
            return out.scatter_reduce_(0, index, values, "amax")
        return out.index_add_(0, index, values)

    for _ in range(opts.ruiz_iters):
        ad = torch.abs(d)
        r = torch.sqrt(scatter(row, B * m, ad, "max"))
        cc = torch.sqrt(scatter(col, B * n, ad, "max"))
        r = torch.where(r < eps, one, r)
        cc = torch.where(cc < eps, one, cc)
        D1 = D1 / r
        D2 = D2 / cc
        d = flat * D1[row] * D2[col]
    D1, D2 = D1.view(B, m), D2.view(B, n)
    bs = D1 * b
    cs = D2 * c
    lbs = torch.where(torch.isfinite(lb), lb / D2, lb)
    ubs = torch.where(torch.isfinite(ub), ub / D2, ub)
    ad = torch.abs(d)
    T = 1.0 / torch.clamp(scatter(col, B * n, ad, "sum"), min=eps)
    Sigma = 1.0 / torch.clamp(scatter(row, B * m, ad, "sum"), min=eps)
    return (d, bs, cs, lbs, ubs, T.view(B, n), Sigma.view(B, m), D1, D2,
            row, col)


class SparseBucketPipeline(BucketPipeline):
    """Prep + solve over a stacked COO bucket (``stack_problems_sparse``
    layout): the norm estimate runs two COO contractions an iteration on
    the symmetric block of Sigma^{1/2} K T^{1/2}, and the solve mounts
    ``engine.sparse_operator`` on a torch sparse COO batch of the scaled
    nonzeros.  No dense (m, n) array ever exists."""

    def run(self, arrays: list, draws: LaneDraws, rho_seeds=None,
            donate: bool = False, read: Callable = bool):
        kd, ki, b, c, lb, ub = arrays
        with spans.span("solve.prepare"):
            (d, bs, cs, lbs, ubs, T, Sigma, D1, D2, row, col) = \
                _prep_one_sparse(kd, ki, b, c, lb, ub, self.opts)
        if donate:
            arrays[0] = kd = None
        B, m, n = bs.shape[0], bs.shape[-1], cs.shape[-1]

        def mv(v):         # symmetric block M' of Keff, matvec-only
            top = engine.coo_matvec(deff, row, col, v[:, m:], (B, m))
            bot = engine.coo_matvec(deff, col, row, v[:, :m], (B, n))
            return torch.cat([top, bot], dim=-1)

        deff = (d * torch.sqrt(Sigma).reshape(-1)[row]
                * torch.sqrt(T).reshape(-1)[col])
        rho_raw, rho = self._rho(mv, m + n, B, draws, rho_seeds, d.dtype)
        del deff
        lanes = torch.div(row, m, rounding_mode="floor")
        K_sp = torch.sparse_coo_tensor(
            torch.stack([lanes, row - lanes * m, col - lanes * n]), d,
            (B, m, n), check_invariants=False)
        op = engine.sparse_operator(K_sp, self.sigma_read, draws.noise)
        x0 = torch.clamp(draws.x0, lbs, ubs)
        x, y, its, merit, windows = yield from engine.solve_core(
            None, None, bs, cs, lbs, ubs, T, Sigma, rho, draws.noise,
            self.static, x0=x0, y0=draws.y0, operator=op, read=read)
        return (D2 * x, D1 * y, its, merit, rho_raw), windows


def make_sparse_bucket_pipeline(opts: PDHGOptions, sigma_read: float = 0.0,
                                device=None):
    """Prep + solve over a stacked COO bucket."""
    return SparseBucketPipeline(opts, sigma_read, device)


def _prep_one_ell(df, cf, da, ca, b, c, lb, ub, opts: PDHGOptions):
    """Sparse Ruiz + Pock–Chambolle diagonals on stacked ELL nonzeros.

    Mirrors ``_prep_one_sparse`` (same eps, same guard, same update
    order), but every row/column reduction is a max or sum over the last
    axis of the layout that already has it contiguous: row stats on the
    forward ELL, column stats on the adjoint ELL; ``D2[cf]`` is a
    per-lane gather.  No scatter anywhere.  Padding slots (data 0, col
    0) scale to 0 and never move a max or a sum.  Also returns the
    per-lane gather indices of both forms."""
    dt = df.dtype
    eps = 1e-12
    m, n = b.shape[-1], c.shape[-1]
    one = torch.ones((), dtype=dt, device=df.device)
    idx_f = lane_index(cf, n)
    idx_a = lane_index(ca, m)
    D1 = torch.ones(b.shape, dtype=dt, device=df.device)
    D2 = torch.ones(c.shape, dtype=dt, device=df.device)
    sf, sa = df, da
    for _ in range(opts.ruiz_iters):
        r = torch.sqrt(_row_reduce(torch.abs(sf), torch.amax))
        cc = torch.sqrt(_row_reduce(torch.abs(sa), torch.amax))
        r = torch.where(r < eps, one, r)
        cc = torch.where(cc < eps, one, cc)
        D1 = D1 / r
        D2 = D2 / cc
        sf = df * D1[..., None] * D2.reshape(-1)[idx_f]
        sa = da * D2[..., None] * D1.reshape(-1)[idx_a]
    bs = D1 * b
    cs = D2 * c
    lbs = torch.where(torch.isfinite(lb), lb / D2, lb)
    ubs = torch.where(torch.isfinite(ub), ub / D2, ub)
    T = 1.0 / torch.clamp(_row_reduce(torch.abs(sa), torch.sum), min=eps)
    Sigma = 1.0 / torch.clamp(_row_reduce(torch.abs(sf), torch.sum),
                              min=eps)
    return sf, sa, bs, cs, lbs, ubs, T, Sigma, D1, D2, idx_f, idx_a


class EllBucketPipeline(BucketPipeline):
    """Prep + solve over a stacked ELL bucket (``stack_problems_ell``
    layout).  Each form's row lengths are taken once, on the card; the
    norm estimate's matvec is two B4 launches on the symmetric block;
    the solve mounts ``engine.sparse_ell_operator`` (B4 on every MVM)
    and, with ``opts.megakernel`` on a noiseless bucket,
    ``engine.make_fused_ell`` (one B5 launch a window).  No dense (m, n)
    array and no scatter exists anywhere."""

    uses_kernels = True

    def run(self, arrays: list, draws: LaneDraws, rho_seeds=None,
            donate: bool = False, read: Callable = bool):
        df, cf, da, ca, b, c, lb, ub = arrays
        with spans.span("solve.prepare"):
            (sf, sa, bs, cs, lbs, ubs, T, Sigma, D1, D2, idx_f, idx_a) = \
                _prep_one_ell(df, cf, da, ca, b, c, lb, ub, self.opts)
            # every MVM of the bucket stops at each row's last stored
            # slot; the scaled forms store no slot that df/da leave empty
            rl_f, rl_a = ell_row_len(df, cf), ell_row_len(da, ca)
        if donate:
            arrays[0] = arrays[2] = df = da = None
        B, m, n = bs.shape[0], bs.shape[-1], cs.shape[-1]
        if self.opts.norm_override is None:
            rtS, rtT = torch.sqrt(Sigma), torch.sqrt(T)
            deff_f = sf * rtS[..., None] * rtT.reshape(-1)[idx_f]
            deff_a = sa * rtT[..., None] * rtS.reshape(-1)[idx_a]
        del idx_f, idx_a

        def mv(v):         # symmetric block M' of Keff, matvec-only
            top = ell_matvec(deff_f, cf, v[:, m:], rl_f)
            bot = ell_matvec(deff_a, ca, v[:, :m], rl_a)
            return torch.cat([top, bot], dim=-1)

        rho_raw, rho = self._rho(mv, m + n, B, draws, rho_seeds, sf.dtype)
        deff_f = deff_a = None
        op = engine.sparse_ell_operator(sf, cf, sa, ca, self.sigma_read,
                                        draws.noise, rl_f, rl_a)
        if self.opts.megakernel and self.sigma_read == 0.0:
            op = op._replace(fuse=engine.make_fused_ell(
                sf, cf, sa, ca, bs, cs, lbs, ubs, T, Sigma,
                self.opts.gamma, rl_f, rl_a))
        x0 = torch.clamp(draws.x0, lbs, ubs)
        x, y, its, merit, windows = yield from engine.solve_core(
            None, None, bs, cs, lbs, ubs, T, Sigma, rho, draws.noise,
            self.static, x0=x0, y0=draws.y0, operator=op, read=read)
        return (D2 * x, D1 * y, its, merit, rho_raw), windows


def make_ell_bucket_pipeline(opts: PDHGOptions, sigma_read: float = 0.0,
                             device=None):
    """Prep + solve over a stacked ELL bucket."""
    return EllBucketPipeline(opts, sigma_read, device)


# ------------------------------------------------------------- scheduler ---

@dataclasses.dataclass
class BatchItemResult:
    """Per-instance result with padding stripped."""

    name: str
    x: np.ndarray
    y: np.ndarray
    obj: float
    iterations: int
    merit: float
    converged: bool
    bucket: Tuple[int, int]
    mvm_calls: int = 0          # device MVMs (engine.mvm_accounting)
    sparse: bool = False        # served by a sparse (ELL/COO) pipeline

    @property
    def status(self) -> str:
        # a non-finite merit means the iterate blew up — that is
        # divergence, not a clean iteration limit (converged is already
        # False: NaN <= tol compares false)
        if not np.isfinite(self.merit):
            return "diverged"
        return "optimal" if self.converged else "iteration_limit"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


class BatchSolver:
    """Shape-bucketing scheduler with a pipeline cache.

    One instance amortizes set-up across calls: the first stream touching
    a ``(bucket, batch, dtype)`` signature builds the bucket pipeline (a
    cache MISS, the counterpart of the reference's compile); every later
    stream with the same signature reuses it (a HIT).  The cache key is
    the reference's ``_cache_key``.

    ``tile`` switches bucketing to device-tile mode; ``sigma_read`` adds
    multiplicative per-MVM read noise; ``kernel`` ("torch" | "cuda")
    selects the engine's update backend (all part of the cache key).
    Subclasses (``crossbar.solver.CrossbarBatchSolver``) override
    ``_make_pipeline``/``_collect``/``_device_signature``/``_lane_draws``
    to run device physics in the same bucketed harness.

    Sparse instances are bucketed separately (shape bucket plus the pair
    of ELL width buckets, or the nnz bucket for ``sparse_kernel="bcoo"``)
    when the solver ``supports_sparse``.  ``async_dispatch`` interleaves
    the buckets' windows on their own CUDA streams (False: one bucket at
    a time).  ``donate_min_bytes`` is the stacked-operator size beyond
    which the raw stack is freed once scaled.  ``last_stream_stats``
    records, per ``solve_stream`` call, the host bytes each stacking path
    built, the dispatch/collect times (the spans ``serve.dispatch`` and
    ``serve.collect``, which always time themselves), each bucket's
    windows and ``compiles``: cache misses plus kernel builds
    (``runtime.sanitize``; a warm pass over a bucket mix served before
    must report 0).
    ``transfer_sanitize=True`` runs every pipeline under
    ``sanitize.no_implicit_transfers()``, which allows only the stacking
    upload and the one host read a window.

    ``norm_reuse=True`` turns on the cross-instance operator-norm cache
    (keyed by ``_norm_fingerprint``): a bucket whose instances ALL have
    cached estimates is served by the seeded twin pipeline, which runs a
    ``NORM_REFINE_ITERS``-step power refinement floored at the cached
    value instead of the full estimate; the twin is built on the cold
    pass, so warm streams stay at zero compiles.

    A call is the span ``serve`` (``repro_torch.spans``) over
    ``serve.group`` (bucketing), each bucket's ``serve.stack`` and
    ``serve.upload``, and ``serve.step`` (one resumption of a bucket's
    pipeline, its loop's spans inside).

    ``torch_device`` is the hardware (default the card, or the
    ``mesh``'s device).  ``mesh`` shards each bucket's lanes over the
    ranks of ``batch_axes`` (see the module's docstring): every rank of
    the mesh serves the same stream and returns every result.
    """

    supports_sparse = True

    def __init__(self, opts: PDHGOptions = PDHGOptions(), *,
                 mesh=None, batch_axes: Tuple[str, ...] = ("data",),
                 min_bucket: int = MIN_BUCKET,
                 sigma_read: float = 0.0,
                 tile: Optional[Tuple[int, int]] = None,
                 kernel: Optional[str] = None,
                 async_dispatch: bool = True,
                 donate_min_bytes: int = DONATE_MIN_BYTES,
                 transfer_sanitize: bool = False,
                 norm_reuse: bool = False,
                 torch_device=None):
        if kernel is not None:
            # the kernel choice rides in opts and therefore in every
            # cache signature
            opts = dataclasses.replace(opts, kernel=kernel)
        self.opts = opts
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.min_bucket = min_bucket
        self.sigma_read = float(sigma_read)
        self.tile = None if tile is None else (int(tile[0]), int(tile[1]))
        self.async_dispatch = bool(async_dispatch)
        self.donate_min_bytes = int(donate_min_bytes)
        self.transfer_sanitize = bool(transfer_sanitize)
        self.norm_reuse = bool(norm_reuse)
        self.torch_device = (mesh.device if mesh is not None
                             and torch_device is None
                             else resolve_device(torch_device))
        self._cache = {}
        self._norm_cache: dict = {}
        self._seeded_idxs: set = set()
        self._streams: list = []
        self.cache_hits = 0
        self.cache_misses = 0
        self._draws: Optional[Callable] = None
        self.last_stream_stats: dict = {}

    # -- subclass hooks -----------------------------------------------

    def _bucket(self, m: int, n: int) -> Tuple[int, int]:
        return bucket_dims(m, n, min_size=self.min_bucket, tile=self.tile)

    def _make_pipeline(self):
        return make_bucket_pipeline(self.opts, self.sigma_read,
                                    device=self.torch_device)

    def _make_sparse_pipeline(self):
        return make_sparse_bucket_pipeline(self.opts, self.sigma_read,
                                           device=self.torch_device)

    def _make_ell_pipeline(self):
        return make_ell_bucket_pipeline(self.opts, self.sigma_read,
                                        device=self.torch_device)

    def _device_signature(self):
        """Hashable device component of the cache key."""
        return None

    # -- pipeline cache -----------------------------------------------

    def _batch_quantum(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.size(self.batch_axes)

    def _padded_batch(self, n_items: int) -> int:
        pow2 = 1 << (n_items - 1).bit_length()
        return _ceil_to(pow2, self._batch_quantum())

    def _local_lanes(self, B: int) -> slice:
        """This rank's share of a padded batch of ``B`` lanes."""
        share = B // self._batch_quantum()
        lo = 0 if self.mesh is None else \
            self.mesh.index(self.batch_axes) * share
        return slice(lo, lo + share)

    def _cache_key(self, shape_sig, B: int, dtype, donate: bool):
        return (shape_sig, B, _dtype_name(dtype), bool(donate),
                opts_static(self.opts, self.sigma_read),
                # prep-stage options that shape the pipeline but live
                # outside the solve-core static tuple
                (self.opts.ruiz_iters, self.opts.lanczos_iters,
                 self.opts.norm_override, self.opts.norm_backend),
                self.tile,
                self._device_signature(),
                None if self.mesh is None else
                (tuple(self.mesh.axis_names),
                 tuple(self.mesh.devices.shape), self.batch_axes))

    def _compile(self, key, make: Callable):
        hit = self._cache.get(key)
        if hit is not None:
            self.cache_hits += 1
            return hit
        self.cache_misses += 1
        sanitize.note_cache_miss()
        self._cache[key] = pipe = make()
        return pipe

    def _executable(self, mb: int, nb: int, B: int, dtype, *,
                    donate: bool = False, seeded: bool = False):
        sig = ("dense", mb, nb) + (("normseed",) if seeded else ())
        return self._compile(self._cache_key(sig, B, dtype, donate),
                             self._make_pipeline)

    def _executable_sparse(self, mb: int, nb: int, nnz: int, B: int,
                           dtype, *, donate: bool = False,
                           seeded: bool = False):
        sig = ("sparse", mb, nb, nnz) + (("normseed",) if seeded else ())
        return self._compile(self._cache_key(sig, B, dtype, donate),
                             self._make_sparse_pipeline)

    def _executable_ell(self, mb: int, nb: int, wf: int, wa: int, B: int,
                        dtype, *, donate: bool = False,
                        seeded: bool = False):
        sig = ("ell", mb, nb, wf, wa) + (("normseed",) if seeded else ())
        return self._compile(self._cache_key(sig, B, dtype, donate),
                             self._make_ell_pipeline)

    def cache_info(self) -> dict:
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "entries": len(self._cache)}

    # -- cross-instance norm cache ------------------------------------

    def _norm_fingerprint(self, lp: StandardLP):
        """Norm-cache key: shape bucket + exact shape + sparsity pattern.

        Sparse instances hash their COO index arrays (blake2b-64), so an
        estimate is only ever reused across instances with the SAME
        nonzero pattern.  Index order is hashed as given: a reordered but
        equal pattern just misses the cache.  Dense instances share one
        entry per exact shape.
        """
        bucket = self._bucket(*lp.K.shape)
        if isinstance(lp.K, SparseCOO):
            h = hashlib.blake2b(digest_size=8)
            h.update(np.ascontiguousarray(
                np.asarray(lp.K.row, np.int64)).tobytes())
            h.update(np.ascontiguousarray(
                np.asarray(lp.K.col, np.int64)).tobytes())
            return (bucket, tuple(lp.K.shape), int(lp.K.nnz),
                    h.hexdigest())
        return (bucket, tuple(lp.K.shape))

    # -- draws --------------------------------------------------------

    def _instance_keys(self, idxs: Sequence[int], n_total: int,
                       B: int) -> List[int]:
        """One generator seed per batch slot, from ``opts.seed`` and the
        instance's position in the stream (filler slots get the positions
        past the end, so even dropped work is decorrelated)."""
        positions = list(idxs) + [n_total + j for j in range(B - len(idxs))]
        return [lane_seed(self.opts.seed, p) for p in positions]

    def _lane_draws(self, keys: List[int], positions: List[int], mb: int,
                    nb: int, dtype, draws: Optional[Callable]) -> LaneDraws:
        """The bucket's random inputs: each lane's generator draws x0,
        then y0 (and, in the crossbar pipeline, then its programming
        error); or ``draws(position, mb, nb)`` (an ``interop.Draws``) is
        uploaded for every lane."""
        dev = self.torch_device

        def stacked(arrays):
            return torch.as_tensor(np.stack([np.array(a) for a in arrays]),
                                   dtype=dtype, device=dev)

        if draws is None:
            x0, y0, v0, program = seeded_lane_draws(keys, mb, nb, dtype,
                                                    dev)[:4]
        else:
            picks = [draws(p, mb, nb) for p in positions]
            x0 = stacked([d.x0 for d in picks])
            y0 = stacked([d.y0 for d in picks])
            v0 = (default_start(mb + nb, dtype, dev) if picks[0].v0 is None
                  else torch.as_tensor(np.array(picks[0].v0), dtype=dtype,
                                       device=dev))
            program = (None if picks[0].program is None else
                       tuple(stacked([d.program[i] for d in picks])
                             for i in range(2)))
        noise = None
        if self.sigma_read > 0.0:
            # the bucket's read noise: one generator, seeded from its
            # first lane's seed
            noise = torch.Generator(device=dev).manual_seed(
                lane_seed(keys[0], 0))
        return LaneDraws(x0, y0, v0, program, noise)

    # -- solving ------------------------------------------------------

    def _collect(self, out, bucket: Tuple[int, int], idxs: Sequence[int],
                 lps: Sequence[StandardLP], results: list) -> None:
        xs, ys, its, merits, rhos = (t.cpu().numpy() for t in out[:5])
        record_norms = self.norm_reuse and self.opts.norm_override is None
        for k, i in enumerate(idxs):
            lp = lps[i]
            m, n = lp.K.shape
            x = xs[k, :n]
            it = int(its[k])
            if self.opts.norm_override is not None:
                lanczos = 0
            elif i in self._seeded_idxs:
                lanczos = NORM_REFINE_ITERS
            else:
                lanczos = self.opts.lanczos_iters
            results[i] = BatchItemResult(
                name=lp.name, x=x, y=ys[k, :m],
                obj=float(lp.c @ x), iterations=it,
                merit=float(merits[k]),
                converged=bool(merits[k] <= self.opts.tol),
                bucket=bucket,
                mvm_calls=engine.mvm_accounting(
                    it, self.opts.check_every, lanczos,
                    restart=self.opts.restart),
                sparse=bool(getattr(lp, "is_sparse", False)),
            )
            if record_norms and np.isfinite(rhos[k]):
                fp = self._norm_fingerprint(lp)
                prev = self._norm_cache.get(fp)
                val = float(rhos[k])
                self._norm_cache[fp] = (val if prev is None
                                        else max(prev, val))

    def _donate(self, nbytes: int) -> bool:
        return (nbytes >= self.donate_min_bytes
                and self.torch_device.type == "cuda")

    def _upload(self, stacked, int_fields=()):
        """The stacking upload (sanctioned under the transfer guard)."""
        dt = torch_dtype(self.opts.dtype)
        with spans.span("serve.upload"), sanitize.sanctioned():
            return [torch.as_tensor(a, dtype=torch.int32 if i in int_fields
                                    else dt, device=self.torch_device)
                    for i, a in enumerate(stacked)]

    def _dispatch_bucket(self, group, idxs, n_total: int,
                         mb: int, nb: int, sig, stats, draws):
        """Stack one bucket, upload it and start its pipeline.

        ``sig`` is the group's sparse signature: None for dense serving,
        a bare int nnz bucket for the COO backend, or ``("ell", wf, wa)``
        width buckets for the ELL backend.  Returns the pipeline's
        generator (not yet started)."""
        dtype = torch_dtype(self.opts.dtype)
        B = self._padded_batch(len(group))
        # norm-reuse serving: a bucket is seeded only when EVERY member's
        # fingerprint already has a cached estimate (filler slots reuse
        # the first member's seed — their results are dropped anyway)
        rho_seeds = None
        if self.norm_reuse and self.opts.norm_override is None:
            cached = [self._norm_cache.get(self._norm_fingerprint(lp))
                      for lp in group]
            if all(v is not None for v in cached):
                rho_seeds = self._upload(
                    [np.asarray(cached + [cached[0]] * (B - len(group)))])[0]
        # batch padding repeats the first instance; extras are dropped
        lanes = self._local_lanes(B)
        if rho_seeds is not None:
            rho_seeds = rho_seeds[lanes]
        seeded = rho_seeds is not None
        members = (group + [group[0]] * (B - len(group)))[lanes]
        keys = self._instance_keys(idxs, n_total, B)[lanes]
        positions = (list(idxs) + [n_total + j
                                   for j in range(B - len(idxs))])[lanes]
        path = ("ell" if isinstance(sig, tuple)
                else "dense" if sig is None else "sparse")
        with spans.span("serve.stack", bucket=[mb, nb], path=path) as span:
            if path == "ell":                            # ("ell", wf, wa)
                _, wf, wa = sig
                stacked = stack_problems_ell(members, m=mb, n=nb,
                                             wf=wf, wa=wa)
            elif path == "sparse":                       # bare int nnz
                stacked = stack_problems_sparse(members, m=mb, n=nb,
                                                nnz=sig)
            else:
                stacked = stack_problems([lp.densified() for lp in members],
                                         m=mb, n=nb)
            nbytes = sum(a.nbytes for a in stacked)
            span.set("bytes", nbytes)
        spans.count(f"stack_bytes.{path}", nbytes)
        stats["dense_stack_bytes" if path == "dense"
              else "sparse_stack_bytes"] += nbytes
        if path == "ell":
            arrays = self._upload(stacked, int_fields=(1, 3))
            donate = self._donate(arrays[0].nbytes + arrays[2].nbytes)
            exe_fn = (lambda s: self._executable_ell(
                mb, nb, wf, wa, B, dtype, donate=donate, seeded=s))
        elif path == "sparse":
            arrays = self._upload(stacked, int_fields=(1,))
            donate = self._donate(arrays[0].nbytes)
            exe_fn = (lambda s: self._executable_sparse(
                mb, nb, sig, B, dtype, donate=donate, seeded=s))
        else:
            arrays = self._upload(stacked)
            donate = self._donate(arrays[0].nbytes)
            exe_fn = (lambda s: self._executable(
                mb, nb, B, dtype, donate=donate, seeded=s))
        del stacked
        exe = exe_fn(seeded)
        if self.norm_reuse and self.opts.norm_override is None \
                and not seeded:
            # cold pass over a new fingerprint set: build the seeded twin
            # NOW so the warm stream that hits the cache later reports
            # zero compiles
            exe_fn(True)
        if seeded:
            self._seeded_idxs.update(idxs)
            stats["norm_seeded_buckets"] += 1
        stats["donated_buckets"] += int(donate)
        with sanitize.sanctioned():
            lane_draws = self._lane_draws(keys, positions, mb, nb, dtype,
                                          draws)
        read = sanitize.host_read if self.transfer_sanitize else bool
        return exe.run(arrays, lane_draws, rho_seeds, donate, read)

    def _sparse_signature(self, lp: StandardLP):
        """Sparse component of an instance's bucket key: the nnz bucket
        (bare int — the COO stacking axis) or the pair of ELL width
        buckets.  Either way, one occupancy outlier never inflates (and
        never rebuilds) the whole shape bucket's stack."""
        if self.opts.sparse_kernel == "ell":
            wf, wa = coo_row_widths(lp.K.row, lp.K.col, lp.K.data,
                                    lp.K.shape)
            return ("ell", ell_width_bucket(wf), ell_width_bucket(wa))
        return nnz_bucket(lp.K.nnz)

    def _group_buckets(self, lps: Sequence[StandardLP]) -> dict:
        """Group stream positions by ((m_bucket, n_bucket), sparse sig);
        a pure function of the stream and the solver's configuration."""
        buckets: dict = {}
        with spans.span("serve.group"):
            for i, lp in enumerate(lps):
                sp = bool(getattr(lp, "is_sparse", False)) and \
                    self.supports_sparse
                sig = self._sparse_signature(lp) if sp else None
                buckets.setdefault((self._bucket(*lp.K.shape), sig),
                                   []).append(i)
        return buckets

    def _stream(self, k: int):
        """The k-th bucket's CUDA stream context (reused across calls);
        the current stream without async dispatch or a card."""
        if self.torch_device.type != "cuda" or not self.async_dispatch:
            return contextlib.nullcontext()
        while len(self._streams) <= k:
            self._streams.append(torch.cuda.Stream(device=self.torch_device))
        return torch.cuda.stream(self._streams[k])

    def _guard(self):
        return (sanitize.no_implicit_transfers() if self.transfer_sanitize
                else contextlib.nullcontext())

    def _step(self, job) -> bool:
        """Resume one bucket's pipeline up to its next host read; True
        once it has finished (its outputs then in ``job["out"]``)."""
        with self._stream(job["k"]), self._guard(), \
                spans.span("serve.step", bucket=job["k"]):
            try:
                next(job["gen"])
                return False
            except StopIteration as stop:
                job["out"], job["windows"] = stop.value
                return True

    def _finish(self, job, lps, results, stats) -> None:
        with self._stream(job["k"]):
            out = job["out"]
            if self.mesh is not None:
                from ..distributed.sharding import gather_blocks

                out = tuple(gather_blocks(t, self.mesh, self.batch_axes)
                            for t in out)
            self._collect(out, job["bucket"][0], job["idxs"], lps, results)
            self._bucket_served(job["bucket"], job["idxs"], out)
        stats["bucket_windows"].append(
            {"bucket": job["bucket"], "lanes": len(job["idxs"]),
             "windows": job["windows"]})

    # -- multi-pod routing hooks (runtime.cluster overrides these) ----

    def _route(self, buckets: dict) -> Tuple[dict, dict]:
        """Split buckets into (served here, served by other pods).  The
        base scheduler is single-pod: everything is local."""
        return buckets, {}

    def _bucket_served(self, key, idxs: Sequence[int], out) -> None:
        """Called once per locally served bucket with its device outputs
        (after collection): the cluster solver publishes here."""

    def _gather_remote(self, remote: dict, lps, results, stats) -> None:
        """Collect buckets served by other pods.  Single-pod: none."""
        if remote:
            raise RuntimeError("base BatchSolver cannot gather remote "
                               f"buckets: {sorted(remote)}")

    def _serve(self, buckets: dict, lps, results, stats, draws) -> None:
        """Serve ``buckets`` ({key: stream positions}) into ``results``:
        every bucket is stacked, uploaded and started before any result
        is read back, then the buckets' windows are enqueued round-robin
        and each is collected when its last lane has stopped (one bucket
        at a time without ``async_dispatch``).  With a mesh the finished
        buckets are gathered and collected in bucket order after the
        last, so that every rank issues the same collectives in the same
        order."""
        done = []

        def finish(job):
            if self.mesh is None:
                self._finish(job, lps, results, stats)
            else:
                done.append(job)

        jobs = []
        with spans.timed("serve.dispatch") as phase:
            for k, (((mb, nb), sig), idxs) in enumerate(buckets.items()):
                group = [lps[i] for i in idxs]
                with self._stream(k), self._guard():
                    gen = self._dispatch_bucket(group, idxs, len(lps), mb,
                                                nb, sig, stats, draws)
                job = {"k": k, "gen": gen, "bucket": ((mb, nb), sig),
                       "idxs": idxs}
                if self.async_dispatch:
                    if self._step(job):
                        finish(job)
                    else:
                        jobs.append(job)
                else:
                    while not self._step(job):
                        pass
                    finish(job)
        stats["dispatch_s"] += phase.seconds
        with spans.timed("serve.collect") as phase:
            while jobs:
                for job in list(jobs):
                    if self._step(job):
                        jobs.remove(job)
                        finish(job)
            for job in sorted(done, key=lambda j: j["k"]):
                self._finish(job, lps, results, stats)
        stats["collect_s"] += phase.seconds

    def solve_stream(self, lps: Sequence[StandardLP],
                     draws: Optional[Callable] = None):
        """Solve a heterogeneous stream; results come back in input order.

        The locally routed buckets are served as ``_serve`` says;
        ``async_dispatch=False`` serves one bucket at a time.  Buckets
        routed to other pods (``runtime.cluster``) are gathered after
        the local work.  ``draws(position, m_bucket, n_bucket) ->
        interop.Draws`` injects every lane's draws (filler lanes
        included) instead of the per-lane generators.
        """
        lps = list(lps)
        with spans.span("serve", lps=len(lps)) as span:
            buckets = self._group_buckets(lps)
            span.set("buckets", len(buckets))
            mine, remote = self._route(buckets)
            results: List[Optional[object]] = [None] * len(lps)
            self._seeded_idxs = set()
            self._draws = draws
            stats = {"n_buckets": len(buckets),
                     "n_local_buckets": len(mine),
                     "dense_stack_bytes": 0,
                     "sparse_stack_bytes": 0, "donated_buckets": 0,
                     "norm_seeded_buckets": 0,
                     "dispatch_s": 0.0, "collect_s": 0.0, "compiles": 0,
                     "bucket_windows": []}
            compiles0 = sanitize.compile_counts()["compiles"]
            self._serve(mine, lps, results, stats, draws)
            self._gather_remote(remote, lps, results, stats)
            stats["compiles"] = (sanitize.compile_counts()["compiles"]
                                 - compiles0)
        self.last_stream_stats = stats
        return results  # type: ignore[return-value]


def solve_stream(lps: Sequence[StandardLP],
                 opts: PDHGOptions = PDHGOptions(), *,
                 mesh=None, solver: Optional[BatchSolver] = None,
                 torch_device=None, draws: Optional[Callable] = None
                 ) -> List[BatchItemResult]:
    """One-shot entry point; pass ``solver`` to keep the pipeline cache
    warm across calls.  Runs on the card unless ``torch_device`` says
    otherwise; ``mesh`` shards each bucket's lanes over its ranks."""
    if solver is None:
        solver = BatchSolver(opts, mesh=mesh, torch_device=torch_device)
    return solver.solve_stream(lps, draws=draws)
