"""One PDHG iteration engine with pluggable operator / update backends;
the port of ``repro.core.engine``.

An enhanced-PDHG iteration is two MVMs plus cheap vector algebra.  This
module is the single home of that step (``pdhg_step``), of the check
window with its restart and step-rule logic (``pdhg_loop``), and of the
MVM accounting the energy ledger charges.  Two backend axes:

  * operator (``Operator``): the two MVMs — dense products with
    optional multiplicative read noise, sparse COO products
    (``sparse_operator``), the ELL kernel B4 (``sparse_ell_operator``),
    the crossbar kernel B6 against the programmed symmetric block
    (``crossbar_operator``), plus an optional ``fuse`` hook that runs a
    whole check window as one launch (the megakernels B3 and B5), or a
    host-side ``Accel`` handle (``accel_operator``: the crossbar
    simulation with its energy ledger, used by ``pdhg.solve``);
  * updates (``Updates``): the proximal vector algebra — plain PyTorch
    (``"torch"``) or the hand-written CUDA kernels (``"cuda"``, B1/B2;
    on CPU tensors the kernels' plain versions run instead), each with
    the step forms the stepped window runs (``dual_step``,
    ``primal_step`` and the window's ``schedule``).

The stepped window (``pdhg_loop`` without a fuse hook) is the schedule
and then four launches a step on the card: the forward product,
``dual_step``, the adjoint product, ``primal_step``.  On a noiseless
device operator (``Operator.capture``) the loop captures one window as a
CUDA graph and replays it every window after the first, so the host
issues one replay a window instead of every launch; ``pdhg_loop(...,
graph=False)`` runs every window eagerly, for tests that compare the
two.

State is carried in the pre-extrapolated form of the reference:
``x_bar`` for iteration k is produced by iteration k-1's primal update,
and ``tau``/``sigma`` already include iteration k's theta_k.

Host/device contract: ``tau``, ``sigma``, ``theta``, the merits and
every restart decision are tensors on the device, combined with
``torch.where``; the loop reads one value on the host per check window
(whether any lane is still active).  Random numbers come from an
explicit ``torch.Generator``; JAX's key splitting has no counterpart.

Batches.  Every function here takes one instance ((d,) vectors, 0-d
step sizes) or a leading batch axis of B independent instances
("lanes": (B, d) vectors, (B,) step sizes).  ``pdhg_loop`` and
``solve_core`` are one loop for both: on a batch, the reference's
vmapped ``while_loop``.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import kernels, spans
from ..kernels import crossbar_mvm, pdhg_megakernel, pdhg_update, sparse_mvm
from .residuals import kkt_residuals
from .symblock import MODE_AX, MODE_ATY, matmul_accel

KERNELS = ("torch", "cuda")        # counterparts of ("jnp", "pallas")
SPARSE_KERNELS = ("ell", "bcoo")
STEP_RULES = ("fixed", "adaptive", "strongly_convex")

# Adaptive step-rule tuning (``step_rule="adaptive"``), as in the
# reference: log-space smoothing weight for the primal-weight updates,
# and the trust region confining the weight around its initial value.
ADAPT_SMOOTH = 0.5         # exp(s*log(target) + (1-s)*log(old))
ADAPT_OMEGA_CLIP = 1024.0  # omega confined to [omega0/1024, omega0*1024]
_ADAPT_TINY = 1e-30        # degenerate-movement / div-by-zero guard


# ---------------------------------------------------------------- state ---

class PDHGState(NamedTuple):
    """Carried PDHG iterate.  ``tau``/``sigma`` are 0-d (or (B,)) tensors
    holding the CURRENT iteration's step sizes (theta_k already
    applied)."""

    x: torch.Tensor
    x_prev: torch.Tensor
    x_bar: torch.Tensor
    y: torch.Tensor
    tau: torch.Tensor
    sigma: torch.Tensor


class Operator(NamedTuple):
    """The two MVMs of one iteration: ``fwd(v) ~ K v`` (dual step) and
    ``adj(v) ~ K^T v`` (primal step).  ``fuse(state, n_steps, active) ->
    (state', x_sum, y_sum)`` is the optional megakernel hook, mounted
    only on noiseless backends; ``active`` is the loop's per-lane mask on
    the device, and a hook may leave the lanes it marks stopped as they
    came in (the loop discards their results).  ``capture`` says that a
    stepped window of the two products may be captured as a CUDA graph:
    they are noiseless work on the device, with no draw from a generator
    and nothing read on the host."""

    fwd: Callable
    adj: Callable
    name: str = "dense"
    fuse: Optional[Callable] = None
    capture: bool = False


class Updates(NamedTuple):
    """The proximal vector algebra of one iteration (``pdhg_step``), and
    its step forms that the stepped window runs
    (``kernels.pdhg_update``).

    primal(x, kty, c, T, lb, ub, tau, theta) -> (x_new, x_bar_next)
    dual(y, kxbar, b, Sigma, sigma)          -> y_new
    schedule(tau, sigma, n_steps, gamma, out) -> (sched, tau', sigma')
    dual_step(y, kxbar, b, Sigma, sigma, ys, out)   -> y_new; ys += y_new
    primal_step(x, kty, c, T, lb, ub, tau, theta, xs, x_new, x_bar)
                                              -> (x_new, x_bar); xs += x_new
    """

    primal: Callable
    dual: Callable
    name: str
    schedule: Callable
    dual_step: Callable
    primal_step: Callable


# ---------------------------------------------------- operator backends ---

def _read_noise(w, generator, sigma_read):
    """Multiplicative cycle-to-cycle read noise, truncated at 4 sigma so
    Assumption 3 (bounded perturbation) holds exactly."""
    g = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                    device=w.device)
    return w * (1.0 + sigma_read * torch.clamp(g, -4.0, 4.0))


def _noisy(product, sigma_read: float,
           generator: Optional[torch.Generator]) -> Callable:
    """``product`` followed by the read-noise hook of every backend."""
    if sigma_read <= 0.0:
        return product
    if generator is None:
        raise ValueError("a noisy operator needs a torch.Generator")
    return lambda v: _read_noise(product(v), generator, sigma_read)


def matvec(M) -> Callable:
    """``v -> M v`` for a dense (m, n) M, or ``(B, n) -> (B, m)`` for a
    (B, m, n) stack."""
    if M.dim() == 2:
        return lambda v: torch.mv(M, v)
    return lambda v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def dense_operator(K_fwd, K_adj, sigma_read: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> Operator:
    """Dense backend, (m, n) or a (B, m, n) stack.  On an ideal device
    ``K_adj == K_fwd.T``; on a programmed crossbar the two blocks are
    distinct cells.  With ``sigma_read > 0`` every MVM draws its read
    noise from ``generator`` (on the operands' device)."""
    return Operator(_noisy(matvec(K_fwd), sigma_read, generator),
                    _noisy(matvec(K_adj), sigma_read, generator), "dense",
                    capture=sigma_read <= 0.0)


def coo_matvec(data, row, col, v, shape) -> torch.Tensor:
    """COO contraction ``out[row] += data * v[col]`` with ``row``/``col``
    indices into the flattened output and ``v`` (a batch's lanes laid end
    to end); returns ``shape``.  A gather and a scatter-add, the
    reference's BCOO product, with no coalescing and so no host read."""
    out = torch.zeros(math.prod(shape), dtype=v.dtype, device=v.device)
    return out.index_add_(0, row, data * v.reshape(-1)[col]).view(shape)


def sparse_operator(K_sp, sigma_read: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> Operator:
    """Sparse backend over a torch sparse COO ``K_sp``, (m, n) or a
    (B, m, n) batch, coalesced or not: the two MVMs contract only its
    stored entries (``coo_matvec``; the reference's BCOO path has no
    Pallas kernel), the adjoint the same entries with rows and columns
    swapped.  The read-noise hook matches ``dense_operator``."""
    idx, vals = K_sp._indices(), K_sp._values()
    *lead, m, n = K_sp.shape
    row, col = idx[-2], idx[-1]
    if lead:
        row, col = row + idx[0] * m, col + idx[0] * n

    def fwd(v):
        return coo_matvec(vals, row, col, v, (*lead, m))

    def adj(v):
        return coo_matvec(vals, col, row, v, (*lead, n))

    return Operator(_noisy(fwd, sigma_read, generator),
                    _noisy(adj, sigma_read, generator), "sparse",
                    capture=sigma_read <= 0.0)


def _row_lens(row_len, data, cols):
    return sparse_mvm.ell_row_len(data, cols) if row_len is None \
        else row_len


def sparse_ell_operator(data_f, cols_f, data_a, cols_a,
                        sigma_read: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        row_len_f=None, row_len_a=None) -> Operator:
    """Row-blocked ELL backend on B4 (``kernels.sparse_mvm.ell_matvec``):
    the forward MVM contracts the ELL form of K (``data_f``/``cols_f``,
    (m, Wf)), the adjoint a separately stored ELL of K^T (``data_a``/
    ``cols_a``, (n, Wa)), each optionally batched; both are gathers and
    row reductions that stop at each row's last stored slot (row lengths
    from ``sparse_mvm.ell_row_len``, computed here once unless given).
    The read-noise hook matches ``dense_operator``."""
    row_len_f = _row_lens(row_len_f, data_f, cols_f)
    row_len_a = _row_lens(row_len_a, data_a, cols_a)
    return Operator(
        _noisy(lambda v: sparse_mvm.ell_matvec(data_f, cols_f, v, row_len_f),
               sigma_read, generator),
        _noisy(lambda v: sparse_mvm.ell_matvec(data_a, cols_a, v, row_len_a),
               sigma_read, generator), "sparse_ell",
        capture=sigma_read <= 0.0)


def accel_operator(accel) -> Operator:
    """Host-loop backend over an encoded ``symblock.Accel`` handle (MVM
    stats feed the energy ledger; the backend brings its own physics,
    read noise included)."""

    def fwd(v):
        return matmul_accel(accel, v, MODE_AX)

    def adj(v):
        return matmul_accel(accel, v, MODE_ATY)

    return Operator(fwd, adj, f"accel({accel.name})")


def crossbar_operator(g_pos, g_neg, scale, m: int, n: int,
                      sigma_read: float = 0.0,
                      generator: Optional[torch.Generator] = None
                      ) -> Operator:
    """Differential-pair backend on B6 (``kernels.crossbar_mvm``) against
    the SINGLE programmed symmetric block M (Algorithm 2), a (R, C) array
    or a (B, R, C) stack with ``scale`` a number or (B,): both MVM modes
    are zero-padded reads of the whole array, the paper's access
    pattern.  Read noise is a per-row multiplicative sample, truncated at
    4 sigma, folded into the kernel's output gain."""
    R, C = g_pos.shape[-2:]
    lead = tuple(g_pos.shape[:-2])

    def mvm(v_full):
        if sigma_read > 0.0:
            g = torch.randn((*lead, R), generator=generator,
                            dtype=v_full.dtype, device=v_full.device)
            noise = sigma_read * torch.clamp(g, -4.0, 4.0)
        else:
            noise = torch.zeros((*lead, R), dtype=v_full.dtype,
                                device=v_full.device)
        return crossbar_mvm.crossbar_mvm(g_pos, g_neg, v_full, scale, noise)

    def padded(v, start):
        v_full = torch.zeros((*lead, C), dtype=v.dtype, device=v.device)
        v_full[..., start:start + v.shape[-1]] = v
        return v_full

    def fwd(x):
        return mvm(padded(x, m))[..., :m].contiguous()

    def adj(y):
        return mvm(padded(y, 0))[..., m:m + n].contiguous()

    if sigma_read > 0.0 and generator is None:
        raise ValueError("a noisy operator needs a torch.Generator")
    return Operator(fwd, adj, "crossbar", capture=sigma_read <= 0.0)


#: all-reduces issued by the sharded path (``sharded_operator`` and the
#: distributed merit) since the count was last set to 0, and, while
#: ``timed_collectives`` is open, the seconds they took.
COLLECTIVES = {"all_reduce": 0}
_COLLECTIVE_TIMES: Optional[list] = None


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over the ranks of ``group`` (``"sum"`` or
    ``"max"``) and returned.  ``group`` None is a mesh axis of one rank
    in a process with no process group: nothing to reduce."""
    if group is None:
        return t
    COLLECTIVES["all_reduce"] += 1
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _COLLECTIVE_TIMES is None:
        dist.all_reduce(t, op=red, group=group)
    elif t.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(t, op=red, group=group)
        end.record()
        _COLLECTIVE_TIMES.append((start, end))
    else:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=red, group=group)
        _COLLECTIVE_TIMES.append(time.perf_counter() - t0)
    return t


@contextlib.contextmanager
def timed_collectives():
    """Time every ``all_reduce`` inside: CUDA events around each on the
    card (from its place in the stream to the end of the reduction),
    the host's clock on the CPU.  Yields a dict whose ``"seconds"`` (the
    sum) and ``"calls"`` are filled in on exit, after a synchronise."""
    global _COLLECTIVE_TIMES
    out = {"seconds": 0.0, "calls": 0}
    _COLLECTIVE_TIMES = times = []
    try:
        yield out
    finally:
        _COLLECTIVE_TIMES = None
        if times and not isinstance(times[0], float):
            times[-1][1].synchronize()
            times = [a.elapsed_time(b) / 1e3 for a, b in times]
        out.update(seconds=float(sum(times)), calls=len(times))


def sharded_operator(K_loc, row_axis, col_axis) -> Operator:
    """Process-group tiled backend: this rank owns a static (m_loc,
    n_loc) tile of K; ``fwd`` is the local product and an all-reduce
    over ``col_axis``, the process group of the column axes (the ranks
    of this rank's grid row: "sum the currents along a crossbar grid
    row"), ``adj`` the local transpose product and an all-reduce over
    ``row_axis``, that of the row axes (``runtime.mesh.Mesh.group``).
    Two collectives a step, each in plain sight here.

    Tiles may be narrower than the vectors.  A torch matmul of two bf16
    operands returns bf16, where the reference accumulates in at least
    f32 (its ``preferred_element_type``); so a tile below f32 is
    widened to f32 once, here, and each product rounds ``v`` to the
    tile's type and back before an f32 GEMV: the same products, each
    exact in f32, accumulated in f32, at the memory of an f32 tile.
    Wider tiles (f32, f64) multiply in their own type.  The windows run
    eagerly (``capture`` False): a collective is not captured here."""
    acc = torch.promote_types(K_loc.dtype, torch.float32)
    tile_dt = K_loc.dtype
    K_acc = K_loc.to(acc)
    K_adj = K_acc.mT

    def product(M, v):
        v_t = v.to(tile_dt).to(acc) if tile_dt != acc else v.to(acc)
        return torch.mv(M, v_t).to(v.dtype)

    def fwd(v):
        return all_reduce(product(K_acc, v), col_axis)

    def adj(v):
        return all_reduce(product(K_adj, v), row_axis)

    return Operator(fwd, adj, "sharded")


# ------------------------------------------------- megakernel (fused) ---

def make_fused_dense(K_fwd, K_adj, b, c, lb, ub, T, Sigma,
                     gamma) -> Callable:
    """``Operator.fuse`` hook for the dense backend: one
    ``kernels.pdhg_megakernel`` launch per check window.  Noiseless
    only; ``K_fwd`` a contiguous (m, n) tensor, and ``K_adj`` a
    contiguous (n, m) one (the two-matrix form of B3) or None when the
    adjoint is exactly K^T (the transpose form, which reads K once a
    step).  Only the lanes ``active`` marks live are stepped."""

    def fuse(state: PDHGState, n_steps: int, active=None):
        (x, x_prev, x_bar, y, tau, sigma, xs, ys) = \
            pdhg_megakernel.fused_dense_steps(
                K_fwd, K_adj, b, c, lb, ub, T, Sigma,
                state.x, state.x_prev, state.x_bar, state.y,
                state.tau, state.sigma,
                n_steps=int(n_steps), gamma=float(gamma), active=active)
        return (PDHGState(x=x, x_prev=x_prev, x_bar=x_bar, y=y,
                          tau=tau, sigma=sigma), xs, ys)

    return fuse


def make_fused_ell(data_f, cols_f, data_a, cols_a, b, c, lb, ub, T, Sigma,
                   gamma, row_len_f=None, row_len_a=None) -> Callable:
    """``Operator.fuse`` hook for the ELL backend: one B5 launch per check
    window (same contract as ``make_fused_dense``, operands in ELL form
    with their row lengths, computed here once unless given).  Only the
    lanes ``active`` marks live are stepped."""
    row_len_f = _row_lens(row_len_f, data_f, cols_f)
    row_len_a = _row_lens(row_len_a, data_a, cols_a)

    def fuse(state: PDHGState, n_steps: int, active=None):
        (x, x_prev, x_bar, y, tau, sigma, xs, ys) = \
            pdhg_megakernel.fused_ell_steps(
                data_f, cols_f, data_a, cols_a, b, c, lb, ub, T, Sigma,
                state.x, state.x_prev, state.x_bar, state.y,
                state.tau, state.sigma,
                n_steps=int(n_steps), gamma=float(gamma),
                row_len_f=row_len_f, row_len_a=row_len_a, active=active)
        return (PDHGState(x=x, x_prev=x_prev, x_bar=x_bar, y=y,
                          tau=tau, sigma=sigma), xs, ys)

    return fuse


# ------------------------------------------------------ update backends ---

TORCH_UPDATES = Updates(pdhg_update.primal_update_plain,
                        pdhg_update.dual_update_plain, "torch",
                        pdhg_update.schedule_plain,
                        pdhg_update.dual_step_plain,
                        pdhg_update.primal_step_plain)
CUDA_UPDATES = Updates(pdhg_update.primal_update, pdhg_update.dual_update,
                       "cuda", pdhg_update.schedule, pdhg_update.dual_step,
                       pdhg_update.primal_step)


def make_updates(kernel: str = "cuda") -> Updates:
    """Update backend keyed by ``PDHGOptions.kernel``."""
    if kernel == "torch":
        return TORCH_UPDATES
    if kernel == "cuda":
        return CUDA_UPDATES
    raise ValueError(f"unknown update kernel {kernel!r}; expected "
                     f"{KERNELS}")


# ------------------------------------------------------------ iteration ---

def init_state(x0, y0, tau0, sigma0, gamma) -> PDHGState:
    """Enter engine state: apply iteration 1's theta to (tau0, sigma0)
    and seed the extrapolation at x_bar_1 = x0 (x_prev = x0)."""
    tau0 = torch.as_tensor(tau0, dtype=x0.dtype, device=x0.device)
    sigma0 = torch.as_tensor(sigma0, dtype=x0.dtype, device=x0.device)
    theta1 = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * tau0)
    return PDHGState(x=x0, x_prev=x0, x_bar=x0, y=y0,
                     tau=theta1 * tau0, sigma=sigma0 / theta1)


def pdhg_step(op: Operator, upd: Updates, b, c, lb, ub, T, Sigma, gamma,
              state: PDHGState) -> PDHGState:
    """ONE enhanced-PDHG iteration (paper Algorithm 4, eq. 7 signs).

        y_{k+1} = y_k + sigma_k Sigma (b - K x_bar_k)        # MVM 1
        x_{k+1} = proj(x_k - tau_k T (c - K^T y_{k+1}))      # MVM 2
        theta_{k+1} = 1/sqrt(1 + 2 gamma tau_k)
        x_bar_{k+1} = x_{k+1} + theta_{k+1} (x_{k+1} - x_k)  # fused above
        tau_{k+1} = theta_{k+1} tau_k; sigma_{k+1} = sigma_k / theta_{k+1}
    """
    Kxbar = op.fwd(state.x_bar)
    y_n = upd.dual(state.y, Kxbar, b, Sigma, state.sigma)
    KTy = op.adj(y_n)
    theta_n = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * state.tau)
    x_n, x_bar_n = upd.primal(state.x, KTy, c, T, lb, ub, state.tau, theta_n)
    return PDHGState(x=x_n, x_prev=state.x, x_bar=x_bar_n, y=y_n,
                     tau=theta_n * state.tau, sigma=state.sigma / theta_n)


def restart_state(state: PDHGState, x_new, y_new) -> PDHGState:
    """Adopt a restart point: x = x_prev = x_bar = x_new (momentum reset),
    keeping the tau/sigma schedule running."""
    return state._replace(x=x_new, x_prev=x_new, x_bar=x_new, y=y_new)


def _tiny(ref: torch.Tensor) -> torch.Tensor:
    # torch.full fills on the device; torch.tensor would copy from the
    # host, which waits for the stream
    return torch.full((), _ADAPT_TINY, dtype=ref.dtype, device=ref.device)


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """The default ``xsum``/``ysum``: a vector's sum, one per lane."""
    return torch.sum(v, dim=-1)


def adaptive_omega_init(tau0, sigma0, b, c, T, Sigma,
                        xsum=lane_sum, ysum=lane_sum):
    """Data-driven primal-weight initialization (the PDLP heuristic in
    the preconditioned metric): scale ``omega = sqrt(sigma/tau)`` by
    ``sqrt(|T^1/2 c| / |Sigma^1/2 b|)``, clipped to [1/1024, 1024].
    ``xsum``/``ysum`` reduce primal/dual vectors (the sharded path
    passes all-reduced sums, so every rank derives the same weight)."""
    tiny = _tiny(b)
    one = torch.ones_like(tiny)
    nc2 = xsum(T * c * c)
    nb2 = ysum(Sigma * b * b)
    w = (torch.maximum(nc2, tiny) / torch.maximum(nb2, tiny)) ** 0.25
    w = torch.clamp(w, 1.0 / ADAPT_OMEGA_CLIP, ADAPT_OMEGA_CLIP)
    ok = (nc2 > tiny) & (nb2 > tiny)
    w = torch.where(ok & torch.isfinite(w), w, one)
    return tau0 / w, sigma0 * w


def adaptive_shrink(tau, sigma, eta, dx, dy, Kdx, KTdy, T, Sigma, ok,
                    xsum=lane_sum, ysum=lane_sum):
    """Down-only step-scale safeguard at every check boundary (zero
    extra MVMs: ``Kdx``/``KTdy`` come from the check MVMs by
    linearity).  The Rayleigh quotient along the window's movement is a
    lower bound on the preconditioned operator norm, so when
    ``sqrt(tau*sigma) * rho_loc > eta`` the scale shrinks to
    ``eta / rho_loc``; it is never grown.  ``xsum``/``ysum`` as in
    ``adaptive_omega_init``."""
    tiny = _tiny(dx)
    one = torch.ones_like(tiny)
    ndx2 = xsum(dx * dx / T)
    ndy2 = ysum(dy * dy / Sigma)
    nK2 = ysum(Sigma * Kdx * Kdx) + xsum(T * KTdy * KTdy)
    mv2 = ndx2 + ndy2
    rho_loc = torch.sqrt(nK2 / torch.maximum(mv2, tiny))
    g = torch.sqrt(tau * sigma)
    s = torch.minimum(one, eta / torch.maximum(rho_loc * g, tiny))
    ok = ok & (mv2 > tiny) & torch.isfinite(s)
    s = torch.where(ok, s, one)
    return tau * s, sigma * s


def adaptive_omega_update(tau, sigma, dx, dy, T, Sigma, w_lo, w_hi, ok,
                          xsum=lane_sum, ysum=lane_sum):
    """PDLP primal-weight rebalancing at RESTART events only: pull
    ``omega = sqrt(sigma/tau)`` toward the dual/primal movement ratio
    since the previous restart anchor with log-space smoothing, clipped
    to ``[w_lo, w_hi]``; the product ``tau*sigma`` is preserved.
    ``xsum``/``ysum`` as in ``adaptive_omega_init``."""
    tiny = _tiny(dx)
    ndx2 = xsum(dx * dx / T)
    ndy2 = ysum(dy * dy / Sigma)
    ok = ok & (ndx2 > tiny) & (ndy2 > tiny)
    w_old = torch.sqrt(sigma / tau)
    ratio = torch.sqrt(ndy2 / torch.maximum(ndx2, tiny))
    w_new = torch.exp(ADAPT_SMOOTH * torch.log(torch.maximum(ratio, tiny))
                      + (1.0 - ADAPT_SMOOTH) * torch.log(
                          torch.maximum(w_old, tiny)))
    w_new = torch.clamp(w_new, w_lo, w_hi)
    g = torch.sqrt(tau * sigma)
    ok = ok & torch.isfinite(w_new)
    return (torch.where(ok, g / w_new, tau),
            torch.where(ok, g * w_new, sigma))


# ----------------------------------------------------------------- loop ---

def draw_init(generator: torch.Generator, m: int, n: int, lb, ub, dtype):
    """Paper's projected-Gaussian start; returns (x0, y0) on the bounds'
    device, drawn from ``generator`` (which must live there too)."""
    x0 = torch.randn(n, generator=generator, dtype=dtype, device=lb.device)
    x0 = torch.clamp(x0, lb, ub)
    y0 = torch.randn(m, generator=generator, dtype=dtype, device=lb.device)
    return x0, y0


def _lanes(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-lane mask or scalar against vectors: (B,) -> (B, 1) (0-d ->
    (1,) for one instance)."""
    return mask.unsqueeze(-1) if v.dim() > mask.dim() else mask


def select_lanes(mask, new, old):
    """Per-lane ``where`` over matching tuples of tensors."""
    return tuple(torch.where(_lanes(mask, a), a, b)
                 for a, b in zip(new, old))


# One capture stream a device for loops that run on its default stream:
# cuBLAS keeps a workspace for every stream it has run on (32 MiB each on
# the H100 under PyTorch 2.11), so a new stream a solve would hold one
# more each time.
_SIDE_STREAMS: dict = {}

#: CUDA graphs of stepped windows since the counts were last set to 0:
#: captures (one a loop call that runs two windows or more) and replays
#: (every window of such a call after its first).
GRAPHS = {"captures": 0, "replays": 0}


class SteppedWindow:
    """``n_steps`` steps of the stepped loop over buffers allocated once
    per loop call: the window's schedule, then a step pair a step
    (``upd.dual_step`` after the forward product, ``upd.primal_step``
    after the adjoint), four launches a step on the card.

    x and y each alternate between two buffers, so that no step writes
    what it reads; x_bar and the two ergodic sums are updated in place.
    ``run(state, xs, ys)`` copies the carried state and sums in, runs the
    window and returns ``(state', xs', ys')`` as views of the buffers,
    valid until the next ``run``.

    With ``capture`` (a CUDA operator that allows it, ``Operator.
    capture``) the first window runs eagerly on the capture stream, which
    also sets up everything that is built on first use (the kernel
    library, cuBLAS's workspace for that stream); the second is captured
    once as a ``torch.cuda.CUDAGraph`` and replayed, as is every window
    after it, on the current stream.  The capture stream is the current
    stream (a bucket's own stream in ``BatchSolver``) unless that is the
    default stream, which cannot be captured: then the device's one side
    stream, ordered after it.  A replay adds the launches its capture
    counted to the kernels' counters.  A capture that fails raises.
    """

    def __init__(self, op: Operator, upd: Updates, b, c, lb, ub, T, Sigma,
                 gamma: float, n_steps: int, x0, y0, capture: bool):
        self.op, self.upd, self.gamma, self.n = op, upd, gamma, n_steps
        self.vecs = (b, c, lb, ub, T, Sigma)
        self.x = x0.new_empty((2, *x0.shape))
        self.y = y0.new_empty((2, *y0.shape))
        self.x_bar = torch.empty_like(x0)
        self.xs = torch.empty_like(x0)
        self.ys = torch.empty_like(y0)
        lead = tuple(x0.shape[:-1])
        self.tau = x0.new_empty(lead)
        self.sigma = x0.new_empty(lead)
        self.sched = pdhg_update.schedule_buffers(self.tau, n_steps)
        self.capture = capture
        self.warm = False
        self.graph = None
        self.launches = {}
        self.mode = "eager"         # how the last window ran

    def body(self) -> None:
        """The window's launches, from the buffers to the buffers."""
        op, upd = self.op, self.upd
        b, c, lb, ub, T, Sigma = self.vecs
        sched = upd.schedule(self.tau, self.sigma, self.n, self.gamma,
                             out=self.sched)[0]
        for k in range(self.n):
            x_in, x_out = self.x[k % 2], self.x[(k + 1) % 2]
            y_in, y_out = self.y[k % 2], self.y[(k + 1) % 2]
            upd.dual_step(y_in, op.fwd(self.x_bar), b, Sigma, sched[1, k],
                          self.ys, out=y_out)
            upd.primal_step(x_in, op.adj(y_out), c, T, lb, ub, sched[0, k],
                            sched[2, k], self.xs, x_new=x_out,
                            x_bar=self.x_bar)

    def _on_capture_stream(self, fn) -> None:
        dev = self.x.device
        cur = torch.cuda.current_stream(dev)
        cap = cur
        if cur == torch.cuda.default_stream(dev):
            cap = _SIDE_STREAMS.get(dev)
            if cap is None:
                cap = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
            cap.wait_stream(cur)
        with torch.cuda.stream(cap):
            fn()
        if cap is not cur:
            cur.wait_stream(cap)

    def _capture(self) -> None:
        # CUDAGraph itself, not torch.cuda.graph: that one synchronises
        # the device first, which the transfer guard forbids and which
        # would stall every other bucket's stream
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        try:
            self.body()
        finally:
            graph.capture_end()
        after = kernels.launch_counts()
        # capturing launches nothing: the counts belong to the replays
        self.launches = {k: after[k] - before[k] for k in after}
        kernels.add_launch_counts({k: -v for k, v in self.launches.items()})
        self.graph = graph
        GRAPHS["captures"] += 1

    def run(self, state: PDHGState, xs, ys):
        self.x[0].copy_(state.x)
        self.y[0].copy_(state.y)
        self.x_bar.copy_(state.x_bar)
        self.tau.copy_(state.tau)
        self.sigma.copy_(state.sigma)
        self.xs.copy_(xs)
        self.ys.copy_(ys)
        if not self.capture:
            self.body()
        elif not self.warm:
            self._on_capture_stream(self.body)
            self.warm = True
        else:
            self.mode = "replay"
            if self.graph is None:
                self.mode = "capture"
                self._on_capture_stream(self._capture)
            self.graph.replay()
            kernels.add_launch_counts(self.launches)
            GRAPHS["replays"] += 1
        n = self.n
        _, tau, sigma = self.sched
        return (PDHGState(x=self.x[n % 2], x_prev=self.x[(n - 1) % 2],
                          x_bar=self.x_bar, y=self.y[n % 2], tau=tau,
                          sigma=sigma), self.xs, self.ys)


def pdhg_loop(op: Operator, upd: Updates, b, c, lb, ub, T, Sigma,
              x0, y0, tau0, sigma0, *,
              max_iters: int, tol: float, gamma: float, check_every: int,
              restart_beta: float, restart: bool = True,
              step_rule: str = "fixed", eta: float = 0.95,
              xsum_fn: Optional[Callable] = None,
              ysum_fn: Optional[Callable] = None,
              residual_fn: Optional[Callable] = None,
              read: Callable = bool, graph: bool = True):
    """The solve loop: ``check_every`` steps per window (or one fused
    launch when ``op.fuse`` is mounted), then one residual check on the
    current AND the ergodic-average iterate with a PDLP-style adaptive
    restart.

    A stepped window is a ``SteppedWindow``: on a CUDA operator with
    ``op.capture`` its launches run as one CUDA graph a window (captured
    once a call), unless ``graph=False``.  Not captured: the windows of
    noisy operators (their read noise draws from a ``torch.Generator``),
    fused windows (one launch already), and the host driver
    (``core.pdhg.solve``), which steps ``pdhg_step`` itself.  The check
    and the restart run eagerly, once a window.

    One instance has (d,) vectors and 0-d step sizes; a batch of B lanes
    has a leading axis ((B, d), (B,)) and runs as the reference's
    ``while_loop`` under ``jax.vmap``.  Before each window a lane is
    active while ``it < max_iters`` and ``merit > tol``; every lane
    advances while ANY lane is active, and after the window a stopped
    lane takes back its state (a per-lane ``torch.where`` on the active
    mask), so each lane reports its own iterations and merit, and
    finished lanes are still computed (what the crossbar ledger
    charges), except by a fuse hook that skips the lanes ``active``
    marks stopped (B5), which changes no result.  Exits only at check
    boundaries, so ``iterations`` can overshoot ``max_iters`` up to the
    next multiple of ``check_every``.

    ``restart=False`` drops the averaged-iterate block and its two
    MVMs.  ``step_rule="adaptive"`` rescales (tau0, sigma0) from the
    data, rebalances the primal weight at restart events and applies the
    down-only safeguard at every boundary, all from already-computed
    quantities (zero extra MVMs).  ``"strongly_convex"`` runs the theta
    schedule inside the window (the step carries it in tau/sigma).
    Restart and step-rule state is all per lane.

    ``xsum_fn``/``ysum_fn`` reduce primal/dual vectors in the adaptive
    rule (default ``lane_sum``); the sharded path (``distributed.
    pdhg_dist``) passes all-reduced sums.  Its windows run eagerly:
    a sharded operator does not allow capture (``sharded_operator``).

    ``residual_fn(x, x_prev, y, Kx, KTy) -> merit`` defaults to the
    dense KKT residual max.  A generator: it yields once a window, just
    before the one host read of that window (``read(active.any())``), so
    that a caller can interleave the windows of several batches, and
    returns ``(x, y, its, merit, windows)``: ``its`` (int64) and
    ``merit`` per lane on the device (the merit of the iterate actually
    carried) and ``windows`` the windows run.  ``drain`` runs it to its
    end.

    Each window is three ``spans``: ``loop.window`` (its launches, with
    the ``mode`` it ran in: eager, capture, replay or fused),
    ``loop.check`` (the check, the restart and the step rule, up to the
    yield) and ``loop.read`` (the host read); none stays open across the
    yield.
    """
    if step_rule not in STEP_RULES:
        raise ValueError(f"unknown step_rule {step_rule!r}; expected one "
                         f"of {STEP_RULES}")
    adaptive = step_rule == "adaptive"
    xsum = lane_sum if xsum_fn is None else xsum_fn
    ysum = lane_sum if ysum_fn is None else ysum_fn
    if residual_fn is None:
        def residual_fn(x, x_prev, y, Kx, KTy):
            return kkt_residuals(x, x_prev, y, c, b, Kx, KTy,
                                 lb=lb, ub=ub).max

    dt, dev = x0.dtype, x0.device
    lead = tuple(x0.shape[:-1])          # () for one instance, (B,)

    def lanes(v):
        return torch.full(lead, v, dtype=dt, device=dev)

    tau0 = torch.as_tensor(tau0, dtype=dt, device=dev).expand(lead)
    sigma0 = torch.as_tensor(sigma0, dtype=dt, device=dev).expand(lead)
    anchors = ()
    if adaptive:
        tau0, sigma0 = adaptive_omega_init(tau0, sigma0, b, c, T, Sigma,
                                           xsum, ysum)
        w0 = torch.sqrt(sigma0 / tau0)
        w_lo = w0 / ADAPT_OMEGA_CLIP
        w_hi = w0 * ADAPT_OMEGA_CLIP
        # (ax, ay, aKx, aKTy, aok, rx, ry): the window baselines for the
        # first boundary are placeholders (aok=False masks them); the
        # restart anchors start at the true initial iterate
        anchors = (x0, y0, torch.zeros_like(y0), torch.zeros_like(x0),
                   torch.zeros(lead, dtype=torch.bool, device=dev), x0, y0)
    state = init_state(x0, y0, tau0, sigma0, gamma)
    its = torch.zeros(lead, dtype=torch.int64, device=dev)
    # (merit, xs, ys, cnt, m_restart)
    rest = (lanes(math.inf), torch.zeros_like(x0), torch.zeros_like(y0),
            lanes(0.0), lanes(math.inf))
    windows = 0
    # every lane starts with it = 0 and merit = inf: the first condition
    # is known on the host
    if not (max_iters > 0 and math.inf > tol):
        return state.x, state.y, its, rest[0], windows
    active = torch.ones(lead, dtype=torch.bool, device=dev)
    window = None
    if op.fuse is None:
        window = SteppedWindow(op, upd, b, c, lb, ub, T, Sigma, gamma,
                               check_every, x0, y0,
                               graph and op.capture and dev.type == "cuda")
    while True:
        merit, xs, ys, cnt, m_restart = rest
        s = state
        with spans.span("loop.window", device=dev) as span:
            if op.fuse is not None:
                # megakernel window: one fused launch over the active lanes
                s, dxs, dys = op.fuse(s, check_every, active)
                xs, ys = xs + dxs, ys + dys
                mode = "fused"
            else:
                # the window's outputs are views of its buffers; everything
                # below that outlives the window (the selects) is a new
                # tensor
                s, xs, ys = window.run(s, xs, ys)
                mode = window.mode
            span.set("mode", mode)
        spans.count(f"windows.{mode}")
        with spans.span("loop.check", device=dev):
            cnt = cnt + check_every
            Kx = op.fwd(s.x)
            KTy = op.adj(s.y)
            merit = residual_fn(s.x, s.x_prev, s.y, Kx, KTy)
            Kx_c, KTy_c = Kx, KTy
            new_anchors = anchors
            if restart:
                x_avg = xs / _lanes(torch.clamp(cnt, min=1.0), xs)
                y_avg = ys / _lanes(torch.clamp(cnt, min=1.0), ys)
                Kxa = op.fwd(x_avg)
                KTya = op.adj(y_avg)
                merit_avg = residual_fn(x_avg, x_avg, y_avg, Kxa, KTya)
                do_restart = merit_avg < restart_beta * m_restart
                # adopt the average on a restart that improves the merit, or
                # whenever it already satisfies tol
                use_avg = ((do_restart & (merit_avg < merit))
                           | (merit_avg <= tol))
                x, x_prev, x_bar, y = select_lanes(
                    use_avg, (x_avg, x_avg, x_avg, y_avg),
                    (s.x, s.x_prev, s.x_bar, s.y))
                s = s._replace(x=x, x_prev=x_prev, x_bar=x_bar, y=y)
                m_restart = torch.where(do_restart,
                                        torch.minimum(merit_avg, merit),
                                        m_restart)
                xs, ys, cnt = select_lanes(
                    do_restart, (torch.zeros_like(xs), torch.zeros_like(ys),
                                 torch.zeros_like(cnt)),
                    (xs, ys, cnt))
                # the carried merit is the merit of the iterate CARRIED
                merit = torch.where(use_avg, merit_avg, merit)
                if adaptive:
                    # operator images of the carried iterate, by linearity
                    Kx_c, KTy_c = select_lanes(use_avg, (Kxa, KTya), (Kx, KTy))
                    rx, ry = anchors[5:]
                    tau_n, sigma_n = adaptive_omega_update(
                        s.tau, s.sigma, s.x - rx, s.y - ry, T, Sigma, w_lo,
                        w_hi, do_restart, xsum, ysum)
                    s = s._replace(tau=tau_n, sigma=sigma_n)
                    new_anchors = anchors[:5] + select_lanes(
                        do_restart, (s.x, s.y), (rx, ry))
            if adaptive:
                ax, ay, aKx, aKTy, aok = new_anchors[:5]
                tau_n, sigma_n = adaptive_shrink(
                    s.tau, s.sigma, eta, s.x - ax, s.y - ay, Kx_c - aKx,
                    KTy_c - aKTy, T, Sigma, aok, xsum, ysum)
                s = s._replace(tau=tau_n, sigma=sigma_n)
                new_anchors = ((s.x, s.y, Kx_c, KTy_c, torch.ones_like(aok))
                               + new_anchors[5:])
            # lanes that had stopped keep their state (the vmapped select)
            state = PDHGState(*select_lanes(active, s, state))
            rest = select_lanes(active, (merit, xs, ys, cnt, m_restart), rest)
            anchors = select_lanes(active, new_anchors, anchors)
            its = torch.where(active, its + check_every, its)
            windows += 1
            active = (its < max_iters) & (rest[0] > tol)
        yield
        # the one host read of the window
        with spans.span("loop.read"):
            go = read(active.any())
        spans.count("host_reads")
        if not go:
            break
    return state.x, state.y, its, rest[0], windows


def drain(gen):
    """Run a loop generator (``pdhg_loop``, ``solve_core``) to its end;
    its return value."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


# ----------------------------------------------------- core + ledger ---

def solve_core(K_fwd, K_adj, b, c, lb, ub, T, Sigma, rho,
               generator: Optional[torch.Generator], static, *,
               operator: Optional[Operator] = None, x0=None, y0=None,
               read: Callable = bool, graph: bool = True):
    """The solve core: option plumbing around ``pdhg_loop``, for one
    instance or a batch (a generator as well; same returns).

    ``static`` is the tuple from ``pdhg.opts_static``: (max_iters, tol,
    eta, omega, gamma, check_every, restart_beta, sigma_read, kernel,
    restart, sparse_kernel, megakernel, step_rule, ...).  ``rho`` is the
    operator-norm estimate (0-d, or (B,) for a batch).  ``x0``/``y0``
    start the loop (both or neither); by default one instance's
    projected-Gaussian start is drawn from ``generator``, which also
    drives the read noise of the default dense operator (an (m, n) K or
    a (B, m, n) stack); ``K_adj=None`` means the adjoint is exactly
    ``K_fwd``'s transpose.  The dense megakernel is mounted when asked
    for on a noiseless dense operator: its transpose form when
    ``K_adj`` is None, else its two-matrix form.  ``graph`` goes to
    ``pdhg_loop``.
    """
    (max_iters, tol, eta, omega, gamma, check_every, restart_beta,
     sigma_read, kernel) = static[:9]
    restart = bool(static[9]) if len(static) > 9 else True
    megakernel = bool(static[11]) if len(static) > 11 else False
    step_rule = str(static[12]) if len(static) > 12 else "fixed"
    # an all-zero operator has rho = 0; unguarded it makes tau0 = inf
    rho = torch.clamp(torch.as_tensor(rho, dtype=b.dtype, device=b.device),
                      min=1e-12)
    tau0 = eta / (omega * rho)
    sigma0 = eta * omega / rho
    if x0 is None:
        x0, y0 = draw_init(generator, b.shape[-1], c.shape[-1], lb, ub,
                           b.dtype)
    if operator is None:
        operator = dense_operator(K_fwd, K_fwd.mT if K_adj is None else K_adj,
                                  sigma_read, generator)
    if (megakernel and operator.fuse is None and sigma_read == 0.0
            and operator.name == "dense"):
        operator = operator._replace(fuse=make_fused_dense(
            K_fwd.contiguous(), None if K_adj is None else K_adj.contiguous(),
            b, c, lb, ub, T, Sigma, gamma))
    return (yield from pdhg_loop(
        operator, make_updates(kernel),
        b, c, lb, ub, T, Sigma, x0, y0, tau0, sigma0,
        max_iters=max_iters, tol=tol, gamma=gamma, check_every=check_every,
        restart_beta=restart_beta, restart=restart,
        step_rule=step_rule, eta=eta, read=read, graph=graph))


def lemma2_margin(rho, sigma_read: float):
    """Widen a NOISY operator-norm estimate so tau*sigma*rho^2 < 1
    (Lemma 2) holds for the TRUE norm despite read noise in the norm
    estimate's MVMs.  Identity when noiseless."""
    if sigma_read <= 0.0:
        return rho
    return rho / (1.0 - min(4.0 * sigma_read, 0.5))


#: MVMs per PDHG iteration: one forward (K @ x_bar) for the dual update
#: and one adjoint (K^T @ y) for the primal update.
MVMS_PER_ITERATION = 2


def mvms_per_check(restart: bool = True) -> int:
    """MVMs per residual check: an x/y pair for the current iterate, and
    a second pair for the averaged iterate when restarts are on."""
    return 4 if restart else 2


def mvm_window_budget(check_every: int, restart: bool = True) -> int:
    """MVMs per check window: ``check_every`` iterations plus the check.
    ``step_rule="adaptive"`` adds exactly zero."""
    return MVMS_PER_ITERATION * check_every + mvms_per_check(restart)


def mvm_accounting(iterations: int, check_every: int,
                   lanczos_iters: int, restart: bool = True) -> int:
    """Device-MVM total for the energy ledger: norm estimation (one MVM
    per Lanczos/power iteration) + ``MVMS_PER_ITERATION`` per iteration
    + ``mvms_per_check(restart)`` per check.  Iterations quantize to
    ``check_every`` multiples, on the stepped and fused paths alike."""
    n_checks = max(1, iterations // max(1, check_every))
    return (lanczos_iters + MVMS_PER_ITERATION * iterations
            + mvms_per_check(restart) * n_checks)


def refine_digital_mvms(refine_rounds: int) -> int:
    """Exact (digital) MVMs the refinement shell (``crossbar.refine``)
    issues outside the analog loops: one (Kx, K^T y) baseline pair plus
    one candidate pair per round.  Never charged to the read ledger."""
    return 0 if refine_rounds <= 0 else 2 + 2 * refine_rounds


def refine_window_factor(refine_rounds: int) -> int:
    """Number of analog loop solves a refined path runs (the original
    solve plus one correction solve per round): each is a full
    ``pdhg_loop`` whose windows charge ``mvm_window_budget`` MVMs.  The
    MVM-budget audit multiplies the per-window budget by this when it
    audits refined paths."""
    return 1 + max(0, refine_rounds)
