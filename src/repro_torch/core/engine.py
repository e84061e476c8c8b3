"""One PDHG iteration engine with pluggable operator / update backends;
the port of ``repro.core.engine`` for the dense solve.

An enhanced-PDHG iteration is two MVMs plus cheap vector algebra.  This
module is the single home of that step (``pdhg_step``), of the check
window with its restart and step-rule logic (``pdhg_loop``), and of the
MVM accounting the energy ledger charges.  Two backend axes:

  * operator (``Operator``): the two MVMs — dense ``torch.mv`` with
    optional multiplicative read noise, plus an optional ``fuse`` hook
    that runs a whole check window as one launch (the B3 megakernel);
  * updates (``Updates``): the proximal vector algebra — plain PyTorch
    (``"torch"``) or the hand-written CUDA kernels (``"cuda"``, B1/B2;
    on CPU tensors the kernels' plain versions run instead).

State is carried in the pre-extrapolated form of the reference:
``x_bar`` for iteration k is produced by iteration k-1's primal update,
and ``tau``/``sigma`` already include iteration k's theta_k.

Host/device contract: ``tau``, ``sigma``, ``theta``, the merits and
every restart decision are 0-d tensors on the device, combined with
``torch.where``; the loop reads one value on the host per check window
(``merit > tol``).  Random numbers come from an explicit
``torch.Generator``; JAX's key splitting has no counterpart.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..kernels import pdhg_megakernel, pdhg_update
from .residuals import kkt_residuals

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
    """Carried PDHG iterate.  ``tau``/``sigma`` are 0-d tensors holding
    the CURRENT iteration's step sizes (theta_k already applied)."""

    x: torch.Tensor
    x_prev: torch.Tensor
    x_bar: torch.Tensor
    y: torch.Tensor
    tau: torch.Tensor
    sigma: torch.Tensor


class Operator(NamedTuple):
    """The two MVMs of one iteration: ``fwd(v) ~ K v`` (dual step) and
    ``adj(v) ~ K^T v`` (primal step).  ``fuse(state, n_steps) ->
    (state', x_sum, y_sum)`` is the optional megakernel hook, mounted
    only on noiseless backends."""

    fwd: Callable
    adj: Callable
    name: str = "dense"
    fuse: Optional[Callable] = None


class Updates(NamedTuple):
    """The proximal vector algebra of one iteration.

    primal(x, kty, c, T, lb, ub, tau, theta) -> (x_new, x_bar_next)
    dual(y, kxbar, b, Sigma, sigma)          -> y_new
    """

    primal: Callable
    dual: Callable
    name: str = "torch"


# ---------------------------------------------------- operator backends ---

def _read_noise(w, generator, sigma_read):
    """Multiplicative cycle-to-cycle read noise, truncated at 4 sigma so
    Assumption 3 (bounded perturbation) holds exactly."""
    g = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                    device=w.device)
    return w * (1.0 + sigma_read * torch.clamp(g, -4.0, 4.0))


def dense_operator(K_fwd, K_adj, sigma_read: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> Operator:
    """Dense backend.  On an ideal device ``K_adj == K_fwd.T``; on a
    programmed crossbar the two blocks are distinct cells.  With
    ``sigma_read > 0`` every MVM draws its read noise from
    ``generator`` (on the operands' device)."""
    if sigma_read > 0.0 and generator is None:
        raise ValueError("a noisy operator needs a torch.Generator")

    def fwd(v):
        w = torch.mv(K_fwd, v)
        if sigma_read > 0.0:
            w = _read_noise(w, generator, sigma_read)
        return w

    def adj(v):
        w = torch.mv(K_adj, v)
        if sigma_read > 0.0:
            w = _read_noise(w, generator, sigma_read)
        return w

    return Operator(fwd, adj, "dense")


# ------------------------------------------------- megakernel (fused) ---

def make_fused_dense(K_fwd, K_adj, b, c, lb, ub, T, Sigma,
                     gamma) -> Callable:
    """``Operator.fuse`` hook for the dense backend: one
    ``kernels.pdhg_megakernel`` launch per check window.  Noiseless
    only; ``K_adj`` must be a contiguous (n, m) tensor."""

    def fuse(state: PDHGState, n_steps: int):
        (x, x_prev, x_bar, y, tau, sigma, xs, ys) = \
            pdhg_megakernel.fused_dense_steps(
                K_fwd, K_adj, b, c, lb, ub, T, Sigma,
                state.x, state.x_prev, state.x_bar, state.y,
                state.tau, state.sigma,
                n_steps=int(n_steps), gamma=float(gamma))
        return (PDHGState(x=x, x_prev=x_prev, x_bar=x_bar, y=y,
                          tau=tau, sigma=sigma), xs, ys)

    return fuse


# ------------------------------------------------------ update backends ---

TORCH_UPDATES = Updates(pdhg_update.primal_update_plain,
                        pdhg_update.dual_update_plain, "torch")
CUDA_UPDATES = Updates(pdhg_update.primal_update, pdhg_update.dual_update,
                       "cuda")


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


def adaptive_omega_init(tau0, sigma0, b, c, T, Sigma):
    """Data-driven primal-weight initialization (the PDLP heuristic in
    the preconditioned metric): scale ``omega = sqrt(sigma/tau)`` by
    ``sqrt(|T^1/2 c| / |Sigma^1/2 b|)``, clipped to [1/1024, 1024]."""
    tiny = _tiny(b)
    one = torch.ones_like(tiny)
    nc2 = torch.sum(T * c * c)
    nb2 = torch.sum(Sigma * b * b)
    w = (torch.maximum(nc2, tiny) / torch.maximum(nb2, tiny)) ** 0.25
    w = torch.clamp(w, 1.0 / ADAPT_OMEGA_CLIP, ADAPT_OMEGA_CLIP)
    ok = (nc2 > tiny) & (nb2 > tiny)
    w = torch.where(ok & torch.isfinite(w), w, one)
    return tau0 / w, sigma0 * w


def adaptive_shrink(tau, sigma, eta, dx, dy, Kdx, KTdy, T, Sigma, ok):
    """Down-only step-scale safeguard at every check boundary (zero
    extra MVMs: ``Kdx``/``KTdy`` come from the check MVMs by
    linearity).  The Rayleigh quotient along the window's movement is a
    lower bound on the preconditioned operator norm, so when
    ``sqrt(tau*sigma) * rho_loc > eta`` the scale shrinks to
    ``eta / rho_loc``; it is never grown."""
    tiny = _tiny(dx)
    one = torch.ones_like(tiny)
    ndx2 = torch.sum(dx * dx / T)
    ndy2 = torch.sum(dy * dy / Sigma)
    nK2 = torch.sum(Sigma * Kdx * Kdx) + torch.sum(T * KTdy * KTdy)
    mv2 = ndx2 + ndy2
    rho_loc = torch.sqrt(nK2 / torch.maximum(mv2, tiny))
    g = torch.sqrt(tau * sigma)
    s = torch.minimum(one, eta / torch.maximum(rho_loc * g, tiny))
    ok = ok & (mv2 > tiny) & torch.isfinite(s)
    s = torch.where(ok, s, one)
    return tau * s, sigma * s


def adaptive_omega_update(tau, sigma, dx, dy, T, Sigma, w_lo, w_hi, ok):
    """PDLP primal-weight rebalancing at RESTART events only: pull
    ``omega = sqrt(sigma/tau)`` toward the dual/primal movement ratio
    since the previous restart anchor with log-space smoothing, clipped
    to ``[w_lo, w_hi]``; the product ``tau*sigma`` is preserved."""
    tiny = _tiny(dx)
    ndx2 = torch.sum(dx * dx / T)
    ndy2 = torch.sum(dy * dy / Sigma)
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


def pdhg_loop(op: Operator, upd: Updates, b, c, lb, ub, T, Sigma,
              x0, y0, tau0, sigma0, *,
              max_iters: int, tol: float, gamma: float, check_every: int,
              restart_beta: float, restart: bool = True,
              step_rule: str = "fixed", eta: float = 0.95,
              residual_fn: Optional[Callable] = None):
    """The solve loop: ``check_every`` steps per window (or one fused
    launch when ``op.fuse`` is mounted), then one residual check on the
    current AND the ergodic-average iterate with a PDLP-style adaptive
    restart.  Exits only at check boundaries: ``it < max_iters`` is
    tested before each window, so ``iterations`` can overshoot
    ``max_iters`` up to the next multiple of ``check_every``, and
    ``merit > tol`` is read on the host once per window.

    ``restart=False`` drops the averaged-iterate block and its two
    MVMs.  ``step_rule="adaptive"`` rescales (tau0, sigma0) from the
    data, rebalances the primal weight at restart events and applies the
    down-only safeguard at every boundary, all from already-computed
    quantities (zero extra MVMs).  ``"strongly_convex"`` runs the theta
    schedule inside the window (the step carries it in tau/sigma).

    ``residual_fn(x, x_prev, y, Kx, KTy) -> merit`` defaults to the
    dense KKT residual max.  Returns ``(x, y, iterations, merit)`` with
    ``iterations`` an int and ``merit`` a 0-d tensor: the merit of the
    iterate actually carried.
    """
    if step_rule not in STEP_RULES:
        raise ValueError(f"unknown step_rule {step_rule!r}; expected one "
                         f"of {STEP_RULES}")
    adaptive = step_rule == "adaptive"
    if residual_fn is None:
        def residual_fn(x, x_prev, y, Kx, KTy):
            return kkt_residuals(x, x_prev, y, c, b, Kx, KTy,
                                 lb=lb, ub=ub).max

    dt, dev = x0.dtype, x0.device

    def scalar(v):
        return torch.full((), v, dtype=dt, device=dev)

    tau0 = torch.as_tensor(tau0, dtype=dt, device=dev)
    sigma0 = torch.as_tensor(sigma0, dtype=dt, device=dev)
    if adaptive:
        tau0, sigma0 = adaptive_omega_init(tau0, sigma0, b, c, T, Sigma)
        w0 = torch.sqrt(sigma0 / tau0)
        w_lo = w0 / ADAPT_OMEGA_CLIP
        w_hi = w0 * ADAPT_OMEGA_CLIP
        # window baselines for the first boundary are placeholders
        # (aok=False masks them); the restart anchors start at the
        # true initial iterate
        ax, ay = x0, y0
        aKx, aKTy = torch.zeros_like(y0), torch.zeros_like(x0)
        aok = torch.zeros((), dtype=torch.bool, device=dev)
        ok_true = torch.ones((), dtype=torch.bool, device=dev)
        rx, ry = x0, y0
    state = init_state(x0, y0, tau0, sigma0, gamma)

    it = 0
    merit = scalar(float("inf"))
    xs, ys = torch.zeros_like(x0), torch.zeros_like(y0)
    cnt = scalar(0.0)
    m_restart = scalar(float("inf"))
    zero = scalar(0.0)
    # the one host read per window (compared in the working dtype)
    while it < max_iters and bool(merit > tol):
        if op.fuse is not None:
            # megakernel window: one fused launch
            state, dxs, dys = op.fuse(state, check_every)
            xs, ys = xs + dxs, ys + dys
        else:
            for _ in range(check_every):
                state = pdhg_step(op, upd, b, c, lb, ub, T, Sigma, gamma,
                                  state)
                xs, ys = xs + state.x, ys + state.y
        cnt = cnt + check_every
        Kx = op.fwd(state.x)
        KTy = op.adj(state.y)
        merit = residual_fn(state.x, state.x_prev, state.y, Kx, KTy)
        Kx_c, KTy_c = Kx, KTy
        if restart:
            x_avg = xs / torch.clamp(cnt, min=1.0)
            y_avg = ys / torch.clamp(cnt, min=1.0)
            Kxa = op.fwd(x_avg)
            KTya = op.adj(y_avg)
            merit_avg = residual_fn(x_avg, x_avg, y_avg, Kxa, KTya)
            do_restart = merit_avg < restart_beta * m_restart
            # adopt the average on a restart that improves the merit, or
            # whenever it already satisfies tol
            use_avg = (do_restart & (merit_avg < merit)) | (merit_avg <= tol)

            def pick(a, cur):
                return torch.where(use_avg, a, cur)

            state = state._replace(
                x=pick(x_avg, state.x), x_prev=pick(x_avg, state.x_prev),
                x_bar=pick(x_avg, state.x_bar), y=pick(y_avg, state.y))
            m_restart = torch.where(do_restart,
                                    torch.minimum(merit_avg, merit),
                                    m_restart)
            xs = torch.where(do_restart, zero, xs)
            ys = torch.where(do_restart, zero, ys)
            cnt = torch.where(do_restart, zero, cnt)
            # the carried merit is the merit of the iterate CARRIED
            merit = torch.where(use_avg, merit_avg, merit)
            if adaptive:
                # operator images of the carried iterate, by linearity
                Kx_c, KTy_c = pick(Kxa, Kx), pick(KTya, KTy)
                tau_n, sigma_n = adaptive_omega_update(
                    state.tau, state.sigma, state.x - rx, state.y - ry,
                    T, Sigma, w_lo, w_hi, do_restart)
                state = state._replace(tau=tau_n, sigma=sigma_n)
                rx = torch.where(do_restart, state.x, rx)
                ry = torch.where(do_restart, state.y, ry)
        if adaptive:
            tau_n, sigma_n = adaptive_shrink(
                state.tau, state.sigma, eta,
                state.x - ax, state.y - ay, Kx_c - aKx, KTy_c - aKTy,
                T, Sigma, aok)
            state = state._replace(tau=tau_n, sigma=sigma_n)
            ax, ay, aKx, aKTy = state.x, state.y, Kx_c, KTy_c
            aok = ok_true
        it += check_every
    return state.x, state.y, it, merit


# ----------------------------------------------------- core + ledger ---

def solve_core(K_fwd, K_adj, b, c, lb, ub, T, Sigma, rho,
               generator: Optional[torch.Generator], static, *,
               operator: Optional[Operator] = None, x0=None, y0=None):
    """The solve core (option plumbing around ``pdhg_loop``).

    ``static`` is the tuple from ``pdhg.opts_static``: (max_iters, tol,
    eta, omega, gamma, check_every, restart_beta, sigma_read, kernel,
    restart, sparse_kernel, megakernel, step_rule, ...).  ``rho`` is the
    operator-norm estimate (a 0-d tensor).  ``x0``/``y0`` start the loop
    (both or neither); by default the projected-Gaussian start is drawn
    from ``generator``, which also drives the read noise.  The
    megakernel is mounted when asked for on a noiseless dense operator.
    """
    (max_iters, tol, eta, omega, gamma, check_every, restart_beta,
     sigma_read, kernel) = static[:9]
    restart = bool(static[9]) if len(static) > 9 else True
    megakernel = bool(static[11]) if len(static) > 11 else False
    step_rule = str(static[12]) if len(static) > 12 else "fixed"
    m, n = b.shape[0], c.shape[0]
    # an all-zero operator has rho = 0; unguarded it makes tau0 = inf
    rho = torch.clamp(torch.as_tensor(rho, dtype=b.dtype, device=b.device),
                      min=1e-12)
    tau0 = eta / (omega * rho)
    sigma0 = eta * omega / rho
    if x0 is None:
        x0, y0 = draw_init(generator, m, n, lb, ub, b.dtype)
    if operator is None:
        operator = dense_operator(K_fwd, K_adj, sigma_read, generator)
    if (megakernel and operator.fuse is None and sigma_read == 0.0
            and operator.name == "dense"):
        operator = operator._replace(fuse=make_fused_dense(
            K_fwd, K_adj, b, c, lb, ub, T, Sigma, gamma))
    return pdhg_loop(
        operator, make_updates(kernel),
        b, c, lb, ub, T, Sigma, x0, y0, tau0, sigma0,
        max_iters=max_iters, tol=tol, gamma=gamma, check_every=check_every,
        restart_beta=restart_beta, restart=restart,
        step_rule=step_rule, eta=eta,
    )


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
