"""Executable forms of the paper's theoretical guarantees; a numpy-only
copy of ``repro.core.theory``.

Lemma 2 (safe coupling): if the norm estimate satisfies |L^ - L| <= delta_bar*L
and tau*sigma = theta / L^2 with theta in (0, (1-delta_bar)^2), then
tau*sigma*L^2 < 1 — PDHG's convergence condition holds despite the noisy
estimate.

Theorem 1 (noisy Lanczos):  E|theta_k - L| <= C rho^{kappa(k-1)} + k eps_max
Theorem 2 (noisy PDHG):     E[gap(z_bar_K)] <= C0/K + delta/sqrt(K)

The bound evaluators below are used by tests/test_theory.py to check the
empirical estimators against these envelopes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SafeCoupling:
    tau: float
    sigma: float
    theta: float          # safety margin used
    satisfied: bool       # tau*sigma*L_hat^2-based guarantee holds


def safe_coupling(
    L_hat: float,
    delta_bar: float = 0.0,
    eta: float = 0.95,
    omega: float = 1.0,
) -> SafeCoupling:
    """Step sizes from a noisy norm estimate (Lemma 2).

    theta = eta^2 must lie in (0, (1 - delta_bar)^2)  =>  eta < 1 - delta_bar.
    tau = eta/(omega L^),  sigma = eta*omega/L^  =>  tau*sigma = eta^2/L^2.
    """
    if not (0.0 <= delta_bar < 1.0):
        raise ValueError("delta_bar must be in [0, 1)")
    eta_eff = min(eta, (1.0 - delta_bar) * 0.999)
    theta = eta_eff**2
    tau = eta_eff / (omega * L_hat)
    sigma = eta_eff * omega / L_hat
    satisfied = theta < (1.0 - delta_bar) ** 2
    return SafeCoupling(tau=tau, sigma=sigma, theta=theta, satisfied=satisfied)


def lemma2_worst_case(L: float, L_hat: float, tau: float, sigma: float,
                      delta_bar: float) -> Tuple[float, bool]:
    """Check tau*sigma*L^2 <= theta/(1-delta_bar)^2 < 1 for the true L."""
    lhs = tau * sigma * L * L
    theta = tau * sigma * L_hat * L_hat
    bound = theta / (1.0 - delta_bar) ** 2
    return lhs, bool(lhs <= bound + 1e-12 and bound < 1.0)


def theorem1_envelope(k: np.ndarray, C: float, rho: float, kappa: int,
                      eps_max: float) -> np.ndarray:
    """Pointwise Ritz-error envelope  C rho^{kappa(k-1)} + k eps_max."""
    k = np.asarray(k, dtype=np.float64)
    return C * rho ** (kappa * (k - 1.0)) + k * eps_max


def theorem2_envelope(K: np.ndarray, C0: float, delta: float) -> np.ndarray:
    """Ergodic-gap envelope  C0/K + delta/sqrt(K)."""
    K = np.asarray(K, dtype=np.float64)
    return C0 / K + delta / np.sqrt(K)


def spectral_ratio(M_eigs: np.ndarray) -> Tuple[float, int]:
    """rho = lambda_{p+1}/lambda_1 and multiplicity p of the top eigenvalue."""
    lam = np.sort(np.abs(np.asarray(M_eigs)))[::-1]
    lam1 = lam[0]
    p = int(np.sum(np.isclose(lam, lam1, rtol=1e-10)))
    rho = lam[p] / lam1 if p < lam.size else 0.0
    return float(rho), p
