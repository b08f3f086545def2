"""DiffVC diffusion: the closed-form VP-SDE algebra, the pf/em/ml/dpm
samplers and the decoder's score-matching loss.

The port's counterpart of ``tpu_speech/models/diffvc/diffusion.py:18-193``
(the reference DiffVC/model/diffusion.py:109-222). ``forward_diffusion`` and
``diffusion_loss`` take their draws (t, z) as optional arguments; without
them they come from ``generator`` on the state's device, t first. The per-step
coefficients depend only on the step index: they are one numpy float32
table, built vectorised in the JAX package's order of operations (kappa
divides 1 - gamma(t - h, t) by gamma0 * beta * h, a cancellation where a
float64 or reordered table drifts) with each exp rounded as XLA's, and each
step reads its row as Python floats, so no step reads the device from the
host. The ``ml`` and ``em`` steps' noise is an argument (``step_noise``,
one draw per step) or is drawn from ``generator`` on the state's device.

The algebra takes Python floats, numpy float32 arrays or tensors. ``mask``
broadcasts against the state and ``ref_mask`` against ``ref``: (B, T, 1) in
the JAX package's (B, T, F) layout, (B, 1, T) in the estimator's (B, F, T).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpu_speech_torch.models.diffusion import draw_t_z, reverse_diffusion_dpm


def _exp(x):
    """exp of a tensor, or of float32 numbers rounded as XLA's float32 exp
    rounds them: in float64, then to float32. Numpy's float32 exp differs
    from that in the last bit for about 40 % of inputs, which the tables'
    cancellations take to 1e-5 of JAX's values."""
    if isinstance(x, torch.Tensor):
        return torch.exp(x)
    return np.exp(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(np.asarray(x, np.float32))


def get_gamma(s, t, beta_min: float, beta_max: float, p: float = 1.0):
    """exp(-0.5 * p * int_s^t beta(u) du) for the linear beta schedule."""
    beta_integral = (beta_min + 0.5 * (beta_max - beta_min) * (t + s)) * (t - s)
    return _exp(-0.5 * p * beta_integral)


def get_mu(s, t, beta_min, beta_max):
    a = get_gamma(s, t, beta_min, beta_max)
    b = 1.0 - get_gamma(0, s, beta_min, beta_max, p=2.0)
    c = 1.0 - get_gamma(0, t, beta_min, beta_max, p=2.0)
    return a * b / c


def get_nu(s, t, beta_min, beta_max):
    a = get_gamma(0, s, beta_min, beta_max)
    b = 1.0 - get_gamma(s, t, beta_min, beta_max, p=2.0)
    c = 1.0 - get_gamma(0, t, beta_min, beta_max, p=2.0)
    return a * b / c


def get_sigma(s, t, beta_min, beta_max):
    a = 1.0 - get_gamma(0, s, beta_min, beta_max, p=2.0)
    b = 1.0 - get_gamma(s, t, beta_min, beta_max, p=2.0)
    c = 1.0 - get_gamma(0, t, beta_min, beta_max, p=2.0)
    return _sqrt(a * b / c)


def compute_diffused_mean(x0, mask, mean, t, beta_min, beta_max):
    """E[x_t | x_0] = gamma * x0 + (1 - gamma) * mean, masked. ``t`` a
    Python float or a 0-d tensor."""
    w = get_gamma(0.0, t, beta_min, beta_max)
    if not isinstance(w, torch.Tensor):
        w, one_minus_w = float(w), float(np.float32(1.0) - w)
    else:
        one_minus_w = 1.0 - w
    return (x0 * w + mean * one_minus_w) * mask


def forward_diffusion(x0, mask, mean, t, beta_min: float, beta_max: float,
                      z: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """x_t ~ N(gamma x0 + (1 - gamma) mean, 1 - gamma^2) at t (B,): x0, mean
    and ``z`` (the standard-normal draw, from ``generator`` when not given)
    of one shape, mask broadcasting against them. Returns (xt, z), both
    masked."""
    tb = t.view(-1, *(1,) * (x0.dim() - 1))
    xt_mean = x0 * get_gamma(0.0, tb, beta_min, beta_max) + mean * (
        1.0 - get_gamma(0.0, tb, beta_min, beta_max))
    variance = 1.0 - get_gamma(0.0, tb, beta_min, beta_max, p=2.0)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    xt = xt_mean * mask + z * torch.sqrt(variance)
    return xt * mask, z * mask


def diffusion_loss(score_fn, x0, mask, mean, ref, mean_ref, n_feats: int, beta_min: float,
                   beta_max: float, offset: float = 1e-5, t: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score matching at t ~ U[offset, 1 - offset] (B,): the reference is
    diffused to the same t as the source, with the source's mask.
    ``score_fn(xt, xt_ref, t)`` evaluates the estimator; ``t`` and ``z``
    (x0's shape) replace the draws, which are made at the global batch's
    shape over N ranks (``models/diffusion.py::draw_t_z``). The sum divides
    by (``count``, or sum(mask)) x n_feats."""
    t, z = draw_t_z(x0, offset, t, z, generator)
    xt, z = forward_diffusion(x0, mask, mean, t, beta_min, beta_max, z=z)
    tb = t.view(-1, *(1,) * (x0.dim() - 1))
    xt_ref = (ref * get_gamma(0.0, tb, beta_min, beta_max)
              + mean_ref * (1.0 - get_gamma(0.0, tb, beta_min, beta_max))) * mask
    z_est = score_fn(xt, xt_ref, t)
    z_est = z_est * torch.sqrt(1.0 - get_gamma(0.0, tb, beta_min, beta_max, p=2.0))
    denom = torch.sum(mask) if count is None else count.to(mask.dtype)
    return torch.sum((z_est + z) ** 2) / (denom * n_feats)


def step_table(n_timesteps: int, beta_min: float, beta_max: float, mode: str) -> np.ndarray:
    """The (n_timesteps, 7) float32 table of per-step coefficients:
    t = 1 - i h (no half-step offset), gamma0 = gamma(0, t), 1 - gamma0, and
    the step's weights: on (mean - xt) 0.5 beta h + omega, on the score
    (1 + kappa) and beta h, on the noise sigma. ``pf`` uses only t, gamma0,
    1 - gamma0 and beta h; its drift is 0.5 (mean - xt - score) beta h."""
    h = 1.0 / n_timesteps
    ts = 1.0 - np.arange(n_timesteps, dtype=np.float32) * h
    beta_ts = beta_min + (beta_max - beta_min) * ts
    gamma0_ts = get_gamma(0.0, ts, beta_min, beta_max)
    if mode == "ml":
        kappas = get_gamma(0, ts - h, beta_min, beta_max) * (
            1.0 - get_gamma(ts - h, ts, beta_min, beta_max, p=2.0))
        kappas = kappas / (gamma0_ts * beta_ts * h)
        kappas = kappas - 1.0
        omegas = get_nu(ts - h, ts, beta_min, beta_max) / gamma0_ts
        omegas = omegas + get_mu(ts - h, ts, beta_min, beta_max)
        omegas = omegas - (0.5 * beta_ts * h + 1.0)
        sigmas = get_sigma(ts - h, ts, beta_min, beta_max)
    elif mode == "em":
        kappas = omegas = np.zeros_like(ts)
        sigmas = np.sqrt(beta_ts * h)
    else:
        kappas = omegas = sigmas = np.zeros_like(ts)
    table = np.stack([ts, gamma0_ts, 1.0 - gamma0_ts, 0.5 * beta_ts * h + omegas,
                      1.0 + kappas, beta_ts * h, sigmas], axis=1)
    assert table.dtype == np.float32, table.dtype
    return table


def reverse_diffusion(
    score_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    mask: torch.Tensor,
    mean: torch.Tensor,
    ref: torch.Tensor,
    ref_mask: torch.Tensor,
    mean_ref: torch.Tensor,
    n_timesteps: int,
    beta_min: float,
    beta_max: float,
    mode: str = "ml",
    step_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Integrate from t = 1 to 0. ``score_fn(xt, xt_ref, t_vec)`` evaluates
    the conditional estimator. mode in {'pf', 'em', 'ml'}, plus 'dpm':
    DPM-Solver++(2M) on the same probability-flow ODE as 'pf', with the
    reference diffused at the step's time. ``step_noise`` (n_timesteps, *z's
    shape) holds the 'em'/'ml' steps' standard-normal draws; without it each
    step draws from ``generator``."""
    assert mode in ("pf", "em", "ml", "dpm"), mode
    if mode == "dpm":
        def cond_score_fn(xt, t_vec):
            xt_ref = compute_diffused_mean(ref, ref_mask, mean_ref, t_vec[0], beta_min,
                                           beta_max)
            return score_fn(xt, xt_ref, t_vec)

        return reverse_diffusion_dpm(cond_score_fn, z, mask, mean, n_timesteps, beta_min,
                                     beta_max, order=2)
    b = z.shape[0]
    xt = z * mask
    for i, (t, g0, one_minus_g0, c_mean, c_score, beta_h, sigma) in enumerate(
            step_table(n_timesteps, beta_min, beta_max, mode).tolist()):
        t_vec = torch.full((b,), t, dtype=z.dtype, device=z.device)
        xt_ref = (ref * g0 + mean_ref * one_minus_g0) * ref_mask
        score = score_fn(xt, xt_ref, t_vec)
        if mode == "pf":
            dxt = 0.5 * (mean - xt - score) * beta_h
        else:
            noise = step_noise[i] if step_noise is not None else torch.randn(
                z.shape, generator=generator, dtype=z.dtype, device=z.device)
            dxt = (mean - xt) * c_mean
            dxt = dxt - score * c_score * beta_h
            dxt = dxt + noise * sigma
        xt = (xt - dxt) * mask
    return xt
