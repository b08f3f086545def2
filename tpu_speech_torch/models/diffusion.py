"""Score-SDE (VP, linear beta schedule) forward and reverse dynamics.

The port's counterpart of ``tpu_speech/models/diffusion.py``: the
closed-form forward moments and the score-matching loss of training
(``forward_diffusion:25``, ``diffusion_loss:216``), the reverse Euler
integrator (the reference Diffusion.reverse_diffusion,
Grad-TTS/model/diffusion.py:254-275) and the DPM-Solver++(2M) sampler on
the same probability-flow ODE. Each sampler is a Python loop of
``n_timesteps`` network calls; no step reads the device from the host.
The training draws (``t``, ``z``) are arguments: a ``generator`` draws them
only when they are not given, so tests can replay the JAX package's draws.

``mask`` broadcasts against ``z``: (B, T, 1) for the JAX package's
(B, T, F) layout, (B, 1, T) for the reference's (B, F, T).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from tpu_speech_torch.parallel.mesh import global_rows


class Decoder(nn.Module):
    """The references' ``Diffusion`` module (Grad-TTS's and DiffVC's),
    reduced to what holds weights: its ``estimator``. The dynamics are
    functions."""

    def __init__(self, estimator: nn.Module):
        super().__init__()
        self.estimator = estimator


def get_noise(t, beta_init: float, beta_term: float, cumulative: bool = False):
    """beta(t) (linear) or its integral from 0 to t."""
    if cumulative:
        return beta_init * t + 0.5 * (beta_term - beta_init) * t**2
    return beta_init + (beta_term - beta_init) * t


def _step_scalars(i: int, n_timesteps: int, beta_min: float, beta_max: float,
                  dtype: torch.dtype):
    """(t, beta(t), h, sqrt(beta(t) h)) of Euler step ``i`` as Python floats,
    computed in ``dtype`` as the JAX scan computes them in z's dtype: every
    constant rounded to the dtype first (JAX's weak types) and every
    operation rounded (``diffusion.py:75-83``). In float32 this is the
    float32 arithmetic of numpy."""
    def r(x):  # a constant as it meets an array of the dtype
        return torch.tensor(x, dtype=dtype)

    h = r(1.0 / n_timesteps)
    t = r(1.0) - (r(float(i)) + r(0.5)) * h
    noise_t = r(beta_min) + r(beta_max - beta_min) * t
    return float(t), float(noise_t), float(h), float(torch.sqrt(noise_t * h))


def forward_diffusion(
    x0: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    t: torch.Tensor,
    beta_min: float,
    beta_max: float,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Sample x_t ~ N(mean(t), var(t)) given x_0 (closed-form OU moments).

    x0, mu and ``z`` (the standard-normal draw, from ``generator`` when not
    given) of one shape; mask broadcasts against them; t (B,). Returns
    (xt, z), both masked."""
    time = t[:, None, None]
    cum_noise = get_noise(time, beta_min, beta_max, cumulative=True)
    mean = x0 * torch.exp(-0.5 * cum_noise) + mu * (1.0 - torch.exp(-0.5 * cum_noise))
    variance = 1.0 - torch.exp(-cum_noise)
    if z is None:
        z = torch.randn(x0.shape, generator=generator, dtype=x0.dtype, device=x0.device)
    xt = mean + z * torch.sqrt(variance)
    return xt * mask, z * mask


def diffusion_loss(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    n_feats: int,
    beta_min: float,
    beta_max: float,
    offset: float = 1e-5,
    t: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    count: Optional[torch.Tensor] = None,
):
    """Score-matching loss at t ~ U[offset, 1 - offset] (the reference
    Diffusion.loss_t, diffusion.py:281-294). ``t`` (B,) and ``z`` (x0's
    shape) are drawn from ``generator`` in that order when not given, at the
    global batch's shape over N ranks (this rank's rows kept). The sum
    divides by (``count``, or sum(mask)) x n_feats. Returns (loss, xt)."""
    t, z = draw_t_z(x0, offset, t, z, generator)
    xt, z = forward_diffusion(x0, mask, mu, t, beta_min, beta_max, z=z)
    cum_noise = get_noise(t[:, None, None], beta_min, beta_max, cumulative=True)
    noise_estimation = score_fn(xt, t) * torch.sqrt(1.0 - torch.exp(-cum_noise))
    denom = torch.sum(mask) if count is None else count.to(mask.dtype)
    loss = torch.sum((noise_estimation + z) ** 2) / (denom * n_feats)
    return loss, xt


def draw_t_z(x0: torch.Tensor, offset: float, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
    """A diffusion loss's draws, those not given from ``generator`` in this
    order: t (B,) uniform clamped to [offset, 1 - offset], z standard normal
    of x0's shape; each at the global batch's shape over N ranks, this
    rank's rows kept (``parallel/mesh.py::global_rows``)."""
    n, rows = global_rows(x0.shape[0])
    if t is None:
        t = torch.rand(n, generator=generator, dtype=x0.dtype, device=x0.device)[rows]
        t = torch.clamp(t, offset, 1.0 - offset)
    if z is None:
        z = torch.randn((n, *x0.shape[1:]), generator=generator, dtype=x0.dtype,
                        device=x0.device)[rows]
    return t, z


def reverse_diffusion(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    n_timesteps: int,
    beta_min: float,
    beta_max: float,
    stoc: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """Integrate the reverse SDE/ODE from t=1 to 0 with n_timesteps Euler steps.

    ``score_fn(xt, t)`` evaluates the noise estimator (closure over the
    model, mask, mu, spk). ``stoc=True`` adds the per-step noise, drawn from
    ``generator`` on ``z``'s device.
    """
    b = z.shape[0]
    xt = z * mask
    for i in range(n_timesteps):
        t, noise_t, h, sd = _step_scalars(i, n_timesteps, beta_min, beta_max, z.dtype)
        t_vec = torch.full((b,), t, dtype=z.dtype, device=z.device)
        score = score_fn(xt, t_vec)
        if stoc:
            dxt_det = (0.5 * (mu - xt) - score) * noise_t * h
            noise = torch.randn(z.shape, generator=generator, dtype=z.dtype, device=z.device)
            dxt = dxt_det + noise * sd
        else:
            dxt = 0.5 * (mu - xt - score) * noise_t * h
        xt = (xt - dxt) * mask
    return xt


def _vp_gamma_np(t, beta_min: float, beta_max: float):
    """Integral of the linear beta schedule from 0 to t (numpy, host-side)."""
    return beta_min * t + 0.5 * (beta_max - beta_min) * t * t


def _vp_t_of_lambda_np(lam, beta_min: float, beta_max: float):
    """Invert lambda(t) = log(alpha_t / sigma_t) for the linear VP schedule:
    gamma = softplus(-2 lambda), and gamma(t) is quadratic in t."""
    gamma = np.logaddexp(0.0, -2.0 * lam)
    disc = beta_min * beta_min + 2.0 * (beta_max - beta_min) * gamma
    return (-beta_min + np.sqrt(disc)) / (beta_max - beta_min)


def _vp_lambda_np(t, beta_min: float, beta_max: float):
    g = _vp_gamma_np(t, beta_min, beta_max)
    a2 = np.exp(-g)
    return 0.5 * (np.log(a2) - np.log1p(-a2))


def dpm_solver_schedule(n_timesteps: int, beta_min: float, beta_max: float,
                        t_start: float = 1.0, t_end: float = 1e-3):
    """Uniform-in-lambda step grid for the VP probability-flow ODE: (ts,
    lambdas) float64 arrays of length n_timesteps+1 from t_start down to
    t_end (Lu et al. 2022)."""
    lam0 = _vp_lambda_np(np.asarray(t_start, np.float64), beta_min, beta_max)
    lam1 = _vp_lambda_np(np.asarray(t_end, np.float64), beta_min, beta_max)
    lams = np.linspace(lam0, lam1, n_timesteps + 1)
    ts = _vp_t_of_lambda_np(lams, beta_min, beta_max)
    return ts, lams


def _dpm_table(n_timesteps: int, beta_min: float, beta_max: float, order: int = 2,
               t_start: float = 1.0, t_end: float = 1e-3) -> np.ndarray:
    """The (n_timesteps, 7) table of per-step coefficients in float64: the
    network's time, sigma^2, 1/alpha, the sigma ratio, the weight on D, and
    the multistep weights on the current and previous x0 estimates."""
    assert order in (1, 2), order
    n = n_timesteps
    ts, lams = dpm_solver_schedule(n, beta_min, beta_max, t_start, t_end)
    h = lams[1:] - lams[:-1]
    gam = _vp_gamma_np(ts, beta_min, beta_max)
    alpha = np.exp(-0.5 * gam)
    sigma = np.sqrt(-np.expm1(-gam))
    r = np.ones(n)
    r[1:] = h[:-1] / h[1:]
    w_cur = 1.0 + 1.0 / (2.0 * r)
    w_prev = -1.0 / (2.0 * r)
    if order == 1:
        w_cur, w_prev = np.ones(n), np.zeros(n)
    else:
        w_cur[0], w_prev[0] = 1.0, 0.0
    return np.stack([ts[:-1], sigma[:-1] ** 2, 1.0 / alpha[:-1], sigma[1:] / sigma[:-1],
                     -alpha[1:] * np.expm1(-h), w_cur, w_prev], axis=1)


def dpm_coefficients(n_timesteps: int, beta_min: float, beta_max: float, order: int = 2,
                     t_start: float = 1.0, t_end: float = 1e-3) -> np.ndarray:
    """``_dpm_table`` cast to float32, as ``diffusion.py:166-197`` does."""
    return _dpm_table(n_timesteps, beta_min, beta_max, order, t_start,
                      t_end).astype(np.float32)


def reverse_diffusion_dpm(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    mask: torch.Tensor,
    mu: torch.Tensor,
    n_timesteps: int,
    beta_min: float,
    beta_max: float,
    order: int = 2,
    t_start: float = 1.0,
    t_end: float = 1e-3,
):
    """DPM-Solver++(2M) exponential integrator for the probability-flow ODE
    that ``reverse_diffusion(stoc=False)`` integrates with Euler steps: one
    network call per step, in the data-prediction parameterisation on
    y = x - mu, with a 2nd-order multistep correction (order=1 is DDIM).
    Deterministic. The coefficients are rounded once from float64 to z's
    dtype, as JAX's table is (float32, or bf16 under bf16 serving)."""
    coeffs = _dpm_table(n_timesteps, beta_min, beta_max, order, t_start, t_end)
    b = z.shape[0]
    y = (z - mu) * mask
    prev_x0 = torch.zeros_like(y)
    # z's dtype's values as Python floats
    for c in torch.from_numpy(coeffs).to(z.dtype).double().tolist():
        t_vec = torch.full((b,), c[0], dtype=z.dtype, device=z.device)
        score = score_fn((y + mu) * mask, t_vec)
        x0 = (y + c[1] * score) * c[2]
        d = c[5] * x0 + c[6] * prev_x0
        y = (c[3] * y + c[4] * d) * mask
        prev_x0 = x0
    return (y + mu) * mask
