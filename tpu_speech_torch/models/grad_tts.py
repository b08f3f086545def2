"""Grad-TTS: score-based diffusion text-to-speech.

The port's counterpart of ``tpu_speech/models/grad_tts.py``: ``GradTTS`` with
``encode``, ``score`` and the training ``forward`` (the JAX ``__call__:97``:
MAS, the crop, the three losses), and ``synthesize`` with the JAX package's
signature and outputs. The module tree is the reference's
(Grad-TTS/model/tts.py: ``spk_emb``, ``encoder``, ``decoder.estimator``), so
a reference ``state_dict`` loads with ``load_state_dict(strict=True)``.

Public functions keep the JAX package's (B, T, F) layout; inside, the
sampler runs the estimator in the reference's (B, F, T).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tpu_speech_torch.models.diffusion import (
    Decoder,
    diffusion_loss,
    reverse_diffusion,
    reverse_diffusion_dpm,
)
from tpu_speech_torch.models.text_encoder import TextEncoder
from tpu_speech_torch.nn.init import seeded_init_
from tpu_speech_torch.nn.unet import GradLogPEstimator2d
from tpu_speech_torch.ops.masks import duration_loss, generate_path, sequence_mask
from tpu_speech_torch.ops.monotonic_align import maximum_path
from tpu_speech_torch.parallel.mesh import global_counts, global_rows


class GradTTS(nn.Module):
    def __init__(self, n_vocab: int, n_spks: int = 1, spk_emb_dim: int = 64,
                 n_enc_channels: int = 192, filter_channels: int = 768,
                 filter_channels_dp: int = 256, n_heads: int = 2, n_enc_layers: int = 6,
                 enc_kernel: int = 3, enc_dropout: float = 0.1, window_size: int = 4,
                 n_feats: int = 80, dec_dim: int = 64, beta_min: float = 0.05,
                 beta_max: float = 20.0, pe_scale: float = 1000.0):
        super().__init__()
        self.n_spks, self.n_feats = n_spks, n_feats
        self.beta_min, self.beta_max = beta_min, beta_max
        if n_spks > 1:
            self.spk_emb = nn.Embedding(n_spks, spk_emb_dim)
        # as in the reference (tts.py:45-47), the encoder gets no speaker:
        # speaker conditioning reaches the decoder only
        self.encoder = TextEncoder(n_vocab, n_feats, n_enc_channels, filter_channels,
                                   filter_channels_dp, n_heads, n_enc_layers, enc_kernel,
                                   enc_dropout, window_size)
        self.decoder = Decoder(GradLogPEstimator2d(dec_dim, n_spks=n_spks,
                                                   spk_emb_dim=spk_emb_dim, n_feats=n_feats,
                                                   pe_scale=pe_scale))

    def _spk_vec(self, spk):
        return self.spk_emb(spk) if self.n_spks > 1 else None

    def encode(self, x, x_lengths, spk=None):
        """Text ids (B, Tx) -> mu_x (B, Tx, F), logw (B, Tx), x_mask (B, Tx)."""
        mu, logw, x_mask = self.encoder(x, x_lengths)
        return mu.transpose(1, 2), logw[:, 0], x_mask[:, 0]

    def score(self, xt, mask, mu, t, spk=None):
        """One network call of the sampler: xt, mu (B, T, F), mask (B, T),
        t (B,) -> (B, T, F)."""
        out = self.decoder.estimator(xt.transpose(1, 2), mask[:, None, :].to(xt.dtype),
                                     mu.transpose(1, 2), t, self._spk_vec(spk))
        return out.transpose(1, 2)

    @torch.no_grad()
    def alignment(self, mu_x, y, attn_mask):
        """MAS on the Gaussian log-prior: mu_x (B, Tx, F), y (B, Ty, F),
        attn_mask (B, Tx, Ty) -> the (B, Tx, Ty) 0/1 path, outside autograd.
        log N(y_t; mu_x, I) = -|y|^2 / 2 + <mu, y> - |mu|^2 / 2 + const is one
        batched product, summed in the JAX package's order."""
        const = -0.5 * math.log(2 * math.pi) * self.n_feats
        y_sq = -0.5 * torch.sum(y ** 2, dim=-1)  # (B, Ty)
        mu_sq = -0.5 * torch.sum(mu_x ** 2, dim=-1)  # (B, Tx)
        cross = torch.matmul(mu_x, y.transpose(1, 2))  # (B, Tx, Ty)
        log_prior = y_sq[:, None, :] + cross + mu_sq[:, :, None] + const
        return maximum_path(log_prior, attn_mask)

    def forward(self, x, x_lengths, y, y_lengths, spk=None, out_size: Optional[int] = None,
                generator: Optional[torch.Generator] = None, offsets=None, t=None, z=None,
                attn=None):
        """Training loss: x (B, Tx) ids, y (B, Ty, F) mels with their
        lengths -> (dur_loss, prior_loss, diff_loss), 0-d tensors.

        The crop applies when ``out_size < Ty``: offsets in [0, max(y_len -
        out_size, 1)), y and the path cut by a gather on the device, the cut
        lengths min(y_len, out_size). The draws are arguments, drawn from
        ``generator`` (on the batch's device) in this order when not given:
        ``offsets`` (B,) of the crop, ``t`` (B,) in [1e-5, 1 - 1e-5] and
        ``z`` (B, T, F) of the diffusion loss. ``attn``, the (B, Tx, Ty) MAS
        path, replaces the search (to hold two devices to one path).

        Over N ranks (the rows of the global batch) the draws are made at
        the global batch's shape and the three losses divide by the global
        counts (one all-reduce): the ranks' losses add up to the global
        loss."""
        spk_e = self._spk_vec(spk)
        crop = out_size is not None and out_size < y.shape[1]
        counts = global_counts(torch.sum(x_lengths),
                               torch.sum(torch.clamp(y_lengths, max=out_size) if crop
                                         else y_lengths))
        mu_x, logw, x_mask = self.encode(x, x_lengths)
        y_mask = sequence_mask(y_lengths, y.shape[1]).to(mu_x.dtype)
        if attn is None:
            attn = self.alignment(mu_x, y, x_mask[:, :, None] * y_mask[:, None, :])

        logw_gt = torch.log(1e-8 + torch.sum(attn, dim=-1)) * x_mask
        dur_loss = duration_loss(logw * x_mask, logw_gt, x_lengths,
                                 None if counts is None else counts[0].to(logw.dtype))

        if crop:
            if offsets is None:
                high = torch.clamp(y_lengths - out_size, min=1)
                n, rows = global_rows(y.shape[0])
                u = torch.rand(n, generator=generator, device=y.device)[rows]
                offsets = torch.minimum((u * high).long(), high - 1)
            idx = offsets.long()[:, None] + torch.arange(out_size, device=y.device)  # (B, out)
            y = torch.gather(y, 1, idx[:, :, None].expand(-1, -1, y.shape[2]))
            attn = torch.gather(attn, 2, idx[:, None, :].expand(-1, attn.shape[1], -1))
            y_mask = sequence_mask(torch.clamp(y_lengths, max=out_size), out_size).to(y_mask.dtype)

        mu_y = torch.matmul(attn.transpose(1, 2), mu_x)  # (B, T, F)
        # the diffusion loss in the estimator's (B, F, T) layout
        mask, mu_cf = y_mask[:, None, :], mu_y.transpose(1, 2)
        estimator = self.decoder.estimator
        diff_loss, _ = diffusion_loss(
            lambda xt, tt: estimator(xt, mask, mu_cf, tt, spk_e), y.transpose(1, 2), mask,
            mu_cf, self.n_feats, self.beta_min, self.beta_max, t=t,
            z=None if z is None else z.transpose(1, 2), generator=generator,
            count=None if counts is None else counts[1])

        prior_loss = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * y_mask[:, :, None])
        frames = torch.sum(y_mask) if counts is None else counts[1].to(y_mask.dtype)
        prior_loss = prior_loss / (frames * self.n_feats)
        return dur_loss, prior_loss, diff_loss

    def init_weights(self, generator: torch.Generator) -> "GradTTS":
        """Seeded random weights (``nn/init.py::seeded_init_``)."""
        return seeded_init_(self, generator)


def durations(logw: torch.Tensor, x_mask: torch.Tensor, length_scale: float = 1.0):
    """Per-token mel frames, fractional: ceil(exp(logw)) in logw's dtype
    (``ceil`` comes first, ``grad_tts.py:191-192``), times length_scale in
    float32, widened to float64 so that their sums are exact. At
    length_scale 0.91 the exact sum comes within 1e-5 of an integer frame
    wherever the ceilings add up to a multiple of 100; a float32 sum's
    rounding there, which differs between the CPU and the card and between
    ``sum`` and ``cumsum``, would decide whether that frame is in. The JAX
    package sums in float32, and under bf16 serving scales and sums in bf16,
    where the path's cumsum rounds every boundary past 256 frames to an
    even frame (ROADMAP Queue 3); the ceilings, integers, are exact in bf16,
    so here the scale and the sums are float32's whatever logw's dtype."""
    return (torch.ceil(torch.exp(logw) * x_mask).float() * length_scale).double()


def duration_path(logw: torch.Tensor, x_mask: torch.Tensor, length_scale: float,
                  y_max_length: int):
    """The int32 lengths (B,), clipped to [1, y_max_length] and truncated as
    ``grad_tts.py:193`` does, the mel mask (B, y_max_length) and the
    monotone alignment (B, Tx, y_max_length), in x_mask's dtype."""
    w_ceil = durations(logw, x_mask, length_scale)
    y_lengths = torch.clamp(torch.sum(w_ceil, dim=1), 1, y_max_length).int()
    y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)
    attn = generate_path(w_ceil, x_mask[:, :, None] * y_mask[:, None, :])
    return y_lengths, y_mask, attn


def synthesize_from_encoding(
    model: GradTTS,
    mu_x: torch.Tensor,
    logw: torch.Tensor,
    x_mask: torch.Tensor,
    n_timesteps: int,
    y_max_length: int,
    temperature: float = 1.0,
    stoc: bool = False,
    spk: Optional[torch.Tensor] = None,
    length_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    solver: str = "euler",
    solver_order: int = 2,
    noise: Optional[torch.Tensor] = None,
    path: Optional[tuple] = None,
):
    """``synthesize`` after ``model.encode``: the duration path, the prior
    mu_y and the sampler. No step reads the device from the host. ``path``,
    a pair (y_lengths (B,), attn (B, Tx, y_max_length)), replaces the
    duration path (to replay another run's)."""
    if path is None:
        y_lengths, y_mask, attn = duration_path(logw, x_mask, length_scale, y_max_length)
    else:
        y_lengths, attn = path
        y_mask = sequence_mask(y_lengths, y_max_length).to(x_mask.dtype)
        attn = attn.to(x_mask.dtype)
    mu_y = torch.matmul(attn.transpose(1, 2), mu_x)  # (B, Ty, F)

    if noise is None:
        noise = torch.randn(mu_y.shape, generator=generator, dtype=mu_y.dtype,
                            device=mu_y.device)
    mu_cf = mu_y.transpose(1, 2)  # the estimator's (B, F, T)
    z = mu_cf + noise.transpose(1, 2) / temperature
    mask = y_mask[:, None, :]
    spk_vec = model._spk_vec(spk)
    estimator = model.decoder.estimator

    def score_fn(xt, t):
        return estimator(xt, mask, mu_cf, t, spk_vec)

    if solver == "dpm":
        if stoc:
            raise ValueError("solver='dpm' is deterministic; stoc must be False")
        dec = reverse_diffusion_dpm(score_fn, z, mask, mu_cf, n_timesteps, model.beta_min,
                                    model.beta_max, order=solver_order)
    elif solver == "euler":
        dec = reverse_diffusion(score_fn, z, mask, mu_cf, n_timesteps, model.beta_min,
                                model.beta_max, stoc=stoc, generator=generator)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return mu_y, dec.transpose(1, 2), attn, y_lengths


def synthesize(
    model: GradTTS,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    n_timesteps: int,
    y_max_length: int,
    temperature: float = 1.0,
    stoc: bool = False,
    spk: Optional[torch.Tensor] = None,
    length_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    solver: str = "euler",
    solver_order: int = 2,
    noise: Optional[torch.Tensor] = None,
    path: Optional[tuple] = None,
):
    """Text -> mel (inference) with a fixed ``y_max_length`` (a multiple of 4).

    Returns (encoder_outputs mu_y, decoder_outputs, attn, y_lengths):
    mu_y and the decoder outputs are (B, y_max_length, F) with frames beyond
    y_lengths zero; y_lengths is clipped to [1, y_max_length], as the JAX
    package's is. ``noise`` is the standard-normal draw for z = mu_y +
    noise / temperature, of mu_y's shape; without it the draw comes from
    ``generator`` (as do the per-step draws of ``stoc=True``). ``path``
    replaces the duration path (``synthesize_from_encoding``). On a model
    whose parameters are bf16 (``utils/precision.py::cast_params_bf16``,
    JAX's bf16 serving) every stage computes in bf16 as JAX's does, the
    duration path aside (``durations``).
    solver='euler' is the reference integrator; solver='dpm' is
    DPM-Solver++(2M) on the same probability-flow ODE (solver_order=1: DDIM).
    """
    mu_x, logw, x_mask = model.encode(x, x_lengths, spk)
    return synthesize_from_encoding(
        model, mu_x, logw, x_mask, n_timesteps, y_max_length, temperature=temperature,
        stoc=stoc, spk=spk, length_scale=length_scale, generator=generator, solver=solver,
        solver_order=solver_order, noise=noise, path=path)
