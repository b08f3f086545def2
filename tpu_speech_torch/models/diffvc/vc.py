"""DiffVC: the average-voice encoder and the speaker-conditional diffusion
decoder, the decoder's training loss, and any-to-any conversion.

The port's counterpart of ``tpu_speech/models/diffvc/vc.py:27-118`` (the
reference DiffVC/model/vc.py:53-144). The module tree is the reference's
(``encoder``, ``decoder.estimator``), so a reference ``state_dict`` loads
with ``load_state_dict(strict=True)``. The public functions take and return
the JAX package's (B, T, F); inside, activations are channels-first (B, F,
T) and (B, C, F, T), cuDNN's layout.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from tpu_speech_torch.models.diffusion import Decoder
from tpu_speech_torch.models.diffvc.diffusion import (
    compute_diffused_mean,
    diffusion_loss,
    reverse_diffusion,
)
from tpu_speech_torch.models.diffvc.encoder import FwdDiffusion
from tpu_speech_torch.models.diffvc.unet import GradLogPEstimatorVC
from tpu_speech_torch.nn.init import seeded_init_
from tpu_speech_torch.ops.masks import sequence_mask
from tpu_speech_torch.parallel.mesh import global_counts


@contextlib.contextmanager
def frozen(module: nn.Module):
    """Within: ``module`` in eval mode (its dropout off) and no autograd;
    after: its mode as before."""
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        module.train(was_training)


class DiffVC(nn.Module):
    def __init__(self, n_feats: int = 80, channels: int = 192, filters: int = 768,
                 heads: int = 2, layers: int = 6, kernel: int = 3, dropout: float = 0.1,
                 window_size: int = 4, enc_dim: int = 128, spk_dim: int = 128,
                 use_ref_t: bool = True, dec_dim: int = 256, beta_min: float = 0.05,
                 beta_max: float = 20.0):
        super().__init__()
        self.n_feats, self.beta_min, self.beta_max = n_feats, beta_min, beta_max
        self.encoder = FwdDiffusion(n_feats, channels, filters, heads, layers, kernel, dropout,
                                    window_size, enc_dim)
        self.decoder = Decoder(GradLogPEstimatorVC(dec_dim, spk_dim, use_ref_t))

    def encode(self, x, x_mask):
        """The average-voice mean: x (B, T, F), x_mask (B, T) -> (B, T, F)."""
        mean = self.encoder(x.transpose(1, 2), x_mask[:, None, :].to(x.dtype))
        return mean.transpose(1, 2)

    def score(self, xt, x_mask, mean, xt_ref, ref_mask, c, t):
        """One network call of the sampler: xt, mean (B, T, F), x_mask (B,
        T), xt_ref (B, Tr, F), ref_mask (B, Tr), c (B, 256), t (B,) -> (B,
        T, F)."""
        out = self.decoder.estimator(
            xt.transpose(1, 2), x_mask[:, None, :].to(xt.dtype), mean.transpose(1, 2),
            xt_ref.transpose(1, 2), ref_mask[:, None, :].to(xt.dtype), c, t)
        return out.transpose(1, 2)

    def forward(self, x, x_lengths, x_ref, c, t: Optional[torch.Tensor] = None,
                z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The decoder's score-matching loss (``tpu_speech/models/diffvc/vc.py:61``):
        x and x_ref (B, T, F) two crops of one utterance, x_lengths (B,), c
        (B, 256) its speaker embedding. Both means come from the encoder
        with its dropout off and without gradient, whatever this module's
        mode; the reference is encoded and diffused under the source's mask.
        ``t`` (B,) and ``z`` (B, T, F) replace the draws of ``generator``.
        Over N ranks the draws are made at the global batch's shape and the
        loss divides by the global frame count."""
        x_mask = sequence_mask(x_lengths, x.shape[1]).to(x.dtype)[:, None, :]  # (B, 1, T)
        counts = global_counts(torch.sum(x_lengths))
        xc, refc = x.transpose(1, 2), x_ref.transpose(1, 2)
        with frozen(self.encoder):
            mean = self.encoder(xc, x_mask)
            mean_ref = self.encoder(refc, x_mask)
        estimator = self.decoder.estimator

        def score_fn(xt, xt_ref, t):
            return estimator(xt, x_mask, mean, xt_ref, x_mask, c, t)

        return diffusion_loss(score_fn, xc, x_mask, mean, refc, mean_ref, self.n_feats,
                              self.beta_min, self.beta_max, t=t,
                              z=None if z is None else z.transpose(1, 2), generator=generator,
                              count=None if counts is None else counts[0])

    def init_weights(self, generator: torch.Generator) -> "DiffVC":
        """Seeded random weights (``nn/init.py::seeded_init_``)."""
        return seeded_init_(self, generator)


def voice_convert(
    model: DiffVC,
    x: torch.Tensor,
    x_lengths: torch.Tensor,
    x_ref: torch.Tensor,
    x_ref_lengths: torch.Tensor,
    c: torch.Tensor,
    n_timesteps: int,
    mode: str = "ml",
    z_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Any-to-any conversion: x (B, T, F) the source mel padded to a multiple
    of 4 with its lengths, x_ref (B, Tr, F) the target's mel with its
    lengths, c (B, 256) the target's speaker embedding. Returns (mean_x,
    converted mel), both (B, T, F), zero beyond x_lengths.

    z = mean_x + ``z_noise`` (B, T, F); the 'em'/'ml' steps add
    ``step_noise`` (n_timesteps, B, T, F). Draws not given come from
    ``generator`` on x's device, z's first (the JAX package draws z from
    ``rng`` and the steps from ``fold_in(rng, 1)``, ``vc.py:105-117``)."""
    x_mask = sequence_mask(x_lengths, x.shape[1]).to(x.dtype)[:, None, :]  # (B, 1, T)
    ref_mask = sequence_mask(x_ref_lengths, x_ref.shape[1]).to(x.dtype)[:, None, :]
    xc, refc = x.transpose(1, 2).contiguous(), x_ref.transpose(1, 2).contiguous()
    mean = model.encoder(xc, x_mask)  # (B, F, T)
    mean_x = compute_diffused_mean(xc, x_mask, mean, 1.0, model.beta_min, model.beta_max)
    mean_ref = model.encoder(refc, ref_mask)
    if z_noise is None:
        z_noise = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    z = mean_x + z_noise.transpose(1, 2)
    estimator = model.decoder.estimator

    def score_fn(xt, xt_ref, t):
        return estimator(xt, x_mask, mean, xt_ref, ref_mask, c, t)

    y = reverse_diffusion(
        score_fn, z, x_mask, mean, refc, ref_mask, mean_ref, n_timesteps, model.beta_min,
        model.beta_max, mode=mode,
        step_noise=None if step_noise is None else step_noise.transpose(2, 3),
        generator=generator)
    return mean_x.transpose(1, 2), y.transpose(1, 2)
