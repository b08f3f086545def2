"""Gumbel-softmax vector quantizer: wav2vec 2.0's target codebook.

Port of ``tpu_speech/models/spiral/quantizer.py::GumbelVectorQuantizer:14``
(the reference's wav2vec_modules.py:41-205). Parameters under the reference
names: ``vars`` (1, groups * num_vars, vq_dim / groups), the codebook, and
``weight_proj``, the linear map to the code logits.

Training draws Gumbel noise, takes the hard one-hot of the noisy softmax's
argmax and passes the gradient straight through the soft one
(``y_hard + y_soft - y_soft.detach()``); eval mode takes the argmax of the
logits. The noise is an argument (``gumbel``, (B*T, groups, num_vars)),
which the parity tests fill with JAX's draw, or comes from an explicit
``torch.Generator``. The perplexity statistics are weighted by an optional
(B, T) 0/1 frame weight: every frame is quantized at a fixed shape and the
statistics are masked, where the reference gathers a subset of frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gumbel_noise(shape, generator: Optional[torch.Generator], device=None) -> torch.Tensor:
    """-log(-log(U)), U uniform in (0, 1), float32."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))


class GumbelVectorQuantizer(nn.Module):
    def __init__(self, dim: int, num_vars: int, groups: int, vq_dim: int,
                 combine_groups: bool = False,
                 temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995), device=None):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"vq_dim {vq_dim} must divide by groups {groups}")
        self.num_vars, self.groups, self.vq_dim = num_vars, groups, vq_dim
        self.combine_groups, self.temp = combine_groups, temp
        num_groups = 1 if combine_groups else groups
        self.vars = nn.Parameter(torch.empty(1, num_groups * num_vars, vq_dim // groups,
                                             device=device))
        self.weight_proj = nn.Linear(dim, groups * num_vars, device=device)
        nn.init.uniform_(self.vars)

    def current_temp(self, num_updates: int) -> float:
        max_t, min_t, decay = self.temp
        return max(max_t * decay ** num_updates, min_t)

    def forward(self, x, num_updates: int, weight=None, gumbel=None,
                generator: Optional[torch.Generator] = None):
        """x (B, T, dim) -> (quantized (B, T, vq_dim), prob_ppl_loss, cur_temp,
        prob_ppl); ``weight`` (B, T) 0/1 frames of the perplexity statistics."""
        b, t, _ = x.shape
        logits = self.weight_proj(x).reshape(b * t, self.groups, self.num_vars)
        cur_temp = self.current_temp(num_updates)
        probs = torch.softmax(logits.float(), dim=-1)
        if weight is None:
            avg_probs = probs.mean(dim=0)
        else:
            w = weight.reshape(b * t, 1, 1).float()
            avg_probs = (probs * w).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
        prob_ppl = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7)).sum(dim=-1)).sum()
        total = self.num_vars * self.groups
        prob_ppl_loss = (total - prob_ppl) / total
        if self.training:
            if gumbel is None:
                gumbel = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits.float() + gumbel) / cur_temp, dim=-1)
            y_hard = F.one_hot(y_soft.argmax(dim=-1), self.num_vars).to(y_soft.dtype)
            # straight through: the value is y_hard exactly, the gradient
            # that of y_soft. JAX's y_hard + y_soft - y_soft keeps a rounding
            # residue that hides some duplicate negatives; the exact value is
            # a difference kept by choice (ROADMAP Queue 3)
            onehot = y_hard + (y_soft - y_soft.detach())
        else:
            onehot = F.one_hot(logits.argmax(dim=-1), self.num_vars).to(x.dtype)
        cb = self.vars
        if self.combine_groups:
            cb = cb.repeat(1, self.groups, 1)
        cb = cb.reshape(self.groups, self.num_vars, -1).to(onehot.dtype)
        quantized = torch.einsum("ngv,gvd->ngd", onehot, cb).reshape(b, t, self.vq_dim)
        return quantized, prob_ppl_loss, cur_temp, prob_ppl
