"""Conformer-CTC ASR encoder and model.

Port of ``tpu_speech/models/spiral/conformer.py`` (``ConformerConfig:29``,
``_FeedForward:50``, ``_ConvModule:65``, ``ConformerBlock:89``,
``ConformerEncoder:112``, ``ConformerCTCModel:149``): conv 2-D subsampling
(two 3x3 stride-2 convs), then blocks of [half FF -> rel-pos MHA -> conv
module -> half FF -> LayerNorm], and a ``ConvASRDecoder`` CTC head (the
vocab projection alone). Channels-last (B, T, C) between modules.

As flax computes it:

- LayerNorm eps 1e-6 (flax's default, not torch's 1e-5); the conv module's
  BatchNorm eps 1e-5, flax's momentum 0.99 (torch's 0.01), statistics over
  every frame (``FlaxBatchNorm1d``);
- the subsampling convs pad "SAME": at stride 2 the pad is asymmetric,
  (0, 1) on an even size and (1, 1) on an odd one, applied with ``F.pad``;
- ``proj`` flattens (B, T, F, C) frequency-major, so the (B, C, T, F) conv
  output is permuted first; out_lens is (l + 1) // 2 twice;
- the padded tail is zeroed before subsampling, after ``proj``, after the
  conv module's GLU (``a * sigmoid(b)``, ``a`` the first half) and at each
  block's end; the depthwise conv (k ``conv_kernel``, "SAME",
  ``groups=d_model``) and the subsampling convs have biases.

Parameter names: ``encoder.subsample.{0,1}``, ``encoder.proj``,
``encoder.layers.{i}.{ff1,ff2}.{norm,linear1,linear2}``,
``.norm_self_att``, ``.self_attn.*``, ``.conv.{norm,pointwise_conv1,
depthwise_conv,batch_norm,pointwise_conv2}``, ``.norm_out``, and
``decoder.decoder_layers.0``; ``compat/jax_ctc_models.py`` maps them to the
flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_speech_torch.models.spiral.conv_layers import FlaxBatchNorm1d
from tpu_speech_torch.models.spiral.ctc import ConvASRDecoder
from tpu_speech_torch.models.spiral.ctc_models import blank_index, featurize
from tpu_speech_torch.models.spiral.dropout import DropoutRng, dropout
from tpu_speech_torch.models.spiral.st2vec import init_weights_
from tpu_speech_torch.nn.conformer_attention import (
    RelPositionMultiHeadAttention,
    rel_positional_table,
)
from tpu_speech_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    num_classes: int
    d_model: int = 176          # 'small' preset dims
    n_heads: int = 4
    n_layers: int = 16
    ff_expansion: int = 4
    conv_kernel: int = 31
    dropout: float = 0.1
    subsampling_filters: int = 176
    sample_rate: int = 16000
    n_mels: int = 80
    window_size: float = 0.025
    window_stride: float = 0.01
    blank_pos: str = "after_vocab_last"
    dither: float = 1e-5


def _len_mask(lens, t, dtype):
    return (torch.arange(t, device=lens.device)[None, :] < lens[:, None]).to(dtype)


def same_pads(size: int, kernel: int, stride: int):
    """flax "SAME" padding of one dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _FeedForward(nn.Module):
    def __init__(self, d_model: int, expansion: int, dropout_rate: float, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.linear1 = nn.Linear(d_model, d_model * expansion, device=device)
        self.linear2 = nn.Linear(d_model * expansion, d_model, device=device)
        self.dropout_rate = dropout_rate

    def forward(self, x, rng=None):
        h = dropout(F.silu(self.linear1(self.norm(x))), self.dropout_rate, self.training, rng)
        return dropout(self.linear2(h), self.dropout_rate, self.training, rng)


class _ConvModule(nn.Module):
    """Pointwise -> GLU -> depthwise -> BatchNorm -> swish -> pointwise."""

    def __init__(self, d_model: int, kernel: int, dropout_rate: float, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.pointwise_conv1 = nn.Linear(d_model, 2 * d_model, device=device)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel, groups=d_model,
                                        device=device)
        self.batch_norm = FlaxBatchNorm1d(d_model, eps=1e-5, momentum=0.01, device=device)
        self.pointwise_conv2 = nn.Linear(d_model, d_model, device=device)
        self.pads = ((kernel - 1) // 2, kernel // 2)  # flax "SAME" at stride 1
        self.dropout_rate = dropout_rate

    def forward(self, x, pad_mask, rng=None):
        a, b = self.pointwise_conv1(self.norm(x)).chunk(2, dim=-1)
        h = a * torch.sigmoid(b) * pad_mask[:, :, None]  # no pad leakage into the depthwise rf
        h = self.depthwise_conv(F.pad(h.transpose(1, 2), self.pads))
        h = F.silu(self.batch_norm(h)).transpose(1, 2)
        return dropout(self.pointwise_conv2(h), self.dropout_rate, self.training, rng)


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        c = cfg
        self.dropout_rate = c.dropout
        self.ff1 = _FeedForward(c.d_model, c.ff_expansion, c.dropout, device)
        self.norm_self_att = nn.LayerNorm(c.d_model, eps=LN_EPS, device=device)
        self.self_attn = RelPositionMultiHeadAttention(c.n_heads, c.d_model, c.dropout, device)
        self.conv = _ConvModule(c.d_model, c.conv_kernel, c.dropout, device)
        self.ff2 = _FeedForward(c.d_model, c.ff_expansion, c.dropout, device)
        self.norm_out = nn.LayerNorm(c.d_model, eps=LN_EPS, device=device)

    def forward(self, x, pad_mask, attn_mask, pos_emb, rng=None):
        x = x + 0.5 * self.ff1(x, rng)
        h = self.norm_self_att(x)
        h = self.self_attn(h, h, h, mask=attn_mask, pos_emb=pos_emb, rng=rng)
        x = x + dropout(h, self.dropout_rate, self.training, rng)
        x = x + self.conv(x, pad_mask, rng)
        x = x + 0.5 * self.ff2(x, rng)
        return self.norm_out(x) * pad_mask[:, :, None]


class ConformerEncoder(nn.Module):
    """(B, T, n_mels) specs -> (B, ceil(ceil(T/2)/2), d_model) features."""

    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        self.subsample = nn.ModuleList([
            nn.Conv2d(1, c.subsampling_filters, 3, stride=2, device=device),
            nn.Conv2d(c.subsampling_filters, c.subsampling_filters, 3, stride=2, device=device),
        ])
        f = c.n_mels
        for _ in range(2):
            f = -(-f // 2)
        self.proj = nn.Linear(f * c.subsampling_filters, c.d_model, device=device)
        self.layers = nn.ModuleList([ConformerBlock(c, device) for _ in range(c.n_layers)])

    def forward(self, specs, spec_lens, rng: Optional[DropoutRng] = None):
        c = self.cfg
        # zero the padded tail BEFORE subsampling: "SAME" padding makes the
        # stride-2 windows right-leaning, so the last valid output frame reads
        # a few padded input frames, which must be zeros
        in_mask = _len_mask(spec_lens, specs.shape[1], specs.dtype)
        x = (specs * in_mask[:, :, None])[:, None]  # (B, 1, T, F)
        for conv in self.subsample:
            pt, pf = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
            x = F.relu(conv(F.pad(x, pf + pt)))
        b, ch, t, f = x.shape
        x = self.proj(x.permute(0, 2, 3, 1).reshape(b, t, f * ch))
        out_lens = spec_lens
        for _ in range(2):
            out_lens = (out_lens + 1) // 2  # ceil-div per stride-2 stage
        pad_mask = _len_mask(out_lens, t, x.dtype)
        attn_mask = (pad_mask[:, None, :] == 0).expand(b, t, t)  # True = masked key
        pos_emb = rel_positional_table(t, c.d_model, x.device).to(x.dtype)
        x = x * pad_mask[:, :, None]
        for layer in self.layers:
            x = layer(x, pad_mask, attn_mask, pos_emb, rng)
        return x, out_lens


class ConformerCTCModel(nn.Module):
    """specs -> Conformer encoder -> 1x1 CTC head: the EncDecCTCModel
    interface (``featurize``, ``forward``, ``blank_idx``), so
    ``ctc_models.make_ctc_train_step`` trains it. Built on
    ``resolve_device(device)``: the card unless told otherwise."""

    def __init__(self, cfg: ConformerConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg, device)
        self.decoder = ConvASRDecoder(cfg.d_model, cfg.num_classes, conv_layers=(),
                                      blank_pos=cfg.blank_pos, device=device)

    @property
    def blank_idx(self) -> int:
        return blank_index(self.cfg.num_classes, self.cfg.blank_pos)

    def featurize(self, wavs, wav_lens, train: bool = False,
                  generator: Optional[torch.Generator] = None):
        return featurize(self.cfg, wavs, wav_lens, train, generator)

    def forward(self, specs, spec_lens, rng: Optional[DropoutRng] = None):
        feats, feat_lens = self.encoder(specs, spec_lens, rng)
        return self.decoder(feats, feat_lens, rng)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ConformerCTCModel":
        """Seeded random init at the JAX package's scales: the subsampling
        convs kaiming-normal, the depthwise convs and the linears
        lecun-normal (``st2vec.init_weights_``), zero biases, unit norms,
        zero u/v biases. The draws run on the CPU generator wherever the
        model lies."""
        device = next(self.parameters()).device
        self.cpu()
        for conv in self.encoder.subsample:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator)
                              * (2.0 / conv.weight[0].numel()) ** 0.5)
            conv.bias.zero_()
        for layer in self.encoder.layers:
            layer.self_attn.pos_bias_u.zero_()
            layer.self_attn.pos_bias_v.zero_()
        unit = [layer.conv.depthwise_conv for layer in self.encoder.layers]
        init_weights_(self, generator, unit_gain=(self.decoder.decoder_layers[0], *unit))
        return self.to(device)
