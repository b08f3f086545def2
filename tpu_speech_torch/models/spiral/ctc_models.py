"""Jasper/QuartzNet-style end-to-end CTC ASR model (NeMo's EncDecCTCModel /
EncDecCTCModelBPE) and its train step.

Port of ``tpu_speech/models/spiral/ctc_models.py`` (``quartznet5x3_blocks:28``,
``EncDecCTCConfig:44``, ``EncDecCTCModel:56``, ``make_ctc_bpe_model:96``,
``decode_ctc_bpe:111``, ``init_ctc_state:125``, ``make_ctc_train_step:137``):
wav -> ``featurize`` (the mel featurizer, K1 on the card) -> ``ConvASREncoder``
(Jasper blocks) -> ``ConvASRDecoder`` (one 1x1 relu conv at
``decoder_filters``, then the vocab projection with the blank appended last)
-> log-probs -> CTC.

The train step serves any model with this forward signature and a
``blank_idx`` (``ConformerCTCModel`` too): the forward in training mode
(dropout from a ``DropoutRng``, BatchNorm statistics moved as flax's
``batch_stats`` are), ``ctc.py::ctc_loss``, the optional global-norm clip
(optax's ``min(1, c / (||g|| + 1e-6))``), then the optimizer, such as
``train/optim.py::AdamW`` (``optax.adamw(lr)`` is ``AdamW(ps, lr,
weight_decay=1e-4)``). SpecAugment (``augment.py``) is applied to the batch
by the caller, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpu_speech_torch.eval.wer import ctc_greedy_decode
from tpu_speech_torch.models.spiral.ctc import ConvASRDecoder, ctc_loss
from tpu_speech_torch.models.spiral.dropout import DropoutRng
from tpu_speech_torch.models.spiral.encoder import ConvLayerCfg
from tpu_speech_torch.models.spiral.features import filterbank_features
from tpu_speech_torch.models.spiral.jasper import ConvASREncoder, JasperBlockCfg
from tpu_speech_torch.models.spiral.st2vec import init_weights_
from tpu_speech_torch.train.optim import clip_by_global_norm
from tpu_speech_torch.utils.device import resolve_device


def quartznet5x3_blocks(filters: int = 256) -> Tuple[JasperBlockCfg, ...]:
    """The JAX package's compact QuartzNet-style preset: separable repeated
    convs with residuals, k 33-87, the first block strided."""
    return (
        JasperBlockCfg(filters, 33, repeat=1, stride=2, residual=False, separable=True),
        JasperBlockCfg(filters, 33, repeat=3, separable=True),
        JasperBlockCfg(filters, 39, repeat=3, separable=True),
        JasperBlockCfg(filters * 2, 51, repeat=3, separable=True),
        JasperBlockCfg(filters * 2, 87, repeat=1, residual=False, separable=True, dilation=2),
    )


@dataclasses.dataclass(frozen=True)
class EncDecCTCConfig:
    num_classes: int
    blocks: Tuple[JasperBlockCfg, ...] = quartznet5x3_blocks()
    sample_rate: int = 16000
    n_mels: int = 64
    window_size: float = 0.02
    window_stride: float = 0.01
    blank_pos: str = "after_vocab_last"  # NeMo CTC: blank appended last
    decoder_filters: int = 1024
    dither: float = 1e-5


def blank_index(num_classes: int, blank_pos: str) -> int:
    return 0 if blank_pos == "vocab_first" else num_classes


def featurize(cfg, wavs, wav_lens, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """The model config's mel featurizer: wav (B, S) -> specs (B, T, n_mels)
    and their lengths; ``generator`` draws the training dither."""
    return filterbank_features(
        wavs, wav_lens, sample_rate=cfg.sample_rate, window_size=cfg.window_size,
        window_stride=cfg.window_stride, nfilt=cfg.n_mels, dither=cfg.dither,
        training=train, generator=generator)


class EncDecCTCModel(nn.Module):
    """specs (B, T, n_mels) -> CTC log-probs (B, T', V + 1) and lengths.
    Built on ``resolve_device(device)``: the card unless told otherwise."""

    def __init__(self, cfg: EncDecCTCConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = ConvASREncoder(cfg.n_mels, cfg.blocks, device=device)
        self.decoder = ConvASRDecoder(
            self.encoder.output_dim, cfg.num_classes,
            conv_layers=(ConvLayerCfg(cfg.decoder_filters, (1,), (1,), None, "relu", 0.0),),
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

    def init_weights(self, generator: torch.Generator) -> "EncDecCTCModel":
        """Seeded random init at the JAX package's scales
        (``st2vec.init_weights_``: kaiming-normal convs, lecun-normal
        linears and vocab projection, unit BatchNorms). The draws run on the
        CPU generator wherever the model lies."""
        device = next(self.parameters()).device
        init_weights_(self.cpu(), generator, unit_gain=(self.decoder.decoder_layers[0],))
        return self.to(device)


def make_ctc_bpe_model(tokenizer, blocks: Optional[Tuple[JasperBlockCfg, ...]] = None,
                       device="cuda", **cfg_overrides) -> EncDecCTCModel:
    """EncDecCTCModelBPE: the conv-CTC model with the tokenizer's vocabulary
    size and the blank appended after it."""
    cfg = EncDecCTCConfig(num_classes=tokenizer.vocab_size,
                          blocks=blocks if blocks is not None else quartznet5x3_blocks(),
                          **cfg_overrides)
    return EncDecCTCModel(cfg, device=device)


def decode_ctc_bpe(log_probs, out_lens, tokenizer, blank_idx: int):
    """Greedy decode to text through ``tokenizer.ids_to_text`` (WERBPE's
    decode path). Takes tensors on any device or numpy arrays."""
    if torch.is_tensor(log_probs):
        log_probs = log_probs.detach().float().cpu().numpy()
    if torch.is_tensor(out_lens):
        out_lens = out_lens.detach().cpu().numpy()
    ids = ctc_greedy_decode(np.asarray(log_probs), np.asarray(out_lens), blank_idx)
    return [tokenizer.ids_to_text(seq) for seq in ids]


@dataclasses.dataclass
class CTCTrainState:
    """The model (in training mode), the optimizer over its parameters and
    the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_ctc_state(model: nn.Module,
                   make_opt: Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]
                   ) -> CTCTrainState:
    """``make_opt(params) -> optimizer`` receives every parameter."""
    model.train()
    return CTCTrainState(model, make_opt(list(model.parameters())))


def make_ctc_train_step(model: nn.Module, grad_clip: Optional[float] = None):
    """``step(state, batch, rng) -> {"loss"}``: one update of ``state`` in
    place. ``batch`` holds ``specs`` (B, T, F), ``spec_lens``, ``labels``
    (B, L) and ``label_lens`` on the model's device; ``rng`` a
    ``DropoutRng`` (None without dropout)."""

    def step(state: CTCTrainState, batch, rng: Optional[DropoutRng] = None):
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        log_probs, out_lens = state.model(batch["specs"], batch["spec_lens"], rng)
        loss = ctc_loss(log_probs, out_lens, batch["labels"], batch["label_lens"],
                        model.blank_idx)
        loss.backward()
        for p in params:
            if p.grad is None:  # JAX differentiates every leaf
                p.grad = torch.zeros_like(p)
        clip_by_global_norm([p.grad for p in params], grad_clip)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    return step
