"""Chunk-incremental (streaming) inference for streaming-mode SPIRAL CTC models.

Port of ``tpu_speech/models/spiral/streaming.py``. A ``CTCFinetuneModel``
built with ``ST2VecConfig(streaming=StreamingCfg(C, L))`` (causal convs, the
causal positional conv, block-chunked attention, the causal cumulative
featurizer normalization; ``models/spiral/encoder.py``) trains as an ordinary
offline forward. ``make_stream_step`` serves it chunk by chunk with carried
state, and its outputs equal the offline streaming-mode forward up to float
reassociation; ``StreamingTranscriber`` feeds it from the host.

The step is a set of functions over the offline model's own modules: no
conversion step, no module of its own. State is a flat dict of tensors on
the model's device (and the chunk counter on the host):

- ``cnt``, ``s1``, ``s2``: (B, F) running count, sum and sum of squares of
  the log-mels, in float64 as the port's offline ``per_feature_causal``
  sums them (``models/spiral/features.py``). The JAX step carries float32
  sums; the port's chunked output equals the port's offline output instead.
- ``conv{i}``: the (k - 1)-frame input tail of encoder module i, a conv.
- ``pos{i}``: the 127-frame input tail of transformer i's positional conv;
  ``k{i}.{l}`` / ``v{i}.{l}``: layer l's projected keys and values of the
  ``left_chunks`` chunks before this one, (B, L*C_i, H, D). Slot m holds
  global frame (j - L)*C_i + m at chunk j; slots before the stream start
  are masked.
- ``up``, ``dec{i}``: the decoder's upsampling projection and conv tails.

Kernels on the chunk step: K1 (``ops/fused_logmel.py::fused_logmel``) on
each chunk's window, which is exactly K1's input contract (preemphasized and
padded samples), where JAX's ``_logmel_window`` uses XLA's rfft; and K4
(``ops/fused_posconv.py::grouped_conv1d``) for each positional conv, a conv
of [tail (k - 1), new (C)] with ``left_pad = 0`` whose first C output rows
are the valid outputs. Everything else is plain torch, as JAX computes it:
the C x (L*C + C) attention, the convs, LayerNorm, the dense layers and the
log-softmax. The step runs eagerly, many small launches a chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_speech_torch.models.spiral.conv_layers import ConvNormAct, activation
from tpu_speech_torch.models.spiral.features import CONSTANT, featurizer_constants
from tpu_speech_torch.models.spiral.wav2vec import TransformerEncoder, attend
from tpu_speech_torch.ops.fused_logmel import fused_logmel
from tpu_speech_torch.ops.fused_posconv import grouped_conv1d

__all__ = ["FeatSpec", "feat_spec", "make_stream_step", "StreamingTranscriber"]


@dataclasses.dataclass(frozen=True)
class FeatSpec:
    """The featurizer's framing (``_FeatSpec:183``)."""

    sample_rate: int
    nfilt: int
    win_length: int
    hop: int
    n_fft: int
    preemph: float
    log_guard: float

    @property
    def pad(self) -> int:  # the centre reflect pad
        return self.n_fft // 2

    @property
    def overlap(self) -> int:  # padded samples shared by consecutive windows
        return self.n_fft - self.hop


def feat_spec(sample_rate=16000, nfilt=128, window_size=0.02, window_stride=0.01,
              preemph=0.97, log_guard=2.0 ** -24) -> FeatSpec:
    win = int(window_size * sample_rate)
    return FeatSpec(sample_rate=sample_rate, nfilt=nfilt, win_length=win,
                    hop=int(window_stride * sample_rate),
                    n_fft=2 ** math.ceil(math.log2(win)), preemph=preemph,
                    log_guard=log_guard)


# ---- incremental layers; each returns (output, new cache) -------------------


def _layer_norm(mod, x):
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias, mod.eps)


def _conv_chunk(conv: torch.nn.Conv1d, cache, x_new, stride: int):
    """The conv over [tail, new], unpadded: x_new.shape[1] // stride outputs."""
    k = conv.kernel_size[0]
    x = torch.cat([cache, x_new], dim=1) if k > 1 else x_new
    y = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, stride=stride).transpose(1, 2)
    return y, (x[:, x.shape[1] - (k - 1):] if k > 1 else cache)


def _conv_norm_act_chunk(mod: ConvNormAct, cache, x_new):
    """Incremental causal ``ConvNormAct`` (``_conv_norm_act_chunk:87``)."""
    y, cache = _conv_chunk(mod.conv.conv, cache, x_new, mod.conv.stride)
    if mod.norm_type == "ln":
        y = _layer_norm(mod.norm, y)
    elif mod.norm_type is not None:
        raise NotImplementedError(f"streaming runs ln or no norm, not {mod.norm_type!r}")
    return activation(y, mod.act_func), cache


def _pos_conv_chunk(mod, cache, x_new):
    """Incremental causal positional conv (``_pos_conv_chunk:111``): K4 with
    left_pad 0 over [tail (k - 1), new (C)], its first C rows, + bias, GELU."""
    x = torch.cat([cache, x_new], dim=1)
    k = mod.kernel_size
    y = grouped_conv1d(x, mod.weight().to(x.dtype), mod.groups, 0)[:, :x_new.shape[1]]
    return F.gelu(y + mod.bias.to(x.dtype)), x[:, x.shape[1] - (k - 1):]


def _mha_chunk(attn, x_new, k_cache, v_cache, key_valid):
    """Incremental block-chunked self-attention (``_mha_chunk:127``): the new
    chunk's queries over [cached keys and values, the new ones]; the caches
    hold projected K/V, so a frame is projected once."""
    b, c, e = x_new.shape
    h = attn.num_heads
    w, bias = attn.qkv_weights()
    q, k_new, v_new = F.linear(x_new, w, bias).view(b, c, 3, h, e // h).unbind(2)
    k_all = torch.cat([k_cache, k_new], dim=1)  # (B, L + C, H, D)
    v_all = torch.cat([v_cache, v_new], dim=1)
    out = attend(q, k_all, v_all, key_valid[:, None, None, :])
    return attn.out_proj(out.reshape(b, c, e)), k_all[:, c:], v_all[:, c:]


def _transformer_chunk(enc: TransformerEncoder, i: int, st, new_st, x_new, key_valid):
    """Incremental pre-LN ``TransformerEncoder`` (``_transformer_chunk:146``)."""
    if not enc.layer_norm_first:
        raise NotImplementedError("streaming runs pre-LN transformer stacks")
    pos, new_st[f"pos{i}"] = _pos_conv_chunk(enc.pos_conv[0], st[f"pos{i}"], x_new)
    x = x_new + pos
    for l, layer in enumerate(enc.layers):
        attn, new_st[f"k{i}.{l}"], new_st[f"v{i}.{l}"] = _mha_chunk(
            layer.self_attn, _layer_norm(layer.self_attn_layer_norm, x),
            st[f"k{i}.{l}"], st[f"v{i}.{l}"], key_valid)
        x = x + attn
        x = x + layer.fc2(layer.act(layer.fc1(_layer_norm(layer.final_layer_norm, x))))
    return _layer_norm(enc.layer_norm, x)


def _causal_normalize(feats, valid, cnt, s1, s2):
    """Per-feature cumulative mean / Bessel-std normalization continuing the
    carried float64 (count, sum, sum of squares) (``_causal_normalize:223``).
    feats (B, T, F) float32, valid (B, T) 1.0 at real frames."""
    f64, vm = feats.double(), valid.double()[:, :, None]
    ccnt = cnt[:, None, :] + torch.cumsum(vm, dim=1)
    cs1 = s1[:, None, :] + torch.cumsum(f64 * vm, dim=1)
    cs2 = s2[:, None, :] + torch.cumsum(f64.square() * vm, dim=1)
    mean = cs1 / torch.clamp(ccnt, min=1.0)
    var = (cs2 - ccnt * mean.square()) / torch.clamp(ccnt - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0)) + CONSTANT
    out = ((f64 - mean) / std).to(feats.dtype)
    return out, ccnt[:, -1], cs1[:, -1], cs2[:, -1]


# ---- the step ---------------------------------------------------------------


def _geometry(model):
    """[(module index, module, cumulative stride after it)] of the encoder."""
    out, cum = [], 1
    for i, mod in enumerate(model.encoder.feature_encoder.block_modules):
        if isinstance(mod, ConvNormAct):
            cum *= mod.conv.stride
        out.append((i, mod, cum))
    return out


def make_stream_step(model, feat: Optional[FeatSpec] = None):
    """(init_state, step) for a streaming-mode ``CTCFinetuneModel`` on its
    own device (``make_stream_step:246``).

    ``step(state, window, n_valid) -> (state, log_probs, ids, lens)``:
    window (B, chunk_samples + feat.overlap) float32, preemphasized and
    padded samples on the model's device; n_valid (B,) int the real spec
    frames of this chunk (chunk_frames but in the flush chunk); log_probs
    (B, frames out, V), ids their argmax, lens (B,) the valid output frames.
    """
    enc = model.encoder.feature_encoder
    stream = enc.streaming
    if stream is None:
        raise ValueError("make_stream_step needs a streaming-mode model "
                         "(ST2VecConfig(streaming=StreamingCfg(...)))")
    cfg = model.encoder.cfg
    feat = feat or feat_spec(sample_rate=cfg.sample_rate, nfilt=cfg.num_features)
    chunk, left = stream.chunk_frames, stream.left_chunks
    geometry = _geometry(model)
    dec = model.decoder
    device = next(model.parameters()).device
    window, fb = featurizer_constants(feat.sample_rate, feat.win_length, feat.n_fft, feat.nfilt,
                                      0.0, feat.sample_rate / 2, device)

    def init_state(batch: int) -> Dict[str, torch.Tensor]:
        def zeros(t, c, dtype=torch.float32):
            return torch.zeros((batch, max(t, 0), c), dtype=dtype, device=device)

        st = {name: torch.zeros((batch, feat.nfilt), dtype=torch.float64, device=device)
              for name in ("cnt", "s1", "s2")}
        st["chunk"] = torch.zeros((), dtype=torch.int64)  # on the host
        ch = feat.nfilt
        for i, mod, cum in geometry:
            if isinstance(mod, ConvNormAct):
                st[f"conv{i}"] = zeros(mod.conv.kernel_size - 1, ch)
                ch = mod.conv.conv.out_channels
            else:
                pos = mod.pos_conv[0]
                st[f"pos{i}"] = zeros(pos.kernel_size - 1, ch)
                for l, layer in enumerate(mod.layers):
                    h = layer.self_attn.num_heads
                    for kv in "kv":
                        st[f"{kv}{i}.{l}"] = torch.zeros(
                            (batch, left * (chunk // cum), h, ch // h), device=device)
        if dec.proj_upsampling is not None:
            up = dec.proj_upsampling.proj.conv.conv
            st["up"] = zeros(up.kernel_size[0] - 1, ch)
            ch = dec.proj_upsampling.filters
        for i, conv in enumerate(dec.conv_layers):
            st[f"dec{i}"] = zeros(conv.conv.kernel_size - 1, ch)
            ch = conv.conv.conv.out_channels
        return st

    @torch.inference_mode()
    def step(state, window_samples, n_valid):
        new = {}
        feats = fused_logmel(window_samples, window, fb, n_fft=feat.n_fft, hop_length=feat.hop,
                             num_frames=chunk, mag_mode="power", log_mode="guard",
                             log_guard=feat.log_guard)
        lens = n_valid.to(device=device, dtype=torch.int64)
        fvalid = (torch.arange(chunk, device=device)[None, :] < lens[:, None]).to(feats.dtype)
        x, new["cnt"], new["s1"], new["s2"] = _causal_normalize(
            feats, fvalid, state["cnt"], state["s1"], state["s2"])
        x = x * fvalid[:, :, None]  # the offline featurizer zeroes padded frames
        j = int(state["chunk"])
        new["chunk"] = state["chunk"] + 1
        for i, mod, cum in geometry:
            if isinstance(mod, ConvNormAct):
                x, new[f"conv{i}"] = _conv_norm_act_chunk(mod, state[f"conv{i}"], x)
                s = mod.conv.stride
                if s > 1:
                    lens = (lens + s - 1) // s
                continue
            c = chunk // cum
            # cache slot m holds global frame (j - left) * c + m; the new
            # frames are valid up to lens
            slots = torch.arange(left * c, device=device)
            cache_valid = ((j - left) * c + slots >= 0)[None, :].expand(x.shape[0], -1)
            new_valid = torch.arange(c, device=device)[None, :] < lens[:, None]
            key_valid = torch.cat([cache_valid, new_valid], dim=1)
            x = x * new_valid[:, :, None].to(x.dtype)
            x = _transformer_chunk(mod, i, state, new, x, key_valid)
        if dec.proj_upsampling is not None:
            ups = dec.proj_upsampling
            y, new["up"] = _conv_chunk(ups.proj.conv.conv, state["up"], x, 1)
            b, t, _ = y.shape
            y = y.reshape(b, t * ups.rate, ups.filters)
            if ups.norm is not None:
                y = _layer_norm(ups.norm, y)
            x = F.relu(y) if ups.act_func == "relu" else y
            lens = lens * ups.rate
        for i, conv in enumerate(dec.conv_layers):
            x, new[f"dec{i}"] = _conv_norm_act_chunk(conv, state[f"dec{i}"], x)
        proj = dec.decoder_layers[0]
        log_probs = torch.log_softmax(F.linear(x, proj.weight[:, :, 0], proj.bias), dim=-1)
        return new, log_probs, log_probs.argmax(dim=-1), lens

    return init_state, step


class StreamingTranscriber:
    """Host-side streaming loop (``StreamingTranscriber:441``): buffers raw
    samples, preemphasizes them (the reflect pad at stream start), cuts fixed
    windows of ``chunk_samples + overlap``, runs the chunk step, and carries
    the greedy CTC collapse across chunks.

    ``feed(wav)`` takes float32 samples of any length, (B, n) or (n,);
    ``flush()`` reflect-pads the tail, runs the partial last chunk with its
    padded frames masked, and returns the collapsed token ids.
    """

    def __init__(self, model, batch: int = 1, feat: Optional[FeatSpec] = None):
        cfg = model.encoder.cfg
        self.feat = feat or feat_spec(sample_rate=cfg.sample_rate, nfilt=cfg.num_features)
        self.chunk = cfg.streaming.chunk_frames
        self.chunk_samples = self.chunk * self.feat.hop
        self.blank = model.blank_idx
        self.batch = batch
        self.device = next(model.parameters()).device
        self.init_state, self.step = make_stream_step(model, self.feat)
        self.reset()

    def reset(self):
        self.state = self.init_state(self.batch)
        self._padded = [np.zeros((0,), np.float32) for _ in range(self.batch)]
        self._raw_n = 0
        self._prev_raw = np.zeros((self.batch,), np.float32)
        self._started = False
        self._consumed = 0  # padded samples consumed into emitted windows
        self._prev_tok = np.full((self.batch,), -1, np.int64)
        self._ids: List[List[int]] = [[] for _ in range(self.batch)]

    def _preemph_extend(self, wav: np.ndarray):
        """Append the preemphasized samples (and, at stream start, the
        n_fft // 2 left reflect pad) to the padded stream."""
        p = wav - self.feat.preemph * np.concatenate([self._prev_raw[:, None], wav[:, :-1]],
                                                     axis=1)
        if not self._started:
            p[:, 0] = wav[:, 0]  # the offline featurizer keeps x[0]
        self._prev_raw = wav[:, -1].copy()
        for b in range(self.batch):
            self._padded[b] = np.concatenate([self._padded[b], p[b]])
        self._raw_n += wav.shape[1]
        if not self._started and self._raw_n > self.feat.pad:
            for b in range(self.batch):
                head = self._padded[b][1:self.feat.pad + 1][::-1]
                self._padded[b] = np.concatenate([head, self._padded[b]])
            self._started = True

    def _emit_ready(self, final_valid: Optional[np.ndarray] = None):
        w, ov = self.chunk_samples, self.feat.overlap
        while self._started and all(len(pb) - self._consumed >= w + ov for pb in self._padded):
            win = np.stack([pb[self._consumed:self._consumed + w + ov] for pb in self._padded])
            self._consumed += w
            if final_valid is not None and all(
                    len(pb) - self._consumed < w + ov for pb in self._padded):
                nv = final_valid
            else:
                nv = np.full((self.batch,), self.chunk, np.int64)
            self.state, _, ids, lens = self.step(
                self.state, torch.from_numpy(win).to(self.device), torch.from_numpy(nv))
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            for b in range(self.batch):
                for t in range(int(lens[b])):
                    tok = int(ids[b, t])
                    if tok != self.blank and tok != self._prev_tok[b]:
                        self._ids[b].append(tok)
                    self._prev_tok[b] = tok

    def feed(self, wav: np.ndarray):
        """wav: (B, n) or (n,) raw float32 samples."""
        if wav.ndim == 1:
            wav = wav[None, :]
        if wav.shape[0] != self.batch:
            raise ValueError(f"fed {wav.shape[0]} streams to a transcriber of {self.batch}")
        self._preemph_extend(wav.astype(np.float32))
        self._emit_ready()

    def flush(self) -> List[List[int]]:
        """Reflect-pad the tail (the offline right pad), zero-fill to whole
        chunks, run the remaining frames and return the collapsed ids."""
        true_frames = -(-self._raw_n // self.feat.hop)
        done_frames = self._consumed // self.feat.hop
        if true_frames > done_frames:
            pad = self.feat.pad
            for b in range(self.batch):
                pb = self._padded[b]
                tail = pb[-pad - 1:-1][::-1] if len(pb) > pad else np.zeros((pad,), np.float32)
                self._padded[b] = np.concatenate([pb, tail])
            rem = true_frames - done_frames
            n_chunks = -(-rem // self.chunk)
            need = self._consumed + n_chunks * self.chunk_samples + self.feat.overlap
            for b in range(self.batch):
                short = need - len(self._padded[b])
                if short > 0:
                    self._padded[b] = np.concatenate(
                        [self._padded[b], np.zeros((short,), np.float32)])
            last_valid = rem - (n_chunks - 1) * self.chunk
            self._emit_ready(final_valid=np.full((self.batch,), last_valid, np.int64))
        return [list(ids) for ids in self._ids]
