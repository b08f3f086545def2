"""tpu_speech (JAX/flax) Grad-TTS and HiFi-GAN trees -> reference-named
PyTorch state_dicts.

The inverses of ``tpu_speech/compat/torch_gradtts.py::convert_gradtts`` and
``torch_hifigan.py::convert_generator``:

- ``gradtts_from_jax(params, n_enc_layers, n_spks)`` takes the GradTTS
  model's flax params (numpy leaves; the tree under ``params``) and returns
  the state_dict that ``tpu_speech_torch.models.grad_tts.GradTTS`` (and the
  reference PyTorch model) load;
- ``hifigan_from_jax(params)`` does the same for the HiFi-GAN generator,
  with folded (plain) conv weights;
- ``fold_weight_norm(state_dict)`` folds a reference HiFi-GAN checkpoint's
  ``weight_g``/``weight_v`` pairs into ``weight`` (weight = g v / ||v||, the
  norm over every dim but the first, as the reference's
  ``remove_weight_norm()`` and ``torch_hifigan.py:23-31`` do).

Layout translation (flax channels-last -> torch channels-first):
- conv1d kernel (k, in, out)        -> Conv1d weight (out, in, k)
- dense kernel (in, out)            -> Linear (out, in), Conv1d k=1 (out, in, 1)
                                       or Conv2d 1x1 (out, in, 1, 1)
- conv2d kernel (kh, kw, in, out)   -> Conv2d weight (out, in, kh, kw)
- conv-transpose kernel (..., in, out) -> ConvTranspose weight (in, out, ...)
- LayerNorm gamma/beta, GroupNorm scale/bias -> gamma/beta, weight/bias

Both converters are strict: every leaf of the tree is consumed exactly once.
``.npz`` files are read with ``compat/jax_spiral.py::load_jax_npz``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tpu_speech_torch.compat.jax_spiral import _Tree, _conv, _dense, _t


def _dense_conv(tr, path, sd, key, ndim):
    """A flax Dense that is a k=1 Conv1d (ndim 3) or a 1x1 Conv2d (ndim 4)."""
    w = np.transpose(tr.get(*path, "kernel"), (1, 0))
    sd[f"{key}.weight"] = _t(w.reshape(w.shape + (1,) * (ndim - 2)))
    if tr.has(*path, "bias"):
        sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def _conv2d(tr, path, sd, key):
    sd[f"{key}.weight"] = _t(np.transpose(tr.get(*path, "kernel"), (3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def _layernorm(tr, path, sd, key):
    sd[f"{key}.gamma"] = _t(tr.get(*path, "gamma"))
    sd[f"{key}.beta"] = _t(tr.get(*path, "beta"))


def _groupnorm(tr, path, sd, key):
    sd[f"{key}.weight"] = _t(tr.get(*path, "scale"))
    sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def _prenet_transformer(tr, p, sd, k, n_layers):
    """The glow-tts prenet (``ConvReluNorm``) and rel-pos transformer under
    flax path ``p`` -> keys ``{k}.prenet.*`` and ``{k}.encoder.*``."""
    for i in range(3):
        _conv(tr, p + ("prenet", f"conv_{i}"), sd, f"{k}.prenet.conv_layers.{i}")
        _layernorm(tr, p + ("prenet", f"norm_{i}"), sd, f"{k}.prenet.norm_layers.{i}")
    _conv(tr, p + ("prenet", "proj"), sd, f"{k}.prenet.proj")
    enc, ek = p + ("encoder",), f"{k}.encoder"
    for i in range(n_layers):
        for proj in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _dense_conv(tr, enc + (f"attn_{i}", proj), sd, f"{ek}.attn_layers.{i}.{proj}", 3)
        for rel in ("emb_rel_k", "emb_rel_v"):
            if tr.has(*enc, f"attn_{i}", rel):
                sd[f"{ek}.attn_layers.{i}.{rel}"] = _t(tr.get(*enc, f"attn_{i}", rel))
        _layernorm(tr, enc + (f"norm1_{i}",), sd, f"{ek}.norm_layers_1.{i}")
        for c in ("conv_1", "conv_2"):
            _conv(tr, enc + (f"ffn_{i}", c), sd, f"{ek}.ffn_layers.{i}.{c}")
        _layernorm(tr, enc + (f"norm2_{i}",), sd, f"{ek}.norm_layers_2.{i}")


def _text_encoder(tr, sd, n_layers):
    p, k = ("encoder",), "encoder"
    sd[f"{k}.emb.weight"] = _t(tr.get(*p, "emb", "embedding"))
    _prenet_transformer(tr, p, sd, k, n_layers)
    _conv(tr, p + ("proj_m",), sd, f"{k}.proj_m")
    for c in ("conv_1", "conv_2", "proj"):
        _conv(tr, p + ("proj_w", c), sd, f"{k}.proj_w.{c}")
    for n in ("norm_1", "norm_2"):
        _layernorm(tr, p + ("proj_w", n), sd, f"{k}.proj_w.{n}")


def _block(tr, path, sd, key):
    _conv2d(tr, path + ("conv",), sd, f"{key}.block.0")
    _groupnorm(tr, path + ("norm",), sd, f"{key}.block.1")


def _resnet(tr, path, sd, key):
    _dense(tr, path + ("mlp",), sd, f"{key}.mlp.1")
    _block(tr, path + ("block1",), sd, f"{key}.block1")
    _block(tr, path + ("block2",), sd, f"{key}.block2")
    if tr.has(*path, "res_conv"):
        _dense_conv(tr, path + ("res_conv",), sd, f"{key}.res_conv", 4)


def _rezero_attn(tr, path, sd, key):
    sd[f"{key}.fn.g"] = _t(tr.get(*path, "g"))
    _dense_conv(tr, path + ("fn", "to_qkv"), sd, f"{key}.fn.fn.to_qkv", 4)
    _dense_conv(tr, path + ("fn", "to_out"), sd, f"{key}.fn.fn.to_out", 4)


def _unet(tr, p, sd, k):
    """The U-Net body that Grad-TTS's and DiffVC's estimators share
    (``nn/unet.py::UNet``) under flax path ``p`` -> keys ``{k}.downs.*`` ...
    ``{k}.final_conv``."""
    i = 0
    while tr.has(*p, f"down_{i}_res1"):
        _resnet(tr, p + (f"down_{i}_res1",), sd, f"{k}.downs.{i}.0")
        _resnet(tr, p + (f"down_{i}_res2",), sd, f"{k}.downs.{i}.1")
        _rezero_attn(tr, p + (f"down_{i}_attn",), sd, f"{k}.downs.{i}.2")
        if tr.has(*p, f"down_{i}_ds"):
            _conv2d(tr, p + (f"down_{i}_ds", "conv"), sd, f"{k}.downs.{i}.3.conv")
        i += 1
    _resnet(tr, p + ("mid_block1",), sd, f"{k}.mid_block1")
    _rezero_attn(tr, p + ("mid_attn",), sd, f"{k}.mid_attn")
    _resnet(tr, p + ("mid_block2",), sd, f"{k}.mid_block2")
    j = 0
    while tr.has(*p, f"up_{j}_res1"):
        _resnet(tr, p + (f"up_{j}_res1",), sd, f"{k}.ups.{j}.0")
        _resnet(tr, p + (f"up_{j}_res2",), sd, f"{k}.ups.{j}.1")
        _rezero_attn(tr, p + (f"up_{j}_attn",), sd, f"{k}.ups.{j}.2")
        us = p + (f"up_{j}_us",)
        sd[f"{k}.ups.{j}.3.conv.weight"] = _t(np.transpose(tr.get(*us, "kernel"), (2, 3, 0, 1)))
        sd[f"{k}.ups.{j}.3.conv.bias"] = _t(tr.get(*us, "bias"))
        j += 1
    _block(tr, p + ("final_block",), sd, f"{k}.final_block")
    _conv2d(tr, p + ("final_conv",), sd, f"{k}.final_conv")


def _estimator(tr, sd, n_spks):
    p, k = ("estimator",), "decoder.estimator"
    if n_spks > 1:
        _dense(tr, p + ("spk_mlp_0",), sd, f"{k}.spk_mlp.0")
        _dense(tr, p + ("spk_mlp_1",), sd, f"{k}.spk_mlp.2")
    _dense(tr, p + ("mlp_0",), sd, f"{k}.mlp.0")
    _dense(tr, p + ("mlp_1",), sd, f"{k}.mlp.2")
    _unet(tr, p, sd, k)


def _unwrap(params: Mapping) -> Mapping:
    """Accept the tree with or without its top ``params`` key."""
    return params["params"] if set(params) == {"params"} else params


def gradtts_from_jax(params: Mapping, n_enc_layers: int = 6, n_spks: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """GradTTS flax params -> reference-named torch state_dict."""
    tr = _Tree(_unwrap(params), "params")
    sd: Dict[str, torch.Tensor] = {}
    if n_spks > 1:
        sd["spk_emb.weight"] = _t(tr.get("spk_emb", "embedding"))
    _text_encoder(tr, sd, n_enc_layers)
    _estimator(tr, sd, n_spks)
    leftover = tr.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")
    return sd


def hifigan_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """HiFi-GAN generator flax params -> reference-named torch state_dict
    (plain, folded conv weights). The upsampler count, the MRF kernel count
    and the resblock type are read from the tree."""
    tr = _Tree(_unwrap(params), "params")
    sd: Dict[str, torch.Tensor] = {}
    _conv(tr, ("conv_pre",), sd, "conv_pre")
    n_kernels = 0
    while tr.has(f"resblocks_0_{n_kernels}"):
        n_kernels += 1
    i = 0
    while tr.has(f"ups_{i}"):
        sd[f"ups.{i}.weight"] = _t(np.transpose(tr.get(f"ups_{i}", "kernel"), (1, 2, 0)))
        sd[f"ups.{i}.bias"] = _t(tr.get(f"ups_{i}", "bias"))
        for j in range(n_kernels):
            blk, key = f"resblocks_{i}_{j}", f"resblocks.{i * n_kernels + j}"
            names = ("convs1", "convs2") if tr.has(blk, "convs1_0") else ("convs",)
            for name in names:
                c = 0
                while tr.has(blk, f"{name}_{c}"):
                    _conv(tr, (blk, f"{name}_{c}"), sd, f"{key}.{name}.{c}")
                    c += 1
        i += 1
    _conv(tr, ("conv_post",), sd, "conv_post")
    leftover = tr.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")
    return sd


def fold_weight_norm(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """Fold every ``<prefix>.weight_g``/``<prefix>.weight_v`` pair into
    ``<prefix>.weight``; other entries pass through."""
    sd = dict(state_dict)
    for key in [k for k in sd if k.endswith(".weight_g")]:
        prefix = key[: -len(".weight_g")]
        g, v = sd.pop(key), sd.pop(f"{prefix}.weight_v")
        norm = torch.sqrt((v ** 2).sum(dim=tuple(range(1, v.dim())), keepdim=True))
        sd[f"{prefix}.weight"] = g * v / norm
    return sd
