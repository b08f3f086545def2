"""tpu_speech (JAX/flax) conv-CTC and Conformer-CTC trees <-> the port's
state_dicts.

- ``enc_dec_ctc_from_jax(variables)``: an ``EncDecCTCModel``'s flax
  ``{"params", "batch_stats"}`` (numpy leaves) -> the state_dict of
  ``tpu_speech_torch.models.spiral.ctc_models.EncDecCTCModel``;
- ``conv_asr_encoder_from_jax(variables)``: a ``ConvASREncoder`` (a stack
  of Jasper blocks) alone;
- ``conformer_ctc_from_jax(variables)``: the same for ``ConformerCTCModel``
  (``models/spiral/conformer.py``);
- ``enc_dec_ctc_to_jax(state_dict)`` and ``conformer_ctc_to_jax(state_dict)``
  go the other way, exactly (the round trip gives the same arrays).

Layouts (flax -> torch): Dense kernel (in, out) -> Linear weight (out, in);
1-D conv kernel (k, in/g, out) -> (out, in/g, k); 2-D conv kernel (kh, kw,
in, out) -> (out, in, kh, kw); norm scale / bias -> weight / bias;
BatchNorm mean / var -> running_mean / running_var (``num_batches_tracked``
has no flax counterpart: dropped going to JAX, 0 coming back);
``pos_bias_u`` / ``_v`` as they are. The flax names are the modules'
(``block_{i}/{dw,pw,conv,bn}_{r}``, ``layers_{i}/ff1/Dense_0``, ...). The
converters are strict: every leaf is consumed exactly once. The helpers are
``compat/jax_spiral.py``'s.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpu_speech_torch.compat.jax_spiral import (
    _StateDict,
    _Tree,
    _check_consumed,
    _conv,
    _conv_to,
    _decoder,
    _dense,
    _dense_to,
    _norm,
    _norm_to,
    _put,
    _t,
)

# conformer flax name -> the port's module name, per block and per sub-module
_FF = (("LayerNorm_0", "norm", "norm"), ("Dense_0", "linear1", "dense"),
       ("Dense_1", "linear2", "dense"))
_CONV = (("LayerNorm_0", "norm", "norm"), ("Dense_0", "pointwise_conv1", "dense"),
         ("depthwise", "depthwise_conv", "conv"), ("BatchNorm_0", "batch_norm", "norm"),
         ("Dense_1", "pointwise_conv2", "dense"))
_ATTN = ("linear_q", "linear_k", "linear_v", "linear_out")


def _split(variables: Mapping):
    return (_Tree(variables["params"], "params"),
            _Tree(variables.get("batch_stats", {}), "batch_stats"))


def _done(*trees):
    leftover = sum((t.leftover() for t in trees), [])
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")


def _leaf(tr, bs, path, sd, key, kind):
    if kind == "norm":
        _norm(tr, bs, path, sd, key)
    else:
        (_dense if kind == "dense" else _conv)(tr, path, sd, key)


def _leaf_to(sd, key, tree, bs, path, kind):
    if kind == "norm":
        _norm_to(sd, key, tree, bs, path)
    else:
        (_dense_to if kind == "dense" else _conv_to)(sd, key, tree, path)


def _jasper_block_names(tr: _Tree, path) -> Tuple[str, ...]:
    node = tr.tree
    for k in path:
        node = node[k]
    return tuple(node)


def _jasper_blocks(tr: _Tree, bs: _Tree, path, sd, key) -> None:
    i = 0
    while tr.has(*path, f"block_{i}"):
        bp, bk = path + (f"block_{i}",), f"{key}blocks.{i}"
        for name in _jasper_block_names(tr, bp):
            kind, r = name.rsplit("_", 1)
            if kind in ("dw", "pw", "conv"):
                _conv(tr, bp + (name,), sd, f"{bk}.{kind}.{r}")
            elif kind == "bn":
                _norm(tr, bs, bp + (name,), sd, f"{bk}.bn.{r}")
        if tr.has(*bp, "res_proj"):
            _dense(tr, bp + ("res_proj",), sd, f"{bk}.res_proj")
            _norm(tr, bs, bp + ("res_bn",), sd, f"{bk}.res_bn")
        i += 1


def conv_asr_encoder_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """A ``ConvASREncoder``'s flax variables (``block_{i}`` at the top) ->
    the port's ``ConvASREncoder`` state_dict."""
    tr, bs = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _jasper_blocks(tr, bs, (), sd, "")
    _done(tr, bs)
    return sd


def enc_dec_ctc_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``EncDecCTCModel`` flax variables -> the port's state_dict."""
    tr, bs = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _jasper_blocks(tr, bs, ("encoder",), sd, "encoder.")
    _decoder(tr, bs, ("decoder",), sd, "decoder")
    _done(tr, bs)
    return sd


def _decoder_to(sd: _StateDict, params):
    i = 0
    while sd.has(f"decoder.conv_layers.{i}.conv.conv.weight"):
        _conv_to(sd, f"decoder.conv_layers.{i}.conv.conv", params,
                 ("decoder", f"conv_{i}", "conv"))
        i += 1
    w = sd.get("decoder.decoder_layers.0.weight")  # (V, C, 1)
    _put(params, ("decoder", "decoder_proj", "kernel"), np.transpose(w[:, :, 0], (1, 0)))
    _put(params, ("decoder", "decoder_proj", "bias"), sd.get("decoder.decoder_layers.0.bias"))


def enc_dec_ctc_to_jax(state_dict: Mapping) -> Dict[str, Dict]:
    """The port's ``EncDecCTCModel`` state_dict -> flax ``{"params",
    "batch_stats"}``."""
    sd = _StateDict(state_dict)
    params: Dict = {}
    bs: Dict = {}
    i = 0
    while any(k.startswith(f"encoder.blocks.{i}.") for k in sd.sd):
        key, bp = f"encoder.blocks.{i}", ("encoder", f"block_{i}")
        r = 0
        while sd.has(f"{key}.bn.{r}.weight"):
            for kind in ("dw", "pw", "conv"):
                if sd.has(f"{key}.{kind}.{r}.weight"):
                    _conv_to(sd, f"{key}.{kind}.{r}", params, bp + (f"{kind}_{r}",))
            _norm_to(sd, f"{key}.bn.{r}", params, bs, bp + (f"bn_{r}",))
            r += 1
        if sd.has(f"{key}.res_proj.weight"):
            _dense_to(sd, f"{key}.res_proj", params, bp + ("res_proj",))
            _norm_to(sd, f"{key}.res_bn", params, bs, bp + ("res_bn",))
        i += 1
    _decoder_to(sd, params)
    _check_consumed(sd)
    return {"params": params, "batch_stats": bs}


def _conv2d(tr, path, sd, key):
    sd[f"{key}.weight"] = _t(np.transpose(tr.get(*path, "kernel"), (3, 2, 0, 1)))
    sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def conformer_ctc_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``ConformerCTCModel`` flax variables -> the port's state_dict."""
    tr, bs = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    for s in range(2):
        _conv2d(tr, ("encoder", f"subsample_{s}"), sd, f"encoder.subsample.{s}")
    _dense(tr, ("encoder", "proj"), sd, "encoder.proj")
    i = 0
    while tr.has("encoder", f"layers_{i}"):
        lp, key = ("encoder", f"layers_{i}"), f"encoder.layers.{i}"
        for ff in ("ff1", "ff2"):
            for jax_name, name, kind in _FF:
                _leaf(tr, bs, lp + (ff, jax_name), sd, f"{key}.{ff}.{name}", kind)
        _norm(tr, bs, lp + ("LayerNorm_0",), sd, f"{key}.norm_self_att")
        for proj in _ATTN:
            _dense(tr, lp + ("self_attn", proj), sd, f"{key}.self_attn.{proj}")
        sd[f"{key}.self_attn.linear_pos.weight"] = _t(
            np.transpose(tr.get(*lp, "self_attn", "linear_pos", "kernel"), (1, 0)))
        for bias in ("pos_bias_u", "pos_bias_v"):
            sd[f"{key}.self_attn.{bias}"] = _t(tr.get(*lp, "self_attn", bias))
        for jax_name, name, kind in _CONV:
            _leaf(tr, bs, lp + ("conv", jax_name), sd, f"{key}.conv.{name}", kind)
        _norm(tr, bs, lp + ("LayerNorm_1",), sd, f"{key}.norm_out")
        i += 1
    _decoder(tr, bs, ("decoder",), sd, "decoder")
    _done(tr, bs)
    return sd


def conformer_ctc_to_jax(state_dict: Mapping) -> Dict[str, Dict]:
    """The port's ``ConformerCTCModel`` state_dict -> flax ``{"params",
    "batch_stats"}``."""
    sd = _StateDict(state_dict)
    params: Dict = {}
    bs: Dict = {}
    for s in range(2):
        key, path = f"encoder.subsample.{s}", ("encoder", f"subsample_{s}")
        _put(params, path + ("kernel",), np.transpose(sd.get(f"{key}.weight"), (2, 3, 1, 0)))
        _put(params, path + ("bias",), sd.get(f"{key}.bias"))
    _dense_to(sd, "encoder.proj", params, ("encoder", "proj"))
    i = 0
    while sd.has(f"encoder.layers.{i}.norm_out.weight"):
        key, lp = f"encoder.layers.{i}", ("encoder", f"layers_{i}")
        for ff in ("ff1", "ff2"):
            for jax_name, name, kind in _FF:
                _leaf_to(sd, f"{key}.{ff}.{name}", params, bs, lp + (ff, jax_name), kind)
        _norm_to(sd, f"{key}.norm_self_att", params, bs, lp + ("LayerNorm_0",))
        for proj in _ATTN:
            _dense_to(sd, f"{key}.self_attn.{proj}", params, lp + ("self_attn", proj))
        _put(params, lp + ("self_attn", "linear_pos", "kernel"),
             np.transpose(sd.get(f"{key}.self_attn.linear_pos.weight"), (1, 0)))
        for bias in ("pos_bias_u", "pos_bias_v"):
            _put(params, lp + ("self_attn", bias), sd.get(f"{key}.self_attn.{bias}"))
        for jax_name, name, kind in _CONV:
            _leaf_to(sd, f"{key}.conv.{name}", params, bs, lp + ("conv", jax_name), kind)
        _norm_to(sd, f"{key}.norm_out", params, bs, lp + ("LayerNorm_1",))
        i += 1
    _decoder_to(sd, params)
    _check_consumed(sd)
    return {"params": params, "batch_stats": bs}
