"""tpu_speech (JAX/flax) DiffVC and speaker-encoder trees <-> reference-named
PyTorch state_dicts.

The inverses of ``tpu_speech/compat/torch_diffvc.py::convert_diffvc`` and
``convert_fwd_diffusion`` and ``torch_speaker_encoder.py::
convert_speaker_encoder``, and, for what training moves between the
packages, both directions:

- ``diffvc_from_jax(params, n_enc_layers, use_ref_t)`` takes the DiffVC
  model's flax params (numpy leaves; the tree under ``params``) and returns
  the state_dict that ``tpu_speech_torch.models.diffvc.DiffVC`` (and the
  reference DiffVC/model/vc.py ``DiffVC``) load;
- ``speaker_encoder_from_jax(tree)`` does the same for the GE2E speaker
  encoder: ``tree`` is ``{"params": {"lstm", "linear"}}``, with the GE2E
  scalars under ``"ge2e"`` when the tree came from a reference checkpoint.
  Without them ``similarity_weight``/``similarity_bias`` take the
  reference's initial values (10, -5): they score GE2E training only;
- ``fwd_diffusion_from_jax(params, n_layers)`` and ``fwd_diffusion_to_jax(
  state_dict, n_layers)``: the average-voice encoder alone (DiffVC's stage
  1), the flax ``FwdDiffusion`` tree ``{"encoder", "postnet"}`` against the
  reference ``FwdDiffusion`` state_dict;
- ``ge2e_from_jax(state)`` and ``ge2e_to_jax(state_dict)``: the GE2E
  training state's parameters, ``{"model", "sim_weight", "sim_bias"}`` (the
  scalars 0-d in JAX, shape [1] in the port) against the port's
  ``SpeakerEncoder`` state_dict.

The layouts are ``compat/jax_gradtts.py``'s (flax Dense -> Linear, k=1
Conv1d or 1x1 Conv2d; conv2d kernel (kh, kw, in, out) -> (out, in, kh, kw);
GroupNorm and InstanceNorm scale/bias -> weight/bias); LSTM weights keep
torch's (4H, in) layout and (i, f, g, o) gate order. Both converters are
strict: every leaf of the tree is consumed exactly once, and every key of
the port's module is filled. ``.npz`` files are read with
``compat/jax_spiral.py::load_jax_npz``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tpu_speech_torch.compat.jax_gradtts import (
    _conv2d,
    _dense_conv,
    _groupnorm,
    _prenet_transformer,
    _unet,
    _unwrap,
)
from tpu_speech_torch.compat.jax_spiral import _Tree, _dense, _t

GE2E_INIT = {"similarity_weight": 10.0, "similarity_bias": -5.0}


def _check_consumed(tr: _Tree) -> None:
    leftover = tr.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")


def _fwd_diffusion(tr, sd, n_layers, path=(), key=""):
    """FwdDiffusion (the average-voice encoder) under flax path ``path`` ->
    keys ``{key}encoder.*`` and ``{key}postnet.*``."""
    p, k = path + ("encoder",), f"{key}encoder"
    _dense_conv(tr, p + ("init_proj",), sd, f"{k}.init_proj", 3)
    _prenet_transformer(tr, p, sd, k, n_layers)
    _dense_conv(tr, p + ("term_proj",), sd, f"{k}.term_proj", 3)
    p, k = path + ("postnet",), f"{key}postnet"
    _dense_conv(tr, p + ("init_conv",), sd, f"{k}.init_conv", 4)
    for b in ("block1", "block2"):
        _conv2d(tr, p + (b, "conv"), sd, f"{k}.res_block.{b}.block.0")
        _groupnorm(tr, p + (b, "norm"), sd, f"{k}.res_block.{b}.block.1")
    _dense_conv(tr, p + ("res",), sd, f"{k}.res_block.res", 4)
    _dense_conv(tr, p + ("final_conv",), sd, f"{k}.final_conv", 4)


def _estimator_vc(tr, sd, use_ref_t):
    """GradLogPEstimatorVC -> ``decoder.estimator.*``."""
    p, k = ("estimator",), "decoder.estimator"
    _dense(tr, p + ("mlp_0",), sd, f"{k}.mlp.0")
    _dense(tr, p + ("mlp_1",), sd, f"{k}.mlp.2")
    _dense(tr, p + ("cond_block_0",), sd, f"{k}.cond_block.0")
    _dense(tr, p + ("cond_block_1",), sd, f"{k}.cond_block.2")
    if use_ref_t:
        rp, rk = p + ("ref_block",), f"{k}.ref_block"
        _dense(tr, rp + ("mlp1",), sd, f"{rk}.mlp1.1")
        _dense(tr, rp + ("mlp2",), sd, f"{rk}.mlp2.1")
        for b in ("block11", "block12", "block21", "block22", "block31", "block32"):
            _conv2d(tr, rp + (b, "conv"), sd, f"{rk}.{b}.0")
            _groupnorm(tr, rp + (b, "norm"), sd, f"{rk}.{b}.1")  # InstanceNorm2d(affine)
        _dense_conv(tr, rp + ("final_conv",), sd, f"{rk}.final_conv", 4)
    _unet(tr, p, sd, k)


def diffvc_from_jax(params: Mapping, n_enc_layers: int = 6, use_ref_t: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """DiffVC flax params -> reference-named torch state_dict."""
    tr = _Tree(_unwrap(params), "params")
    sd: Dict[str, torch.Tensor] = {}
    _fwd_diffusion(tr, sd, n_enc_layers, ("encoder",), "encoder.")
    _estimator_vc(tr, sd, use_ref_t)
    _check_consumed(tr)
    return sd


def speaker_encoder_from_jax(tree: Mapping, num_layers: int = 3) -> Dict[str, torch.Tensor]:
    """SpeakerEncoder flax params (``{"params": ...}``, optionally with
    ``"ge2e"``) -> the reference's state_dict (``model_state``)."""
    unknown = set(tree) - {"params", "ge2e"}
    if unknown:
        raise ValueError(f"unexpected top-level keys: {sorted(unknown)}")
    tr = _Tree(tree["params"], "params")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(num_layers):
        for jax_name, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"lstm.{name}_l{i}"] = _t(tr.get("lstm", f"{jax_name}_l{i}"))
    _dense(tr, ("linear",), sd, "linear")
    _check_consumed(tr)
    if "ge2e" in tree:
        ge = _Tree(tree["ge2e"], "ge2e")
        for name in GE2E_INIT:
            sd[name] = _t(ge.get(name)).reshape(1)
        _check_consumed(ge)
    else:
        for name, value in GE2E_INIT.items():
            sd[name] = torch.tensor([value], dtype=torch.float32)
    return sd


def fwd_diffusion_from_jax(params: Mapping, n_layers: int = 6) -> Dict[str, torch.Tensor]:
    """FwdDiffusion flax params (``{"encoder", "postnet"}``, with or without
    its top ``params`` key) -> the reference ``FwdDiffusion`` state_dict."""
    tr = _Tree(_unwrap(params), "params")
    sd: Dict[str, torch.Tensor] = {}
    _fwd_diffusion(tr, sd, n_layers)
    _check_consumed(tr)
    return sd


class _TorchTree:
    """The other direction's reader: takes each key of a state_dict once
    and writes numpy leaves into a nested dict."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor]):
        self.left, self.tree = dict(state_dict), {}

    def take(self, key: str) -> np.ndarray:
        return self.left.pop(key).detach().cpu().numpy().astype(np.float32)

    def put(self, path, value) -> None:
        node = self.tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    def dense(self, path, key) -> None:
        """Linear, k=1 Conv1d or 1x1 Conv2d -> flax Dense (in, out)."""
        w = self.take(f"{key}.weight")
        self.put(path + ("kernel",), np.ascontiguousarray(w.reshape(w.shape[:2]).T))
        self.put(path + ("bias",), self.take(f"{key}.bias"))

    def conv(self, path, key, axes) -> None:
        self.put(path + ("kernel",), np.ascontiguousarray(self.take(f"{key}.weight")
                                                          .transpose(axes)))
        self.put(path + ("bias",), self.take(f"{key}.bias"))

    def norm(self, path, key, names) -> None:
        for jax_name, name in names:
            self.put(path + (jax_name,), self.take(f"{key}.{name}"))

    def done(self) -> dict:
        if self.left:
            raise ValueError(f"unconsumed torch keys: {sorted(self.left)[:8]}")
        return self.tree


_LAYERNORM = (("gamma", "gamma"), ("beta", "beta"))
_GROUPNORM = (("scale", "weight"), ("bias", "bias"))


def fwd_diffusion_to_jax(state_dict: Mapping[str, torch.Tensor], n_layers: int = 6) -> dict:
    """The reference ``FwdDiffusion`` state_dict -> its flax params
    ``{"encoder", "postnet"}`` (numpy leaves), as the JAX package's
    ``convert_fwd_diffusion`` gives them."""
    tt = _TorchTree(state_dict)
    p = ("encoder",)
    tt.dense(p + ("init_proj",), "encoder.init_proj")
    for i in range(3):
        tt.conv(p + ("prenet", f"conv_{i}"), f"encoder.prenet.conv_layers.{i}", (2, 1, 0))
        tt.norm(p + ("prenet", f"norm_{i}"), f"encoder.prenet.norm_layers.{i}", _LAYERNORM)
    tt.conv(p + ("prenet", "proj"), "encoder.prenet.proj", (2, 1, 0))
    enc, ek = p + ("encoder",), "encoder.encoder"
    for i in range(n_layers):
        for proj in ("conv_q", "conv_k", "conv_v", "conv_o"):
            tt.dense(enc + (f"attn_{i}", proj), f"{ek}.attn_layers.{i}.{proj}")
        for rel in ("emb_rel_k", "emb_rel_v"):
            if f"{ek}.attn_layers.{i}.{rel}" in tt.left:
                tt.put(enc + (f"attn_{i}", rel), tt.take(f"{ek}.attn_layers.{i}.{rel}"))
        tt.norm(enc + (f"norm1_{i}",), f"{ek}.norm_layers_1.{i}", _LAYERNORM)
        for c in ("conv_1", "conv_2"):
            tt.conv(enc + (f"ffn_{i}", c), f"{ek}.ffn_layers.{i}.{c}", (2, 1, 0))
        tt.norm(enc + (f"norm2_{i}",), f"{ek}.norm_layers_2.{i}", _LAYERNORM)
    tt.dense(p + ("term_proj",), "encoder.term_proj")
    p, k = ("postnet",), "postnet"
    tt.dense(p + ("init_conv",), f"{k}.init_conv")
    for b in ("block1", "block2"):
        tt.conv(p + (b, "conv"), f"{k}.res_block.{b}.block.0", (2, 3, 1, 0))
        tt.norm(p + (b, "norm"), f"{k}.res_block.{b}.block.1", _GROUPNORM)
    tt.dense(p + ("res",), f"{k}.res_block.res")
    tt.dense(p + ("final_conv",), f"{k}.final_conv")
    return tt.done()


def ge2e_from_jax(state: Mapping, num_layers: int = 3) -> Dict[str, torch.Tensor]:
    """The GE2E state's parameters (``{"model", "sim_weight", "sim_bias"}``,
    ``train/speaker_encoder.py::GE2EState``'s) -> the port's
    ``SpeakerEncoder`` state_dict."""
    unknown = set(state) - {"model", "sim_weight", "sim_bias"}
    if unknown:
        raise ValueError(f"unexpected top-level keys: {sorted(unknown)}")
    return speaker_encoder_from_jax(
        {"params": state["model"], "ge2e": {"similarity_weight": state["sim_weight"],
                                            "similarity_bias": state["sim_bias"]}}, num_layers)


def ge2e_to_jax(state_dict: Mapping[str, torch.Tensor], num_layers: int = 3) -> dict:
    """The port's ``SpeakerEncoder`` state_dict -> ``{"model", "sim_weight",
    "sim_bias"}`` with 0-d scalars (numpy leaves)."""
    tt = _TorchTree(state_dict)
    for i in range(num_layers):
        for jax_name, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            tt.put(("model", "lstm", f"{jax_name}_l{i}"), tt.take(f"lstm.{name}_l{i}"))
    tt.dense(("model", "linear"), "linear")
    tt.put(("sim_weight",), tt.take("similarity_weight").reshape(()))
    tt.put(("sim_bias",), tt.take("similarity_bias").reshape(()))
    return tt.done()
