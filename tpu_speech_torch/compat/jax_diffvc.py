"""tpu_speech (JAX/flax) DiffVC and speaker-encoder trees -> reference-named
PyTorch state_dicts.

The inverses of ``tpu_speech/compat/torch_diffvc.py::convert_diffvc`` and
``torch_speaker_encoder.py::convert_speaker_encoder``:

- ``diffvc_from_jax(params, n_enc_layers, use_ref_t)`` takes the DiffVC
  model's flax params (numpy leaves; the tree under ``params``) and returns
  the state_dict that ``tpu_speech_torch.models.diffvc.DiffVC`` (and the
  reference DiffVC/model/vc.py ``DiffVC``) load;
- ``speaker_encoder_from_jax(tree)`` does the same for the GE2E speaker
  encoder: ``tree`` is ``{"params": {"lstm", "linear"}}``, with the GE2E
  scalars under ``"ge2e"`` when the tree came from a reference checkpoint.
  Without them ``similarity_weight``/``similarity_bias`` take the
  reference's initial values (10, -5): they score GE2E training only.

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


def _fwd_diffusion(tr, sd, n_layers):
    """FwdDiffusion (the average-voice encoder) -> ``encoder.*``."""
    p, k = ("encoder", "encoder"), "encoder.encoder"
    _dense_conv(tr, p + ("init_proj",), sd, f"{k}.init_proj", 3)
    _prenet_transformer(tr, p, sd, k, n_layers)
    _dense_conv(tr, p + ("term_proj",), sd, f"{k}.term_proj", 3)
    p, k = ("encoder", "postnet"), "encoder.postnet"
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
    _fwd_diffusion(tr, sd, n_enc_layers)
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

