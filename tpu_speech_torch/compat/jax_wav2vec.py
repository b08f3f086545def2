"""tpu_speech (JAX/flax) wav2vec 2.0 trees -> the port's state_dicts.

``wav2vec2_from_jax(params)`` takes a JAX ``Wav2Vec2Model``'s parameter tree
(numpy leaves) and returns the state_dict that
``tpu_speech_torch.models.spiral.wav2vec_model.Wav2Vec2Model`` loads;
``wav2vec2_ctc_from_jax(params)`` does the same for ``Wav2Vec2CTCModel``
(``encoder`` and ``decoder`` subtrees). The names are the reference's
fairseq/NeMo wav2vec 2.0 module names (see the model's docstring); the JAX
package has no torch converter for this family to mirror. The layouts
translate as in ``compat/jax_spiral.py``, whose helpers this module uses, and
the converter is strict: every leaf is consumed exactly once.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from tpu_speech_torch.compat.jax_spiral import _Tree, _conv, _decoder, _dense, _t, _transformer


def _wav2vec2(tr: _Tree, path, sd: Dict[str, torch.Tensor], key: str) -> None:
    pre = f"{key}." if key else ""
    fe = path + ("feature_extractor",)
    i = 0
    while tr.has(*fe, f"conv_{i}"):
        _conv(tr, fe + (f"conv_{i}",), sd, f"{pre}feature_extractor.conv_layers.{i}.0")
        for name, dst in ((f"ln_{i}", f"conv_layers.{i}.2.1"), (f"gn_{i}", f"conv_layers.{i}.2")):
            if tr.has(*fe, name):
                sd[f"{pre}feature_extractor.{dst}.weight"] = _t(tr.get(*fe, name, "scale"))
                sd[f"{pre}feature_extractor.{dst}.bias"] = _t(tr.get(*fe, name, "bias"))
        i += 1
    sd[f"{pre}layer_norm.weight"] = _t(tr.get(*path, "layer_norm", "scale"))
    sd[f"{pre}layer_norm.bias"] = _t(tr.get(*path, "layer_norm", "bias"))
    sd[f"{pre}mask_emb"] = _t(tr.get(*path, "mask_emb"))
    for dense in ("post_extract_proj", "project_q", "final_proj"):
        if tr.has(*path, dense):
            _dense(tr, path + (dense,), sd, f"{pre}{dense}")
    _transformer(tr, path + ("encoder",), sd, f"{pre}encoder")
    if tr.has(*path, "quantizer"):
        sd[f"{pre}quantizer.vars"] = _t(tr.get(*path, "quantizer", "vars"))
        _dense(tr, path + ("quantizer", "weight_proj"), sd, f"{pre}quantizer.weight_proj")


def _done(tr: _Tree, sd):
    leftover = tr.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")
    return sd


def wav2vec2_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``Wav2Vec2Model`` flax params -> the port's state_dict."""
    tr, sd = _Tree(params, "params"), {}
    _wav2vec2(tr, (), sd, "")
    return _done(tr, sd)


def wav2vec2_ctc_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``Wav2Vec2CTCModel`` flax params -> the port's state_dict."""
    tr, sd = _Tree(params, "params"), {}
    _wav2vec2(tr, ("encoder",), sd, "encoder")
    _decoder(tr, _Tree({}, "batch_stats"), ("decoder",), sd, "decoder")
    return _done(tr, sd)
