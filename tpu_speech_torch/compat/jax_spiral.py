"""tpu_speech (JAX/flax) SPIRAL trees -> reference-named PyTorch state_dicts.

The inverses of ``tpu_speech/compat/torch_spiral.py``'s converters:

- ``ctc_finetune_from_jax(params, batch_stats)`` takes the CTC finetune
  model's flax trees (numpy leaves) and returns the state_dict that
  ``tpu_speech_torch.models.spiral.ctc.CTCFinetuneModel`` (and the reference
  PyTorch model) load, so that ``convert_ctc_finetune(state_dict)`` gives the
  trees back exactly;
- ``st2vec_from_jax(params, batch_stats, teacher)`` does the same for the
  pretraining model, ``ST2VecEncoder(cfg, pretraining=True)``, against
  ``convert_st2vec``.

Layout translation (flax channels-last -> torch channels-first):
- conv kernel (k, in, out)        -> Conv1d weight (out, in, k)
- dense kernel (in, out)          -> Linear weight (out, in)
- norm scale / bias               -> weight / bias
- pos conv v (k, in/g, out), g (k,) -> weight_v (out, in/g, k), weight_g (1, 1, k)
- BatchNorm batch_stats mean/var  -> running_mean / running_var
- decoder_proj kernel (C, V)      -> decoder_layers.0.weight (V, C, 1)
- ``block{B}_conv{C}`` / ``block{B}_transformer`` -> the interleaved
  ``feature_encoder.block_modules.{i}`` list

The converter is strict: every leaf of both trees is consumed exactly once.

``load_jax_npz`` reads trees saved as one ``.npz`` whose keys are
``params/<path>`` and ``batch_stats/<path>`` (and ``teacher/<path>`` for a
pretraining model) with ``/``-joined flax paths.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


class _Tree:
    """Leaf reader over a nested dict that records what was consumed."""

    def __init__(self, tree: Mapping, name: str):
        self.tree, self.name, self.used = tree, name, set()

    def has(self, *path) -> bool:
        node = self.tree
        for k in path:
            if not isinstance(node, Mapping) or k not in node:
                return False
            node = node[k]
        return True

    def get(self, *path) -> np.ndarray:
        node = self.tree
        for k in path:
            node = node[k]
        if path in self.used:
            raise ValueError(f"{self.name} leaf consumed twice: {'/'.join(path)}")
        self.used.add(path)
        return np.asarray(node)

    def leftover(self):
        def walk(node, pre):
            if isinstance(node, Mapping):
                for k, v in node.items():
                    yield from walk(v, pre + (k,))
            else:
                yield pre

        return sorted("/".join(p) for p in walk(self.tree, ()) if p not in self.used)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))  # a copy


def _conv(tr, path, sd, key):
    sd[f"{key}.weight"] = _t(np.transpose(tr.get(*path, "kernel"), (2, 1, 0)))
    if tr.has(*path, "bias"):
        sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def _dense(tr, path, sd, key):
    sd[f"{key}.weight"] = _t(np.transpose(tr.get(*path, "kernel"), (1, 0)))
    sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))


def _norm(tr, bs, path, sd, key):
    sd[f"{key}.weight"] = _t(tr.get(*path, "scale"))
    sd[f"{key}.bias"] = _t(tr.get(*path, "bias"))
    if bs.has(*path, "mean"):  # BatchNorm statistics
        sd[f"{key}.running_mean"] = _t(bs.get(*path, "mean"))
        sd[f"{key}.running_var"] = _t(bs.get(*path, "var"))
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _transformer(tr, path, sd, key):
    v = tr.get(*path, "pos_conv", "v")
    sd[f"{key}.pos_conv.0.weight_v"] = _t(np.transpose(v, (2, 1, 0)))
    sd[f"{key}.pos_conv.0.weight_g"] = _t(
        tr.get(*path, "pos_conv", "g").reshape(1, 1, -1))
    sd[f"{key}.pos_conv.0.bias"] = _t(tr.get(*path, "pos_conv", "bias"))
    j = 0
    while tr.has(*path, f"layer_{j}"):
        lp, lk = path + (f"layer_{j}",), f"{key}.layers.{j}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(tr, lp + ("self_attn", proj), sd, f"{lk}.self_attn.{proj}")
        _dense(tr, lp + ("fc1",), sd, f"{lk}.fc1")
        _dense(tr, lp + ("fc2",), sd, f"{lk}.fc2")
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{lk}.{ln}.weight"] = _t(tr.get(*lp, ln, "scale"))
            sd[f"{lk}.{ln}.bias"] = _t(tr.get(*lp, ln, "bias"))
        j += 1
    sd[f"{key}.layer_norm.weight"] = _t(tr.get(*path, "layer_norm", "scale"))
    sd[f"{key}.layer_norm.bias"] = _t(tr.get(*path, "layer_norm", "bias"))


def _feature_encoder(tr, bs, path, sd, key):
    node = tr.tree
    for k in path:
        node = node[k]
    pat = re.compile(r"block(\d+)_(?:conv(\d+)|(transformer))$")
    entries = []
    for name in node:
        m = pat.match(name)
        if m is None:
            raise ValueError(f"unexpected feature_encoder entry {name!r}")
        # a block's convs, in order, come before its transformer
        is_tf = m.group(3) is not None
        entries.append((int(m.group(1)), is_tf, 0 if is_tf else int(m.group(2)), name))
    for i, (_, is_tf, _, name) in enumerate(sorted(entries)):
        dst = f"{key}.block_modules.{i}"
        if is_tf:
            _transformer(tr, path + (name,), sd, dst)
        else:
            _conv(tr, path + (name, "conv"), sd, f"{dst}.conv.conv")
            _norm(tr, bs, path + (name, "norm"), sd, f"{dst}.norm")


def ctc_finetune_from_jax(params: Mapping, batch_stats: Mapping = None
                          ) -> Dict[str, torch.Tensor]:
    """CTC finetune flax trees -> reference-named torch state_dict."""
    tr = _Tree(params, "params")
    bs = _Tree(batch_stats or {}, "batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    _feature_encoder(tr, bs, ("encoder", "feature_encoder"), sd,
                     "encoder.feature_encoder")
    dec = ("decoder",)
    if tr.has(*dec, "proj_upsampling"):
        pu = dec + ("proj_upsampling",)
        _conv(tr, pu + ("proj",), sd, "decoder.proj_upsampling.proj.conv.conv")
        if tr.has(*pu, "norm"):
            _norm(tr, bs, pu + ("norm",), sd, "decoder.proj_upsampling.norm")
    i = 0
    while tr.has(*dec, f"conv_{i}"):
        cp = dec + (f"conv_{i}",)
        _conv(tr, cp + ("conv",), sd, f"decoder.conv_layers.{i}.conv.conv")
        if tr.has(*cp, "norm"):
            _norm(tr, bs, cp + ("norm",), sd, f"decoder.conv_layers.{i}.norm")
        i += 1
    w = tr.get(*dec, "decoder_proj", "kernel")  # (C, V)
    sd["decoder.decoder_layers.0.weight"] = _t(np.transpose(w, (1, 0))[:, :, None])
    sd["decoder.decoder_layers.0.bias"] = _t(tr.get(*dec, "decoder_proj", "bias"))
    leftover = tr.leftover() + bs.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")
    return sd


def _projector(tr, bs, path, sd, key):
    i = 0
    while tr.has(*path, f"conv{i}"):
        cp = path + (f"conv{i}",)
        _conv(tr, cp + ("conv",), sd, f"{key}.conv_layers.{i}.conv.conv")
        _norm(tr, bs, cp + ("norm",), sd, f"{key}.conv_layers.{i}.norm")
        i += 1
    _dense(tr, path + ("output_proj",), sd, f"{key}.output_proj")


def st2vec_from_jax(params: Mapping, batch_stats: Mapping = None,
                    teacher: Mapping = None) -> Dict[str, torch.Tensor]:
    """ST2Vec pretraining flax trees (student params, BatchNorm stats, EMA
    teacher subtree) -> reference-named torch state_dict."""
    tr = _Tree(params, "params")
    bs = _Tree(batch_stats or {}, "batch_stats")
    te = _Tree(teacher or {}, "teacher")
    sd: Dict[str, torch.Tensor] = {}
    _feature_encoder(tr, bs, ("feature_encoder",), sd, "feature_encoder")
    _projector(tr, bs, ("projector",), sd, "projector")
    _projector(tr, bs, ("predictor",), sd, "predictor")
    if teacher:
        _feature_encoder(te, bs, ("feature_encoder",), sd, "target_feature_encoder")
        _projector(te, bs, ("projector",), sd, "target_projector")
    leftover = tr.leftover() + bs.leftover() + te.leftover()
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {leftover[:8]}")
    return sd


def load_jax_npz(path: str, roots=("params", "batch_stats")):
    """``.npz`` whose keys are ``<root>/<path>`` -> one nested dict of numpy
    arrays per name in ``roots`` (a root the file lacks gives ``{}``)."""
    trees = {r: {} for r in roots}
    with np.load(path) as z:
        for key in z.files:
            root, *rest = key.split("/")
            if root not in trees or not rest:
                raise ValueError(f"{path}: unexpected key {key!r}")
            node = trees[root]
            for k in rest[:-1]:
                node = node.setdefault(k, {})
            node[rest[-1]] = z[key]
    return tuple(trees[r] for r in roots)
