"""tpu_speech (JAX/flax) SPIRAL trees <-> reference-named PyTorch state_dicts.

The inverses of ``tpu_speech/compat/torch_spiral.py``'s converters:

- ``ctc_finetune_from_jax(params, batch_stats)`` takes the CTC finetune
  model's flax trees (numpy leaves) and returns the state_dict that
  ``tpu_speech_torch.models.spiral.ctc.CTCFinetuneModel`` (and the reference
  PyTorch model) load, so that ``convert_ctc_finetune(state_dict)`` gives the
  trees back exactly;
- ``st2vec_from_jax(params, batch_stats, teacher)`` does the same for the
  pretraining model, ``ST2VecEncoder(cfg, pretraining=True)``, against
  ``convert_st2vec``;
- ``ctc_finetune_to_jax(state_dict)`` and ``st2vec_to_jax(state_dict)`` go
  the other way: the port's state_dicts -> the JAX package's flax trees
  (``(params, batch_stats)`` and ``(params, batch_stats, teacher)``, numpy
  leaves), as ``convert_ctc_finetune`` / ``convert_st2vec`` give them. The
  port's ``.tpu_speech`` archives hold these trees, and its weight surgery
  (``utils/surgery.py``) addresses their paths, so ``--load_model_skip_var``
  matches the same strings in both packages. BatchNorm's
  ``num_batches_tracked`` has no flax counterpart: it is dropped going to JAX
  and 0 coming back (the port's BatchNorm has a momentum, so it never reads
  it).

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
from typing import Dict, Mapping, Tuple

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
        if torch.is_tensor(node):  # a bfloat16 leaf of an archive (exact in float32)
            return node.detach().float().numpy()
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


# ---- the other direction: port state_dicts -> flax trees --------------------

def _np_leaf(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy() if torch.is_tensor(t) else np.array(t)


class _StateDict:
    """Tensor reader over a state_dict that records what was consumed."""

    def __init__(self, sd: Mapping):
        self.sd, self.used = dict(sd), set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> np.ndarray:
        if key in self.used:
            raise ValueError(f"state_dict tensor consumed twice: {key}")
        self.used.add(key)
        return _np_leaf(self.sd[key])

    def leftover(self):
        return sorted(k for k in self.sd if k not in self.used
                      and not k.endswith(".num_batches_tracked"))


def _put(tree: Dict, path, value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    if path[-1] in node:
        raise ValueError(f"flax leaf written twice: {'/'.join(path)}")
    node[path[-1]] = value


def _conv_to(sd, key, tree, path):
    _put(tree, path + ("kernel",), np.transpose(sd.get(f"{key}.weight"), (2, 1, 0)))
    if sd.has(f"{key}.bias"):
        _put(tree, path + ("bias",), sd.get(f"{key}.bias"))


def _dense_to(sd, key, tree, path):
    _put(tree, path + ("kernel",), np.transpose(sd.get(f"{key}.weight"), (1, 0)))
    _put(tree, path + ("bias",), sd.get(f"{key}.bias"))


def _norm_to(sd, key, tree, bs, path):
    _put(tree, path + ("scale",), sd.get(f"{key}.weight"))
    _put(tree, path + ("bias",), sd.get(f"{key}.bias"))
    if sd.has(f"{key}.running_mean"):
        if bs is None:
            raise NotImplementedError(
                f"{key}: teacher BatchNorm statistics have no slot in the flax trees")
        _put(bs, path + ("mean",), sd.get(f"{key}.running_mean"))
        _put(bs, path + ("var",), sd.get(f"{key}.running_var"))


def _transformer_to(sd, key, tree, path):
    _put(tree, path + ("pos_conv", "g"), sd.get(f"{key}.pos_conv.0.weight_g").reshape(-1))
    _put(tree, path + ("pos_conv", "v"),
         np.transpose(sd.get(f"{key}.pos_conv.0.weight_v"), (2, 1, 0)))
    _put(tree, path + ("pos_conv", "bias"), sd.get(f"{key}.pos_conv.0.bias"))
    j = 0
    while sd.has(f"{key}.layers.{j}.self_attn.q_proj.weight"):
        lk, lp = f"{key}.layers.{j}", path + (f"layer_{j}",)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense_to(sd, f"{lk}.self_attn.{proj}", tree, lp + ("self_attn", proj))
        _dense_to(sd, f"{lk}.fc1", tree, lp + ("fc1",))
        _dense_to(sd, f"{lk}.fc2", tree, lp + ("fc2",))
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            _norm_to(sd, f"{lk}.{ln}", tree, None, lp + (ln,))
        j += 1
    _norm_to(sd, f"{key}.layer_norm", tree, None, path + ("layer_norm",))


def _feature_encoder_to(sd, key, tree, bs, path):
    """The interleaved ``block_modules`` list -> ``block{B}_conv{C}`` /
    ``block{B}_transformer``."""
    i, block, conv = 0, 0, 0
    while True:
        src = f"{key}.block_modules.{i}"
        if sd.has(f"{src}.conv.conv.weight"):
            dst = path + (f"block{block}_conv{conv}",)
            _conv_to(sd, f"{src}.conv.conv", tree, dst + ("conv",))
            _norm_to(sd, f"{src}.norm", tree, bs, dst + ("norm",))
            conv += 1
        elif sd.has(f"{src}.pos_conv.0.weight_v"):
            _transformer_to(sd, src, tree, path + (f"block{block}_transformer",))
            block, conv = block + 1, 0
        else:
            break
        i += 1
    if i == 0:
        raise ValueError(f"no block_modules under {key}")


def _projector_to(sd, key, tree, bs, path):
    i = 0
    while sd.has(f"{key}.conv_layers.{i}.conv.conv.weight"):
        cp = path + (f"conv{i}",)
        _conv_to(sd, f"{key}.conv_layers.{i}.conv.conv", tree, cp + ("conv",))
        _norm_to(sd, f"{key}.conv_layers.{i}.norm", tree, bs, cp + ("norm",))
        i += 1
    _dense_to(sd, f"{key}.output_proj", tree, path + ("output_proj",))


def _check_consumed(sd: _StateDict):
    leftover = sd.leftover()
    if leftover:
        raise ValueError(f"unconsumed state_dict tensors: {leftover[:8]}")


def ctc_finetune_to_jax(state_dict: Mapping) -> Tuple[Dict, Dict]:
    """The CTC finetune model's reference-named state_dict -> its flax trees
    ``(params, batch_stats)``."""
    sd = _StateDict(state_dict)
    params: Dict = {}
    bs: Dict = {}
    _feature_encoder_to(sd, "encoder.feature_encoder", params, bs,
                        ("encoder", "feature_encoder"))
    if sd.has("decoder.proj_upsampling.proj.conv.conv.weight"):
        _conv_to(sd, "decoder.proj_upsampling.proj.conv.conv", params,
                 ("decoder", "proj_upsampling", "proj"))
        if sd.has("decoder.proj_upsampling.norm.weight"):
            _norm_to(sd, "decoder.proj_upsampling.norm", params, bs,
                     ("decoder", "proj_upsampling", "norm"))
    i = 0
    while sd.has(f"decoder.conv_layers.{i}.conv.conv.weight"):
        cp = ("decoder", f"conv_{i}")
        _conv_to(sd, f"decoder.conv_layers.{i}.conv.conv", params, cp + ("conv",))
        if sd.has(f"decoder.conv_layers.{i}.norm.weight"):
            _norm_to(sd, f"decoder.conv_layers.{i}.norm", params, bs, cp + ("norm",))
        i += 1
    w = sd.get("decoder.decoder_layers.0.weight")  # (V, C, 1)
    _put(params, ("decoder", "decoder_proj", "kernel"), np.transpose(w[:, :, 0], (1, 0)))
    _put(params, ("decoder", "decoder_proj", "bias"), sd.get("decoder.decoder_layers.0.bias"))
    _check_consumed(sd)
    return params, bs


def st2vec_to_jax(state_dict: Mapping) -> Tuple[Dict, Dict, Dict]:
    """The pretraining model's reference-named state_dict -> its flax trees
    ``(params, batch_stats, teacher)`` (the teacher empty when the
    state_dict has no ``target_*`` towers)."""
    sd = _StateDict(state_dict)
    params: Dict = {}
    bs: Dict = {}
    teacher: Dict = {}
    _feature_encoder_to(sd, "feature_encoder", params, bs, ("feature_encoder",))
    for name in ("projector", "predictor"):
        if sd.has(f"{name}.output_proj.weight"):
            _projector_to(sd, name, params, bs, (name,))
    if sd.has("target_feature_encoder.block_modules.0.conv.conv.weight") or sd.has(
            "target_feature_encoder.block_modules.0.pos_conv.0.weight_v"):
        _feature_encoder_to(sd, "target_feature_encoder", teacher, None, ("feature_encoder",))
        _projector_to(sd, "target_projector", teacher, None, ("projector",))
    _check_consumed(sd)
    return params, bs, teacher


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
