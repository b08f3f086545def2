"""tpu_speech (JAX/flax) HiFi-GAN trees <-> reference-named PyTorch
state_dicts, for training: the discriminators both ways and the generator
to JAX (``compat/jax_gradtts.py::hifigan_from_jax`` goes the other way).

- ``mpd_from_jax`` / ``mpd_to_jax``: ``MultiPeriodDiscriminator``; flax
  ``disc_{p}/conv_{i}_kernel`` (k, 1, in, out) HWIO <-> ``discriminators.{n}
  .convs.{i}.weight`` (out, in, k, 1) OIHW, the n-th period in ascending
  order; ``conv_4`` is ``convs.4`` and ``conv_post`` is ``conv_post``;
- ``msd_from_jax`` / ``msd_to_jax``: ``MultiScaleDiscriminator``; flax
  ``disc_{i}/conv_{j}/kernel`` (k, in/g, out) <-> ``discriminators.{i}
  .convs.{j}.weight`` (out, in/g, k);
- ``hifigan_to_jax``: the generator's reference-named state_dict (plain
  weights; fold a weight-norm checkpoint first) -> its flax params, the
  inverse of ``hifigan_from_jax``.

Every converter is strict: a leaf or tensor it does not consume raises.
The trees are taken and returned without their top ``params`` key.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from tpu_speech_torch.compat.jax_gradtts import _unwrap
from tpu_speech_torch.compat.jax_spiral import _StateDict, _Tree, _conv, _conv_to, _put, _t


def _strict(reader, what: str) -> None:
    leftover = reader.leftover()
    if leftover:
        raise ValueError(f"unconsumed {what}: {leftover[:8]}")


def _count(has, fmt: str) -> int:
    n = 0
    while has(fmt.format(n)):
        n += 1
    return n


def mpd_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MultiPeriodDiscriminator flax params -> reference-named state_dict."""
    tree = _unwrap(params)
    tr = _Tree(tree, "params")
    periods = sorted(int(re.fullmatch(r"disc_(\d+)", k).group(1)) for k in tree)
    sd: Dict[str, torch.Tensor] = {}
    for n, p in enumerate(periods):
        d, key = f"disc_{p}", f"discriminators.{n}"
        for i in range(_count(lambda name: tr.has(d, name), "conv_{}_kernel")):
            sd[f"{key}.convs.{i}.weight"] = _t(np.transpose(tr.get(d, f"conv_{i}_kernel"),
                                                            (3, 2, 0, 1)))
            sd[f"{key}.convs.{i}.bias"] = _t(tr.get(d, f"conv_{i}_bias"))
        sd[f"{key}.conv_post.weight"] = _t(np.transpose(tr.get(d, "conv_post_kernel"),
                                                        (3, 2, 0, 1)))
        sd[f"{key}.conv_post.bias"] = _t(tr.get(d, "conv_post_bias"))
    _strict(tr, "JAX leaves")
    return sd


def msd_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """MultiScaleDiscriminator flax params -> reference-named state_dict."""
    tr = _Tree(_unwrap(params), "params")
    sd: Dict[str, torch.Tensor] = {}
    for i in range(_count(tr.has, "disc_{}")):
        d, key = f"disc_{i}", f"discriminators.{i}"
        for j in range(_count(lambda name: tr.has(d, name), "conv_{}")):
            _conv(tr, (d, f"conv_{j}"), sd, f"{key}.convs.{j}")
        _conv(tr, (d, "conv_post"), sd, f"{key}.conv_post")
    _strict(tr, "JAX leaves")
    return sd


def mpd_to_jax(state_dict: Mapping, periods=(2, 3, 5, 7, 11)) -> Dict:
    """MultiPeriodDiscriminator state_dict -> flax params; ``periods`` in
    the module's order (the state_dict does not hold them)."""
    sd = _StateDict(state_dict)
    tree: Dict = {}
    for n, p in enumerate(periods):
        d, key = f"disc_{p}", f"discriminators.{n}"
        for i in range(_count(lambda k: sd.has(k), key + ".convs.{}.weight")):
            _put(tree, (d, f"conv_{i}_kernel"),
                 np.transpose(sd.get(f"{key}.convs.{i}.weight"), (2, 3, 1, 0)))
            _put(tree, (d, f"conv_{i}_bias"), sd.get(f"{key}.convs.{i}.bias"))
        _put(tree, (d, "conv_post_kernel"),
             np.transpose(sd.get(f"{key}.conv_post.weight"), (2, 3, 1, 0)))
        _put(tree, (d, "conv_post_bias"), sd.get(f"{key}.conv_post.bias"))
    _strict(sd, "state_dict tensors")
    return tree


def msd_to_jax(state_dict: Mapping) -> Dict:
    """MultiScaleDiscriminator state_dict -> flax params (the meanpools hold
    no weights)."""
    sd = _StateDict(state_dict)
    tree: Dict = {}
    for i in range(_count(lambda k: sd.has(k), "discriminators.{}.conv_post.weight")):
        key = f"discriminators.{i}"
        for j in range(_count(lambda k: sd.has(k), key + ".convs.{}.weight")):
            _conv_to(sd, f"{key}.convs.{j}", tree, (f"disc_{i}", f"conv_{j}"))
        _conv_to(sd, f"{key}.conv_post", tree, (f"disc_{i}", "conv_post"))
    _strict(sd, "state_dict tensors")
    return tree


def hifigan_to_jax(state_dict: Mapping) -> Dict:
    """HiFi-GAN generator state_dict (plain weights) -> flax params. The
    upsampler count, the MRF kernel count and the resblock type are read
    from the state_dict."""
    sd = _StateDict(state_dict)
    tree: Dict = {}
    _conv_to(sd, "conv_pre", tree, ("conv_pre",))
    n_ups = _count(lambda k: sd.has(k), "ups.{}.weight")
    n_blocks = _count(lambda k: sd.has(k), "resblocks.{}.convs1.0.weight") or _count(
        lambda k: sd.has(k), "resblocks.{}.convs.0.weight")
    n_kernels = n_blocks // max(n_ups, 1)
    for i in range(n_ups):
        _put(tree, (f"ups_{i}", "kernel"), np.transpose(sd.get(f"ups.{i}.weight"), (2, 0, 1)))
        _put(tree, (f"ups_{i}", "bias"), sd.get(f"ups.{i}.bias"))
        for j in range(n_kernels):
            key, blk = f"resblocks.{i * n_kernels + j}", f"resblocks_{i}_{j}"
            names = ("convs1", "convs2") if sd.has(f"{key}.convs1.0.weight") else ("convs",)
            for name in names:
                for c in range(_count(lambda k: sd.has(k), f"{key}.{name}.{{}}.weight")):
                    _conv_to(sd, f"{key}.{name}.{c}", tree, (blk, f"{name}_{c}"))
    _conv_to(sd, "conv_post", tree, ("conv_post",))
    _strict(sd, "state_dict tensors")
    return tree
