"""Self-contained model archives, ``.tpu_speech`` files, in both directions.

The port's own copy of ``tpu_speech/utils/archive.py`` (``_to_jsonable:136``,
``config_object:161``, ``save_archive:185``, ``load_archive:206``) with the
same tar layout: ``config.json`` (the run config, every dataclass level
tagged with its class), ``params.msgpack`` and ``<name>.msgpack`` for each
extra tree (``teacher``, ``batch_stats``), the trees in flax's msgpack
encoding through the port's codec (``utils/msgpack.py``). The trees are the
JAX package's flax trees (``compat/jax_spiral.py``'s ``*_to_jax`` give them
from the port's models), so an archive either package writes, the other
reads.

The ``__dataclass__`` tags are written in the JAX package's namespace (a
port class ``tpu_speech_torch.X.C`` is tagged ``tpu_speech.X.C``), so that
JAX's ``config_object`` rebuilds them. On reading, the prefix
``tpu_speech.`` is mapped to ``tpu_speech_torch.`` before the module is
imported: the port never imports a ``tpu_speech.`` module name, and refuses
any tag outside the two packages.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import os
import tarfile
import time
from typing import Any, Dict, Tuple

from tpu_speech_torch.utils import msgpack

JAX_PREFIX = "tpu_speech."
PORT_PREFIX = "tpu_speech_torch."


def _tag(cls) -> str:
    """The ``__dataclass__`` tag of a class, in the JAX package's namespace."""
    name = cls.__module__ + "." + cls.__qualname__
    if name.startswith(PORT_PREFIX):
        name = JAX_PREFIX + name[len(PORT_PREFIX):]
    return name


def _to_jsonable(o: Any) -> Any:
    """Recursively encode a config tree, tagging every dataclass level with
    its class (in the JAX package's namespace) so ``config_object`` can
    rebuild the exact dataclass composition."""
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        d: Dict[str, Any] = {"__dataclass__": _tag(type(o))}
        for f in dataclasses.fields(o):
            d[f.name] = _to_jsonable(getattr(o, f.name))
        return d
    if isinstance(o, (list, tuple)):
        return [_to_jsonable(x) for x in o]
    if isinstance(o, dict):
        return {str(k): _to_jsonable(v) for k, v in o.items()}
    if isinstance(o, (str, int, float, bool)) or o is None:
        return o
    return str(o)


def _cfg_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2)


def _port_class(tag: str):
    """The port's class for a tag: ``tpu_speech.X.C`` -> ``tpu_speech_torch.X.C``."""
    module, _, qualname = tag.rpartition(".")
    if module.startswith(JAX_PREFIX):
        module = PORT_PREFIX + module[len(JAX_PREFIX):]
    elif not module.startswith(PORT_PREFIX):
        raise ValueError(f"archive config: class {tag!r} is outside the tpu_speech packages")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    return cls


def config_object(config: Any) -> Any:
    """Inverse of ``_to_jsonable``: rebuild the port's dataclass config tree
    from an archive's config.json dict (the ``--use_chkpt_hparams`` load
    path). JSON lists inside a dataclass come back as tuples (the config
    trees hold sequences as tuples, and the frozen model configs hash)."""
    if isinstance(config, dict):
        target = config.get("__dataclass__")
        kwargs = {k: config_object(v) for k, v in config.items() if k != "__dataclass__"}
        if target is None:
            return kwargs
        cls = _port_class(target)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in kwargs.items() if k in fields})
    if isinstance(config, list):
        return [config_object(v) for v in config]
    return config


def save_archive(path: str, config: Any, params: Any,
                 extra: Dict[str, Any] | None = None) -> None:
    """Write the tar archive: config.json + params.msgpack (+ extra trees).
    The trees are nested dicts of numpy arrays or tensors."""
    members = {
        "config.json": _cfg_to_json(config).encode("utf-8"),
        "params.msgpack": msgpack.packb(params),
    }
    for name, tree in (extra or {}).items():
        members[f"{name}.msgpack"] = msgpack.packb(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with tarfile.open(path, "w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))


def read_config(path: str) -> dict:
    """An archive's config.json as a dict."""
    with tarfile.open(path, "r") as tar:
        return json.loads(tar.extractfile("config.json").read().decode("utf-8"))


def load_archive(path: str) -> Tuple[Dict, Any, Dict]:
    """Read an archive -> (config dict, params tree, {name: extra tree})."""
    with tarfile.open(path, "r") as tar:
        names = tar.getnames()
        config = json.loads(tar.extractfile("config.json").read().decode("utf-8"))
        params = msgpack.unpackb(tar.extractfile("params.msgpack").read())
        extra = {}
        for name in names:
            if name.endswith(".msgpack") and name != "params.msgpack":
                extra[name[:-8]] = msgpack.unpackb(tar.extractfile(name).read())
    return config, params, extra
