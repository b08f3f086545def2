"""Checkpoint surgery: partial parameter loads and variable skipping.

The port's own copy of ``tpu_speech/utils/surgery.py`` (``SurgeryReport:29``,
``flatten_paths:48``, ``unflatten_paths:59``, ``merge_params:70``,
``parse_skip_vars:110``), the machinery behind ``--init_model_partial`` and
``--load_model_skip_var`` (SPIRAL/run_spiral.py:45-47). It acts on nested
mappings addressed by '/'-joined key paths; the leaves are numpy arrays or
tensors. The port's runners apply it to the flax-layout trees of
``compat/jax_spiral.py`` (``st2vec_to_jax``, ``ctc_finetune_to_jax``), so a
``--load_model_skip_var`` string matches the same paths in both packages.

- ``partial=False`` (the reference's ``strict=True``): every target leaf must
  be found in the source with a matching shape, or the load fails loudly.
- ``partial=True``: leaves present in both trees with matching shapes are
  loaded; everything else keeps its current value, and the report says
  exactly what happened.
- ``skip``: substring patterns; any target path containing one is left at
  its current value even if the source provides it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Sequence, Tuple


@dataclasses.dataclass
class SurgeryReport:
    loaded: List[str] = dataclasses.field(default_factory=list)
    skipped: List[str] = dataclasses.field(default_factory=list)
    missing: List[str] = dataclasses.field(default_factory=list)
    mismatched: List[str] = dataclasses.field(default_factory=list)
    unexpected: List[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (
            f"loaded {len(self.loaded)} vars"
            + (f", skipped {len(self.skipped)}" if self.skipped else "")
            + (f", kept-at-init {len(self.missing)}" if self.missing else "")
            + (f", shape-mismatch {len(self.mismatched)}" if self.mismatched else "")
            + (f", unexpected-in-ckpt {len(self.unexpected)}" if self.unexpected else "")
        )


def flatten_paths(tree: Any, prefix: str = "") -> dict:
    """Nested mapping -> {'a/b/c': leaf} (flax param addressing)."""
    out = {}
    if isinstance(tree, Mapping):
        for k in tree:
            out.update(flatten_paths(tree[k], f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def unflatten_paths(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def merge_params(target: Any, source: Any, partial: bool = False,
                 skip: Sequence[str] = ()) -> Tuple[dict, SurgeryReport]:
    """Merge ``source`` leaves into ``target`` by path; see the module doc.
    A loaded leaf is the source's leaf object itself."""
    tgt = flatten_paths(target)
    src = flatten_paths(source)
    patterns = tuple(p for p in skip if p)
    report = SurgeryReport()
    merged = {}
    for path, tval in tgt.items():
        if any(p in path for p in patterns):
            report.skipped.append(path)
            merged[path] = tval
            continue
        sval = src.get(path)
        if sval is None:
            report.missing.append(path)
            merged[path] = tval
            continue
        s_shape = tuple(getattr(sval, "shape", ()))
        t_shape = tuple(getattr(tval, "shape", ()))
        if s_shape != t_shape:
            report.mismatched.append(f"{path} ckpt{s_shape} != model{t_shape}")
            merged[path] = tval
            continue
        merged[path] = sval
        report.loaded.append(path)
    report.unexpected = sorted(set(src) - set(tgt))
    if not partial and (report.missing or report.mismatched):
        raise ValueError(
            "strict checkpoint load failed (pass --init_model_partial=true "
            "to allow a partial load): "
            f"missing={report.missing[:8]} mismatched={report.mismatched[:8]}"
        )
    return unflatten_paths(merged), report


def parse_skip_vars(spec: str) -> Tuple[str, ...]:
    """The reference's --load_model_skip_var string -> substring patterns
    (comma-separated; empty entries dropped)."""
    return tuple(s.strip() for s in spec.split(",") if s.strip())
