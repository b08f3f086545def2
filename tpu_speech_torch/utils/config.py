"""Config dataclasses and dotted-key overrides of the SPIRAL run configs.

The port's own copy of what it uses of ``tpu_speech/utils/config.py``
(``:16-336``): the dataclasses of a SPIRAL ``RunConfig`` tree, field for field
with the same defaults, ``apply_override`` / ``apply_overrides`` /
``parse_cli_override`` with the helpers they need, and
``load_yaml_experiment`` (a YAML experiment file: a ``base:`` config name and
a nested mapping of overrides), and the optimizers' parameter classes
(``AdamWParams``, ``AdamParams``, ``NovogradParams`` with the reference's
NovoGrad defaults, ``SGDParams``).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class AdamWParams:
    name: str = "adamw"
    lr: float = 1e-3
    eps: float = 1e-6
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.01
    sched: Optional["SchedParams"] = None


@dataclasses.dataclass
class AdamParams:
    name: str = "adam"
    lr: float = 1e-3
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.0
    sched: Optional["SchedParams"] = None


@dataclasses.dataclass
class NovogradParams:
    """Reference core/optim/novograd.py defaults."""
    name: str = "novograd"
    lr: float = 1e-2
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.95, 0.25)
    weight_decay: float = 0.0
    sched: Optional["SchedParams"] = None


@dataclasses.dataclass
class SGDParams:
    name: str = "sgd"
    lr: float = 1e-2
    momentum: float = 0.0
    weight_decay: float = 0.0
    sched: Optional["SchedParams"] = None


@dataclasses.dataclass
class SchedParams:
    name: str = "CosineAnnealing"
    warmup_steps: int = 0
    warmup_ratio: Optional[float] = None
    hold_ratio: Optional[float] = None
    max_steps: int = 100000
    min_lr: float = 0.0
    d_model: int = 512  # NoamAnnealing only


@dataclasses.dataclass
class AudioDatasetConfig:
    manifest_filepath: str = ""
    sample_rate: int = 16000
    batch_size: int = 24
    min_duration: float = 0.0
    max_duration: Optional[float] = None
    crop_size: Optional[int] = None
    shuffle: bool = True
    num_workers: int = 4
    noise_manifest: Optional[str] = None
    # tar-shard streaming variant (audio_to_text.py:798+); when set, the
    # manifest provides metadata and audio streams from these tar files
    tarred_audio_filepaths: Optional[str] = None
    shuffle_n: int = 0
    dup_factor: int = 1  # duplicate entries (reference dev_data_dup_factor)
    # duration-bucketed static batching (CTC finetune): pad each batch to its
    # bucket's bound instead of max_duration; k compiled programs, ~2x less
    # padded compute on LibriSpeech-shaped data (data/loader.py:
    # BucketedDataLoader). 1 = single static shape (reference-equivalent)
    num_buckets: int = 1
    # native C++/OpenMP batch prep (read+crop+SNR-mix+collate fused, GIL
    # released; data/native_pipeline.py). Auto-falls back to the Python path
    # when the library can't build or the augmentor isn't expressible.
    use_native_loader: bool = True
    # host->device waveform wire format: 'int16' ships source-PCM samples
    # (half the H2D payload; bit-exact for unaugmented audio, <=0.5 LSB
    # re-quantization for augmented — train/spiral.py::quantize_wire_int16)
    # and the jitted step converts on device; 'float32' ships the loader's
    # floats unchanged (the reference DataLoader behavior); 'mulaw' ships
    # 8-bit G.711-style companding (LOSSY ~38 dB SNR, quarter payload —
    # opt-in for pathologically link-bound hosts;
    # train/spiral.py::quantize_wire_mulaw).
    wire_dtype: str = "int16"


@dataclasses.dataclass
class DecoderConfig:
    """ConvASRDecoder layout (reference ConvASRDecoderConfig,
    modules/conv_asr.py:214-360): conv stack + 1x1 vocab projection, with the
    char recipes adding 4x ProjUpsampling and an appended blank."""
    conv_layers: Any = None          # Tuple[ConvLayerCfg, ...]; None = default
    upsample_rate: Optional[int] = None
    upsample_filters: int = 512
    upsample_norm: Optional[str] = "ln"      # ProjUpsampling norm_type
    upsample_act: Optional[str] = "relu"     # ProjUpsampling act_func
    upsample_dropout: float = 0.1
    blank_pos: str = "vocab_first"   # or 'after_vocab_last'


@dataclasses.dataclass
class NoisePerturbConfig:
    """RandomNoisePerturbation recipe knobs (reference NoisePerturbConfig,
    spiral_base_pretrain_ls960_noise.py:214-223). manifest_path: JSON-lines
    noise manifest(s) (the reference uses a csv; format differs, role same)."""
    manifest_path: str = ""
    min_snr_db: float = 0.0
    max_snr_db: float = 30.0
    ratio: float = 0.5
    target_sr: int = 16000
    cache_noise: bool = True


@dataclasses.dataclass
class TrainerConfig:
    devices: int = -1  # -1: all visible
    max_epochs: int = 100
    max_steps: Optional[int] = None
    accumulate_grad_batches: int = 1
    # sequence parallelism: shard the time axis of activations over a 'seq'
    # mesh axis (parallel.mesh.seq_constrainer); devices must be divisible
    seq_parallel: int = 1
    # ZeRO-3-style parameter/optimizer-state sharding over the 'data' axis
    # (parallel.mesh.shard_state_fsdp) — per-chip state memory scales down
    # ~linearly with the mesh; the reference (DDP) has no equivalent
    fsdp: bool = False
    log_every_n_steps: int = 50
    val_check_interval_epochs: int = 4


@dataclasses.dataclass
class ExpManagerConfig:
    name: str = "exp"
    explicit_log_dir: Optional[str] = None
    resume_if_exists: bool = True
    save_top_k: int = 5


@dataclasses.dataclass
class SpiralModelConfig:
    encoder: Any = None                 # ST2VecConfig
    optim: AdamWParams = dataclasses.field(default_factory=AdamWParams)
    train_ds: AudioDatasetConfig = dataclasses.field(default_factory=AudioDatasetConfig)
    validation_ds: Optional[AudioDatasetConfig] = None
    test_ds: Optional[AudioDatasetConfig] = None
    expected_gpu_num: int = 1
    logit_temp: float = 0.3
    labels: Optional[Sequence[str]] = None
    tokenizer_file: Optional[str] = None
    decoder: Optional[DecoderConfig] = None
    noise_perturb: Optional[NoisePerturbConfig] = None
    freeze_finetune_updates: int = 0
    pretrain_chkpt_path: Optional[str] = None
    use_teacher_encoder: bool = False
    grad_clip: Optional[float] = None
    precision: str = "fp32"  # 'fp32' | 'bf16' (mixed: params/opt fp32, compute bf16)
    # 'rbg' = XLA hardware bit generator (measured ~21 ms/step cheaper than
    # threefry at SPIRAL-base B=24 — dropout mask bits dominate); 'threefry'
    # = jax default splittable stream (bit-reproducible across backends)
    rng_impl: str = "rbg"


@dataclasses.dataclass
class RunConfig:
    name: str = "st2vec"
    model: SpiralModelConfig = dataclasses.field(default_factory=SpiralModelConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    exp_manager: ExpManagerConfig = dataclasses.field(default_factory=ExpManagerConfig)


def _field_types(obj) -> dict:
    """Resolved type hints of a dataclass instance (annotations are strings
    under `from __future__ import annotations`)."""
    try:
        return typing.get_type_hints(type(obj))
    except Exception:
        return {f.name: Any for f in dataclasses.fields(obj)}


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value, tp):
    tp = _unwrap_optional(tp)
    if value is None or tp is Any:
        return value
    origin = typing.get_origin(tp)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(tp)
        if args and args[-1] is not Ellipsis and len(args) == len(value):
            return tuple(_coerce(v, a) for v, a in zip(value, args))
        elt = args[0] if args else Any
        return tuple(_coerce(v, elt) for v in value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        args = typing.get_args(tp)
        return [_coerce(v, args[0] if args else Any) for v in value]
    if tp is float and isinstance(value, int) and not isinstance(value, bool):
        return float(value)
    if tp is bool and isinstance(value, str):
        return value.lower() in ("true", "1", "yes")
    if tp in (int, float, str) and isinstance(value, tp):
        return value
    return value


def apply_override(cfg, dotted_key: str, value):
    """Set `cfg.<dotted.key> = value` with struct validation + coercion.

    Intermediate None dataclass fields (e.g. Optional[AudioDatasetConfig])
    are default-constructed on the way down.
    """
    obj = cfg
    parts = dotted_key.split(".")
    for i, part in enumerate(parts[:-1]):
        if not dataclasses.is_dataclass(obj) or not hasattr(obj, part):
            raise KeyError(
                f"unknown config key '{'.'.join(parts[: i + 1])}' "
                f"(struct mode; valid: "
                f"{sorted(f.name for f in dataclasses.fields(obj))})"
            )
        child = getattr(obj, part)
        if child is None:
            tp = _unwrap_optional(_field_types(obj).get(part, Any))
            if dataclasses.is_dataclass(tp):
                child = tp()
                setattr(obj, part, child)
            else:
                raise KeyError(
                    f"cannot descend into '{'.'.join(parts[: i + 1])}': "
                    f"value is None and field type {tp!r} is not a dataclass"
                )
        obj = child
    leaf = parts[-1]
    if not dataclasses.is_dataclass(obj) or leaf not in {
        f.name for f in dataclasses.fields(obj)
    }:
        raise KeyError(
            f"unknown config key '{dotted_key}' (struct mode; valid leaves: "
            f"{sorted(f.name for f in dataclasses.fields(obj)) if dataclasses.is_dataclass(obj) else '?'})"
        )
    current = getattr(obj, leaf)
    if dataclasses.is_dataclass(current) and isinstance(value, dict):
        apply_overrides(current, value)
        return
    setattr(obj, leaf, _coerce(value, _field_types(obj).get(leaf, Any)))


def apply_overrides(cfg, mapping: dict, prefix: str = ""):
    """Overlay a nested mapping onto a dataclass config tree. Each leaf goes
    through apply_override so struct validation reports full dotted paths
    (and intermediate None dataclass fields get default-constructed)."""
    for k, v in mapping.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            apply_overrides(cfg, v, prefix=f"{key}.")
        else:
            apply_override(cfg, key, v)


def parse_cli_override(spec: str):
    """'model.optim.lr=3e-3' -> ('model.optim.lr', 3e-3) with YAML scalar
    parsing (the hydra overrides_str analog, reference run_spiral.py:127)."""
    import yaml

    if "=" not in spec:
        raise ValueError(f"override '{spec}' must be KEY=VALUE")
    key, raw = spec.split("=", 1)
    value = yaml.safe_load(raw)
    if isinstance(value, str):
        # YAML 1.1 reads '3e-3' (no dot) as a string; users mean a float
        try:
            value = float(value)
        except ValueError:
            pass
    return key.strip(), value


def load_yaml_experiment(path: str):
    """Parse a YAML experiment file -> (base config name, overrides dict)
    (``load_yaml_experiment:294``)::

        base: spiral_base_pretrain_ls960   # the config to compose
        model:
          optim:
            lr: 0.003
        trainer:
          max_steps: 200000
    """
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: YAML experiment file must be a mapping")
    base = doc.pop("base", None)
    if base is None:
        raise ValueError(
            f"{path}: YAML experiment file needs a 'base:' python config "
            "module to compose from"
        )
    return base, doc
