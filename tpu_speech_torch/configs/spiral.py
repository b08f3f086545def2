"""SPIRAL experiment configs for the port (JAX-free twins of the cli configs).

The JAX experiment files under ``cli/conf/spiral/`` import flax through the
JAX model configs, so the port rebuilds the same RunConfig trees from its own
field-for-field twin dataclasses (``models/spiral/encoder.py``,
``models/spiral/st2vec.py``) and the port's copy of the run-config
dataclasses (``utils/config.py``).

``spiral_base_ctc_char()`` is ``cli/conf/spiral/spiral_base_finetune_ls100_char.py``
(with the helpers of ``cli/conf/spiral/_common.py``): SPIRAL-base encoder
with the finetune dropout bumps, the char CTC head (4x ProjUpsampling + 3
convs, blank after the 28-char vocab), test batches of 14 padded to 24 s.

``spiral_base_pretrain_ls960()`` is ``cli/conf/spiral/spiral_base_pretrain_ls960.py``
(SPIRAL-base ST2Vec pretraining: batch 24 x 250 000-sample crops, AdamW
3e-3 with 32k-step warmup and cosine decay, EMA momentum 0.995 -> 1.0);
``spiral_tiny_pretrain()`` is ``cli/conf/spiral/spiral_tiny_test.py``, the
CPU test size of the pretrain step.

``CONFIGS`` maps the ``--config_name`` values of the port's run_spiral CLI to
these functions (``spiral_tiny_test``, the JAX package's name, is
``spiral_tiny_pretrain``). The other experiment files of ``cli/conf/spiral/``
are not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses

from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    TransformerCfg,
)
from tpu_speech_torch.models.spiral.st2vec import ST2VecConfig, spiral_base_config
from tpu_speech_torch.text.tokenizers import DEFAULT_CHAR_LABELS
from tpu_speech_torch.utils.config import (
    AdamWParams,
    AudioDatasetConfig,
    DecoderConfig,
    ExpManagerConfig,
    RunConfig,
    SchedParams,
    SpiralModelConfig,
    TrainerConfig,
)


def spiral_base_pretrain_ls960() -> RunConfig:
    """``cli/conf/spiral/spiral_base_pretrain_ls960.py``."""
    max_steps = 200000
    model = SpiralModelConfig(
        encoder=spiral_base_config(target_momentum_steps=max_steps),
        optim=AdamWParams(
            lr=0.003, eps=1e-6, betas=(0.9, 0.98), weight_decay=0.01,
            sched=SchedParams(name="CosineAnnealing", warmup_steps=32000,
                              max_steps=max_steps, min_lr=0.0),
        ),
        train_ds=AudioDatasetConfig(
            manifest_filepath=(
                "manifest_json/librivox-train-clean-100.json,"
                "manifest_json/librivox-train-clean-360.json,"
                "manifest_json/librivox-train-other-500.json"
            ),
            sample_rate=16000, batch_size=24, min_duration=2.0,
            crop_size=250000, shuffle=True, num_workers=4,
        ),
        validation_ds=AudioDatasetConfig(
            manifest_filepath="manifest_json/librivox-dev-clean.json",
            sample_rate=16000, batch_size=24, min_duration=2.0,
            crop_size=250000, shuffle=False,
        ),
        test_ds=AudioDatasetConfig(
            manifest_filepath="manifest_json/librivox-test-clean.json",
            sample_rate=16000, batch_size=24, min_duration=2.0,
            crop_size=250000, shuffle=False,
        ),
        expected_gpu_num=16,
    )
    return RunConfig(
        name="st2vec", model=model,
        trainer=TrainerConfig(max_epochs=280, max_steps=max_steps),
        exp_manager=ExpManagerConfig(name="st2vec", save_top_k=5),
    )


def _tiny_blocks():
    """The blocks of ``cli/conf/spiral/spiral_tiny_test.py``: 16 mels, two
    one-layer 32-wide transformers."""
    return (
        ConvTransformerBlockCfg(
            conv_layers=(
                ConvLayerCfg(24, (5,), (2,), "ln", "relu", 0.0),
                ConvLayerCfg(32, (5,), (2,), "ln", "relu", 0.0),
            ),
            transformer=TransformerCfg(1, 32, 64, 4, 0.0, conv_pos=8,
                                       conv_pos_groups=4),
        ),
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(32, (5,), (2,), "ln", "relu", 0.0),),
            transformer=TransformerCfg(1, 32, 64, 4, 0.0, conv_pos=8,
                                       conv_pos_groups=4),
        ),
    )


def spiral_tiny_pretrain() -> RunConfig:
    """``cli/conf/spiral/spiral_tiny_test.py``: the tiny ST2Vec (16-wide
    projector, one BatchNorm predictor conv, 4 negatives) on 1 s crops,
    batch 2, 4 steps."""
    encoder = ST2VecConfig(
        blocks=_tiny_blocks(),
        num_features=16,
        projector_dim=16,
        predictor_convs=(ConvLayerCfg(16, (3,), (1,), "bn", "relu", 0.0, bias=None),),
        n_negatives=4,
        max_shift=2,
        target_momentum_steps=100,
    )
    model = SpiralModelConfig(
        encoder=encoder,
        labels=DEFAULT_CHAR_LABELS,
        freeze_finetune_updates=1,
        optim=AdamWParams(
            lr=1e-3,
            sched=SchedParams(name="CosineAnnealing", warmup_steps=2, max_steps=100),
        ),
        train_ds=AudioDatasetConfig(
            manifest_filepath="manifest.json", sample_rate=16000,
            batch_size=2, crop_size=16000, shuffle=True, num_workers=2,
            max_duration=1.0,
        ),
        validation_ds=AudioDatasetConfig(
            manifest_filepath="manifest.json", sample_rate=16000,
            batch_size=2, shuffle=False, max_duration=1.0,
        ),
        test_ds=AudioDatasetConfig(
            manifest_filepath="manifest.json", sample_rate=16000,
            batch_size=2, shuffle=False, max_duration=1.0,
        ),
    )
    return RunConfig(
        name="st2vec_tiny", model=model,
        trainer=TrainerConfig(max_epochs=1, max_steps=4, val_check_interval_epochs=1),
        exp_manager=ExpManagerConfig(name="st2vec_tiny"),
    )


def finetune_transformer_overrides(blocks, layerdrop_first=None,
                                   layerdrop_last=0.1):
    """Finetune-time regularization bumps (``_common.py:11``): transformer
    dropout/activation_dropout -> 0.1 on every block, layerdrop -> 0.1 on the
    last (and on the first for the large recipes)."""
    out = []
    for i, blk in enumerate(blocks):
        t = blk.transformer
        if t is not None:
            if i == len(blocks) - 1:
                ld = layerdrop_last
            elif layerdrop_first is not None:
                ld = layerdrop_first
            else:
                ld = t.encoder_layerdrop
            t = dataclasses.replace(
                t, dropout=0.1, activation_dropout=0.1, encoder_layerdrop=ld
            )
        out.append(dataclasses.replace(blk, transformer=t))
    return tuple(out)


def char_decoder(norm_type=None, filters=512) -> DecoderConfig:
    """Char CTC head (``_common.py:33``): 4x ProjUpsampling + 3 convs +
    appended blank."""
    return DecoderConfig(
        conv_layers=tuple(
            ConvLayerCfg(filters, (5,), (1,), norm_type, "relu", 0.1)
            for _ in range(3)
        ),
        upsample_rate=4,
        upsample_filters=filters,
        blank_pos="after_vocab_last",
    )


def finetune_run_config(config_name, encoder, decoder, labels=None,
                        train_manifest="manifest_json/librivox-train-clean-100.json",
                        batch_size=14, max_duration=24.0, max_steps=80000,
                        expected_gpu_num=8, freeze_finetune_updates=2000,
                        max_epochs=320, sample_rate=16000, lr=0.00003):
    """CTC finetune RunConfig skeleton (``_common.py:61``)."""
    model = SpiralModelConfig(
        encoder=encoder,
        labels=labels,
        decoder=decoder,
        freeze_finetune_updates=freeze_finetune_updates,
        optim=AdamWParams(
            lr=lr, eps=1e-6, betas=(0.9, 0.98), weight_decay=0.01,
            sched=SchedParams(
                name="PolynomialHoldDecayAnnealing", warmup_ratio=0.1,
                hold_ratio=0.4, max_steps=max_steps, min_lr=lr * 0.05,
            ),
        ),
        train_ds=AudioDatasetConfig(
            manifest_filepath=train_manifest,
            sample_rate=sample_rate, batch_size=batch_size, shuffle=True,
            max_duration=max_duration, num_workers=4,
        ),
        validation_ds=AudioDatasetConfig(
            manifest_filepath="manifest_json/librivox-dev-other.json",
            sample_rate=sample_rate, batch_size=batch_size, shuffle=False,
        ),
        test_ds=AudioDatasetConfig(
            manifest_filepath="manifest_json/librivox-test-clean.json",
            sample_rate=sample_rate, batch_size=batch_size, shuffle=False,
        ),
        expected_gpu_num=expected_gpu_num,
    )
    return RunConfig(
        name=config_name,
        model=model,
        trainer=TrainerConfig(max_epochs=max_epochs, max_steps=max_steps),
        exp_manager=ExpManagerConfig(name=config_name),
    )


def spiral_base_ctc_char() -> RunConfig:
    """``cli/conf/spiral/spiral_base_finetune_ls100_char.py``."""
    enc = spiral_base_config()
    encoder = dataclasses.replace(
        enc,
        blocks=finetune_transformer_overrides(enc.blocks),
        mask_prob=0.3,
        mask_length=4,
        mask_channel_prob=0.3,
        mask_channel_length=20,
    )
    return finetune_run_config(
        "ctc_finetune", encoder, char_decoder(norm_type=None),
        labels=DEFAULT_CHAR_LABELS,
        batch_size=14, max_duration=24.0, max_steps=80000,
        expected_gpu_num=8, freeze_finetune_updates=2000, max_epochs=320,
    )


def spiral_tiny_ctc_char() -> RunConfig:
    """The blocks of ``cli/conf/spiral/spiral_tiny_test.py`` (16 mels, two
    one-layer 32-wide transformers) with a 32-wide char head (4x
    upsampling): the CPU test size of the whole transcription path. Test
    batches of 2 padded to 1 s."""
    encoder = ST2VecConfig(blocks=_tiny_blocks(), num_features=16)
    cfg = finetune_run_config(
        "ctc_tiny", encoder, char_decoder(norm_type=None, filters=32),
        labels=DEFAULT_CHAR_LABELS, batch_size=2, max_duration=1.0,
        max_steps=4, expected_gpu_num=1, freeze_finetune_updates=0,
        max_epochs=1,
    )
    cfg.model.test_ds.num_workers = 1
    return cfg


CONFIGS = {
    "spiral_base_finetune_ls100_char": spiral_base_ctc_char,
    "spiral_tiny_ctc_char": spiral_tiny_ctc_char,
    "spiral_base_pretrain_ls960": spiral_base_pretrain_ls960,
    "spiral_tiny_pretrain": spiral_tiny_pretrain,
    "spiral_tiny_test": spiral_tiny_pretrain,  # the JAX package's name for it
}
