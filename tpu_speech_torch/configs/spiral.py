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

The other experiment files of ``cli/conf/spiral/`` under their own names:
the subword recipes (``subword_decoder``: two plain convs, the blank first;
``tokenizer_file`` names the sentencepiece model the JAX recipe names), the
noise recipes (``dns_noise``), the SPIRAL-large finetune recipes (char and
subword at LS-100 and LS-960) and Libri-Light pretraining, and
``spiral_toy_quality`` (the small learnable model of the toy corpus).

``CONFIGS`` maps the ``--config_name`` values of the port's run_spiral CLI to
these functions (``spiral_tiny_test``, the JAX package's name, is
``spiral_tiny_pretrain``); a YAML experiment file's ``base:`` resolves
against it too. The two streaming configs are
``spiral_base_finetune_ls100_char_streaming`` (SPIRAL-base char finetuning
with ``StreamingCfg(128, 2)``: 1.28 s chunks, two chunks of left context) and
``spiral_tiny_stream_test`` (the tiny config with ``StreamingCfg(32, 2)``).
"""

from __future__ import annotations

import dataclasses

from tpu_speech_torch.models.spiral.encoder import (
    ConvLayerCfg,
    ConvTransformerBlockCfg,
    StreamingCfg,
    TransformerCfg,
)
from tpu_speech_torch.models.spiral.st2vec import (
    ST2VecConfig,
    spiral_base_config,
    spiral_large_config,
)
from tpu_speech_torch.text.tokenizers import DEFAULT_CHAR_LABELS
from tpu_speech_torch.utils.config import (
    AdamWParams,
    AudioDatasetConfig,
    DecoderConfig,
    ExpManagerConfig,
    NoisePerturbConfig,
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


def subword_decoder() -> DecoderConfig:
    """Subword CTC head (``_common.py:49``): 2 plain convs, blank first."""
    return DecoderConfig(
        conv_layers=tuple(
            ConvLayerCfg(512, (5,), (1,), None, "relu", 0.1) for _ in range(2)
        ),
        blank_pos="vocab_first",
    )


def dns_noise(noise_dir: str = "/path/to/noise_data",
              sample_rate: int = 16000) -> NoisePerturbConfig:
    """Multi-condition training noise source (``_common.py:128``): point
    ``model.noise_perturb.manifest_path`` at a JSON-lines manifest of the DNS
    noise set."""
    return NoisePerturbConfig(
        manifest_path=noise_dir + "/noise/ms_dns_train.json",
        min_snr_db=0.0, max_snr_db=30.0, ratio=0.5,
        target_sr=sample_rate, cache_noise=True,
    )


def finetune_run_config(config_name, encoder, decoder, labels=None, tokenizer_file=None,
                        train_manifest="manifest_json/librivox-train-clean-100.json",
                        batch_size=14, max_duration=24.0, max_steps=80000,
                        expected_gpu_num=8, freeze_finetune_updates=2000,
                        max_epochs=320, noise_perturb=None, sample_rate=16000,
                        lr=0.00003):
    """CTC finetune RunConfig skeleton (``_common.py:61``)."""
    model = SpiralModelConfig(
        encoder=encoder,
        labels=labels,
        tokenizer_file=tokenizer_file,
        decoder=decoder,
        noise_perturb=noise_perturb,
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


def spiral_base_finetune_ls100_char_streaming() -> RunConfig:
    """``cli/conf/spiral/spiral_base_finetune_ls100_char_streaming.py``: the
    char recipe with a streaming-trainable encoder, 128 spec frames (1.28 s)
    a chunk and two chunks of left context."""
    enc = spiral_base_config(streaming=StreamingCfg(chunk_frames=128, left_chunks=2))
    encoder = dataclasses.replace(
        enc,
        blocks=finetune_transformer_overrides(enc.blocks),
        mask_prob=0.3,
        mask_length=4,
        mask_channel_prob=0.3,
        mask_channel_length=20,
    )
    return finetune_run_config(
        "ctc_finetune_streaming", encoder, char_decoder(norm_type=None),
        labels=DEFAULT_CHAR_LABELS,
        batch_size=14, max_duration=24.0, max_steps=80000,
        expected_gpu_num=8, freeze_finetune_updates=2000, max_epochs=320,
    )


def spiral_tiny_stream_test() -> RunConfig:
    """``cli/conf/spiral/spiral_tiny_stream_test.py``: the tiny config with a
    streaming encoder, 32 spec frames a chunk (4 encoder frames) and two
    chunks of left context."""
    cfg = spiral_tiny_pretrain()
    cfg.model.encoder = dataclasses.replace(
        cfg.model.encoder, streaming=StreamingCfg(chunk_frames=32, left_chunks=2))
    cfg.name = cfg.exp_manager.name = "st2vec_tiny_stream"
    return cfg


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


SPM_MODEL = "vocab_spm/spm_1k_libri_unigram_bos_mask.model"
LS960_TRAIN = ("manifest_json/librivox-train-clean-100.json,"
               "manifest_json/librivox-train-clean-360.json,"
               "manifest_json/librivox-train-other-500.json")


def _base_finetune_encoder():
    enc = spiral_base_config()
    return dataclasses.replace(
        enc, blocks=finetune_transformer_overrides(enc.blocks),
        mask_prob=0.3, mask_length=4, mask_channel_prob=0.3, mask_channel_length=20)


def spiral_base_finetune_ls100_subword() -> RunConfig:
    """``cli/conf/spiral/spiral_base_finetune_ls100_subword.py``."""
    return finetune_run_config(
        "ctc_finetune", _base_finetune_encoder(), subword_decoder(),
        tokenizer_file=SPM_MODEL, batch_size=14, max_duration=24.0, max_steps=80000,
        expected_gpu_num=8, freeze_finetune_updates=2000, max_epochs=320,
    )


def spiral_base_finetune_ls100_subword_noise() -> RunConfig:
    """``cli/conf/spiral/spiral_base_finetune_ls100_subword_noise.py``."""
    cfg = spiral_base_finetune_ls100_subword()
    cfg.model.noise_perturb = dns_noise(sample_rate=16000)
    cfg.trainer.max_epochs = 380
    return cfg


def spiral_base_pretrain_ls960_noise() -> RunConfig:
    """``cli/conf/spiral/spiral_base_pretrain_ls960_noise.py``."""
    cfg = spiral_base_pretrain_ls960()
    cfg.model.noise_perturb = dns_noise(sample_rate=16000)
    return cfg


def _large_finetune(decoder, mask_length, labels=None, tokenizer_file=None, ls960=False):
    """The SPIRAL-large finetune recipes (``spiral_large_finetune_*.py``):
    layerdrop 0.1 on both blocks, mask_prob 0.5; LS-100 at B = 18 x 42 s,
    LS-960 at B = 10 x 26 s for 320k steps."""
    enc = spiral_large_config()
    encoder = dataclasses.replace(
        enc, blocks=finetune_transformer_overrides(enc.blocks, layerdrop_first=0.1),
        mask_prob=0.5, mask_length=mask_length, mask_channel_prob=0.3,
        mask_channel_length=20)
    size = (dict(train_manifest=LS960_TRAIN, batch_size=10, max_duration=26.0,
                 max_steps=320000, expected_gpu_num=16, freeze_finetune_updates=4000,
                 max_epochs=380) if ls960 else
            dict(batch_size=18, max_duration=42.0, max_steps=80000, expected_gpu_num=8,
                 freeze_finetune_updates=2000, max_epochs=393))
    return finetune_run_config("ctc_finetune", encoder, decoder, labels=labels,
                               tokenizer_file=tokenizer_file, **size)


def spiral_large_finetune_ls100_char() -> RunConfig:
    """``cli/conf/spiral/spiral_large_finetune_ls100_char.py``."""
    return _large_finetune(char_decoder(norm_type="ln"), 4, labels=DEFAULT_CHAR_LABELS)


def spiral_large_finetune_ls100_subword() -> RunConfig:
    """``cli/conf/spiral/spiral_large_finetune_ls100_subword.py``."""
    return _large_finetune(subword_decoder(), 4, tokenizer_file=SPM_MODEL)


def spiral_large_finetune_ls960_char() -> RunConfig:
    """``cli/conf/spiral/spiral_large_finetune_ls960_char.py``."""
    return _large_finetune(char_decoder(norm_type="ln"), 12, labels=DEFAULT_CHAR_LABELS,
                           ls960=True)


def spiral_large_finetune_ls960_subword() -> RunConfig:
    """``cli/conf/spiral/spiral_large_finetune_ls960_subword.py``."""
    return _large_finetune(subword_decoder(), 8, tokenizer_file=SPM_MODEL, ls960=True)


def spiral_large_pretrain_librilight() -> RunConfig:
    """``cli/conf/spiral/spiral_large_pretrain_librilight.py``: Libri-Light
    pretraining, batch 20 x 256 000-sample crops, 500k steps, EMA 0.99 ->
    0.999."""
    max_steps = 500000

    def ds(manifest, shuffle, **kw):
        return AudioDatasetConfig(manifest_filepath=manifest, sample_rate=16000,
                                  batch_size=20, min_duration=2.0, crop_size=256000,
                                  shuffle=shuffle, **kw)

    model = SpiralModelConfig(
        encoder=spiral_large_config(target_momentum_steps=max_steps),
        optim=AdamWParams(
            lr=0.003, eps=1e-6, betas=(0.9, 0.98), weight_decay=0.01,
            sched=SchedParams(name="CosineAnnealing", warmup_steps=32000,
                              max_steps=max_steps, min_lr=0.0),
        ),
        train_ds=ds("librilight_manifest_json/librilight_unlab600.json,"
                    "librilight_manifest_json/librilight_unlab6k.json,"
                    "librilight_manifest_json/librilight_unlab60k.json", True, num_workers=4),
        validation_ds=ds("manifest_json/librivox-dev-clean.json", False),
        test_ds=ds("manifest_json/librivox-test-clean.json", False),
        expected_gpu_num=32,
    )
    return RunConfig(
        name="st2vec", model=model,
        trainer=TrainerConfig(max_epochs=700, max_steps=max_steps),
        exp_manager=ExpManagerConfig(name="st2vec", save_top_k=5),
    )


def spiral_toy_quality() -> RunConfig:
    """``cli/conf/spiral/spiral_toy_quality.py``: a small learnable SPIRAL
    (two 48-wide two-layer transformers, d_head 12) on 0.8 s utterances."""
    t = TransformerCfg(2, 48, 96, 4, 0.0, attention_dropout=0.0, conv_pos=8,
                       conv_pos_groups=4)
    blocks = (
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(32, (5,), (2,), "ln", "relu", 0.0),
                         ConvLayerCfg(48, (5,), (2,), "ln", "relu", 0.0)),
            transformer=t),
        ConvTransformerBlockCfg(
            conv_layers=(ConvLayerCfg(48, (5,), (2,), "ln", "relu", 0.0),),
            transformer=t),
    )
    encoder = ST2VecConfig(
        blocks=blocks, num_features=32, projector_dim=24,
        predictor_convs=(ConvLayerCfg(24, (3,), (1,), "bn", "relu", 0.0, bias=None),),
        n_negatives=8, max_shift=2,
        mask_prob=0.15, mask_length=6, mask_channel_prob=0.1, mask_channel_length=4,
        target_momentum=0.99, target_momentum_final=0.999, target_momentum_steps=300,
    )

    def ds(shuffle, **kw):
        return AudioDatasetConfig(manifest_filepath="manifest.json", sample_rate=16000,
                                  batch_size=8, shuffle=shuffle, max_duration=0.81,
                                  num_workers=2, **kw)

    model = SpiralModelConfig(
        encoder=encoder,
        labels=DEFAULT_CHAR_LABELS,
        freeze_finetune_updates=0,
        decoder=DecoderConfig(
            conv_layers=tuple(ConvLayerCfg(48, (5,), (1,), None, "relu", 0.0)
                              for _ in range(2)),
            upsample_rate=4, upsample_filters=48, upsample_dropout=0.0,
        ),
        optim=AdamWParams(
            lr=2e-3, sched=SchedParams(name="CosineAnnealing", warmup_steps=20,
                                       max_steps=600)),
        train_ds=ds(True, crop_size=12800),
        validation_ds=ds(False),
        test_ds=ds(False),
    )
    return RunConfig(
        name="st2vec_toy", model=model,
        trainer=TrainerConfig(devices=1, max_epochs=10, max_steps=None,
                              val_check_interval_epochs=5),
        exp_manager=ExpManagerConfig(name="st2vec_toy"),
    )


CONFIGS = {
    "spiral_base_finetune_ls100_char": spiral_base_ctc_char,
    "spiral_tiny_ctc_char": spiral_tiny_ctc_char,
    "spiral_base_pretrain_ls960": spiral_base_pretrain_ls960,
    "spiral_tiny_pretrain": spiral_tiny_pretrain,
    "spiral_tiny_test": spiral_tiny_pretrain,  # the JAX package's name for it
    "spiral_base_finetune_ls100_subword": spiral_base_finetune_ls100_subword,
    "spiral_base_finetune_ls100_subword_noise": spiral_base_finetune_ls100_subword_noise,
    "spiral_base_pretrain_ls960_noise": spiral_base_pretrain_ls960_noise,
    "spiral_large_finetune_ls100_char": spiral_large_finetune_ls100_char,
    "spiral_large_finetune_ls100_subword": spiral_large_finetune_ls100_subword,
    "spiral_large_finetune_ls960_char": spiral_large_finetune_ls960_char,
    "spiral_large_finetune_ls960_subword": spiral_large_finetune_ls960_subword,
    "spiral_large_pretrain_librilight": spiral_large_pretrain_librilight,
    "spiral_toy_quality": spiral_toy_quality,
    "spiral_base_finetune_ls100_char_streaming": spiral_base_finetune_ls100_char_streaming,
    "spiral_tiny_stream_test": spiral_tiny_stream_test,
}
