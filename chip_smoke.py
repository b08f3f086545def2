#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Drives the port's three SPIRAL-base paths through their normal entry point
(``tpu_speech_torch.cli.run_spiral.main``), at full width with seeded random
weights: CTC transcription, the ST2Vec pretrain step and the CTC finetune
step, the two training steps also in bf16 mixed precision and with gradient
accumulation; Grad-TTS + HiFi-GAN text-to-waveform serving through
``tpu_speech_torch.cli.inference.main``, which reaches no hand kernel (cuDNN
and cuBLAS); Grad-TTS training through ``tpu_speech_torch.cli.train.main``,
whose monotonic alignment search is a hand kernel; DiffVC voice
conversion through ``tpu_speech_torch.cli.inference_vc.main`` (cuDNN, cuBLAS
and cuFFT, no hand kernel); and DiffVC's two-stage training and the GE2E
speaker encoder's training through their CLIs (``preprocess_spk``,
``train_spk_encoder``, ``get_avg_mels``, ``train_enc``, ``train_dec``; no
hand kernel), ending in a conversion on the checkpoints they wrote; and
the SPIRAL loops as the JAX CLI runs them (its defaults, a checkpoint every
epoch and resume, validation, ``.tpu_speech`` archives); HiFi-GAN V1's GAN
training through ``tpu_speech_torch.cli.train_hifigan.main`` (fp32, bf16,
resume, fine-tuning; no hand kernel) and Grad-TTS training in bf16. It
checks each hand kernel, fp32 and bf16, against its plain PyTorch version. Phases
(any failure raises and the script exits non-zero without printing a
result):

1. build the CUDA kernels from ``tpu_speech_torch/csrc`` (nvcc, sm_90a);
   print each kernel's registers and spills (``-Xptxas -v``) and its
   tensor-core instructions (``cuobjdump -sass``: HMMA for mma.sync, HGMMA
   for wgmma), and fail if an attention or positional-conv kernel has none,
   if a bf16 variant has no bf16 ones, or if one of the 18 bf16 attention
   kernels of ``csrc/fused_attention_sm90.cu`` or the four bf16 K4 kernels
   of ``csrc/fused_posconv_sm90.cu`` has no HGMMA or spills (a missing
   ``cuobjdump`` fails too);
2. K1 (fused log-mel) against ``logmel_plain`` in fp32 and in float64 at
   the SPIRAL shape (14 x 384 512 featurizer-input samples), at frame-count
   edges, at the HiFi-GAN mel (n_fft 1024, hop 256, mag_eps and clip) and
   on tones over a weak noise floor; a warm call must make no host copy and
   no sync (``torch.cuda.set_sync_debug_mode``);
3. K2 (merged-qkv attention forward) against ``qkv_attention_plain`` at both
   SPIRAL blocks' shapes, lengths over 30-100 % of T, one fully padded row;
4. the slice: synthetic wavs + manifest -> ``tpu_speech_torch.cli.run_spiral
   .main(--run_mode test)`` with full-width weights from a seeded
   ``torch.Generator``; the launch counters must show K1 on every batch, K2
   twelve times and K4 twice per batch, and the log-probs must be finite;
5. the same weights on the CPU (plain paths) against the card's log-probs
   for two of those utterances;
6. timings with CUDA events (median of 20 after warm-up): each kernel beside
   its plain version, and the slice per batch; beside each kernel's time its
   bound (``roofline``) and, where one PyTorch call computes the same
   function, that call's time (``F.scaled_dot_product_attention`` for K2 and
   K3, cuDNN's grouped ``conv1d`` and its input gradient for K4), which the
   port never calls;
7. K2 with attention dropout 0.1 against ``qkv_attention_plain`` replaying
   the same counter-based mask, at the pretrain step's four shapes and the
   finetune step's two; the kernel's own keep rate (q = 0, v = 1: each
   output is its row's kept share over 1 - p) within 4 sigma of 0.9; masks
   that differ across seeds and across (b, h);
8. K2-bwd: dqkv against autograd of the plain version at p = 0 and 0.1, at
   the same six shapes, timed beside it (backward alone, and forward +
   backward);
9. the pretrain slice: a synthetic corpus (speech-like waves, 4-20 s) ->
   ``run_spiral.main(--model_type st2vec --run_mode train --config_name
   spiral_base_pretrain_ls960)`` for a few steps at B = 24 x 250 000
   samples; the launch counters must show K1 twice per step, K2-fwd once per
   kept teacher and student layer, K2-bwd once per kept student layer, K4
   four times and K4-dx twice per step; the loss and accuracy finite, the
   student moved, the teacher moved less (EMA);
10. one full-width step on the card against the CPU (B = 2 x 4 s crops, the
    same weights and batch, dither, dropout and layerdrop off, SGD with
    lr = 1): the loss and every gradient tensor, and the EMA update exactly;
11. the pretrain step's time (median of 10 on the card, batch on the card),
    its peak device memory, and a profile of the step;
12. K4 (grouped positional conv) against ``grouped_conv1d_plain`` (cuDNN's
    ``F.conv1d``) at the six shapes of the three paths with left pads 64, 63
    and 127, dx against autograd of the plain version, each timed beside
    the plain version (forward, and forward + backward);
13. K3 (attention on (B, T, H, D) q, k, v) against ``attention_plain`` at
    both finetune blocks' shapes, dropout 0 and 0.1, one fully padded row,
    forward and backward, timed beside the plain version and beside K2;
14. the finetune slice: a synthetic corpus (speech-like waves, 4-20 s,
    random character transcripts) -> ``run_spiral.main(--model_type
    ctc_finetune --run_mode train --config_name
    spiral_base_finetune_ls100_char)`` from phase 9's ``st2vec.pt`` for 4
    steps at B = 14 x 24 s, the first 2 with the encoder frozen; per step
    the launch counters must show K1 once, K2-fwd once per kept layer, K4
    twice, and K2-bwd and K4-dx only in the unfrozen steps; the loss finite;
    in the frozen steps the encoder moved by weight decay alone; the decoder
    moved on every step; the saved state_dict loads in ``--run_mode test``;
15. one full-width unfrozen finetune step on the card against the CPU
    (B = 2 x 4 s, dither, dropout, layerdrop and masks off, SGD with lr = 1):
    the loss and every gradient tensor;
16. the finetune step's time (median of 10, unfrozen, batch on the card),
    its peak device memory, and a profile of the step;
17. the bf16 variants of K2, K2-bwd, K3, K3-bwd, K4 and K4-dx against their
    plain versions (which round where the kernels do) at the shapes of
    phases 7, 8, 12 and 13, each timed beside its plain version, its bound
    (FLOP at the bf16 peak) and the library's bf16 call (SDPA, cuDNN's conv
    and dgrad); for K2 and K3 also the achieved TFLOP/s, the backward's
    scratch bytes, and two runs of forward and backward at p = 0 and 0.1
    that must give equal bits (out, lse, dq, dk, dv); K4 and K4-dx at all
    six K4 shapes a call (with the weights' rearrangement) and back to back
    (the kernel alone), beside the plain version, cuDNN's bf16 conv and
    dgrad (a call and back to back) and the bound, with their TFLOP/s and two
    runs that must give equal bits; the weights' layout kernel held to its
    plain version bit for bit and timed beside it; and a line of the weight bytes a call
    reads from L2 by the tiling (computed from the kernel's frames a block,
    which its library reports);
18. the pretrain slice with ``--set model.precision=bf16`` through
    ``run_spiral.main`` on phase 9's corpus for 3 steps: per step the bf16
    kernels' launches and none of the fp32 attention or K4 kernels, finite
    losses, float32 weights saved; then the bf16 step's time, peak memory
    and profile, and the step time beside its device busy time and the bf16
    attention and K4 kernels' parts of it (the same for phase 20);
19. one full-width pretrain step in bf16 against fp32 on the card (B = 24 x
    250 000, the same weights, batch and negatives, regularisers off, SGD lr
    = 1): the loss within 2e-2 relative, each gradient leaf (at least 1 % of
    the largest) within 0.1 relative L2 or, where the same bf16 step on the
    plain versions is itself farther, within 2x its distance + 1e-2;
20. the same for finetuning: the bf16 slice through ``run_spiral.main`` (2
    unfrozen steps from phase 9's st2vec.pt), its step time and peak memory,
    and a bf16 step against fp32 (B = 14 x 24 s);
21. ``accumulate_grad_batches = 2`` for both steps at full width (24 and 14
    utterances a micro-batch): one update and one EMA a call, the peak
    memory within 1.1x the accum = 1 step's, the step times;
22. the finetune step at accum 2 on two halves of 28 utterances against
    accum 1 on all 28 (fp32, SGD, regularisers off): the loss within 1e-5
    relative, the gradients within 1e-3 x max|g|;
23. Grad-TTS + HiFi-GAN text -> wav through
    ``tpu_speech_torch.cli.inference.main`` at the LJSpeech width of
    ``cli/params.py`` and HiFi-GAN V1, seeded random weights saved as a
    reference-named ``.pt`` and a weight-norm generator ``.pt`` with its
    V1 ``hifigan-config.json``: three lines (bench.py's text, numbers and
    abbreviations, one over 256 frames) give int16 wavs of frames x 256
    samples, none cut; no hand kernel launches on this path;
24. the same weights and z on the card and on the CPU at bucket 384: 10
    Euler steps and 6 DPM steps within mel MAE 1e-3, the wav MAE after
    HiFi-GAN; the sampler and vocoder after the encoder make no host sync
    (``torch.cuda.set_sync_debug_mode("error")``);
25. the TTS points bench.py names, fp32, CUDA events (median of 10): e2e
    text -> int16 wav RTF at B = 1, bucket 384, 10 Euler and 6 DPM steps,
    the mel-only RTF, B = 16 throughput in x realtime, HiFi-GAN alone at
    (16, 384, 80), peak memory, and a profile (kernels per utterance, busy
    share, top device ops);
26. the MAS kernel (``csrc/monotonic_align.cu``) against
    ``maximum_path_plain`` on the card, paths equal bit for bit: bench.py's
    (16, 72, 512) at full lengths, LJSpeech-like rows (Tx 30-400, Ty
    100-900, mixed, one with Tx = Ty) and an integer grid full of ties;
    each timed beside the plain loop and the bound;
27. Grad-TTS training through ``tpu_speech_torch.cli.train.main`` at the
    LJSpeech width, B = 16, out_size 172, on 40 synthetic 22 050 Hz
    utterances of 1-8 s: 2 epochs of 2 steps, then a second ``main()`` on
    the same log dir with 3 epochs that resumes at step 4 and takes 2 steps,
    then the multi-speaker entry (n_spks 4) for 2 steps; per step MAS
    launches once and no other hand kernel, the losses are finite; the
    encoder and the estimator moved; ``train.log`` has a line per epoch; the
    final ``gradtts.pt`` gives an uncut wav through ``cli.inference.main``;
28. one full-width training step on the card against the CPU (B = 2, Ty
    256, the same weights, batch, offsets, t and z, dropout off, Adam
    1e-4): the MAS paths equal, the losses within 1e-4 relative, each
    gradient within 1e-3 x its max|g|, the parameters within 1e-5 x max(1,
    |p|) of the CPU's Adam on the card's gradients (Adam's first step is
    about lr sign(g), so where g is rounding noise the two sides' own steps
    may differ by 2 lr); the card's step makes no host sync;
29. bench.py's train-step point (B = 16, Tx 72, Ty 512, out_size 172, fp32):
    step time (CUDA events, median of 10), peak memory, kernels per step,
    the busy share and a profile with MAS's rank;
30. DiffVC voice conversion through ``tpu_speech_torch.cli.inference_vc.main``
    at the width of ``cli/params_vc.py`` (126 259 128 parameters), seeded
    random weights saved as a reference-named ``diffvc.pt`` (rezero gains
    zero) and a ``{'model_state': ...}`` speaker-encoder ``.pt``, on
    speech-like 22 050 Hz wavs (source 3.0 s, target 2.5 s): ``--mode ml -n
    30``, ``--mode dpm -n 6``, then ml again warm; each wav has hop x (frames
    - 1) samples (the JAX CLI's Griffin-Lim length), the converted mel is
    finite, no hand kernel launches (``launches_by_path`` key
    ``diffvc_conversion``). On untrained weights the sampler's mel reaches
    hundreds and the reference's denoiser overflows, so the wav's finiteness
    is printed, not required;
31. the same weights and inputs on the card and on the CPU: the
    average-voice encoder and one estimator call at T = 256, ``voice_convert``
    with 3 ml and 2 dpm steps at T = 128 (draws given, scaled as in the CPU
    tests), the speaker embedding, ``istft`` and 32 Griffin-Lim iterations
    (spectral convergence): mels within MAE 1e-3, the embedding and istft
    1e-4; the sampler and Griffin-Lim again under
    ``torch.cuda.set_sync_debug_mode("error")``;
32. bench.py's conversion points in fp32 (CUDA events, median of 10): B = 1,
    256-frame source and reference, 30 ml steps and 6 dpm steps, each as RTF
    beside its bound (convolution and product FLOP at the CUDA cores' fp32
    rate) and peak memory; Griffin-Lim alone; the CLI's wav -> wav time by
    stage; a profile (kernels per conversion, busy share, top device ops);
33. the GE2E speaker encoder's training: 256 speech-like 22 050 Hz wavs of
    2.0-2.6 s from 16 speakers (each around a base f0 of its own) ->
    ``cli.preprocess_spk.main`` -> ``cli.train_spk_encoder.main`` at the full
    width (3 x 256 LSTM) for 4 steps of 16 speakers x 10 utterances x 160
    frames, then a run that resumes at step 4 and takes 2: the losses
    finite, the EER in [0, 1], no hand kernel (``launches_by_path`` key
    ``ge2e_train``), the ``.pt`` loads through ``cli.inference_vc``'s
    ``--spk-encoder`` loader;
34. DiffVC's training at ``cli/params_vc.py``'s width: phase 33's wavs ->
    host mels, embeddings by phase 33's encoder and TextGrids of random
    phone intervals -> ``cli.get_avg_mels.main`` -> ``cli.train_enc.main``
    at B = 128 x 128 frames, 2 epochs (4 steps), then a resumed epoch (2
    steps) -> ``cli.train_dec.main`` from its ``enc.pt`` at B = 32, 2 epochs
    (16 steps), then a resumed epoch (8 steps) -> ``cli.inference_vc.main``
    on the trained ``diffvc.pt`` and phase 33's encoder (ml 30). Every
    step's loss finite, no hand kernel (keys ``diffvc_enc_train``,
    ``diffvc_dec_train``), the encoder in ``diffvc.pt`` bit for bit
    ``enc.pt``'s, the estimator moved, the converted mel finite;
35. the encoder step, the decoder step and the GE2E step at full width and
    B = 2 (4 x 5 for GE2E) on the card against the CPU, the same weights
    and batch, dropout off, the decoder's t and z given: phase 28's limits
    (loss 1e-4 relative, gradients 1e-3 x max|g|, parameters 1e-5 x max(1,
    |p|) of the CPU's Adam on the card's gradients), each card step under
    ``torch.cuda.set_sync_debug_mode("error")``;
36. the recipe's points, fp32, the batch on the card, CUDA events (median
    of 5): the encoder step at B = 128 x 128, the decoder step at B = 32 x
    128, the GE2E step at 64 x 10 x 160 x 40; each with its peak memory,
    kernels per step, busy share, top device ops and FLOP bound
    (``torch.utils.flop_counter``, plus the LSTM's products counted by hand,
    at the CUDA cores' fp32 rate); the GE2E sampler's host time a batch
    (640 ``.npy`` loads) beside its device time;
37. pretraining through ``run_spiral.main`` with no --model_type and no
    --run_mode (the JAX CLI's defaults: spiral, train) at
    spiral_base_pretrain_ls960's width on phase 9's corpus (48 utterances, a
    validation manifest of 24 more), one loader thread: 2 epochs of 2 steps
    with validation and a checkpoint after each; then 1 epoch, and a second
    ``main`` call in the same directory that resumes for the second. The
    straight and the resumed run end with the same student, teacher and
    AdamW moments, bit for bit (with cuDNN's deterministic algorithms: its
    default weight gradients sum in a run-dependent order); every kernel of
    the step launched; both train.logs hold the validation loss and the
    four collapse scalars, finite; the checkpoint's size and its write time
    on the Checkpointer's thread (``launches_by_path`` key
    ``pretrain_cli_resume``);
38. validation on the card: a validate pass of phase 37's weights over its
    validation manifest, per batch K1 twice, K2-fwd once per layer of both
    towers, K4 four times, no K2-bwd, no K4-dx and no bf16 kernel
    (``pretrain_validation``); the pass's time and one batch's; one batch
    (B = 2 x 4 s) on the card against the CPU with the same weights, batch
    and negative indices, the loss within phase 10's limit;
39. archives: CTC finetuning through ``run_spiral.main`` on phase 14's
    corpus from phase 37's ``st2vec.tpu_speech`` (2 steps,
    ``finetune_cli_archive``) writes ``ctc_finetune.tpu_speech``; ``--run_mode
    test`` with ``--init_archive`` on it, with ``--init_chkpt_file
    ctc_finetune.pt``, with a step checkpoint, and with ``--use_chkpt_hparams
    true`` under a pretrain ``--config_name`` give the same log-probs bit for
    bit and the same WER;
40. HiFi-GAN V1 training through ``tpu_speech_torch.cli.train_hifigan.main``
    on 48 speech-like 22 050 Hz wavs of 2 s (8 more for validation), the V1
    config written out (B = 16 x 8192, AdamW 2e-4, b 0.8/0.99, decay
    0.999): 2 epochs of 3 steps with validation, then ``--resume_if_exists``
    to a 3rd, then ``--fine_tuning`` on host mels stored (80, T) for a 4th;
    per step the seven metrics finite and no hand kernel
    (``launches_by_path`` key ``hifigan_train_step``); the generator and
    both discriminators moved; the final ``generator.pt`` vocodes through
    ``cli.inference.main``;
41. one V1 GAN step (B = 2 x 8192) on the card against the CPU, the
    generator's half against a CPU step that meets the card's updated
    discriminators: metrics 1e-4 relative, each gradient leaf within 1e-3
    relative L2 (the L1 mel loss flips single elements' signs, so phase
    28's elementwise bound is printed only), parameters 1e-5 x max(1, |p|)
    of the CPU's AdamW on the card's gradients; the card's step under
    ``torch.cuda.set_sync_debug_mode("error")``;
42. bf16 training: ``train_hifigan.main --bf16`` for 2 epochs on phase 40's
    corpus, and Grad-TTS through ``cli.train.main`` with ``precision =
    "bf16"`` (2 epochs of 2 steps at B = 16, MAS once a step: key
    ``gradtts_train_step_bf16``), float32 weights saved; one bf16 step of
    each held to its fp32 step (the loss within 2e-2, the gradients by the
    2x rule of phase 19): the GAN step at B = 16 x 8192 (no hand kernel, so
    its yardstick is the step itself) and the Grad-TTS step at bench.py's
    point with one set of draws and MAS path (yardstick: MAS's plain loop);
43. the GAN step at B = 16 x 8192, fp32 with TF32 off and bf16: CUDA events
    (median of 10), peak memory, kernels per step, busy share, and the FLOP
    bound (at 67 TFLOP/s fp32 or 989 TFLOP/s bf16) of 4 F_G + 9 F_D, the
    generator's and the discriminators' forwards by
    ``torch.utils.flop_counter``;
44. bench.py's train-step point in bf16 (``gradtts_train_step_ms_bf16``):
    as phase 29.

Output: phase lines, then the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``), then one JSON line describing
the kernels, then the last line ``{"ok": true, "device": {...}}``.
Needs one CUDA card; fails without one.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

T0 = time.perf_counter()
SR = 16000
BATCH = 14
MAX_SAMPLES = 24 * SR
N_UTTS = 28
# log-mel units. The log amplifies rounding in frames where a one-bin low mel
# filter sees near-zero power. On this speech-like input the plain fp32
# version (cuFFT) lands ~1.3e-4 off the float64 value; the kernel, whose
# transform runs in float64, ~4e-5 (its fp32 window product).
K1_ATOL_PLAIN32 = 2e-4
K1_ATOL_PLAIN64 = 2e-4
K2_ATOL = 1e-4
SLICE_ATOL = 5e-3
SLICE_ARGMAX_AGREE = 0.99
DROP_P = 0.1
# K2-bwd against autograd of the plain version: 1e-4 x max(1, max|plain|).
# Both sum 64-term dot products in fp32 in different orders, and dS = P (dP -
# Delta) cancels; measured ~1e-5 at these shapes.
K2_BWD_RTOL = 1e-4
# the pretrain step's shapes: (B, T, E, H), student and teacher, both blocks
STEP_SHAPES = ((24, 392, 512, 8), (24, 456, 512, 8), (24, 196, 768, 12), (24, 228, 768, 12))
# ... and the finetune step's (blocks 1 and 2 at 24 s): K2 with dropout and
# K2-bwd are held against the plain version at both sets
K2_TRAIN_SHAPES = STEP_SHAPES + ((14, 604, 512, 8), (14, 302, 768, 12))
PRETRAIN_STEPS = 3
PRETRAIN_BATCH = 24
# card against CPU, one step: loss relative; each gradient tensor within
# GRAD_RTOL x its max|g|, floored at GRAD_RTOL x 1 % of the largest gradient
# of the model (the key biases have an exactly zero gradient, the softmax
# ignores a per-row shift, so both sides see rounding noise there)
STEP_LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
# K4 and K4-dx against the plain version: 1e-4 x max(1, max|plain|); both
# sum Cg * K = 4096-6144 fp32 products in different orders (measured ~2e-5
# at max|plain| ~5)
K4_RTOL = 1e-4
# (B, T, C): the positional convs of CTC transcription and finetuning (blocks
# 1 and 2 at 24 s), and of the pretrain step (student and teacher crops)
K4_SHAPES = ((14, 604, 512), (14, 302, 768), (24, 392, 512), (24, 456, 512),
             (24, 196, 768), (24, 228, 768))
# K3 at the finetune step's shapes: (B, T, H, D)
K3_SHAPES = ((14, 604, 8, 64), (14, 302, 12, 64))
FT_STEPS = 4
FT_FROZEN = 2
FT_LR = 1e-2  # x lr_scale 1/8; weight decay 0.01: a frozen step scales by 1 - 1.25e-5
# the bf16 kernels against their plain versions, which round at the same
# points (P~ and dS, outputs): x max(1, max|plain|), about one bf16 step at
# the largest value (an output of either may land one rounding step apart)
BF16_FWD_RTOL = 8e-3
BF16_GRAD_RTOL = 1.6e-2
# a bf16 step against the fp32 step on the same weights and batch: the loss
# relative, and each gradient leaf (max|g| at least 1 % of the largest) in
# relative L2 (see _hold_bf16_step for the leaves where the bf16 scheme
# itself, with the plain versions, is farther)
BF16_STEP_LOSS_RTOL = 2e-2
BF16_STEP_GRAD_RL2 = 0.1
BF16_FT_STEPS = 2
# the finetune step at accum 2 on two halves against accum 1 on the whole
ACCUM_LOSS_RTOL = 1e-5
# Grad-TTS + HiFi-GAN (phases 23-25): bench.py's text (bench.py:69-72) and
# mel bucket; card against CPU, the mel's mean absolute error (the JAX
# package's on-chip gate against the reference, README)
TTS_TEXT = ("The quick brown fox jumps over the lazy dog while the curious cat watches from a "
            "sunlit windowsill in the early morning.")
TTS_LINES = (
    TTS_TEXT,
    "Dr. Smith paid $3.50 for 2 tickets on Feb. 1st, 1999, at St. John's, 10 minutes early.",
    "At full width a line this long is predicted at well over two hundred and fifty six "
    "mel frames, so the command line tool of the JAX package would cut it at that bucket, "
    "while the port passes the smallest multiple of the bucket that covers the predicted "
    "length and keeps every frame of it.",
)
TTS_BUCKET = 384
TTS_MEL_MAE = 1e-3
TTS_SEED = 23
HIFIGAN_V1 = dict(resblock="1", upsample_rates=[8, 8, 2, 2], upsample_kernel_sizes=[16, 16, 4, 4],
                  upsample_initial_channel=512, resblock_kernel_sizes=[3, 7, 11],
                  resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]])


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def speech_like(rng, n, sr=SR, f0=None):
    """Voiced-speech stand-in at ``sr`` Hz: a gliding f0 (``f0``, else drawn
    from 100-250 Hz) with 1/h harmonics up to 3.4 kHz under a 4 Hz syllable
    envelope, plus noise 40 dB below the 0.15 peak."""
    t = np.arange(n) / sr
    if f0 is None:
        f0 = rng.uniform(100, 250)
    f0 = f0 * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 1) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    y = np.zeros(n)
    for h in range(1, int(3400 / 250) + 1):
        y += np.sin(h * phase + rng.uniform(0, 2 * np.pi)) / h
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t + rng.uniform(0, 2 * np.pi))) ** 2
    y = 0.15 * y * env / np.abs(y).max()
    y += 0.0015 * rng.standard_normal(n)
    return y.astype(np.float32)


def cuda_ms(fn, n=20, warmup=3, reps=1):
    """Median over n samples of the device time of ``fn``; a sample times
    ``reps`` calls back to back and counts their mean (reps > 1 for a kernel
    whose time is near the host's launch overhead, which the device would
    otherwise idle through)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


# the card's peaks (NVIDIA's H100 SXM data sheet, dense): TF32 and bf16
# tensor cores and HBM3. An fp32-accurate product costs three TF32 products
# (the hi/lo split), a bf16 product one bf16 product, so a kernel's least
# time is the larger of 3 * FLOP / TF32 peak (FLOP / bf16 peak) and bytes /
# memory rate.
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def roofline(flop, nbytes, bf16=False):
    """(bound_ms, bound_by) of a kernel that does ``flop`` fp32-accurate (or
    bf16) operations and must move ``nbytes`` (each input read once, each
    output written once)."""
    ops_ms = (flop / PEAK_BF16 if bf16 else 3 * flop / PEAK_TF32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound(b, t, h, d, backward, itemsize=4):
    """The forward does S = q k^T and P v (4 B H T^2 D FLOP); the backward
    recomputes S and dO v^T and forms dV, dQ, dK (10 B H T^2 D). Operands of
    ``itemsize`` bytes; L and Delta float32, the mask a byte a key."""
    e = h * d
    if backward:  # q, k, v, out, dO, L, mask in; dq, dk, dv out
        return roofline(10 * b * h * t * t * d, itemsize * 8 * b * t * e + 4 * b * h * t + b * t,
                        bf16=itemsize == 2)
    return roofline(4 * b * h * t * t * d, itemsize * 4 * b * t * e + b * t, bf16=itemsize == 2)


def sdpa(q, k, v, mask, p):
    """The one PyTorch call that computes K2's and K3's function, on (B, H,
    T, D) views (q carries its scale; True in ``mask`` is a padded key): the
    yardstick timed as ``library_ms``. The port never calls it."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=~mask[:, None, None, :],
                                          dropout_p=p, scale=1.0)


def sdpa_calls(torch, q, k, v, mask, dout, p):
    """(forward, backward-alone) calls of ``sdpa`` on (B, T, H, D) q, k, v
    and dout, passed as (B, H, T, D) views."""
    q, k, v, dout = (a.transpose(1, 2) for a in (q, k, v, dout))
    xs = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    out = sdpa(*xs, mask, p)
    return (lambda: sdpa(q, k, v, mask, p),
            lambda: torch.autograd.grad(out, xs, dout, retain_graph=True))


def sdpa_times(torch, q, k, v, mask, dout, p):
    """(forward ms, backward-alone ms) of ``sdpa`` (``cuda_ms``)."""
    return tuple(cuda_ms(fn) for fn in sdpa_calls(torch, q, k, v, mask, dout, p))


def back_to_back_ms(fn, reps=20):
    """The time of one call of ``fn`` among ``reps`` calls back to back
    (CUDA events, median of 10 samples): the device's time a call wherever
    the host enqueues a call faster than the device runs it. ``cuda_ms`` of
    a single call also counts the host's work before the launch, on which a
    kernel of tens of microseconds waits."""
    return cuda_ms(fn, n=10, warmup=3, reps=reps)


def qkv_views(qkv, h):
    """The (B, T, H, D) q, k, v views of a merged (B, T, 3E) plane."""
    b, t, e3 = qkv.shape
    return qkv.view(b, t, 3, h, e3 // 3 // h).unbind(2)


def sass_counts(so_path):
    """({kernel: tensor-core instructions}, {kernel: bf16 ones}, {kernel:
    HGMMA ones}, the HMMA TF32 lines) from ``cuobjdump -sass`` of the built
    library (HMMA: mma.sync; HGMMA: wgmma), or None without the tool."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    counts, bf16, hgmma, fn = {}, {}, {}, None
    for line in sass:
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            counts[fn] = bf16[fn] = hgmma[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
            bf16[fn] += "BF16" in line
            hgmma[fn] += "HGMMA" in line
    return counts, bf16, hgmma, [ln for ln in sass if "HMMA" in ln and "TF32" in ln]


def kernel_name(text):
    """``attn_fwd_kernel<64>`` (``attn_fwd_sm90_kernel<64,1>``: the second
    argument a bool) from a line that holds a kernel's mangled name."""
    m = re.search(r"(attn_[a-z0-9_]+?_kernel|grouped_conv1d(?:_sm90)?_kernel|logmel_fft_kernel"
                  r"|maximum_path_kernel|posconv_weight_layout_kernel)"
                  r"((?:IL[ib]\d+E)?(?:L[ib]\d+E)*)", text)
    if m is None:
        return text.strip()
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


# the bf16 attention kernels of csrc/fused_attention_sm90.cu: three kernels,
# each at d_head 16, 32, 64, with and without dropout
SM90_KERNELS = {f"attn_{k}_sm90_kernel<{d},{p}>" for k in ("fwd", "bwd_dq", "bwd_dkdv")
                for d in (16, 32, 64) for p in (0, 1)}
# the bf16 K4 kernel of csrc/fused_posconv_sm90.cu at <Cg, 64-frame tiles a
# warpgroup>
K4_SM90_KERNELS = {f"grouped_conv1d_sm90_kernel<{cg},{mw}>"
                   for cg, mw in ((16, 2), (32, 2), (48, 2), (64, 1))}


def phase_build(_build):
    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"[1 build] {secs:.1f} s, compiled={_build.build_info['compiled']} "
        f"-> {_build.build_info['path']}")
    name, spills = None, {}
    for line in _build.build_info["log"].splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line)
        elif "registers" in line or "spill" in line:
            log(f"    ptxas {name}: {line.strip().replace('ptxas info    : ', '')}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[name] = spills.get(name, 0) + int(m.group(1)) + int(m.group(2))
    # the sm90 kernels: no spills, and wgmma in each (a missing cuobjdump fails)
    sm90 = SM90_KERNELS | K4_SM90_KERNELS
    check(sm90 <= set(spills), f"sm90 kernels not in the ptxas log: "
          f"{sorted(sm90 - set(spills))}")
    check(all(spills[k] == 0 for k in sm90),
          f"sm90 kernels spill: { {k: spills[k] for k in sm90 if spills[k]} }")
    c7514 = [ln.strip() for ln in _build.build_info["log"].splitlines() if "C7514" in ln]
    log(f"    ptxas C7514 (wgmma serialized) lines: {len(c7514)}")
    sass = sass_counts(_build.build_info["path"])
    check(sass is not None, "cuobjdump not found: the sm90 kernels' HGMMA cannot be checked")
    counts, bf16, hgmma, tf32 = sass
    for fn, n in sorted(counts.items()):
        log(f"    SASS: {n:5d} HMMA/HGMMA ({bf16[fn]} of them BF16, {hgmma[fn]} HGMMA) in "
            f"{kernel_name(fn)}")
    log(f"    SASS: {len(tf32)} HMMA ... TF32 instructions in all, e.g. "
        f"{tf32[0].split('*/')[1].split(';')[0].strip() if tf32 else None}")
    # the attention and positional-conv kernels run their products on the
    # tensor cores (the attention's Delta kernel is a row sum)
    tc = {kernel_name(fn): n for fn, n in counts.items()
          if ("attn_" in fn and "delta" not in fn) or "grouped_conv1d" in fn}
    check(tc and all(n > 0 for n in tc.values()),
          f"kernels without tensor-core instructions: {tc}")
    # ... the bf16 variants on bf16 ones
    tc16 = {kernel_name(fn): n for fn, n in bf16.items()
            if "_bf16_" in kernel_name(fn) or "_sm90_" in kernel_name(fn)}
    check(len(tc16) >= 4 and all(n > 0 for n in tc16.values()),
          f"bf16 kernels without bf16 tensor-core instructions: {tc16}")
    # ... and the bf16 attention and K4 kernels on wgmma
    wg = {kernel_name(fn): n for fn, n in hgmma.items() if "_sm90_" in kernel_name(fn)}
    check(set(wg) == sm90 and all(n > 0 for n in wg.values()),
          f"sm90 kernels without HGMMA: {wg}")
    for name, group in (("attention", SM90_KERNELS), ("K4", K4_SM90_KERNELS)):
        n = [wg[k] for k in group]
        log(f"    the {len(group)} sm90 {name} kernels: HGMMA in each ({min(n)}-{max(n)}), "
            f"no spills")


def tones_over_noise(n, seed):
    """Two strong tones (440 Hz and 1234.5 Hz) over a noise floor 74 dB below
    them: near-zero-power bins everywhere off the tones, where the log
    amplifies every rounding."""
    t = np.arange(n) / SR
    noise = np.random.default_rng(seed).standard_normal(n)
    return (0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * 1234.5 * t)
            + 1e-4 * noise).astype(np.float32)


def phase_k1(torch, rng):
    from tpu_speech_torch.audio.mel import hann_window, mel_filterbank
    from tpu_speech_torch.models.spiral.features import hann_window_symmetric, stft_input
    from tpu_speech_torch.ops.fused_logmel import fused_logmel, logmel_plain

    dev = "cuda"
    win = np.zeros(512, np.float32)
    win[96:416] = hann_window_symmetric(320)
    window = torch.tensor(win, device=dev)
    fb = torch.tensor(mel_filterbank(SR, 512, 128, 0.0, SR / 2), device=dev)
    lens = np.linspace(0.3, 1.0, BATCH) * MAX_SAMPLES
    wav = np.zeros((BATCH, MAX_SAMPLES), np.float32)
    for i, n in enumerate(lens.astype(int)):
        wav[i, :n] = speech_like(rng, n)
    # the signal K1 reads on the main path: normalized, preemphasized,
    # reflect-padded (14, 384 512)
    x = stft_input(torch.tensor(wav, device=dev), 512)
    spiral = (window, fb, dict(n_fft=512, hop_length=160))
    # the HiFi-GAN mel: periodic Hann of 1024, hop 256, 80 slaney mels at
    # 22.05 kHz, sqrt(power + eps), log(max(mel, 1e-5)); 4 x 8 s
    hifigan = (torch.tensor(hann_window(1024), device=dev),
               torch.tensor(mel_filterbank(22050, 1024, 80, 0.0, 8000.0), device=dev),
               dict(n_fft=1024, hop_length=256, mag_mode="mag_eps", log_mode="clip",
                    log_guard=1e-5))
    x_hifi = torch.tensor(np.stack([speech_like(rng, 8 * 22050) for _ in range(4)]), device=dev)
    x_tones = stft_input(torch.tensor(np.stack([tones_over_noise(8 * SR, s) for s in (1, 2)]),
                                      device=dev), 512)
    cases = [("spiral", x, spiral)] + [
        (f"frames={nf}", x[:3, : (nf - 1) * 160 + 512].contiguous(), spiral)
        # the kernel's tile is 16 frames at n_fft 512: its edges, two tiles, ragged
        for nf in (1, 15, 16, 17, 31, 32, 33, 65)
    ] + [("hifigan", x_hifi, hifigan), ("tones", x_tones, spiral)]
    worst = {}
    for name, xx, (w, f, kw0) in cases:
        kw = dict(kw0, num_frames=1 + (xx.shape[1] - kw0["n_fft"]) // kw0["hop_length"])
        out = fused_logmel(xx, w, f, **kw)
        p32 = logmel_plain(xx, w, f, **kw)
        p64 = logmel_plain(xx.double(), w.double(), f.double(), **kw)
        torch.cuda.synchronize()
        check(out.shape == p32.shape and bool(torch.isfinite(out).all()), f"K1 {name}: bad output")
        e32 = (out - p32).abs().max().item()
        e64 = (out.double() - p64).abs().max().item()
        p_e64 = (p32.double() - p64).abs().max().item()
        lim32, lim64 = K1_ATOL_PLAIN32, K1_ATOL_PLAIN64
        if name == "tones":
            # plain fp32 is itself p_e64 off the float64 value here: K1 is held
            # to 2e-4 and to p_e64 + 1e-4 of float64, and so to p_e64 + 2e-4
            # of plain fp32
            lim32, lim64 = p_e64 + K1_ATOL_PLAIN32, min(K1_ATOL_PLAIN64, p_e64 + 1e-4)
        log(f"[2 K1 {name}] shape {tuple(out.shape)}: max|K1-plain32| {e32:.3e} (limit "
            f"{lim32:.1e}), max|K1-plain64| {e64:.3e} (limit {lim64:.1e}); plain32 "
            f"itself {p_e64:.3e} off plain64")
        check(e32 <= lim32, f"K1 {name}: {e32} > {lim32} vs plain fp32")
        check(e64 <= lim64, f"K1 {name}: {e64} > {lim64} vs plain fp64")
        worst[name] = (e32, e64, p_e64)
    kw = dict(spiral[2], num_frames=1 + (x.shape[1] - 512) // 160)
    # warm (tables built): a call copies nothing to the card and never syncs
    fused_logmel(x, window, fb, **kw)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_logmel(x, window, fb, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the least work for the function: a real FFT (2.5 N log2 N), the power,
    # the mel product over the filterbank's nonzeros and the log per frame;
    # wav, window, filterbank in, the log-mel out
    frames, n_freq, n_mels = BATCH * kw["num_frames"], fb.shape[1], fb.shape[0]
    nnz = int((fb != 0).sum().item())
    k1_bound = roofline(frames * (2.5 * 512 * 9 + 3 * n_freq + 2 * nnz + n_mels),
                        4 * (x.numel() + 512 + fb.numel() + frames * n_mels))
    hw, hf, hkw = hifigan
    hkw = dict(hkw, num_frames=1 + (x_hifi.shape[1] - 1024) // 256)
    # K1 is timed as 10 calls back to back per sample: a single call is near
    # the host's launch overhead, which the device would idle through
    hifi_ms = cuda_ms(lambda: fused_logmel(x_hifi, hw, hf, **hkw), reps=10)
    hifi_plain_ms = cuda_ms(lambda: logmel_plain(x_hifi, hw, hf, **hkw), reps=10)
    tones = worst.pop("tones")
    res = {
        # against plain fp32 on the cases held to 2e-4; the tones in "shape"
        "max_abs_err": max(e32 for e32, _, _ in worst.values()),
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": None,  # no one PyTorch call computes the log-mel
        "ms": cuda_ms(lambda: fused_logmel(x, window, fb, **kw), reps=10),
        "plain_ms": cuda_ms(lambda: logmel_plain(x, window, fb, **kw), reps=10),
        "shape": f"wav {tuple(x.shape)} -> {(BATCH, kw['num_frames'], 128)}, tables built, "
                 f"{nnz} filterbank nonzeros; HiFi-GAN wav {tuple(x_hifi.shape)} -> "
                 f"{(4, hkw['num_frames'], 80)}: {hifi_ms:.4f} ms vs plain {hifi_plain_ms:.4f} ms; "
                 f"max error against float64 {max(e64 for _, e64, _ in worst.values()):.3e}; "
                 f"on tones over noise {tones[1]:.3e} against float64 (plain fp32 itself "
                 f"{tones[2]:.3e}), {tones[0]:.3e} against plain fp32",
    }
    log(f"    K1 no host copy or sync once warm; HiFi-GAN {hifi_ms:.4f} ms, plain "
        f"{hifi_plain_ms:.4f} ms; bound at the SPIRAL shape {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}, {nnz} nonzeros)")
    return res


def phase_k2(torch, gen):
    from tpu_speech_torch.ops.fused_attention import (
        fused_qkv_self_attention,
        qkv_attention_plain,
    )

    dev = "cuda"
    res = {}
    for t, e, h in ((604, 512, 8), (302, 768, 12)):
        qkv = torch.randn(BATCH, t, 3 * e, generator=gen).to(dev)
        qkv[..., :e] *= (e // h) ** -0.5  # the folded q scale
        lens = torch.linspace(0.3 * t, t, BATCH).round().long().to(dev)
        lens[0] = 0  # one fully padded row
        mask = torch.arange(t, device=dev)[None, :] >= lens[:, None]
        out = fused_qkv_self_attention(qkv, h, mask)
        ref = qkv_attention_plain(qkv, h, mask)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        log(f"[3 K2 T={t} E={e} H={h}] max|K2-plain| {err:.3e}, fully padded "
            f"row finite: {bool(torch.isfinite(out[0]).all())}")
        check(bool(torch.isfinite(out).all()), f"K2 T={t}: non-finite output")
        check(err <= K2_ATOL, f"K2 T={t}: {err} > {K2_ATOL}")
        res[t] = dict(
            err=err,
            ms=cuda_ms(lambda: fused_qkv_self_attention(qkv, h, mask)),
            plain_ms=cuda_ms(lambda: qkv_attention_plain(qkv, h, mask)),
        )
        log(f"    K2 {res[t]['ms']:.3f} ms, plain {res[t]['plain_ms']:.3f} ms")
    return {
        "max_abs_err": max(r["err"] for r in res.values()),
        "ms": res[604]["ms"],
        "plain_ms": res[604]["plain_ms"],
        "shape": f"qkv (14, 604, 1536) H=8; at (14, 302, 2304) H=12: "
                 f"{res[302]['ms']:.4f} ms vs plain {res[302]['plain_ms']:.4f} ms",
    }


def _k2_case(torch, gen, b, t, e, h, dev="cuda"):
    """The merged plane at one shape; lengths over 30-100 % of T, row 0
    fully padded."""
    qkv = torch.randn(b, t, 3 * e, generator=gen).to(dev)
    qkv[..., :e] *= (e // h) ** -0.5  # the folded q scale
    lens = torch.linspace(0.3 * t, t, b).round().long().to(dev)
    lens[0] = 0
    mask = torch.arange(t, device=dev)[None, :] >= lens[:, None]
    return qkv, mask


def phase_k2_dropout(torch, gen):
    from tpu_speech_torch.ops.fused_attention import (
        fused_qkv_self_attention,
        qkv_attention_plain,
    )

    worst, timed = 0.0, None
    for b, t, e, h in K2_TRAIN_SHAPES:
        qkv, mask = _k2_case(torch, gen, b, t, e, h)
        out = fused_qkv_self_attention(qkv, h, mask, DROP_P, 1234)
        ref = qkv_attention_plain(qkv, h, mask, DROP_P, 1234)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        check(bool(torch.isfinite(out).all()), f"K2 dropout T={t}: non-finite output")
        check(err <= K2_ATOL, f"K2 dropout T={t}: {err} > {K2_ATOL}")
        # the kernel's own mask: q = 0 makes every row uniform over its T keys
        # and v = 1 makes each output the row's kept share / (1 - p)
        probe = torch.zeros_like(qkv)
        probe[..., 2 * e:] = 1.0
        share = fused_qkv_self_attention(probe, h, None, DROP_P, 99)[..., ::e // h]
        share = share * (1 - DROP_P)  # (B, T, H): kept keys / T per row
        rate = share.mean().item()
        n = b * h * t * t
        sigma = (DROP_P * (1 - DROP_P) / n) ** 0.5
        other_seed = fused_qkv_self_attention(probe, h, None, DROP_P, 100)[..., ::e // h]
        differ = (not torch.equal(share[0, :, 0], share[0, :, 1])
                  and not torch.equal(share[0, :, 0], share[1, :, 0])
                  and not torch.equal(share, other_seed * (1 - DROP_P)))
        log(f"[7 K2 dropout T={t} E={e} H={h}] max|K2-plain replay| {err:.3e}; kernel "
            f"keep rate {rate:.5f} (0.9 +- 4 sigma = {4 * sigma:.1e}); masks differ "
            f"across (b, h) and seeds: {differ}")
        check(abs(rate - (1 - DROP_P)) <= 4 * sigma, f"keep rate {rate}")
        check(differ, "dropout masks repeat across (b, h) or seeds")
        if timed is None:
            q, k, v = qkv_views(qkv, h)
            lib_ms = cuda_ms(lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), mask, DROP_P))
            bound_ms, bound_by = attention_bound(b, t, h, e // h, backward=False)
            timed = dict(
                ms=cuda_ms(lambda: fused_qkv_self_attention(qkv, h, mask, DROP_P, 1234)),
                plain_ms=cuda_ms(lambda: qkv_attention_plain(qkv, h, mask, DROP_P, 1234)),
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            log(f"    K2 fwd p=0.1 at {(b, t, 3 * e)}: {timed['ms']:.3f} ms, plain "
                f"{timed['plain_ms']:.3f} ms, SDPA {lib_ms:.3f} ms, bound {bound_ms:.4f} ms")
    return worst, timed


def phase_k2_bwd(torch, gen):
    from tpu_speech_torch.ops import fused_attention as fa

    res = {}
    for b, t, e, h in K2_TRAIN_SHAPES:
        qkv, mask = _k2_case(torch, gen, b, t, e, h)
        dout = torch.randn(b, t, e, generator=gen).to("cuda")
        for p in (0.0, DROP_P):
            grads = []
            for fn in (fa.fused_qkv_self_attention, fa.qkv_attention_plain):
                x = qkv.clone().requires_grad_(True)
                fn(x, h, mask, p, 4321).backward(dout)
                grads.append(x.grad)
            torch.cuda.synchronize()
            got, ref = grads
            err = (got - ref).abs().max().item()
            bound = K2_BWD_RTOL * max(1.0, ref.abs().max().item())
            log(f"[8 K2-bwd T={t} E={e} H={h} p={p}] max|dqkv kernel - autograd plain| "
                f"{err:.3e} (bound {bound:.2e}); padded row dq, dk zero: "
                f"{got[0, :, :2 * e].abs().max().item() == 0.0}")
            check(bool(torch.isfinite(got).all()), f"K2-bwd T={t}: non-finite")
            check(err <= bound, f"K2-bwd T={t} p={p}: {err} > {bound}")
            res[(t, p)] = err
    # times at the student's block-1 shape with dropout: backward alone and
    # forward + backward, each beside the plain version
    b, t, e, h = STEP_SHAPES[0]
    qkv, mask = _k2_case(torch, gen, b, t, e, h)
    dout = torch.randn(b, t, e, generator=gen).to("cuda")
    seed, thresh = 4321, fa.dropout_threshold(DROP_P)
    scale = 1.0 / (1.0 - DROP_P)
    out, lse = fa._launch_fwd(qkv, mask, h, seed, thresh, scale, True)
    x = qkv.clone().requires_grad_(True)
    plain_out = fa.qkv_attention_plain(x, h, mask, DROP_P, seed)

    def fwd_bwd(fn):
        y = qkv.clone().requires_grad_(True)
        fn(y, h, mask, DROP_P, seed).backward(dout)

    _, lib_bwd = sdpa_times(torch, *qkv_views(qkv, h), mask,
                            dout.view(b, t, h, e // h), DROP_P)
    bound_ms, bound_by = attention_bound(b, t, h, e // h, backward=True)
    t_k = dict(
        ms=cuda_ms(lambda: fa._launch_bwd(qkv, mask, out, dout, lse, h, seed, thresh, scale)),
        plain_ms=cuda_ms(lambda: torch.autograd.grad(plain_out, x, dout, retain_graph=True)),
        fb_ms=cuda_ms(lambda: fwd_bwd(fa.fused_qkv_self_attention)),
        fb_plain_ms=cuda_ms(lambda: fwd_bwd(fa.qkv_attention_plain)),
        library_ms=lib_bwd, bound_ms=bound_ms, bound_by=bound_by,
    )
    log(f"    K2-bwd at {(b, t, 3 * e)} p=0.1: backward {t_k['ms']:.3f} ms vs plain "
        f"{t_k['plain_ms']:.3f} ms, SDPA's backward {lib_bwd:.3f} ms, bound "
        f"{bound_ms:.4f} ms; forward + backward {t_k['fb_ms']:.3f} vs "
        f"{t_k['fb_plain_ms']:.3f} ms")
    return max(res.values()), t_k


def write_pretrain_corpus(root, rng, n):
    """n speech-like int16 wavs of 4-20 s and a manifest named as the
    config's first train manifest, so --manifest_dir finds it."""
    import scipy.io.wavfile

    with open(os.path.join(root, "librivox-train-clean-100.json"), "w") as f:
        for i, d in enumerate(rng.uniform(4.0, 20.0, size=n)):
            path = os.path.join(root, f"pre{i:03d}.wav")
            pcm = np.clip(speech_like(rng, int(d * SR)) * 32767, -32768, 32767)
            scipy.io.wavfile.write(path, SR, pcm.astype(np.int16))
            f.write(json.dumps({"audio_filepath": path, "duration": float(d),
                                "text": ""}) + "\n")
    for other in ("librivox-train-clean-360.json", "librivox-train-other-500.json"):
        open(os.path.join(root, other), "w").close()


def _max_diff(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def phase_pretrain_slice(torch, rng, root):
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder
    from tpu_speech_torch.ops import _build

    write_pretrain_corpus(root, rng, PRETRAIN_STEPS * PRETRAIN_BATCH)
    run_dir = os.path.join(root, "pretrain")
    # a 2-step warmup instead of 32 000, so that a few steps move the
    # parameters far beyond rounding and the EMA's pull shows
    argv = ["--model_type", "st2vec", "--run_mode", "train",
            "--config_name", "spiral_base_pretrain_ls960", "--manifest_dir", root,
            "--model_save_dir", run_dir, "--set", f"trainer.max_steps={PRETRAIN_STEPS}",
            "--set", "model.optim.sched.warmup_steps=2"]
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_spiral.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = res["steps"]
    kept_t = sum(m["teacher_layers"] for m in steps)
    kept_s = sum(m["student_layers"] for m in steps)
    log(f"[9 pretrain slice] {len(steps)} steps of B = {PRETRAIN_BATCH} x 250 000 "
        f"samples through run_spiral.main in {wall:.1f} s (model build, data, steps); "
        f"launches {launches}; kept layers teacher {kept_t}, student {kept_s}")
    for i, m in enumerate(steps):
        log(f"    step {i}: loss {m['loss']:.4f} acc {m['accuracy']:.4f} "
            f"momentum {m['momentum']:.6f} lr {m['lr']:.3e}")
    check(len(steps) == PRETRAIN_STEPS, f"{len(steps)} steps ran")
    check(launches["fused_logmel"] == 2 * len(steps), f"K1 launches {launches}")
    check(launches["fused_qkv_attention"] == kept_t + kept_s, f"K2-fwd launches {launches}")
    check(launches["fused_qkv_attention_bwd"] == kept_s, f"K2-bwd launches {launches}")
    check(launches["grouped_conv1d"] == 4 * len(steps), f"K4 launches {launches}")
    check(launches["grouped_conv1d_dx"] == 2 * len(steps), f"K4-dx launches {launches}")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["accuracy"]) for m in steps),
          "non-finite loss or accuracy")
    cfg = spiral_base_pretrain_ls960()
    init = ST2VecEncoder(cfg.model.encoder, pretraining=True)
    init.init_weights(torch.Generator().manual_seed(0))
    init_sd, sd = init.state_dict(), torch.load(res["state_dict"], weights_only=True)
    check(sd.keys() == init_sd.keys(), "saved state_dict keys")
    stu = [k for k in sd if k.startswith(("feature_encoder.", "projector."))
           and sd[k].is_floating_point()]
    d_student = _max_diff([sd[k] for k in stu], [init_sd[k] for k in stu])
    d_teacher = _max_diff([sd["target_" + k] for k in stu], [init_sd["target_" + k] for k in stu])
    log(f"    max |change| from the init: student {d_student:.3e}, teacher "
        f"{d_teacher:.3e} (EMA)")
    check(d_student > 0 and 0 < d_teacher < d_student, "student/teacher did not move as expected")
    return launches, res["state_dict"]


def phase_pretrain_cpu_vs_card(torch):
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
    from tpu_speech_torch.train import spiral as tspiral

    enc = spiral_base_pretrain_ls960().model.encoder
    blocks = tuple(dataclasses.replace(b, transformer=dataclasses.replace(
        b.transformer, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        encoder_layerdrop=0.0), conv_layers=tuple(
            dataclasses.replace(c, dropout=0.0) for c in b.conv_layers)) for b in enc.blocks)
    enc = dataclasses.replace(enc, blocks=blocks, dither=0.0)
    n = 4 * SR
    spec_len = ((1 + n // 160 + 15) // 16) * 16
    r = np.random.default_rng(5)
    wavs = np.stack([speech_like(r, n) for _ in range(2)])
    lens = np.array([n, 3 * SR], np.int32)
    wavs[1, lens[1]:] = 0
    batch = tspiral.host_augment_batch(enc, wavs, lens, wavs * 0.8, lens, spec_len,
                                       np.random.default_rng(6), np.random.default_rng(7))
    t_out = spec_len // 8
    feat_lens = torch.tensor(np.ceil(lens / 160).astype(np.int64))
    for _ in range(3):
        feat_lens = (feat_lens + 1) // 2
    neg = draw_negative_indices(feat_lens, t_out, enc.n_negatives,
                                torch.Generator().manual_seed(8))
    results = []
    for dev in ("cpu", "cuda"):
        model = ST2VecEncoder(enc, pretraining=True)
        model.init_weights(torch.Generator().manual_seed(3))
        model.to(dev)
        teacher0 = [p.detach().clone() for p in model.teacher_parameters()]
        state = tspiral.make_pretrain_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
        m = tspiral.pretrain_step(state, tspiral.batch_to_device(batch, dev),
                                  DropoutRng.seeded(0, dev), neg_idx=neg.to(dev))
        results.append((model, float(m["loss"]), m["momentum"], teacher0))
    (cpu, l_cpu, _, _), (card, l_card, mom, t0) = results
    names = [n for n, p in card.named_parameters() if p.requires_grad]
    g_cpu = dict((n, p.grad) for n, p in cpu.named_parameters() if p.requires_grad)
    g_card = dict((n, p.grad.cpu()) for n, p in card.named_parameters() if p.requires_grad)
    g_max = max(g_cpu[k].abs().max().item() for k in names)
    worst, worst_name = 0.0, ""
    for k in names:
        bound_ref = max(g_cpu[k].abs().max().item(), 1e-2 * g_max)
        rel = (g_card[k] - g_cpu[k]).abs().max().item() / bound_ref
        if rel > worst:
            worst, worst_name = rel, k
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    # EMA on the card: teacher = m * teacher0 + (1 - m) * student (after SGD)
    student = [p for _, s in card._pairs() for p in s.parameters()]
    ema_err = max((t - (t_old * mom + s.detach() * (1 - mom))).abs().max().item()
                  for t, t_old, s in zip(card.teacher_parameters(), t0, student))
    log(f"[10 pretrain card vs cpu] B = 2 x 4 s, one SGD(lr=1) step: loss card "
        f"{l_card:.6f} cpu {l_cpu:.6f} (rel {rel_loss:.2e}, limit {STEP_LOSS_RTOL}); "
        f"worst gradient {worst:.2e} x its max|g| ({worst_name}; limit {GRAD_RTOL}) over "
        f"{len(names)} tensors; EMA max error {ema_err:.2e}")
    check(rel_loss <= STEP_LOSS_RTOL, f"loss card {l_card} vs cpu {l_cpu}")
    check(worst <= GRAD_RTOL, f"gradient {worst_name}: {worst} x max|g|")
    check(ema_err <= 1e-6, f"EMA update off by {ema_err}")


def phase_pretrain_time(torch, root):
    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner

    cfg = spiral_base_pretrain_ls960()
    cfg.model.train_ds.manifest_filepath = os.path.join(root, "librivox-train-clean-100.json")
    runner = SpiralPretrainRunner(cfg, os.path.join(root, "timed"), device="cuda")
    batch = runner.device_batch(next(iter(runner.loader)))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: runner.step(batch), n=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[11 pretrain step time] B = 24 x 250 000 samples, batch on the card: "
        f"{ms:.2f} ms per step (median of 10), peak device memory {peak:.2f} GiB")
    profile_slice(torch, lambda: runner.step(batch), batches=3, top=12, tag="11 profile")
    return ms, peak


def phase_k4(torch, gen):
    from tpu_speech_torch.ops import fused_posconv as fp
    from tpu_speech_torch.ops.fused_posconv import grouped_conv1d, grouped_conv1d_plain

    worst, worst_dx, times = 0.0, 0.0, {}
    for b, t, c in K4_SHAPES:
        cg, k = c // 16, 128
        x = torch.randn(b, t, c, generator=gen).to("cuda")
        w = (torch.randn(c, cg, k, generator=gen) * (cg * k) ** -0.5).to("cuda")
        errs = []
        for left in (64, 63, 127):  # the forward, dx's and the causal pad
            out = grouped_conv1d(x, w, 16, left)
            ref = grouped_conv1d_plain(x, w, 16, left)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            bound = K4_RTOL * max(1.0, ref.abs().max().item())
            check(bool(torch.isfinite(out).all()), f"K4 {(b, t, c)}: non-finite")
            check(err <= bound, f"K4 {(b, t, c)} left {left}: {err} > {bound}")
            errs.append(err)
        dy = torch.randn(b, t, c, generator=gen).to("cuda")
        grads = []
        for fn in (grouped_conv1d, grouped_conv1d_plain):
            xx = x.clone().requires_grad_(True)
            ww = w.clone().requires_grad_(True)
            fn(xx, ww, 16, 64).backward(dy)
            grads.append((xx.grad, ww.grad))
        torch.cuda.synchronize()
        (gx, gw), (rx, rw) = grads
        e_dx = (gx - rx).abs().max().item()
        e_dw = (gw - rw).abs().max().item()
        check(e_dx <= K4_RTOL * max(1.0, rx.abs().max().item()), f"K4-dx {(b, t, c)}: {e_dx}")
        check(e_dw <= K4_RTOL * max(1.0, rw.abs().max().item()), f"K4 dw {(b, t, c)}: {e_dw}")
        worst, worst_dx = max(worst, *errs), max(worst_dx, e_dx)

        def fwd_bwd(fn):
            xx = x.clone().requires_grad_(True)
            ww = w.clone().requires_grad_(True)
            fn(xx, ww, 16, 64).backward(dy)

        # dx alone: K4 on the rearranged weights, as the backward runs it,
        # against the plain version's input gradient alone
        xg = x.clone().requires_grad_(True)
        plain_y = grouped_conv1d_plain(xg, w, 16, 64)
        # the library calls: one cuDNN convolution on the padded (B, C, T)
        # input, and its input gradient (padded, the pad rows cut by a view)
        xp = torch.nn.functional.pad(x.transpose(1, 2), (64, 63)).contiguous()
        dyt = dy.transpose(1, 2).contiguous()
        flop = 2 * b * t * c * cg * k
        conv_bytes = 4 * (2 * b * t * c + c * cg * k)  # x and out, w
        r = times[(b, t, c)] = dict(
            library_ms=cuda_ms(lambda: torch.nn.functional.conv1d(xp, w, groups=16)),
            dx_library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
                xp.shape, w, dyt, groups=16)),
            bound=roofline(flop, conv_bytes),
            ms=cuda_ms(lambda: grouped_conv1d(x, w, 16, 64)),
            plain_ms=cuda_ms(lambda: grouped_conv1d_plain(x, w, 16, 64)),
            dx_ms=cuda_ms(lambda: fp._launch(dy, fp._dx_weights(w, 16), 63, "grouped_conv1d_dx")),
            dx_plain_ms=cuda_ms(lambda: torch.autograd.grad(plain_y, xg, dy, retain_graph=True)),
            fb_ms=cuda_ms(lambda: fwd_bwd(grouped_conv1d)),
            fb_plain_ms=cuda_ms(lambda: fwd_bwd(grouped_conv1d_plain)))
        log(f"[12 K4 {(b, t, c)} Cg={cg} K=128] max|K4-plain| at left pads 64/63/127 "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}; dx {e_dx:.3e}, dw {e_dw:.3e}; "
            f"forward {r['ms']:.3f} ms ({flop / r['ms'] / 1e9:.1f} TFLOP/s) vs plain "
            f"{r['plain_ms']:.3f} ms, cuDNN's conv alone {r['library_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4f} ms; dx {r['dx_ms']:.3f} vs {r['dx_plain_ms']:.3f} ms "
            f"(cuDNN's dgrad alone {r['dx_library_ms']:.3f}); forward + backward "
            f"{r['fb_ms']:.3f} vs {r['fb_plain_ms']:.3f} ms")
    return worst, worst_dx, times


def phase_k3(torch, gen):
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.ops import fused_attention as fa

    _build.reset_launches()
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases = {}
    for b, t, h, d in K3_SHAPES:
        q, k, v = (torch.randn(b, t, h, d, generator=gen).to("cuda") for _ in range(3))
        q = q * d ** -0.5
        lens = torch.linspace(0.3 * t, t, b).round().long().to("cuda")
        lens[0] = 0  # one fully padded row
        mask = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        dout = torch.randn(b, t, h, d, generator=gen).to("cuda")
        cases[(b, t, h, d)] = (q, k, v, mask, dout)
        for p in (0.0, DROP_P):
            res = []
            for fn in (fa.fused_self_attention, fa.attention_plain):
                xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
                out = fn(*xs, mask, p, 4321)
                out.backward(dout)
                res.append([out.detach()] + [x.grad for x in xs])
            torch.cuda.synchronize()
            e_out = (res[0][0] - res[1][0]).abs().max().item()
            e_grad = max((g - r).abs().max().item() / max(1.0, r.abs().max().item())
                         for g, r in zip(res[0][1:], res[1][1:]))
            pad_zero = res[0][1][0].abs().max().item() == 0.0
            log(f"[13 K3 {(b, t, h, d)} p={p}] max|K3-plain| {e_out:.3e}; dq, dk, dv "
                f"{e_grad:.3e} x max(1, max|plain|); padded row dq zero: {pad_zero}")
            check(all(bool(torch.isfinite(a).all()) for a in res[0]), "K3: non-finite")
            check(e_out <= K2_ATOL, f"K3 {(b, t, h, d)} p={p}: {e_out}")
            check(e_grad <= K2_BWD_RTOL, f"K3-bwd {(b, t, h, d)} p={p}: {e_grad}")
            check(pad_zero, "K3-bwd: dq of the fully padded row")
            worst["fwd"], worst["bwd"] = max(worst["fwd"], e_out), max(worst["bwd"], e_grad)
    launches = dict(_build.LAUNCHES)
    # times, K3 beside its plain version and beside K2 on the same data
    t_k = {}
    for shape, (q, k, v, mask, dout) in cases.items():
        b, t, h, d = shape
        seed, thresh, scale = 4321, fa.dropout_threshold(DROP_P), 1.0 / (1.0 - DROP_P)
        out, lse = fa._launch_attn_fwd(q, k, v, mask, seed, thresh, scale, True)
        xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
        plain_out = fa.attention_plain(*xs, mask, DROP_P, seed)
        qkv = torch.cat([a.reshape(b, t, h * d) for a in (q, k, v)], -1).contiguous()

        def fb3(fn):
            ys = [a.clone().requires_grad_(True) for a in (q, k, v)]
            fn(*ys, mask, DROP_P, seed).backward(dout)

        def fb2():
            y = qkv.clone().requires_grad_(True)
            fa.fused_qkv_self_attention(y, h, mask, DROP_P, seed).backward(
                dout.reshape(b, t, h * d))

        r = t_k[shape] = dict(
            ms=cuda_ms(lambda: fa.fused_self_attention(q, k, v, mask, DROP_P, seed)),
            plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, mask, DROP_P, seed)),
            bwd_ms=cuda_ms(lambda: fa._launch_attn_bwd(q, k, v, mask, out, dout, lse, seed,
                                                       thresh, scale)),
            bwd_plain_ms=cuda_ms(lambda: torch.autograd.grad(plain_out, xs, dout,
                                                             retain_graph=True)),
            fb_ms=cuda_ms(lambda: fb3(fa.fused_self_attention)),
            fb_plain_ms=cuda_ms(lambda: fb3(fa.attention_plain)),
            k2_ms=cuda_ms(lambda: fa.fused_qkv_self_attention(qkv, h, mask, DROP_P, seed)),
            k2_fb_ms=cuda_ms(fb2))
        r["library_ms"], r["bwd_library_ms"] = sdpa_times(torch, q, k, v, mask, dout, DROP_P)
        r["bound"], r["bwd_bound"] = (attention_bound(b, t, h, d, backward=False),
                                      attention_bound(b, t, h, d, backward=True))
        log(f"    K3 at {shape} p=0.1: forward {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} "
            f"(K2 {r['k2_ms']:.3f}, SDPA {r['library_ms']:.3f}, bound {r['bound'][0]:.4f}); "
            f"backward {r['bwd_ms']:.3f} vs plain {r['bwd_plain_ms']:.3f} (SDPA "
            f"{r['bwd_library_ms']:.3f}, bound {r['bwd_bound'][0]:.4f}); forward + backward "
            f"{r['fb_ms']:.3f} vs plain {r['fb_plain_ms']:.3f} (K2 {r['k2_fb_ms']:.3f})")
    return worst, t_k, launches


CHARS = "abcdefghijklmnopqrstuvwxyz'"


def random_transcript(rng, seconds):
    """About 12 characters a second: words of 2-8 random letters."""
    words, n = [], 0
    while n < 12 * seconds:
        w = "".join(rng.choice(list(CHARS), size=int(rng.integers(2, 9))))
        words.append(w)
        n += len(w) + 1
    return " ".join(words)


def write_finetune_corpus(root, rng, n_train, n_dev):
    """Speech-like int16 wavs of 4-20 s with random transcripts, under the
    config's train and dev manifest names, so --manifest_dir finds them."""
    import scipy.io.wavfile

    for name, n in (("librivox-train-clean-100.json", n_train),
                    ("librivox-dev-other.json", n_dev)):
        with open(os.path.join(root, name), "w") as f:
            for i, d in enumerate(rng.uniform(4.0, 20.0, size=n)):
                path = os.path.join(root, f"{name[9:14]}{i:03d}.wav")
                pcm = np.clip(speech_like(rng, int(d * SR)) * 32767, -32768, 32767)
                scipy.io.wavfile.write(path, SR, pcm.astype(np.int16))
                f.write(json.dumps({"audio_filepath": path, "duration": float(d),
                                    "text": random_transcript(rng, d)}) + "\n")


def phase_finetune_slice(torch, rng, root, st2vec_pt):
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner

    write_finetune_corpus(root, rng, FT_STEPS * BATCH, BATCH)
    run_dir = os.path.join(root, "finetune")
    argv = ["--model_type", "ctc_finetune", "--run_mode", "train",
            "--config_name", "spiral_base_finetune_ls100_char", "--manifest_dir", root,
            "--init_chkpt_dir", os.path.dirname(st2vec_pt),
            "--init_chkpt_file", os.path.basename(st2vec_pt), "--model_save_dir", run_dir,
            "--set", f"trainer.max_steps={FT_STEPS}",
            "--set", f"model.freeze_finetune_updates={FT_FROZEN}",
            "--set", "model.optim.sched.warmup_ratio=0", "--set", f"model.optim.lr={FT_LR}",
            "--set", "trainer.val_check_interval_epochs=1"]
    # watch each step: its launches, and the parameters before and after it
    # (validation's inference comes after the last step)
    seen, step = [], SpiralFinetuneRunner.step

    def watched(self, batch):
        if not seen:
            seen.append((None, {n: p.detach().clone() for n, p in self.model.named_parameters()}))
        _build.reset_launches()
        m = step(self, batch)
        torch.cuda.synchronize()
        seen.append((dict(_build.LAUNCHES),
                     {n: p.detach().clone() for n, p in self.model.named_parameters()}))
        return m

    SpiralFinetuneRunner.step = watched
    t0 = time.perf_counter()
    try:
        res = run_spiral.main(argv)
    finally:
        SpiralFinetuneRunner.step = step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = res["steps"]
    check(len(steps) == FT_STEPS and len(seen) == FT_STEPS + 1, f"{len(steps)} steps ran")
    wd = 0.01  # the config's AdamW weight decay
    totals = dict.fromkeys(seen[1][0], 0)
    for i, m in enumerate(steps):
        launches, after = seen[i + 1]
        before = seen[i][1]
        for name in totals:
            totals[name] += launches[name]
        frozen = i < FT_FROZEN
        dec = max((after[n] - before[n]).abs().max().item() for n in after
                  if n.startswith("decoder."))
        decay = 1.0 - m["lr"] * wd
        # > 0 where an encoder element is off p * (1 - lr * wd) by more than 1e-6 |p|
        enc_off = max(((after[n] - before[n] * decay).abs()
                       - 1e-6 * before[n].abs()).max().item()
                      for n in after if n.startswith("encoder."))
        log(f"    finetune step {i} ({'frozen' if frozen else 'unfrozen'}): loss "
            f"{m['loss']:.4f}, lr {m['lr']:.3e}, kept layers {m['layers']}, launches "
            f"{launches}; decoder max|change| {dec:.3e}; encoder beyond p*(1 - lr*wd) "
            f"+ 1e-6|p|: {enc_off:.3e}")
        check(m["frozen"] == frozen, f"step {i}: frozen {m['frozen']}")
        check(np.isfinite(m["loss"]), f"step {i}: loss {m['loss']}")
        check(launches["fused_logmel"] == 1, f"step {i}: K1 {launches}")
        check(launches["fused_qkv_attention"] == m["layers"], f"step {i}: K2-fwd {launches}")
        check(launches["grouped_conv1d"] == 2, f"step {i}: K4 {launches}")
        check(launches["fused_qkv_attention_bwd"] == (0 if frozen else m["layers"]),
              f"step {i}: K2-bwd {launches}")
        check(launches["grouped_conv1d_dx"] == (0 if frozen else 2), f"step {i}: K4-dx {launches}")
        check(dec > 0, f"step {i}: the decoder did not move")
        if frozen:
            check(enc_off <= 0, f"step {i}: the frozen encoder moved beyond its decay")
        else:
            check(enc_off > 0, f"step {i}: the encoder moved by its decay alone")
    val = res["validation"]
    log(f"[14 finetune slice] {FT_STEPS} steps of B = {BATCH} x 24 s through "
        f"run_spiral.main in {wall:.1f} s (model build, st2vec.pt load, data, steps, "
        f"validation of {val['n']} utts: WER {val['wer']:.3f}); launches over the "
        f"steps {totals}")
    results = run_spiral.main([
        "--model_type", "ctc_finetune", "--run_mode", "test",
        "--config_name", "spiral_base_finetune_ls100_char",
        "--test_manifest", os.path.join(root, "librivox-dev-other.json"),
        "--model_save_dir", os.path.join(root, "finetune_test"),
        "--init_chkpt_dir", run_dir, "--init_chkpt_file", os.path.basename(res["state_dict"])])
    log(f"    --run_mode test on the saved {os.path.basename(res['state_dict'])}: "
        f"{results['n']} utts, WER {results['wer']:.3f}")
    check(results["n"] == BATCH, "test mode on the saved state_dict")
    return totals


def _no_dropout_finetune_cfg():
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char

    cfg = spiral_base_ctc_char()
    enc = cfg.model.encoder
    cfg.model.encoder = dataclasses.replace(enc, dither=0.0, blocks=tuple(
        dataclasses.replace(b, transformer=dataclasses.replace(
            b.transformer, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
            encoder_layerdrop=0.0), conv_layers=tuple(
                dataclasses.replace(c, dropout=0.0) for c in b.conv_layers))
        for b in enc.blocks))
    dec = cfg.model.decoder
    cfg.model.decoder = dataclasses.replace(dec, upsample_dropout=0.0, conv_layers=tuple(
        dataclasses.replace(c, dropout=0.0) for c in dec.conv_layers))
    return cfg


def phase_finetune_cpu_vs_card(torch):
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
    from tpu_speech_torch.train.spiral import batch_to_device
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = _no_dropout_finetune_cfg()
    n = 4 * SR
    r = np.random.default_rng(9)
    wavs = np.stack([speech_like(r, n) for _ in range(2)])
    lens = np.array([n, 3 * SR], np.int32)
    wavs[1, lens[1]:] = 0
    labels = np.zeros((2, 512), np.int32)
    label_lens = np.array([40, 30], np.int32)
    for i, m in enumerate(label_lens):
        labels[i, :m] = r.integers(0, 28, size=m)
    batch = {"wavs": wavs, "wav_lens": lens, "labels": labels, "label_lens": label_lens}
    results = []
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(3)).to(dev)
        state = make_finetune_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
        m = finetune_step(state, batch_to_device(batch, dev), DropoutRng.seeded(0, dev))
        results.append((float(m["loss"]), {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (l_cpu, g_cpu), (l_card, g_card) = results
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for k, g in g_cpu.items():
        rel = (g_card[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-2 * g_max)
        if rel > worst:
            worst, worst_name = rel, k
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    log(f"[15 finetune card vs cpu] B = 2 x 4 s, one unfrozen SGD(lr=1) step: loss card "
        f"{l_card:.6f} cpu {l_cpu:.6f} (rel {rel_loss:.2e}, limit {STEP_LOSS_RTOL}); worst "
        f"gradient {worst:.2e} x its max|g| ({worst_name}; limit {GRAD_RTOL}) over "
        f"{len(g_cpu)} tensors")
    check(rel_loss <= STEP_LOSS_RTOL, f"loss card {l_card} vs cpu {l_cpu}")
    check(worst <= GRAD_RTOL, f"gradient {worst_name}: {worst} x max|g|")


def phase_finetune_time(torch, root):
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.text.tokenizers import CharTokenizer
    from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner

    cfg = spiral_base_ctc_char()
    cfg.model.freeze_finetune_updates = 0
    cfg.model.train_ds.manifest_filepath = os.path.join(root, "librivox-train-clean-100.json")
    runner = SpiralFinetuneRunner(cfg, os.path.join(root, "ft_timed"),
                                  CharTokenizer(cfg.model.labels), device="cuda")
    batch = runner.device_batch(next(iter(runner.loader)))
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: runner.step(batch), n=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[16 finetune step time] B = 14 x 24 s, unfrozen, batch on the card: {ms:.2f} ms "
        f"per step (median of 10), peak device memory {peak:.2f} GiB")
    profile_slice(torch, lambda: runner.step(batch), batches=3, top=12, tag="16 profile")
    return ms, peak


# ---- bf16 mixed precision and gradient accumulation --------------------------

def _bf16_err(got, ref):
    """max|got - ref| / max(1, max|ref|) over tensors compared as float32."""
    return max((g.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())
               for g, r in zip(got, ref))


def _same_bits_twice(torch, run):
    """Two calls of ``run`` (a list of tensors each) give equal bits."""
    first, second = run(), run()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def _time_attention(torch, key, shape, calls, bounds):
    """Phase 17's times of the bf16 K2 or K3 forward and backward at the
    timed shape: each call (kernel, plain version, SDPA) from event to event
    (``cuda_ms``, comparable with earlier PRs), and the kernel's and SDPA's
    time a call back to back (``back_to_back_ms``)."""
    res = {}
    for k, (kernel, plain, lib), bound in zip((key + "_t", key + "_bwd_t"), calls, bounds):
        res[k] = r = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
                          back_to_back_ms=back_to_back_ms(kernel),
                          library_back_to_back_ms=back_to_back_ms(lib), bound=bound)
        log(f"    {k[:-2]} bf16 at {shape} p=0.1: {r['ms']:.4f} ms a call "
            f"({r['back_to_back_ms']:.4f} ms back to back) vs plain {r['plain_ms']:.3f} ms, SDPA "
            f"bf16 {r['library_ms']:.4f} ms a call ({r['library_back_to_back_ms']:.4f} ms back to "
            f"back), bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return res


def _scratch_bytes(torch, bwd):
    """Device memory that one call of ``bwd`` asks for beside the gradients
    it returns: the caching allocator's peak of requested bytes over the
    call, less the bytes requested before it and the gradients' bytes (the C
    entries allocate nothing of their own). Also the same from the
    allocated bytes, which count the allocator's rounding of the blocks."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    grads = bwd()
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    grads = grads if isinstance(grads, (tuple, list)) else (grads,)
    out = sum(g.nbytes for g in grads)
    return tuple(after[k + ".all.peak"] - before[k + ".all.current"] - out
                 for k in ("requested_bytes", "allocated_bytes"))


def _host_us(torch, fn, n=20):
    """Host microseconds of one call of ``fn``: the host clock over n calls
    issued after a sync (the device's queue stays far from full)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _attention_extras(torch, res, key, b, t, h, d, fa, runs, bwd):
    """Phase 17's extras for the timed K2 or K3 shape: the achieved TFLOP/s
    of the forward and the backward (the bound's FLOP count, 4 and 10 B H T^2
    D, over the time a call back to back), the backward's scratch bytes as
    the allocator saw them over one call of ``bwd``, and equal bits from two
    runs of the forward (out, lse) and the backward (dq, dk, dv) at p = 0 and
    0.1."""
    for k, units in ((key + "_t", 4), (key + "_bwd_t", 10)):
        res[k]["tflops"] = units * b * h * t * t * d / (res[k]["back_to_back_ms"] * 1e-3) / 1e12
    scratch, blocks = _scratch_bytes(torch, bwd)
    tq = -(-t // 64) * 64
    res[key + "_bwd_t"]["scratch_bytes"] = scratch
    same = {p: _same_bits_twice(torch, run) for p, run in runs.items()}
    log(f"    {key} bf16 at {(b, t, h, d)}: forward {res[key + '_t']['tflops']:.1f} TFLOP/s, "
        f"backward {res[key + '_bwd_t']['tflops']:.1f} TFLOP/s (4 and 10 B H T^2 D FLOP over "
        f"the time back to back; the backward executes 14); backward scratch {scratch} bytes "
        f"(the allocator's peak of requested bytes over one call less its gradients; "
        f"{blocks} in allocated blocks; the wrapper's formula gives "
        f"{4 * fa.bwd_scratch_floats(b, t, h, torch.bfloat16)}: L and Delta in rows of {tq}; "
        f"the mma.sync kernels' bf16 dS^T was {2 * b * h * tq * tq} bytes)")
    log(f"[17 determinism {key} bf16] two runs, out, lse, dq, dk, dv equal bit for bit: "
        + ", ".join(f"p={p}: {ok}" for p, ok in same.items()))
    check(all(same.values()), f"{key} bf16: two runs differ {same}")


def _k2_host_split(torch, res, fa, qkv, mask, out, dout, lse, h, seed, thresh, scale):
    """Host microseconds of one bf16 K2 call at the timed shape, through the
    Python wrapper and through the C entry alone (ctypes, outputs and
    scratch made beforehand): what the wrapper adds, and what the entry's
    checks, tensor-map encodes and launches take."""
    from tpu_speech_torch.ops import _build

    lib, (b, t, e3) = _build.library(), qkv.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptrs, d = fa._thirds(qkv), e3 // 3 // h
    o, ls = torch.empty_like(out), torch.empty_like(lse)
    stats = torch.empty(fa.bwd_scratch_floats(b, t, h, qkv.dtype), device="cuda")
    dqkv = torch.empty_like(qkv)
    tail = (b, t, h, d, seed, thresh, scale, stream)
    pairs = {
        "fwd": (lambda: fa.fused_qkv_self_attention(qkv, h, mask, DROP_P, seed),
                lambda: lib.tsx_attention_fwd_bf16(*ptrs, e3, mask.data_ptr(), o.data_ptr(),
                                                   ls.data_ptr(), *tail)),
        "bwd": (lambda: fa._launch_bwd(qkv, mask, out, dout, lse, h, seed, thresh, scale),
                lambda: lib.tsx_attention_bwd_bf16(
                    *ptrs, e3, mask.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    stats.data_ptr(), *fa._thirds(dqkv), e3, *tail))}
    for k, (wrapper, entry) in pairs.items():
        r = res["k2_t" if k == "fwd" else "k2_bwd_t"]
        r["host_us"], r["c_entry_host_us"] = _host_us(torch, wrapper), _host_us(torch, entry)
        check(entry() == 0, f"K2 bf16 {k}: the C entry failed")
        log(f"    k2 bf16 {k} host time a call: {r['host_us']:.1f} us through "
            f"{'fused_qkv_self_attention' if k == 'fwd' else '_launch_bwd'}, "
            f"{r['c_entry_host_us']:.1f} us through the C entry alone (its checks, tensor-map "
            f"encodes and launches, and the ctypes call)")


def phase_bf16_kernels(torch, gen):
    """17: each bf16 kernel against its plain version (which rounds at the
    kernel's points) at every shape of the paths, timed beside its plain
    version, its bound and the library's bf16 call; the attention kernels
    also for equal bits run to run, their TFLOP/s and scratch bytes."""
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.ops import fused_attention as fa
    from tpu_speech_torch.ops import fused_posconv as fp

    res = {"k2": 0.0, "k2_bwd": 0.0, "k3": 0.0, "k3_bwd": 0.0, "k4": 0.0, "k4_dx": 0.0}
    for b, t, e, h in K2_TRAIN_SHAPES:
        qkv32, mask = _k2_case(torch, gen, b, t, e, h)
        qkv = qkv32.bfloat16()
        dout = torch.randn(b, t, e, generator=gen).to("cuda").bfloat16()
        for p in (0.0, DROP_P):
            outs, grads = [], []
            for fn in (fa.fused_qkv_self_attention, fa.qkv_attention_plain):
                x = qkv.clone().requires_grad_(True)
                out = fn(x, h, mask, p, 4321)
                out.backward(dout)
                outs.append(out.detach())
                grads.append(x.grad)
            torch.cuda.synchronize()
            e_f, e_b = _bf16_err(outs[:1], outs[1:]), _bf16_err(grads[:1], grads[1:])
            log(f"[17 K2 bf16 {(b, t, 3 * e)} H={h} p={p}] max|kernel - plain| forward "
                f"{e_f:.3e} (limit {BF16_FWD_RTOL}), dqkv {e_b:.3e} (limit {BF16_GRAD_RTOL}) "
                f"x max(1, max|plain|); dtypes {outs[0].dtype}/{grads[0].dtype}")
            check(outs[0].dtype == grads[0].dtype == torch.bfloat16, "K2 bf16 dtypes")
            check(bool(torch.isfinite(outs[0]).all() and torch.isfinite(grads[0]).all()),
                  "K2 bf16: non-finite")
            check(e_f <= BF16_FWD_RTOL and e_b <= BF16_GRAD_RTOL, f"K2 bf16 T={t} p={p}")
            check(grads[0][0, :, :2 * e].abs().max().item() == 0.0, "K2 bf16: padded row dq, dk")
            res["k2"], res["k2_bwd"] = max(res["k2"], e_f), max(res["k2_bwd"], e_b)
    # times at the student's block-1 shape with dropout
    b, t, e, h = STEP_SHAPES[0]
    qkv32, mask = _k2_case(torch, gen, b, t, e, h)
    qkv = qkv32.bfloat16()
    dout = torch.randn(b, t, e, generator=gen).to("cuda").bfloat16()
    seed, thresh, scale = 4321, fa.dropout_threshold(DROP_P), 1.0 / (1.0 - DROP_P)
    out, lse = fa._launch_fwd(qkv, mask, h, seed, thresh, scale, True)
    x = qkv.clone().requires_grad_(True)
    plain_out = fa.qkv_attention_plain(x, h, mask, DROP_P, seed)
    lib_fwd, lib_bwd = sdpa_calls(torch, *qkv_views(qkv, h), mask, dout.view(b, t, h, e // h),
                                  DROP_P)
    res.update(_time_attention(torch, "k2", (b, t, 3 * e), (
        (lambda: fa.fused_qkv_self_attention(qkv, h, mask, DROP_P, seed),
         lambda: fa.qkv_attention_plain(qkv, h, mask, DROP_P, seed), lib_fwd),
        (lambda: fa._launch_bwd(qkv, mask, out, dout, lse, h, seed, thresh, scale),
         lambda: torch.autograd.grad(plain_out, x, dout, retain_graph=True), lib_bwd)),
        [attention_bound(b, t, h, e // h, bwd, itemsize=2) for bwd in (False, True)]))

    def k2_run(p):
        th, sc = fa.dropout_threshold(p) if p else 0, 1.0 / (1.0 - p)

        def run():
            o, ls = fa._launch_fwd(qkv, mask, h, seed, th, sc, True)
            return [o, ls, fa._launch_bwd(qkv, mask, o, dout, ls, h, seed, th, sc)]
        return run

    _attention_extras(torch, res, "k2", b, t, h, e // h, fa,
                      {p: k2_run(p) for p in (0.0, DROP_P)},
                      lambda: fa._launch_bwd(qkv, mask, out, dout, lse, h, seed, thresh, scale))
    _k2_host_split(torch, res, fa, qkv, mask, out, dout, lse, h, seed, thresh, scale)

    _build.reset_launches()
    for b, t, h, d in K3_SHAPES:
        q, k, v = (torch.randn(b, t, h, d, generator=gen).to("cuda") for _ in range(3))
        q, k, v = (q * d ** -0.5).bfloat16(), k.bfloat16(), v.bfloat16()
        lens = torch.linspace(0.3 * t, t, b).round().long().to("cuda")
        lens[0] = 0
        mask = torch.arange(t, device="cuda")[None, :] >= lens[:, None]
        dout = torch.randn(b, t, h, d, generator=gen).to("cuda").bfloat16()
        for p in (0.0, DROP_P):
            got = []
            for fn in (fa.fused_self_attention, fa.attention_plain):
                xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
                o = fn(*xs, mask, p, 4321)
                o.backward(dout)
                got.append([o.detach()] + [a.grad for a in xs])
            torch.cuda.synchronize()
            e_f, e_b = _bf16_err(got[0][:1], got[1][:1]), _bf16_err(got[0][1:], got[1][1:])
            log(f"[17 K3 bf16 {(b, t, h, d)} p={p}] forward {e_f:.3e}, dq dk dv {e_b:.3e} "
                f"x max(1, max|plain|)")
            check(all(a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
                      for a in got[0]), "K3 bf16: dtype or non-finite")
            check(e_f <= BF16_FWD_RTOL and e_b <= BF16_GRAD_RTOL, f"K3 bf16 T={t} p={p}")
            check(got[0][1][0].abs().max().item() == 0.0, "K3 bf16: padded row dq")
            res["k3"], res["k3_bwd"] = max(res["k3"], e_f), max(res["k3_bwd"], e_b)
    res["k3_launches"] = dict(_build.LAUNCHES)
    b, t, h, d = K3_SHAPES[0]
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to("cuda").bfloat16() for _ in range(3))
    mask = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    mask[:, int(0.8 * t):] = True
    dout = torch.randn(b, t, h, d, generator=gen).to("cuda").bfloat16()
    out, lse = fa._launch_attn_fwd(q, k, v, mask, seed, thresh, scale, True)
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    plain_out = fa.attention_plain(*xs, mask, DROP_P, seed)
    lib_fwd, lib_bwd = sdpa_calls(torch, q, k, v, mask, dout, DROP_P)
    res.update(_time_attention(torch, "k3", (b, t, h, d), (
        (lambda: fa.fused_self_attention(q, k, v, mask, DROP_P, seed),
         lambda: fa.attention_plain(q, k, v, mask, DROP_P, seed), lib_fwd),
        (lambda: fa._launch_attn_bwd(q, k, v, mask, out, dout, lse, seed, thresh, scale),
         lambda: torch.autograd.grad(plain_out, xs, dout, retain_graph=True), lib_bwd)),
        [attention_bound(b, t, h, d, bwd, itemsize=2) for bwd in (False, True)]))

    def k3_run(p):
        th, sc = fa.dropout_threshold(p) if p else 0, 1.0 / (1.0 - p)

        def run():
            o, ls = fa._launch_attn_fwd(q, k, v, mask, seed, th, sc, True)
            return [o, ls, *fa._launch_attn_bwd(q, k, v, mask, o, dout, ls, seed, th, sc)]
        return run

    _attention_extras(torch, res, "k3", b, t, h, d, fa, {p: k3_run(p) for p in (0.0, DROP_P)},
                      lambda: fa._launch_attn_bwd(q, k, v, mask, out, dout, lse, seed, thresh,
                                                  scale))

    res["k4_shapes"] = []
    for b, t, c in K4_SHAPES:
        cg = c // 16
        x, w, dy = _k4_bf16_inputs(torch, gen, b, t, c)
        errs = []
        for left in (64, 63, 127):
            out = fp.grouped_conv1d(x, w, 16, left)
            ref = fp.grouped_conv1d_plain(x, w, 16, left)
            torch.cuda.synchronize()
            errs.append(_bf16_err([out], [ref]))
            check(out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all()),
                  "K4 bf16: dtype or non-finite")
        grads = []
        for fn in (fp.grouped_conv1d, fp.grouped_conv1d_plain):
            xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            fn(xx, ww, 16, 64).backward(dy)
            grads.append((xx.grad, ww.grad))
        torch.cuda.synchronize()
        e_dx, e_dw = _bf16_err([grads[0][0]], [grads[1][0]]), _bf16_err([grads[0][1]], [grads[1][1]])
        log(f"[17 K4 bf16 {(b, t, c)} Cg={cg}] forward at left pads 64/63/127 "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, dx {e_dx:.3e}, dw {e_dw:.3e} "
            f"x max(1, max|plain|)")
        check(max(errs) <= BF16_FWD_RTOL, f"K4 bf16 {(b, t, c)}: {errs}")
        check(e_dx <= BF16_GRAD_RTOL and e_dw <= BF16_GRAD_RTOL, f"K4 bf16 dx/dw {(b, t, c)}")
        res["k4"], res["k4_dx"] = max(res["k4"], *errs), max(res["k4_dx"], e_dx)
        fwd_t, dx_t = _time_k4_bf16(torch, fp, x, w, dy)
        lib, stream, layout = _build.library(), torch.cuda.current_stream().cuda_stream, []
        for dx, fn in ((False, fp.kernel_weights), (True, fp._dx_weights)):
            wl = fn(w, 16)
            check(torch.equal(wl, fp.weights_plain(w, 16, dx)),
                  f"K4 bf16 weight layout {(b, t, c)} dx={dx}: not the plain version's bits")
            layout += [back_to_back_ms(lambda: lib.tsx_grouped_conv1d_bf16_weights(
                           w.data_ptr(), wl.data_ptr(), 16, cg, w.shape[-1], int(dx), stream)),
                       back_to_back_ms(lambda: fn(w, 16)),
                       back_to_back_ms(lambda: fp.weights_plain(w, 16, dx))]
        log(f"    k4 bf16 weight layout at {(b, t, c)}, forward and dx, back to back: the layout "
            f"kernel through its C entry {layout[0]:.4f} and {layout[3]:.4f} ms (at most the "
            f"kernel's time), through the wrapper {layout[1]:.4f} and {layout[4]:.4f}, PyTorch's "
            f"permute-copy {layout[2]:.4f} and {layout[5]:.4f}; equal bits")
        frames = _build.library().tsx_grouped_conv1d_bf16_frames(cg)
        log(f"    k4 and k4_dx bf16 at {(b, t, c)}: weights read from L2 by the tiling "
            f"({frames} frames a block, computed, not measured) "
            f"{k4_weight_l2_bytes(b, t, c, frames) / 1e6:.1f} MB a call; from device memory "
            f"not measured")
        res["k4_shapes"].append({"shape": [b, t, c], "cg": cg, "fwd": fwd_t, "dx": dx_t})
        if (b, t, c) == K4_SHAPES[0]:
            res["k4_t"], res["k4_dx_t"] = fwd_t, dx_t
    return res


def _k4_bf16_inputs(torch, gen, b, t, c, k=128):
    """Phase 17's bf16 K4 operands at one shape, drawn from ``gen``: x (B, T,
    C), w (C, C/16, K) at the scale of a unit-variance sum, dy (B, T, C)."""
    cg = c // 16
    x = torch.randn(b, t, c, generator=gen).to("cuda").bfloat16()
    w = (torch.randn(c, cg, k, generator=gen) * (cg * k) ** -0.5).to("cuda").bfloat16()
    return x, w, torch.randn(b, t, c, generator=gen).to("cuda").bfloat16()


def k4_weight_l2_bytes(b, t, c, frames, k=128, groups=16):
    """Weight bytes a K4 call reads from L2 by the tiling: every block reads
    its group's K Cg^2 bf16 weights once, and there are B G ceil(T / frames)
    blocks (computed, not measured)."""
    cg = c // groups
    return b * groups * -(-t // frames) * k * cg * cg * 2


def _time_k4_bf16(torch, fp, x, w, dy, references=True):
    """Phase 17's times of the bf16 K4 and K4-dx of the port module ``fp``
    at one shape (K 128, left pad 64 and its complement 63): a call
    (``cuda_ms``: the wrapper, the weights' rearrangement and the kernel, as
    earlier PRs timed it) and back to back (``back_to_back_ms``: the kernel
    alone on weights prepared once), the bound, the achieved TFLOP/s and
    equal bits over two runs; with ``references`` also the plain version and
    cuDNN's bf16 conv and dgrad (a call and back to back)."""
    b, t, c = x.shape
    cg, k = c // 16, w.shape[-1]
    xg = x.clone().requires_grad_(True)
    plain_y = fp.grouped_conv1d_plain(xg, w, 16, 64)
    xp = torch.nn.functional.pad(x.transpose(1, 2), (64, 63)).contiguous()
    dyt = dy.transpose(1, 2).contiguous()
    wk, wdx = fp.kernel_weights(w, 16), fp._dx_weights(w, 16)
    flop = 2 * b * t * c * cg * k
    bound = roofline(flop, 2 * (2 * b * t * c + c * cg * k), bf16=True)
    calls = {
        "fwd": (lambda: fp.grouped_conv1d(x, w, 16, 64),
                lambda: fp._launch(x, wk, 64, "grouped_conv1d"),
                lambda: fp.grouped_conv1d_plain(x, w, 16, 64),
                lambda: torch.nn.functional.conv1d(xp, w, groups=16)),
        "dx": (lambda: fp._launch(dy, fp._dx_weights(w, 16), 63, "grouped_conv1d_dx"),
               lambda: fp._launch(dy, wdx, 63, "grouped_conv1d_dx"),
               lambda: torch.autograd.grad(plain_y, xg, dy, retain_graph=True),
               lambda: torch.nn.grad.conv1d_input(xp.shape, w, dyt, groups=16))}
    out = []
    for name, (call, kernel, plain, lib) in calls.items():
        r = dict(ms=cuda_ms(call), back_to_back_ms=back_to_back_ms(kernel), bound=bound,
                 same_bits=_same_bits_twice(torch, lambda: [kernel()]))
        r["tflops"] = flop / (r["back_to_back_ms"] * 1e-3) / 1e12
        beside = ""
        if references:
            r.update(plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib),
                     library_back_to_back_ms=back_to_back_ms(lib))
            beside = (f", plain {r['plain_ms']:.3f} ms, cuDNN bf16 "
                      f"{'conv' if name == 'fwd' else 'dgrad'} {r['library_ms']:.4f} ms a call "
                      f"({r['library_back_to_back_ms']:.4f} back to back)")
        log(f"    k4{'' if name == 'fwd' else '_dx'} bf16 at {(b, t, c)} Cg {cg}: "
            f"{r['ms']:.4f} ms a call (weights rearranged), {r['back_to_back_ms']:.4f} ms back to "
            f"back ({r['tflops']:.1f} TFLOP/s){beside}, bound {bound[0]:.4f} ms ({bound[1]})")
        log(f"[17 determinism k4{'' if name == 'fwd' else '_dx'} bf16 {(b, t, c)}] two runs equal "
            f"bit for bit: {r['same_bits']}")
        check(r["same_bits"], f"K4 bf16 {name} {(b, t, c)}: two runs differ")
        out.append(r)
    return out


FP32_KERNELS = ("fused_qkv_attention", "fused_qkv_attention_bwd", "fused_attention",
                "fused_attention_bwd", "grouped_conv1d", "grouped_conv1d_dx")


def _watch_steps(torch, runner_cls, seen):
    """Wrap ``runner_cls.step`` to record each call's launches (a difference
    of the counters, which the caller zeroes once before the path) and the
    step's metrics; returns the original."""
    from tpu_speech_torch.ops import _build

    step = runner_cls.step

    def watched(self, batch):
        before = dict(_build.LAUNCHES)
        m = step(self, batch)
        torch.cuda.synchronize()
        seen.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
        return m

    runner_cls.step = watched
    return step


def phase_bf16_pretrain_slice(torch, root):
    """18: the pretrain slice with --set model.precision=bf16 through
    run_spiral.main on phase 9's corpus: per step the bf16 kernels' launches
    and no fp32 attention or K4 launch, finite losses, float32 weights
    saved."""
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner

    argv = ["--model_type", "st2vec", "--run_mode", "train",
            "--config_name", "spiral_base_pretrain_ls960", "--manifest_dir", root,
            "--model_save_dir", os.path.join(root, "pretrain_bf16"),
            "--set", f"trainer.max_steps={PRETRAIN_STEPS}",
            "--set", "model.optim.sched.warmup_steps=2", "--set", "model.precision=bf16"]
    seen = []
    step = _watch_steps(torch, SpiralPretrainRunner, seen)
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        res = run_spiral.main(argv)
    finally:
        SpiralPretrainRunner.step = step
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    steps = res["steps"]
    log(f"[18 bf16 pretrain slice] {len(steps)} steps of B = {PRETRAIN_BATCH} x 250 000 "
        f"samples with model.precision=bf16 through run_spiral.main in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    check(len(steps) == PRETRAIN_STEPS == len(seen), f"{len(steps)} steps ran")
    for i, (m, n) in enumerate(zip(steps, seen)):
        log(f"    step {i}: loss {m['loss']:.4f} acc {m['accuracy']:.4f}, kept layers "
            f"teacher {m['teacher_layers']} student {m['student_layers']}; launches "
            f"{ {k: v for k, v in n.items() if v} }")
        check(np.isfinite(m["loss"]) and np.isfinite(m["accuracy"]), f"step {i}: loss")
        check(n["fused_logmel"] == 2, f"step {i}: K1 {n}")
        check(n["fused_qkv_attention_bf16"] == m["teacher_layers"] + m["student_layers"],
              f"step {i}: K2-fwd bf16 {n}")
        check(n["fused_qkv_attention_bwd_bf16"] == m["student_layers"], f"step {i}: K2-bwd {n}")
        check(n["grouped_conv1d_bf16"] == 4 and n["grouped_conv1d_dx_bf16"] == 2,
              f"step {i}: K4 bf16 {n}")
        check(all(n[k] == 0 for k in FP32_KERNELS), f"step {i}: an fp32 kernel ran {n}")
    sd = torch.load(res["state_dict"], weights_only=True)
    check(all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point()),
          "the saved weights are not float32")
    return launches


def _pretrain_runner(root, precision="fp32", accum=1, regularised=True):
    """A SpiralPretrainRunner at spiral_base_pretrain_ls960 on phase 9's
    corpus; without regularisers: dither, dropout and layerdrop off."""
    import dataclasses

    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner

    cfg = spiral_base_pretrain_ls960()
    cfg.model.train_ds.manifest_filepath = os.path.join(root, "librivox-train-clean-100.json")
    cfg.model.precision = precision
    cfg.trainer.accumulate_grad_batches = accum
    if not regularised:
        enc = cfg.model.encoder
        cfg.model.encoder = dataclasses.replace(enc, dither=0.0, blocks=tuple(
            dataclasses.replace(b, transformer=dataclasses.replace(
                b.transformer, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                encoder_layerdrop=0.0), conv_layers=tuple(
                    dataclasses.replace(c, dropout=0.0) for c in b.conv_layers))
            for b in enc.blocks))
    return SpiralPretrainRunner(cfg, os.path.join(root, f"timed_{precision}_{accum}"),
                                device="cuda")


def _timed_step(torch, fn, n=10):
    """(median ms of ``fn`` over n after 2 warm-ups, peak GiB over them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(fn, n=n, warmup=2)
    return ms, torch.cuda.max_memory_allocated() / 2**30


def _log_busy(tag, ms, prof):
    """A step's time beside its device busy time and the bf16 attention and
    K4 kernels' parts of it (the profile's sums by kernel name)."""
    if prof is None:
        log(f"[{tag}] {ms:.2f} ms a step; device busy not measured")
        return
    attn = sum(t for name, t, _ in prof["ranked"] if "attn_" in name and "_sm90_kernel" in name)
    k4 = [(t, n) for name, t, n in prof["ranked"] if "grouped_conv1d_sm90_kernel" in name]
    log(f"[{tag}] {ms:.2f} ms a step (CUDA events), device busy {prof['busy_ms']:.2f} ms "
        f"(share {prof['share']:.3f}); bf16 attention kernels {attn:.2f} ms of the busy time; "
        f"bf16 K4 and K4-dx {sum(t for t, _ in k4):.3f} ms in {sum(n for _, n in k4)} launches")


def phase_bf16_pretrain_time(torch, root):
    """18: the bf16 pretrain step's time and peak memory, as phase 11."""
    runner = _pretrain_runner(root, "bf16")
    batch = runner.device_batch(next(iter(runner.loader)))
    ms, peak = _timed_step(torch, lambda: runner.step(batch))
    log(f"[18 bf16 pretrain step time] B = 24 x 250 000 samples, batch on the card: "
        f"{ms:.2f} ms per step (median of 10), peak device memory {peak:.2f} GiB")
    prof = profile_slice(torch, lambda: runner.step(batch), batches=3, top=12, tag="18 profile")
    _log_busy("18 bf16 pretrain step", ms, prof)
    return ms, peak


class plain_kernels:
    """Within: the towers call the plain versions of K2 and K4 on the card
    (the bf16 scheme's own rounding, without the hand kernels)."""

    def __enter__(self):
        from tpu_speech_torch.models.spiral import wav2vec
        from tpu_speech_torch.ops.fused_attention import qkv_attention_plain
        from tpu_speech_torch.ops.fused_posconv import grouped_conv1d_plain

        self.saved = wav2vec.fused_qkv_self_attention, wav2vec.grouped_conv1d
        wav2vec.fused_qkv_self_attention = qkv_attention_plain
        wav2vec.grouped_conv1d = grouped_conv1d_plain

    def __exit__(self, *exc):
        from tpu_speech_torch.models.spiral import wav2vec

        wav2vec.fused_qkv_self_attention, wav2vec.grouped_conv1d = self.saved


def _hold_bf16_step(tag, run):
    """A bf16 step against the fp32 step on the same weights and batch.
    ``run(bf16)`` gives (loss, {name: gradient}); the plain versions' bf16
    step (``plain_kernels``) is the yardstick of the bf16 scheme's own error.
    The loss within BF16_STEP_LOSS_RTOL relative; each gradient leaf (max|g|
    at least 1 % of the largest) within BF16_STEP_GRAD_RL2 relative L2 or,
    where the bf16 scheme itself is farther, no farther than the JAX parity
    tests' bound: 2 x the plain bf16 step's distance + 1e-2 ||g32||."""
    l32, g32 = run(False)
    l16, g16 = run(True)
    with plain_kernels():
        lp, gp = run(True)
    rel_loss, rel_plain = abs(l16 - l32) / abs(l32), abs(lp - l32) / abs(l32)
    g_max = max(g.abs().max().item() for g in g32.values())
    rows = []
    for k, g in g32.items():
        if g.abs().max().item() < 1e-2 * g_max:
            continue
        n32 = g.norm().item()
        rows.append((((g16[k] - g).norm().item() / n32), (gp[k] - g).norm().item() / n32, k))
    rows.sort(reverse=True)
    over = [r for r in rows if r[0] > BF16_STEP_GRAD_RL2]
    bad = [r for r in over if r[0] > 2 * r[1] + 1e-2]
    log(f"[{tag}] loss fp32 {l32:.6f} bf16 {l16:.6f} (rel {rel_loss:.3e}, limit "
        f"{BF16_STEP_LOSS_RTOL}); plain-version bf16 {lp:.6f} (rel {rel_plain:.3e}); "
        f"{len(rows)} gradient leaves above 1 % of the largest, {len(over)} of them beyond "
        f"{BF16_STEP_GRAD_RL2} relative L2; worst leaves (kernels' bf16, plain bf16 "
        f"relative L2):")
    for r16, rp, k in rows[:6]:
        log(f"    {r16:.3e} {rp:.3e} {k}")
    check(rel_loss <= BF16_STEP_LOSS_RTOL, f"bf16 loss {l16} vs fp32 {l32}")
    check(not bad, f"bf16 gradients beyond both bounds: {bad}")
    return rel_loss, rows[0][0]


def phase_bf16_vs_fp32_pretrain(torch, root):
    """19: one full-width pretrain step in bf16 against the fp32 step on the
    card: the same weights, batch (B = 24 x 250 000) and negatives,
    regularisers off, SGD lr = 1; loss and gradients (``_hold_bf16_step``)."""
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
    from tpu_speech_torch.train import spiral as tspiral

    runner = _pretrain_runner(root, regularised=False)
    enc = runner.enc_cfg
    batch = runner.device_batch(next(iter(runner.loader)))
    del runner
    feat_lens = torch.ceil(batch["p_wav_lens"].float() / 160).long()
    for _ in range(3):
        feat_lens = (feat_lens + 1) // 2
    neg = draw_negative_indices(feat_lens.cpu(), batch["time_mask"].shape[1] // 8,
                                enc.n_negatives, torch.Generator().manual_seed(8)).cuda()

    def run(bf16):
        model = ST2VecEncoder(enc, pretraining=True)
        model.init_weights(torch.Generator().manual_seed(3))
        state = tspiral.make_pretrain_state(model.cuda(), lambda ps: torch.optim.SGD(ps, lr=1.0))
        m = tspiral.pretrain_step(state, batch, DropoutRng.seeded(0, "cuda"), bf16=bf16,
                                  neg_idx=neg)
        return float(m["loss"]), {n: p.grad for n, p in model.named_parameters()
                                  if p.requires_grad}

    return _hold_bf16_step("19 pretrain bf16 vs fp32, B = 24 x 250 000, one SGD(lr=1) step",
                           run)


def phase_bf16_finetune_slice(torch, root, st2vec_pt):
    """20: the finetune slice with --set model.precision=bf16 through
    run_spiral.main from phase 9's st2vec.pt, unfrozen, on phase 14's
    corpus: per step the bf16 kernels' launches, finite losses."""
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner

    argv = ["--model_type", "ctc_finetune", "--run_mode", "train",
            "--config_name", "spiral_base_finetune_ls100_char", "--manifest_dir", root,
            "--init_chkpt_dir", os.path.dirname(st2vec_pt),
            "--init_chkpt_file", os.path.basename(st2vec_pt),
            "--model_save_dir", os.path.join(root, "finetune_bf16"),
            "--set", f"trainer.max_steps={BF16_FT_STEPS}",
            "--set", "model.freeze_finetune_updates=0",
            "--set", "model.optim.sched.warmup_ratio=0", "--set", f"model.optim.lr={FT_LR}",
            "--set", "model.precision=bf16"]
    seen = []
    step = _watch_steps(torch, SpiralFinetuneRunner, seen)
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        res = run_spiral.main(argv)
    finally:
        SpiralFinetuneRunner.step = step
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    steps = res["steps"]
    log(f"[20 bf16 finetune slice] {len(steps)} unfrozen steps of B = {BATCH} x 24 s with "
        f"model.precision=bf16 through run_spiral.main in {time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    check(len(steps) == BF16_FT_STEPS == len(seen), f"{len(steps)} steps ran")
    for i, (m, n) in enumerate(zip(steps, seen)):
        log(f"    step {i}: loss {m['loss']:.4f}, kept layers {m['layers']}; launches "
            f"{ {k: v for k, v in n.items() if v} }")
        check(np.isfinite(m["loss"]) and not m["frozen"], f"step {i}: loss {m['loss']}")
        check(n["fused_logmel"] == 1, f"step {i}: K1 {n}")
        check(n["fused_qkv_attention_bf16"] == n["fused_qkv_attention_bwd_bf16"] == m["layers"],
              f"step {i}: K2 bf16 {n}")
        check(n["grouped_conv1d_bf16"] == n["grouped_conv1d_dx_bf16"] == 2, f"step {i}: K4 {n}")
        check(all(n[k] == 0 for k in FP32_KERNELS), f"step {i}: an fp32 kernel ran {n}")
    return launches


def _finetune_runner(root, precision="fp32", accum=1):
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.text.tokenizers import CharTokenizer
    from tpu_speech_torch.train.spiral_runner import SpiralFinetuneRunner

    cfg = spiral_base_ctc_char()
    cfg.model.freeze_finetune_updates = 0
    cfg.model.precision = precision
    cfg.trainer.accumulate_grad_batches = accum
    cfg.model.train_ds.manifest_filepath = os.path.join(root, "librivox-train-clean-100.json")
    return SpiralFinetuneRunner(cfg, os.path.join(root, f"ft_timed_{precision}_{accum}"),
                                CharTokenizer(cfg.model.labels), device="cuda")


def phase_bf16_finetune_time(torch, root):
    """20: the bf16 finetune step's time and peak memory, as phase 16."""
    runner = _finetune_runner(root, "bf16")
    batch = runner.device_batch(next(iter(runner.loader)))
    ms, peak = _timed_step(torch, lambda: runner.step(batch))
    log(f"[20 bf16 finetune step time] B = 14 x 24 s, unfrozen, batch on the card: "
        f"{ms:.2f} ms per step (median of 10), peak device memory {peak:.2f} GiB")
    prof = profile_slice(torch, lambda: runner.step(batch), batches=3, top=12, tag="20 profile")
    _log_busy("20 bf16 finetune step", ms, prof)
    return ms, peak


def _finetune_batch(rng, n):
    """n speech-like utterances of 4-24 s padded to 24 s with random labels
    (12 a second), as host arrays."""
    lens = rng.integers(4 * SR, MAX_SAMPLES + 1, size=n).astype(np.int32)
    wavs = np.zeros((n, MAX_SAMPLES), np.float32)
    labels = np.zeros((n, 512), np.int32)
    label_lens = (lens // SR * 12).astype(np.int32)
    for i in range(n):
        wavs[i, :lens[i]] = speech_like(rng, int(lens[i]))
        labels[i, :label_lens[i]] = rng.integers(0, 28, size=label_lens[i])
    return {"wavs": wavs, "wav_lens": lens, "labels": labels, "label_lens": label_lens}


def phase_bf16_vs_fp32_finetune(torch):
    """20: one full-width unfrozen finetune step in bf16 against fp32 on the
    card: the same weights and batch (B = 14 x 24 s), regularisers off, SGD
    lr = 1; loss and gradients (``_hold_bf16_step``)."""
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
    from tpu_speech_torch.train.spiral import batch_to_device
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = _no_dropout_finetune_cfg()
    batch = batch_to_device(_finetune_batch(np.random.default_rng(11), BATCH), "cuda")

    def run(bf16):
        model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(3)).cuda()
        state = make_finetune_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
        m = finetune_step(state, batch, DropoutRng.seeded(0, "cuda"), bf16=bf16)
        return float(m["loss"]), {n: p.grad for n, p in model.named_parameters()}

    return _hold_bf16_step("20 finetune bf16 vs fp32, B = 14 x 24 s, one unfrozen SGD(lr=1) "
                           "step", run)


def phase_accum(torch, root, ft_root):
    """21: accumulate_grad_batches = 2 at full width, 24 (pretrain) and 14
    (finetune) utterances a micro-batch, through the runners' steps: one
    optimizer update and one EMA per call, the peak memory against the
    accum = 1 step's on the same state, and the step times."""
    from tpu_speech_torch.train.spiral import pretrain_step
    from tpu_speech_torch.train.finetune import finetune_step

    res = {}
    runner = _pretrain_runner(root, accum=2)
    it = iter(runner.loader)
    micro = [runner.device_batch(next(it), i) for i in range(2)]
    state = runner.state
    one = lambda: pretrain_step(state, micro[0], runner.rng, grad_clip=runner.cfg.model.grad_clip)
    res["pre_1"] = _timed_step(torch, one, n=5)
    res["pre_2"] = _timed_step(torch, lambda: runner.step(micro), n=5)
    step0 = state.step
    teacher0 = [p.detach().clone() for p in state.model.teacher_parameters()]
    m = runner.step(micro)
    student = [p for _, s in state.model._pairs() for p in s.parameters()]
    mom = m["momentum"]
    ema_err = max((t - (t0 * mom + s.detach() * (1 - mom))).abs().max().item()
                  for t, t0, s in zip(state.model.teacher_parameters(), teacher0, student))
    log(f"[21 pretrain accum 2] 2 x 24 x 250 000 samples a call: step count +{state.step - step0} "
        f"a call; EMA as one update (max error {ema_err:.2e}); loss {float(m['loss']):.4f}; "
        f"{res['pre_2'][0]:.2f} ms a call vs {res['pre_1'][0]:.2f} ms for one micro-batch "
        f"(median of 5), peak {res['pre_2'][1]:.2f} GiB vs {res['pre_1'][1]:.2f} GiB")
    check(state.step - step0 == 1, "pretrain accum: not one update a call")
    check(ema_err <= 1e-6, f"pretrain accum: EMA off by {ema_err}")
    check(np.isfinite(float(m["loss"])), "pretrain accum: loss")
    check(res["pre_2"][1] <= 1.1 * res["pre_1"][1], "pretrain accum: peak memory")
    del runner, micro, state, one, teacher0, student

    runner = _finetune_runner(ft_root, accum=2)
    it = iter(runner.loader)
    micro = [runner.device_batch(next(it)) for _ in range(2)]
    state = runner.state
    one = lambda: finetune_step(state, micro[0], runner.rng)
    res["ft_1"] = _timed_step(torch, one, n=5)
    res["ft_2"] = _timed_step(torch, lambda: runner.step(micro), n=5)
    step0, count0 = state.step, state.optimizer.count
    m = runner.step(micro)
    log(f"[21 finetune accum 2] 2 x 14 x 24 s a call: step count +{state.step - step0}, "
        f"optimizer count +{state.optimizer.count - count0} a call; loss {float(m['loss']):.4f}; "
        f"{res['ft_2'][0]:.2f} ms a call vs {res['ft_1'][0]:.2f} ms for one micro-batch "
        f"(median of 5), peak {res['ft_2'][1]:.2f} GiB vs {res['ft_1'][1]:.2f} GiB")
    check(state.step - step0 == 1 and state.optimizer.count - count0 == 1,
          "finetune accum: not one update a call")
    check(np.isfinite(float(m["loss"])), "finetune accum: loss")
    check(res["ft_2"][1] <= 1.1 * res["ft_1"][1], "finetune accum: peak memory")
    return res


def phase_finetune_accum_equiv(torch):
    """22: the finetune step at accum 2 on two halves of 14 against accum 1 on
    the 28 utterances, fp32, SGD lr = 1, regularisers off: loss and
    gradients."""
    from tpu_speech_torch.models.spiral.dropout import DropoutRng
    from tpu_speech_torch.train.finetune import finetune_step, make_finetune_state
    from tpu_speech_torch.train.spiral import batch_to_device
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = _no_dropout_finetune_cfg()
    whole = _finetune_batch(np.random.default_rng(12), 2 * BATCH)
    halves = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in whole.items()} for i in range(2)]
    out = []
    for batch, accum in ((batch_to_device(whole, "cuda"), 1),
                         ([batch_to_device(h, "cuda") for h in halves], 2)):
        model = build_model(cfg, 28).init_weights(torch.Generator().manual_seed(3)).cuda()
        state = make_finetune_state(model, lambda ps: torch.optim.SGD(ps, lr=1.0))
        m = finetune_step(state, batch, DropoutRng.seeded(0, "cuda"), accum_steps=accum)
        out.append((float(m["loss"]), {n: p.grad for n, p in model.named_parameters()}))
        del model, state, batch
    (l1, g1), (l2, g2) = out
    rel_loss = abs(l2 - l1) / abs(l1)
    g_max = max(g.abs().max().item() for g in g1.values())
    worst = max((g2[k] - g).abs().max().item() / max(g.abs().max().item(), 1e-2 * g_max)
                for k, g in g1.items())
    log(f"[22 finetune accum 2 vs 1] 28 utterances, fp32, SGD(lr=1): loss {l1:.6f} vs "
        f"{l2:.6f} (rel {rel_loss:.2e}, limit {ACCUM_LOSS_RTOL}); worst gradient "
        f"{worst:.2e} x its max|g| (limit {GRAD_RTOL})")
    check(rel_loss <= ACCUM_LOSS_RTOL, f"accum 2 loss {l2} vs accum 1 {l1}")
    check(worst <= GRAD_RTOL, f"accum 2 gradient: {worst}")
    return rel_loss


def _tts_models(torch):
    """Grad-TTS at the LJSpeech width of cli/params.py and HiFi-GAN V1, seeded
    random weights, on the CPU."""
    from tpu_speech_torch.configs import gradtts as cfg
    from tpu_speech_torch.models.grad_tts import GradTTS
    from tpu_speech_torch.models.hifigan import Generator
    from tpu_speech_torch.text import symbols

    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    model.init_weights(torch.Generator().manual_seed(TTS_SEED)).eval()
    voc = Generator(**HIFIGAN_V1).init_weights(torch.Generator().manual_seed(TTS_SEED + 1))
    return model, voc.eval()


def _tts_ids(torch, text, device, batch=1):
    """bench.py's input: english_cleaners, characters (no dictionary),
    interspersed with the blank."""
    from tpu_speech_torch.text import intersperse, symbols, text_to_sequence

    seq = intersperse(text_to_sequence(text), len(symbols))
    x = torch.tensor([seq] * batch, device=device)
    return x, torch.full((batch,), len(seq), device=device)


def write_vocoder(torch, root, voc):
    """HiFi-GAN V1 as a reference training checkpoint stores it: a generator
    .pt with weight_g/weight_v pairs (folded at load) and its
    hifigan-config.json. Returns both paths."""
    hpt = os.path.join(root, "hifigan.pt")
    sd = {}
    for k, v in voc.state_dict().items():  # weight = g * v / ||v||, v = 2 w
        if k.endswith(".weight"):
            sd[k[:-7] + ".weight_g"] = v.norm(dim=tuple(range(1, v.dim())), keepdim=True)
            sd[k[:-7] + ".weight_v"] = 2 * v
        else:
            sd[k] = v
    torch.save({"generator": sd}, hpt)
    hjson = os.path.join(root, "hifigan-config.json")
    with open(hjson, "w") as f:
        json.dump(dict(HIFIGAN_V1, num_mels=80, sampling_rate=22050, hop_size=256), f)
    return hpt, hjson


def phase_tts_slice(torch, root):
    """23: text -> wav through tpu_speech_torch.cli.inference.main on the
    card: a reference-named Grad-TTS .pt, a V1 hifigan-config.json and a
    generator .pt with weight_g/weight_v pairs (folded at load), a small
    CMU dictionary, three lines (bench.py's text, numbers and
    abbreviations, one longer than 256 frames)."""
    from tpu_speech_torch.cli import inference
    from tpu_speech_torch.ops import _build

    model, voc = _tts_models(torch)
    ckpt = os.path.join(root, "grad-tts.pt")
    torch.save(model.state_dict(), ckpt)
    hpt, hjson = write_vocoder(torch, root, voc)
    texts, cmu = os.path.join(root, "texts.txt"), os.path.join(root, "cmu_dictionary")
    with open(texts, "w") as f:
        f.write("\n".join(TTS_LINES) + "\n")
    with open(cmu, "w", encoding="latin-1") as f:
        f.write("THE  DH AH0\nQUICK  K W IH1 K\nBROWN  B R AW1 N\nFOX  F AA1 K S\n"
                "DOCTOR  D AA1 K T ER0\nSMITH  S M IH1 TH\nTICKETS  T IH1 K AH0 T S\n")
    n_params = sum(p.numel() for p in model.parameters())
    n_voc = sum(p.numel() for p in voc.parameters())
    del model, voc
    _build.reset_launches()
    t0 = time.perf_counter()
    res = inference.main(["-f", texts, "-c", ckpt, "--hifigan", hpt, "--hifigan-config", hjson,
                          "--cmudict", cmu, "--out-dir", os.path.join(root, "tts_out")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[23 tts slice] Grad-TTS {res['n_params']} parameters, HiFi-GAN V1 "
        f"{res['n_vocoder_params']}; {len(res['samples'])} lines through "
        f"cli.inference.main in {wall:.1f} s; hand-kernel launches "
        f"{ {k: v for k, v in launches.items() if v} or 0}")
    check(res["n_params"] == n_params and res["n_vocoder_params"] == n_voc,
          f"parameter counts {res['n_params']}, {res['n_vocoder_params']}")
    check(len(res["samples"]) == len(TTS_LINES), f"{len(res['samples'])} samples")
    import scipy.io.wavfile

    for s in res["samples"]:
        sr, pcm = scipy.io.wavfile.read(s["path"])
        log(f"    {os.path.basename(s['path'])}: {s['frames']} frames (predicted "
            f"{s['predicted_frames']:.2f}, bucket {s['y_max_length']}), {len(pcm)} int16 "
            f"samples, RTF {s['rtf']:.5f}, peak |pcm| {int(np.abs(pcm.astype(np.int32)).max())}")
        check(sr == 22050 and pcm.dtype == np.int16, f"{s['path']}: {sr} Hz, {pcm.dtype}")
        check(pcm.shape == (s["frames"] * 256,), f"{s['path']}: {pcm.shape} samples")
        check(s["frames"] == int(s["predicted_frames"]), f"a line was cut: {s}")
        check(np.abs(pcm.astype(np.int32)).max() > 0, f"{s['path']} is silent")
    check(res["samples"][-1]["frames"] > 256, "the long line is not over 256 frames")
    return launches


def phase_tts_cpu_vs_card(torch):
    """24: the same weights and z on the card and on the CPU, bench.py's
    text at bucket 384: 10 Euler steps (mel MAE < 1e-3, the JAX package's
    on-chip gate) and 6 DPM steps; the wav MAE after HiFi-GAN. A warm call
    of the sampler and vocoder after the encoder makes no host sync."""
    from tpu_speech_torch.models.grad_tts import synthesize, synthesize_from_encoding

    model, voc = _tts_models(torch)
    noise = torch.randn(1, TTS_BUCKET, 80, generator=torch.Generator().manual_seed(TTS_SEED))
    kw = dict(temperature=1.5, length_scale=0.91)
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev), voc.to(dev)
        x, xl = _tts_ids(torch, TTS_TEXT, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            for solver, steps in (("euler", 10), ("dpm", 6)):
                _, dec, attn, yl = synthesize(model, x, xl, steps, TTS_BUCKET, solver=solver,
                                              noise=noise.to(dev), **kw)
                n = int(yl[0])
                wav = voc(dec[:, :n].transpose(1, 2))
                out[(dev, solver)] = (dec[0, :n].cpu(), attn.cpu(), n, wav.cpu())
            if dev == "cuda":
                mu_x, logw, x_mask = model.encode(x, xl)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    g = torch.Generator("cuda").manual_seed(0)
                    _, dec, _, _ = synthesize_from_encoding(model, mu_x, logw, x_mask, 10,
                                                            TTS_BUCKET, generator=g, **kw)
                    voc(dec.transpose(1, 2))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
        log(f"    [24] {dev}: both samplers and HiFi-GAN in {time.perf_counter() - t0:.1f} s")
    res = {}
    for solver in ("euler", "dpm"):
        (dc, ac, nc, wc), (dg, ag, ng, wg) = out[("cpu", solver)], out[("cuda", solver)]
        check(nc == ng and torch.equal(ac, ag), f"{solver}: lengths {nc} vs {ng} or the path")
        check(bool(torch.isfinite(dg).all() and torch.isfinite(wg).all()), f"{solver}: finite")
        mae, worst = (dg - dc).abs().mean().item(), (dg - dc).abs().max().item()
        wav_mae = (wg - wc).abs().mean().item()
        res[solver] = mae
        log(f"[24 tts card vs cpu] {solver} {dict(euler=10, dpm=6)[solver]} "
            f"steps, {nc} frames at bucket {TTS_BUCKET}: mel MAE {mae:.3e} (limit "
            f"{TTS_MEL_MAE}), max {worst:.3e}, mean|mel| {dc.abs().mean().item():.3f}; wav "
            f"MAE {wav_mae:.3e}, max|wav| {wc.abs().max().item():.4f}")
        check(mae < TTS_MEL_MAE, f"{solver}: card vs CPU mel MAE {mae}")
    log("    [24] sampler + vocoder after the encoder under set_sync_debug_mode('error'): "
        "no host sync")
    return res


def phase_tts_time(torch):
    """25: the points bench.py names, with CUDA events (median of 10), fp32:
    e2e text -> int16 wav RTF at B = 1, bucket 384, 10 Euler steps and 6 DPM
    steps; the mel-only RTF; B = 16 throughput in x realtime; HiFi-GAN alone
    at (16, 384, 80). As bench.py does, the vocoder takes the whole bucket
    and the RTF counts the predicted frames. Then kernels per utterance, the
    busy share and the top device ops (torch.profiler), and peak memory."""
    from tpu_speech_torch.models.grad_tts import synthesize
    from tpu_speech_torch.models.hifigan import to_int16_pcm

    model, voc = _tts_models(torch)
    model.cuda(), voc.cuda()
    kw = dict(temperature=1.5, length_scale=0.91)
    res = {}

    def e2e(x, xl, steps, solver, vocode=True):
        g = torch.Generator("cuda").manual_seed(0)
        with torch.inference_mode():
            _, dec, _, yl = synthesize(model, x, xl, steps, TTS_BUCKET, solver=solver,
                                       generator=g, **kw)
            return (to_int16_pcm(voc(dec.transpose(1, 2))) if vocode else dec), yl

    x1, xl1 = _tts_ids(torch, TTS_TEXT, "cuda")
    frames = int(e2e(x1, xl1, 1, "euler", vocode=False)[1][0])
    audio_s = frames * 256 / 22050
    for name, steps, solver, vocode in (("e2e_wav_rtf_10step", 10, "euler", True),
                                        ("e2e_wav_rtf_dpm6", 6, "dpm", True),
                                        ("mel_rtf_10step", 10, "euler", False)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: e2e(x1, xl1, steps, solver, vocode), n=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[name] = ms / 1e3 / audio_s
        log(f"[25 tts time] {name}: {ms:.2f} ms for {frames} frames ({audio_s:.3f} s of "
            f"audio), RTF {res[name]:.5f}, peak {peak:.3f} GiB")
    x16, xl16 = _tts_ids(torch, TTS_TEXT, "cuda", batch=16)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: e2e(x16, xl16, 10, "euler"), n=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    res["e2e_throughput_b16"] = 16 * audio_s / (ms / 1e3)
    log(f"[25 tts time] e2e_throughput_b16: {ms:.2f} ms for 16 x {frames} frames, "
        f"{res['e2e_throughput_b16']:.1f} x realtime, peak {peak:.3f} GiB")
    mel = torch.randn(16, 80, TTS_BUCKET, generator=torch.Generator().manual_seed(0)).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: voc(mel), n=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    res["hifigan_throughput_b16"] = 16 * TTS_BUCKET * 256 / 22050 / (ms / 1e3)
    log(f"[25 tts time] hifigan_throughput_b16: {ms:.2f} ms for (16, {TTS_BUCKET}, 80), "
        f"{res['hifigan_throughput_b16']:.1f} x realtime, peak {peak:.3f} GiB")
    profile_slice(torch, lambda: e2e(x1, xl1, 10, "euler"), batches=3, top=12,
                  tag="25 profile, e2e 10 Euler steps, B = 1")
    return res

# ---- Grad-TTS training (phases 26-29) -----------------------------------------

# the fp32 rate of the CUDA cores (NVIDIA's H100 SXM data sheet): MAS's adds
# and maxes run there
PEAK_FP32 = 67e12
MAS_BENCH = (16, 72, 512)  # bench.py's train-step point: B, Tx, Ty
GT_UTTS = 40
GT_SEED = 28
GT_LETTERS = list("abcdefghijklmnopqrstuvwxyz")
# one step, card against CPU: parameters after Adam within 1e-5 x max(1, |p|)
GT_PARAM_RTOL = 1e-5
# and each gradient leaf within GRAD_RTOL x its max|g| or GT_GRAD_FLOOR x the
# largest gradient, whichever is larger: the floor is about 8 fp32 roundings
# of the largest, the level of the leaves whose gradient is exactly zero
# (conv biases under GroupNorm, the key biases: both sides hold noise there)
GT_GRAD_FLOOR = 1e-6


def _mas_grid(torch, gen, b, t_x, t_y, x_len, y_len, ties=False):
    """A Gaussian log-prior grid of random 80-feature mu and mels, formed as
    GradTTS.alignment forms it, and its (B, Tx, Ty) mask, on the card; an
    integer grid full of ties with ``ties``."""
    from tpu_speech_torch.ops.masks import sequence_mask

    mu = torch.randn(b, t_x, 80, generator=gen).cuda()
    y = torch.randn(b, t_y, 80, generator=gen).cuda()
    value = (-0.5 * (y ** 2).sum(-1)[:, None, :] + mu @ y.transpose(1, 2)
             - 0.5 * (mu ** 2).sum(-1)[:, :, None] - 0.5 * np.log(2 * np.pi) * 80)
    if ties:
        value = torch.round(value / 40.0)
    xm = sequence_mask(torch.as_tensor(x_len).cuda(), t_x).float()
    ym = sequence_mask(torch.as_tensor(y_len).cuda(), t_y).float()
    return value, xm[:, :, None] * ym[:, None, :]


def mas_bound(x_len, y_len, t_x, t_y):
    """(bound_ms, bound_by): value and mask read, the path written, (B, Tx,
    Ty) fp32 each, against an add and a max per computed cell (x < t_x,
    y < t_y) at the CUDA cores' fp32 rate."""
    nbytes = 3 * 4 * len(x_len) * t_x * t_y
    ops = 2 * int(np.sum(np.asarray(x_len) * np.asarray(y_len)))
    ops_ms, bytes_ms = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_mas(torch, gen):
    """26: the MAS kernel against maximum_path_plain on the card, paths bit
    for bit: bench.py's (16, 72, 512) at full lengths, LJSpeech-like rows
    (Tx 30-400, Ty 100-900, mixed, one row with Tx = Ty) and an integer grid
    full of ties; times with CUDA events beside the plain loop and the
    bound."""
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.ops.monotonic_align import maximum_path, maximum_path_plain

    r = np.random.default_rng(26)
    b, t_x, t_y = MAS_BENCH
    x_lj = r.integers(30, 401, size=16)
    y_lj = np.clip((x_lj * r.uniform(1.6, 3.0, size=16)).astype(int), 100, 900)
    x_lj[0], y_lj[0] = 400, 900
    x_lj[1] = y_lj[1] = 250
    x_tie, y_tie = r.integers(8, 65, size=8), r.integers(64, 257, size=8)
    x_tie[0], y_tie[0] = 64, 64
    cases = [("bench", (b, t_x, t_y), [t_x] * b, [t_y] * b, False),
             ("ljspeech", (16, 400, 900), x_lj, y_lj, False),
             ("ties", (8, 64, 256), x_tie, y_tie, True)]
    _build.reset_launches()
    res, worst = {}, 0.0
    for name, (bb, tx, ty), xl, yl, ties in cases:
        v, m = _mas_grid(torch, gen, bb, tx, ty, xl, yl, ties)
        path = maximum_path(v, m)
        ref = maximum_path_plain(v, m)
        torch.cuda.synchronize()
        err = (path - ref).abs().max().item()
        worst = max(worst, err)
        per_frame = path.sum(1)  # one token per valid frame
        check(torch.equal(path, ref), f"MAS {name}: the kernel's path differs from the plain "
                                      f"version's in {int((path != ref).sum())} cells")
        check(torch.equal(per_frame, m[:, 0, :]), f"MAS {name}: not one token per frame")
        ms = cuda_ms(lambda: maximum_path(v, m), n=20, warmup=3)
        plain_ms = cuda_ms(lambda: maximum_path_plain(v, m), n=3, warmup=1)
        bound = mas_bound(xl, yl, tx, ty)
        res[name] = dict(ms=ms, plain_ms=plain_ms, bound=bound)
        log(f"[26 mas] {name} ({bb}, {tx}, {ty}), Tx {min(xl)}-{max(xl)}, Ty {min(yl)}-"
            f"{max(yl)}{', integer ties' if ties else ''}: paths equal ({int(path.sum())} "
            f"ones); kernel {ms:.4f} ms, plain loop {plain_ms:.2f} ms, bound {bound[0]:.5f} ms "
            f"({bound[1]})")
    log(f"    [26] the kernel's own launches in this phase: {_build.LAUNCHES['maximum_path']}")
    bench = res["bench"]
    lj = res["ljspeech"]
    return dict(max_abs_err=worst, ms=bench["ms"], plain_ms=bench["plain_ms"],
                bound_ms=bench["bound"][0], bound_by=bench["bound"][1], library_ms=None,
                shape=f"value, mask (16, 72, 512) full lengths, bench.py's train-step point "
                      f"(max_abs_err: the paths' difference); LJSpeech-like (16, 400, 900): "
                      f"{lj['ms']:.4f} ms vs plain {lj['plain_ms']:.2f} ms, bound "
                      f"{lj['bound'][0]:.5f} ms; no library call computes MAS")


def write_tts_corpus(root, rng, n):
    """n speech-like 22 050 Hz wavs of 1-8 s with random character lines
    (about 14 characters a second), and their filelist 'wav|text'."""
    from tpu_speech_torch.data.wav import write_wav

    lines = []
    for i in range(n):
        secs = rng.uniform(1.0, 8.0)
        path = os.path.join(root, f"tts{i:02d}.wav")
        write_wav(path, speech_like(rng, int(secs * 22050), sr=22050), 22050)
        words = ["".join(rng.choice(GT_LETTERS, size=int(rng.integers(2, 9))))
                 for _ in range(max(1, int(secs * 2.5)))]
        lines.append(f"{path}|{' '.join(words)}")
    filelist = os.path.join(root, "train.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return filelist, lines


def _watch_gradtts_steps(torch, seen):
    """Wrap train/gradtts.py's train_step (the trainer looks it up at each
    step) to record each step's launches and metrics; returns the original."""
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import gradtts as tg

    step = tg.train_step

    def watched(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        m = step(*args, **kwargs)
        torch.cuda.synchronize()
        seen.append(({k: v - before[k] for k, v in _build.LAUNCHES.items()},
                     {k: float(v) for k, v in m.items()}))
        return m

    tg.train_step = watched
    return step


def phase_gradtts_train_slice(torch, rng, root):
    """27: Grad-TTS training through tpu_speech_torch.cli.train.main at the
    full LJSpeech width, B = 16, out_size 172, on a synthetic corpus: 2
    epochs of 2 steps, then a second main() on the same log dir with 3
    epochs (resumes at step 4, takes 2 steps), then the multi-speaker entry
    (n_spks 4) for 2 steps. Per step the MAS kernel launches once and no
    other hand kernel; losses finite; the encoder and the estimator moved;
    train.log a line per epoch; the final gradtts.pt serves an uncut wav
    through cli.inference.main."""
    import importlib.util

    from tpu_speech_torch.cli import inference, train, train_multi_speaker
    from tpu_speech_torch.configs import gradtts as cfg
    from tpu_speech_torch.models.hifigan import Generator
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import gradtts as tg

    filelist, lines = write_tts_corpus(root, rng, GT_UTTS)
    spk_list = os.path.join(root, "train_spk.txt")
    with open(spk_list, "w", encoding="utf-8") as f:
        f.write("\n".join(f"{ln}|{i % 4}" for i, ln in enumerate(lines)) + "\n")
    test_list = os.path.join(root, "test.txt")
    if importlib.util.find_spec("matplotlib") is not None:
        with open(test_list, "w", encoding="utf-8") as f:
            f.write("preview.wav|a preview line for the alignment images|1\n")
        previews = "previews on (one test line)"
    else:
        previews = "matplotlib is missing: no test filelist, previews off"
    log_dir, spk_dir = os.path.join(root, "gradtts_logs"), os.path.join(root, "gradtts_spk")
    keys = ("train_filelist_path", "test_filelist_path", "log_dir", "n_epochs", "batch_size",
            "cmudict_path", "n_spks")
    saved = {k: getattr(cfg, k) for k in keys}
    init = {k: v.clone() for k, v in train.build_model().state_dict().items()}
    seen = []
    step = _watch_gradtts_steps(torch, seen)
    runs = []
    _build.reset_launches()
    try:
        for k, v in dict(train_filelist_path=filelist, test_filelist_path=test_list,
                         log_dir=log_dir, batch_size=16, cmudict_path="").items():
            setattr(cfg, k, v)
        for epochs, entry in ((2, train.main), (3, train.main), (1, train_multi_speaker.main)):
            if entry is train_multi_speaker.main:
                cfg.n_spks, cfg.train_filelist_path, cfg.log_dir = 4, spk_list, spk_dir
            cfg.n_epochs = epochs
            t0 = time.perf_counter()
            res = entry([])
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0, len(seen)))
    finally:
        tg.train_step = step
        for k, v in saved.items():
            setattr(cfg, k, v)
    launches = dict(_build.LAUNCHES)
    (r1, w1, n1), (r2, w2, n2), (r3, w3, n3) = runs
    log(f"[27 gradtts train slice] {r1['n_params']} parameters, {GT_UTTS} utterances of 1-8 s, "
        f"B = 16, out_size {cfg.out_size}; {previews}; run 1 (2 epochs) {n1} steps in "
        f"{w1:.1f} s, run 2 (3 epochs) resumed at step {r1['iteration']}, epoch "
        f"{r2['first_epoch']}: {n2 - n1} steps in {w2:.1f} s; multi-speaker (4) {n3 - n2} steps "
        f"in {w3:.1f} s; launches {({k: v for k, v in launches.items() if v})}")
    for i, (d, m) in enumerate(seen):
        log(f"    step {i}: loss {m['loss']:.4f} (dur {m['dur_loss']:.4f}, prior "
            f"{m['prior_loss']:.4f}, diff {m['diff_loss']:.4f}), grad norms enc "
            f"{m['enc_grad_norm']:.3f} dec {m['dec_grad_norm']:.3f}")
        check(d == dict(dict.fromkeys(d, 0), maximum_path=1), f"step {i} launches {d}")
        check(all(np.isfinite(v) for v in m.values()), f"step {i} metrics {m}")
    check((n1, n2 - n1, n3 - n2) == (4, 2, 2), f"steps per run {n1}, {n2 - n1}, {n3 - n2}")
    check(r1["iteration"] == 4 and r2["first_epoch"] == 3 and r2["iteration"] == 6,
          f"resume: {r1['iteration']} -> epoch {r2['first_epoch']}, {r2['iteration']}")
    with open(os.path.join(log_dir, "train.log")) as f:
        log_lines = f.read().splitlines()
    log(f"    train.log: {log_lines}")
    check(len(log_lines) == 3, f"train.log has {len(log_lines)} lines for 3 epochs")
    sd = torch.load(r2["state_dict"], weights_only=True)
    moved = {part: _max_diff([sd[k] for k in init if k.startswith(part)],
                             [init[k] for k in init if k.startswith(part)])
             for part in tg.ENCODER + tg.ESTIMATOR}
    log(f"    moved (max |w - w0| after 6 steps): {moved}")
    check(all(v > 0 for v in moved.values()), f"a module did not move: {moved}")
    spk = torch.load(r3["state_dict"], weights_only=True)["spk_emb.weight"]
    check(r3["iteration"] == 2 and spk.shape == (4, cfg.spk_emb_dim),
          f"multi-speaker: {r3['iteration']} steps, spk_emb {tuple(spk.shape)}")

    voc = Generator(**HIFIGAN_V1).init_weights(torch.Generator().manual_seed(TTS_SEED + 1))
    hpt, hjson = write_vocoder(torch, root, voc)
    texts = os.path.join(root, "texts.txt")
    with open(texts, "w") as f:
        f.write(TTS_TEXT + "\n")
    out = inference.main(["-f", texts, "-c", r2["state_dict"], "--hifigan", hpt,
                          "--hifigan-config", hjson, "--cmudict", "", "--out-dir",
                          os.path.join(root, "gradtts_out")])
    import scipy.io.wavfile

    (smp,) = out["samples"]
    _, pcm = scipy.io.wavfile.read(smp["path"])
    log(f"    the trained gradtts.pt through cli.inference.main: {smp['frames']} frames "
        f"(predicted {smp['predicted_frames']:.2f}), {len(pcm)} int16 samples")
    check(smp["frames"] == int(smp["predicted_frames"]) and len(pcm) == smp["frames"] * 256,
          f"the trained model's wav was cut: {smp}")
    return launches


def _gradtts_full_width(torch, seed):
    from tpu_speech_torch.configs import gradtts as cfg
    from tpu_speech_torch.models.grad_tts import GradTTS
    from tpu_speech_torch.text import symbols

    model = GradTTS(**cfg.model_kwargs(len(symbols) + 1))
    return model.init_weights(torch.Generator().manual_seed(seed))


def phase_gradtts_cpu_vs_card(torch):
    """28: one full-width step on the card against the CPU: B = 2, Ty 256,
    out_size 172, the same weights (gains drawn), batch, offsets, t and z,
    dropout off, Adam 1e-4. The MAS paths equal; the losses within 1e-4
    relative; each gradient within 1e-3 x its max|g| or 1e-6 x the largest
    (GT_GRAD_FLOOR); the parameters after Adam within 1e-5 x
    max(1, |p|) of the CPU's Adam on the card's gradients. The card's step
    runs under set_sync_debug_mode('error')."""
    import copy

    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.ops.masks import sequence_mask
    from tpu_speech_torch.text import symbols
    from tpu_speech_torch.train.gradtts import batch_to_device, train_step
    from tpu_speech_torch.train.optim import AdamW

    model = _gradtts_full_width(torch, GT_SEED).eval()  # dropout off
    r = np.random.default_rng(GT_SEED)
    t_x, t_y, out_size, lr = 64, 256, 172, 1e-4
    batch = {"x": r.integers(1, len(symbols), size=(2, t_x)).astype(np.int32),
             "x_lengths": np.array([t_x, 47], np.int32),
             "y": r.standard_normal((2, t_y, 80)).astype(np.float32),
             "y_lengths": np.array([t_y, 201], np.int32)}
    g = torch.Generator().manual_seed(GT_SEED)
    high = torch.clamp(torch.tensor(batch["y_lengths"]).long() - out_size, min=1)
    draws = dict(offsets=torch.minimum((torch.rand(2, generator=g) * high).long(), high - 1),
                 t=torch.clamp(torch.rand(2, generator=g), 1e-5, 1 - 1e-5),
                 z=torch.randn(2, out_size, 80, generator=g))
    side = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        b = batch_to_device(batch, dev)
        with torch.no_grad():
            mu_x, _, x_mask = m.encode(b["x"], b["x_lengths"])
            y_mask = sequence_mask(b["y_lengths"], t_y).float()
            attn = m.alignment(mu_x, b["y"], x_mask[:, :, None] * y_mask[:, None, :])
        side[dev] = [m, AdamW(m.parameters(), lr), b, attn.cpu()]
    same_path = torch.equal(side["cpu"][3], side["cuda"][3])
    m, opt, b, _ = side["cuda"]
    dev_draws = {k: v.cuda() for k, v in draws.items()}
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        met_card = train_step(m, opt, b, None, out_size, **dev_draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(_build.LAUNCHES["maximum_path"] == 1, f"card step launches {_build.LAUNCHES}")
    m_cpu, opt_cpu, b_cpu, _ = side["cpu"]
    met_cpu = train_step(m_cpu, opt_cpu, b_cpu, None, out_size,
                         attn=None if same_path else side["cuda"][3], **draws)
    # Adam's first step moves each element by lr g / (|g| + eps), about lr
    # sign(g): where g is rounding noise (the attention's key bias, which the
    # softmax cancels, and elements near 0) the two sides' own steps differ
    # by up to 2 lr. So the card's parameters are held to the CPU's Adam on
    # the card's (clipped) gradients, and the gradients to the CPU's.
    ref = copy.deepcopy(model)
    p_ref = dict(ref.named_parameters())
    for k, p in m.named_parameters():
        p_ref[k].grad = p.grad.cpu()
    AdamW(ref.parameters(), lr).step()
    names = [n for n, _ in m_cpu.named_parameters()]
    p_cpu, p_card = dict(m_cpu.named_parameters()), dict(m.named_parameters())
    g_max = max(p.grad.abs().max().item() for p in p_cpu.values())
    worst_g, worst_p, own, worst_own = (0.0, ""), (0.0, ""), 0.0, (0.0, "")
    for k in names:
        gc, gg = p_cpu[k].grad, p_card[k].grad.cpu()
        err, scale = (gg - gc).abs().max().item(), gc.abs().max().item()
        worst_g = max(worst_g, (err / max(GRAD_RTOL * scale, GT_GRAD_FLOOR * g_max), k))
        if scale > GT_GRAD_FLOOR * g_max:  # above rounding noise
            worst_own = max(worst_own, (err / scale, k))
        pg = p_card[k].detach().cpu()
        worst_p = max(worst_p, (((pg - p_ref[k].detach()).abs()
                                 / p_ref[k].detach().abs().clamp(min=1.0)).max().item(), k))
        own = max(own, (pg - p_cpu[k].detach()).abs().max().item())
    rel_loss = {k: abs(met_card[k].item() - met_cpu[k].item()) / abs(met_cpu[k].item())
                for k in ("dur_loss", "prior_loss", "diff_loss")}
    log(f"[28 gradtts card vs cpu] B = 2, Tx {t_x}, Ty {t_y}, out_size {out_size}, Adam "
        f"{lr}: MAS paths {'equal' if same_path else 'DIFFER: the CPU step ran on the card path'}"
        f"; losses card {[round(met_card[k].item(), 6) for k in rel_loss]} cpu "
        f"{[round(met_cpu[k].item(), 6) for k in rel_loss]} (worst rel "
        f"{max(rel_loss.values()):.2e}, limit {STEP_LOSS_RTOL}); worst gradient at "
        f"{worst_g[0]:.3f} of its bound ({worst_g[1]}: {GRAD_RTOL} x its max|g| or "
        f"{GT_GRAD_FLOOR} x the largest, {g_max:.3e}) over {len(names)} tensors; above "
        f"{GT_GRAD_FLOOR} x the largest, worst {worst_own[0]:.2e} x its own max|g| "
        f"({worst_own[1]}); parameters after Adam {worst_p[0]:.2e} x max(1, |p|) from the "
        f"CPU's Adam on the card's gradients ({worst_p[1]}; limit {GT_PARAM_RTOL}), at most "
        f"{own:.2e} from the CPU's own step; the card's step under "
        f"set_sync_debug_mode('error')")
    check(max(rel_loss.values()) <= STEP_LOSS_RTOL, f"losses {rel_loss}")
    check(worst_g[0] <= 1.0, f"gradient {worst_g}")
    check(worst_p[0] <= GT_PARAM_RTOL, f"parameters after Adam {worst_p}")
    return same_path


def phase_gradtts_train_time(torch, bf16=False):
    """29 (44 with bf16): bench.py's train-step point (bench.py:302-321): B =
    16, Tx 72, Ty 512, out_size 172, n_vocab len(symbols) + 1, the reference
    init, dropout on, Adam 1e-4, fp32 with TF32 off (or the bf16 step,
    bench.py's gradtts_train_step_ms_bf16); CUDA events, median of 10 after
    warm-up, the batch on the card. Peak memory, kernels per step, the busy
    share and a profile with where MAS stands."""
    from tpu_speech_torch.cli import train
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.gradtts import step_generator, train_step
    from tpu_speech_torch.train.optim import AdamW

    model = train.build_model().cuda().train()
    opt = AdamW(model.parameters(), 1e-4)
    batch = _gradtts_bench_batch(torch)
    it = [0]
    phase, tag = ("44", "bf16") if bf16 else ("29", "fp32")

    def step():
        it[0] += 1
        return train_step(model, opt, batch, step_generator(0, it[0], "cuda"), 172, bf16=bf16)

    ms, peak = _timed_step(torch, step)
    _build.reset_launches()
    m = step()
    torch.cuda.synchronize()
    check(_build.LAUNCHES == dict(dict.fromkeys(_build.LAUNCHES, 0), maximum_path=1),
          f"bench step launches {_build.LAUNCHES}")
    check(all(torch.isfinite(v) for v in m.values()), f"bench step metrics {m}")
    log(f"[{phase} gradtts train step time] bench.py's point B = 16, Tx 72, Ty 512, out_size "
        f"172, {tag}: {ms:.2f} ms per step (median of 10), peak device memory {peak:.3f} GiB")
    prof = profile_slice(torch, step, batches=3, top=12, tag=f"{phase} profile, {tag} train step")
    if prof is not None:
        ranks = [i for i, (name, _, _) in enumerate(prof["ranked"]) if "maximum_path" in name]
        if ranks:
            name, mas_ms, n = prof["ranked"][ranks[0]]
            log(f"    MAS: rank {ranks[0] + 1} of {len(prof['ranked'])} kernels by device time, "
                f"{mas_ms:.4f} ms x{n} per step ({mas_ms / prof['busy_ms']:.4f} of the busy "
                f"time)")
    return ms, peak


# ---- DiffVC voice conversion (phases 30-32) -----------------------------------

VC_SEED = 31
VC_SR = 22050
VC_FRAMES = 256  # bench.py's conversion point: B = 1, 256-frame source and reference
# card against CPU: the mels' mean absolute error (PR 7's phase-24 gate) and the
# speaker embedding's largest difference
VC_MEL_MAE = 1e-3
VC_EMB_ATOL = 1e-4
VC_WAV_ATOL = 1e-4
# The samplers on random weights, card against CPU: an untrained estimator
# does not cancel the drift away from the average voice, so the state grows
# up to 1/gamma(0, 1) ~ 150x the noise, and the U-Net turns to NaN at inputs
# of a few hundred (its linear attention is quadratic in its input). As in
# tests/test_torch_diffvc.py, the draws are scaled by 0.01 and the
# estimator's last conv by 0.02 there: the state stays within tens.
VC_NOISE_SCALE = 0.01
VC_SCORE_SCALE = 0.02


def _vc_models(torch, zero_gains=False):
    """DiffVC at cli/params_vc.py's width and the GE2E speaker encoder,
    seeded random weights, on the CPU. ``zero_gains``: the rezero gains at
    zero, the reference's init, with which the U-Net stays finite at the
    hundreds that the untrained sampler's state reaches."""
    from tpu_speech_torch.configs import diffvc as vc_cfg
    from tpu_speech_torch.models.diffvc import DiffVC
    from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder

    model = DiffVC(**vc_cfg.model_kwargs()).init_weights(torch.Generator().manual_seed(VC_SEED))
    if zero_gains:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(".fn.g"):
                    p.zero_()
    spk = SpeakerEncoder().init_weights(torch.Generator().manual_seed(VC_SEED + 1))
    return model.eval(), spk.eval()


def _vc_wav(rng, n):
    return speech_like(rng, n, sr=VC_SR)


def phase_vc_slice(torch, rng, root):
    """30: source wav + target wav -> converted wav through
    tpu_speech_torch.cli.inference_vc.main on the card, at cli/params_vc.py's
    width: a reference-named diffvc.pt (seeded random weights, rezero gains
    zero) and a {'model_state': ...} speaker encoder; speech-like 22 050 Hz
    wavs, the source 3.0 s, the target 2.5 s; --mode ml -n 30, --mode dpm -n
    6, then ml again warm. Each wav has hop x (frames - 1) samples (the JAX
    CLI's fast_griffin_lim length), the converted mel is finite, and no hand
    kernel launches. Returns the launch counts and the warm run's result."""
    import scipy.io.wavfile

    from tpu_speech_torch.cli import inference_vc
    from tpu_speech_torch.data.wav import write_wav
    from tpu_speech_torch.ops import _build

    model, spk = _vc_models(torch, zero_gains=True)
    ckpt, spk_pt = os.path.join(root, "diffvc.pt"), os.path.join(root, "encoder.pt")
    torch.save(model.state_dict(), ckpt)
    torch.save({"model_state": spk.state_dict()}, spk_pt)
    n_params = sum(p.numel() for p in model.parameters())
    del model, spk
    src, tgt = os.path.join(root, "source.wav"), os.path.join(root, "target.wav")
    src_wav = _vc_wav(rng, 3 * VC_SR)
    write_wav(src, src_wav, VC_SR)
    write_wav(tgt, _vc_wav(rng, VC_SR * 5 // 2), VC_SR)
    frames = len(src_wav) // 256
    _build.reset_launches()
    runs = []
    for mode, n, name in (("ml", 30, "ml30.wav"), ("dpm", 6, "dpm6.wav"), ("ml", 30, "warm.wav")):
        t0 = time.perf_counter()
        res = inference_vc.main(["-s", src, "-t", tgt, "-c", ckpt, "--spk-encoder", spk_pt,
                                 "-n", str(n), "--mode", mode, "-o", os.path.join(root, name)])
        wall = time.perf_counter() - t0
        sr, pcm = scipy.io.wavfile.read(res["output"])
        stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in res["times"].items())
        log(f"    [30] {mode} -n {n}: {res['frames']} frames -> {len(pcm)} int16 samples "
            f"({res['seconds']:.3f} s) in {wall:.2f} s by main(); stages: {stages}; max "
            f"|converted mel| {res['max_abs_mel']:.1f}; finite {res['finite']}")
        check(sr == VC_SR and pcm.dtype == np.int16, f"{name}: {sr} Hz, {pcm.dtype}")
        check(res["frames"] == frames and pcm.shape == ((frames - 1) * 256,),
              f"{name}: {res['frames']} frames, {pcm.shape} samples")
        check(res["finite"]["mel"], f"{name}: the converted mel is not finite")
        runs.append(res)
    launches = dict(_build.LAUNCHES)
    check(not any(launches.values()), f"hand kernels on the conversion path: {launches}")
    log(f"[30 vc slice] DiffVC {n_params} parameters at cli/params_vc.py's width; source "
        f"{frames} frames, target 2.5 s; ml 30 and dpm 6 through cli.inference_vc.main; "
        f"hand-kernel launches 0")
    return launches, runs[-1]


def phase_vc_cpu_vs_card(torch):
    """31: the same weights and inputs on the card and on the CPU: the
    average-voice encoder and one estimator call at T = 256, voice_convert
    with 3 ml steps and 2 dpm steps at T = 128 (the draws replayed, see
    VC_NOISE_SCALE), the speaker embedding of a 2.5 s utterance, istft, and
    32 Griffin-Lim iterations (by spectral convergence, as the CPU tests).
    The mels within MAE 1e-3, the embedding 1e-4. voice_convert and
    Griffin-Lim run again on the card under set_sync_debug_mode("error")."""
    import copy

    from tpu_speech_torch.audio.mel import hann_window, mel_spectrogram_np
    from tpu_speech_torch.audio.vocode import (
        fast_griffin_lim,
        griffin_lim_constants,
        istft,
        stft_complex,
    )
    from tpu_speech_torch.models.diffvc import voice_convert
    from tpu_speech_torch.models.speaker_encoder import embed_utterance, preprocess_wav

    model, spk = _vc_models(torch)
    small = copy.deepcopy(model)
    with torch.no_grad():
        small.decoder.estimator.final_conv.weight.mul_(VC_SCORE_SCALE)
        small.decoder.estimator.final_conv.bias.mul_(VC_SCORE_SCALE)
    r = np.random.default_rng(VC_SEED)
    g = torch.Generator().manual_seed(VC_SEED)
    wav = _vc_wav(r, 256 * VC_FRAMES)
    mel = torch.from_numpy(mel_spectrogram_np(wav[None]))  # (1, 256, 80)
    ref = torch.from_numpy(mel_spectrogram_np(_vc_wav(r, VC_SR * 5 // 2)[None]))
    tgt_wav = preprocess_wav(_vc_wav(r, VC_SR * 5 // 2), VC_SR)
    lens, rlens = torch.tensor([VC_FRAMES]), torch.tensor([ref.shape[1]])
    c = torch.randn(1, 256, generator=g)
    c = c / c.norm()
    xt = torch.randn(1, VC_FRAMES, 80, generator=g)
    half = VC_FRAMES // 2
    z_noise = VC_NOISE_SCALE * torch.randn(1, half, 80, generator=g)
    step_noise = VC_NOISE_SCALE * torch.randn(3, 1, half, 80, generator=g)
    spec = stft_complex(torch.from_numpy(np.stack([wav, _vc_wav(r, len(wav))])), 1024, 256,
                        torch.from_numpy(hann_window(1024)))
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev), small.to(dev), spk.to(dev)
        d = {k: v.to(dev) for k, v in dict(mel=mel, ref=ref, lens=lens, rlens=rlens, c=c, xt=xt,
                                           z=z_noise, steps=step_noise, spec=spec).items()}
        mask = torch.ones(1, VC_FRAMES, device=dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            mean = model.encode(d["mel"], mask)
            score = model.score(mean + d["xt"], mask, mean, d["ref"],
                                torch.ones(1, ref.shape[1], device=dev), d["c"],
                                torch.full((1,), 0.5, device=dev))
            conv = {}
            for mode, n in (("ml", 3), ("dpm", 2)):
                conv[mode] = voice_convert(
                    small, d["mel"][:, :half], d["lens"] // 2, d["ref"], d["rlens"], d["c"], n,
                    mode, z_noise=d["z"], step_noise=d["steps"] if mode == "ml" else None)[1]
            emb = embed_utterance(spk, tgt_wav)
            _, window = griffin_lim_constants(VC_SR, 1024, 80, torch.device(dev))
            back = istft(d["spec"], 1024, 256, window)
            gl = fast_griffin_lim(d["mel"], n_iters=32)
        out[dev] = {k: v.cpu() for k, v in dict(mean=mean, score=score, ml=conv["ml"],
                                                dpm=conv["dpm"], emb=emb, istft=back,
                                                gl=gl).items()}
        log(f"    [31] {dev}: encoder, estimator, ml 3 + dpm 2 at T = {half}, embedding, istft "
            f"and Griffin-Lim in {time.perf_counter() - t0:.1f} s")
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.inference_mode():
                    gen = torch.Generator("cuda").manual_seed(0)
                    voice_convert(small, d["mel"][:, :half], d["lens"] // 2, d["ref"],
                                  d["rlens"], d["c"], 3, "ml", generator=gen)
                    voice_convert(small, d["mel"][:, :half], d["lens"] // 2, d["ref"],
                                  d["rlens"], d["c"], 2, "dpm", generator=gen)
                    fast_griffin_lim(d["mel"], n_iters=32)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    cpu, card = out["cpu"], out["cuda"]
    res = {}
    for name in ("mean", "score", "ml", "dpm"):
        a, b = cpu[name], card[name]
        check(bool(torch.isfinite(b).all()), f"{name}: not finite on the card")
        mae, worst = (b - a).abs().mean().item(), (b - a).abs().max().item()
        res[name] = mae
        log(f"[31 vc card vs cpu] {name}: MAE {mae:.3e} (limit {VC_MEL_MAE}), max {worst:.3e}, "
            f"mean|cpu| {a.abs().mean().item():.3f}, max|cpu| {a.abs().max().item():.3f}")
        check(mae < VC_MEL_MAE, f"{name}: card vs CPU MAE {mae}")
    emb_err = (card["emb"] - cpu["emb"]).abs().max().item()
    wav_err = (card["istft"] - cpu["istft"]).abs().max().item()
    log(f"[31 vc card vs cpu] speaker embedding max diff {emb_err:.3e} (limit {VC_EMB_ATOL}); "
        f"istft max diff {wav_err:.3e} (limit {VC_WAV_ATOL}) at max|wav| "
        f"{cpu['istft'].abs().max().item():.3f}")
    check(emb_err <= VC_EMB_ATOL, f"speaker embedding: {emb_err}")
    check(wav_err <= VC_WAV_ATOL, f"istft: {wav_err}")
    sc = {dev: _spectral_convergence(torch, out[dev]["gl"], mel) for dev in out}
    gl_err = (card["gl"] - cpu["gl"]).abs().max().item()
    log(f"[31 vc card vs cpu] Griffin-Lim 32 iterations: spectral convergence card "
        f"{sc['cuda']:.6f}, cpu {sc['cpu']:.6f}; max sample diff {gl_err:.3e} at max|wav| "
        f"{cpu['gl'].abs().max().item():.3f}")
    check(abs(sc["cuda"] - sc["cpu"]) < 1e-3, f"Griffin-Lim spectral convergence {sc}")
    log("    [31] voice_convert (ml 3, dpm 2) and Griffin-Lim under "
        "set_sync_debug_mode('error'): no host sync")
    res.update(embedding=emb_err, istft=wav_err, gl_sc=sc)
    return res


def _spectral_convergence(torch, wav, log_mel):
    """||S - |STFT(wav)||| / ||S|| in float64 on the CPU, S the magnitude
    that Griffin-Lim aims at (the pseudo-inverted mels)."""
    from tpu_speech_torch.audio.mel import hann_window
    from tpu_speech_torch.audio.vocode import mel_pseudo_inverse, stft_complex

    inv = torch.from_numpy(mel_pseudo_inverse(VC_SR, 1024, 80).astype(np.float64))
    target = torch.exp(log_mel.double()) @ inv.T
    mag = stft_complex(wav.double(), 1024, 256, torch.from_numpy(hann_window(1024)).double()).abs()
    return ((mag - target).norm() / target.norm()).item()


def phase_vc_time(torch, cli_res):
    """32: bench.py's conversion points (bench.py:430-475), fp32, CUDA events
    (median of 10): B = 1, 256-frame source and reference (standard normal,
    as bench.py's), 30 ml steps (diffvc_conversion_rtf_30step) and 6 dpm
    steps (_dpm6); RTF = t x 22 050 / (256 x 256). Beside each its bound:
    the convolutions' and products' FLOP (torch.utils.flop_counter: one
    estimator call and one encode at these shapes) at the CUDA cores' fp32
    rate. Then Griffin-Lim alone, the CLI's wav -> wav stages (phase 30's
    warm run), peak memory, and a profile (kernels per conversion, the busy
    share, the top device ops)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_speech_torch.audio.vocode import fast_griffin_lim
    from tpu_speech_torch.models.diffvc import voice_convert

    model, _ = _vc_models(torch, zero_gains=True)
    model.cuda()
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((1, VC_FRAMES, 80)).astype(np.float32)).cuda()
    xr = torch.from_numpy(r.standard_normal((1, VC_FRAMES, 80)).astype(np.float32)).cuda()
    c = torch.from_numpy(r.standard_normal((1, 256)).astype(np.float32)).cuda()
    lens = torch.tensor([VC_FRAMES], device="cuda")
    mask = torch.ones(1, VC_FRAMES, device="cuda")
    with torch.inference_mode(), FlopCounterMode(display=False) as fc_enc:
        mean = model.encode(x, mask)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc_score:
        model.score(x, mask, mean, xr, mask, c, torch.full((1,), 0.5, device="cuda"))
    enc_flop, score_flop = fc_enc.get_total_flops(), fc_score.get_total_flops()
    audio_s = VC_FRAMES * 256 / VC_SR
    res = {}

    def convert(n, mode):
        g = torch.Generator("cuda").manual_seed(0)
        with torch.inference_mode():
            return voice_convert(model, x, lens, xr, lens, c, n, mode, generator=g)[1]

    for name, n, mode in (("diffvc_conversion_rtf_30step", 30, "ml"),
                          ("diffvc_conversion_rtf_dpm6", 6, "dpm")):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: convert(n, mode), n=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flop = n * score_flop + 2 * enc_flop
        bound_ms = flop / PEAK_FP32 * 1e3
        res[name] = dict(ms=ms, rtf=ms / 1e3 / audio_s, peak_gib=peak, tflop=flop / 1e12,
                         bound_ms=bound_ms)
        log(f"[32 vc time] {name}: {ms:.2f} ms for {VC_FRAMES} frames ({audio_s:.3f} s of "
            f"audio), RTF {ms / 1e3 / audio_s:.5f}; bound {bound_ms:.2f} ms ({flop / 1e12:.2f} "
            f"TFLOP at {PEAK_FP32 / 1e12:.0f} TFLOP/s fp32; {ms / bound_ms:.2f}x); peak "
            f"{peak:.3f} GiB")
    log(f"    per call: estimator {score_flop / 1e9:.1f} GFLOP, encode {enc_flop / 1e9:.1f} "
        f"GFLOP (convolutions and products)")
    log_mel = torch.randn(1, VC_FRAMES, 80, generator=torch.Generator().manual_seed(0)).cuda() - 4
    with torch.inference_mode():
        gl_ms = cuda_ms(lambda: fast_griffin_lim(log_mel, n_iters=32), n=10, warmup=2)
    res["griffin_lim_ms"] = gl_ms
    log(f"[32 vc time] Griffin-Lim, 32 iterations at {VC_FRAMES} frames: {gl_ms:.2f} ms")
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in cli_res["times"].items())
    total = sum(cli_res["times"].values())
    log(f"[32 vc time] CLI wav -> wav, ml 30, {cli_res['frames']} frames ({cli_res['seconds']:.3f}"
        f" s out), host clock by stage (phase 30's warm run): {stages}; {total * 1e3:.1f} ms "
        f"in all, RTF {total / cli_res['seconds']:.4f}")
    prof = profile_slice(torch, lambda: convert(30, "ml"), batches=2, top=12,
                         tag="32 profile, ml 30 conversion, B = 1 x 256 frames")
    res["profile"] = None if prof is None else {k: prof[k] for k in ("kernels", "busy_ms",
                                                                      "span_ms", "share")}
    return res


# ---- DiffVC and GE2E speaker-encoder training (phases 33-36) --------------------

TR_SEED = 33
TR_SPEAKERS = 16
TR_UTTS = 16  # per speaker: 256 utterances, two of the encoder's 128-batches an epoch
TR_SECONDS = (2.0, 2.6)  # 160+ frames at 16 kHz after the trim, 172+ mel frames at 22 050 Hz
TR_PHONES = ("sil", "AH0", "B", "D", "EH1", "IY1", "K", "L", "M", "N", "S", "T")
TR_GE2E = dict(speakers=16, utterances=10)  # the CLI run's batch; phase 36 times the recipe's
ENC_POINT = (128, 128)  # the recipe's batches: B x train_frames (cli/train_enc.py:49)
DEC_POINT = (32, 128)  # cli/train_dec.py:146
GE2E_POINT = (64, 10, 160)  # speakers x utterances x frames (cli/train_spk_encoder.py:332-334)


def write_speaker_corpus(root, rng):
    """TR_SPEAKERS x TR_UTTS speech-like 22 050 Hz wavs of TR_SECONDS, each
    speaker around a base f0 of its own: ``<root>/<spk>/<spk>_<u>.wav``.
    Returns {speaker: [paths]}."""
    from tpu_speech_torch.data.wav import write_wav

    wavs = {}
    for s in range(TR_SPEAKERS):
        spk = f"spk{s:02d}"
        os.makedirs(os.path.join(root, spk))
        f0 = 90 + 170 * s / (TR_SPEAKERS - 1)
        wavs[spk] = []
        for u in range(TR_UTTS):
            path = os.path.join(root, spk, f"{spk}_{u:03d}.wav")
            n = int(rng.uniform(*TR_SECONDS) * 22050)
            write_wav(path, speech_like(rng, n, sr=22050, f0=f0 * rng.uniform(0.95, 1.05)),
                      22050)
            wavs[spk].append(path)
    return wavs


def phase_spk_train(torch, rng, root):
    """33: the speaker encoder's data and training on the card. Synthetic
    per-speaker wav directories -> tpu_speech_torch.cli.preprocess_spk.main
    -> cli.train_spk_encoder.main at the full width (3 x 256 LSTM) for 4
    steps of 16 speakers x 10 utterances x 160 frames, then a second run
    that resumes at step 4 and takes 2. The losses finite, the EER in [0,
    1], no hand kernel; the .pt loads through cli.inference_vc's
    --spk-encoder loader. Returns the launches, the .pt, the wavs and the
    preprocessed root."""
    from tpu_speech_torch.cli import inference_vc, preprocess_spk, train_spk_encoder
    from tpu_speech_torch.ops import _build

    raw, clean, models = (os.path.join(root, d) for d in ("raw", "clean", "models"))
    t0 = time.perf_counter()
    wavs = write_speaker_corpus(raw, rng)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = preprocess_spk.main([raw, "-o", clean, "-n", "smoke"])
    t_prep = time.perf_counter() - t0
    check(n == TR_SPEAKERS * TR_UTTS, f"preprocess_spk kept {n} utterances")
    args = ["smoke", clean, "-m", models, "-v", "2", "-u", "0", "-s", "2", "-b", "0",
            "--speakers_per_batch", str(TR_GE2E["speakers"]),
            "--utterances_per_speaker", str(TR_GE2E["utterances"])]
    runs = []
    _build.reset_launches()
    for max_steps in (4, 6):
        t0 = time.perf_counter()
        runs.append(train_spk_encoder.main(args + ["--max_steps", str(max_steps)]))
        torch.cuda.synchronize()
        runs[-1]["wall"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    r1, r2 = runs
    log(f"[33 ge2e train] {n} utterances of {TR_SECONDS[0]}-{TR_SECONDS[1]} s from "
        f"{TR_SPEAKERS} speakers (written in {t_write:.1f} s, preprocess_spk {t_prep:.1f} s); "
        f"cli.train_spk_encoder at 3 x 256, {TR_GE2E['speakers']} speakers x "
        f"{TR_GE2E['utterances']} utterances x 160 frames: run 1 to step {r1['step']} in "
        f"{r1['wall']:.1f} s, run 2 resumed to step {r2['step']} in {r2['wall']:.1f} s; host "
        f"batch time {r2['times']['batch']['mean_s'] * 1e3:.1f} ms a step; hand-kernel "
        f"launches {sum(launches.values())}")
    for step, loss, eer in r1["reports"] + r2["reports"]:
        log(f"    step {step}: loss {loss:.4f}, EER {eer:.4f}")
        check(np.isfinite(loss) and 0.0 <= eer <= 1.0, f"step {step}: loss {loss}, EER {eer}")
    check([r[0] for r in r1["reports"]] == [2, 4] and [r[0] for r in r2["reports"]] == [6],
          f"reports {r1['reports']}, {r2['reports']}")
    check(not any(launches.values()), f"hand kernels on the GE2E path: {launches}")
    spk = inference_vc.load_speaker_encoder(r2["model_path"], torch.device("cuda"))
    saved = torch.load(r2["model_path"], weights_only=True)
    check(saved["step"] == 6 and all(torch.equal(v.cpu(), saved["model_state"][k])
                                     for k, v in spk.state_dict().items()),
          "the trained .pt does not load as it is through --spk-encoder")
    return launches, r2["model_path"], wavs, clean


def _textgrid(intervals, xmax):
    """A long-format Praat TextGrid with one 'phones' tier."""
    items = "".join(f"        intervals [{i + 1}]:\n            xmin = {a:.4f}\n"
                    f"            xmax = {b:.4f}\n            text = \"{text}\"\n"
                    for i, (a, b, text) in enumerate(intervals))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\nxmin = 0\n'
            f'xmax = {xmax:.4f}\ntiers? <exists>\nsize = 1\nitem []:\n    item [1]:\n'
            '        class = "IntervalTier"\n        name = "phones"\n        xmin = 0\n'
            f'        xmax = {xmax:.4f}\n        intervals: size = {len(intervals)}\n{items}')


def write_vc_data(torch, root, rng, wavs, spk_model):
    """A DiffVC data dir from phase 33's wavs: HiFi-GAN-convention host mels
    (80, T), each utterance's embedding by phase 33's encoder, and a
    TextGrid of random phone intervals (60-160 ms)."""
    from tpu_speech_torch.audio.mel import mel_spectrogram_np
    from tpu_speech_torch.data.wav import read_wav
    from tpu_speech_torch.models.speaker_encoder import embed_utterance, preprocess_wav

    for spk, paths in wavs.items():
        for d in ("mels", "embeds", "textgrids"):
            os.makedirs(os.path.join(root, d, spk))
        for path in paths:
            uid = os.path.splitext(os.path.basename(path))[0]
            wav, sr = read_wav(path)
            wav = wav[: len(wav) // 256 * 256]
            np.save(os.path.join(root, "mels", spk, f"{uid}_mel.npy"),
                    mel_spectrogram_np(wav[None])[0].T)
            with torch.inference_mode():
                emb = embed_utterance(spk_model, preprocess_wav(wav, sr)).cpu().numpy()
            np.save(os.path.join(root, "embeds", spk, f"{uid}_embed.npy"), emb)
            secs, edges = len(wav) / sr, [0.0]
            while edges[-1] < secs:
                edges.append(min(secs, edges[-1] + rng.uniform(0.06, 0.16)))
            phones = [(a, b, TR_PHONES[int(rng.integers(len(TR_PHONES)))])
                      for a, b in zip(edges[:-1], edges[1:])]
            with open(os.path.join(root, "textgrids", spk, f"{uid}.TextGrid"), "w") as f:
                f.write(_textgrid(phones, secs))


def phase_vc_train_slice(torch, rng, root, wavs, spk_pt):
    """34: DiffVC's two-stage training at cli/params_vc.py's width on the
    card. Phase 33's 256 utterances -> mels, embeddings by phase 33's
    encoder, TextGrids -> cli.get_avg_mels.main -> cli.train_enc.main at B =
    128 x 128 frames for 2 epochs (4 steps), then a second run that resumes
    at epoch 3 (2 steps) -> cli.train_dec.main from its enc.pt at B = 32 for
    2 epochs (16 steps), then a resumed epoch (8 steps) -> the trained
    diffvc.pt and phase 33's encoder through cli.inference_vc.main (ml 30).
    Every step's loss finite; no hand kernel on either stage; the encoder in
    diffvc.pt bit for bit enc.pt's; the estimator moved in the resumed
    epoch; the converted mel finite."""
    from tpu_speech_torch.cli import get_avg_mels, inference_vc, train_dec, train_enc
    from tpu_speech_torch.ops import _build

    data = os.path.join(root, "vc")
    t0 = time.perf_counter()
    write_vc_data(torch, data, rng, wavs, inference_vc.load_speaker_encoder(spk_pt, "cuda"))
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    modes = get_avg_mels.main(["--data-dir", data])
    t_avg = time.perf_counter() - t0
    check(set(modes) == set(TR_PHONES), f"average mels for {sorted(modes)}")
    enc_dir, dec_dir = os.path.join(root, "enc"), os.path.join(root, "dec")
    launches, runs = {}, {}
    for stage, cli, extra, epochs in (("enc", train_enc, ["--log-dir", enc_dir], (2, 3)),
                                      ("dec", train_dec, ["--log-dir", dec_dir], (2, 3))):
        if stage == "dec":
            extra = extra + ["--enc-ckpt", runs["enc"][-1]["state_dict"]]
        _build.reset_launches()
        runs[stage] = []
        for n in epochs:
            t0 = time.perf_counter()
            res = cli.main(["--data-dir", data, "--epochs", str(n)] + extra)
            torch.cuda.synchronize()
            res["wall"] = time.perf_counter() - t0
            res["sd"] = torch.load(res["state_dict"], weights_only=True)
            runs[stage].append(res)
        launches[stage] = dict(_build.LAUNCHES)
    (e1, e2), (d1, d2) = runs["enc"], runs["dec"]
    log(f"[34 vc train slice] data: 256 mels, embeddings and TextGrids in {t_data:.1f} s, "
        f"get_avg_mels {t_avg:.1f} s ({len(modes)} phones); train_enc ({e1['n_params']} "
        f"parameters, B = 128): {e1['iteration']} steps in {e1['wall']:.1f} s, resumed at epoch "
        f"{e2['first_epoch']}: {e2['iteration'] - e1['iteration']} steps in {e2['wall']:.1f} s; "
        f"train_dec ({d1['n_params']} parameters, B = 32): {d1['iteration']} steps in "
        f"{d1['wall']:.1f} s, resumed at epoch {d2['first_epoch']}: "
        f"{d2['iteration'] - d1['iteration']} steps in {d2['wall']:.1f} s; hand-kernel launches "
        f"{sum(launches['enc'].values()) + sum(launches['dec'].values())}")
    for tag, (r1, r2) in (("enc", runs["enc"]), ("dec", runs["dec"])):
        hist = r1["history"] + r2["history"]
        log(f"    {tag} losses {[round(h['loss'], 4) for h in hist]}; grad norms "
            f"{[round(h['grad_norm'], 3) for h in hist]}")
        check(all(np.isfinite(list(h.values())).all() for h in hist), f"{tag}: {hist}")
        check(not any(launches[tag].values()), f"hand kernels on {tag}: {launches[tag]}")
        with open(os.path.join(r2["log_dir"], "train.log")) as f:
            check(len(f.read().splitlines()) == 3, f"{tag}: train.log lines")
    check((e1["iteration"], e2["first_epoch"], e2["iteration"]) == (4, 3, 6),
          f"enc steps {e1['iteration']} -> epoch {e2['first_epoch']}, {e2['iteration']}")
    check((d1["iteration"], d2["first_epoch"], d2["iteration"]) == (16, 3, 24),
          f"dec steps {d1['iteration']} -> epoch {d2['first_epoch']}, {d2['iteration']}")
    enc_sd = e2["sd"]
    check(all(torch.equal(d2["sd"][f"encoder.{k}"], v) for k, v in enc_sd.items()),
          "the decoder's steps moved the encoder")
    moved = max((d2["sd"][k] - d1["sd"][k]).abs().max().item() for k in d2["sd"]
                if k.startswith("decoder.estimator."))
    check(moved > 0, "the estimator did not move in the resumed epoch")
    src, tgt = wavs["spk00"][0], wavs[f"spk{TR_SPEAKERS - 1:02d}"][0]
    out = inference_vc.main(["-s", src, "-t", tgt, "-c", d2["state_dict"], "--spk-encoder",
                             spk_pt, "-n", "30", "-o", os.path.join(root, "converted.wav")])
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in out["times"].items())
    log(f"    the encoder in diffvc.pt equals enc.pt bit for bit; the estimator moved "
        f"{moved:.3e} in the resumed epoch; cli.inference_vc on the trained diffvc.pt and "
        f"phase 33's encoder (ml 30): {out['frames']} frames, max |mel| "
        f"{out['max_abs_mel']:.2f}, finite {out['finite']}; {stages}")
    check(out["finite"]["mel"], "the trained model's converted mel is not finite")
    return {"diffvc_enc_train": launches["enc"], "diffvc_dec_train": launches["dec"]}


def _hold_train_step(torch, tag, model, lr, batches, step):
    """One step on the CPU and on the card from the same weights and batch
    (``batches[dev]``), the card's under set_sync_debug_mode("error"): the
    loss within STEP_LOSS_RTOL, each gradient within GRAD_RTOL x its max|g|
    or GT_GRAD_FLOOR x the largest, the card's parameters within
    GT_PARAM_RTOL x max(1, |p|) of the CPU's Adam on the card's gradients
    (phase 28's limits). ``step(model, opt, batch)`` returns the metrics."""
    import copy

    from tpu_speech_torch.train.optim import AdamW

    side = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        opt = AdamW(m.parameters(), lr)
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            met = step(m, opt, batches[dev])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        side[dev] = (dict(m.named_parameters()), float(met["loss"]))
    (p_cpu, loss_cpu), (p_card, loss_card) = side["cpu"], side["cuda"]
    ref = copy.deepcopy(model)
    p_ref = dict(ref.named_parameters())
    for k, p in p_card.items():
        p_ref[k].grad = p.grad.cpu()
    AdamW(ref.parameters(), lr).step()
    g_max = max(p.grad.abs().max().item() for p in p_cpu.values())
    worst_g, worst_p = (0.0, ""), (0.0, "")
    for k, p in p_cpu.items():
        err = (p_card[k].grad.cpu() - p.grad).abs().max().item()
        worst_g = max(worst_g, (err / max(GRAD_RTOL * p.grad.abs().max().item(),
                                          GT_GRAD_FLOOR * g_max), k))
        rel = ((p_card[k].detach().cpu() - p_ref[k].detach()).abs()
               / p_ref[k].detach().abs().clamp(min=1.0)).max().item()
        worst_p = max(worst_p, (rel, k))
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"[35 train card vs cpu] {tag}: loss card {loss_card:.6f} cpu {loss_cpu:.6f} (rel "
        f"{rel_loss:.2e}, limit {STEP_LOSS_RTOL}); worst gradient at {worst_g[0]:.3f} of its "
        f"bound ({worst_g[1]}) over {len(p_cpu)} tensors; parameters after Adam "
        f"{worst_p[0]:.2e} x max(1, |p|) from the CPU's Adam on the card's gradients "
        f"({worst_p[1]}; limit {GT_PARAM_RTOL}); no host sync in the card's step")
    check(rel_loss <= STEP_LOSS_RTOL, f"{tag}: loss {loss_card} vs {loss_cpu}")
    check(worst_g[0] <= 1.0, f"{tag}: gradient {worst_g}")
    check(worst_p[0] <= GT_PARAM_RTOL, f"{tag}: parameters after Adam {worst_p}")
    return {"loss_rel": rel_loss, "grad": worst_g[0], "param": worst_p[0]}


def phase_train_cpu_vs_card(torch):
    """35: the encoder step, the decoder step and the GE2E step at full
    width and a small batch on the card against the CPU: the same seeded
    weights (rezero gains drawn), the same batch, dropout off (the encoder
    in eval mode; the decoder in train mode, whose loss runs the encoder
    frozen), the decoder's t and z given; phase 28's limits; the card's
    steps make no host sync."""
    from tpu_speech_torch.configs import diffvc as vc_cfg
    from tpu_speech_torch.models.diffvc import DiffVC
    from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder
    from tpu_speech_torch.train.diffvc import dec_train_step, enc_train_step
    from tpu_speech_torch.train.speaker_encoder import ge2e_train_step

    g = torch.Generator().manual_seed(TR_SEED)
    model = DiffVC(**vc_cfg.model_kwargs()).init_weights(g)
    b, t = 2, vc_cfg.train_frames
    r = np.random.default_rng(TR_SEED)
    enc_batch = {"x": r.normal(-5, 2, (b, t, 80)).astype(np.float32),
                 "y": r.normal(-5, 2, (b, t, 80)).astype(np.float32),
                 "lengths": np.array([t, t * 3 // 4], np.int32)}
    c = r.standard_normal((b, 256)).astype(np.float32)
    dec_batch = {"mel1": r.normal(-5, 2, (b, t, 80)).astype(np.float32),
                 "mel2": r.normal(-5, 2, (b, t, 80)).astype(np.float32),
                 "mel_lengths": np.array([t, t * 5 // 8], np.int32),
                 "c": c / np.linalg.norm(c, axis=1, keepdims=True)}
    draws = {"t": np.array([0.23, 0.81], np.float32),
             "z": r.standard_normal((b, t, 80)).astype(np.float32)}
    frames = (r.uniform(0, 1, (4, 5, 160, 40)) ** 4 * 5).astype(np.float32)

    def on(dev, arrays):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    res = {"enc": _hold_train_step(
        torch, f"encoder step, B = {b} x {t} (eval: dropout off), Adam 5e-4",
        model.encoder.eval(), 5e-4, {d: on(d, enc_batch) for d in ("cpu", "cuda")},
        enc_train_step)}
    dec_inputs = {d: (on(d, dec_batch), on(d, draws)) for d in ("cpu", "cuda")}
    res["dec"] = _hold_train_step(
        torch, f"decoder step, B = {b} x {t}, t and z given, Adam 1e-4", model.train(), 1e-4,
        dec_inputs, lambda m, opt, bd: dec_train_step(m, opt, bd[0], **bd[1]))
    spk = SpeakerEncoder().init_weights(torch.Generator().manual_seed(TR_SEED + 1)).train()
    res["ge2e"] = _hold_train_step(
        torch, "GE2E step, 4 speakers x 5 utterances x 160 frames, Adam 1e-4", spk, 1e-4,
        {d: torch.from_numpy(frames).to(d) for d in ("cpu", "cuda")}, ge2e_train_step)
    return res


def _lstm_flop(batch, frames, n_in, hidden, layers):
    """A multi-layer LSTM's products in training: forward 2 x B x T x 4H x
    (in + H) a layer, backward twice that."""
    fwd = sum(2 * batch * frames * 4 * hidden * ((n_in if i == 0 else hidden) + hidden)
              for i in range(layers))
    return 3 * fwd


def _train_point(torch, tag, step, extra_flop=0, host_ms=None):
    """A training step's recipe point: CUDA events (median of 5 after 2
    warm-ups), peak memory, no hand kernel, the FLOP bound (convolutions and
    products by torch.utils.flop_counter over one step, forward and
    backward, plus ``extra_flop``, at the CUDA cores' fp32 rate), and a
    profile (kernels per step, busy share, top device ops)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_speech_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, n=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _build.reset_launches()
    with FlopCounterMode(display=False) as fc:
        step()
    torch.cuda.synchronize()
    check(not any(_build.LAUNCHES.values()), f"{tag}: hand kernels {_build.LAUNCHES}")
    counted = fc.get_total_flops()
    ops = {str(op) for counts in fc.get_flop_counts().values() for op in counts}
    if any("rnn" in op or "lstm" in op for op in ops):
        extra_flop = 0  # the counter saw the recurrence itself
    flop = counted + extra_flop
    bound_ms = flop / PEAK_FP32 * 1e3
    host = "" if host_ms is None else f"; the host's batch {host_ms:.1f} ms a step"
    log(f"[36 train step time] {tag}: {ms:.2f} ms a step (median of 5), peak {peak:.2f} GiB; "
        f"bound {bound_ms:.2f} ms ({flop / 1e12:.3f} TFLOP at {PEAK_FP32 / 1e12:.0f} TFLOP/s "
        f"fp32, {counted / 1e12:.3f} counted + {extra_flop / 1e12:.3f} by hand; "
        f"{ms / bound_ms:.2f}x){host}")
    prof = profile_slice(torch, step, batches=2, top=8, tag=f"36 profile, {tag}")
    return {"ms": ms, "peak_gib": peak, "tflop": flop / 1e12, "bound_ms": bound_ms,
            "host_ms": host_ms, "profile": None if prof is None else {
                k: prof[k] for k in ("kernels", "busy_ms", "span_ms", "share")}}


def phase_train_time(torch, clean):
    """36: the recipe's points, fp32 with TF32 off, the batch on the card:
    the encoder step at B = 128 x 128 (dropout on, Adam 5e-4), the decoder
    step at B = 32 x 128 (Adam 1e-4, t and z drawn), the GE2E step at 64
    speakers x 10 utterances x 160 frames x 40 mels (Adam 1e-4), each with
    _train_point's numbers; the GE2E sampler's host time (640 .npy loads
    and crops a batch from phase 33's data) beside its device time."""
    from tpu_speech_torch.cli import train_enc
    from tpu_speech_torch.configs import diffvc as vc_cfg
    from tpu_speech_torch.data.speaker_verification import SpeakerVerificationSampler
    from tpu_speech_torch.models.diffvc import DiffVC
    from tpu_speech_torch.models.speaker_encoder import SpeakerEncoder
    from tpu_speech_torch.train.diffvc import dec_train_step, enc_train_step
    from tpu_speech_torch.train.optim import AdamW
    from tpu_speech_torch.train.speaker_encoder import ge2e_train_step
    from tpu_speech_torch.train.trainer import step_generator

    r = np.random.default_rng(0)
    res = {}
    b, t = ENC_POINT
    enc = train_enc.build_encoder().cuda().train()
    opt = AdamW(enc.parameters(), 5e-4)
    batch = {"x": torch.from_numpy(r.normal(-5, 2, (b, t, 80)).astype(np.float32)).cuda(),
             "y": torch.from_numpy(r.normal(-5, 2, (b, t, 80)).astype(np.float32)).cuda(),
             "lengths": torch.full((b,), t, device="cuda")}
    res["enc"] = _train_point(torch, f"encoder step, B = {b} x {t}",
                              lambda: enc_train_step(enc, opt, batch))
    del enc, opt, batch
    torch.cuda.empty_cache()

    b, t = DEC_POINT
    torch.manual_seed(vc_cfg.seed)
    model = DiffVC(**vc_cfg.model_kwargs()).cuda().train()
    opt = AdamW(model.parameters(), 1e-4)
    c = torch.randn(b, 256, generator=torch.Generator().manual_seed(0))
    batch = {"mel1": torch.from_numpy(r.normal(-5, 2, (b, t, 80)).astype(np.float32)).cuda(),
             "mel2": torch.from_numpy(r.normal(-5, 2, (b, t, 80)).astype(np.float32)).cuda(),
             "mel_lengths": torch.full((b,), t, device="cuda"),
             "c": (c / c.norm(dim=1, keepdim=True)).cuda()}
    it = [0]

    def dec_step():
        it[0] += 1
        return dec_train_step(model, opt, batch, step_generator(0, it[0], "cuda"))

    res["dec"] = _train_point(torch, f"decoder step, B = {b} x {t}", dec_step)
    del model, opt, batch
    torch.cuda.empty_cache()

    s, u, n = GE2E_POINT
    sampler = SpeakerVerificationSampler(clean, s, u, n, seed=0)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        frames = sampler.next_batch()
        host.append((time.perf_counter() - t0) * 1e3)
    frames = torch.from_numpy(frames.reshape(s, u, n, -1)).cuda()
    spk = SpeakerEncoder().init_weights(torch.Generator().manual_seed(0)).cuda().train()
    opt = AdamW(spk.parameters(), 1e-4)
    res["ge2e"] = _train_point(
        torch, f"GE2E step, {s} speakers x {u} utterances x {n} frames",
        lambda: ge2e_train_step(spk, opt, frames),
        extra_flop=_lstm_flop(s * u, n, 40, spk.lstm.hidden_size, spk.lstm.num_layers),
        host_ms=float(np.median(host)))
    return res


def write_corpus(root, rng):
    import scipy.io.wavfile

    words = ["speech", "model", "port", "kernel", "test", "audio", "hello", "world"]
    durations = np.linspace(3.0, 24.0, N_UTTS)
    rng.shuffle(durations)
    manifest = os.path.join(root, "test.json")
    with open(manifest, "w") as f:
        for i, d in enumerate(durations):
            path = os.path.join(root, f"utt{i:02d}.wav")
            pcm = np.clip(speech_like(rng, int(d * SR)) * 32767, -32768, 32767)
            scipy.io.wavfile.write(path, SR, pcm.astype(np.int16))
            text = " ".join(rng.choice(words, size=3))
            f.write(json.dumps({"audio_filepath": path, "duration": float(d),
                                "text": text}) + "\n")
    return manifest


def phase_slice(torch, rng, root):
    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import build_model

    manifest = write_corpus(root, rng)
    model = build_model(spiral_base_ctc_char(), num_classes=28)
    model.init_weights(torch.Generator().manual_seed(1234))
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(root, "spiral_base_ctc_char.pt")
    torch.save(model.state_dict(), ckpt)
    del model
    run_dir = os.path.join(root, "run")
    argv = ["--config_name", "spiral_base_finetune_ls100_char", "--model_type", "ctc_finetune",
            "--run_mode", "test", "--test_manifest", manifest,
            "--model_save_dir", run_dir, "--init_chkpt_dir", root,
            "--init_chkpt_file", os.path.basename(ckpt), "--save_logits", "true"]
    _build.reset_launches()
    t0 = time.perf_counter()
    results = run_spiral.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n_batches = -(-N_UTTS // BATCH)
    log(f"[4 slice] {n_params / 1e6:.1f} M params, {results['n']} utts in "
        f"{n_batches} batches, {wall:.1f} s through run_spiral.main (model "
        f"build, 0.4 GB weight load, data, decode); "
        f"launches {launches}; WER {results['wer']:.3f} (random weights)")
    check(results["n"] == N_UTTS, f"decoded {results['n']} of {N_UTTS} utterances")
    check(launches["fused_logmel"] >= n_batches, f"K1 launches {launches}")
    check(launches["fused_qkv_attention"] == 12 * n_batches, f"K2 launches {launches}")
    check(launches["grouped_conv1d"] == 2 * n_batches and launches["grouped_conv1d_dx"] == 0,
          f"K4 launches {launches}")
    logits = [np.load(os.path.join(run_dir, "logits", f"logits_{BATCH * (i + 1)}.npy"))
              for i in range(n_batches)]
    for lp in logits:
        check(lp.shape == (BATCH, 1208, 29), f"log-probs shape {lp.shape}")
        check(bool(np.isfinite(lp).all()), "non-finite log-probs")
    return manifest, ckpt, logits[0], launches


def load_batch(manifest, n):
    """The first n manifest utterances as the CLI batches them: float32 in
    [-1, 1), zero-padded to 24 s."""
    import scipy.io.wavfile

    with open(manifest) as f:
        entries = [json.loads(line) for line in f][:n]
    wavs = np.zeros((n, MAX_SAMPLES), np.float32)
    lens = np.zeros((n,), np.int32)
    for i, e in enumerate(entries):
        _, pcm = scipy.io.wavfile.read(e["audio_filepath"])
        wavs[i, :len(pcm)] = pcm.astype(np.float32) / 32768.0
        lens[i] = len(pcm)
    return wavs, lens


def load_model(torch, ckpt, device):
    from tpu_speech_torch.configs.spiral import spiral_base_ctc_char
    from tpu_speech_torch.train.spiral_runner import build_model

    cfg = spiral_base_ctc_char()
    model = build_model(cfg, num_classes=28)
    model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    return cfg.model.encoder, model.to(device).eval()


def infer(torch, enc_cfg, model, wavs, lens):
    from tpu_speech_torch.models.spiral.st2vec import wav_to_spec

    with torch.inference_mode():
        return model(*wav_to_spec(enc_cfg, wavs, lens))


def phase_cpu_vs_card(torch, manifest, ckpt, card_logits):
    enc_cfg, model = load_model(torch, ckpt, "cpu")
    wavs, lens = load_batch(manifest, 2)
    lp, out_lens = infer(torch, enc_cfg, model, torch.tensor(wavs), torch.tensor(lens))
    worst, agree, total = 0.0, 0, 0
    for i in range(2):
        n = int(out_lens[i])
        cpu, card = lp[i, :n].numpy(), card_logits[i, :n]
        worst = max(worst, float(np.abs(cpu - card).max()))
        agree += int((cpu.argmax(-1) == card.argmax(-1)).sum())
        total += n
    share = agree / total
    log(f"[5 cpu vs card] 2 utts, {total} valid frames: max|card-cpu| "
        f"{worst:.3e} (limit {SLICE_ATOL}), argmax agreement {share:.4f}")
    check(worst <= SLICE_ATOL, f"card vs CPU log-probs differ by {worst}")
    check(share >= SLICE_ARGMAX_AGREE, f"argmax agreement {share}")


def phase_slice_time(torch, manifest, ckpt):
    enc_cfg, model = load_model(torch, ckpt, "cuda")
    wavs, lens = load_batch(manifest, BATCH)
    wavs, lens = torch.tensor(wavs, device="cuda"), torch.tensor(lens, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: infer(torch, enc_cfg, model, wavs, lens), n=10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[6 slice time] wav (14, 384000) on the card -> log-probs: {ms:.2f} ms "
        f"per batch (median of 10), peak device memory {peak:.2f} GiB")
    profile_slice(torch, lambda: infer(torch, enc_cfg, model, wavs, lens))


def profile_slice(torch, run, batches=3, top=8, tag="6 profile"):
    """Where the slice's device time goes: torch.profiler kernel events over a
    few batches, summed by kernel name, and the device's busy share of the
    span from the first kernel's start to the last kernel's end. Kernels
    that run at the same time (cuDNN's per-group launches) count once in the
    share and fully in the per-kernel sums. Annotations that the profiler
    reports on the device timeline (``Optimizer.step#AdamW.step``) are not
    kernels and are left out."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        log(f"[{tag}] the profiler saw no device kernels; not measured")
        return
    busy, (cur_s, cur_e) = 0, spans[0]
    by_name = defaultdict(lambda: [0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    log(f"[{tag}] {len(spans) // batches} kernels per run; device busy "
        f"{busy / batches / 1e3:.2f} ms of a {span / batches / 1e3:.2f} ms span per "
        f"run (share {busy / span:.3f})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (us, n) in ranked[:top]:
        log(f"    {us / batches / 1e3:8.3f} ms  x{n // batches:<3d} {name[:90]}")
    return {"ranked": [(name, us / batches / 1e3, n // batches) for name, (us, n) in ranked],
            "kernels": len(spans) // batches, "busy_ms": busy / batches / 1e3,
            "span_ms": span / batches / 1e3, "share": busy / span}


# ---- 37-39: SPIRAL runs as the JAX CLI runs them ----------------------------

RESUME_STEPS = 2  # pretrain updates an epoch in phase 37 (B = 24)
ARCHIVE_FT_STEPS = 2  # finetune updates in phase 39 (B = 14)


def drop_run_outputs(root):
    """Delete the weight files under ``root`` (step checkpoints, ``.pt``,
    ``.tpu_speech``): full-width runs write gigabytes each, and the later
    phases need only the corpora."""
    import shutil

    for dirpath, dirnames, filenames in os.walk(root, topdown=True):
        if "ckpt" in dirnames:
            shutil.rmtree(os.path.join(dirpath, "ckpt"))
            dirnames.remove("ckpt")
        for name in filenames:
            if name.endswith((".pt", ".tpu_speech")):
                os.remove(os.path.join(dirpath, name))


def _write_lines(path, lines):
    with open(path, "w") as f:
        f.writelines(lines)


def phase_pretrain_resume(torch, root):
    """37: pretraining through ``run_spiral.main`` with no --model_type and no
    --run_mode (the JAX CLI's defaults) at spiral_base_pretrain_ls960's width
    on phase 9's corpus: 2 epochs of RESUME_STEPS steps with validation after
    each; then the same run as 1 epoch and a second ``main`` call in the same
    directory that resumes. The straight and the resumed run end with the
    same student, teacher and AdamW moments, bit for bit; the checkpoint's
    size and write time.

    cuDNN's default weight-gradient algorithms (the feature encoder's convs,
    K4's dw) may sum in an order of their own from call to call, so two
    straight runs of the same step differ in rounding, and Adam turns that
    into +-lr on the leaves whose gradient is rounding noise (the key
    biases). The phase asks cuDNN for its deterministic algorithms, which
    makes the step deterministic on the card (the hand kernels use no
    atomics), and then requires the resumed run to equal the straight one
    bit for bit. The CLI itself leaves cuDNN's defaults: two more straight
    runs under them show how far apart two runs that never stopped end, and
    the step's time under each setting is printed beside it."""
    import shutil

    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner
    from tpu_speech_torch.utils.checkpoint import Checkpointer

    d = os.path.join(root, "p37")
    os.makedirs(d)
    with open(os.path.join(root, "librivox-train-clean-100.json")) as f:
        lines = f.readlines()
    n = RESUME_STEPS * PRETRAIN_BATCH
    _write_lines(os.path.join(d, "librivox-train-clean-100.json"), lines[:n])
    for other in ("librivox-train-clean-360.json", "librivox-train-other-500.json"):
        _write_lines(os.path.join(d, other), [])
    _write_lines(os.path.join(d, "librivox-dev-clean.json"), lines[n:n + PRETRAIN_BATCH])
    # one loader thread: the crops of utterances past 250 000 samples come
    # from one generator, in the order the threads reach it
    base = ["--config_name", "spiral_base_pretrain_ls960", "--manifest_dir", d,
            "--set", "trainer.val_check_interval_epochs=1",
            "--set", "model.optim.sched.warmup_steps=2",
            "--set", "model.train_ds.num_workers=1", "--set", "model.validation_ds.num_workers=1"]
    writes, saves, steps = [], [], []
    write, save, step = Checkpointer._write, Checkpointer.save, SpiralPretrainRunner.step

    def timed_write(self, at, state):
        t0 = time.perf_counter()
        write(self, at, state)
        writes.append((os.path.getsize(self._path(at)), time.perf_counter() - t0, t0,
                       time.perf_counter()))

    def timed_save(self, at, state):
        t0 = time.perf_counter()
        save(self, at, state)
        saves.append(time.perf_counter() - t0)

    def timed_step(self, batch):
        steps.append(time.perf_counter())
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(self, batch)
        ev[1].record()
        step_events.append(ev)
        return out

    step_events, spans = [], {}

    def straight_pair(mode, *names):
        """Runs of 2 epochs, each from its own directory; the step spans of
        each run after its first step (CUDA events around ``step``)."""
        out = []
        for name in names:
            step_events.clear()
            out.append(run_spiral.main(base + ["--model_save_dir", os.path.join(d, name),
                                               "--max_epochs", "2"]))
            torch.cuda.synchronize()
            spans.setdefault(mode, []).extend(a.elapsed_time(b) for a, b in step_events[1:])
        return out

    Checkpointer._write, Checkpointer.save = timed_write, timed_save
    SpiralPretrainRunner.step = timed_step
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        straight, = straight_pair("deterministic", "a")
        first = run_spiral.main(base + ["--model_save_dir", os.path.join(d, "b"),
                                        "--max_epochs", "1"])
        resumed = run_spiral.main(base + ["--model_save_dir", os.path.join(d, "b"),
                                          "--max_epochs", "2"])
        torch.backends.cudnn.deterministic = deterministic
        straight_pair("cuDNN's defaults", "c", "e")
    finally:
        Checkpointer._write, Checkpointer.save = write, save
        SpiralPretrainRunner.step = step
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"[37 pretrain resume] run_spiral.main with the JAX defaults (model_type spiral, "
        f"run_mode train): 2 epochs of {RESUME_STEPS} steps straight, then 1 epoch + a "
        f"resumed epoch (cuDNN's deterministic algorithms), then two straight runs under "
        f"cuDNN's defaults, B = {PRETRAIN_BATCH} x 250 000, in {wall:.1f} s; launches "
        f"{launches}")
    for key in ("fused_logmel", "fused_qkv_attention", "fused_qkv_attention_bwd",
                "grouped_conv1d", "grouped_conv1d_dx"):
        check(launches[key] > 0, f"phase 37 never launched {key}")
    check(first["epoch"] == 1 and resumed["epoch"] == straight["epoch"] == 2, "epochs")
    check(straight["iteration"] == resumed["iteration"] == 2 * RESUME_STEPS,
          f"iterations {straight['iteration']} / {resumed['iteration']}")
    cks = {k: Checkpointer(os.path.join(d, k, "ckpt")) for k in ("a", "b", "c", "e")}
    check(all(c.all_steps() == [RESUME_STEPS, 2 * RESUME_STEPS] for c in cks.values()),
          f"checkpoints {[c.all_steps() for c in cks.values()]}")

    def part_diffs(a, b):
        """The largest |difference| and the relative L2 difference of each part."""
        student = [k for k in a["model"] if not k.startswith("target_")]
        teacher = [k for k in a["model"] if k.startswith("target_")]
        out = {}
        for what, ref, other, keys in (("student", a["model"], b["model"], student),
                                       ("teacher", a["model"], b["model"], teacher),
                                       ("mu", a["mu"], b["mu"], list(a["mu"])),
                                       ("nu", a["nu"], b["nu"], list(a["nu"]))):
            dif = [(other[k].double() - ref[k].double()) for k in keys]
            out[what] = (max(x.abs().max().item() for x in dif),
                         math.sqrt(sum(x.square().sum().item() for x in dif))
                         / max(math.sqrt(sum(ref[k].double().square().sum().item()
                                             for k in keys)), 1e-30))
        return out

    a, b = (cks[k].restore(2 * RESUME_STEPS) for k in ("a", "b"))
    diffs = {k: v[0] for k, v in part_diffs(a, b).items()}
    default = part_diffs(*(cks[k].restore(2 * RESUME_STEPS) for k in ("c", "e")))
    log(f"    straight vs resumed at step {2 * RESUME_STEPS} (deterministic algorithms), max "
        f"|difference| of each part: {diffs}")
    log("    two straight runs under cuDNN's defaults at step "
        f"{2 * RESUME_STEPS}, max |difference| and relative L2 difference of each part: "
        + ", ".join(f"{k} {m:.3e} / {r:.3e}" for k, (m, r) in default.items()))
    log("    step span (CUDA events around the step, each run's first step left out): "
        + ", ".join(f"{k} {np.median(v):.2f} ms (median of {len(v)})"
                    for k, v in spans.items()))
    for k in ("c", "e"):  # 3 GiB of checkpoints each; later phases need only a and b
        shutil.rmtree(os.path.join(d, k))
    check(not any(diffs.values()), f"the resumed run is not the straight one: {diffs}")
    check(a["count"] == b["count"] == 2 * RESUME_STEPS and a["step"] == b["step"],
          "optimizer counts")
    check([m["loss"] for m in resumed["steps"]]
          == [m["loss"] for m in straight["steps"]][RESUME_STEPS:], "the resumed losses")
    for lines_of in ("a", "b"):
        with open(os.path.join(d, lines_of, "train.log")) as f:
            val = [ln for ln in f if ln.startswith("Validation")]
        nums = [float(x.split(" = ")[1]) for ln in val for x in ln.split(" | ")]
        check(len(val) == 2 and len(nums) == 10 and all(np.isfinite(nums)),
              f"train.log validation lines of run {lines_of}: {val}")
    size, sec, w0, w1 = writes[0]
    during = sum(1 for t in steps if w0 <= t <= w1)
    log(f"    checkpoint: {size} bytes ({size / 2**30:.3f} GiB: student, teacher, two AdamW "
        f"moments, statistics, generators); save() returned in {np.median(saves):.3f} s "
        f"(copy to host), the write took {np.median([w[1] for w in writes]):.3f} s on its "
        f"thread (median of {len(writes)}); steps started during the first write: {during}")
    log(f"    validation lines: {val[-1].strip()}")
    return launches, os.path.join(d, "a")


def phase_validation(torch, root, run_dir):
    """38: validation on the card. A validate pass at full width over phase
    37's validation manifest with phase 37's weights: per batch K1 twice,
    K2-fwd once per layer of both towers and K4 four times, no K2-bwd and no
    K4-dx; the pass's time; then one validation batch (B = 2 x 4 s) on the
    card against the CPU with the same weights, batch and negative indices:
    the loss within phase 10's limit."""
    from tpu_speech_torch.configs.spiral import spiral_base_pretrain_ls960
    from tpu_speech_torch.models.spiral.st2vec import ST2VecEncoder, draw_negative_indices
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import spiral as tspiral
    from tpu_speech_torch.train.spiral_runner import SpiralPretrainRunner

    d = os.path.join(root, "p37")
    cfg = spiral_base_pretrain_ls960()
    cfg.model.train_ds.manifest_filepath = os.path.join(d, "librivox-train-clean-100.json")
    cfg.model.validation_ds.manifest_filepath = os.path.join(d, "librivox-dev-clean.json")
    cfg.model.validation_ds.num_workers = 1
    runner = SpiralPretrainRunner(cfg, os.path.join(root, "p38"), device="cuda")
    runner.restore_from_checkpoint(os.path.join(run_dir, "st2vec.pt"))
    layers = 2 * sum(b.transformer.encoder_layers for b in cfg.model.encoder.blocks
                     if b.transformer is not None)
    seen, vstep = [], SpiralPretrainRunner.validation_step

    def watched(self, batch, neg_idx=None):
        before = dict(_build.LAUNCHES)
        out = vstep(self, batch, neg_idx)
        torch.cuda.synchronize()
        seen.append({k: v - before[k] for k, v in _build.LAUNCHES.items()})
        return out

    SpiralPretrainRunner.validation_step = watched
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        val = runner.validate()
    finally:
        SpiralPretrainRunner.validation_step = vstep
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(len(seen) == runner.last_validation["batches"] >= 1, f"{len(seen)} batches")
    for i, c in enumerate(seen):
        check(c["fused_logmel"] == 2 and c["fused_qkv_attention"] == layers
              and c["grouped_conv1d"] == 4, f"validation batch {i}: launches {c}")
        check(c["fused_qkv_attention_bwd"] == 0 and c["grouped_conv1d_dx"] == 0
              and not any(c[k] for k in c if k.endswith("_bf16")),
              f"validation batch {i} launched a backward or bf16 kernel: {c}")
    check(np.isfinite(val) and all(np.isfinite(v) for v in runner.last_validation.values()),
          f"validation {runner.last_validation}")
    on_card = tspiral.batch_to_device(runner._augment(next(iter(runner.val_loader))), "cuda")
    ms = cuda_ms(lambda: runner.validation_step(on_card), n=5, warmup=1)
    log(f"[38 validation] {len(seen)} batch(es) of B = {PRETRAIN_BATCH} x 250 000 in "
        f"{wall:.2f} s (loader, host masks, the forward pass, one read back); one batch "
        f"{ms:.2f} ms on the card (CUDA events, median of 5); launches per batch "
        f"{seen[0]}; {runner.last_validation}")

    enc = cfg.model.encoder
    n = 4 * SR
    spec_len = ((1 + n // 160 + 15) // 16) * 16
    r = np.random.default_rng(9)
    wavs = np.stack([speech_like(r, n) for _ in range(2)])
    lens = np.array([n, 3 * SR], np.int32)
    wavs[1, lens[1]:] = 0
    batch = tspiral.host_augment_batch(enc, wavs, lens, wavs * 0.8, lens, spec_len,
                                       np.random.default_rng(10), np.random.default_rng(11))
    feat_lens = torch.tensor(np.ceil(lens / 160).astype(np.int64))
    for _ in range(3):
        feat_lens = (feat_lens + 1) // 2
    neg = draw_negative_indices(feat_lens, spec_len // 8, enc.n_negatives,
                                torch.Generator().manual_seed(12))
    sd = torch.load(os.path.join(run_dir, "st2vec.pt"), weights_only=True)
    out = {}
    for dev in ("cpu", "cuda"):
        model = ST2VecEncoder(enc, pretraining=True)
        model.load_state_dict(sd)
        model.to(dev).train()
        loss, acc, diag = tspiral.validation_loss(model, tspiral.batch_to_device(batch, dev),
                                                  neg_idx=neg.to(dev))
        out[dev] = (float(loss), float(acc), {k: float(v) for k, v in diag.items()})
    (l_cpu, a_cpu, d_cpu), (l_card, a_card, d_card) = out["cpu"], out["cuda"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    diag_err = max(abs(d_card[k] - d_cpu[k]) for k in d_cpu)
    log(f"    one batch, B = 2 x 4 s, card vs CPU (same weights, batch, negatives): loss "
        f"{l_card:.6f} vs {l_cpu:.6f} (rel {rel:.2e}, limit {STEP_LOSS_RTOL}); accuracy "
        f"{a_card:.4f} vs {a_cpu:.4f}; collapse scalars max |diff| {diag_err:.2e}")
    check(rel <= STEP_LOSS_RTOL, f"validation loss card {l_card} vs cpu {l_cpu}")
    return launches


def phase_archives(torch, root, ft_root, pre_dir):
    """39: archives. CTC finetuning through ``run_spiral.main`` on phase 14's
    corpus from phase 37's pretraining archive writes
    ``ctc_finetune.tpu_speech``; ``--run_mode test`` with ``--init_archive``
    on it gives the same log-probs as ``--init_chkpt_file ctc_finetune.pt``
    and as a step checkpoint; ``--use_chkpt_hparams true`` with a pretrain
    config rebuilds the model from the archive alone, to the same
    log-probs."""
    import glob

    from tpu_speech_torch.cli import run_spiral
    from tpu_speech_torch.ops import _build

    d = os.path.join(root, "p39")
    argv = ["--model_type", "ctc_finetune", "--config_name", "spiral_base_finetune_ls100_char",
            "--manifest_dir", ft_root, "--init_chkpt_dir", pre_dir,
            "--init_chkpt_file", "st2vec.tpu_speech", "--model_save_dir", d,
            "--set", f"trainer.max_steps={ARCHIVE_FT_STEPS}",
            "--set", "model.freeze_finetune_updates=0",
            "--set", "model.optim.sched.warmup_ratio=0", "--set", f"model.optim.lr={FT_LR}",
            "--set", "model.train_ds.num_workers=1"]
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_spiral.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for key in ("fused_logmel", "fused_qkv_attention", "fused_qkv_attention_bwd",
                "grouped_conv1d", "grouped_conv1d_dx"):
        check(launches[key] > 0, f"phase 39 never launched {key}")
    check(os.path.basename(res["archive"]) == "ctc_finetune.tpu_speech", res["archive"])
    check(all(np.isfinite(m["loss"]) for m in res["steps"]), "finetune losses")
    dev = os.path.join(ft_root, "librivox-dev-other.json")
    runs = {"archive": ["--init_archive", res["archive"]],
            "state_dict": ["--init_chkpt_dir", d, "--init_chkpt_file", "ctc_finetune.pt"],
            "step": ["--init_chkpt_dir", os.path.join(d, "ckpt"), "--init_chkpt_file",
                     "step_*.pt"],
            "hparams": ["--config_name", "spiral_base_pretrain_ls960", "--use_chkpt_hparams",
                        "true", "--init_archive", res["archive"]]}
    logits, wer = {}, {}
    for name, extra in runs.items():
        out_dir = os.path.join(d, f"test_{name}")
        argv = ["--model_type", "ctc_finetune", "--run_mode", "test", "--config_name",
                "spiral_base_finetune_ls100_char", "--test_manifest", dev, "--save_logits",
                "true", "--model_save_dir", out_dir] + extra
        wer[name] = run_spiral.main(argv)["wer"]
        files = sorted(glob.glob(os.path.join(out_dir, "logits", "*.npy")))
        logits[name] = np.concatenate([np.load(f).reshape(-1) for f in files])
    ref = logits["archive"]
    diffs = {k: float(np.abs(v - ref).max()) if v.shape == ref.shape else float("inf")
             for k, v in logits.items()}
    log(f"[39 archives] finetuning from st2vec.tpu_speech, {len(res['steps'])} steps, "
        f"{wall:.1f} s; {os.path.getsize(res['archive'])} bytes in "
        f"{os.path.basename(res['archive'])}; test mode max |log-prob - archive's| {diffs}; "
        f"WER {wer}")
    check(all(v == 0.0 for v in diffs.values()), f"test-mode log-probs differ: {diffs}")
    check(len(set(wer.values())) == 1, f"WER differs: {wer}")
    return launches


# ---- 40-44: HiFi-GAN training, bf16 Grad-TTS training -----------------------

HG_SEED = 41
HG_UTTS = 48  # 2 s each: three V1 batches of 16 an epoch
HG_VAL_UTTS = 8
HG_POINT = (16, 8192)  # the V1 recipe's batch: B x segment_size
HG_GRAD_RL2 = 1e-3  # the GAN step's gradients, card against CPU, relative L2 per leaf
# cli/train_hifigan.py's defaults (build_generator:35, mel_cfg_from:49) and
# the V1 recipe's training keys (:81-82, 112-118), written out as a config
HG_CONFIG = dict(HIFIGAN_V1, n_fft=1024, num_mels=80, sampling_rate=22050, hop_size=256,
                 win_size=1024, fmin=0.0, fmax=8000.0, segment_size=8192, batch_size=16,
                 learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, seed=1234)


def write_hifigan_corpus(root, rng):
    """HG_UTTS + HG_VAL_UTTS speech-like 22 050 Hz wavs of 2 s, the
    filelists (ids, and text after '|' in the training one) and the V1
    config. Returns (wav dir, train list, validation list, config)."""
    from tpu_speech_torch.data.wav import write_wav

    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs)
    names = []
    for i in range(HG_UTTS + HG_VAL_UTTS):
        names.append(f"hg{i:02d}")
        write_wav(os.path.join(wavs, names[-1] + ".wav"),
                  speech_like(rng, 2 * 22050, sr=22050), 22050)
    train, val, config = (os.path.join(root, n) for n in ("train.txt", "val.txt",
                                                           "config.json"))
    _write_lines(train, [f"{n}|a line of text\n" for n in names[:HG_UTTS]])
    _write_lines(val, [f"{n}\n" for n in names[HG_UTTS:]])
    with open(config, "w") as f:
        json.dump(HG_CONFIG, f)
    return wavs, train, val, config


def _watch_gan_steps(torch, seen):
    """Wrap train/hifigan.py's gan_train_step (the trainer looks it up at
    each step) to record each step's launches and metrics; returns the
    original."""
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import hifigan as th

    step = th.gan_train_step

    def watched(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        m = step(*args, **kwargs)
        torch.cuda.synchronize()
        seen.append(({k: v - before[k] for k, v in _build.LAUNCHES.items()},
                     {k: float(v) for k, v in m.items()}))
        return m

    th.gan_train_step = watched
    return step


def _hg_cli(corpus, log_dir, epochs, *extra):
    from tpu_speech_torch.cli import train_hifigan

    wavs, train, val, config = corpus
    t0 = time.perf_counter()
    res = train_hifigan.main(["--config", config, "--input_wavs_dir", wavs,
                              "--input_training_file", train, "--input_validation_file", val,
                              "--log_dir", log_dir, "--training_epochs", str(epochs),
                              "--validation_interval", "1", *extra])
    return res, time.perf_counter() - t0


def phase_hifigan_train_slice(torch, rng, root):
    """40: HiFi-GAN V1 training through tpu_speech_torch.cli.train_hifigan
    .main on the card: 2 epochs of 3 steps (B = 16 x 8192) with validation,
    then --resume_if_exists to a 3rd epoch, then --fine_tuning on host mels
    stored (80, T) for a 4th; per step no hand kernel, the seven metrics
    finite; the generator and both discriminators moved; train.log has a
    line per epoch; the final generator.pt vocodes through
    cli.inference.main."""
    import scipy.io.wavfile

    from tpu_speech_torch.audio.mel import mel_spectrogram_np
    from tpu_speech_torch.cli import inference, train_hifigan
    from tpu_speech_torch.data.wav import read_wav
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import hifigan as th

    corpus = write_hifigan_corpus(root, rng)
    mels = os.path.join(root, "mels")
    os.makedirs(mels)
    for name in sorted(os.listdir(corpus[0])):
        wav, _ = read_wav(os.path.join(corpus[0], name))
        np.save(os.path.join(mels, name[:-4] + ".npy"), mel_spectrogram_np(wav).T)
    log_dir = os.path.join(root, "hifigan_logs")
    seen, runs = [], []
    step = _watch_gan_steps(torch, seen)
    _build.reset_launches()
    try:
        for epochs, extra in ((2, ()), (3, ("--resume_if_exists",)),
                              (4, ("--resume_if_exists", "--fine_tuning", "--input_mels_dir",
                                   mels))):
            res, wall = _hg_cli(corpus, log_dir, epochs, *extra)
            runs.append((res, wall, len(seen)))
    finally:
        th.gan_train_step = step
    launches = dict(_build.LAUNCHES)
    (r1, w1, n1), (r2, w2, n2), (r3, w3, n3) = runs
    log(f"[40 hifigan train slice] parameters {r1['n_params']}; {HG_UTTS} wavs of 2 s, "
        f"B = 16 x 8192; run 1 (2 epochs) {n1} steps in {w1:.1f} s, run 2 resumed at epoch "
        f"{r2['first_epoch']}: {n2 - n1} steps in {w2:.1f} s, run 3 (--fine_tuning) at "
        f"epoch {r3['first_epoch']}: {n3 - n2} steps in {w3:.1f} s; hand-kernel launches "
        f"{ {k: v for k, v in launches.items() if v} or 0}")
    for i, (d, m) in enumerate(seen):
        log("    step %d: %s" % (i, ", ".join(f"{k} {v:.4f}" for k, v in m.items())))
        check(not any(d.values()), f"step {i} launches {d}")
        check(all(np.isfinite(v) for v in m.values()), f"step {i} metrics {m}")
    check((n1, n2 - n1, n3 - n2) == (6, 3, 3), f"steps per run {n1}, {n2 - n1}, {n3 - n2}")
    check((r2["first_epoch"], r3["first_epoch"], r3["iteration"]) == (2, 3, 12),
          f"resume: epochs {r2['first_epoch']}, {r3['first_epoch']}, {r3['iteration']} steps")
    vals = [e["val_mel_error"] for r in (r1, r2, r3) for e in r["epochs"]]
    log(f"    validation mel error per epoch: {[round(v, 4) for v in vals]}")
    check(len(vals) == 4 and all(np.isfinite(vals)), f"validation {vals}")
    with open(os.path.join(log_dir, "train.log")) as f:
        log_lines = f.read().splitlines()
    log(f"    train.log: {log_lines}")
    check(len(log_lines) == 4, f"train.log has {len(log_lines)} lines for 4 epochs")
    gen0, mpd0, msd0 = train_hifigan.build_models(HG_CONFIG)
    g0 = gen0.state_dict()
    d0 = torch.nn.ModuleDict({"mpd": mpd0, "msd": msd0}).state_dict()
    ckpt = torch.load(os.path.join(log_dir, "ckpt", "step_0000000012.pt"), weights_only=True)
    g = torch.load(r3["generator"], weights_only=True)["generator"]
    moved = {"generator": _max_diff(list(g.values()), [g0[k] for k in g]),
             "mpd": _max_diff([ckpt["disc"][k] for k in d0 if k.startswith("mpd.")],
                              [d0[k] for k in d0 if k.startswith("mpd.")]),
             "msd": _max_diff([ckpt["disc"][k] for k in d0 if k.startswith("msd.")],
                              [d0[k] for k in d0 if k.startswith("msd.")])}
    log(f"    moved (max |w - w0| after 12 steps): {moved}; checkpoints "
        f"{sorted(os.listdir(os.path.join(log_dir, 'ckpt')))}, "
        f"{os.path.getsize(os.path.join(log_dir, 'ckpt', 'step_0000000012.pt')) / 2**30:.3f} "
        f"GiB each")
    check(all(v > 0 for v in moved.values()), f"a network did not move: {moved}")
    check(all(torch.equal(g[k], ckpt["gen"][k]) for k in g), "generator.pt is not the last step's")
    del ckpt
    shutil.rmtree(os.path.join(log_dir, "ckpt"))  # 1 GiB a checkpoint

    gt_pt = os.path.join(root, "grad-tts.pt")
    torch.save(_gradtts_full_width(torch, HG_SEED).state_dict(), gt_pt)
    texts = os.path.join(root, "texts.txt")
    _write_lines(texts, [TTS_TEXT + "\n"])
    out = inference.main(["-f", texts, "-c", gt_pt, "--hifigan", r3["generator"],
                          "--hifigan-config", corpus[3], "--cmudict", "", "--out-dir",
                          os.path.join(root, "hifigan_out")])
    (smp,) = out["samples"]
    _, pcm = scipy.io.wavfile.read(smp["path"])
    log(f"    the trained generator.pt through cli.inference.main: {smp['frames']} frames, "
        f"{len(pcm)} int16 samples, peak |pcm| {int(np.abs(pcm.astype(np.int32)).max())}")
    check(len(pcm) == smp["frames"] * 256 and out["n_vocoder_params"] == r1["n_params"][
        "generator"], f"vocoder output {smp}, {out['n_vocoder_params']} parameters")
    return launches, corpus


def _hg_models(torch, seed):
    """HiFi-GAN V1 and the reference discriminators with the CLI's init
    from ``seed``, on the CPU."""
    from tpu_speech_torch.cli import train_hifigan

    return train_hifigan.build_models(dict(HG_CONFIG, seed=seed))


def _hg_batch(rng, b, n):
    return {"wav": np.stack([0.95 * w / np.abs(w).max()
                             for w in (speech_like(rng, n, sr=22050) for _ in range(b))])}


def _gan_step_on(torch, models, batch, device, bf16=False, debug=False, frozen_disc=False):
    """One gan_train_step of copies of ``models`` on ``device``: (metrics,
    {name: gradient} of the generator and of the discriminators, the models
    after the step). ``frozen_disc``: the discriminators' AdamW at lr 0, so
    that the generator's half of the step meets the discriminators as
    given."""
    import copy

    from tpu_speech_torch.train import hifigan as th
    from tpu_speech_torch.train.optim import AdamW
    from tpu_speech_torch.train.trainer import batch_to_device

    gen, mpd, msd = (copy.deepcopy(m).to(device) for m in models)
    disc = torch.nn.ModuleDict({"mpd": mpd, "msd": msd})
    opt_g, opt_d = th.make_optimizers(gen, disc)
    if frozen_disc:
        opt_d = AdamW(disc.parameters(), 0.0)
    b = batch_to_device(batch, device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if debug else 0)
    try:
        m = th.gan_train_step(gen, mpd, msd, opt_g, opt_d, b, bf16=bf16)
    finally:
        if device == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    grads = {f"gen.{n}": p.grad.cpu() for n, p in gen.named_parameters()}
    grads.update({f"disc.{n}": p.grad.cpu() for n, p in disc.named_parameters()})
    return {k: float(v) for k, v in m.items()}, grads, (gen, disc)


def phase_hifigan_cpu_vs_card(torch):
    """41: one V1 GAN step on the card against the CPU (B = 2 x 8192, the
    same weights and batch, AdamW as the recipe's). The discriminators'
    half against the CPU's step, the generator's half against a CPU step
    that meets the card's updated discriminators (theirs at lr 0): AdamW's
    first update is about lr sign(g), so where a discriminator's gradient
    is rounding noise the two sides' own updates differ by 2 lr, and the
    generator's gradients with them. The seven metrics within 1e-4
    relative; each gradient leaf (max|g| at least 1 % of the largest)
    within HG_GRAD_RL2 relative L2 (phase 28's elementwise bound, 1e-3 x
    max|g|, is printed: the L1 mel loss and the leaky ReLUs can flip single
    elements' signs); both networks' parameters within 1e-5 x max(1, |p|)
    of the CPU's AdamW on the card's gradients; the card's step (after a
    warm one on other copies) under set_sync_debug_mode('error')."""
    import copy

    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import hifigan as th

    models = _hg_models(torch, HG_SEED)
    batch = _hg_batch(np.random.default_rng(HG_SEED), 2, HG_POINT[1])
    _gan_step_on(torch, models, batch, "cuda")  # warm: cuDNN's plans, the mel constants
    _build.reset_launches()
    m_card, g_card, (gen, disc) = _gan_step_on(torch, models, batch, "cuda", debug=True)
    check(not any(_build.LAUNCHES.values()), f"card step launches {_build.LAUNCHES}")
    m_cpu, g_cpu, _ = _gan_step_on(torch, models, batch, "cpu")
    met_g, g_gen, _ = _gan_step_on(torch, (models[0], copy.deepcopy(disc["mpd"]).cpu(),
                                           copy.deepcopy(disc["msd"]).cpu()), batch, "cpu",
                                   frozen_disc=True)
    for k in ("loss_gen", "mel_error", "loss_fm", "loss_adv"):
        m_cpu[k] = met_g[k]
    g_cpu.update({k: g for k, g in g_gen.items() if k.startswith("gen.")})
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu}
    g_max = max(g.abs().max().item() for g in g_cpu.values())
    worst_g = max(((g_card[k] - g).abs().max().item()
                   / max(GRAD_RTOL * g.abs().max().item(), GT_GRAD_FLOOR * g_max), k)
                  for k, g in g_cpu.items())
    worst_l2 = max(((g_card[k] - g).norm().item() / g.norm().item(), k)
                   for k, g in g_cpu.items() if g.abs().max().item() >= 1e-2 * g_max)
    # the card's parameters against the CPU's AdamW on the card's gradients
    ref = {"gen": copy.deepcopy(models[0]),
           "disc": torch.nn.ModuleDict({"mpd": copy.deepcopy(models[1]),
                                        "msd": copy.deepcopy(models[2])})}
    for part, model in ref.items():
        for n, p in model.named_parameters():
            p.grad = g_card[f"{part}.{n}"]
    for opt in th.make_optimizers(ref["gen"], ref["disc"]):
        opt.step()
    worst_p = (0.0, "")
    for part, card in (("gen", gen), ("disc", disc)):
        want = dict(ref[part].named_parameters())
        for n, p in card.named_parameters():
            w = want[n].detach()
            worst_p = max(worst_p, (((p.detach().cpu() - w).abs() / w.abs().clamp(min=1.0))
                                    .max().item(), f"{part}.{n}"))
    log(f"[41 hifigan card vs cpu] V1, B = 2 x {HG_POINT[1]}: metrics card "
        f"{ {k: round(v, 5) for k, v in m_card.items()} } (worst rel {max(rel.values()):.2e}, "
        f"limit {STEP_LOSS_RTOL}); gradients: worst relative L2 {worst_l2[0]:.2e} "
        f"({worst_l2[1]}; limit {HG_GRAD_RL2}, leaves above 1 % of the largest), worst "
        f"max |diff| at {worst_g[0]:.3f} x phase 28's bound ({worst_g[1]}) over "
        f"{len(g_cpu)} tensors; parameters after AdamW {worst_p[0]:.2e} x max(1, |p|) from "
        f"the CPU's AdamW on the card's gradients ({worst_p[1]}; limit {GT_PARAM_RTOL}); "
        f"the card's step under set_sync_debug_mode('error')")
    check(max(rel.values()) <= STEP_LOSS_RTOL, f"metrics {rel}")
    check(worst_l2[0] <= HG_GRAD_RL2, f"gradient {worst_l2}")
    check(worst_p[0] <= GT_PARAM_RTOL, f"parameters after AdamW {worst_p}")


def phase_bf16_tts_train(torch, rng, root, corpus):
    """42: bf16 training of both TTS networks. HiFi-GAN: cli.train_hifigan
    .main --bf16 on phase 40's corpus for 2 epochs (6 steps), float32
    weights saved. Grad-TTS: cli.train.main with precision = "bf16" at the
    LJSpeech width, B = 16, on a synthetic corpus for 2 epochs of 2 steps,
    MAS once a step. Then one bf16 step of each held to its fp32 step on
    the same weights and batch (_hold_bf16_step: the loss within 2e-2,
    gradient leaves within 0.1 relative L2 or the rule's bound): the GAN
    step at B = 16 x 8192, the Grad-TTS step at bench.py's point with the
    fp32 step's draws and MAS path given to both (t and z rounded to
    bf16)."""
    from tpu_speech_torch.cli import train
    from tpu_speech_torch.configs import gradtts as cfg
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import gradtts as tg
    from tpu_speech_torch.train import hifigan as th

    seen = []
    step = _watch_gan_steps(torch, seen)
    _build.reset_launches()
    try:
        res, wall = _hg_cli(corpus, os.path.join(root, "hifigan_bf16"), 2, "--bf16")
    finally:
        th.gan_train_step = step
    hg_launches = dict(_build.LAUNCHES)
    g = torch.load(res["generator"], weights_only=True)["generator"]
    log(f"[42 bf16 hifigan cli] {len(seen)} steps in {wall:.1f} s; validation "
        f"{[round(e['val_mel_error'], 4) for e in res['epochs']]}")
    for i, (d, m) in enumerate(seen):
        log("    step %d: %s" % (i, ", ".join(f"{k} {v:.4f}" for k, v in m.items())))
        check(not any(d.values()) and all(np.isfinite(v) for v in m.values()),
              f"bf16 step {i}: {d}, {m}")
    check(len(seen) == 6 and all(v.dtype == torch.float32 for v in g.values()),
          f"bf16 hifigan: {len(seen)} steps, dtypes {({v.dtype for v in g.values()})}")

    filelist, _ = write_tts_corpus(root, rng, GT_UTTS)
    keys = ("train_filelist_path", "test_filelist_path", "log_dir", "n_epochs", "batch_size",
            "cmudict_path", "precision")
    saved = {k: getattr(cfg, k) for k in keys}
    gseen = []
    gstep = _watch_gradtts_steps(torch, gseen)
    _build.reset_launches()
    try:
        for k, v in dict(train_filelist_path=filelist,
                         test_filelist_path=os.path.join(root, "absent.txt"),
                         log_dir=os.path.join(root, "gradtts_bf16"), n_epochs=2, batch_size=16,
                         cmudict_path="", precision="bf16").items():
            setattr(cfg, k, v)
        t0 = time.perf_counter()
        gres = train.main([])
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t0
    finally:
        tg.train_step = gstep
        for k, v in saved.items():
            setattr(cfg, k, v)
    gt_launches = dict(_build.LAUNCHES)
    log(f"[42 bf16 gradtts cli] precision bf16, B = 16: {len(gseen)} steps in {gwall:.1f} s")
    for i, (d, m) in enumerate(gseen):
        log(f"    step {i}: loss {m['loss']:.4f} (dur {m['dur_loss']:.4f}, prior "
            f"{m['prior_loss']:.4f}, diff {m['diff_loss']:.4f}), grad norms enc "
            f"{m['enc_grad_norm']:.3f} dec {m['dec_grad_norm']:.3f}")
        check(d == dict(dict.fromkeys(d, 0), maximum_path=1), f"bf16 step {i} launches {d}")
        check(all(np.isfinite(v) for v in m.values()), f"bf16 step {i} metrics {m}")
    sd = torch.load(gres["state_dict"], weights_only=True)
    check(len(gseen) == 4 and all(v.dtype == torch.float32 for v in sd.values()),
          f"bf16 gradtts: {len(gseen)} steps")

    models = _hg_models(torch, HG_SEED + 1)
    batch = _hg_batch(np.random.default_rng(HG_SEED + 1), *HG_POINT)

    def gan_run(bf16):
        m, grads, _ = _gan_step_on(torch, models, batch, "cuda", bf16=bf16)
        return m["loss_gen"], grads

    _hold_bf16_step("42 hifigan bf16 vs fp32 (no hand kernel: the yardstick is the same "
                    "step)", gan_run)
    _hold_bf16_step("42 gradtts bf16 vs fp32 (yardstick: MAS's plain loop)",
                    _gradtts_bf16_run(torch))
    return hg_launches, gt_launches


def _gradtts_bench_batch(torch):
    """bench.py's train-step point (bench.py:285-321): B = 16, Tx 72, Ty 512,
    on the card."""
    from tpu_speech_torch.text import symbols
    from tpu_speech_torch.train.gradtts import batch_to_device

    b, t_x, t_y = MAS_BENCH
    r = np.random.default_rng(0)
    return batch_to_device({
        "x": r.integers(1, len(symbols), size=(b, t_x)).astype(np.int32),
        "x_lengths": np.full((b,), t_x, np.int32),
        "y": r.standard_normal((b, t_y, 80)).astype(np.float32),
        "y_lengths": np.full((b,), t_y, np.int32)}, "cuda")


def _gradtts_bf16_run(torch):
    """run(bf16) for _hold_bf16_step: one Grad-TTS step at bench.py's point
    from one set of weights (dropout off), SGD with lr 1 so that the
    gradients stay on .grad, the fp32 draws (in bf16 for the bf16 step) and
    the fp32 step's MAS path given to both: (loss, {name: gradient})."""
    import copy

    from tpu_speech_torch.ops.masks import sequence_mask
    from tpu_speech_torch.train.gradtts import train_step

    model = _gradtts_full_width(torch, GT_SEED + 1).eval().cuda()
    batch = _gradtts_bench_batch(torch)
    b, _, t_y = MAS_BENCH
    g = torch.Generator("cuda").manual_seed(GT_SEED)
    draws = dict(offsets=torch.randint(0, t_y - 172, (b,), generator=g, device="cuda"),
                 t=torch.clamp(torch.rand(b, generator=g, device="cuda"), 1e-5, 1 - 1e-5),
                 z=torch.randn(b, 172, 80, generator=g, device="cuda"))
    with torch.no_grad():
        mu_x, _, x_mask = model.encode(batch["x"], batch["x_lengths"])
        y_mask = sequence_mask(batch["y_lengths"], t_y).float()
        attn = model.alignment(mu_x, batch["y"], x_mask[:, :, None] * y_mask[:, None, :])

    def run(bf16):
        m = copy.deepcopy(model)
        dt = torch.bfloat16 if bf16 else torch.float32
        out = train_step(m, torch.optim.SGD(m.parameters(), lr=1.0), batch, None, 172,
                         offsets=draws["offsets"], t=draws["t"].to(dt), z=draws["z"].to(dt),
                         attn=attn.to(dt), bf16=bf16)
        return out["loss"].item(), {n: p.grad.cpu() for n, p in m.named_parameters()}

    return run


def _gan_flop(torch, models, b, n):
    """(flop of one GAN step as it runs: torch.utils.flop_counter over
    gan_train_step, forward and backward; the generator's forward F_G and
    the discriminators' forward F_D on one wav batch) at B = b x n."""
    from torch.utils.flop_counter import FlopCounterMode

    gen, mpd, msd = (m.cuda() for m in models)
    wav = torch.zeros(b, n, device="cuda")
    mel = torch.zeros(b, 80, n // 256, device="cuda")
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            gen(mel)
        f_g = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            mpd(wav)
            msd(wav)
        f_d = fc.get_total_flops()
    return f_g, f_d


def phase_hifigan_time(torch):
    """43: the GAN step at the recipe's point, B = 16 x 8192, fp32 with TF32
    off and bf16: CUDA events (median of 10 after warm-up), peak memory,
    kernels per step, the busy share (profile of 3 steps) and the FLOP
    bound at the CUDA cores' fp32 rate or the bf16 tensor-core rate. The
    operations: the generator's forward F_G and the discriminators' F_D on
    one wav batch, counted by torch.utils.flop_counter, and the step runs
    4 F_G (a forward without a graph, one with its two backwards) and 9 F_D
    (forward and both backwards on the real and the generated wav for their
    update, then forward on both and the input gradient on the generated
    one), less the first layers' input gradients. The counter's count of
    the whole step is printed beside it: it counts a grouped conv's weight
    gradient once per group."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.train import hifigan as th
    from tpu_speech_torch.train.trainer import batch_to_device

    b, n = HG_POINT
    models = _hg_models(torch, HG_SEED + 2)
    f_g, f_d = _gan_flop(torch, models, b, n)
    gen, mpd, msd = (m.cuda() for m in models)
    disc = torch.nn.ModuleDict({"mpd": mpd, "msd": msd})
    opt_g, opt_d = th.make_optimizers(gen, disc, steps_per_epoch=3)
    batch = batch_to_device(_hg_batch(np.random.default_rng(HG_SEED + 2), b, n), "cuda")
    out = {}
    for bf16 in (False, True):
        def step():
            return th.gan_train_step(gen, mpd, msd, opt_g, opt_d, batch, bf16=bf16)

        tag = "bf16" if bf16 else "fp32"
        ms, peak = _timed_step(torch, step)
        _build.reset_launches()
        with FlopCounterMode(display=False) as fc:
            m = step()
        torch.cuda.synchronize()
        check(not any(_build.LAUNCHES.values()), f"{tag} GAN step launches {_build.LAUNCHES}")
        check(all(torch.isfinite(v) for v in m.values()), f"{tag} GAN step metrics {m}")
        flop = 4 * f_g + 9 * f_d
        bound = flop / (PEAK_BF16 if bf16 else PEAK_FP32) * 1e3
        log(f"[43 hifigan step time] V1, B = {b} x {n}, {tag}: {ms:.2f} ms per step (median "
            f"of 10), peak {peak:.3f} GiB; 4 F_G + 9 F_D = {flop / 1e12:.3f} TFLOP (F_G "
            f"{f_g / 1e12:.4f}, F_D {f_d / 1e12:.4f}; the counter over the step: "
            f"{fc.get_total_flops() / 1e12:.3f}), bound {bound:.2f} ms at "
            f"{(PEAK_BF16 if bf16 else PEAK_FP32) / 1e12:.0f} TFLOP/s ({ms / bound:.1f}x)")
        prof = profile_slice(torch, step, batches=3, top=10, tag=f"43 profile, {tag} GAN step")
        out[tag] = {"ms": ms, "peak_gib": peak, "tflop": flop / 1e12, "bound_ms": bound,
                    "profile": None if prof is None else {
                        k: prof[k] for k in ("kernels", "busy_ms", "span_ms", "share")}}
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU only",
              file=sys.stderr)
        return 2
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.utils.device import use_full_fp32

    use_full_fp32()
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    phase_build(_build)
    k1 = phase_k1(torch, rng)
    log(f"    K1 {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms")
    k2 = phase_k2(torch, gen)
    with tempfile.TemporaryDirectory() as root:
        manifest, ckpt, card_logits, launches = phase_slice(torch, rng, root)
        phase_cpu_vs_card(torch, manifest, ckpt, card_logits)
        phase_slice_time(torch, manifest, ckpt)
    drop_err, k2_drop_t = phase_k2_dropout(torch, gen)
    bwd_err, k2_bwd_t = phase_k2_bwd(torch, gen)
    k4_err, k4_dx_err, k4_t = phase_k4(torch, gen)
    k3_err, k3_t, k3_launches = phase_k3(torch, gen)
    spiral_tmp = tempfile.TemporaryDirectory()  # phase 9's and 14's corpora, for 37-39
    root = spiral_tmp.name
    pre_launches, st2vec_pt = phase_pretrain_slice(torch, rng, root)
    phase_pretrain_cpu_vs_card(torch)
    phase_pretrain_time(torch, root)
    ft_root = os.path.join(root, "ft")
    os.makedirs(ft_root)
    ft_launches = phase_finetune_slice(torch, rng, ft_root, st2vec_pt)
    phase_finetune_cpu_vs_card(torch)
    phase_finetune_time(torch, ft_root)
    k16 = phase_bf16_kernels(torch, gen)
    pre16_launches = phase_bf16_pretrain_slice(torch, root)
    phase_bf16_pretrain_time(torch, root)
    phase_bf16_vs_fp32_pretrain(torch, root)
    ft16_launches = phase_bf16_finetune_slice(torch, ft_root, st2vec_pt)
    phase_bf16_finetune_time(torch, ft_root)
    phase_bf16_vs_fp32_finetune(torch)
    phase_accum(torch, root, ft_root)
    phase_finetune_accum_equiv(torch)
    drop_run_outputs(root)
    tts_root = os.path.join(root, "tts")
    os.makedirs(tts_root)
    tts_launches = phase_tts_slice(torch, tts_root)
    phase_tts_cpu_vs_card(torch)
    phase_tts_time(torch)
    k_mas = phase_mas(torch, gen)
    with tempfile.TemporaryDirectory() as root:
        gt_launches = phase_gradtts_train_slice(torch, rng, root)
    phase_gradtts_cpu_vs_card(torch)
    phase_gradtts_train_time(torch)
    with tempfile.TemporaryDirectory() as root:
        vc_launches, vc_cli = phase_vc_slice(torch, rng, root)
    phase_vc_cpu_vs_card(torch)
    phase_vc_time(torch, vc_cli)
    tr_rng = np.random.default_rng(TR_SEED)
    with tempfile.TemporaryDirectory() as root:
        ge2e_launches, spk_pt, tr_wavs, clean = phase_spk_train(torch, tr_rng, root)
        tr_launches = phase_vc_train_slice(torch, tr_rng, root, tr_wavs, spk_pt)
        phase_train_cpu_vs_card(torch)
        phase_train_time(torch, clean)
    tr_launches["ge2e_train"] = ge2e_launches
    root = spiral_tmp.name
    resume_launches, pre_dir = phase_pretrain_resume(torch, root)
    val_launches = phase_validation(torch, root, pre_dir)
    arch_launches = phase_archives(torch, root, os.path.join(root, "ft"), pre_dir)
    spiral_tmp.cleanup()
    with tempfile.TemporaryDirectory() as root:
        hg_launches, hg_corpus = phase_hifigan_train_slice(
            torch, np.random.default_rng(HG_SEED), root)
        phase_hifigan_cpu_vs_card(torch)
        hg16_launches, gt16_launches = phase_bf16_tts_train(
            torch, np.random.default_rng(HG_SEED + 3), root, hg_corpus)
    phase_hifigan_time(torch)
    phase_gradtts_train_time(torch, bf16=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    def by_path(key):
        return {"ctc_transcription": launches[key], "pretrain_step": pre_launches[key],
                "finetune_step": ft_launches[key], "pretrain_step_bf16": pre16_launches[key],
                "finetune_step_bf16": ft16_launches[key], "tts_e2e": tts_launches[key],
                "gradtts_train_step": gt_launches[key], "diffvc_conversion": vc_launches[key],
                **{path: counts[key] for path, counts in tr_launches.items()},
                "pretrain_cli_resume": resume_launches[key],
                "pretrain_validation": val_launches[key],
                "finetune_cli_archive": arch_launches[key],
                "hifigan_train_step": hg_launches[key] + hg16_launches[key],
                "gradtts_train_step_bf16": gt16_launches[key]}

    def path_kernel(name, key, replaces, **measured):
        return dict(name=name, route="cuda", source=f"tpu_speech_torch/csrc/{measured.pop('src')}",
                    replaces=replaces, launches=sum(by_path(key).values()),
                    launches_by_path=by_path(key), **measured)

    def k3_kernel(name, key, replaces, src="fused_attention.cu", **measured):
        # no path reaches K3: its launches are those of its own checks (phase
        # 13, and phase 17 for bf16)
        own = (k16["k3_launches"] if key.endswith("_bf16") else k3_launches)[key]
        phase = "k3_phase_17" if key.endswith("_bf16") else "k3_phase_13"
        return dict(name=name, route="cuda", source=f"tpu_speech_torch/csrc/{src}",
                    replaces=replaces, launches=own,
                    launches_by_path=dict(by_path(key), **{phase: own}), **measured)

    def bf16_kernel(name, key, replaces, src, err, timed, shape):
        r = k16[timed]
        measured = dict(max_abs_err=k16[err], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound"][0], bound_by=r["bound"][1],
                        library_ms=r["library_ms"],
                        shape=shape + "; error relative to max(1, max|plain|)",
                        **{k: r[k] for k in ("back_to_back_ms", "library_back_to_back_ms",
                                             "tflops", "scratch_bytes", "host_us",
                                             "c_entry_host_us") if k in r})
        if key.startswith("grouped_conv1d"):  # phase 17's six shapes
            part = "fwd" if key == "grouped_conv1d_bf16" else "dx"
            measured["by_shape"] = [
                dict(shape=sh["shape"], cg=sh["cg"], bound_ms=sh[part]["bound"][0],
                     **{k: sh[part][k] for k in ("ms", "back_to_back_ms", "plain_ms", "library_ms",
                                                 "library_back_to_back_ms", "tflops")})
                for sh in k16["k4_shapes"]]
        if key.startswith("fused_attention"):
            return k3_kernel(name, key, replaces, src=src, **measured)
        return path_kernel(name, key, replaces, src=src, **measured)

    k2 = dict(k2, max_abs_err=max(k2["max_abs_err"], drop_err), **k2_drop_t,
              shape=f"dropout 0.1 at (24, 392, 1536) H=8 (no grad); dropout 0 at "
                    f"(14, 604, 1536) H=8: {k2['ms']:.4f} ms vs plain {k2['plain_ms']:.4f} ms; "
                    + k2["shape"].split("; ")[-1])
    k4_b1, k4_b2 = k4_t[K4_SHAPES[0]], k4_t[K4_SHAPES[1]]
    k3_b1, k3_b2 = k3_t[K3_SHAPES[0]], k3_t[K3_SHAPES[1]]
    kernels = [
        path_kernel("fused_logmel", "fused_logmel", "tpu_speech/ops/fused_logmel.py:203",
                    src="fused_logmel.cu", **k1),
        path_kernel("fused_qkv_self_attention", "fused_qkv_attention",
                    "tpu_speech/ops/fused_attention.py:384", src="fused_attention.cu", **k2),
        path_kernel("fused_qkv_self_attention_bwd", "fused_qkv_attention_bwd",
                    "tpu_speech/ops/fused_attention.py:401", src="fused_attention.cu",
                    max_abs_err=bwd_err, ms=k2_bwd_t["ms"], plain_ms=k2_bwd_t["plain_ms"],
                    bound_ms=k2_bwd_t["bound_ms"], bound_by=k2_bwd_t["bound_by"],
                    library_ms=k2_bwd_t["library_ms"],
                    shape=f"dqkv (24, 392, 1536) H=8 p=0.1, backward alone; forward + "
                          f"backward {k2_bwd_t['fb_ms']:.4f} ms vs plain "
                          f"{k2_bwd_t['fb_plain_ms']:.4f} ms"),
        k3_kernel("fused_self_attention", "fused_attention",
                  "tpu_speech/ops/fused_attention.py:222", max_abs_err=k3_err["fwd"],
                  ms=k3_b1["ms"], plain_ms=k3_b1["plain_ms"], bound_ms=k3_b1["bound"][0],
                  bound_by=k3_b1["bound"][1], library_ms=k3_b1["library_ms"],
                  shape=f"q, k, v (14, 604, 8, 64) p=0.1 (no grad); K2 on the same data "
                        f"{k3_b1['k2_ms']:.4f} ms; at (14, 302, 12, 64): {k3_b2['ms']:.4f} "
                        f"ms vs plain {k3_b2['plain_ms']:.4f} ms"),
        k3_kernel("fused_self_attention_bwd", "fused_attention_bwd",
                  "tpu_speech/ops/fused_attention.py:239", max_abs_err=k3_err["bwd"],
                  ms=k3_b1["bwd_ms"], plain_ms=k3_b1["bwd_plain_ms"],
                  bound_ms=k3_b1["bwd_bound"][0], bound_by=k3_b1["bwd_bound"][1],
                  library_ms=k3_b1["bwd_library_ms"],
                  shape=f"dq, dk, dv (14, 604, 8, 64) p=0.1, backward alone (error relative "
                        f"to max(1, max|plain|)); forward + backward {k3_b1['fb_ms']:.4f} ms "
                        f"vs plain {k3_b1['fb_plain_ms']:.4f} ms (K2 {k3_b1['k2_fb_ms']:.4f} "
                        f"ms); at (14, 302, 12, 64) backward {k3_b2['bwd_ms']:.4f} vs "
                        f"{k3_b2['bwd_plain_ms']:.4f} ms"),
        path_kernel("grouped_conv1d", "grouped_conv1d", "tpu_speech/ops/fused_posconv.py:132",
                    src="fused_posconv.cu", max_abs_err=k4_err, ms=k4_b1["ms"],
                    plain_ms=k4_b1["plain_ms"], bound_ms=k4_b1["bound"][0],
                    bound_by=k4_b1["bound"][1], library_ms=k4_b1["library_ms"],
                    shape=f"x (14, 604, 512) Cg 32 K 128, forward; forward + backward "
                          f"{k4_b1['fb_ms']:.4f} ms vs plain {k4_b1['fb_plain_ms']:.4f} ms; "
                          f"at (14, 302, 768) Cg 48: forward {k4_b2['ms']:.4f} vs "
                          f"{k4_b2['plain_ms']:.4f} ms"),
        path_kernel("grouped_conv1d_dx", "grouped_conv1d_dx",
                    "tpu_speech/ops/fused_posconv.py:132", src="fused_posconv.cu",
                    max_abs_err=k4_dx_err, ms=k4_b1["dx_ms"], plain_ms=k4_b1["dx_plain_ms"],
                    bound_ms=k4_b1["bound"][0], bound_by=k4_b1["bound"][1],
                    library_ms=k4_b1["dx_library_ms"],
                    shape=f"dx alone at (14, 604, 512), the weight rearrangement included: "
                          f"the K4 kernel on flipped, swapped weights (the VJP _bwd:198) "
                          f"against the plain version's input gradient; at (14, 302, 768) "
                          f"{k4_b2['dx_ms']:.4f} vs {k4_b2['dx_plain_ms']:.4f} ms"),
    ]
    # the bf16 variants (phase 17): max_abs_err relative to max(1, max|plain|)
    # against the plain versions that round at the kernels' points
    kernels += [
        bf16_kernel("fused_qkv_self_attention_bf16", "fused_qkv_attention_bf16",
                    "tpu_speech/ops/fused_attention.py:384", "fused_attention_sm90.cu", "k2",
                    "k2_t",
                    "bf16 qkv (24, 392, 1536) H=8 p=0.1 (no grad); library: SDPA in bf16"),
        bf16_kernel("fused_qkv_self_attention_bwd_bf16", "fused_qkv_attention_bwd_bf16",
                    "tpu_speech/ops/fused_attention.py:401", "fused_attention_sm90.cu", "k2_bwd",
                    "k2_bwd_t", "bf16 dqkv (24, 392, 1536) H=8 p=0.1, backward alone"),
        bf16_kernel("fused_self_attention_bf16", "fused_attention_bf16",
                    "tpu_speech/ops/fused_attention.py:222", "fused_attention_sm90.cu", "k3",
                    "k3_t",
                    "bf16 q, k, v (14, 604, 8, 64) p=0.1 (no grad)"),
        bf16_kernel("fused_self_attention_bwd_bf16", "fused_attention_bwd_bf16",
                    "tpu_speech/ops/fused_attention.py:239", "fused_attention_sm90.cu", "k3_bwd",
                    "k3_bwd_t", "bf16 dq, dk, dv (14, 604, 8, 64) p=0.1, backward alone"),
        bf16_kernel("grouped_conv1d_bf16", "grouped_conv1d_bf16",
                    "tpu_speech/ops/fused_posconv.py:132", "fused_posconv_sm90.cu", "k4", "k4_t",
                    "bf16 x (14, 604, 512) Cg 32 K 128, forward, a call with the weight "
                    "rearrangement (back_to_back_ms: the kernel alone); by_shape: the six "
                    "K4_SHAPES; library: cuDNN's bf16 conv1d"),
        bf16_kernel("grouped_conv1d_dx_bf16", "grouped_conv1d_dx_bf16",
                    "tpu_speech/ops/fused_posconv.py:132", "fused_posconv_sm90.cu", "k4_dx",
                    "k4_dx_t", "bf16 dx alone at (14, 604, 512), a call with the weight "
                    "rearrangement (back_to_back_ms: the kernel alone); by_shape: the six "
                    "K4_SHAPES; library: cuDNN's bf16 dgrad"),
    ]
    # MAS (phase 26): a port-only kernel, the JAX package's lax.scan
    kernels.append(path_kernel("maximum_path", "maximum_path",
                               "tpu_speech/ops/monotonic_align.py:27",
                               src="monotonic_align.cu", **k_mas))
    check(len(kernels) == 14, f"{len(kernels)} kernel entries")  # K1, 6 fp32, 6 bf16, MAS
    for k in kernels:
        check(all(k["launches_by_path"][path] == 0 for path in tr_launches),
              f"{k['name']} launched on a training path of phases 33-34")
        check(k["launches_by_path"]["hifigan_train_step"] == 0,
              f"{k['name']} launched on HiFi-GAN training (phases 40 and 42)")
        check((k["launches_by_path"]["gradtts_train_step_bf16"] > 0)
              == (k["name"] == "maximum_path"),
              f"{k['name']}: {k['launches_by_path']['gradtts_train_step_bf16']} launches on "
              f"bf16 Grad-TTS training (phase 42)")
        path_launches = {p: n for p, n in k["launches_by_path"].items() if not p.startswith("k3_")}
        if not k["name"].startswith("fused_self_attention"):  # K3: no path reaches it
            check(sum(path_launches.values()) > 0, f"{k['name']} never ran on a path")
    log(f"[done] {time.perf_counter() - T0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def k4_times_of(root):
    """``python3 chip_smoke.py --k4-of ROOT``: phase 17's timing of the bf16
    K4 and K4-dx (``_time_k4_bf16`` without its references) on the port
    checked out at ROOT, its own ``tpu_speech_torch`` built from its own
    ``csrc``, at the six K4 shapes, each held to its plain version first. It
    sets another commit's kernel (a parent unpacked with ``git archive``)
    beside this one in one chip call, each tree in a process of its own; run
    it as parent, change, change, parent. Ends with one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU only", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from tpu_speech_torch.ops import _build
    from tpu_speech_torch.ops import fused_posconv as fp

    check(fp.__file__.startswith(root + os.sep), f"{fp.__file__} is not under {root}")
    _build.library()
    gen = torch.Generator().manual_seed(0)
    rows = []
    for b, t, c in K4_SHAPES:
        x, w, dy = _k4_bf16_inputs(torch, gen, b, t, c)
        err = _bf16_err([fp.grouped_conv1d(x, w, 16, 64)], [fp.grouped_conv1d_plain(x, w, 16, 64)])
        check(err <= BF16_FWD_RTOL, f"K4 bf16 of {root} at {(b, t, c)}: {err}")
        log(f"[k4 of {root}] {(b, t, c)}: forward error {err:.2e} x max(1, max|plain|)")
        fwd, dx = _time_k4_bf16(torch, fp, x, w, dy, references=False)
        rows.append({"shape": [b, t, c], "max_abs_err": err,
                     **{part: {k: r[k] for k in ("ms", "back_to_back_ms", "tflops")}
                        for part, r in (("fwd", fwd), ("dx", dx))}})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"k4_of": root, "device": torch.cuda.get_device_name(0), "rows": rows}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--k4-of":
        sys.exit(k4_times_of(sys.argv[2]))
    sys.exit(main())
