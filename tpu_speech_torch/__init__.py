"""tpu_speech_torch — the PyTorch/CUDA port of ``tpu_speech`` for NVIDIA Hopper.

The JAX package ``tpu_speech`` stays the reference; every module here mirrors
its counterpart's path and name (``tpu_speech/models/spiral/ctc.py`` ->
``tpu_speech_torch/models/spiral/ctc.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. Public functions keep the JAX
package's channels-last ``(B, T, C)`` layout.

Ported so far: SPIRAL-base CTC transcription (wav -> log-mel ->
conv-subsampling + transformer encoder -> char CTC head -> greedy decode),
the ST2Vec pretrain step and the CTC finetune step, with every Pallas kernel
of the JAX package re-written by hand for Hopper in ``csrc/``
(``ops/fused_logmel.py``, ``ops/fused_attention.py``,
``ops/fused_posconv.py``); and Grad-TTS + HiFi-GAN text-to-waveform
serving (``cli/inference.py``: text -> ids -> encoder -> durations ->
U-Net sampler -> HiFi-GAN -> int16 wav), which reaches no Pallas kernel in
the JAX package and runs here on cuDNN and cuBLAS, with the reference
PyTorch module trees (``nn/``, ``models/{text_encoder,diffusion,grad_tts,
hifigan}.py``).

Nothing here imports JAX or any module of the JAX package. The host-side
code the port runs is its own copy, with the JAX package's structure and
names: ``utils/config.py``, ``text/`` (tokenizers, the char parser and the
TTS frontend), ``eval/wer.py``, ``data/`` (manifests, datasets, collates,
the loader, ``read_wav``, ``write_wav``) and ``configs/gradtts.py``. ``tests/test_torch_isolation.py`` holds the rule and
``tests/test_torch_host.py`` holds the copies against the originals.
"""

__version__ = "0.1.0"
