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
``ops/fused_posconv.py``).

Nothing here imports JAX or any module of the JAX package. The host-side
code the port runs is its own copy, with the JAX package's structure and
names: ``utils/config.py``, ``text/`` (tokenizers and the char parser),
``eval/wer.py`` and ``data/`` (manifests, datasets, collates, the loader,
``read_wav``). ``tests/test_torch_isolation.py`` holds the rule and
``tests/test_torch_host.py`` holds the copies against the originals.
"""

__version__ = "0.1.0"
