"""tpu_speech_torch — the PyTorch/CUDA port of ``tpu_speech`` for NVIDIA Hopper.

The JAX package ``tpu_speech`` stays the reference; every module here mirrors
its counterpart's path and name (``tpu_speech/models/spiral/ctc.py`` ->
``tpu_speech_torch/models/spiral/ctc.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests. Public functions keep the JAX
package's channels-last ``(B, T, C)`` layout.

Ported so far: the SPIRAL-base CTC transcription path (wav -> log-mel ->
conv-subsampling + transformer encoder -> char CTC head -> greedy decode),
with the two Pallas kernels it runs re-written by hand for Hopper in
``csrc/`` (``ops/fused_logmel.py``, ``ops/fused_attention.py``).

Nothing here imports JAX. Host-side helpers that import no JAX
(``tpu_speech.text``, ``tpu_speech.eval.wer``, ``tpu_speech.data``,
``tpu_speech.utils.config``) are reused from the JAX package as they are.
"""

__version__ = "0.1.0"
