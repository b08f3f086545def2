"""The hand-written kernels and their plain versions.

Importing this package registers the kernels that ``torch.export`` keeps in
its graphs as ops of the ``tpu_speech`` namespace: ``tpu_speech::fused_logmel``
(K1), ``tpu_speech::fused_qkv_attention_fwd`` (K2's forward without dropout)
and ``tpu_speech::grouped_posconv`` (K4's forward). A program that loads an
exported graph holding them imports ``tpu_speech_torch.ops`` first.
"""

from tpu_speech_torch.ops import fused_attention, fused_logmel, fused_posconv  # noqa: F401
