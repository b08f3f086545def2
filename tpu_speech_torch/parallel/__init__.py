"""Data parallelism over processes: the rendezvous (``distributed.py``) and
the data axis with its batch slicing and FSDP placement (``mesh.py``).

The port's counterpart of ``tpu_speech/parallel/``: one process a card,
NCCL on the card and gloo on the CPU.
"""
