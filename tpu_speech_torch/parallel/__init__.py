"""Parallelism over processes: the rendezvous (``distributed.py``), the data
and seq axes of the mesh with batch slicing and FSDP placement
(``mesh.py``), the time-axis collectives of sequence parallelism
(``seq.py``) and the CLIs' launcher (``launch.py``).

The port's counterpart of ``tpu_speech/parallel/``: one process a card,
NCCL on the card and gloo on the CPU.
"""
