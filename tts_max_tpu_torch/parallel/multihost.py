"""Per-process batches and cross-process sync (counterpart of
``tts_max_tpu/parallel/multihost.py``).

Each process loads only its rows of the global batch (``data/loader.py``
applies the rule): rank r of a batch split over n ranks holds rows
``[r * B/n, (r + 1) * B/n)``, the row order
``jax.make_array_from_process_local_data`` gives the global array in the
JAX package. The port keeps the local rows as they are: no
global array is assembled, and the steps sum across ranks what they need.
Each rank pads its rows to its own bucket; the steps' sums do not depend
on it (causal attention, ``-100`` labels on the pad tail).
"""

from __future__ import annotations

import torch.distributed as dist

from tts_max_tpu_torch.parallel import collectives


def barrier(group=None) -> None:
    """Cross-process sync point; nothing without a group."""
    if dist.is_available() and dist.is_initialized():
        collectives.barrier(group)
