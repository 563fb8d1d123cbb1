"""Device memory of the stage log.

JAX counterpart: ``toycluster_tpu/utils/memory.py``, which estimates the
standing footprint by walking the live buffers because the TPU backend's
``memory_stats()`` is empty.  On CUDA the caching allocator counts its
own bytes, so the port reads those; the CPU keeps no such count.
"""

from __future__ import annotations

import torch


def reset_peak(device) -> None:
    """Start the peak count of ``device`` anew (no-op off CUDA)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def stage_memory(device) -> dict:
    """``mem_gib`` (allocated now) and ``peak_gib`` (the most allocated
    since the last ``reset_peak``) on a CUDA ``device``; {} elsewhere."""
    if device.type != "cuda":
        return {}
    return dict(mem_gib=torch.cuda.memory_allocated(device) / 2**30,
                peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
