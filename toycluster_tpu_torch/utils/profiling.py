"""The profiler of ``make_ics(profile_dir=...)`` and
``python -m toycluster_tpu_torch.trace``."""

from __future__ import annotations

import torch


def profiler(device):
    """A ``torch.profiler.profile`` of the host and, on CUDA, the
    device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
