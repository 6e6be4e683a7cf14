"""Opt-in `torch.profiler` hook for the dense iteration loop.

`profile_ctx(profile_dir)` records a `torch.profiler` trace (host ops, and
device kernels when a CUDA card is present) around a block and writes it
into `profile_dir` as a TensorBoard/Perfetto-loadable JSON; with
`profile_dir=None` it is a no-op context (the default for every run). The
dense runner enters it around the simulator's run when
`ExperimentSpec.profile_dir` is set.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

__all__ = ["profile_ctx"]


@contextmanager
def profile_ctx(profile_dir: str | None) -> Iterator[None]:
    if profile_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(profile_dir))
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler):
        yield
