"""Profiling harness: wall clock and ray-steps/s accounting (port of
raytrace_tpu/utils/profiling.py).

A timing context that waits for the card (CUDA synchronisation) before
it reads the clock, the headline metric (attempted ray-steps/s per card),
and a torch.profiler trace context.
"""

import contextlib
import time

import numpy as np
import torch


class Timing:
    def __init__(self):
        self.wall_s = None


@contextlib.contextmanager
def timed(result_holder: Timing):
    """Times a block; waits for every queued CUDA kernel before reading
    the clock, as the JAX package blocks on its results."""
    t0 = time.perf_counter()
    yield result_holder
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    result_holder.wall_s = time.perf_counter() - t0


def ray_steps_per_sec(result, wall_s, valid=None, n_devices=1):
    """The headline metric: attempted steps of valid rays / wall / cards."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    acc = host(result.n_accept)
    rej = host(result.n_reject)
    if valid is not None:
        acc, rej = acc[np.asarray(valid)], rej[np.asarray(valid)]
    return float((acc.sum() + rej.sum()) / wall_s / n_devices)


@contextlib.contextmanager
def device_trace(path):
    """torch.profiler trace of the block (CPU, and CUDA where a card is
    present), written as a Chrome trace to `path`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
