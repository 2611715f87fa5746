"""The ray axis and the device of a process (port of
raytrace_tpu/parallel/mesh.py).

The embarrassingly parallel axis is the ray batch. The JAX package spreads
it over two levels: a 1-D mesh of the chips of one host (NamedSharding
over ICI) and, across hosts, one process per host (multi-host DCN). The
port scales out with one process per card, PyTorch's idiom: that one
level stands in for both. A process traces its slice of the launch on its
own card (parallel/distributed.py), so there is no mesh to build and
nothing to shard: `make_ray_mesh`, `ray_sharding`, `replicated` and
`shard_batch` have no counterpart. What is left is the axis name, the
padding of a batch for the processes, and the card a process drives.
"""

import os

import torch

RAY_AXIS = "rays"


def pad_rays(n, n_parts, multiple=8):
    """Padded batch size: divisible by n_parts * multiple (the JAX
    package's pad_rays with the mesh's device count as n_parts)."""
    k = n_parts * multiple
    return -(-n // k) * k


def local_device(device=None):
    """The device this process drives: `device` where the caller names
    one, else cuda:(LOCAL_RANK % device_count) (LOCAL_RANK as torchrun
    sets it, 0 without it; several ranks may share one card). Raises
    RuntimeError when no card is present and no device is named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a process runs on a card unless the caller "
            "names a device (e.g. device='cpu')")
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", rank % torch.cuda.device_count())
