"""Where the physics tiers compute: the device and dtype convention.

growth, diffusion, fokker_planck, radial and drift take numpy arrays,
Python scalars or tensors. Tensors stay on their device and keep their
floating dtype; numpy arrays and scalars become float64 tensors on the
device the caller names, else on the card. Nothing falls back to the
CPU: with no card and no device named, a tier function raises.
"""

import numpy as np
import torch


def device_of(*xs, device=None):
    """The device a tier function computes on: `device` where the caller
    names one, else that of the first tensor among xs, else cuda (which
    raises without a card)."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                   torch.device("cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the physics tiers run on the card unless the "
            "caller passes device='cpu'")
    return dev


def dtype_of(*xs):
    """The floating dtype of the first floating tensor among xs, else
    float64."""
    return next((x.dtype for x in xs
                 if isinstance(x, torch.Tensor) and x.is_floating_point()),
                torch.float64)


def tensor(x, device, dtype):
    """x as a tensor of `dtype` on `device` (numpy and scalars through a
    float64 copy, so a float64 run takes their values exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x, np.float64),
                           device=device).to(dtype)


def place(*xs, device=None):
    """xs as tensors on one device in one dtype: device_of's device and
    dtype_of's dtype."""
    dev = device_of(*xs, device=device)
    dt = dtype_of(*xs)
    return [tensor(x, dev, dt) for x in xs]
