"""Device and dtype policy for the port.

The device is always explicit: ``cuda`` unless a caller names another one,
either through a ``device`` argument or the ``AIRFOIL_TPU_TORCH_DEVICE``
environment variable. Asking for ``cuda`` on a machine without a CUDA
device raises; nothing falls back to the CPU silently.

Everything is float32, as in the JAX reference. TF32 is turned off for
matmuls and cuDNN so that any float32 product keeps full precision.
"""

from __future__ import annotations

import os

import torch

__all__ = ["DTYPE", "ENV_VAR", "resolve_device"]

DTYPE = torch.float32
ENV_VAR = "AIRFOIL_TPU_TORCH_DEVICE"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``device`` if given, else the environment
    variable, else ``cuda``. Raises if ``cuda`` is named and absent."""
    if device is None:
        device = os.environ.get(ENV_VAR) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            f"pass device='cpu' (or set {ENV_VAR}=cpu) to run on the CPU")
    return dev
