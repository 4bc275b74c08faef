"""Base64 of a frame's fields: on a CUDA tensor by one launch of
``csrc/field_b64.cu`` over every field, on a CPU tensor by ``binascii``.

``b64encode(tensors)`` gives, for each tensor, the standard base64 of its
bytes as ``binascii.b2a_base64(buf, newline=False)`` spells it: ASCII that
``handlers.reply_parts`` puts into a reply as it is. For CUDA tensors it
encodes all of them in one launch into one device buffer, copies that
buffer once into pinned host memory (torch's caching host allocator, a
buffer per call, so two frames in flight never share one) and waits once;
each field's string is then a ``memoryview`` slice of the pinned buffer,
which keeps it alive. For CPU tensors each string is ``bytes``. Both give
the same bytes.

The api layer owns this kernel, as ``lbm`` and ``viscous`` own theirs:
only the served reply base64-encodes. Its library is one of
``cuda_build.LIBRARIES``, so the server's warm-up builds it, and
``launches`` counts the launches (one a call on CUDA tensors, through
``cuda_build.launch``; the CPU path never touches it). A failed launch
raises.
"""

from __future__ import annotations

import binascii
import ctypes
import functools

import torch

from airfoil_tpu_torch import cuda_build

__all__ = ["MAX_FIELDS", "b64encode", "load"]

# csrc/field_b64.cu's kMaxFields: the fields one launch takes.
MAX_FIELDS = 5

launches = 0

_P = ctypes.c_void_p


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and bind the encode kernel's library."""
    return cuda_build.bind(
        cuda_build.load_library("field_b64"), "field_b64_error_string",
        {"field_b64_launch": [_P, _P, _P, ctypes.c_int, _P, ctypes.c_int,
                              _P]})


def _b64_length(n: int) -> int:
    return 4 * ((n + 2) // 3)


def _encode(tensors: list) -> tuple[torch.Tensor, list]:
    """One launch over the contiguous CUDA ``tensors`` (each 4-byte
    aligned): the device buffer of their base64 and each string's (offset,
    length) in it."""
    if len(tensors) > MAX_FIELDS:
        raise ValueError(f"{len(tensors)} fields for one launch of at most "
                         f"{MAX_FIELDS}")
    device = tensors[0].device
    count = len(tensors)
    nbytes = [t.numel() * t.element_size() for t in tensors]
    spans, total = [], 0
    for n in nbytes:
        spans.append((total, _b64_length(n)))
        total += (_b64_length(n) + 15) & ~15
    ascii_ = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    cuda_build.launch(load(), "field_b64_launch", [
        (_P * count)(*(t.data_ptr() for t in tensors)),
        (ctypes.c_longlong * count)(*nbytes),
        (ctypes.c_longlong * count)(*(o for o, _ in spans)), count,
        ascii_.data_ptr()], device, (__name__, "launches"))
    return ascii_, spans


def b64encode(tensors) -> list:
    """The base64 of each tensor's bytes (contiguous, in memory order), as
    ``bytes`` for CPU tensors and as ``memoryview`` slices of one pinned
    host buffer for CUDA tensors (at most ``MAX_FIELDS``, on one device,
    each starting on a 4-byte boundary, as every float32 tensor does)."""
    tensors = [t.detach().contiguous() for t in tensors]
    if not tensors:
        return []
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("fields on more than one device: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if device.type == "cpu":
        return [binascii.b2a_base64(
            t.reshape(-1).view(torch.uint8).numpy(), newline=False)
            for t in tensors]
    ascii_, spans = _encode(tensors)
    host = torch.empty(ascii_.numel(), dtype=torch.uint8, pin_memory=True)
    host.copy_(ascii_)                  # on the current stream, then waits
    view = memoryview(host.numpy())
    return [view[o:o + n] for o, n in spans]
