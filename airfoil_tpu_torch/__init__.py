"""airfoil_tpu_torch — the PyTorch/CUDA port of ``airfoil_tpu``.

A second package beside the JAX reference, with the same module names so
each counterpart is easy to find. It imports ``torch`` and never ``jax``;
from ``airfoil_tpu`` it uses only the jax-free ``config``, ``geometry``,
``models`` and ``native`` modules.

Ported so far (the interactive wind-tunnel path):

- ``device``          — explicit device policy (``cuda`` by default, no
  silent CPU fallback), float32, TF32 off.
- ``lbm``             — D2Q9 core as torch ops, the hand-written CUDA
  step kernel (``csrc/lbm_steps.cu``), diagnostics, ``WindTunnel``,
  MLUPS bench.
- ``api``             — the ``/lbm/*`` session handlers and the stdlib
  HTTP server.
"""

__version__ = "0.1.0"
