"""airfoil_tpu_torch — the PyTorch/CUDA port of ``airfoil_tpu``.

A second package beside the JAX reference, with the same module names so
each counterpart is easy to find. It imports ``torch`` and never ``jax``,
and nothing of ``airfoil_tpu``: what it needs of the reference's jax-free
modules it keeps as its own copies (``tests/test_torch_isolation.py``).

Ported so far:

- ``config``          — service limits, environment variables and
  ``LBMConfig`` (a copy of ``airfoil_tpu/config.py``'s).
- ``geometry``        — the ``.dat`` parser and multi-element check (a copy
  of ``airfoil_tpu/geometry``).
- ``models``          — ``naca4`` (a copy).
- ``device``          — explicit device policy (``cuda`` by default, no
  silent CPU fallback), float32, TF32 off.
- ``lbm``             — the interactive wind tunnel: D2Q9 core as torch
  ops, the hand-written CUDA step kernels (``csrc/lbm_steps.cu``,
  ``csrc/lbm_steps_tiled.cu``), diagnostics, ``WindTunnel``, MLUPS bench.
- ``api``             — ``/upload_airfoil/``, the ``/lbm/*`` session
  handlers and the stdlib HTTP server, serving the page
  ``ui/static_app.html`` (a byte copy).
- ``numerics``        — jnp primitives torch lacks (``interp``,
  ``nanmax``/``nanmin``, JAX-tie ``clip``, JAX's ``sigmoid`` and
  ``softplus``) and a forward-mode ``Dual``.
- ``paneling``        — ``repanel``, ``panel_geometry``,
  ``smooth_geometry``, ``rotate_about_quarter_chord``.
- ``inviscid``        — the linear-vortex panel solver (``build_operator``,
  ``solve_inviscid``, ``velocity_at_points``).
- ``viscous``         — closures, the boundary-layer march (plain torch,
  and the hand-written CUDA kernel ``csrc/bl_march.cu`` behind
  ``viscous.kernel``), the wake operator, the direct coupled solve
  ``solve_viscous`` and the simultaneous-Newton solver ``viscous.newton``.
- ``polar``           — ``analyze_airfoil``, the three-strategy
  single-point analysis.
- ``utils``           — the analysis counter (a copy of the reference's
  ``utils/stats.py``).
"""

__version__ = "0.1.0"
