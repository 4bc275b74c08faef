"""The benchmark of ``airfoil_tpu_torch``: one cell a run, driven by data.

``run.py`` is the command. A cell (``workloads/<cell>.json``) names its
configuration (``configs/<config>.json``, with its plain reference in
``configs/<config>.py``) and its traffic mix (``traffic/<mix>.json``, read
by the one generator in ``traffic.py``, which makes airfoil files with the
makers in ``airfoils/<maker>.py``). Each metric is computed by a file named
after it: ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``.
Nothing here imports JAX or the JAX package; the references import nothing
of the program.
"""
