"""Visualisation of the port's results (``flowviz``), the static page
that ``api/minihttp.py`` serves, and the Streamlit studio (``app.py``,
``pages/``, ``lbm_viewer.html``: ``streamlit run
airfoil_tpu_torch/ui/app.py``, scripts that are run, not imported)."""
