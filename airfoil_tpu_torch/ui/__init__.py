"""Visualisation of the port's results (``flowviz``) and the static page
that ``api/minihttp.py`` serves."""
