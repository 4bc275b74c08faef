"""Test doubles of ``streamlit`` (with ``streamlit.components.v1``) and
``plotly`` (``plotly.graph_objects``), which neither the CPU nor the GPU
machine installs.

Every streamlit call is recorded in ``calls`` as (name, args, kwargs).
Widgets return their defaults (``radio``/``selectbox`` the option at
``index``, ``number_input``/``slider``/``select_slider`` their ``value``),
``file_uploader`` returns None and ``button`` False; ``stop()`` raises
``StopRun``; ``cache_data`` returns the function itself; ``sidebar``,
``columns`` and ``expander`` are context managers whose methods record as
the module's do. Plotly's objects accept any arguments and any method
call. ``modules()`` gives fresh doubles by module name, for
``sys.modules``.
"""

from __future__ import annotations

import types


class StopRun(Exception):
    """What ``st.stop()`` raises: the script ends there."""


class _Container:
    def __init__(self, st):
        self._st = st

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, name):
        return getattr(self._st, name)


class Streamlit(types.ModuleType):
    def __init__(self):
        super().__init__("streamlit")
        self.calls: list[tuple[str, tuple, dict]] = []
        self.session_state: dict = {}
        self.sidebar = _Container(self)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args, **kwargs: self._record(name, args, kwargs)

    def _record(self, name, args, kwargs):
        self.calls.append((name, args, kwargs))

    def named(self, name: str) -> list[tuple]:
        """The positional arguments of every call of ``name``."""
        return [args for n, args, _ in self.calls if n == name]

    # ── decorators and control flow ──────────────────────────────────────
    def cache_data(self, fn=None, **_options):
        if fn is not None:
            return fn
        return lambda f: f

    def stop(self):
        self._record("stop", (), {})
        raise StopRun

    # ── layout ───────────────────────────────────────────────────────────
    def columns(self, spec, **kwargs):
        self._record("columns", (spec,), kwargs)
        n = spec if isinstance(spec, int) else len(spec)
        return [_Container(self) for _ in range(n)]

    def expander(self, *args, **kwargs):
        self._record("expander", args, kwargs)
        return _Container(self)

    # ── widgets: their defaults ──────────────────────────────────────────
    def radio(self, label, options, index=0, **kwargs):
        self._record("radio", (label, options), kwargs)
        return list(options)[index]

    def selectbox(self, label, options, index=0, **kwargs):
        self._record("selectbox", (label, options), kwargs)
        return list(options)[index]

    def number_input(self, label, min_value=None, max_value=None,
                     value=None, step=None, **kwargs):
        self._record("number_input", (label,), kwargs)
        return min_value if value is None else value

    def slider(self, label, min_value=None, max_value=None, value=None,
               step=None, **kwargs):
        self._record("slider", (label,), kwargs)
        return min_value if value is None else value

    def select_slider(self, label, options=(), value=None, **kwargs):
        self._record("select_slider", (label,), kwargs)
        return list(options)[0] if value is None else value

    def file_uploader(self, *args, **kwargs):
        self._record("file_uploader", args, kwargs)
        return None

    def button(self, *args, **kwargs):
        self._record("button", args, kwargs)
        return False


class _PlotlyObject:
    def __init__(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *args, **kwargs: None


class _GraphObjects(types.ModuleType):
    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return type(name, (_PlotlyObject,), {})


def modules() -> dict[str, types.ModuleType]:
    """Fresh doubles by the module names the pages import."""
    st = Streamlit()
    components = types.ModuleType("streamlit.components")
    v1 = types.ModuleType("streamlit.components.v1")
    v1.html = lambda *args, **kwargs: st._record("components.html", args,
                                                 kwargs)
    components.v1 = v1
    st.components = components
    plotly = types.ModuleType("plotly")
    go = _GraphObjects("plotly.graph_objects")
    plotly.graph_objects = go
    return {"streamlit": st, "streamlit.components": components,
            "streamlit.components.v1": v1, "plotly": plotly,
            "plotly.graph_objects": go}
