"""Flow-field visualisation builders: a copy of ``airfoil_tpu/ui/flowviz.py``.

A speed-heatmap PNG with a fixed 0..2 U_inf colour scale so different
airfoils are comparable (``render_heatmap_png``), a Plotly
particle-advection animation along the traced streamlines
(``build_flow_animation``), and the boundary-layer displacement-thickness
overlay offset along the surface normals with transition markers
(``build_bl_overlay``), as the reference's frontend draws them.

The field is the port's ``FlowField``
(``airfoil_tpu_torch.inviscid.flowfield.compute_flow_field``: numpy arrays
on the host). matplotlib and plotly are imported inside the functions that
use them.
"""

from __future__ import annotations

import base64
import io

import numpy as np

__all__ = ["render_heatmap_png", "build_flow_animation", "build_bl_overlay"]

# Same 7-stop speed colormap role as the reference (:252-259): dark blue
# (stagnant) through white (U_inf) to deep red (2 U_inf).
_SPEED_STOPS = [
    (0.00, "#10306a"), (0.18, "#2a65b4"), (0.38, "#7fb2e0"),
    (0.50, "#f4f4f2"), (0.65, "#f5b183"), (0.85, "#e35d3c"),
    (1.00, "#8e1a10"),
]


def render_heatmap_png(field, dpi: int = 110) -> str:
    """Speed heatmap + streamlines -> base64 PNG (fixed 0..2 U_inf scale).

    ``field`` is a FlowField from ``compute_flow_field``. Matching the
    reference, the colour scale is pinned to [0, 2 U_inf] so plots of
    different airfoils / alphas are directly comparable (:246-251).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list(
        "aerospeed", _SPEED_STOPS)

    fig, ax = plt.subplots(figsize=(7.2, 5.4), dpi=dpi)
    ax.imshow(
        field.speed,
        origin="lower",
        extent=(field.x[0], field.x[-1], field.y[0], field.y[-1]),
        vmin=0.0, vmax=2.0,
        cmap=cmap, aspect="equal", interpolation="bilinear",
    )
    for xs, ys in field.streamlines:
        ax.plot(xs, ys, color="white", lw=0.7, alpha=0.55)
    ax.fill(field.coords[:, 0], field.coords[:, 1], color="#15151a",
            zorder=5)
    ax.set_xlim(field.x[0], field.x[-1])
    ax.set_ylim(field.y[0], field.y[-1])
    ax.set_xlabel("x/c")
    ax.set_ylabel("y/c")
    ax.set_title("Flow speed |V| / U∞ (fixed 0–2 scale)")
    sm = plt.cm.ScalarMappable(cmap=cmap,
                               norm=plt.Normalize(vmin=0, vmax=2))
    fig.colorbar(sm, ax=ax, fraction=0.04, pad=0.02, label="|V| / U∞")
    fig.tight_layout()

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def build_flow_animation(field, n_frames: int = 50,
                         particles_per_line: int = 5):
    """Plotly animation: particles advected along the traced streamlines.

    Mirrors the reference's arc-length parameterisation with a fixed
    rng(42) seed for reproducible particle phases (:426-503).
    """
    import plotly.graph_objects as go

    rng = np.random.default_rng(42)
    lines = []
    for xs, ys in field.streamlines:
        xs = np.asarray(xs, np.float64)
        ys = np.asarray(ys, np.float64)
        if len(xs) < 6:
            continue
        seg = np.hypot(np.diff(xs), np.diff(ys))
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        if arc[-1] <= 0:
            continue
        lines.append((xs, ys, arc / arc[-1]))

    base_traces = [
        go.Scatter(x=field.coords[:, 0], y=field.coords[:, 1],
                   mode="lines", fill="toself",
                   line=dict(color="#222"), fillcolor="#222",
                   showlegend=False, hoverinfo="skip"),
    ]
    for xs, ys, _f in lines:
        base_traces.append(go.Scatter(
            x=xs, y=ys, mode="lines",
            line=dict(color="rgba(120,150,220,0.35)", width=1),
            showlegend=False, hoverinfo="skip"))

    phases = [rng.random(particles_per_line) for _ in lines]

    def particles_at(t_frac):
        px, py = [], []
        for (xs, ys, frac), ph in zip(lines, phases):
            for p in ph:
                f = (p + t_frac) % 1.0
                i = np.searchsorted(frac, f)
                i = min(max(i, 1), len(frac) - 1)
                w = (f - frac[i - 1]) / max(frac[i] - frac[i - 1], 1e-12)
                px.append(xs[i - 1] + w * (xs[i] - xs[i - 1]))
                py.append(ys[i - 1] + w * (ys[i] - ys[i - 1]))
        return px, py

    px0, py0 = particles_at(0.0)
    particle_trace = go.Scatter(
        x=px0, y=py0, mode="markers",
        marker=dict(size=4, color="#e8eefc"),
        showlegend=False, hoverinfo="skip")

    frames = []
    for k in range(n_frames):
        px, py = particles_at(k / n_frames)
        frames.append(go.Frame(
            data=[go.Scatter(x=px, y=py)],
            traces=[len(base_traces)], name=str(k)))

    fig = go.Figure(data=base_traces + [particle_trace], frames=frames)
    fig.update_yaxes(scaleanchor="x", scaleratio=1, visible=False)
    fig.update_xaxes(visible=False)
    fig.update_layout(
        height=420, margin=dict(l=6, r=6, t=30, b=6),
        paper_bgcolor="#0d1321", plot_bgcolor="#0d1321",
        title="Streamline particle animation",
        updatemenus=[dict(
            type="buttons", showactive=False, y=0, x=0,
            buttons=[dict(
                label="▶ Play", method="animate",
                args=[None, dict(
                    frame=dict(duration=60, redraw=False),
                    transition=dict(duration=0),
                    fromcurrent=True, mode="immediate")])],
        )],
    )
    return fig


def build_bl_overlay(coords, bl_data):
    """Plotly traces: displacement-thickness surface offset + transition.

    The delta* line is offset along the local outward surface normal
    (reference :297-332); transition points get markers (:391-423).
    Returns a list of traces to add onto the geometry figure.
    """
    import plotly.graph_objects as go

    traces = []
    coords = np.asarray(coords, np.float64)

    for side_name, color in (("upper", "#e3633c"), ("lower", "#3c7de3")):
        rows = (bl_data or {}).get(side_name) or []
        if len(rows) < 4:
            continue
        x = np.array([r["x"] for r in rows])
        y = np.array([r["y"] for r in rows])
        ds = np.array([r["dstar"] for r in rows])
        # Local outward normal from the surface tangent.
        tx = np.gradient(x)
        ty = np.gradient(y)
        tl = np.hypot(tx, ty) + 1e-12
        nx, ny = -ty / tl, tx / tl
        # Point the normal away from the camber line (y ~ 0 for the
        # overlay's purposes): upper offsets up, lower offsets down.
        sign = 1.0 if side_name == "upper" else -1.0
        flip = np.where(sign * ny >= 0, 1.0, -1.0)
        ox = x + flip * nx * ds
        oy = y + flip * ny * ds
        traces.append(go.Scatter(
            x=ox, y=oy, mode="lines",
            line=dict(color=color, width=1.4, dash="dot"),
            name=f"δ* ({side_name})"))

        xtr = (bl_data or {}).get(f"transition_{side_name}_x")
        if xtr is not None:
            i = int(np.argmin(np.abs(x - xtr)))
            traces.append(go.Scatter(
                x=[x[i]], y=[y[i]], mode="markers",
                marker=dict(symbol="diamond", size=9, color=color,
                            line=dict(color="white", width=1)),
                name=f"transition ({side_name})"))
    return traces
