"""Analysis studio — single point, one-request polars, batch, wind tunnel.

Port of ``airfoil_tpu/ui/pages/1_Airfoil_Analysis.py``: upload
single/batch, Reynolds presets, alpha slider or sweep, cached HTTP client
with retry, coefficient metrics with stall/downforce heuristics, geometry
plot, parser-fix console, split-surface Cp plot with reversed y-axis,
polar table + charts + CSV download, flow field visualisation, and the
LBM wind-tunnel embed. Every solve is an HTTP call to the backend at
``BACKEND_URL`` (``python -m airfoil_tpu_torch.api.server``); a sweep is
ONE ``/polar/`` request, its points solved side by side. The flow field
is computed here, by the port's ``compute_flow_field`` on
``resolve_device()`` (``cuda`` unless ``AIRFOIL_TPU_TORCH_DEVICE`` names
another device).
"""

import io
import os
import time

import numpy as np
import pandas as pd
import plotly.graph_objects as go
import requests
import streamlit as st
import streamlit.components.v1 as components

BACKEND_URL = os.getenv("BACKEND_URL", "http://localhost:8000")
_VIEWER = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "lbm_viewer.html")

st.set_page_config(page_title="Airfoil Analysis", page_icon="📈",
                   layout="wide")
st.title("📈 Airfoil Analysis")

RE_PRESETS = {
    "50,000 (model glider)": 5e4,
    "200,000 (RC plane)": 2e5,
    "500,000 (large UAV)": 5e5,
    "1,000,000 (light aircraft)": 1e6,
    "3,000,000 (GA cruise)": 3e6,
    "6,000,000 (commuter)": 6e6,
}


# ── backend health gate (reference Airfoil_Analysis.py:619-649) ────────────
@st.cache_data(ttl=30, show_spinner=False)
def _health(url):
    try:
        return requests.get(f"{url}/health", timeout=5).status_code == 200
    except Exception:
        return False


if not _health(BACKEND_URL):
    st.error("Solver backend is not reachable. Start it with "
             "`python -m airfoil_tpu_torch.api.server`.")
    st.stop()


# ── cached clients with retry (reference :675-705) ─────────────────────────
@st.cache_data(ttl=3600, max_entries=50, show_spinner=False)
def run_analysis(file_bytes: bytes, name: str, reynolds: float, alpha: float,
                 url: str):
    for attempt in range(3):
        try:
            r = requests.post(
                f"{url}/upload_airfoil/",
                files={"file": (name, file_bytes)},
                data={"reynolds": reynolds, "alpha": alpha},
                timeout=90,
            )
            if r.status_code == 429:
                time.sleep(5 * (attempt + 1))
                continue
            return r.status_code, r.json()
        except requests.exceptions.Timeout:
            time.sleep(2 * (attempt + 1))
    return 0, {"detail": "Backend did not respond after 3 attempts"}


@st.cache_data(ttl=3600, max_entries=20, show_spinner=False)
def run_polar(file_bytes: bytes, name: str, reynolds: float,
              a0: float, a1: float, step: float, url: str):
    for attempt in range(3):
        try:
            r = requests.post(
                f"{url}/polar/",
                files={"file": (name, file_bytes)},
                data={"reynolds": reynolds, "alpha_start": a0,
                      "alpha_end": a1, "alpha_step": step},
                timeout=180,
            )
            if r.status_code == 429:
                time.sleep(5 * (attempt + 1))
                continue
            return r.status_code, r.json()
        except requests.exceptions.Timeout:
            time.sleep(2 * (attempt + 1))
    return 0, {"detail": "Backend did not respond after 3 attempts"}


# ── sidebar controls ───────────────────────────────────────────────────────
with st.sidebar:
    st.header("Run setup")
    mode = st.radio("Mode", ["Single point", "α sweep (polar)", "Batch files"])
    preset = st.selectbox("Reynolds preset", list(RE_PRESETS), index=3)
    reynolds = st.number_input("Reynolds number", 1e4, 1e7,
                               RE_PRESETS[preset], step=1e4, format="%.0f")
    if mode == "α sweep (polar)":
        a_lo, a_hi = st.slider("α range (deg)", -20.0, 20.0, (-4.0, 12.0),
                               step=0.5)
        a_step = st.select_slider("α step", [0.25, 0.5, 1.0, 2.0], value=1.0)
        alpha = None
    else:
        alpha = st.slider("Angle of attack α (deg)", -20.0, 20.0, 5.0,
                          step=0.5)

if mode == "Batch files":
    files = st.file_uploader("Upload up to 10 .dat files", type=["dat"],
                             accept_multiple_files=True)
    files = (files or [])[:10]
else:
    one = st.file_uploader("Upload airfoil .dat file", type=["dat"])
    files = [one] if one else []


def geometry_figure(coords, name, bl_data=None):
    c = np.asarray(coords)
    fig = go.Figure(go.Scatter(x=c[:, 0], y=c[:, 1], mode="lines",
                               fill="toself", name=name))
    if bl_data:
        try:
            from airfoil_tpu_torch.ui.flowviz import build_bl_overlay

            for tr in build_bl_overlay(c, bl_data):
                fig.add_trace(tr)
        except Exception:
            pass  # overlay is cosmetic; never block the geometry plot
    fig.update_yaxes(scaleanchor="x", scaleratio=1)
    fig.update_layout(height=260, margin=dict(l=10, r=10, t=30, b=10),
                      title=f"Geometry — {name} ({len(c)} points)")
    return fig


@st.cache_data(ttl=3600, max_entries=20, show_spinner=False)
def flow_visuals(coords_tuple, alpha: float):
    """Heatmap PNG + particle animation from the port's own panel solution
    on ``resolve_device()``; the field reaches the renderers as numpy
    arrays."""
    from airfoil_tpu_torch.device import resolve_device
    from airfoil_tpu_torch.inviscid.flowfield import compute_flow_field
    from airfoil_tpu_torch.ui.flowviz import build_flow_animation, \
        render_heatmap_png

    field = compute_flow_field(np.asarray(coords_tuple), alpha,
                               device=resolve_device())
    return render_heatmap_png(field), build_flow_animation(field)


def cp_figure(cp_x, cp_values):
    x = np.asarray(cp_x)
    cp = np.asarray(cp_values)
    le = int(np.argmin(x))
    fig = go.Figure()
    fig.add_trace(go.Scatter(x=x[:le + 1], y=cp[:le + 1], name="Upper",
                             mode="lines"))
    fig.add_trace(go.Scatter(x=x[le:], y=cp[le:], name="Lower",
                             mode="lines"))
    fig.update_yaxes(autorange="reversed", title="Cp")
    fig.update_xaxes(title="x/c")
    fig.update_layout(height=360, margin=dict(l=10, r=10, t=30, b=10),
                      title="Pressure distribution (−Cp up)")
    return fig


def coefficient_row(c, alpha=None):
    cl = c.get("CL", 0.0)
    cd = c.get("CD", 0.0)
    cm = c.get("Cm", 0.0)
    ld = cl / cd if cd and cd > 0 else float("nan")
    cols = st.columns(4)
    cols[0].metric("CL", f"{cl:.4f}")
    cols[1].metric("CD", f"{cd:.5f}" if cd else "—")
    cols[2].metric("Cm", f"{cm:.4f}")
    cols[3].metric("L/D", f"{ld:.1f}" if np.isfinite(ld) else "—")
    # stall / downforce heuristics (reference :1235-1257)
    if c.get("mode") == "inviscid":
        st.warning("Viscous solve did not converge — inviscid fallback. "
                   + c.get("warning", ""))
    if cl < -0.05:
        st.info("Negative lift — this configuration produces downforce.")
    elif (alpha is not None and abs(alpha) >= 12
            and (cd > 0.15 or (np.isfinite(ld) and ld < 5))):
        st.error("Possible stall condition — high drag and low L/D "
                 "suggest flow separation.")


def bl_section(bl):
    if not bl:
        return
    with st.expander("Boundary-layer details"):
        cols = st.columns(2)
        txu = bl.get("transition_upper_x")
        txl = bl.get("transition_lower_x")
        cols[0].metric("Transition (upper)",
                       f"x/c = {txu:.3f}" if txu else "laminar to TE")
        cols[1].metric("Transition (lower)",
                       f"x/c = {txl:.3f}" if txl else "laminar to TE")
        for side in ("upper", "lower"):
            rows = bl.get(side) or []
            if rows:
                df = pd.DataFrame(rows)
                fig = go.Figure()
                fig.add_trace(go.Scatter(x=df.x, y=df.dstar, name="δ*"))
                fig.add_trace(go.Scatter(x=df.x, y=df.theta, name="θ"))
                fig.update_layout(height=220, title=f"{side} surface",
                                  margin=dict(l=10, r=10, t=30, b=10))
                st.plotly_chart(fig, use_container_width=True)


def polar_png_downloads(df, filename, reynolds):
    """Publication-style PNG exports of the polar charts (reference
    pages/Airfoil_Analysis.py:1090-1141 offers the same five downloads;
    rendered headless with the Agg backend)."""
    import io as _io

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:          # pragma: no cover - matplotlib absent
        st.caption(f"PNG export unavailable: {e}")
        return
    # mode is the API's string enum ("viscous"/"viscous_smoothed"/
    # "inviscid"); inviscid points carry CD=0 and must not enter the
    # CD-based charts.
    ok = df[(df.get("mode", "viscous") != "inviscid") & np.isfinite(df.CL)]
    if len(ok) < 2:
        return
    st.subheader("📈 Download polar plots")
    label = os.path.splitext(filename)[0]
    plots = {
        "CL_vs_alpha": (ok.alpha, ok.CL, "α (deg)", "CL"),
        "CD_vs_alpha": (ok.alpha, ok.CD, "α (deg)", "CD"),
        "Cm_vs_alpha": (ok.alpha, ok.Cm, "α (deg)", "Cm"),
        "drag_polar": (ok.CD, ok.CL, "CD", "CL"),
        "LD_vs_alpha": (ok.alpha, ok["L/D"], "α (deg)", "L/D"),
    }
    cols = st.columns(len(plots))
    for col, (tag, (xs, ys, xl, yl)) in zip(cols, plots.items()):
        fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
        ax.plot(xs, ys, "o-", lw=1.8, ms=4)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_title(f"{label}  Re={reynolds:,.0f}")
        ax.grid(alpha=0.4, ls="--")
        fig.tight_layout()
        buf = _io.BytesIO()
        fig.savefig(buf, format="png")
        plt.close(fig)
        col.download_button(f"⬇️ {yl} plot", buf.getvalue(),
                            file_name=f"{label}_{tag}.png",
                            mime="image/png", key=f"dl_{tag}")


def parser_fixes_box(fixes):
    with st.expander("Parser repair log", expanded=bool(
            fixes and "No changes" not in fixes[0])):
        for f in fixes or []:
            st.code(f, language=None)


def lbm_embed(file_bytes, name, alpha0):
    try:
        r = requests.post(f"{BACKEND_URL}/lbm/start",
                          files={"file": (name, file_bytes)},
                          data={"alpha": alpha0}, timeout=120)
        if r.status_code != 200:
            st.info("Wind tunnel unavailable: " + r.text[:200])
            return
        meta = r.json()
    except Exception as e:
        st.info(f"Wind tunnel unavailable: {e}")
        return
    with open(_VIEWER) as f:
        html = f.read()
    html = (html
            .replace("%%BACKEND%%", BACKEND_URL)
            .replace("%%SESSION%%", meta["session"])
            .replace("%%META%%", str(meta).replace("'", '"'))
            .replace("%%NAME%%", name)
            .replace("%%ALPHA%%", str(alpha0)))
    components.html(html, height=620, scrolling=False)


# ── single point ───────────────────────────────────────────────────────────
if mode == "Single point" and files:
    f = files[0]
    data = f.getvalue()
    if st.button("🚀 Run analysis", type="primary"):
        st.session_state["single"] = run_analysis(
            data, f.name, reynolds, alpha, BACKEND_URL)
    if "single" in st.session_state:
        code, res = st.session_state["single"]
        if code != 200:
            st.error(res.get("detail", "analysis failed"))
        else:
            coefficient_row(res["coefficients"], alpha=alpha)
            parser_fixes_box(res.get("parser_fixes"))
            c1, c2 = st.columns(2)
            with c1:
                st.plotly_chart(
                    geometry_figure(res["coords_after"], f.name,
                                    res.get("bl_data")),
                    use_container_width=True)
            with c2:
                st.plotly_chart(cp_figure(res["cp_x"], res["cp_values"]),
                                use_container_width=True)
            bl_section(res.get("bl_data"))
            st.subheader("🌊 Flow field")
            try:
                png_b64, anim = flow_visuals(
                    tuple(map(tuple, res["coords_after"])), alpha)
                v1, v2 = st.columns(2)
                with v1:
                    st.image(io.BytesIO(__import__("base64").b64decode(
                        png_b64)), caption="Speed heatmap + streamlines")
                with v2:
                    st.plotly_chart(anim, use_container_width=True)
            except Exception as e:
                st.info(f"Flow visualisation unavailable: {e}")
            st.subheader("🌬️ Interactive wind tunnel")
            lbm_embed(data, f.name, alpha)

# ── polar sweep: ONE request ───────────────────────────────────────────────
elif mode == "α sweep (polar)" and files:
    f = files[0]
    data = f.getvalue()
    if st.button("🚀 Run sweep", type="primary"):
        st.session_state["sweep"] = run_polar(
            data, f.name, reynolds, a_lo, a_hi, a_step, BACKEND_URL)
    if "sweep" in st.session_state:
        code, res = st.session_state["sweep"]
        if code != 200:
            st.error(res.get("detail", "sweep failed"))
        else:
            st.caption(
                f"Whole polar computed server-side in "
                f"{res['elapsed_seconds']:.3f} s (one request, the points "
                f"solved side by side)")
            df = pd.DataFrame(res["polar"])
            df["L/D"] = np.where(df.CD > 0, df.CL / df.CD, np.nan)
            st.dataframe(df, use_container_width=True, height=260)
            st.download_button(
                "⬇️ CSV", df.to_csv(index=False).encode(),
                file_name=f"{os.path.splitext(f.name)[0]}_polar.csv")
            figs = []
            for ycol, title in [("CL", "CL vs α"), ("CD", "CD vs α"),
                                ("Cm", "Cm vs α"), ("L/D", "L/D vs α")]:
                fig = go.Figure(go.Scatter(x=df.alpha, y=df[ycol],
                                           mode="lines+markers"))
                fig.update_layout(title=title, height=280,
                                  margin=dict(l=10, r=10, t=40, b=10))
                figs.append(fig)
            drag = go.Figure(go.Scatter(x=df.CD, y=df.CL,
                                        mode="lines+markers"))
            drag.update_layout(title="Drag polar (CL vs CD)", height=280,
                               margin=dict(l=10, r=10, t=40, b=10))
            figs.append(drag)
            cols = st.columns(2)
            for i, fig in enumerate(figs):
                cols[i % 2].plotly_chart(fig, use_container_width=True)
            polar_png_downloads(df, f.name, reynolds)

# ── batch: ONE request, the geometries solved side by side ─────────────────
elif mode == "Batch files" and files:
    if st.button(f"🚀 Analyze {len(files)} files", type="primary"):
        try:
            # Repeated "files" parts: the one convention both transports
            # bind (FastAPI list[UploadFile] and minihttp's accumulating
            # multipart parser).
            form_files = [("files", (f.name, f.getvalue()))
                          for f in files]
            r = requests.post(f"{BACKEND_URL}/batch/", files=form_files,
                              data={"reynolds": reynolds, "alpha": alpha},
                              timeout=180)
            payload = r.json()
            if r.status_code == 200:
                st.session_state["batch"] = payload
            else:
                st.error(payload.get("detail", "batch failed"))
        except Exception as e:
            st.error(f"Batch request failed: {e}")
    if "batch" in st.session_state:
        payload = st.session_state["batch"]
        st.caption(f"{len(payload['results'])} airfoils analyzed in ONE "
                   f"batched request: {payload['elapsed_seconds']:.3f} s")
        df = pd.DataFrame(payload["results"])
        st.dataframe(df, use_container_width=True)
        st.download_button("⬇️ CSV", df.to_csv(index=False).encode(),
                           file_name="batch_results.csv")
else:
    st.info("Upload a `.dat` airfoil file to begin. Selig and Lednicer "
            "formats are both handled; imperfect files are repaired "
            "automatically.")
