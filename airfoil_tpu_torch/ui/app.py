"""Home page — the airfoil CFD studio on PyTorch and an NVIDIA GPU.

Port of ``airfoil_tpu/ui/app.py``, the Streamlit home: hero, backend
health probe with online / suspended / offline states, gated entry to the
analysis page, and the global analysis counter (``/stats``), all from the
backend at ``BACKEND_URL`` (``python -m airfoil_tpu_torch.api.server``).

Run: ``streamlit run airfoil_tpu_torch/ui/app.py`` where Streamlit is
installed.
"""

import os

import requests
import streamlit as st

BACKEND_URL = os.getenv("BACKEND_URL", "http://localhost:8000")

st.set_page_config(page_title="Airfoil CFD on GPU", page_icon="🛩️",
                   layout="wide")


@st.cache_data(ttl=30, show_spinner=False)
def check_backend(url: str) -> str:
    """'online' | 'suspended' | 'offline' (reference app.py:37-58)."""
    try:
        r = requests.get(f"{url}/health", timeout=5)
        if r.status_code == 200:
            return "online"
        if r.status_code in (502, 503):
            return "suspended"
        return "offline"
    except requests.exceptions.Timeout:
        return "suspended"
    except Exception:
        return "offline"


@st.cache_data(ttl=60, show_spinner=False)
def analysis_count(url: str):
    try:
        r = requests.get(f"{url}/stats", timeout=5)
        if r.status_code == 200:
            return r.json().get("total_analyses")
    except Exception:
        pass
    return None


st.title("🛩️ Airfoil CFD on GPU")
st.markdown(
    """
**Upload an airfoil. Get a full viscous analysis in one request.**

This is a rebuild of the classic XFOIL workflow in PyTorch on an NVIDIA
GPU: a robust Selig/Lednicer `.dat` parser with automatic geometry repair
feeds a panel method coupled to an integral boundary layer with
e&#8319; transition, its boundary-layer march a hand-written CUDA kernel
and its solver programs replayed as CUDA graphs. A whole −10°…+20° polar
costs one request. The interactive wind tunnel is a server-side D2Q9
lattice-Boltzmann solver (a CUDA kernel) streaming real fields on your
actual geometry.
"""
)

status = check_backend(BACKEND_URL)
if status == "online":
    st.success(f"Solver backend online — {BACKEND_URL}")
    st.page_link("pages/1_Airfoil_Analysis.py",
                 label="🚀 Open the analysis studio", icon="🛩️")
elif status == "suspended":
    st.warning(
        "The solver backend is waking up (cold start). Give it a moment "
        "and refresh — first contact can take ~30 s on suspended hosting."
    )
else:
    st.error(
        f"Solver backend unreachable at `{BACKEND_URL}`. Start it with "
        f"`python -m airfoil_tpu_torch.api.server` or set `BACKEND_URL`."
    )

count = analysis_count(BACKEND_URL)
if count is not None:
    st.metric("Total analyses run", f"{count:,}")

st.divider()
c1, c2, c3 = st.columns(3)
with c1:
    st.markdown("### 🔧 Robust parsing\nSelig & Lednicer detection, winding "
                "repair, LE de-dup, closed-TE preservation — the fixes that "
                "rescue 63% of the UIUC database.")
with c2:
    st.markdown("### ⚡ One-request polars\nEvery angle of attack is a "
                "lane of one batched solve: the whole sweep runs side by "
                "side on the GPU.")
with c3:
    st.markdown("### 🌬️ Live wind tunnel\nServer-side D2Q9 "
                "lattice-Boltzmann with bounce-back boundaries on your "
                "geometry, streaming velocity/pressure/vorticity.")
