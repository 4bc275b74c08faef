"""About page — what the tool computes and how (port of
``airfoil_tpu/ui/pages/2_About.py``)."""

import streamlit as st

st.set_page_config(page_title="About", page_icon="ℹ️", layout="wide")
st.title("ℹ️ About Airfoil CFD on GPU")

st.markdown(
    """
### What this tool does

You upload a 2-D airfoil as a `.dat` coordinate file and pick a Reynolds
number and angle of attack. The solver returns the pressure distribution
Cp(x), the lift/drag/moment coefficients, and the boundary-layer state
(momentum and displacement thickness, skin friction, predicted transition)
— the same quantities the classic **XFOIL** workflow produces, computed by
a from-scratch solver in PyTorch that runs on an NVIDIA GPU, its hot loops
hand-written CUDA kernels.

### The solver, in three layers

1. **Geometry repair.** Real-world coordinate files are messy: Lednicer
   two-section layouts, duplicated leading-edge points, reversed winding,
   headers and stray text. The parser detects and repairs all of these
   (the repairs are listed with every result) — on the 1,000-airfoil UIUC
   database this class of repair lifts solver success from ~22% to ~86%.

2. **Inviscid panel method.** The surface is re-paneled with leading- and
   trailing-edge clustering and modeled by linear-strength vortex panels
   with a Kutta condition — a dense linear system solved on the GPU. This
   gives the pressure distribution and the edge velocities.

3. **Viscous boundary layer.** An integral boundary-layer method marches
   from the stagnation point over both surfaces and into the wake:
   Falkner–Skan laminar closures, an e⁹ amplification-envelope transition
   prediction, a lag-dissipation turbulent model, and Squire–Young drag —
   coupled back to the panel method through surface and wake transpiration
   so the displacement effect decambers the flow exactly as in viscous
   reality. When the flow separates massively (deep stall), the viscous
   solve declines to converge and the tool falls back to inviscid mode,
   clearly labeled.

### One-request polars

A sweep over angle of attack is one request: its points are the lanes of
one batched solve, marched side by side by the boundary-layer kernel and
replayed as CUDA graphs, instead of one solver run per point.

### The wind tunnel

The interactive view is a D2Q9 **lattice-Boltzmann** simulation running
server-side on the GPU, a hand-written CUDA kernel, with bounce-back
boundaries on your actual
uploaded geometry — an unsteady, qualitative companion to the
panel-method numbers: watch the stagnation point move, the wake thicken,
and separation creep forward as you pull the nose up.

### Limits worth knowing

- Single-element airfoils only (no slats/flaps — they are detected and
  rejected with a clear message).
- Reynolds 10⁴–10⁷; α −10°…+20° for the API envelope.
- Low-Reynolds laminar-separation-bubble cases are the hardest regime for
  any integral method; expect reduced accuracy below Re ≈ 2×10⁵.
- The lattice-Boltzmann tunnel runs at a lattice Reynolds number of a few
  hundred — its fields are qualitative, not a replacement for the
  boundary-layer solve.
"""
)
