"""Joukowski airfoils with their exact potential-flow solution: a copy of
``airfoil_tpu/models/joukowski.py`` (NumPy, float64), kept so that the port
imports nothing of the JAX package.

The conformal map z = zeta + c^2/zeta sends a circle through zeta = c to an
airfoil with a cusped trailing edge, and the flow around the circle is known
in closed form — so surface Cp and CL are EXACT, with no transcription or
discretization error. This is the framework's manufactured-solution truth
for the inviscid panel layer: the reference validates its solver chain only
statistically (1,000-airfoil convergence benchmark,
reference benchmark/airfoil_parser_benchmark.py:484-560) because its solver
is the closed-source XFOIL binary; here the solver is ours, so it is held
to an analytic standard instead.

Conventions: unit freestream, TE preimage at zeta = c = 1, circle center
``mu`` (Re mu < 0 thickens, Im mu > 0 cambers), radius R = |c - mu|.
"""

from __future__ import annotations

import numpy as np

__all__ = ["joukowski", "joukowski_exact"]

_C = 1.0  # TE preimage


def _circle(mu: complex, n: int, theta_te_offset: float = 0.0):
    """Preimage circle points, Selig-ordered (TE -> upper -> LE -> lower).

    The TE (zeta = c) corresponds to angle theta_te on the circle; walking
    the angle from theta_te upward by 2*pi traces TE -> upper surface ->
    LE -> lower surface -> TE, which after mapping is the Selig loop order
    used everywhere else in the framework.
    """
    r = abs(_C - mu)
    theta_te = np.angle(_C - mu)
    t = theta_te + theta_te_offset + np.linspace(0.0, 2.0 * np.pi, n)
    return mu + r * np.exp(1j * t)


def joukowski(mu_x: float = -0.08, mu_y: float = 0.04, n: int = 201,
              cosine: bool = True) -> np.ndarray:
    """Joukowski airfoil coordinates, Selig-ordered, chord-normalised.

    ``cosine=True`` clusters points at the LE/TE like standard `.dat`
    distributions. Returns an (n, 2) float array with x in [0, 1].
    """
    mu = complex(mu_x, mu_y)
    if cosine:
        # Cosine clustering in the circle angle: dense near TE and LE.
        u = np.linspace(0.0, 2.0 * np.pi, n)
        t = u - 0.5 * np.sin(2.0 * u)  # extra density at both ends + middle
        r = abs(_C - mu)
        theta_te = np.angle(_C - mu)
        zeta = mu + r * np.exp(1j * (theta_te + t))
    else:
        zeta = _circle(mu, n)
    z = zeta + _C**2 / zeta
    x, y = z.real, z.imag
    # Chord-normalise to x in [0, 1].
    x_le, x_te = x.min(), x[0]
    chord = x_te - x_le
    return np.stack([(x - x_le) / chord, y / chord], axis=1)


def joukowski_exact(mu_x: float, mu_y: float, alpha_deg: float,
                    n: int = 401, te_margin: float = 1e-3):
    """Exact surface solution for the Joukowski airfoil.

    Returns a dict with chord-normalised surface ``x``, ``y``, exact ``cp``,
    exact surface speed ``q`` (|V|/U_inf), and exact ``cl``.

    ``te_margin`` excludes a small angular neighbourhood of the cusped TE
    where the mapped speed is a 0/0 limit (the physical value there is
    finite but the quotient is numerically indeterminate).

    Flow model: unit freestream at ``alpha_deg`` past the circle with the
    Kutta circulation; velocities map by W_z = W_zeta / (dz/dzeta).
    """
    mu = complex(mu_x, mu_y)
    alpha = np.deg2rad(alpha_deg)
    r = abs(_C - mu)
    theta_te = np.angle(_C - mu)

    # Kutta condition: stagnation at the TE preimage.
    gamma = 4.0 * np.pi * r * np.sin(theta_te - alpha)

    t = theta_te + np.linspace(te_margin, 2.0 * np.pi - te_margin, n)
    zeta = mu + r * np.exp(1j * t)

    dz = zeta - mu
    w_zeta = (np.exp(-1j * alpha)
              - r**2 * np.exp(1j * alpha) / dz**2
              - 1j * gamma / (2.0 * np.pi * dz))
    dzdzeta = 1.0 - _C**2 / zeta**2
    w_z = w_zeta / dzdzeta
    q = np.abs(w_z)
    cp = 1.0 - q**2

    z = zeta + _C**2 / zeta
    x, y = z.real, z.imag
    # Same chord normalisation as `joukowski` (TE at the t=0 end).
    zeta_te = mu + r * np.exp(1j * theta_te)
    x_te = (zeta_te + _C**2 / zeta_te).real
    u_full = np.linspace(0.0, 2.0 * np.pi, 2049)
    zeta_f = mu + r * np.exp(1j * (theta_te + u_full))
    x_le = (zeta_f + _C**2 / zeta_f).real.min()
    chord = x_te - x_le

    # Exact lift: Kutta-Joukowski, L' = -rho U Gamma for counterclockwise-
    # positive Gamma (a lifting airfoil carries clockwise circulation).
    cl = -2.0 * gamma / chord

    return {
        "x": (x - x_le) / chord,
        "y": y / chord,
        "q": q,
        "cp": cp,
        "cl": cl,
        "chord": chord,
    }
