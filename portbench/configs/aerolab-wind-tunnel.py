"""Plain reference of the ``aerolab-wind-tunnel`` configuration.

A D2Q9 wind tunnel written from the reference viewer's description, in
plain PyTorch and NumPy, and sharing no code with the program: the Selig
parse, the rotation about the quarter chord, the 160-point cosine
re-panelling and the scanline fill of the mask, the lattice step (pull
streaming, half-way bounce-back, zero-gradient outlet, clamped BGK
collision, equilibrium inlet, top and bottom), the pressure forces with
their exponential smoothing, the separation share and the three served
fields. It runs in any floating dtype: float64 is the reference, and
bfloat16 is the control that a correct comparison has to reject.
"""

from __future__ import annotations

import base64
import math
from types import SimpleNamespace

import numpy as np
import torch

E = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
     (1, 1), (-1, 1), (-1, -1), (1, -1))
W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
FACES = ((0, 1), (1, 0), (0, -1), (-1, 0))        # (dy, dx)


def parse_selig(text: str) -> np.ndarray:
    """The (n, 2) float64 loop of a Selig file: every line whose first two
    words are numbers, in order."""
    rows = []
    for line in text.splitlines():
        parts = line.split()
        try:
            rows.append((float(parts[0]), float(parts[1])))
        except (IndexError, ValueError):
            continue
    return np.asarray(rows, np.float64)


def rotate(coords: np.ndarray, alpha_deg: float) -> np.ndarray:
    """The loop turned by ``alpha_deg`` nose up about (0.25, 0)."""
    a = -math.radians(alpha_deg)
    ca, sa = math.cos(a), math.sin(a)
    dx, dy = coords[:, 0] - 0.25, coords[:, 1]
    return np.stack([0.25 + dx * ca - dy * sa, dx * sa + dy * ca], axis=1)


def rotate_in(coords: np.ndarray, alpha_deg: float, dtype) -> np.ndarray:
    """``rotate`` computed in ``dtype``, returned as float64."""
    c = torch.tensor(coords, dtype=dtype)
    a = torch.tensor(-math.radians(alpha_deg), dtype=dtype)
    ca, sa = torch.cos(a), torch.sin(a)
    dx, dy = c[:, 0] - 0.25, c[:, 1]
    out = torch.stack([0.25 + dx * ca - dy * sa, dx * sa + dy * ca], dim=1)
    return out.double().numpy()


def panelise(coords: np.ndarray, n: int = 160):
    """``n + 1`` points spaced by the cosine rule along the arc length."""
    x, y = coords[:, 0], coords[:, 1]
    arc = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
    s = arc[-1] * 0.5 * (1.0 - np.cos(np.pi * np.arange(n + 1) / n))
    return np.interp(s, arc, x), np.interp(s, arc, y)


def scanline(xp, yp, nx: int, ny: int, domain) -> np.ndarray:
    """(ny, nx) float32 mask: on each row's centre line, the cells whose
    centre-line position lies between the 1st and 2nd, 3rd and 4th, ...
    crossings of the polygon, in x order, are solid."""
    dx0, dx1, dy0, dy1 = domain
    mask = np.zeros((ny, nx), np.float32)
    for iy in range(ny):
        wy = dy0 + (iy + 0.5) / ny * (dy1 - dy0)
        cross = []
        for k in range(len(xp) - 1):
            y1, y2 = yp[k], yp[k + 1]
            if (y1 > wy) != (y2 > wy):
                cross.append(xp[k] + (xp[k + 1] - xp[k]) * (wy - y1)
                             / (y2 - y1))
        cross.sort()
        for a, b in zip(cross[0::2], cross[1::2]):
            i0 = max(int(math.ceil((a - dx0) / (dx1 - dx0) * nx)), 0)
            i1 = min(int(math.floor((b - dx0) / (dx1 - dx0) * nx)), nx - 1)
            if i1 >= i0:
                mask[iy, i0:i1 + 1] = 1.0
    return mask


class Tunnel:
    """One session of the tunnel on ``device`` in ``dtype``: the lattice
    starts at the uniform equilibrium of ``u0``; ``frame`` steps it and
    returns what a served frame reports."""

    def __init__(self, coords, cfg: dict, alpha: float, device,
                 dtype=torch.float64, band: float = 0.0):
        self.coords = np.asarray(coords, np.float64)
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.nx, self.ny = cfg["nx"], cfg["ny"]
        self.u0, self.tau = cfg["u0"], cfg["tau"]
        self.chord_cells = self.nx / (cfg["dx1"] - cfg["dx0"])
        opts = dict(dtype=dtype, device=self.device)
        self.ex = torch.tensor([e[0] for e in E], **opts).view(9, 1, 1)
        self.ey = torch.tensor([e[1] for e in E], **opts).view(9, 1, 1)
        self.w = torch.tensor(W, **opts).view(9, 1, 1)
        col = torch.arange(self.nx, device=self.device).expand(self.ny, -1)
        row = torch.arange(self.ny, device=self.device).view(-1, 1)
        self.outlet = col == self.nx - 1
        self.edge = ((col == 0) | (row == 0) | (row == self.ny - 1)) \
            & ~self.outlet
        ones = torch.ones((self.ny, self.nx), **opts)
        self.f = self.equilibrium(ones, ones * self.u0, ones * 0.0)
        one = torch.ones((1, 1), **opts)
        self.f_edge = self.equilibrium(one, one * self.u0, one * 0.0)
        self.step_count = 0
        self.smooth = None
        self.sep_smooth = [0.0, 0.0, 0.0]
        self.bars = (-band * self.u0, 0.0, band * self.u0)
        self.set_alpha(alpha)

    def equilibrium(self, rho, ux, uy):
        eu = self.ex * ux + self.ey * uy
        return self.w * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu
                               - 1.5 * (ux * ux + uy * uy))

    def set_alpha(self, alpha: float):
        """Re-rasterise the body at ``alpha``; the flow is kept. Below
        float64 the outline is turned in the tunnel's dtype."""
        cfg = self.cfg
        self.alpha = alpha
        if self.dtype == torch.float64:
            self.outline = rotate(self.coords, alpha)
        else:
            self.outline = rotate_in(self.coords, alpha, self.dtype)
        mask = scanline(*panelise(self.outline), self.nx, self.ny,
                        (cfg["dx0"], cfg["dx1"], cfg["dy0"], cfg["dy1"]))
        self.solid = torch.tensor(mask, device=self.device) > 0.5
        self.bounce = torch.stack([
            self.solid | torch.roll(self.solid, (ey, ex), (0, 1))
            for ex, ey in E])
        # Each face of the body: a solid cell whose neighbour (-dy, -dx)
        # away is fluid.
        self.faces = [((-dy, -dx), self.solid
                       & ~torch.roll(self.solid, (-dy, -dx), (0, 1)))
                      for dy, dx in FACES]
        self.surface = int(sum(int(face.sum()) for _, face in self.faces))

    def step(self):
        f = self.f
        pulled = torch.stack([torch.roll(f[i], (ey, ex), (0, 1))
                              for i, (ex, ey) in enumerate(E)])
        fin = torch.where(self.bounce, f[list(OPP)], pulled)
        fin = torch.where(self.outlet, torch.roll(f, 1, 2), fin)
        rho = fin.sum(0)
        ux = (fin * self.ex).sum(0) / rho
        uy = (fin * self.ey).sum(0) / rho
        spd = torch.sqrt(ux * ux + uy * uy)
        u_max = self.cfg["u_max"]
        scale = torch.where(spd > u_max, u_max / spd.clamp(min=1e-12), 1.0)
        feq = self.equilibrium(
            rho.clamp(self.cfg["rho_min"], self.cfg["rho_max"]),
            ux * scale, uy * scale)
        out = torch.where(self.solid | self.outlet, fin,
                          fin - (fin - feq) / self.tau)
        self.f = torch.where(self.edge & ~self.solid, self.f_edge, out)

    def macro(self):
        rho = self.f.sum(0)
        return rho, (self.f * self.ex).sum(0) / rho, \
            (self.f * self.ey).sum(0) / rho

    def frame(self, steps: int, want_fields: bool) -> dict:
        """Advance ``steps``; the smoothed forces, the separation share,
        the step count and, where asked, (speed, ux, uy) as float64 numpy
        with NaN on the body."""
        for _ in range(steps):
            self.step()
        self.step_count += steps
        rho, ux, uy = self.macro()
        p = rho / 3.0
        sums = []
        for nb, face in self.faces:
            sums.append(torch.where(face, torch.roll(p, nb, (0, 1)),
                                    0.0).sum().double())
            nb_ux = torch.roll(ux, nb, (0, 1))
            for bar in self.bars:
                sums.append((face & (nb_ux < bar)).sum().double())
        face_p = torch.stack(sums).tolist()
        fx = fy = 0.0
        for (dy, dx), fp in zip(FACES, face_p[0::4]):
            fx -= fp * dx
            fy -= fp * dy
        # The separation share counting reversed flow below each bar: at
        # -eps, 0 and +eps (``separation_band``), each smoothed alike.
        seps = [sum(face_p[k::4]) / max(self.surface, 1) for k in (1, 2, 3)]
        q = 0.5 * self.u0 * self.u0 * self.chord_cells
        cl, cd = fy / q, fx / q
        if self.smooth is None:
            self.smooth = [cl, cd]
        else:
            self.smooth = [0.9 * self.smooth[0] + 0.1 * cl,
                           0.9 * self.smooth[1] + 0.1 * cd]
        self.sep_smooth = [0.85 * a + 0.15 * b
                           for a, b in zip(self.sep_smooth, seps)]
        out = {"cl": self.smooth[0], "cd": max(self.smooth[1], 0.0),
               "separation": self.sep_smooth[1],
               "separation_band": (self.sep_smooth[0], self.sep_smooth[2]),
               "step": self.step_count}
        if want_fields:
            body = self.solid.cpu().numpy()
            fields = {"speed": torch.sqrt(ux * ux + uy * uy) / self.u0,
                      "ux": ux, "uy": uy}
            out["fields"] = {}
            for name, v in fields.items():
                a = v.double().cpu().numpy()
                a[body] = np.nan
                out["fields"][name] = a
        return out


FIELDS = {"speed": 1.0, "ux": None, "uy": None}   # None: scaled by u0
ROUNDING = 5e-5           # the service rounds cl, cd and separation to 1e-4


def decode(field: dict) -> np.ndarray:
    """A served field (base64 float32 bytes with its shape) as float64."""
    if field.get("dtype") != "float32":
        raise ValueError(f"field dtype {field.get('dtype')!r}")
    raw = np.frombuffer(base64.b64decode(field["data"]), np.float32)
    return raw.reshape(field["shape"]).astype(np.float64)


def encode(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a, np.float32)
    return {"shape": list(a.shape), "dtype": "float32",
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def session_start(setup: list) -> tuple[str, float]:
    """(Selig text, angle) of the session that a client's set-up opened."""
    start = next(r for r in setup if r.route == "/lbm/start")
    return start.files["file"][1].decode(), float(start.fields["alpha"])


def numbers(clients: list, cfg: dict, device,
            dtype=torch.float64) -> dict:
    """Follow each client's served session in the reference and compare
    every frame with it: a client holds its set-up's requests (``setup``)
    and, in order, its window's (``window``), each with its form as sent
    (``fields``, ``files``) and its parsed reply (``reply``, None where none
    came), the sampled frames' with their fields. Returns the worst reading
    of each number compared."""
    worst = {"step_or_alpha_wrong": 0, "body_cells_wrong": 0,
             "field_err": 0.0, "force_err": 0.0, "separation_err": 0.0,
             "outline_err": 0.0}
    for client in clients:
        _follow(client, cfg, device, dtype, worst)
    return worst


def _follow(client, cfg: dict, device, dtype, worst: dict):
    lat = cfg["lattice"]
    text, alpha0 = session_start(client.setup)
    tunnel = Tunnel(parse_selig(text), lat, alpha0, device, dtype,
                    cfg["separation_band_u0"])
    for rec in client.window:
        if rec.route != "/lbm/frame":
            continue
        alpha, reply = float(rec.fields["alpha"]), rec.reply
        if abs(alpha - tunnel.alpha) > 1e-6:
            tunnel.set_alpha(alpha)
        want = reply is not None and "fields" in reply
        ref = tunnel.frame(lat["steps_per_frame"], want)
        if reply is None:       # a failed request, counted by the harness
            continue
        if reply["step"] != ref["step"] or reply["alpha"] != alpha:
            worst["step_or_alpha_wrong"] += 1
        worst["force_err"] = max(worst["force_err"],
                                 abs(reply["cl"] - ref["cl"]),
                                 abs(reply["cd"] - ref["cd"]))
        lo, hi = ref["separation_band"]
        worst["separation_err"] = max(
            worst["separation_err"], lo - ROUNDING - reply["separation"],
            reply["separation"] - hi - ROUNDING)
        outline = np.asarray(reply["outline"], np.float64)
        worst["outline_err"] = max(worst["outline_err"], float(
            np.abs(outline - tunnel.outline).max())
            if outline.shape == tunnel.outline.shape else math.inf)
        if not want:
            continue
        for name, scale in FIELDS.items():
            got, exp = decode(reply["fields"][name]), ref["fields"][name]
            if got.shape != exp.shape:
                worst["body_cells_wrong"] += exp.size
                continue
            worst["body_cells_wrong"] += int(
                (np.isnan(got) != np.isnan(exp)).sum())
            both = ~(np.isnan(got) | np.isnan(exp))
            err = np.abs(got[both] - exp[both]).max() / (scale or lat["u0"])
            worst["field_err"] = max(worst["field_err"], float(err))


def served(setup: list, requests: list, keep: set, cfg: dict, device,
           dtype) -> list:
    """The frames that the reference in ``dtype`` serves for a client's
    window ``requests`` after its ``setup``, rounded and encoded as the
    service does, with the fields of the frames in ``keep``: the control
    puts these in the program's place."""
    lat = cfg["lattice"]
    text, alpha0 = session_start(setup)
    tunnel = Tunnel(parse_selig(text), lat, alpha0, device, dtype)
    frames = []
    for k, req in enumerate(requests):
        alpha = float(req.fields["alpha"])
        if abs(alpha - tunnel.alpha) > 1e-6:
            tunnel.set_alpha(alpha)
        out = tunnel.frame(lat["steps_per_frame"], k in keep)
        reply = {"cl": round(out["cl"], 4), "cd": round(out["cd"], 4),
                 "separation": round(out["separation"], 4),
                 "step": out["step"], "alpha": alpha,
                 "outline": tunnel.outline.round(5).tolist()}
        if k in keep:
            reply["fields"] = {n: encode(a) for n, a in out["fields"].items()}
        frames.append(SimpleNamespace(route=req.route, fields=req.fields,
                                     reply=reply))
    return frames
