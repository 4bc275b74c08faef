"""HTTP API of the port: ``minihttp`` serves every route of the reference's
service (``/upload_airfoil/``, ``/polar/``, ``/batch/``, ``/stats``,
``/health``, ``/app`` and the wind tunnel's ``/lbm/*``) through
``handlers``."""

from airfoil_tpu_torch.api import handlers
from airfoil_tpu_torch.api.minihttp import make_server, serve

__all__ = ["handlers", "make_server", "serve"]
