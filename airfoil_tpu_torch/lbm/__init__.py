from airfoil_tpu_torch.lbm.core import (
    D2Q9_E,
    D2Q9_W,
    D2Q9_OPP,
    equilibrium_init,
    lbm_step,
)
from airfoil_tpu_torch.lbm.masks import rasterize_airfoil, build_mask
from airfoil_tpu_torch.lbm.diagnostics import forces_and_separation, render_fields
from airfoil_tpu_torch.lbm.kernel import (cell_word, lbm_steps, lbm_steps_tiled,
                                          prefers_tiled)
from airfoil_tpu_torch.lbm.runner import LBMState, WindTunnel
from airfoil_tpu_torch.lbm.bench import bench_mlups
from airfoil_tpu_torch.lbm.sharded import dryrun_sharded_step, sharded_lbm_steps

__all__ = [
    "D2Q9_E", "D2Q9_W", "D2Q9_OPP",
    "equilibrium_init", "lbm_step",
    "rasterize_airfoil", "build_mask",
    "forces_and_separation", "render_fields",
    "cell_word", "lbm_steps", "lbm_steps_tiled", "prefers_tiled",
    "LBMState", "WindTunnel",
    "bench_mlups",
    "dryrun_sharded_step", "sharded_lbm_steps",
]
