"""semantic_dsp_map_tpu — a JAX (XLA + Pallas) dual-structure-particle
semantic occupancy mapping framework.

Re-designed from scratch with the capabilities of tud-amr/semantic_dsp_map:
an instance-aware, ego-centric semantic occupancy map for dynamic scenes,
built as pure-functional array programs over a device-resident ring-buffer
voxel grid.

Key entry points:
  - ``MapConfig`` / presets: static configuration (grid shape, camera, dataset mode)
  - ``MapState``: the full map state as a pytree of dense arrays
  - ``SemanticDSPMap``: the user-facing map engine (jitted per-frame update)
"""

from .config import MapConfig, FilterParams, kitti360_config, coda_config, virtual_kitti2_config, zed2_config
from .labels import LabelRegistry
from .state import MapState, ObjectTable, init_map_state
from .map import SemanticDSPMap
from .frontend import FrameInput, MaskKpts, rasterize_masks

__version__ = "0.1.0"

__all__ = [
    "MapConfig",
    "FilterParams",
    "kitti360_config",
    "coda_config",
    "virtual_kitti2_config",
    "zed2_config",
    "LabelRegistry",
    "MapState",
    "ObjectTable",
    "init_map_state",
    "SemanticDSPMap",
    "FrameInput",
    "MaskKpts",
    "rasterize_masks",
]
