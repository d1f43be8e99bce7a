"""Voxel-grid sharding over a device mesh.

The reference is a single-process CPU library whose only concurrency is a
2-thread spatially-partitioned BFS (mt_operations.h:110-174).  The
scale-out here replaces that with SPMD over a 1-D ``grid`` mesh axis
(SURVEY.md section 2.3):

  - every per-voxel array ([V, ...]: particle SoA, voxel stamps, render
    outputs) is sharded on its leading voxel dimension — since the flat voxel
    index is z-major (codecs.ring_to_voxel), this shards the grid by z-slabs;
  - the image-space accumulators (ck_kappa [H, W]) and the tiny object table
    are replicated; XLA's SPMD partitioner inserts the psum over shards for
    the pass-A scatter-add — the analog of the halo/collective design in
    context parallelism;
  - scroll state is O(N_axis) and replicated; the scroll itself stays pure
    index arithmetic on every shard.

The per-frame update is the *same* pure function as single-chip
(map.build_frame_step's body); only in/out shardings differ.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterParams, MapConfig
from ..labels import LabelRegistry
from ..state import MapState


def make_mesh(n_devices: Optional[int] = None, axis: str = "grid") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                "requested a %d-device mesh but only %d device(s) are "
                "available (set XLA_FLAGS=--xla_force_host_platform_device_"
                "count=N and force the CPU backend to emulate a mesh)"
                % (n_devices, len(devices))
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def _shard_rule(cfg: MapConfig, mesh: Mesh, leaf: jax.ShapeDtypeStruct):
    """Shard the voxel dimension wherever it appears: dim of size V
    (voxel_stamp, render outputs) or V*K (the flat particle storage —
    voxel-major, so an even split keeps whole voxels per shard)."""
    axis = mesh.axis_names[0]
    shape = getattr(leaf, "shape", ())
    vk = cfg.num_voxels * cfg.slots_per_voxel
    for d, size in enumerate(shape):
        if size in (cfg.num_voxels, vk) and size % mesh.devices.size == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return NamedSharding(mesh, P(*spec))
    return NamedSharding(mesh, P())


def state_shardings(cfg: MapConfig, mesh: Mesh, state: MapState):
    """Sharding pytree for MapState: [V, ...] arrays split over the mesh."""
    return jax.tree_util.tree_map(lambda leaf: _shard_rule(cfg, mesh, leaf), state)


def shard_state(cfg: MapConfig, mesh: Mesh, state: MapState) -> MapState:
    sh = state_shardings(cfg, mesh, state)
    return jax.tree_util.tree_map(jax.device_put, state, sh)


def build_sharded_step(
    cfg: MapConfig,
    params: FilterParams,
    registry: LabelRegistry,
    mesh: Mesh,
    example_state: MapState,
):
    """jit the frame step with explicit grid shardings.

    Returns (step_fn, sharded initial-state placer).
    """
    from ..map import build_frame_step

    # Reuse the single-chip step body; build_frame_step returns a jitted fn,
    # so grab the underlying function for re-jitting with shardings.
    jitted = build_frame_step(cfg, params, registry)
    fun = jitted.__wrapped__

    st_sh = state_shardings(cfg, mesh, example_state)
    repl = NamedSharding(mesh, P())
    frame_struct = _example_frame_struct(cfg)
    frame_sh = jax.tree_util.tree_map(lambda _: repl, frame_struct)

    # Pin the OUTPUT shardings too: without them the
    # compiler is free to lay small outputs out sharded/permuted, and feeding
    # the returned state back into the next frame then fails the in_shardings
    # check.  The new state must carry exactly the input-state shardings; the
    # render result shards wherever a voxel dimension appears; diagnostics
    # replicate.
    state_struct = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), example_state
    )
    out_struct = jax.eval_shape(fun, state_struct, frame_struct)
    out_sh = jax.tree_util.tree_map(
        lambda leaf: _shard_rule(cfg, mesh, leaf), out_struct
    )

    return jax.jit(
        fun, in_shardings=(st_sh, frame_sh), out_shardings=out_sh,
        donate_argnums=0,
    )


def _example_frame_struct(cfg: MapConfig):
    """Abstract FrameInput shapes for eval_shape/sharding trees."""
    import jax.numpy as jnp

    from ..frontend import FrameInput

    I, Kp = cfg.max_instances_per_frame, cfg.max_keypoints
    H, W = cfg.height, cfg.width
    f32, i32 = jnp.float32, jnp.int32
    s = jax.ShapeDtypeStruct
    return FrameInput(
        depth=s((H, W), f32),
        track_raster=s((H, W), i32),
        track_label_table=s((65536,), i32),
        inst_valid=s((I,), jnp.bool_),
        inst_track=s((I,), i32),
        inst_label=s((I,), i32),
        kpts_curr=s((I, Kp, 3), f32),
        kpts_prev=s((I, Kp, 3), f32),
        kpts_count=s((I,), i32),
        inst_bbox_min=s((65536, 3), f32),
        inst_bbox_max=s((65536, 3), f32),
        cam_pos=s((3,), f32),
        cam_quat=s((4,), f32),
        time=s((), f32),
    )
