"""Map state as a pytree of dense arrays.

This is the array-program replacement for the reference's global mutable storage:
  - ``PARTICLE_ARRAY`` (buffer.h:86) -> particle SoA arrays of shape [V, K]
    (voxel-major, K = 2^n - 1 real slots; the reference's slot-0 "time
    particle" becomes the separate ``voxel_stamp`` array);
  - ring-buffer scroll state (buffer.h:97-120) -> small scalar/1-D arrays;
  - ``ObjectSet``'s hash maps (object_layer.h:345-424) -> a fixed-capacity
    :class:`ObjectTable` with a validity mask;
  - ``ObjectParticleHashMap`` (object_layer.h:20-52) -> no explicit structure:
    particle<->object association is the predicate ``particles.track == id``.

Everything is functional: the per-frame update maps ``MapState -> MapState``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .config import MapConfig

# Particle status codes (buffer.h:43-50; TIMEPTC is not needed because the
# time particle is the separate voxel_stamp array).
STATUS_INVALID = 0
STATUS_UPDATED = 1
STATUS_REGULAR_BORN = 2
STATUS_GUESSED_BORN = 3
STATUS_COPIED = 4


def pytree_dataclass(cls):
    """A frozen dataclass registered as a pytree whose fields are all
    children, with a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class Particles:
    """SoA particle storage, FLAT shape [V*K] (voxel-major, K slots/voxel).

    Flat 1-D buffers have a linear layout.  Ops reshape to [V, K] views
    INSIDE jit (a free bitcast from linear) via :func:`particles_vk` and
    flatten results back with :func:`particles_flat`, so no [V, K] layout
    with the tiny K minor ever crosses the jit boundary.

    Positions are three SEPARATE arrays, so no array pairs the tiny xyz
    axis with the particle dimension.
    """

    px: jax.Array       # f32[V*K] global-frame position x
    py: jax.Array       # f32[V*K]
    pz: jax.Array       # f32[V*K]
    weight: jax.Array   # f32[V*K]
    label: jax.Array    # u8[V*K] semantic label id (buffer.h:66 u16, values <= 255)
    track: jax.Array    # u16[V*K] instance / track id (buffer.h:65)
    status: jax.Array   # u8[V*K] STATUS_* (buffer.h:69 u8)
    forget: jax.Array   # u8[V*K] forgetting counter (buffer.h:70 u8)
    stamp: jax.Array    # i32[V*K] birth/update time stamp (u16 in buffer.h:64;
                        #          widened — no wraparound handling needed)


def particles_vk(cfg: MapConfig, p: Particles) -> Particles:
    """[V, K]-shaped views of the flat storage (free bitcast inside jit)."""
    V, K = cfg.num_voxels, cfg.slots_per_voxel
    return Particles(
        px=p.px.reshape(V, K), py=p.py.reshape(V, K), pz=p.pz.reshape(V, K),
        weight=p.weight.reshape(V, K), label=p.label.reshape(V, K),
        track=p.track.reshape(V, K), status=p.status.reshape(V, K),
        forget=p.forget.reshape(V, K), stamp=p.stamp.reshape(V, K),
    )


def particles_vk_sized(p: Particles, V: int, K: int) -> Particles:
    """[V, K]-shaped views with explicit sizes (slab-local working copies in
    parallel/shard_step.py have V = num_voxels / n_devices)."""
    return Particles(
        px=p.px.reshape(V, K), py=p.py.reshape(V, K), pz=p.pz.reshape(V, K),
        weight=p.weight.reshape(V, K), label=p.label.reshape(V, K),
        track=p.track.reshape(V, K), status=p.status.reshape(V, K),
        forget=p.forget.reshape(V, K), stamp=p.stamp.reshape(V, K),
    )


def particles_flat(p: Particles) -> Particles:
    """Flatten a [V, K]-view Particles back to storage shape."""
    return Particles(
        px=p.px.reshape(-1), py=p.py.reshape(-1), pz=p.pz.reshape(-1),
        weight=p.weight.reshape(-1), label=p.label.reshape(-1),
        track=p.track.reshape(-1), status=p.status.reshape(-1),
        forget=p.forget.reshape(-1), stamp=p.stamp.reshape(-1),
    )


@pytree_dataclass
class ScrollState:
    """Ego-centric ring-buffer scroll state (buffer.h:97-120).

    The map is a fixed torus of voxels; moving the ego only changes these
    index offsets and stamps wrapped-out voxel *columns* per axis — no data
    is ever moved (operations.h:1111-1191).
    """

    ego_pos: jax.Array        # f32[3] current ego/camera position (global)
    map_center: jax.Array     # f32[3] voxel-quantized map center (global)
    moved_steps: jax.Array    # i32[3] total voxel steps moved per axis
    equiv_steps: jax.Array    # i32[3] moved_steps mod axis length (C-style)
    axis_stamp_x: jax.Array   # i32[Nx] wrap-out time stamps per x ring column
    axis_stamp_y: jax.Array   # i32[Ny]
    axis_stamp_z: jax.Array   # i32[Nz]


@pytree_dataclass
class ObjectTable:
    """Fixed-capacity object layer (replaces object_layer.h:345-648).

    All arrays have leading dim O = config.max_objects; ``valid`` masks live
    rows.  The transform window (object_layer.h:203-297) is stored as a
    rolling buffer of the last W transforms per object.
    """

    valid: jax.Array             # bool[O]
    track_id: jax.Array          # i32[O]
    label: jax.Array             # i32[O]
    last_obs_step: jax.Array     # i32[O] observation_time_step
    obs_count: jax.Array         # i32[O]
    moved_probability: jax.Array # f32[O] Bayesian moving belief (init 0.5)
    moving: jax.Array            # bool[O] rigidbody_moved_vec[0]
    has_moved_record: jax.Array  # bool[O] rigidbody_moved_vec non-empty
    tmatrix: jax.Array           # f32[O, 4, 4] current rigid transform
    has_tmatrix: jax.Array       # bool[O]
    reference_point: jax.Array   # f32[O, 3]
    to_match_templates: jax.Array  # bool[O]
    to_match_previous: jax.Array   # bool[O]

    # Transform window for velocity estimation (object_layer.h:203-297).
    win_tmatrix: jax.Array       # f32[O, W, 4, 4]
    win_dt: jax.Array            # f32[O, W]
    win_ref: jax.Array           # f32[O, W, 3]
    win_stamp: jax.Array         # i32[O, W]
    win_count: jax.Array         # i32[O] number of live window entries

    velocity: jax.Array          # f32[O, 3] translational velocity estimate
    vel_valid: jax.Array         # bool[O] (MotionEstimation "updated_" flag)

    # ZED2 keypoint caches (semantic_dsp_map.h:267-271).
    last_kpts: jax.Array         # f32[O, 4, 3]
    last_kpts_time: jax.Array    # f32[O]
    has_last_kpts: jax.Array     # bool[O]
    key_kpts: jax.Array          # f32[O, 4, 3]
    key_kpts_time: jax.Array     # f32[O]


@pytree_dataclass
class MapState:
    particles: Particles
    voxel_stamp: jax.Array   # i32[V] observation stamp of each voxel
                             # (the reference's slot-0 time particle,
                             # buffer.h:57-79; 0 == never observed)
    scroll: ScrollState
    objects: ObjectTable
    global_time: jax.Array   # i32 scalar frame counter (data_base.h:22)
    prev_frame_time: jax.Array  # f32 scalar wall time of previous frame
    rng: jax.Array           # jax.random key


def init_particles(cfg: MapConfig) -> Particles:
    n = cfg.num_voxels * cfg.slots_per_voxel
    return Particles(
        px=jnp.zeros(n, jnp.float32),
        py=jnp.zeros(n, jnp.float32),
        pz=jnp.zeros(n, jnp.float32),
        weight=jnp.zeros(n, jnp.float32),
        label=jnp.zeros(n, jnp.uint8),
        track=jnp.zeros(n, jnp.uint16),
        status=jnp.zeros(n, jnp.uint8),
        forget=jnp.zeros(n, jnp.uint8),
        stamp=jnp.zeros(n, jnp.int32),
    )


def init_scroll(cfg: MapConfig) -> ScrollState:
    return ScrollState(
        ego_pos=jnp.zeros(3, jnp.float32),
        map_center=jnp.zeros(3, jnp.float32),
        moved_steps=jnp.zeros(3, jnp.int32),
        equiv_steps=jnp.zeros(3, jnp.int32),
        axis_stamp_x=jnp.zeros(cfg.nx, jnp.int32),
        axis_stamp_y=jnp.zeros(cfg.ny, jnp.int32),
        axis_stamp_z=jnp.zeros(cfg.nz, jnp.int32),
    )


def init_objects(cfg: MapConfig) -> ObjectTable:
    O, W = cfg.max_objects, cfg.transform_window
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (O, 4, 4))
    return ObjectTable(
        valid=jnp.zeros(O, bool),
        track_id=jnp.full(O, -1, jnp.int32),
        label=jnp.zeros(O, jnp.int32),
        last_obs_step=jnp.zeros(O, jnp.int32),
        obs_count=jnp.zeros(O, jnp.int32),
        moved_probability=jnp.full(O, 0.5, jnp.float32),
        moving=jnp.zeros(O, bool),
        has_moved_record=jnp.zeros(O, bool),
        tmatrix=eye,
        has_tmatrix=jnp.zeros(O, bool),
        reference_point=jnp.zeros((O, 3), jnp.float32),
        to_match_templates=jnp.zeros(O, bool),
        to_match_previous=jnp.zeros(O, bool),
        win_tmatrix=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (O, W, 4, 4)),
        win_dt=jnp.zeros((O, W), jnp.float32),
        win_ref=jnp.zeros((O, W, 3), jnp.float32),
        win_stamp=jnp.zeros((O, W), jnp.int32),
        win_count=jnp.zeros(O, jnp.int32),
        velocity=jnp.zeros((O, 3), jnp.float32),
        vel_valid=jnp.zeros(O, bool),
        last_kpts=jnp.zeros((O, 4, 3), jnp.float32),
        last_kpts_time=jnp.zeros(O, jnp.float32),
        has_last_kpts=jnp.zeros(O, bool),
        key_kpts=jnp.zeros((O, 4, 3), jnp.float32),
        key_kpts_time=jnp.zeros(O, jnp.float32),
    )


def init_map_state(cfg: MapConfig, seed: int = 0) -> MapState:
    """Build a cleared map (operations.h:684-767 initialize/clear analog).

    Unlike the reference's 290 ms serial fill of 67M particle structs
    (operations.h:700), this is a handful of broadcasted zero-fills.
    """
    return MapState(
        particles=init_particles(cfg),
        voxel_stamp=jnp.zeros(cfg.num_voxels, jnp.int32),
        scroll=init_scroll(cfg),
        objects=init_objects(cfg),
        global_time=jnp.zeros((), jnp.int32),
        prev_frame_time=jnp.zeros((), jnp.float32),
        rng=jax.random.PRNGKey(seed),
    )


def clear_map_state(state: MapState, cfg: MapConfig) -> MapState:
    """SemanticDSPMap::clear analog (semantic_dsp_map.h:74-81): wipe particles,
    voxel stamps and the object set; retain the scroll position (the
    reference's RingBufferOperations::clear keeps buffer_moved_steps,
    operations.h:683-723, but resets stamps and global time)."""
    return state.replace(
        particles=init_particles(cfg),
        voxel_stamp=jnp.zeros(cfg.num_voxels, jnp.int32),
        objects=init_objects(cfg),
        global_time=jnp.zeros((), jnp.int32),
        scroll=state.scroll.replace(
            axis_stamp_x=jnp.zeros(cfg.nx, jnp.int32),
            axis_stamp_y=jnp.zeros(cfg.ny, jnp.int32),
            axis_stamp_z=jnp.zeros(cfg.nz, jnp.int32),
        ),
    )
