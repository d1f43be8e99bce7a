"""Voxel-block working sets: the array-program sparsity machinery.

The reference avoids touching its 58.7M particle slots per frame with a
CPU-friendly vertex BFS over frustum voxels (operations.h:1297-1457).  The
array equivalent avoids the primitives whose cost scales with the whole
state rather than with the work:

  - ``jnp.nonzero`` over a [V, K] domain (a full compaction)
  - per-element gathers/scatters on big domains

while exploiting the ones that stream at memory bandwidth:

  - dense elementwise/reduce passes
  - whole-row gathers/scatters
  - multi-operand ``lax.sort`` over a small working set

The resulting pattern, used by visibility/PHD, birth, and object moves:

  1. reduce the per-slot predicate to a per-*block* predicate (dense);
  2. pick active blocks with one tiny argsort over the block count;
  3. row-gather the active blocks' field rows — a dense [A, B] working set;
  4. do all per-particle work inside the working set with dense ops and
     multi-operand sorts (never element gathers on the full state);
  5. row-scatter the modified rows back.

A block is ``block_voxels`` consecutive voxels in storage order (a power of
two), i.e. rows of the reshaped ``[NB, block_voxels * K]`` particle arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig


def block_layout(cfg: MapConfig):
    """(block_voxels, num_blocks, slots_per_block) for this config.

    Block size targets ~256-512 particle slots per row so row gathers move
    whole cache-friendly tiles (last dim a multiple of 128 lanes when K
    allows it).
    """
    K = cfg.slots_per_voxel
    bv = 1
    while bv * 2 * K <= 512 and bv * 2 <= cfg.num_voxels:
        bv *= 2
    return bv, cfg.num_voxels // bv, bv * K


class ActiveBlocks(NamedTuple):
    """Result of :func:`select_blocks`.

    ``ids`` lists active block indices (ascending); padding rows hold
    unique out-of-range values (>= nb) so row gathers read a dummy (clamped)
    and row scatters drop them without violating index uniqueness.  ``count`` is the true number of active blocks; ``overflow`` counts
    blocks that were active but did not fit in the static capacity.
    """

    ids: jax.Array      # i32[A], padded with nb
    count: jax.Array    # i32 scalar
    overflow: jax.Array # i32 scalar


def select_blocks(block_mask: jax.Array, capacity: int) -> ActiveBlocks:
    """Pick the indices of True entries of ``block_mask`` (bool[NB]).

    One small argsort (NB is ~1000x smaller than the slot count); ascending
    ids keep later row gathers sequential.
    """
    nb = block_mask.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (nb, 1), 0).squeeze(-1)
    # Pad keys are nb+idx, NOT a shared sentinel: scatters with
    # unique_indices=True and duplicated (dropped) pad indices are undefined
    # behavior (it has been seen to write a stray copy of an update row).
    key = jnp.where(block_mask, idx, nb + idx)
    order = jnp.sort(key)  # actives (ascending) first, then unique pads
    ids = order[:capacity]
    count = jnp.sum(block_mask.astype(jnp.int32))
    overflow = jnp.maximum(count - capacity, 0)
    return ActiveBlocks(ids=ids, count=jnp.minimum(count, capacity), overflow=overflow)


def mask_to_block_mask(mask_vk: jax.Array, block_voxels: int) -> jax.Array:
    """any() of a per-slot (``[V, K]``) or per-voxel (``[V]``) mask per block."""
    v = mask_vk.shape[0]
    return jnp.any(mask_vk.reshape(v // block_voxels, -1), axis=1)


def gather_rows(field: jax.Array, blocks: ActiveBlocks, block_voxels: int) -> jax.Array:
    """Gather the active blocks' rows of a ``[V, K]`` or ``[V]`` field.

    Returns ``[A, block_voxels * K]`` (or ``[A, block_voxels]``).  Padding
    rows read block 0 (callers mask by ``row_valid``); clamp keeps the gather
    in bounds without a branch.
    """
    v = field.shape[0]
    nb = v // block_voxels
    rows = field.reshape(nb, -1)
    safe = jnp.minimum(blocks.ids, nb - 1)
    return rows[safe]


def row_valid(blocks: ActiveBlocks) -> jax.Array:
    """bool[A]: which rows of a gathered working set are real."""
    a = blocks.ids.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (a, 1), 0).squeeze(-1)
    return idx < blocks.count


def scatter_rows(
    field: jax.Array, blocks: ActiveBlocks, block_voxels: int, values: jax.Array
) -> jax.Array:
    """Write working-set rows back into the full field.

    Padding rows carry id == nb and are dropped by the scatter.  Values are
    cast to the field dtype (working sets compute in i32/f32; narrow storage
    dtypes keep the full-state traffic down).
    """
    v = field.shape[0]
    nb = v // block_voxels
    rows = field.reshape(nb, -1)
    out = rows.at[blocks.ids].set(
        values.reshape(values.shape[0], -1).astype(field.dtype),
        mode="drop",
        unique_indices=True,
    )
    return out.reshape(field.shape)


def slot_coords(cfg: MapConfig, blocks: ActiveBlocks):
    """Voxel index and slot index of every working-set slot, ``[A, BV*K]``.

    Pure index arithmetic (no gathers): slot j of block row b belongs to
    voxel ``ids[b] * BV + j // K``, slot ``j % K``.
    """
    bv, _nb, spb = block_layout(cfg)
    K = cfg.slots_per_voxel
    a = blocks.ids.shape[0]
    j = jax.lax.broadcasted_iota(jnp.int32, (a, spb), 1)
    vox = blocks.ids[:, None] * bv + j // K
    slot = j % K
    return vox, slot


def group_rank(sorted_key: jax.Array) -> jax.Array:
    """Rank of each element within runs of equal keys (input already sorted).

    rank[i] = i - first index of i's run; one associative max-scan.
    """
    n = sorted_key.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    is_start = jnp.concatenate(
        [jnp.ones(1, bool), sorted_key[1:] != sorted_key[:-1]]
    )
    group_start = jax.lax.associative_scan(jnp.maximum, jnp.where(is_start, idx, 0))
    return idx - group_start

def gather_rows_flat(field: jax.Array, blocks: ActiveBlocks, row_len: int) -> jax.Array:
    """Row-gather from the FLAT storage array ([V*K] or [V]) with an
    explicit row length.

    Implemented as a [NB, row_len] reshape followed by a row index; the
    alternative is a sliced gather (vmap of dynamic_slice) with a
    row_len-wide window.  Which lowers faster on the GPU has not been
    measured.  Padding ids read a clamped row (callers mask by
    :func:`row_valid`).
    """
    nbk = field.shape[0] // row_len
    rows = field.reshape(nbk, row_len)
    safe = jnp.minimum(blocks.ids, nbk - 1)
    return rows[safe]


def scatter_rows_flat(
    field: jax.Array, blocks: ActiveBlocks, row_len: int, values: jax.Array
) -> jax.Array:
    """Write working-set rows back into the FLAT storage array (dual of
    :func:`gather_rows_flat`; same measured preference for the reshape-based
    form — see its docstring).  Padding rows carry id >= NB and are dropped
    (unique by construction, :class:`ActiveBlocks`)."""
    nbk = field.shape[0] // row_len
    rows = field.reshape(nbk, row_len)
    out = rows.at[blocks.ids].set(
        values.reshape(values.shape[0], -1).astype(field.dtype),
        mode="drop",
        unique_indices=True,
    )
    return out.reshape(field.shape)
