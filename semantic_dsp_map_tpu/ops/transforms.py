"""Rigid transform estimation: masked Kabsch/SVD fit and batched RANSAC.

Batched equivalents of estimateTransformation (basic_algorithms.h:56-95)
and estimateTransformationRANSAC (basic_algorithms.h:106-195).  The reference
runs a serial hypothesis loop with rejection-sampled index triples; here all
hypotheses are evaluated as one batched 3x3-SVD problem, and distinct random
triples are drawn with the Gumbel-top-k trick so degenerate duplicate samples
cannot occur (the reference rejects duplicates in a while loop,
basic_algorithms.h:118-123).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .geometry import HIGHEST, mm


def kabsch(P, Q, mask):
    """Masked rigid fit Q ~ R @ P + t (basic_algorithms.h:56-95).

    Args:
      P, Q: f32[..., N, 3] point sets (last-frame, current-frame).
      mask: bool[..., N] valid points.

    Returns (T f32[..., 4, 4], ok bool[...]).
    """
    m = mask.astype(jnp.float32)[..., None]
    cnt = jnp.maximum(jnp.sum(m, axis=-2), 1e-9)
    cp = jnp.sum(P * m, axis=-2) / cnt
    cq = jnp.sum(Q * m, axis=-2) / cnt
    Pc = (P - cp[..., None, :]) * m
    Qc = (Q - cq[..., None, :]) * m

    # Cross-covariance H = Pc^T Qc (3x3).
    H = jnp.einsum("...ni,...nj->...ij", Pc, Qc, precision=HIGHEST)

    U, _, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    R = mm(V, jnp.swapaxes(U, -1, -2))
    det = jnp.linalg.det(R)
    # Reflection fix: flip the third column of V (basic_algorithms.h:81-84).
    Vfix = V.at[..., :, 2].multiply(jnp.where(det < 0, -1.0, 1.0)[..., None])
    R = mm(Vfix, jnp.swapaxes(U, -1, -2))

    t = cq - jnp.einsum("...ij,...j->...i", R, cp, precision=HIGHEST)

    T = jnp.zeros(P.shape[:-2] + (4, 4), jnp.float32)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    ok = jnp.sum(mask, axis=-1) >= 3
    return T, ok


def apply_transform(T, pts):
    """T[..., 4, 4] applied to pts[..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts, precision=HIGHEST) + t[..., None, :]


def _normalize(v, eps=1e-12):
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True) + eps)


def _triangle_frame(p1, p2, p3):
    """Orthonormal frame of a point triple (Gram-Schmidt on the edges)."""
    e1 = _normalize(p2 - p1)
    u = p3 - p1
    e2 = _normalize(u - jnp.sum(u * e1, axis=-1, keepdims=True) * e1)
    e3 = jnp.cross(e1, e2)
    return jnp.stack([e1, e2, e3], axis=-1)  # [..., 3, 3] columns = frame


def triangle_fit(Ps, Qs):
    """Exact rigid fit of 3-point correspondences, closed form.

    For an exact correspondence this equals the SVD/Kabsch fit; for noisy
    triples it differs within the RANSAC inlier tolerance.  Used for the
    RANSAC *hypotheses* because batched 3x3 SVDs (32 instances x 100
    hypotheses) would dominate the object-layer cost; the final refit still
    uses the masked Kabsch SVD.

    Degenerate (collinear) samples produce non-finite frames; callers mask.
    Args: Ps, Qs f32[..., 3, 3] (3 points each).  Returns T f32[..., 4, 4].
    """
    Fp = _triangle_frame(Ps[..., 0, :], Ps[..., 1, :], Ps[..., 2, :])
    Fq = _triangle_frame(Qs[..., 0, :], Qs[..., 1, :], Qs[..., 2, :])
    R = mm(Fq, jnp.swapaxes(Fp, -1, -2))
    cp = jnp.mean(Ps, axis=-2)
    cq = jnp.mean(Qs, axis=-2)
    t = cq - jnp.einsum("...ij,...j->...i", R, cp, precision=HIGHEST)
    T = jnp.zeros(Ps.shape[:-2] + (4, 4), jnp.float32)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    ok = jnp.all(jnp.isfinite(T.reshape(T.shape[:-2] + (16,))), axis=-1)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), T.shape)
    return jnp.where(ok[..., None, None], T, eye)


def ransac_transform(
    rng: jax.Array,
    P: jax.Array,        # f32[N, 3]
    Q: jax.Array,        # f32[N, 3]
    mask: jax.Array,     # bool[N]
    n_iter: int,
    threshold: float,
    refit_with_inliers: bool,
):
    """estimateTransformationRANSAC (basic_algorithms.h:106-195), batched.

    Returns (T, inlier_mask, n_inliers, mse_inliers, first_inlier_idx).
    The reference's early break at >90% inliers only saves time, not changing
    the argmax result given identical hypotheses, so it is dropped.
    """
    N = P.shape[0]

    # Distinct random triples per hypothesis via Gumbel top-k over valid pts.
    g = jax.random.gumbel(rng, (n_iter, N))
    g = jnp.where(mask[None, :], g, -jnp.inf)
    _, triple_idx = jax.lax.top_k(g, 3)  # i32[n_iter, 3]

    Ps = P[triple_idx]  # [n_iter, 3, 3]
    Qs = Q[triple_idx]
    # Closed-form triangle-frame fits (equal to Kabsch for exact triples; no
    # batched SVDs — those cost ~57 ms/frame at VKITTI2 instance counts).
    T_h = triangle_fit(Ps, Qs)

    # Inlier counting per hypothesis (basic_algorithms.h:133-143).
    Pt = apply_transform(T_h, jnp.broadcast_to(P, (n_iter, N, 3)))
    err = jnp.linalg.norm(Pt - Q[None], axis=-1)
    inl = mask[None, :] & (err < threshold)
    counts = jnp.sum(inl, axis=1)

    best = jnp.argmax(counts)  # first max wins, matching the strict '>' update
    best_T = T_h[best]
    best_inl = inl[best]
    n_inl = counts[best]

    if refit_with_inliers:
        refit_T, refit_ok = kabsch(P, Q, best_inl)
        use_refit = refit_ok & (n_inl >= 3)
        best_T = jnp.where(use_refit, refit_T, best_T)

    # Inlier MSE under the returned transform (basic_algorithms.h:177-194;
    # squared-norm errors averaged over inliers).
    Pf = apply_transform(best_T[None], P[None])[0]
    sq = jnp.sum((Pf - Q) ** 2, axis=-1)
    mse = jnp.sum(jnp.where(best_inl, sq, 0.0)) / jnp.maximum(n_inl, 1)

    first_inlier = jnp.argmax(best_inl)  # lowest index inlier
    has_inlier = jnp.any(best_inl)
    first_inlier = jnp.where(has_inlier, first_inlier, 0)

    return best_T, best_inl, n_inl, mse, first_inlier
