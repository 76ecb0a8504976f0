"""Pinhole camera model (batched, jit-friendly).

Replaces the reference's `Camera`/`Intrinsics` structs (reference:
include/Utils.hpp:30-82) and its scattered projection helpers
(`Frame::world2Camera` src/Frame.cc:16-28, `LoopHandler::pixel2camera`
src/LoopHandler.cc:908-915, `sophus2ProjMat` src/LoopHandler.cc:887-906).

Coordinate convention (fixing reference quirk SURVEY.md §2.4.1): pixel
coordinates are ALWAYS `uv = (u, v) = (column, row)` float32, the standard CV
convention. Image arrays are indexed `img[v, u]`. No (row, col) keypoints
anywhere in this codebase.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Camera(NamedTuple):
    """Pinhole intrinsics. Scalars (or broadcastable arrays) fx, fy, cx, cy.

    `create` stores HOST (numpy) scalars: jitted code consumes them as
    pytree leaves exactly like device arrays, while host-side consumers
    (`float(cam.fx)` in renderers/exporters) stay free of device->host
    syncs.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def create(fx, fy, cx, cy, dtype=jnp.float32) -> "Camera":
        return Camera(
            np.asarray(fx, dtype), np.asarray(fy, dtype),
            np.asarray(cx, dtype), np.asarray(cy, dtype),
        )

    @property
    def K(self) -> jnp.ndarray:
        """3x3 intrinsic matrix (host numpy outside jit, traced inside)."""
        xp = np if isinstance(self.fx, (np.ndarray, float, int)) else jnp
        z = xp.zeros_like(self.fx)
        o = xp.ones_like(self.fx)
        return xp.stack(
            [
                xp.stack([self.fx, z, self.cx], axis=-1),
                xp.stack([z, self.fy, self.cy], axis=-1),
                xp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )

    def project(self, pts_cam: jnp.ndarray, eps: float = 1e-6):
        """Camera-frame points [..., 3] -> pixel uv [..., 2] and depth [...].

        Depth is returned so callers can mask points behind the camera
        (the reference checks `pc(2,0) < 0` at src/LoopHandler.cc:334-341).
        """
        z = pts_cam[..., 2]
        z_safe = jnp.where(jnp.abs(z) < eps, jnp.where(z < 0, -eps, eps), z)
        u = self.fx * pts_cam[..., 0] / z_safe + self.cx
        v = self.fy * pts_cam[..., 1] / z_safe + self.cy
        return jnp.stack([u, v], axis=-1), z

    def unproject(self, uv: jnp.ndarray, depth=None) -> jnp.ndarray:
        """Pixels [..., 2] (+ optional depth [...]) -> camera-frame points.

        With depth None, returns normalized-plane points (z = 1), the
        equivalent of reference `pixel2camera` (src/LoopHandler.cc:908-915).
        """
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        z = jnp.ones_like(x)
        rays = jnp.stack([x, y, z], axis=-1)
        if depth is None:
            return rays
        return rays * depth[..., None]

    def projection_matrix(self, T_wc: jnp.ndarray) -> jnp.ndarray:
        """P = K [R|t] for a world->camera pose T_wc [..., 4, 4] -> [..., 3, 4].

        Equivalent of reference `sophus2ProjMat` (src/LoopHandler.cc:887-906).
        """
        return self.K @ T_wc[..., :3, :4]


def in_bounds(uv: jnp.ndarray, height: int, width: int, margin: int = 0):
    """Boolean mask [...,] of pixels at least `margin` inside the image."""
    u, v = uv[..., 0], uv[..., 1]
    return (
        (u >= margin) & (u <= width - 1 - margin)
        & (v >= margin) & (v <= height - 1 - margin)
    )
