"""ya_vo_tpu: monocular visual odometry in JAX (see README.md).

Public API convenience exports; submodules remain importable directly.
"""

from ya_vo_tpu.config import VOConfig  # noqa: F401

__version__ = "0.1.0"


def create_frontend(config=None, camera=None):
    """Build a ready-to-run VO frontend.

    Args:
      config: VOConfig (defaults to KITTI-shaped defaults).
      camera: core.camera.Camera (defaults to KITTI gray-cam intrinsics).
    """
    from ya_vo_tpu.config import VOConfig as _C
    from ya_vo_tpu.tracking.frontend import Frontend
    from ya_vo_tpu.utils.synthetic import kitti_camera

    return Frontend(config or _C(), camera or kitti_camera())
