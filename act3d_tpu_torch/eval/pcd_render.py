"""Software point-cloud rendering for evaluation videos.

Counterpart of ``act3d_tpu/eval/pcd_render.py``: a dependency-free
(numpy-only) equivalent of the reference's open3d offscreen point-cloud
views (utils/video_utils.py:100-215 — ``get_point_cloud_images`` — and
the gripper/marker geometry of video_utils.py:19-100): a pinhole z-buffer
point splatter plus sampled surface geometry for the parallel-jaw
gripper, keypose spheres and the fine-sampling ball.  It needs no open3d
and renders the same scene content headlessly and deterministically,
which also makes it unit-testable.

Conventions: extrinsic is world->camera (x_cam = E[:3,:3] @ x + E[:3,3],
the same convention the reference builds in video_utils.py:281-293);
intrinsic is the usual (fx, 0, cx; 0, fy, cy; 0, 0, 1).  Colors are
float RGB in [0, 1].
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "euler_matrix",
    "look_at_extrinsic",
    "topdown_extrinsic",
    "default_intrinsic",
    "render_points",
    "cylinder_points",
    "sphere_points",
    "gripper_control_points",
    "keypose_marker_points",
    "get_point_cloud_images",
    "GT_COLOR",
    "COARSE_PRED_COLOR",
    "FINE_PRED_COLOR",
]

# Marker colors of the reference (video_utils.py:14-16).
GT_COLOR = (0.2, 0.8, 0.0)
COARSE_PRED_COLOR = (1.0, 1.0, 0.0)
FINE_PRED_COLOR = (1.0, 0.0, 1.0)


# ---------------------------------------------------------------------------
# camera helpers
# ---------------------------------------------------------------------------


def euler_matrix(ai: float, aj: float, ak: float) -> np.ndarray:
    """4x4 static-xyz euler rotation — trimesh.transformations.euler_matrix
    default 'sxyz' convention (used by the reference for gripper-jaw
    alignment, video_utils.py:29): R = Rz(ak) @ Ry(aj) @ Rx(ai)."""
    si, ci = np.sin(ai), np.cos(ai)
    sj, cj = np.sin(aj), np.cos(aj)
    sk, ck = np.sin(ak), np.cos(ak)
    rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    ry = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
    rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
    out = np.eye(4)
    out[:3, :3] = rz @ ry @ rx
    return out


def look_at_extrinsic(
    eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)
) -> np.ndarray:
    """World->camera extrinsic for a camera at `eye` looking at `target`
    (+z forward, +x right, +y down — standard CV pinhole frame)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:  # forward parallel to up: pick another up
        upv = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, upv)
        nrm = np.linalg.norm(right)
    right = right / nrm
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])  # rows: camera axes in world coords
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ eye
    return ext


def topdown_extrinsic(
    center: np.ndarray, distance: float = 1.6
) -> np.ndarray:
    """Camera straight above `center` looking down — the reference's
    default (non-custom_cam_params) open3d view is top-down
    (video_utils.py:255)."""
    center = np.asarray(center, np.float64)
    eye = center + np.array([0.0, 0.0, distance])
    return look_at_extrinsic(eye, center, up=(0.0, 1.0, 0.0))


def default_intrinsic(
    image_size: Tuple[int, int] = (480, 480), fov_deg: float = 60.0
) -> np.ndarray:
    h, w = image_size
    f = 0.5 * w / np.tan(np.deg2rad(fov_deg) / 2)
    return np.array(
        [[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]]
    )


# ---------------------------------------------------------------------------
# rasteriser
# ---------------------------------------------------------------------------


def render_points(
    points: np.ndarray,
    colors: np.ndarray,
    extrinsic: np.ndarray,
    intrinsic: np.ndarray,
    image_size: Tuple[int, int] = (480, 480),
    point_radius: int = 1,
    background: float = 1.0,
    near: float = 1e-3,
    base: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Z-buffered splat of an (N, 3) cloud with (N, 3) colors -> uint8
    (H, W, 3).

    Each point covers a (2r+1)^2 pixel block; nearest point wins per pixel
    (painter's algorithm: all splat pixels of all points sorted far-to-near
    in ONE scatter, so a far point's edge pixel can never overwrite a near
    point's center pixel).  Vectorised — no per-point Python loop.

    ``base``: optional uint8 (H, W, 3) image to paint over instead of a
    flat background — a second call with `base` draws its points as a
    decal layer on top of an earlier render (depth is still resolved
    *within* the call, but not against the base image).
    """
    h, w = image_size
    if base is not None:
        img = base.astype(np.float32) / 255.0
    else:
        img = np.full((h, w, 3), float(background), np.float32)
    points = np.asarray(points, np.float64).reshape(-1, 3)
    colors = np.asarray(colors, np.float32).reshape(-1, 3)
    if points.shape[0] == 0:
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    cam = points @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    z = cam[:, 2]
    keep = z > near
    cam, z, colors = cam[keep], z[keep], colors[keep]
    if cam.shape[0] == 0:
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    u = intrinsic[0, 0] * cam[:, 0] / z + intrinsic[0, 2]
    v = intrinsic[1, 1] * cam[:, 1] / z + intrinsic[1, 2]
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)

    # Expand every point to its (2r+1)^2 splat pixels, then do a single
    # far-to-near-sorted scatter over ALL of them — sorting per offset
    # pass would let a far point's edge pixel (written in a later pass)
    # overwrite a near point's center pixel.
    r = int(point_radius)
    k = 2 * r + 1
    dv, du = np.mgrid[-r : r + 1, -r : r + 1]
    uu = (ui[None, :] + du.reshape(-1, 1)).ravel()
    vv = (vi[None, :] + dv.reshape(-1, 1)).ravel()
    zz = np.broadcast_to(z, (k * k, z.size)).ravel()
    cc = np.broadcast_to(colors, (k * k,) + colors.shape).reshape(-1, 3)
    ok = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    uu, vv, zz, cc = uu[ok], vv[ok], zz[ok], cc[ok]
    order = np.argsort(-zz, kind="stable")
    img[vv[order], uu[order]] = cc[order]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# geometry sampling (replaces open3d TriangleMesh primitives)
# ---------------------------------------------------------------------------


def cylinder_points(
    radius: float, height: float, transform: np.ndarray, n: int = 400
) -> np.ndarray:
    """Surface samples of a z-axis-aligned cylinder (open3d
    ``create_cylinder`` convention: centred at the origin, axis +z),
    mapped through a 4x4 `transform`."""
    k = max(int(np.sqrt(n)), 4)
    theta = np.linspace(0.0, 2 * np.pi, k, endpoint=False)
    zz = np.linspace(-height / 2, height / 2, k)
    tt, zz = np.meshgrid(theta, zz)
    pts = np.stack(
        [radius * np.cos(tt).ravel(), radius * np.sin(tt).ravel(), zz.ravel()],
        axis=1,
    )
    return pts @ transform[:3, :3].T + transform[:3, 3]


def sphere_points(
    center: np.ndarray, radius: float, n: int = 600
) -> np.ndarray:
    """Fibonacci-lattice surface samples of a sphere."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    pts = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1) * radius
    return pts + np.asarray(center, np.float64)


_ALIGN = euler_matrix(np.pi / 2, -np.pi / 2, 0)


def gripper_control_points(
    grasp: np.ndarray, color=GT_COLOR, n_per_part: int = 300
) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel-jaw gripper as four sampled cylinders, with the exact
    part dimensions/placements of the reference's open3d gripper mesh
    (video_utils.py:19-100, itself from TaskGrasp): the wrist shaft, the
    palm crossbar and the two fingers.  `grasp` is the 4x4 gripper pose.
    Returns (points, colors)."""
    grasp = np.asarray(grasp, np.float64)
    parts = []
    # wrist shaft: r=0.005 h=0.139, local x offset -0.03
    t = np.eye(4)
    t[0, 3] = -0.03
    parts.append(cylinder_points(0.005, 0.139, grasp @ _ALIGN @ t, n_per_part))
    # palm crossbar: r=0.005 h=0.07, rotated onto x, x offset -0.065
    t = euler_matrix(0, np.pi / 2, 0)
    t[0, 3] = -0.065
    parts.append(cylinder_points(0.005, 0.07, grasp @ _ALIGN @ t, n_per_part))
    # fingers: r=0.005 h=0.06 at z = +-0.065
    for zoff in (0.065, -0.065):
        t = euler_matrix(0, np.pi / 2, 0)
        t[2, 3] = zoff
        parts.append(
            cylinder_points(0.005, 0.06, grasp @ _ALIGN @ t, n_per_part)
        )
    pts = np.concatenate(parts)
    cols = np.tile(np.asarray(color, np.float32), (pts.shape[0], 1))
    return pts, cols


def keypose_marker_points(
    position: np.ndarray, color, radius: float = 0.015, n: int = 600
) -> Tuple[np.ndarray, np.ndarray]:
    """Sphere marker at a predicted/GT position (video_utils.py:165-193)."""
    pts = sphere_points(position, radius, n)
    cols = np.tile(np.asarray(color, np.float32), (pts.shape[0], 1))
    return pts, cols


# ---------------------------------------------------------------------------
# full multi-view scene render (reference get_point_cloud_images)
# ---------------------------------------------------------------------------


def _overlay_geometry(
    gt_keyframe_gripper_matrices: Optional[np.ndarray],
    pred_keyframe_gripper_matrices: Optional[np.ndarray],
    pred_coarse_position: Optional[np.ndarray],
    pred_fine_position: Optional[np.ndarray],
    position_prediction_only: bool,
    fine_sampling_ball_diameter: Optional[float],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The keyframe-action geometry set of video_utils.py:137-196: GT and
    predicted gripper jaws (or position spheres under
    position_prediction_only), coarse/fine position markers and the
    fine-sampling ball."""
    geoms: List[Tuple[np.ndarray, np.ndarray]] = []

    def add_grippers(mats, color):
        for grasp in np.asarray(mats, np.float64).reshape(-1, 4, 4):
            if position_prediction_only:
                geoms.append(
                    keypose_marker_points(grasp[:3, 3], color, radius=0.03)
                )
            else:
                geoms.append(gripper_control_points(grasp, color=color))

    if gt_keyframe_gripper_matrices is not None:
        add_grippers(gt_keyframe_gripper_matrices, GT_COLOR)
    if pred_keyframe_gripper_matrices is not None:
        add_grippers(pred_keyframe_gripper_matrices, FINE_PRED_COLOR)
    if pred_coarse_position is not None:
        geoms.append(
            keypose_marker_points(pred_coarse_position, COARSE_PRED_COLOR)
        )
    if pred_fine_position is not None:
        geoms.append(
            keypose_marker_points(pred_fine_position, FINE_PRED_COLOR)
        )
    if fine_sampling_ball_diameter is not None and pred_coarse_position is not None:
        geoms.append(
            keypose_marker_points(
                pred_coarse_position,
                COARSE_PRED_COLOR,
                radius=fine_sampling_ball_diameter / 2,
                n=1500,
            )
        )
    return geoms


def get_point_cloud_images(
    rgb_obs: np.ndarray,
    pcd_obs: np.ndarray,
    view_names: Optional[Sequence[str]] = None,
    extrinsics: Optional[Sequence[np.ndarray]] = None,
    gt_keyframe_gripper_matrices: Optional[np.ndarray] = None,
    pred_keyframe_gripper_matrices: Optional[np.ndarray] = None,
    pred_coarse_position: Optional[np.ndarray] = None,
    pred_fine_position: Optional[np.ndarray] = None,
    position_prediction_only: bool = False,
    fine_sampling_ball_diameter: Optional[float] = None,
    image_size: Tuple[int, int] = (480, 480),
) -> List[np.ndarray]:
    """Per-camera point-cloud views plus one aggregate view — the same
    output list as the reference ``get_point_cloud_images``
    (video_utils.py:100-215): ``num_cams + 1`` uint8 images; keyframe
    overlays appear on the shoulder views and the aggregate (the
    reference draws them only where the window is named
    left/right_shoulder, :204-209).

    rgb_obs: (ncam, H, W, 3) float in [0, 1]; pcd_obs: (ncam, H, W, 3)
    world-frame xyz.  `extrinsics`: optional per-view world->camera 4x4s;
    views without one (and the aggregate) get a top-down view over the
    cloud's centroid, matching the reference's default open3d viewpoint.
    """
    rgb_obs = np.asarray(rgb_obs, np.float32)
    pcd_obs = np.asarray(pcd_obs, np.float64)
    ncam = rgb_obs.shape[0]
    if view_names is None:
        view_names = [f"cam{i}" for i in range(ncam)]
    intr = default_intrinsic(image_size)
    overlays = _overlay_geometry(
        gt_keyframe_gripper_matrices,
        pred_keyframe_gripper_matrices,
        pred_coarse_position,
        pred_fine_position,
        position_prediction_only,
        fine_sampling_ball_diameter,
    )
    overlay_pts = (
        np.concatenate([g[0] for g in overlays]) if overlays else None
    )
    overlay_cols = (
        np.concatenate([g[1] for g in overlays]) if overlays else None
    )

    all_pts = pcd_obs.reshape(-1, 3)
    center = np.median(all_pts, axis=0)
    default_ext = topdown_extrinsic(center)

    def render_view(pts, cols, ext, with_overlay):
        """Cloud render, then the marker geometry as a decal layer on top
        (depth-resolved among themselves): the markers are diagnostic
        annotations — the reference draws them as large bright meshes
        precisely to be seen (video_utils.py:137-196), so a dense cloud
        must not swallow them."""
        img = render_points(pts, cols, ext, intr, image_size)
        if with_overlay and overlay_pts is not None:
            img = render_points(
                overlay_pts, overlay_cols, ext, intr, image_size, base=img
            )
        return img

    imgs = []
    for cam in range(ncam):
        pts = pcd_obs[cam].reshape(-1, 3)
        cols = rgb_obs[cam].reshape(-1, 3)
        ext = (
            extrinsics[cam]
            if extrinsics is not None and extrinsics[cam] is not None
            else default_ext
        )
        imgs.append(
            render_view(pts, cols, ext, "shoulder" in view_names[cam])
        )

    imgs.append(
        render_view(all_pts, rgb_obs.reshape(-1, 3), default_ext, True)
    )
    return imgs
