"""The 47 engineered pose features as batched tensor math, ported from
``surya_tpu/features/pose47.py``.

Layout: ``landmarks`` is (..., 33, 4) = (x, y, z, visibility) in MediaPipe
normalised coordinates, on any device. Output is (..., 47) float32, NaN
where the reference extractor emits NaN (failed guards), and NaN with zero
visibilities for a frame whose ``pose_detected`` is False.

Feature order:
  [0:33)  LM{i}_visibility
  [33:41) 8 joint angles (see landmarks.ANGLES_47), degrees
  [41]    TORSO_VERTICAL_ANGLE        [42] TORSO_HORIZONTAL_ALIGNMENT
  [43]    DIST_LR_WRIST_NORM  [44] DIST_LR_ANKLE_NORM
  [45]    DIST_L_WRIST_HIP_NORM
  [46]    TORSO_VAR_XY_RATIO
"""

from __future__ import annotations

import math

import torch

from surya_tpu_torch.features import landmarks as L

FEATURE_NAMES_47 = tuple(
    [f"LM{i}_visibility" for i in range(33)]
    + [name for name, _ in L.ANGLES_47]
    + ["TORSO_VERTICAL_ANGLE", "TORSO_HORIZONTAL_ALIGNMENT",
       "DIST_LR_WRIST_NORM", "DIST_LR_ANKLE_NORM",
       "DIST_L_WRIST_HIP_NORM", "TORSO_VAR_XY_RATIO"])
NUM_FEATURES = len(FEATURE_NAMES_47)
assert NUM_FEATURES == 47, NUM_FEATURES


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _angle_deg(p1, p2, p3):
    """3-D angle at vertex p2, degrees. The clip only absorbs rounding; a
    zero-length limb still gives NaN, as in the reference."""
    ba = p1 - p2
    bc = p3 - p2
    cos = (ba * bc).sum(-1) / (_norm(ba) * _norm(bc))
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def _fold_180(deg):
    deg = deg.abs()
    return torch.where(deg > 180.0, 360.0 - deg, deg)


def _masked_var(v, keep, denom):
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    mean = torch.where(keep, v, zero).sum(-1) / denom
    return torch.where(keep, (v - mean[..., None]) ** 2, zero).sum(-1) / denom


def extract_features_47(landmarks: torch.Tensor,
                        pose_detected: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """(..., 33, 4) landmark tensor → (..., 47) features."""
    xyz = landmarks[..., :3]
    vis = landmarks[..., 3]
    nan = torch.full((), math.nan, dtype=landmarks.dtype,
                     device=landmarks.device)

    def pt(i):
        return xyz[..., i, :]

    feats = [vis[..., i] for i in range(L.NUM_LANDMARKS)]
    for _, (a, b, c) in L.ANGLES_47:
        feats.append(_angle_deg(pt(a), pt(b), pt(c)))

    # TORSO_VERTICAL_ANGLE: the torso vector (mid-shoulder - mid-hip)
    # against +y, as a difference of atan2s.
    mid_hip = 0.5 * (pt(L.LEFT_HIP) + pt(L.RIGHT_HIP))
    mid_shoulder = 0.5 * (pt(L.LEFT_SHOULDER) + pt(L.RIGHT_SHOULDER))
    torso = mid_shoulder - mid_hip
    angle_rad = (math.atan2(1.0, 0.0)
                 - torch.arctan2(torso[..., 1], torso[..., 0]))
    feats.append(_fold_180(torch.rad2deg(angle_rad)))

    # TORSO_HORIZONTAL_ALIGNMENT: |shoulder-line − hip-line angle|.
    sh_vec = pt(L.RIGHT_SHOULDER)[..., :2] - pt(L.LEFT_SHOULDER)[..., :2]
    hip_vec = pt(L.RIGHT_HIP)[..., :2] - pt(L.LEFT_HIP)[..., :2]
    sh_ang = torch.rad2deg(torch.arctan2(sh_vec[..., 1], sh_vec[..., 0]))
    hip_ang = torch.rad2deg(torch.arctan2(hip_vec[..., 1], hip_vec[..., 0]))
    feats.append(_fold_180(sh_ang - hip_ang))

    # Body-scale-normalised distances: NaN unless body_scale > 0.05.
    def dist(i, j):
        return _norm(pt(i) - pt(j))

    shoulder_w = dist(L.LEFT_SHOULDER, L.RIGHT_SHOULDER)
    hip_w = dist(L.LEFT_HIP, L.RIGHT_HIP)
    body_scale = torch.where((shoulder_w > 0) & (hip_w > 0),
                             0.5 * (shoulder_w + hip_w), 1.0)
    body_scale = torch.where(body_scale == 0, 1.0, body_scale)
    ok = body_scale > 0.05
    for i, j in ((L.LEFT_WRIST, L.RIGHT_WRIST),
                 (L.LEFT_ANKLE, L.RIGHT_ANKLE),
                 (L.LEFT_WRIST, L.LEFT_HIP)):
        feats.append(torch.where(ok, dist(i, j) / body_scale, nan))

    # TORSO_VAR_XY_RATIO over torso landmarks with visibility > 0.65:
    # needs ≥ 2 of them and var_y != 0.
    torso_idx = list(L.TORSO)
    tv = vis[..., torso_idx] > L.VISIBILITY_THRESHOLD
    cnt = tv.sum(-1)
    denom = cnt.clamp(min=1)
    var_x = _masked_var(xyz[..., torso_idx, 0], tv, denom)
    var_y = _masked_var(xyz[..., torso_idx, 1], tv, denom)
    feats.append(torch.where((cnt >= 2) & (var_y != 0), var_x / var_y, nan))

    out = torch.stack(feats, dim=-1).float()
    if pose_detected is not None:
        # no-pose frames: visibilities 0, every other feature NaN
        nanrow = torch.cat(
            [torch.zeros(33, device=out.device),
             torch.full((14,), math.nan, device=out.device)])
        out = torch.where(pose_detected.to(out.device, torch.bool)[..., None],
                          out, nanrow)
    return out
