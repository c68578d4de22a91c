"""The extended per-frame pose feature set of the sequence pipeline,
ported from ``surya_tpu/features/pose_extended.py``; vectorised over whole
(…, T, 33, 4) landmark sequences on any device:

1. 33 × (norm x, y, z, visibility)                              = 132
2. 10 joint angles from PIXEL coords, visibility-gated at 0.65  =  10
3. 3 body-scale-normalised pixel distances                      =   3
   (scale = shoulder width if > 0.05·W, else hip width if > 0.05·W,
   else H/3)
4. 33 × mid-hip-relative normalised coords (vis-gated)          =  99
5. 33 × (vx, vy, vz, ax, ay, az) pixel dynamics from a 2-frame
   history, NaN when any of the 3 frames' landmark is invisible = 198
6. torso variance ratio (var_x+1e-6)/(var_y+1e-6), ≥2 visible   =   1
                                                           total = 443

The first two frames' dynamics are NaN (the reference's 2-deep landmark
history).
"""

from __future__ import annotations

import math

import torch

from surya_tpu_torch.features import landmarks as L
from surya_tpu_torch.features.pose47 import _masked_var, _norm

VIS = L.VISIBILITY_THRESHOLD  # 0.65

ANGLES_EXTENDED = (
    ("LEFT_ELBOW_ANGLE", (L.LEFT_SHOULDER, L.LEFT_ELBOW, L.LEFT_WRIST)),
    ("RIGHT_ELBOW_ANGLE", (L.RIGHT_SHOULDER, L.RIGHT_ELBOW,
                           L.RIGHT_WRIST)),
    ("LEFT_SHOULDER_ANGLE", (L.LEFT_ELBOW, L.LEFT_SHOULDER, L.LEFT_HIP)),
    ("RIGHT_SHOULDER_ANGLE", (L.RIGHT_ELBOW, L.RIGHT_SHOULDER,
                              L.RIGHT_HIP)),
    ("LEFT_KNEE_ANGLE", (L.LEFT_HIP, L.LEFT_KNEE, L.LEFT_ANKLE)),
    ("RIGHT_KNEE_ANGLE", (L.RIGHT_HIP, L.RIGHT_KNEE, L.RIGHT_ANKLE)),
    ("LEFT_HIP_ANGLE", (L.LEFT_SHOULDER, L.LEFT_HIP, L.LEFT_KNEE)),
    ("RIGHT_HIP_ANGLE", (L.RIGHT_SHOULDER, L.RIGHT_HIP, L.RIGHT_KNEE)),
    ("TORSO_VERTICAL_ANGLE", (L.NOSE, L.LEFT_SHOULDER, L.LEFT_HIP)),
    ("TORSO_HORIZONTAL_ALIGNMENT", (L.LEFT_SHOULDER, L.RIGHT_SHOULDER,
                                    L.LEFT_HIP)),
)

FEATURE_NAMES_EXTENDED = tuple(
    [f"LM{i}_{s}" for i in range(33)
     for s in ("norm_x", "norm_y", "norm_z", "visibility")]
    + [name for name, _ in ANGLES_EXTENDED]
    + ["DIST_LR_WRIST_NORM", "DIST_LR_ANKLE_NORM",
       "DIST_L_WRIST_HIP_NORM"]
    + [f"LM{i}_rel_{a}_norm" for i in range(33) for a in "xyz"]
    + [f"LM{i}_{s}_px" for i in range(33)
       for s in ("vx", "vy", "vz", "ax", "ay", "az")]
    + ["TORSO_VAR_XY_RATIO"])
NUM_FEATURES_EXTENDED = len(FEATURE_NAMES_EXTENDED)
assert NUM_FEATURES_EXTENDED == 443, NUM_FEATURES_EXTENDED


def extract_features_extended(landmarks: torch.Tensor, img_width,
                              img_height) -> torch.Tensor:
    """(…, T, 33, 4) normalised landmarks → (…, T, 443) features.

    ``img_width``/``img_height`` are scalars or per-frame tensors of shape
    ``landmarks.shape[:-2]`` (mixed-size clips need per-frame sizes for
    their pixel coordinates)."""
    dev, dt = landmarks.device, landmarks.dtype
    xyz = landmarks[..., :3]
    vis = landmarks[..., 3]
    visible = vis > VIS
    nan = torch.full((), math.nan, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    img_width = torch.as_tensor(img_width, dtype=torch.float32, device=dev)
    img_height = torch.as_tensor(img_height, dtype=torch.float32, device=dev)
    # pixel coords (x·W, y·H, z·W)
    whw = torch.stack(torch.broadcast_tensors(img_width, img_height,
                                              img_width), dim=-1)
    px = xyz * whw[..., None, :]

    feats = []
    # 1. raw normalised coords + visibility, landmark-major
    for i in range(33):
        feats += [xyz[..., i, 0], xyz[..., i, 1], xyz[..., i, 2],
                  vis[..., i]]

    # 2. angles from pixel coords, NaN unless all three visible; a
    #    zero-length vector gives 0.0, as the reference's guard does
    def p(i):
        return px[..., i, :]

    for _, (a, b, c) in ANGLES_EXTENDED:
        ba = p(a) - p(b)
        bc = p(c) - p(b)
        nprod = _norm(ba) * _norm(bc)
        cos = torch.where(nprod > 0,
                          (ba * bc).sum(-1) / nprod.clamp(min=1e-12), 1.0)
        ang = torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))
        ok = visible[..., a] & visible[..., b] & visible[..., c]
        feats.append(torch.where(ok, ang, nan))

    # 3. normalised pixel distances with the fallback body scale
    def pdist(i, j):
        return _norm(p(i) - p(j))

    sw_ok = visible[..., L.LEFT_SHOULDER] & visible[..., L.RIGHT_SHOULDER]
    hw_ok = visible[..., L.LEFT_HIP] & visible[..., L.RIGHT_HIP]
    shoulder_w = torch.where(sw_ok, pdist(L.LEFT_SHOULDER,
                                          L.RIGHT_SHOULDER), zero)
    hip_w = torch.where(hw_ok, pdist(L.LEFT_HIP, L.RIGHT_HIP), zero)
    thresh = 0.05 * img_width
    body_scale = torch.where(shoulder_w > thresh, shoulder_w,
                             torch.where(hip_w > thresh, hip_w,
                                         img_height / 3.0))
    body_scale = torch.where(body_scale == 0, 1.0, body_scale)
    for i, j in ((L.LEFT_WRIST, L.RIGHT_WRIST),
                 (L.LEFT_ANKLE, L.RIGHT_ANKLE),
                 (L.LEFT_WRIST, L.LEFT_HIP)):
        ok = visible[..., i] & visible[..., j]
        feats.append(torch.where(ok, pdist(i, j) / body_scale, nan))

    # 4. mid-hip-relative normalised coords (no hips → the image centre
    #    (0.5, 0.5, 0)); NaN per landmark when invisible
    mid_hip = 0.5 * (xyz[..., L.LEFT_HIP, :] + xyz[..., L.RIGHT_HIP, :])
    center = torch.tensor([0.5, 0.5, 0.0], dtype=dt, device=dev)
    mid_hip = torch.where(hw_ok[..., None], mid_hip, center)
    rel = xyz - mid_hip[..., None, :]
    for i in range(33):
        for a in range(3):
            feats.append(torch.where(visible[..., i], rel[..., i, a], nan))

    # 5. pixel velocity/acceleration over T; the landmark must be visible
    #    in all three frames, and frames t < 2 have no history
    prev = torch.roll(px, 1, dims=-3)
    prev2 = torch.roll(px, 2, dims=-3)
    has_hist = (torch.arange(landmarks.shape[-3], device=dev) >= 2)[:, None]
    dyn_ok = (visible & torch.roll(visible, 1, dims=-2)
              & torch.roll(visible, 2, dims=-2) & has_hist)
    vel = px - prev
    acc = vel - (prev - prev2)
    for i in range(33):
        ok = dyn_ok[..., i]
        for a in range(3):
            feats.append(torch.where(ok, vel[..., i, a], nan))
        for a in range(3):
            feats.append(torch.where(ok, acc[..., i, a], nan))

    # 6. torso variance ratio with epsilons
    torso_idx = list(L.TORSO)
    tv = visible[..., torso_idx]
    cnt = tv.sum(-1)
    denom = cnt.clamp(min=1)
    ratio = ((_masked_var(xyz[..., torso_idx, 0], tv, denom) + 1e-6)
             / (_masked_var(xyz[..., torso_idx, 1], tv, denom) + 1e-6))
    feats.append(torch.where(cnt > 1, ratio, nan))

    return torch.stack(feats, dim=-1).float()
