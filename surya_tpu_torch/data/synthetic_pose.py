"""Synthetic pose dataset on the device: articulated stick figures with
their 33 MediaPipe-topology landmarks, ported from
``surya_tpu/data/synthetic_pose.py``.

Ground truth for training ``models.pose.PoseLandmarkNet`` without
MediaPipe or a real pose dataset. Every random draw is split from the
deterministic math (as ``data/augment.py`` splits its augmentation):
``draw_pose`` draws from a ``torch.Generator`` on the batch's device, and
``pose_from_draws``, ``articulate``, ``camera_transform``,
``render_pose`` and ``apply_pose_augment`` are pure functions of their
inputs, so they hold against JAX on the same drawn values. JAX's
threefry streams are not reproduced.

Bones are colour-coded by side (left limbs → channel 0, right → 1,
torso/face → 2), which makes a monochrome figure's chirality readable;
depth sets the intensity (near = bright), which makes z learnable.
"""

from __future__ import annotations

import numpy as np
import torch

from surya_tpu_torch.features import landmarks as L

# Canonical 33-landmark template, MediaPipe topology/order, normalised
# image coords (x right, y DOWN), front-facing: the subject's LEFT side
# appears on the image's right (x > 0.5).
_T = {
    0: (0.50, 0.18),                                    # nose
    1: (0.52, 0.16), 2: (0.535, 0.16), 3: (0.55, 0.16),  # left eye i/c/o
    4: (0.48, 0.16), 5: (0.465, 0.16), 6: (0.45, 0.16),  # right eye i/c/o
    7: (0.57, 0.17), 8: (0.43, 0.17),                   # ears L/R
    9: (0.52, 0.20), 10: (0.48, 0.20),                  # mouth L/R
    11: (0.60, 0.30), 12: (0.40, 0.30),                 # shoulders
    13: (0.66, 0.42), 14: (0.34, 0.42),                 # elbows
    15: (0.70, 0.54), 16: (0.30, 0.54),                 # wrists
    17: (0.72, 0.585), 18: (0.28, 0.585),               # pinkies
    19: (0.715, 0.59), 20: (0.285, 0.59),               # index fingers
    21: (0.705, 0.575), 22: (0.295, 0.575),             # thumbs
    23: (0.56, 0.55), 24: (0.44, 0.55),                 # hips
    25: (0.57, 0.72), 26: (0.43, 0.72),                 # knees
    27: (0.57, 0.88), 28: (0.43, 0.88),                 # ankles
    29: (0.575, 0.915), 30: (0.425, 0.915),             # heels
    31: (0.60, 0.935), 32: (0.40, 0.935),               # foot index
}
TEMPLATE_XY = np.asarray([_T[i] for i in range(L.NUM_LANDMARKS)],
                         np.float32)

# (bones, channel): 0 = left limbs, 1 = right limbs, 2 = torso/face.
_BONE_SPEC = (
    # face
    ((0, 2), 2), ((2, 7), 2), ((0, 5), 2), ((5, 8), 2), ((9, 10), 2),
    # torso box
    ((11, 12), 2), ((11, 23), 2), ((12, 24), 2), ((23, 24), 2),
    # left arm + hand
    ((11, 13), 0), ((13, 15), 0), ((15, 17), 0), ((15, 19), 0),
    ((15, 21), 0),
    # right arm + hand
    ((12, 14), 1), ((14, 16), 1), ((16, 18), 1), ((16, 20), 1),
    ((16, 22), 1),
    # left leg + foot
    ((23, 25), 0), ((25, 27), 0), ((27, 29), 0), ((29, 31), 0),
    ((27, 31), 0),
    # right leg + foot
    ((24, 26), 1), ((26, 28), 1), ((28, 30), 1), ((30, 32), 1),
    ((28, 32), 1),
)
BONES = np.asarray([b for b, _ in _BONE_SPEC], np.int32)        # (K, 2)
BONE_CHANNEL = np.asarray([c for _, c in _BONE_SPEC], np.int32)  # (K,)

# Joint blob channel by side: from landmark 7 (ears) on, odd = left and
# even = right; landmarks 1-3 are the left eye, 4-6 the right, and the
# midline nose (0) takes the torso channel.
JOINT_CHANNEL = np.asarray(
    [2]
    + [0] * 3 + [1] * 3                                  # eyes L, R
    + [0 if i % 2 == 1 else 1 for i in range(7, L.NUM_LANDMARKS)],
    np.int32)

# Articulation chains: (pivot, moved landmark indices), applied
# proximal-first so the distal chain follows the proximal rotation.
_CHAINS = (
    (11, (13, 15, 17, 19, 21)),   # left arm about shoulder
    (13, (15, 17, 19, 21)),       # left forearm about elbow
    (12, (14, 16, 18, 20, 22)),   # right arm about shoulder
    (14, (16, 18, 20, 22)),       # right forearm about elbow
    (23, (25, 27, 29, 31)),       # left leg about hip
    (25, (27, 29, 31)),           # left shank about knee
    (24, (26, 28, 30, 32)),       # right leg about hip
    (26, (28, 30, 32)),           # right shank about knee
)
_CHAIN_PIVOTS = np.asarray([p for p, _ in _CHAINS], np.int32)
_CHAIN_MASKS = np.zeros((len(_CHAINS), L.NUM_LANDMARKS), np.float32)
for _ci, (_, _moved) in enumerate(_CHAINS):
    _CHAIN_MASKS[_ci, list(_moved)] = 1.0
# Max swing per chain (radians): shoulders/hips wide, distal smaller.
_CHAIN_RANGE = np.asarray([1.2, 1.0, 1.2, 1.0, 0.6, 0.7, 0.6, 0.7],
                          np.float32)


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def _rotate(v: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) @ rot2(theta).T, theta (...,): x' = x·c + y·(−s),
    y' = x·s + y·c."""
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    x, y = v[..., 0], v[..., 1]
    return torch.stack([x * c + y * -s, x * s + y * c], dim=-1)


def articulate(swings: torch.Tensor) -> torch.Tensor:
    """Forward kinematics: (..., 8) chain angles → (..., 33, 2) xy."""
    xy = _t(TEMPLATE_XY, swings).expand(*swings.shape[:-1],
                                        L.NUM_LANDMARKS, 2)
    masks = _t(_CHAIN_MASKS, swings)
    for ci in range(len(_CHAINS)):
        pivot = xy[..., int(_CHAIN_PIVOTS[ci]), :][..., None, :]
        rotated = _rotate(xy - pivot, swings[..., ci]) + pivot
        m = masks[ci][:, None]
        xy = m * rotated + (1.0 - m) * xy
    return xy


def camera_transform(xy: torch.Tensor, scale, theta, trans) -> torch.Tensor:
    """Global similarity transform (the 'camera'): rotate (..., 33, 2) by
    ``theta`` (...,) about the body centre, scale, translate by ``trans``
    (..., 2)."""
    center = torch.tensor([0.5, 0.55], dtype=torch.float32, device=xy.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=xy.device)
    trans = torch.as_tensor(trans, dtype=torch.float32, device=xy.device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=xy.device)
    return (_rotate(xy - center, theta) * scale[..., None, None] + center
            + trans[..., None, :])


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def draw_pose(generator: torch.Generator, batch_size: int) -> dict:
    """Every random draw of :func:`sample_pose` for ``batch_size`` poses,
    on the generator's device."""
    b, k = batch_size, L.NUM_LANDMARKS
    normal = (lambda *s: torch.randn(  # noqa: E731
        s, generator=generator, device=generator.device))
    return {"swings": _uniform(generator, (b, len(_CHAINS)), -1.0, 1.0),
            "scale": _uniform(generator, (b,), 0.55, 0.95),
            "theta": _uniform(generator, (b,), -0.5, 0.5),
            "trans": _uniform(generator, (b, 2), -0.12, 0.12),
            "jitter": normal(b, k, 2),
            "lean": _uniform(generator, (b,), -0.35, 0.35),
            "z_noise": normal(b, k)}


def pose_from_draws(draws: dict, swing_center: torch.Tensor | None = None,
                    swing_spread: float = 1.0):
    """The deterministic half of :func:`sample_pose`: drawn values →
    (xy (..., 33, 2), z (..., 33), vis (..., 33)).

    xy is in normalised [0, 1] image coords; a joint that leaves the
    frame gets a visibility target that drops smoothly toward 0.
    ``swing_center`` (..., 8) makes the pose class-conditional: the swings
    are drawn around it, within ``swing_spread`` of the usual range and
    clipped to the kinematic limits."""
    u = draws["swings"]
    rng = _t(_CHAIN_RANGE, u)
    swings = u * rng
    if swing_center is not None:
        swings = torch.clamp(swing_center.to(u.device) + swing_spread * swings,
                             -rng, rng)
    xy = articulate(swings)
    xy = camera_transform(xy, draws["scale"], draws["theta"], draws["trans"])
    xy = xy + 0.01 * draws["jitter"]
    # depth: a global lean makes z linear in template height, plus noise
    template_y = _t(TEMPLATE_XY, u)[:, 1]
    z = draws["lean"][..., None] * (template_y - 0.55)
    z = z + 0.02 * draws["z_noise"]
    inside = torch.prod(torch.sigmoid(xy / 0.01)
                        * torch.sigmoid((1.0 - xy) / 0.01), dim=-1)
    return xy.float(), z.float(), inside.clamp(0.0, 1.0)


def sample_pose(generator: torch.Generator, batch_size: int,
                swing_center: torch.Tensor | None = None,
                swing_spread: float = 1.0):
    """``batch_size`` random articulated poses → (xy (B, 33, 2), z (B, 33),
    vis (B, 33)) on the generator's device (see :func:`pose_from_draws`)."""
    return pose_from_draws(draw_pose(generator, batch_size), swing_center,
                           swing_spread)


def render_pose(xy: torch.Tensor, z: torch.Tensor, image_size: int = 256,
                bone_sigma: float = 0.010, joint_sigma: float = 0.018
                ) -> torch.Tensor:
    """(..., 33, 2) coords + (..., 33) depth → (..., S, S, 3) float32 image
    in [0, 1]: the distance of every pixel centre to every bone segment and
    joint, a gaussian falloff, the per-side channels by two one-hot
    products. Depth modulates intensity (near = bright)."""
    s, dev = image_size, xy.device
    centers = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    pix_x = centers.repeat(s)[:, None]                 # (P, 1), x along rows
    pix_y = centers.repeat_interleave(s)[:, None]
    xy = xy[..., None, :, :]                           # (..., 1, 33, 2)
    depth_gain = torch.clamp(1.0 - 1.5 * z, 0.35, 1.65)[..., None, :]

    bones = _t(BONES.astype(np.int64), xy)
    p = xy[..., bones[:, 0], :]                        # (..., 1, K, 2)
    q = xy[..., bones[:, 1], :]
    seg = q - p
    len2 = (seg * seg).sum(-1) + 1e-8                  # (..., 1, K)
    rel_x = pix_x - p[..., 0]                          # (..., P, K)
    rel_y = pix_y - p[..., 1]
    t = torch.clamp((rel_x * seg[..., 0] + rel_y * seg[..., 1]) / len2,
                    0.0, 1.0)
    d2 = (rel_x - t * seg[..., 0]) ** 2 + (rel_y - t * seg[..., 1]) ** 2
    bone_gain = 0.5 * (depth_gain[..., bones[:, 0]]
                       + depth_gain[..., bones[:, 1]])
    bone_int = torch.exp(-d2 / (2.0 * bone_sigma ** 2)) * bone_gain
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    bone_rgb = bone_int @ eye[_t(BONE_CHANNEL.astype(np.int64), xy)]

    d2j = (pix_x - xy[..., 0]) ** 2 + (pix_y - xy[..., 1]) ** 2   # (..., P, 33)
    joint_int = torch.exp(-d2j / (2.0 * joint_sigma ** 2)) * depth_gain
    joint_rgb = joint_int @ eye[_t(JOINT_CHANNEL.astype(np.int64), xy)]

    img = torch.clamp(0.65 * bone_rgb + joint_rgb, 0.0, 1.0)
    return img.reshape(*img.shape[:-2], s, s, 3)


def draw_pose_augment(generator: torch.Generator, b: int, s: int,
                      occlude_p: float = 0.0, mirror_p: float = 0.0) -> dict:
    """The random half of :func:`augment_pose_batch` for B images of side S:
    the occlusion squares (side S/4..S/2, top-left corner) and the per-image
    occlusion and mirror gates; a gate is None when its probability is 0."""
    dev = generator.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (b,), generator=generator, device=dev)

    def gate(prob):
        return (torch.rand(b, generator=generator, device=dev) < prob
                if prob > 0.0 else None)

    return {"side": randint(s // 4, s // 2 + 1),
            "oy": randint(0, s - s // 4), "ox": randint(0, s - s // 4),
            "occlude": gate(occlude_p), "mirror": gate(mirror_p)}


def apply_pose_augment(imgs: torch.Tensor, xy: torch.Tensor, params: dict):
    """Occlusion + mirror with drawn ``params`` → (imgs, xy).

    An occluded joint keeps its coordinate target (the net must infer it
    from kinematic context). A mirrored image gets x → 1 − x targets with
    UNCHANGED landmark indices: the subject's left limbs then appear on the
    image's left, so side identity is readable only from the renderer's
    per-side channels, as MediaPipe's chirality is on mirrored video."""
    s = imgs.shape[1]
    if params["occlude"] is not None:
        ar = torch.arange(s, device=imgs.device)
        yy, xx = ar[None, :, None], ar[None, None, :]
        oy = params["oy"][:, None, None]
        ox = params["ox"][:, None, None]
        side = params["side"][:, None, None]
        patch = ((yy >= oy) & (yy < oy + side) & (xx >= ox)
                 & (xx < ox + side))
        imgs = torch.where((patch & params["occlude"][:, None, None])[..., None],
                           0.0, imgs)
    if params["mirror"] is not None:
        gate = params["mirror"]
        imgs = torch.where(gate[:, None, None, None], imgs.flip(2), imgs)
        flipped = torch.stack([1.0 - xy[..., 0], xy[..., 1]], dim=-1)
        xy = torch.where(gate[:, None, None], flipped, xy)
    return imgs, xy


def augment_pose_batch(generator: torch.Generator, imgs: torch.Tensor,
                       xy: torch.Tensor, occlude_p: float = 0.0,
                       mirror_p: float = 0.0):
    """Occlusion + mirror augmentation on the device → (imgs, xy); z and
    visibility are unchanged (see :func:`apply_pose_augment`)."""
    params = draw_pose_augment(generator, imgs.shape[0], imgs.shape[1],
                               occlude_p, mirror_p)
    return apply_pose_augment(imgs, xy, params)


def _noisy(generator, imgs, noise):
    return torch.clamp(imgs + noise * torch.randn(
        imgs.shape, generator=generator, device=generator.device), 0.0, 1.0)


def make_pose_batch(generator: torch.Generator, batch_size: int,
                    image_size: int = 256, noise: float = 0.03,
                    occlude_p: float = 0.0, mirror_p: float = 0.0):
    """(generator) → (images (B,S,S,3), xy, z, vis), all drawn and rendered
    on the generator's device; ``occlude_p`` / ``mirror_p`` turn on
    :func:`augment_pose_batch`."""
    xy, z, vis = sample_pose(generator, batch_size)
    imgs = _noisy(generator, render_pose(xy, z, image_size), noise)
    if occlude_p > 0.0 or mirror_p > 0.0:
        imgs, xy = augment_pose_batch(generator, imgs, xy, occlude_p,
                                      mirror_p)
    return imgs, xy, z, vis


def class_swing_centers(num_classes: int, seed: int = 1234) -> np.ndarray:
    """Deterministic per-class articulation presets, (C, 8): each row is a
    pose class, drawn inside ±0.85 of the kinematic range so conditional
    sampling keeps room for jitter. numpy, bit-equal to JAX's."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.85, 0.85, (num_classes, len(_CHAINS)))
            * _CHAIN_RANGE).astype(np.float32)


def make_pose_class_batch(generator: torch.Generator, labels, centers,
                          image_size: int = 256, noise: float = 0.03,
                          swing_spread: float = 0.25):
    """Class-conditional :func:`make_pose_batch`: (labels (B,), centers
    (C, 8) from :func:`class_swing_centers`) → (images (B,S,S,3), xy, z,
    vis) on the generator's device."""
    dev = generator.device
    labels = torch.as_tensor(np.asarray(labels), device=dev).long()
    centers = torch.as_tensor(np.asarray(centers), dtype=torch.float32,
                              device=dev)
    xy, z, vis = sample_pose(generator, labels.shape[0],
                             swing_center=centers[labels],
                             swing_spread=swing_spread)
    return _noisy(generator, render_pose(xy, z, image_size), noise), xy, z, vis
