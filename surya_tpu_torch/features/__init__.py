"""Pose-feature names, a copy of ``surya_tpu/features/pose47.py``'s
``FEATURE_NAMES_47`` (the port's feature extractors are ROADMAP A10).
The order is the layout of every 47-vector: the 33 landmark
visibilities, the 8 joint angles, then the torso and distance features.
"""

FEATURE_NAMES_47 = tuple(
    [f"LM{i}_visibility" for i in range(33)]
    + ["LEFT_ELBOW_ANGLE", "RIGHT_ELBOW_ANGLE", "LEFT_SHOULDER_ANGLE",
       "RIGHT_SHOULDER_ANGLE", "LEFT_KNEE_ANGLE", "RIGHT_KNEE_ANGLE",
       "LEFT_HIP_ANGLE", "RIGHT_HIP_ANGLE"]
    + ["TORSO_VERTICAL_ANGLE", "TORSO_HORIZONTAL_ALIGNMENT",
       "DIST_LR_WRIST_NORM", "DIST_LR_ANKLE_NORM",
       "DIST_L_WRIST_HIP_NORM", "TORSO_VAR_XY_RATIO"])
NUM_FEATURES = len(FEATURE_NAMES_47)
