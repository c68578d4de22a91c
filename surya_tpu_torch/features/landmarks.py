"""MediaPipe Pose landmark indices + joint/angle definitions (a copy of
``surya_tpu/features/landmarks.py``).

Index constants follow the 33-landmark MediaPipe Pose topology used by
the reference (``experiment/1_prepare_still_image_dataset.py:30``). Only
the landmarks the 47/575-feature sets touch are named here.
"""

NUM_LANDMARKS = 33

NOSE = 0
LEFT_SHOULDER = 11
RIGHT_SHOULDER = 12
LEFT_ELBOW = 13
RIGHT_ELBOW = 14
LEFT_WRIST = 15
RIGHT_WRIST = 16
LEFT_HIP = 23
RIGHT_HIP = 24
LEFT_KNEE = 25
RIGHT_KNEE = 26
LEFT_ANKLE = 27
RIGHT_ANKLE = 28

TORSO = (LEFT_SHOULDER, RIGHT_SHOULDER, LEFT_HIP, RIGHT_HIP)

# (name, (p1, vertex, p3)) — 8 joint angles of the 47-feature set
# (``1_prepare_still_image_dataset.py:236-245``).
ANGLES_47 = (
    ("LEFT_ELBOW_ANGLE", (LEFT_SHOULDER, LEFT_ELBOW, LEFT_WRIST)),
    ("RIGHT_ELBOW_ANGLE", (RIGHT_SHOULDER, RIGHT_ELBOW, RIGHT_WRIST)),
    ("LEFT_SHOULDER_ANGLE", (LEFT_HIP, LEFT_SHOULDER, LEFT_ELBOW)),
    ("RIGHT_SHOULDER_ANGLE", (RIGHT_HIP, RIGHT_SHOULDER, RIGHT_ELBOW)),
    ("LEFT_KNEE_ANGLE", (LEFT_HIP, LEFT_KNEE, LEFT_ANKLE)),
    ("RIGHT_KNEE_ANGLE", (RIGHT_HIP, RIGHT_KNEE, RIGHT_ANKLE)),
    ("LEFT_HIP_ANGLE", (LEFT_SHOULDER, LEFT_HIP, LEFT_KNEE)),
    ("RIGHT_HIP_ANGLE", (RIGHT_SHOULDER, RIGHT_HIP, RIGHT_KNEE)),
)

# The 10-angle set of the 575-feature pipeline adds torso-side angles
# (``sqn process/processing_image_sequence.py:42-53``).
VISIBILITY_THRESHOLD = 0.65
