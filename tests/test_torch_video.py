"""The port's video tier (``surya_tpu_torch/infer/video.py``) against the
JAX package's: the frame-batch core against JAX's ``run_video_inference``
on the same decoded frames, landmark extractor and bridged ``quadtree``
weights at 64 px (labels equal, confidences within 1e-5 at f32); the
cv2-free staging resize against ``cv2.resize`` (within 1e-5); the
``video`` CLI on a tiny mp4; and the card's path (the neural extractor,
the staging resize, the features and the classifier) with PIL and cv2
blocked."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from surya_tpu.core.config import ModelConfig as JaxModelConfig
from surya_tpu.infer.video import run_video_inference as jax_run_video
from surya_tpu.models import get_model as jax_get_model
from surya_tpu_torch.__main__ import main as port_main
from surya_tpu_torch.core.config import ModelConfig
from surya_tpu_torch.data.resample import linear_resize
from surya_tpu_torch.infer import video as tvideo
from surya_tpu_torch.models.from_jax import from_jax_variables
from test_torch_resnet import numpy_variables
from torch_port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["c0", "c1", "c2", "c3", "c4"]
SIZE = 64


class FixedExtractor:
    """Landmarks from the frame's pixels (deterministic per frame); every
    third frame has no pose."""

    def process_array(self, frame):
        s = int(frame.astype(np.int64).sum())
        rng = np.random.default_rng(s)
        lm = rng.uniform(0.1, 0.9, (33, 4)).astype(np.float32)
        return lm, s % 3 != 0


def _video(path, n=7, shape=(48, 80), seed=0):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5,
                        (shape[1], shape[0]))
    for _ in range(n):
        w.write(rng.integers(0, 255, shape + (3,), np.uint8))
    w.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    assert len(frames) == n
    return frames


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig(name="quadtree", num_classes=len(CLASSES),
                          compute_dtype="float32")
    variables = numpy_variables(jax_get_model(jcfg),
                                jnp.zeros((1, SIZE, SIZE, 3)),
                                jnp.zeros((1, 47)), train=False)
    return jcfg, variables, from_jax_variables(variables)


@pytest.mark.parametrize("src,dst", [((480, 640), 224), ((48, 80), 64),
                                     ((30, 40), 224), ((224, 224), 224)])
def test_staging_resize_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    f = np.random.default_rng(0).random(src + (3,), dtype=np.float32)
    want = cv2.resize(f, (dst, dst))
    got = linear_resize(torch.from_numpy(f)[None], (dst, dst))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_frame_batch_core_matches_jax_video(weights, tmp_path):
    jcfg, variables, sd = weights
    path = str(tmp_path / "v.mp4")
    frames = _video(path)
    want = jax_run_video(jcfg, variables, path, CLASSES,
                         extractor=FixedExtractor(), batch_size=4,
                         image_size=SIZE)
    cfg = ModelConfig(name="quadtree", num_classes=len(CLASSES),
                      compute_dtype="float32")
    classify = tvideo.make_frame_classifier(cfg, sd, SIZE, device="cpu")
    got, lms, det = [], [], []
    for lo in range(0, len(frames), 4):
        recs, lm, d = tvideo.classify_frame_batch(
            classify, FixedExtractor(), frames[lo:lo + 4], CLASSES, SIZE,
            start=lo)
        got += recs
        lms += lm
        det += d
    assert len(got) == len(want) == len(frames) and not all(det)
    for g, w in zip(got, want):
        assert g["frame"] == w["frame"] and g["label"] == w["label"]
        assert abs(g["confidence"] - w["confidence"]) <= 1e-5
    # the port's own video loop gives the same records
    assert tvideo.run_video_inference(
        cfg, sd, path, CLASSES, extractor=FixedExtractor(), batch_size=4,
        image_size=SIZE, device="cpu") == got


def test_video_cli_with_the_neural_extractor(tmp_path, capsys):
    cfg = ModelConfig(name="quadtree", mode="fusion",
                      num_classes=len(CLASSES))
    from surya_tpu_torch.models import get_model

    ckpt = str(tmp_path / "clf.pt")
    torch.save(get_model(cfg, image_size=224).state_dict(), ckpt)
    names = str(tmp_path / "names.json")
    with open(names, "w") as f:
        json.dump(CLASSES, f)
    path = str(tmp_path / "v.mp4")
    _video(path, n=3, shape=(40, 48))
    out = str(tmp_path / "annotated.mp4")
    pose = os.path.join(ROOT, "runs", "pose_landmark_cpu",
                        "pose_landmark.msgpack")
    assert port_main(["video", ckpt, path, "--classes", names, "--out", out,
                      "--pose-ckpt", pose, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "3 frames classified" in printed
    recs = json.loads(printed[:printed.rindex("]") + 1])
    assert [r["frame"] for r in recs] == [0, 1, 2]
    assert all(r["label"] in CLASSES and 0 < r["confidence"] <= 1
               for r in recs)
    assert os.path.getsize(out) > 0


def test_card_path_needs_no_pil_or_cv2():
    """The extractor's resize, the staging resize, the features and the
    classifier run with PIL and cv2 unimportable, as on the card's
    machine."""
    code = "\n".join([
        "import sys",
        "sys.modules['PIL'] = None; sys.modules['cv2'] = None",
        "import numpy as np, torch",
        "from surya_tpu_torch.core.config import ModelConfig",
        "from surya_tpu_torch.infer import video",
        "from surya_tpu_torch.models import get_model",
        "from surya_tpu_torch.models.pose import PoseLandmarkNet, "
        "neural_landmark_extractor",
        "torch.set_num_threads(1)",
        "net = PoseLandmarkNet(width=8, dtype=torch.float32)",
        "ext = neural_landmark_extractor(net.state_dict(), model=net, "
        "image_size=32, detection_threshold=-1.0, device='cpu')",
        "cfg = ModelConfig(name='quadtree', num_classes=3, "
        "compute_dtype='float32')",
        "clf = video.make_frame_classifier(cfg, get_model(cfg, 64)"
        ".state_dict(), 64, device='cpu')",
        "frames = list(np.random.default_rng(0).integers("
        "0, 255, (3, 50, 40, 3), np.uint8))",
        "recs, lms, det = video.classify_frame_batch(clf, ext, frames, "
        "['a', 'b', 'c'], 64)",
        "assert len(recs) == 3 and all(det), (recs, det)",
        "assert sys.modules['PIL'] is None and sys.modules['cv2'] is None",
        "print('ok')"])
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
