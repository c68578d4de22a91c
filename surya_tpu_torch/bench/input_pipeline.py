"""Host input-pipeline throughput: the port's native C++ decoder against
PIL on synthetic JPEGs at ``DiskDataSource``'s staging size, and epochs
served from the packed memmap cache; the counterpart of
``surya_tpu/bench/input_pipeline.py``.

Host work only: no device is used. A decoder that is missing is reported
as missing (``null`` rates, ``decoders`` says which exist), never stood in
for by another; with no JPEG encoder (PIL or cv2) there is nothing to
decode and only ``decoders`` is reported.

    python -m surya_tpu_torch.bench.input_pipeline [n_images] [staging]
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np


def _decoders() -> dict:
    from surya_tpu_torch import native

    return {"native": native.available(),
            "PIL": importlib.util.find_spec("PIL") is not None,
            "cv2": importlib.util.find_spec("cv2") is not None}


def _write_jpegs(root: str, n: int, src_hw, use_pil: bool) -> list[str]:
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        rgb = rng.integers(0, 255, (*src_hw, 3), np.uint8)
        path = os.path.join(root, f"img{i:05d}.jpg")
        if use_pil:
            from PIL import Image

            Image.fromarray(rgb).save(path, quality=90)
        else:
            import cv2

            cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        paths.append(path)
    return paths


def _rate(n: int, fn) -> float:
    t0 = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t0)


def _packed_rate(paths, tmp, staging, result) -> None:
    import shutil

    from surya_tpu_torch.core.config import DataConfig
    from surya_tpu_torch.data.packed import PackedDataSource, pack_dataset

    root = os.path.join(tmp, "flat")
    os.makedirs(os.path.join(root, "train", "c0"))
    rng = np.random.default_rng(1)
    for i, p in enumerate(paths):
        dst = os.path.join(root, "train", "c0", f"img{i:05d}")
        shutil.copy(p, dst + ".jpg")
        np.save(dst + ".npy", rng.normal(size=47).astype(np.float32))
    t0 = time.perf_counter()
    pack_dataset(root, os.path.join(tmp, "pack"), staging=staging,
                 splits=("train",), verbose=False)
    result["pack_build_s"] = time.perf_counter() - t0
    src = PackedDataSource(DataConfig(data_root=root, batch_size=64),
                           packed_dir=os.path.join(tmp, "pack"))
    for _ in src.train_batches(0):   # warm the page cache
        pass
    best = 0.0
    for epoch in range(3):
        t0 = time.perf_counter()
        seen = sum(len(b[2]) for b in src.train_batches(epoch + 1))
        best = max(best, seen / (time.perf_counter() - t0))
    result["packed_images_per_sec"] = best


def main(n_images: int = 256, staging: int = 256,
         src_hw: tuple[int, int] = (480, 640)) -> dict:
    """→ (and prints as one JSON line) decode rates in images/s on this
    host: ``pil_images_per_sec``, ``native_images_per_sec`` (null where the
    decoder is missing), ``packed_images_per_sec``, ``pack_build_s``."""
    decoders = _decoders()
    result = {"n_images": n_images, "staging": staging,
              "src": f"{src_hw[0]}x{src_hw[1]}", "decoders": decoders,
              "pil_images_per_sec": None, "native_images_per_sec": None,
              "packed_images_per_sec": None}
    if not (decoders["PIL"] or decoders["cv2"]):
        print(json.dumps(result))
        return result
    with tempfile.TemporaryDirectory() as tmp:
        paths = _write_jpegs(tmp, n_images, src_hw, decoders["PIL"])
        if decoders["PIL"]:
            from PIL import Image

            def pil():
                for p in paths:
                    with Image.open(p) as im:
                        np.asarray(im.convert("RGB").resize(
                            (staging, staging), Image.BILINEAR))

            result["pil_images_per_sec"] = _rate(n_images, pil)
        if decoders["native"]:
            from surya_tpu_torch import native

            native.decode_batch(paths[:8], staging)   # warm
            ok = []
            result["native_images_per_sec"] = _rate(
                n_images, lambda: ok.append(
                    native.decode_batch(paths, staging)[1]))
            result["native_ok"] = ok[0]
        if decoders["native"] or decoders["PIL"]:
            _packed_rate(paths, tmp, staging, result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
