"""The port's host input-pipeline bench (``bench/input_pipeline.py``) at
a tiny size: every decoder that exists is timed and agrees with the
others on what it decoded; a missing one is reported as missing."""

import json

import pytest

from surya_tpu_torch.bench import input_pipeline


def test_reports_every_decoder_that_exists(capsys):
    result = input_pipeline.main(n_images=6, staging=32, src_hw=(48, 64))
    assert json.loads(capsys.readouterr().out) == result
    decoders = result["decoders"]
    assert set(decoders) == {"native", "PIL", "cv2"}
    for name, key in (("PIL", "pil_images_per_sec"),
                      ("native", "native_images_per_sec")):
        assert (result[key] is not None) == decoders[name]
        assert result[key] is None or result[key] > 0
    if decoders["native"]:
        assert result["native_ok"] == 6
    if decoders["native"] or decoders["PIL"]:
        assert result["packed_images_per_sec"] > 0
        assert result["pack_build_s"] > 0


def test_no_encoder_no_rates(monkeypatch, capsys):
    monkeypatch.setattr(input_pipeline, "_decoders", lambda: {
        "native": False, "PIL": False, "cv2": False})
    result = input_pipeline.main(n_images=4, staging=32)
    assert result["pil_images_per_sec"] is None
    assert result["native_images_per_sec"] is None
    assert result["packed_images_per_sec"] is None
    assert "pack_build_s" not in result


@pytest.mark.parametrize("missing", ["PIL", "native"])
def test_a_missing_decoder_is_not_stood_in_for(monkeypatch, missing):
    real = input_pipeline._decoders()
    if not real["cv2"] and missing == "PIL":
        pytest.skip("needs cv2 to write the JPEGs without PIL")
    monkeypatch.setattr(input_pipeline, "_decoders",
                        lambda: {**real, missing: False})
    result = input_pipeline.main(n_images=4, staging=32, src_hw=(48, 64))
    key = {"PIL": "pil_images_per_sec",
           "native": "native_images_per_sec"}[missing]
    assert result[key] is None
