"""The port's CLI (``python -m surya_tpu_torch``): ``train``, ``eval``,
``pack`` and ``compare``, in-process on the CPU (``--device cpu``) at a
tiny size: 64 px, 3 classes, a frozen trunk, f32.

``eval`` on the checkpoint that ``train`` wrote prints the same metrics as
the loop's own test evaluation (the same weights on the same batches on
the same device: to 1e-6 relative).
"""

import json
import os

import numpy as np
import pytest
import torch

from surya_tpu_torch.__main__ import main
from surya_tpu_torch.data.packed import PackedDataSource
from surya_tpu_torch.core.config import DataConfig
from torch_port_fixtures import one_torch_thread  # noqa: F401

TINY = ["--data.image_size=64", "--data.synthetic_size=24",
        "--model.num_classes=3", "--data.batch_size=8",
        "--model.compute_dtype=float32", "--model.freeze_backbone=true",
        "--device", "cpu"]


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_then_eval(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert main(["train", "--preset", "quadtree-fusion", "--synthetic",
                 "--out", out, "--plot", "--train.epochs=2", *TINY]) == 0
    summary = _last_json(capsys)
    assert set(os.listdir(out)) >= {"config.json", "metrics.jsonl", "ckpt",
                                    "history.png", "confusion.png"}
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["train"]["checkpoint_dir"] == os.path.join(out, "ckpt")
    assert cfg["data"]["synthetic"] and cfg["model"]["num_classes"] == 3
    epochs = [r for r in _records(os.path.join(out, "metrics.jsonl"))
              if "train_loss" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]
    assert summary["test"]["count"] == 24 and not summary["preempted"]
    assert "kernel_launches" not in summary          # the CPU has none
    ckpt = os.path.join(out, "ckpt")
    assert str(summary["best_epoch"]) + ".pt" in os.listdir(ckpt)

    assert main(["eval", ckpt, "--synthetic", *TINY]) == 0
    got = _last_json(capsys)
    for k in ("loss", "accuracy", "precision", "recall", "f1"):
        np.testing.assert_allclose(got[k], summary["test"][k], rtol=1e-6,
                                   err_msg=k)
    assert got["count"] == 24 and "r2" in got

    # --resume goes on from the last checkpoint to the new budget
    assert main(["train", "--synthetic", "--out", out, "--resume",
                 "--train.epochs=3", *TINY]) == 0
    recs = _records(os.path.join(out, "metrics.jsonl"))
    assert any(r.get("event") == "resume" for r in recs)
    assert [r["epoch"] for r in recs if "train_loss" in r] == [0, 1, 2]


def test_pack_then_train_on_the_pack(disk_dataset, tmp_path, capsys):
    """The real data path on the CPU: pack the JPEG layout, then train
    from the pack with augmentation on and per-class imputation."""
    pdir = str(tmp_path / "pack")
    assert main(["pack", "--root", disk_dataset, "--out", pdir,
                 "--staging", "72"]) == 0
    meta = _last_json(capsys)
    assert meta["kind"] == "flat" and meta["splits"]["train"]["count"] == 12
    src = PackedDataSource(DataConfig(data_root=disk_dataset),
                           packed_dir=pdir)
    assert src.staging == 72 and src.stats is not None

    out = str(tmp_path / "run")
    assert main(["train", "--out", out, "--train.epochs=1",
                 f"--data.packed_dir={pdir}",
                 f"--data.data_root={disk_dataset}", *TINY,
                 "--model.num_classes=2", "--data.batch_size=4"]) == 0
    summary = _last_json(capsys)
    assert summary["test"]["count"] == 8
    rec = [r for r in _records(os.path.join(out, "metrics.jsonl"))
           if "train_loss" in r][0]
    assert rec["steps"] == 3 and np.isfinite(rec["train_loss"])


# a temporal preset at the CLI's tiny size: 32 px, 4 classes, f32
TINY_CLIPS = ["--data.image_size=32", "--model.num_classes=4",
              "--model.compute_dtype=float32", "--device", "cpu"]


def test_train_then_eval_a_temporal_preset(tmp_path, capsys):
    """``train --preset ji-3dcnn --data.synthetic=true``: synthetic clips
    of the preset's T = 5, two epochs, the checkpoint read back by
    ``eval``."""
    out = str(tmp_path / "run")
    flags = ["--preset", "ji-3dcnn", "--data.synthetic=true",
             "--data.synthetic_size=16", "--data.batch_size=4", *TINY_CLIPS]
    assert main(["train", "--out", out, "--train.epochs=2", *flags]) == 0
    summary = _last_json(capsys)
    assert summary["test"]["count"] == 16
    epochs = [r for r in _records(os.path.join(out, "metrics.jsonl"))
              if "train_loss" in r]
    assert [r["steps"] for r in epochs] == [4, 4]
    assert all(np.isfinite(r["train_loss"]) for r in epochs)
    assert main(["eval", os.path.join(out, "ckpt"), *flags]) == 0
    got = _last_json(capsys)
    np.testing.assert_allclose(got["loss"], summary["test"]["loss"],
                               rtol=1e-6)


def test_train_fact_at_a_tiny_width(tmp_path, capsys):
    """``train --preset fact --synthetic`` at a tiny fusion width (48: the
    ViT's 12 heads and the fusion's 8 divide it; the ViT keeps its 12
    blocks) takes its step on the CPU, and ``eval`` reads the checkpoint
    back."""
    out = str(tmp_path / "run")
    flags = ["--preset", "fact", "--synthetic", "--data.synthetic_size=8",
             "--data.batch_size=8", "--model.fusion_dim=48",
             "--model.fusion_layers=1", *TINY_CLIPS]
    assert main(["train", "--out", out, "--train.epochs=1", *flags]) == 0
    summary = _last_json(capsys)
    assert summary["test"]["count"] == 8
    rec = [r for r in _records(os.path.join(out, "metrics.jsonl"))
           if "train_loss" in r]
    assert rec[0]["steps"] == 1 and np.isfinite(rec[0]["train_loss"])
    assert main(["eval", os.path.join(out, "ckpt"), *flags]) == 0
    np.testing.assert_allclose(_last_json(capsys)["loss"],
                               summary["test"]["loss"], rtol=1e-6)


def test_pack_sequences_then_train_on_the_pack(tmp_path, capsys):
    """``pack --sequences`` of a temporal replay window tree at T = 5,
    then ``quadtree-3d`` and ``cnn-lstm`` (T = 4 from the same windows,
    truncated) train from the packs and ``eval`` reads the checkpoint."""
    from surya_tpu_torch.data.replay import make_replay_temporal
    from surya_tpu_torch.data.sequences import write_windows

    root = str(tmp_path / "windows")
    write_windows(root, {s: make_replay_temporal(
        per_class=n, image_size=32, seq_len=5, seed=2000 + i)
        for i, (s, n) in enumerate((("train", 1), ("valid", 1),
                                    ("test", 1)))},
        [f"pose_{i}" for i in range(8)])
    for preset, t in (("quadtree-3d", 5), ("cnn-lstm", 4)):
        pdir = str(tmp_path / f"pack{t}")
        assert main(["pack", "--sequences", "--root", root, "--out", pdir,
                     "--seq-len", str(t)]) == 0
        meta = _last_json(capsys)
        assert meta["kind"] == "sequences"
        assert meta["splits"]["train"]["count"] == 8
        out = str(tmp_path / preset)
        flags = ["--preset", preset, f"--data.packed_dir={pdir}",
                 f"--data.seq_root={root}", "--data.batch_size=4",
                 "--data.image_size=32", "--model.compute_dtype=float32",
                 "--device", "cpu"]
        assert main(["train", "--out", out, "--train.epochs=1",
                     *flags]) == 0
        summary = _last_json(capsys)
        assert summary["test"]["count"] == 8
        rec = [r for r in _records(os.path.join(out, "metrics.jsonl"))
               if "train_loss" in r][0]
        assert rec["steps"] == 2 and np.isfinite(rec["train_loss"])
        assert main(["eval", os.path.join(out, "ckpt"), *flags]) == 0
        np.testing.assert_allclose(_last_json(capsys)["loss"],
                                   summary["test"]["loss"], rtol=1e-6)


def test_compare(tmp_path, capsys):
    out = str(tmp_path / "run")
    assert main(["train", "--synthetic", "--out", out, "--train.epochs=1",
                 *TINY]) == 0
    capsys.readouterr()
    ckpt = os.path.join(out, "ckpt")
    weights = str(tmp_path / "w.pt")
    sd = torch.load(os.path.join(ckpt, "0.pt"), weights_only=True)["model"]
    torch.save(sd, weights)
    cmp_dir = str(tmp_path / "cmp")
    assert main(["compare", f"a={ckpt}:quadtree-fusion",
                 f"b={weights}:quadtree-fusion", "--data.synthetic=true",
                 "--split", "valid", "--out", cmp_dir, *TINY]) == 0
    res = _last_json(capsys)
    assert set(res) == {"a", "b"} and res["a"] == res["b"]
    assert set(os.listdir(cmp_dir)) == {"comparison.json", "comparison.png",
                                        "confusion_a.png", "confusion_b.png"}
    with pytest.raises(SystemExit, match="NAME=CKPT_PATH:PRESET"):
        main(["compare", "nonsense", *TINY])


def test_kernel_launches_lists_every_kernel():
    """The counters a card run reports: the training and inference forms
    of the two main-path kernels, and each stem-BN kernel's count (none
    on the CPU)."""
    from surya_tpu_torch.__main__ import kernel_launches

    got = kernel_launches()
    assert got == {"quadrant": {"training": 0, "inference": 0},
                   "fusion_head": {"training": 0, "inference": 0},
                   "channel_stats": 0, "affine_relu": 0}


def test_launch_record_gathers_every_rank_and_the_group_ends(tmp_path):
    """Under a mesh of ranks a card run's result line carries every rank's
    launch counters (an ``all_gather_object`` on every rank, rank 0
    prints); on the CPU it carries none. A command run from ``main``
    destroys the process group ``torchrun`` had it initialise."""
    import torch.distributed as dist

    from surya_tpu_torch import __main__ as cli
    from surya_tpu_torch.core.mesh import create_mesh, single_device_mesh

    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert cli.launch_record(single_device_mesh("cpu"), cpu) == {}
    assert cli.launch_record(single_device_mesh("cpu"), card) == {
        "kernel_launches": cli.kernel_launches()}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = create_mesh(device="cpu")
        assert mesh.distributed
        got = cli.launch_record(mesh, card)
        assert got == {"kernel_launches": cli.kernel_launches(),
                       "kernel_launches_by_rank": [cli.kernel_launches()]}
        assert cli.launch_record(mesh, cpu) == {}
        with pytest.raises(ValueError, match="checkpoint must be"):
            cli.main(["eval", str(tmp_path / "missing"), "--synthetic",
                      *TINY])
        assert not dist.is_initialized()   # even when the command raised
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_cli_refusals(tmp_path, capsys):
    assert main(["list-presets"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 16
    assert main(["frobnicate"]) == 1
    assert main([]) == 1
    # a mesh of two devices needs two processes: torchrun
    with pytest.raises(RuntimeError, match="torchrun"):
        main(["train", "--synthetic", "--out", str(tmp_path / "m"),
              "--mesh.data=2", *TINY])
    with pytest.raises(FileNotFoundError, match="class_to_idx"):
        main(["pack", "--sequences", "--root", str(tmp_path), "--out",
              str(tmp_path / "p")])
    with pytest.raises(ValueError, match="data.seq_len=4 != model.seq_len=5"):
        main(["train", "--preset", "quadtree-3d", "--out",
              str(tmp_path / "s"), "--data.seq_len=4", "--device", "cpu"])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", "--synthetic", "--out", str(tmp_path / "c")])


SMALL = ["--data.image_size=64", "--model.num_classes=3",
         "--model.compute_dtype=float32"]


@pytest.fixture
def checkpoint(tmp_path):
    """A random quadtree-fusion state_dict at 64 px, 3 classes, as .pt."""
    from surya_tpu_torch.core.checkpoint import save_params
    from surya_tpu_torch.core.config import ModelConfig
    from surya_tpu_torch.models import get_model

    cfg = ModelConfig(name="quadtree", num_classes=3, compute_dtype="float32")
    torch.manual_seed(0)
    sd = get_model(cfg, image_size=64).state_dict()
    path = str(tmp_path / "w.pt")
    save_params(path, sd)
    return cfg, sd, path


def test_export(checkpoint, tmp_path, capsys):
    """``export`` writes the serving artifact, which serves what the
    Predictor serves on the same weights."""
    from surya_tpu_torch.infer.serve import Predictor, load_exported

    cfg, sd, ckpt = checkpoint
    out = str(tmp_path / "q.pt2")
    assert main(["export", ckpt, out, "--batch-size", "2", "--input-dtype",
                 "uint8", "--device", "cpu", *SMALL]) == 0
    line = _last_json(capsys)
    assert line == {"artifact": os.path.abspath(out),
                    "bytes": os.path.getsize(out), "batch_size": 2,
                    "input_dtype": "uint8", "model": "quadtree"}
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    feats = rng.normal(size=(2, 47)).astype(np.float32)
    preds, probs = load_exported(out, device="cpu").call(raw, feats)
    want_preds, want_probs = Predictor(
        cfg, sd, batch_size=2, image_size=64, input_dtype="uint8",
        device="cpu").predict(raw, feats)
    np.testing.assert_array_equal(probs.numpy(), want_probs)
    np.testing.assert_array_equal(preds.numpy(), want_preds)


def test_export_torch(checkpoint, tmp_path, capsys):
    """``export-torch`` writes the reference-named state_dict; the
    importer gives the checkpoint back bit for bit."""
    from surya_tpu_torch.models.full_export import EXPORTERS
    from surya_tpu_torch.models.full_import import load_reference_state_dict

    _, sd, ckpt = checkpoint
    out = str(tmp_path / "ref.pth")
    assert main(["export-torch", ckpt, out, *SMALL]) == 0
    line = _last_json(capsys)
    ref = torch.load(out, weights_only=True)
    assert line == {"artifact": os.path.abspath(out), "format": "torch",
                    "model": "quadtree", "tensors": len(ref)}
    assert "base_cnn.fc.weight" in ref and "classifier.0.weight" in ref
    assert sorted(ref) == sorted(EXPORTERS["quadtree"](sd))
    back = load_reference_state_dict("quadtree", ref)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("device", ["cpu", "card"])
def test_check(device, capsys, monkeypatch):
    """``check --device cpu`` reports and exits 0 without building; the
    card check exits 1 when there is no card, the report printed all the
    same with every kernel listed."""
    from surya_tpu_torch.ops.cuda import KERNELS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["check"] + (["--device", "cpu"] if device == "cpu" else [])
    rc = main(argv)
    report = json.loads(capsys.readouterr().out)
    assert report["torch"] == torch.__version__ and not report[
        "cuda_available"]
    assert {"PIL", "cv2", "msgpack", "mediapipe", "rembg", "diffusers",
            "matplotlib", "sklearn", "native_decoder"} <= set(report)
    if device == "cpu":
        assert rc == 0 and "kernels" not in report
    else:
        assert rc == 1 and report["card"] is None
        assert set(report["kernels"]) == set(KERNELS)
