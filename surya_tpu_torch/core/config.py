"""Dataclass config tree with named presets and CLI overrides.

The reference configures every experiment via hand-edited module-level
UPPER_CASE constants (e.g. ``TRAINING_MODE`` in
``experiment/train_cnn_model.py:23``, hyperparameters in
``Quadtree_from scratch/Quadtree_train.py:18-23``). Here a single dataclass
tree replaces all of them, with presets reproducing each reference
experiment and dotted-path CLI overrides (``--train.lr=3e-4``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ModelConfig:
    """Model family + architecture knobs.

    ``name`` selects from the model registry (surya_tpu_torch.models.registry).
    ``mode`` mirrors the reference's fusion ablation switch
    (``experiment/models_cnn.py:55-63``):
    'fusion' | 'image_only' | 'numerical_only'.
    """

    name: str = "quadtree"
    mode: str = "fusion"
    num_classes: int = 8
    num_features: int = 47
    backbone: str = "resnet18"  # for standard_multimodal: resnet18/50, vgg16, mobilenet_v2, densenet121
    freeze_backbone: bool = False
    # None = each family's reference default (0.5 spatial/cnn-lstm,
    # 0.6 3d-quadtree/hybrid, 0.1 FACT); set to override uniformly
    dropout: float | None = None
    # temporal models
    seq_len: int = 4
    lstm_hidden: int = 256
    lstm_layers: int = 2
    # FACT (ViT fusion transformer)
    fusion_layers: int = 4
    fusion_heads: int = 8
    fusion_dim: int = 768
    # FACT MoE variant (parallel/moe.py): >0 replaces every fusion
    # layer's dense FFN with a top-k mixture of this many experts
    # (EP-shardable; beyond-reference extension). 0 = reference parity.
    moe_experts: int = 0
    moe_top_k: int = 2
    # compute dtype policy: params stay float32; activations/matmuls in this dtype
    compute_dtype: str = "bfloat16"
    # Kept only so that to_dict() and saved config JSON match the JAX
    # package field for field. The port reads it nowhere: the quadrant
    # block and the fusion head always go through ops/cuda, which picks
    # the CUDA kernel or its plain version by the tensor's device.
    use_pallas: bool = False
    # space-to-depth stem for resnet trunks (TPU MXU efficiency; exact
    # math equivalence — see models/backbones/resnet.py)
    stem_space_to_depth: bool = False
    # ji_3dcnn/quadtree_3d: compute each (3,3,3) conv3d as 3 batched 2D
    # convs (T folded into batch — models/temporal/conv3d.Conv3dAs2D;
    # identical params, measured A/B in BENCH_NOTES)
    conv3d_as_2d: bool = False


@dataclass
class DataConfig:
    data_root: str = "data/flat_image_dataset_final"
    image_size: int = 224
    batch_size: int = 16
    # sequence datasets
    seq_root: str = "data/sequential_dataset"
    seq_len: int = 4
    seq_stride: int = 2
    # host pipeline
    prefetch: int = 2
    # packed pre-decoded cache (data/packed.py): when set, spatial
    # training serves batches from decode-free uint8 memmaps in this
    # directory (built on first use from data_root)
    packed_dir: str = ""
    shuffle_buffer: int = 4096
    standardize_features: bool = False  # per-class (x-mean)/std, 3dcnn/dataloaders.py:119-139
    # augmentation (matches experiment/dataloader_cnn.py:31-46 semantics)
    augment: bool = True
    rrc_scale_min: float = 0.8
    hflip_prob: float = 0.5
    jitter_brightness: float = 0.2
    jitter_contrast: float = 0.2
    jitter_saturation: float = 0.2
    jitter_hue: float = 0.1
    rotation_deg: float = 10.0
    blur_sigma_min: float = 0.1
    blur_sigma_max: float = 0.5
    synthetic: bool = False  # use the synthetic in-memory dataset (tests/benches)
    synthetic_size: int = 256
    # Data echoing (Choi et al. 2019): reuse each host-decoded batch N
    # times per step with FRESH on-device augmentations (our augment
    # pipeline is PRNG-keyed per step, so echoes differ). Lifts
    # throughput when host decode can't feed the chip; mild
    # regularization tradeoff — keep 1 unless input-bound.
    data_echo: int = 1


@dataclass
class TrainConfig:
    epochs: int = 10
    lr: float = 1e-4
    weight_decay: float = 1e-4
    seed: int = 42
    grad_clip: float = 0.0  # 0 disables; 3dcnn uses 1.0
    early_stop_patience: int = 5
    early_stop_min_delta: float = 0.0
    early_stop_metric: str = "val_loss"  # or "val_accuracy"
    plateau_patience: int = 0  # 0 disables ReduceLROnPlateau
    plateau_factor: float = 0.5
    plateau_min_lr: float = 1e-7
    nan_guard: bool = True  # skip non-finite-loss steps (3dcnn train:127-129)
    label_smoothing: float = 0.0
    checkpoint_dir: str = "checkpoints"
    checkpoint_metric: str = "val_loss"  # best-metric retention
    log_every: int = 50
    deterministic: bool = True
    remat: bool = False  # jax.checkpoint the backbone to trade FLOPs for HBM
    zero1: bool = False  # ZeRO-1: shard Adam moments over the data axis
    #                      (parallel/zero.py; needs a multi-device mesh)
    fsdp: bool = False  # FSDP/ZeRO-3: shard params+stats+moments over
    #                     'data' (parallel/zero.py); supersedes zero1
    grad_accum: int = 1  # microbatches per optimizer step (lax.scan);
    #                      batch_size must be divisible by it
    preempt_save: bool = True  # on SIGTERM (TPU-VM preemption notice):
    #   finish the in-flight step, checkpoint the full state, stop
    #   cleanly; `resume=true` continues from it (train/loop.py)


@dataclass
class MeshConfig:
    """Device-mesh topology. axes: data (DP), model (TP), seq (CP)."""

    data: int = -1  # -1 = all remaining devices
    model: int = 1
    seq: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    name: str = "default"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def override(self, overrides: dict[str, Any]) -> "Config":
        """Apply dotted-path overrides, e.g. {"train.lr": 3e-4}."""
        cfg = self
        for path, value in overrides.items():
            parts = path.split(".")
            cfg = _set_path(cfg, parts, value)
        return cfg


def _set_path(obj, parts, value):
    if len(parts) == 1:
        fields = {f.name: f for f in dataclasses.fields(obj)}
        if parts[0] not in fields:
            raise KeyError(f"unknown config field {parts[0]!r} on {type(obj).__name__}")
        if isinstance(value, str):
            value = _coerce(value, getattr(obj, parts[0]))
        return dataclasses.replace(obj, **{parts[0]: value})
    child = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _set_path(child, parts[1:], value)})


def _coerce(s: str, current):
    if isinstance(current, bool):
        low = s.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"invalid boolean {s!r} "
                         "(use true/false/1/0/yes/no/on/off)")
    if isinstance(current, int):
        return int(s)
    if isinstance(current, float):
        return float(s)
    if current is None:  # optional numeric field (e.g. model.dropout)
        if s.strip().lower() in ("none", "null", ""):
            return None
        try:
            return float(s)
        except ValueError:
            return s
    return s


def parse_cli_overrides(argv: list[str]) -> dict[str, Any]:
    """Parse ``--a.b.c=value`` style args into an override dict."""
    out: dict[str, Any] = {}
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"bad override {arg!r}; expected --path.to.field=value")
        k, v = arg[2:].split("=", 1)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Presets: one per reference experiment (hyperparams from BASELINE.md).
# ---------------------------------------------------------------------------

def _preset_quadtree() -> Config:
    # Quadtree_from scratch/Quadtree_train.py:18-27 — BS 16, Adam 1e-4/wd 1e-4,
    # 10 epochs, seed 42, early-stop patience 5 on val loss.
    return Config(
        name="quadtree-fusion",
        model=ModelConfig(name="quadtree", mode="fusion"),
        data=DataConfig(batch_size=16),
        train=TrainConfig(epochs=10, lr=1e-4, weight_decay=1e-4,
                          early_stop_patience=5, early_stop_metric="val_loss",
                          checkpoint_metric="val_loss"),
    )


def _preset_experiment(mode: str) -> Config:
    # experiment/train_cnn_model.py:23-33 — frozen backbone, 20 epochs,
    # best-val-accuracy checkpointing, ablation mode switch.
    return Config(
        name=f"experiment-{mode}",
        model=ModelConfig(name="quadtree", mode=mode, freeze_backbone=True),
        data=DataConfig(batch_size=16),
        train=TrainConfig(epochs=20, lr=1e-4, weight_decay=1e-4,
                          early_stop_metric="val_accuracy",
                          checkpoint_metric="val_accuracy"),
    )


def _preset_comparative(backbone: str) -> Config:
    # comparative analysis/train_cnn.py:15,40-154 — backbone sweep.
    return Config(
        name=f"comparative-{backbone}",
        model=ModelConfig(name="standard_multimodal", backbone=backbone),
        data=DataConfig(batch_size=16),
        train=TrainConfig(epochs=20, lr=1e-4, weight_decay=1e-4,
                          checkpoint_metric="val_loss"),
    )


def _preset_cnn_lstm() -> Config:
    # cnn+lstm/training.py:26-29,93 — BS 32, lr 1e-4, 50 epochs, plateau 5.
    return Config(
        name="cnn-lstm",
        model=ModelConfig(name="cnn_lstm", freeze_backbone=True, seq_len=4),
        data=DataConfig(batch_size=32, seq_len=4),
        train=TrainConfig(epochs=50, lr=1e-4, weight_decay=0.0,
                          plateau_patience=5,
                          checkpoint_metric="val_accuracy",
                          early_stop_metric="val_accuracy"),
    )


def _preset_3dcnn(name: str = "quadtree_3d") -> Config:
    # 3dcnn/train_3D_Quadtree_cnn_model.py:29-43 — BS 8, 5e-5, wd 5e-4,
    # clip 1.0, T=5, early-stop 10 w/ min_delta 1e-3, plateau 5 ×0.5 min 1e-7.
    # r3d_18-based models freeze the pretrained trunk except layer4
    # (3dcnn/models.py:229-237,291-297 — the partial-unfreeze mask).
    freeze = name in ("resnet3d_video", "hybrid_quadtree_3d")
    return Config(
        name=name,
        model=ModelConfig(name=name, mode="fusion", seq_len=5,
                          freeze_backbone=freeze),
        data=DataConfig(batch_size=8, seq_len=5),
        train=TrainConfig(epochs=50, lr=5e-5, weight_decay=5e-4, grad_clip=1.0,
                          early_stop_patience=10, early_stop_min_delta=1e-3,
                          plateau_patience=5, plateau_factor=0.5,
                          plateau_min_lr=1e-7,
                          checkpoint_metric="val_loss"),
    )


def _preset_fact() -> Config:
    # VIT/fact_model_train.py:27-31 — BS 32, lr 1e-4, wd 1e-5, clip 1.0, T=4.
    # NOTE: BS 32 is reference parity, not the TPU throughput optimum —
    # the measured v5e batch sweep (BENCH_NOTES.md "FACT batch sweep":
    # BS 8 → 204.8, BS 16 → 235.2, BS 32 → 211.9, BS 64 → 184.6 clips/s)
    # has its knee at BS 16 (+15%, 50.9% MFU). Use the `fact-bs16`
    # preset when throughput matters more than exact-hyper parity.
    return Config(
        name="fact",
        model=ModelConfig(name="fact", seq_len=4, freeze_backbone=True),
        data=DataConfig(batch_size=32, seq_len=4),
        train=TrainConfig(epochs=50, lr=1e-4, weight_decay=1e-5, grad_clip=1.0,
                          checkpoint_metric="val_accuracy",
                          early_stop_metric="val_accuracy"),
    )


def _preset_fact_bs16() -> Config:
    # Perf variant of `fact`: identical model/optimizer hypers, batch 16
    # — the measured v5e throughput knee (BENCH_NOTES.md "FACT batch
    # sweep", 235.2 clips/s, 50.9% MFU; past 16 the per-frame ViT's
    # activation footprint pushes XLA into less fused schedules).
    cfg = _preset_fact()
    return cfg.replace(name="fact-bs16",
                       data=dataclasses.replace(cfg.data, batch_size=16))


_PRESETS = {
    "quadtree-fusion": _preset_quadtree,
    "experiment-fusion": lambda: _preset_experiment("fusion"),
    "experiment-image-only": lambda: _preset_experiment("image_only"),
    "experiment-numerical-only": lambda: _preset_experiment("numerical_only"),
    "comparative-resnet18": lambda: _preset_comparative("resnet18"),
    "comparative-resnet50": lambda: _preset_comparative("resnet50"),
    "comparative-vgg16": lambda: _preset_comparative("vgg16"),
    "comparative-mobilenet-v2": lambda: _preset_comparative("mobilenet_v2"),
    "comparative-densenet121": lambda: _preset_comparative("densenet121"),
    "cnn-lstm": _preset_cnn_lstm,
    "ji-3dcnn": lambda: _preset_3dcnn("ji_3dcnn"),
    "quadtree-3d": lambda: _preset_3dcnn("quadtree_3d"),
    "resnet3d-video": lambda: _preset_3dcnn("resnet3d_video"),
    "hybrid-quadtree-3d": lambda: _preset_3dcnn("hybrid_quadtree_3d"),
    "fact": _preset_fact,
    "fact-bs16": _preset_fact_bs16,
}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> Config:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {list_presets()}")
    return _PRESETS[name]()
