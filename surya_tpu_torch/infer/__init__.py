"""Serving tier: the fixed-batch Predictor, the ``torch.export`` serving
artifact, the HTTP server and video."""

from surya_tpu_torch.infer.serve import (  # noqa: F401
    ExportedPredictor,
    Predictor,
    ServingForward,
    export_model,
    load_exported,
)
