"""Minimal stdlib HTTP inference server around :class:`Predictor`, ported
from ``surya_tpu/infer/http_server.py`` with the same endpoints, wire
format, error codes and CLI flags.

Endpoints
  GET  /healthz   → JSON {status, model, batch_size, image wire spec}
  POST /predict   → JSON {predictions, [labels], probabilities, n}

Request body for /predict:
  * ``application/x-npz`` (preferred): ``np.savez`` bytes with arrays
    ``images`` (N,H,W,3) and ``features`` (N,F), or, for a temporal
    checkpoint (``--preset cnn-lstm``, ``ji-3dcnn``, ``quadtree-3d``),
    sequences ``images`` (N,T,H,W,3) and ``features`` (N,T,F) through the
    same wire. The image dtype must
    match the server's wire format: raw uint8 pixels with
    ``--input-dtype uint8`` (the default), [0,1] floats otherwise.
  * ``application/json``: {"images": nested lists, "features": ...} —
    curl-able, ~10× the bytes; for smoke tests.

The handler is threaded, and device work is serialised behind one lock:
one card runs one forward at a time, and ``Predictor`` batches already.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

# the server's checkpoint reader: .npz of JAX variables, .pt or a
# checkpoint directory
from surya_tpu_torch.core.checkpoint import (  # noqa: F401
    load_checkpoint_variables as load_state_dict,
)

__all__ = ["PredictionServer", "main"]

_MAX_BODY = 1 << 30  # 1 GiB: ~7k uint8 224² images per request


class PredictionServer:
    """Owns a ``Predictor`` + optional class names; builds the stdlib
    server. Split from the handler so tests can drive ``handle_bytes``
    without sockets."""

    def __init__(self, predictor, class_names: list[str] | None = None):
        self.predictor = predictor
        self.class_names = class_names
        self._lock = threading.Lock()

    def info(self) -> dict:
        p = self.predictor
        return {
            "status": "ok",
            "model": p.cfg.name,
            "mode": p.cfg.mode,
            "num_classes": p.cfg.num_classes,
            "batch_size": p.batch_size,
            "image_size": p.image_size,
            "input_dtype": str(p.input_dtype).removeprefix("torch."),
            "num_features": p.cfg.num_features,
            "classes": self.class_names,
        }

    def handle_bytes(self, body: bytes, content_type: str) -> dict:
        """Decode one /predict request body → response dict.

        Raises ``ValueError`` for malformed requests (mapped to 400)."""
        uint8_wire = self.predictor.input_dtype == torch.uint8
        if content_type.startswith("application/json"):
            req = json.loads(body.decode("utf-8"))
            try:
                # parse at full precision first so a uint8 wire can check
                # the values are raw 0-255 integers before casting
                images = np.asarray(req["images"], np.float64)
                feats = np.asarray(req["features"], np.float32)
            except KeyError as e:
                raise ValueError(f"missing field {e.args[0]!r}") from e
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"images/features must be rectangular numeric "
                    f"lists: {e}") from e
            if uint8_wire:
                if images.size and (np.any(images != np.floor(images))
                                    or images.min() < 0
                                    or images.max() > 255):
                    raise ValueError(
                        "this server's wire format is uint8 raw pixels; "
                        "JSON image values must be integers in [0, 255] "
                        "(got float or out-of-range values — send raw "
                        "pixels, not normalized ones)")
                images = images.astype(np.uint8)
            else:
                images = images.astype(np.float32)
        else:  # npz (the efficient path)
            try:
                with np.load(io.BytesIO(body)) as z:
                    images, feats = z["images"], z["features"]
            except KeyError as e:
                raise ValueError(str(e)) from e
            except Exception as e:  # zipfile/np header errors
                raise ValueError(f"not a readable .npz body: {e}") from e
        if images.ndim < 2 or feats.ndim < 1:
            raise ValueError("images/features have too few dimensions")
        if images.shape[0] != feats.shape[0]:
            raise ValueError(
                f"batch mismatch: {images.shape[0]} images vs "
                f"{feats.shape[0]} feature rows")
        if uint8_wire and images.dtype != np.uint8:
            raise ValueError(
                "this server's wire format is uint8 raw pixels; got "
                f"{images.dtype} (re-export or send raw pixels)")
        with self._lock:  # one card, one forward at a time
            preds, probs = self.predictor.predict(images, feats)
        out = {"n": int(preds.shape[0]),
               "predictions": preds.tolist(),
               "probabilities": np.round(probs, 6).tolist()}
        if self.class_names:
            out["labels"] = [self.class_names[i] for i in preds]
        return out

    def make_server(self, host: str = "0.0.0.0", port: int = 8577
                    ) -> ThreadingHTTPServer:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, code: int, payload: dict,
                      close: bool = False) -> None:
                raw = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                if close:
                    # rejecting without reading the body: end the
                    # connection rather than parse the body as a request
                    self.send_header("Connection", "close")
                    self.close_connection = True
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path == "/healthz":
                    self._send(200, outer.info())
                else:
                    self._send(404, {"error": f"no route {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path != "/predict":
                    self._send(404, {"error": f"no route {self.path}"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if not 0 < n <= _MAX_BODY:
                    self._send(413 if n else 400,
                               {"error": f"bad Content-Length {n}"},
                               close=True)
                    return
                body = self.rfile.read(n)
                try:
                    self._send(200, outer.handle_bytes(
                        body, self.headers.get("Content-Type", "")))
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # keep the server up
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})

            def log_message(self, fmt, *args):  # quiet by default
                pass

        return ThreadingHTTPServer((host, port), Handler)


def main(argv: list[str]) -> int:
    """``python -m surya_tpu_torch serve CKPT [--preset P] [--port N] ...``"""
    import argparse

    from surya_tpu_torch.core.config import get_preset, parse_cli_overrides
    from surya_tpu_torch.infer.serve import Predictor

    ap = argparse.ArgumentParser(prog="surya_tpu_torch serve")
    ap.add_argument("checkpoint", help=".npz (JAX variables), .pt or a "
                    "checkpoint directory")
    ap.add_argument("--preset", default="quadtree-fusion")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8577)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--param-dtype", default="bfloat16",
                    choices=["bfloat16", "float16", "float32"])
    ap.add_argument("--input-dtype", default="uint8",
                    choices=["float32", "bfloat16", "uint8"],
                    help="image wire format (uint8 raw pixels is the "
                         "production default: 4x smaller requests, /255 "
                         "on the device)")
    ap.add_argument("--classes", default=None,
                    help="JSON list of class names for the 'labels' "
                         "response field")
    args, rest = ap.parse_known_args(argv)
    cfg = get_preset(args.preset)
    if rest:
        cfg = cfg.override(parse_cli_overrides(rest))
    class_names = None
    if args.classes:
        with open(args.classes) as f:
            class_names = json.load(f)
        if len(class_names) < cfg.model.num_classes:
            raise SystemExit(
                f"--classes lists {len(class_names)} names but the "
                f"model has {cfg.model.num_classes} classes; every "
                "/predict with labels would 500 on IndexError")

    predictor = Predictor(cfg.model, load_state_dict(args.checkpoint),
                          batch_size=args.batch_size,
                          image_size=cfg.data.image_size,
                          param_dtype=getattr(torch, args.param_dtype),
                          input_dtype=args.input_dtype)
    server = PredictionServer(predictor, class_names)
    httpd = server.make_server(args.host, args.port)
    print(json.dumps({"serving": f"http://{args.host}:{args.port}",
                      **server.info()}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0
