"""CLI of the PyTorch port (``train`` and ``eval`` come with the training
loop; the train step itself is ``surya_tpu_torch.train``).

  python -m surya_tpu_torch list-presets
  python -m surya_tpu_torch serve CKPT [--preset P] [--port 8577] [--classes names.json]

CKPT is a ``.npz`` of a JAX variable tree (``/``-joined keys) or a
``.pt`` of the port's own ``state_dict``. ``serve`` runs on the card.
"""

from __future__ import annotations

import sys


def cmd_list_presets() -> int:
    from surya_tpu_torch.core.config import get_preset, list_presets

    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name:28s} model={cfg.model.name:20s} "
              f"bs={cfg.data.batch_size:<3d} lr={cfg.train.lr:g} "
              f"epochs={cfg.train.epochs}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "list-presets":
        return cmd_list_presets()
    if cmd == "serve":
        from surya_tpu_torch.infer.http_server import main as serve_main

        return serve_main(rest)
    print(f"unknown command {cmd!r}\n{__doc__}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
