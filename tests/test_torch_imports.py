"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, and its config tree is the JAX one, preset for preset."""

import os
import pkgutil
import subprocess
import sys

import pytest

from surya_tpu.core import config as jax_config
from surya_tpu_torch.core import config as torch_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import surya_tpu_torch

    names = ["surya_tpu_torch"]
    for m in pkgutil.walk_packages(surya_tpu_torch.__path__,
                                   "surya_tpu_torch."):
        names.append(m.name)
    return names


def test_port_imports_without_jax():
    """Every port module and chip_smoke.py import with jax, flax, optax,
    orbax and surya_tpu blocked."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax", "surya_tpu"]
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{b!r}] = None" for b in blocked],
        f"for name in {_port_modules() + ['chip_smoke']!r}:",
        "    importlib.import_module(name)",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{blocked!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('ok')",
    ])
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_preset_names_match():
    assert torch_config.list_presets() == jax_config.list_presets()
    assert len(torch_config.list_presets()) == 16


@pytest.mark.parametrize("name", jax_config.list_presets())
def test_preset_to_dict_matches_jax(name):
    assert (torch_config.get_preset(name).to_dict()
            == jax_config.get_preset(name).to_dict())


def test_overrides_match_jax():
    argv = ["--train.lr=3e-4", "--model.dropout=0.2",
            "--model.use_pallas=yes", "--data.batch_size=64"]
    want = jax_config.get_preset("quadtree-fusion").override(
        jax_config.parse_cli_overrides(argv))
    got = torch_config.get_preset("quadtree-fusion").override(
        torch_config.parse_cli_overrides(argv))
    assert got.to_dict() == want.to_dict()
    with pytest.raises(KeyError):
        torch_config.get_preset("quadtree-fusion").override({"model.x": 1})
