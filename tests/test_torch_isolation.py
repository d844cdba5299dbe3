"""The PyTorch port stands alone: no module of ``poseidon_tpu_torch`` (nor
``chip_smoke.py`` or ``bench_torch.py``) imports JAX, flax, optax or the JAX package, the package
imports with JAX blocked, and its entry points refuse to fall back to the
CPU when CUDA is absent."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import poseidon_tpu_torch as pt

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "poseidon_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _port_files():
    return sorted((ROOT / "poseidon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "bench_torch.py"]


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) > 10
    for path in files:
        bad = set(_imported_roots(path)) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'poseidon_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import poseidon_tpu_torch, poseidon_tpu_torch.hub, poseidon_tpu_torch.ops\n"
            "import poseidon_tpu_torch.ops.mlp, poseidon_tpu_torch.ops._build\n"
            "import poseidon_tpu_torch.ops.window_attention, poseidon_tpu_torch.training.rollout\n"
            "import poseidon_tpu_torch.training.optimizer, poseidon_tpu_torch.training.trainer\n"
            "import poseidon_tpu_torch.metrics, poseidon_tpu_torch.parallel.host\n"
            "import poseidon_tpu_torch.parallel, poseidon_tpu_torch.parallel.mesh\n"
            "import poseidon_tpu_torch.data.registry, poseidon_tpu_torch.data.loader\n"
            "import poseidon_tpu_torch.data.fluids, poseidon_tpu_torch.data.elliptic\n"
            "import poseidon_tpu_torch.data.wave, poseidon_tpu_torch.data.reaction_diffusion\n"
            "import poseidon_tpu_torch.inference, poseidon_tpu_torch.train\n"
            "import poseidon_tpu_torch.utils.params, poseidon_tpu_torch.utils.plotting\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax') and sys.modules[m] is not None\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_clis_and_hub_need_no_optional_package(tmp_path):
    # The card's machine may lack any of these: both CLIs import, and a
    # checkpoint directory is written and read, without them.
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'poseidon_tpu', 'yaml', 'matplotlib', 'wandb',\n"
            "          'safetensors', 'huggingface_hub', 'h5py'):\n"
            "    sys.modules[m] = None\n"
            "import poseidon_tpu_torch as pt\n"
            "import poseidon_tpu_torch.inference, poseidon_tpu_torch.train\n"
            "import poseidon_tpu_torch.utils.params, poseidon_tpu_torch.utils.plotting\n"
            "cfg = pt.make_config('T', image_size=32, num_channels=2, num_out_channels=2,\n"
            "                     embed_dim=16, depths=(2, 2), num_heads=(2, 2),\n"
            "                     skip_connections=(1, 0), window_size=4)\n"
            "m = pt.build_model(cfg, device='cpu')\n"
            f"pt.save_pretrained(m, {str(tmp_path)!r})\n"
            f"back = pt.from_pretrained({str(tmp_path)!r}, device='cpu')\n"
            "sd = m.state_dict()\n"
            "assert all((back.state_dict()[k] == v).all() for k, v in sd.items())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_build_model_needs_cuda_or_explicit_cpu():
    cfg = pt.make_config("T", image_size=32, num_channels=2, num_out_channels=2,
                         embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                         skip_connections=(1, 0), window_size=4)
    assert next(pt.build_model(cfg, device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.build_model(cfg)


def test_build_model_is_seeded():
    cfg = pt.make_config("T", image_size=32, num_channels=2, num_out_channels=2,
                         embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                         skip_connections=(1, 0), window_size=4)
    a = pt.build_model(cfg, device="cpu", seed=3).state_dict()
    b = pt.build_model(cfg, device="cpu", seed=3).state_dict()
    c = pt.build_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_kernels_not_built_on_import():
    # Importing builds nothing: the build directory is only made by a build.
    from poseidon_tpu_torch.ops import _build

    assert _build._libs == {}
