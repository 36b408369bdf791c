"""The port stands alone: neither repro_torch nor chip_smoke.py imports JAX
or the JAX package, importing the port builds and probes nothing, and its
entry points never fall back to the CPU on their own."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    # the distributed tests' spawned ranks run tests/_torch_dist_world.py
    # with the port alone
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tests" / "_torch_dist_world.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_and_smoke_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 10
    # the mesh control plane and the training pipeline's modules are walked
    # and so are the training testbed's
    for part in ("launch/mesh_plane.py", "configs/base.py", "configs/archs.py",
                 "data/selection.py", "distributed/sharding.py", "models/layers.py",
                 "models/attention.py", "models/model.py", "models/moe.py",
                 "models/mamba.py", "data/pipeline.py",
                 "train/optim.py", "train/grad_compress.py", "train/train_step.py",
                 "launch/train.py", "tree.py"):
        assert PORT / part in files, part
    bad = [
        f"{path.relative_to(ROOT)}:{line} imports {root}"
        for path in files
        for root, line in _imported_roots(ast.parse(path.read_text()))
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_no_module_level_device_probe():
    """Whether there is a card is decided inside calls, never at import."""
    bad = []
    for path in _port_files():
        for stmt in ast.parse(path.read_text()).body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if "is_available" in ast.unparse(stmt) or "import triton" in ast.unparse(stmt):
                bad.append(f"{path.relative_to(ROOT)}:{stmt.lineno}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.interop\n"
        "import repro_torch.launch.serve, repro_torch.launch.async_serve\n"
        "import repro_torch.launch.sessions, repro_torch.ckpt.checkpoint\n"
        "import repro_torch.core.optimizers.distributed\n"
        "import repro_torch.launch.mesh_plane, repro_torch.configs.archs\n"
        "import repro_torch.data.selection, repro_torch.distributed.sharding\n"
        "import repro_torch.models.model, repro_torch.data.pipeline\n"
        "import repro_torch.models.moe, repro_torch.models.mamba\n"
        "import repro_torch.train.train_step, repro_torch.launch.train\n"
        "from repro_torch.kernels import _build, ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert _build._lib is None and not _build.BUILD_INFO\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_default_to_the_card():
    """Without a card, numpy input and no device= must raise, naming the
    missing device, rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.core import FacilityLocation, create_kernel
    from repro_torch.interop import facility_location_from_arrays, params_from_arrays

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import run
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.train.train_step import init_train_state

    x = np.ones((4, 3), np.float32)
    cfg = get_config("qwen3-0.6b").reduced()
    calls = [
        lambda: create_kernel(x),
        lambda: FacilityLocation.from_kernel(x),
        lambda: facility_location_from_arrays(x),
        lambda: init_params(cfg),
        lambda: init_train_state(cfg),
        lambda: init_cache(cfg, 1, 8),
        lambda: SyntheticTokens(cfg, 8).batch([0]),
        lambda: run("qwen3-0.6b", steps=1, batch=1, seq=8),
    ]
    # the moe, ssm, hybrid and audio families (models/moe.py, models/mamba.py)
    for arch in ("deepseek-v2-236b", "mamba2-370m", "jamba-1.5-large-398b", "whisper-small"):
        other = get_config(arch).reduced()
        calls += [lambda c=other: init_params(c), lambda c=other: init_cache(c, 1, 8),
                  lambda c=other: params_from_arrays(c, {"embed": x}),
                  lambda a=arch: run(a, steps=1, batch=1, seq=8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert create_kernel(x, device="cpu").shape == (4, 4)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where there is no
    card, and where it stands alone without the repo's src/."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs = [[sys.executable, str(alone)]]
    if not torch.cuda.is_available():
        runs.append([sys.executable, str(ROOT / "chip_smoke.py")])
    for cmd in runs:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
