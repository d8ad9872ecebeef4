"""ray_tpu_torch stands alone: no JAX, nothing of ray_tpu, no silent CPU path."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu")


def test_import_pulls_in_no_jax_and_no_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.models, ray_tpu_torch.ops.attention, "
        "ray_tpu_torch.ops.losses, ray_tpu_torch.ops._build, ray_tpu_torch.models.generate, "
        "ray_tpu_torch.serve, ray_tpu_torch.serve.llm\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_raise_without_a_card():
    from ray_tpu_torch.models import TransformerConfig, adamw, init_params, make_train_step
    from ray_tpu_torch.models.generate import init_cache, init_paged_cache

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=1, n_kv_heads=1, d_ff=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, adamw(params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(cfg, 4, 4)
