"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` load
without ``jax`` and without the JAX package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_serve_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {"repro_torch.serve", "repro_torch.serve.engine"} <= modules


def test_moe_serving_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.configs", "repro_torch.configs.base",
        "repro_torch.configs.deepseek_v2_236b", "repro_torch.configs.deepseek_v3_671b",
        "repro_torch.core.moe_balancer", "repro_torch.kernels.moe_route",
        "repro_torch.models", "repro_torch.models.common", "repro_torch.models.flash",
        "repro_torch.models.mla", "repro_torch.models.ffn", "repro_torch.models.transformer",
        "repro_torch.models.model", "repro_torch.models.convert",
    } <= modules


def test_dense_serving_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.kernels.flash_attn", "repro_torch.models.attention",
        "repro_torch.configs.gemma2_9b", "repro_torch.configs.qwen3_0p6b",
        "repro_torch.configs.qwen1p5_4b", "repro_torch.configs.smollm_135m",
        "repro_torch.configs.chameleon_34b",
    } <= modules


def test_dispatcher_slice_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.core.dispatch_sim", "repro_torch.examples.quickstart",
        "repro_torch.examples.serve_care", "repro_torch.examples.serve_stream",
    } <= modules


def test_family_serving_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.models.ssm", "repro_torch.configs.hymba_1p5b",
        "repro_torch.configs.rwkv6_1p6b", "repro_torch.configs.whisper_small",
    } <= modules


def test_sharding_slice_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.models.parallel", "repro_torch.models.partitioning",
        "repro_torch.launch.mesh",
    } <= modules


def test_launch_tooling_modules_are_checked():
    modules = {_module_name(p) for p in FILES if p.parent != ROOT}
    assert {
        "repro_torch.launch.model_stats", "repro_torch.launch.op_analysis",
        "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
        "repro_torch.launch.op_breakdown", "repro_torch.examples.multipod_dryrun",
    } <= modules


def test_every_module_imports_without_jax():
    modules = [_module_name(p) for p in FILES if p.parent != ROOT]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_loads_the_card_tests_without_jax():
    # chip_smoke.py takes its serve_slots cases from tests/test_torch_cuda.py.
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "module = chip_smoke._card_tests()\n"
        "assert module.SLOTS_CASES and callable(module.slots_vs_dense)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path.name} imports {name}"
            )
