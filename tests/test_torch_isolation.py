"""The port stands alone: neither the torch package nor chip_smoke.py
imports ``jax`` or anything of ``openekfmonoslam_tpu``."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import openekfmonoslam_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "openekfmonoslam_tpu")


def test_every_port_module_imports_without_jax():
    names = sorted(m.name for m in pkgutil.walk_packages(
        openekfmonoslam_tpu_torch.__path__, "openekfmonoslam_tpu_torch."))
    for name in ("engine.step", "engine.scan_runner", "vision.frontend",
                 "vision.star", "vision.brief", "ops.star_kernel",
                 "ops.brief_kernel", "io.sources", "eval.replay",
                 "engine.engine", "engine.checkpoint", "eval.trajectory",
                 "eval.result_reader", "cli", "ops.sinv", "ops.cholsolve",
                 "eval.oracle", "eval.compare", "vision.dog", "vision.orb",
                 "vision.floatdesc", "vision.harris", "vision.fast",
                 "vision.ncc", "graph.pose_graph", "graph.loop_closure",
                 "serving.protocol", "serving.server",
                 "parallel.batch_runner", "io.native_loader", "ops.batched",
                 "viz.draw", "viz.viewer3d", "parallel.comm",
                 "parallel.sharding", "parallel.multihost"):
        assert "openekfmonoslam_tpu_torch." + name in names
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'openekfmonoslam_tpu'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imports(path: Path) -> set[str]:
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.add(node.module)
    return found


def test_no_source_of_the_port_names_the_jax_package():
    files = [ROOT / "chip_smoke.py",
             *(ROOT / "openekfmonoslam_tpu_torch").rglob("*.py")]
    for path in files:
        bad = sorted(n for n in _imports(path) if _is_forbidden(n))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
