"""Rules of the port: it stands alone beside the JAX package.

training_operator_tpu_torch and chip_smoke.py import neither jax nor the JAX
package (training_operator_tpu), not even its numpy-only modules; without a
card the entry points refuse to default to one, and the kernel loader
raises rather than fall back.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "training_operator_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "training_operator_tpu"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) >= 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [
        "training_operator_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    ]
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in modules)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        + repr(sorted(FORBIDDEN)) + ")\n"
        + "assert not bad, bad\n"
        + "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_loader_raises_without_nvcc(monkeypatch):
    from training_operator_tpu_torch.trainer import kernels

    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(kernels.os, "access", lambda *a: False)
    monkeypatch.setattr(kernels, "_loaded", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.load()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card the script exits non-zero and prints no result line;
    alone in a directory (without the package) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
