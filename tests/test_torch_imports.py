"""The port stands apart from the JAX package, and its chip smoke refuses
to run without a card."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    for root, _, names in os.walk(PORT):
        for name in sorted(names):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")
    # what the ranks of the distributed tests run
    tests = os.path.join(REPO, "tests")
    for name in sorted(os.listdir(tests)):
        if name.startswith("torch_") and name.endswith(".py"):
            yield os.path.join(tests, name)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", list(_port_files()), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
