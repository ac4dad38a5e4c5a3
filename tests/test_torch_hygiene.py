"""Import hygiene of the PyTorch port: ``ddlb_tpu_torch/`` and
``chip_smoke.py`` import neither JAX nor the JAX package ``ddlb_tpu``
(``ddlb_tpu_torch`` itself is of course allowed)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "ddlb_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py",
    REPO / "scripts" / "telemetry_cards.py",
    REPO / "scripts" / "time_trace_overhead.py",
    REPO / "scripts" / "perfmodel_cards.py",
]
BANNED = ("jax", "jaxlib", "ddlb_tpu")


def banned_imports(source: str):
    """(line, module) of every import of a banned package or submodule."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in BANNED:
                found.append((node.lineno, name))
    return found


def test_port_files_exist():
    assert (REPO / "chip_smoke.py").is_file()
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    assert banned_imports(path.read_text()) == []


@pytest.mark.parametrize(
    "source,hits",
    [
        ("import jax", [(1, "jax")]),
        ("import jax.numpy as jnp", [(1, "jax.numpy")]),
        ("from jax import lax", [(1, "jax")]),
        ("import ddlb_tpu", [(1, "ddlb_tpu")]),
        ("from ddlb_tpu.options import OptionsManager", [(1, "ddlb_tpu.options")]),
        ("def f():\n    import ddlb_tpu.native", [(2, "ddlb_tpu.native")]),
        ("import ddlb_tpu_torch.ops", []),
        ("from ddlb_tpu_torch import benchmark", []),
        ("from . import base", []),
        ("import jaxtyping", []),
    ],
)
def test_checker_catches_what_it_must(source, hits):
    assert banned_imports(source) == hits
