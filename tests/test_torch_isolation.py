"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def _entry_points():
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import buffers_from_numpy, params_from_jax
    from repro_torch.core.hashing import seed_stream
    from repro_torch.core.memory import init_memory
    from repro_torch.core.signatures import (planted_dense_store,
                                             synthetic_dense_store)
    from repro_torch.embed import EmbeddingTable
    from repro_torch.models.recsys import Recsys

    cfg = get_config("dlrm-rm2").make_smoke()
    return {
        "seed_stream": lambda: seed_stream(0, 4),
        "buffers_from_numpy": lambda: buffers_from_numpy(
            {"store_lengths": np.zeros(4, np.int32)}),
        "params_from_jax": lambda: params_from_jax(
            {"embedding": {}, "bot": {}, "top": {}}, cfg),
        "init_memory": lambda: init_memory(64),
        "synthetic_dense_store": lambda: synthetic_dense_store(8, 2, 4),
        "planted_dense_store": lambda: planted_dense_store(8, 2, 4),
        "EmbeddingTable.init": lambda: EmbeddingTable(cfg.embedding).init(),
        "Recsys": lambda: Recsys(cfg),
    }


@pytest.mark.parametrize("name", ["seed_stream", "buffers_from_numpy",
                                  "params_from_jax", "init_memory",
                                  "synthetic_dense_store",
                                  "planted_dense_store",
                                  "EmbeddingTable.init", "Recsys"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """With no device named, tensors go to the card; without one, raise."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.configs as c, repro_torch.models.recsys\n"
            "import repro_torch.serve, repro_torch.convert\n"
            "import repro_torch.kernels.build\n"
            "cfg = c.get_config('dlrm-rm2').make_smoke()\n"
            "repro_torch.models.recsys.init(cfg, device='cpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
