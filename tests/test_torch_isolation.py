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
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import buffers_from_numpy, params_from_jax
    from repro_torch.core.hashing import seed_stream
    from repro_torch.core.memory import init_memory
    from repro_torch.core.signatures import (planted_dense_store,
                                             synthetic_dense_store)
    from repro_torch.core.signatures import synthetic_signature_store
    from repro_torch.dist.collectives import run_ranks
    from repro_torch.embed import EmbeddingTable
    from repro_torch.launch import train as launcher
    from repro_torch.models import transformer
    from repro_torch.models.recsys import Recsys
    from repro_torch.resilience.faults import FaultInjector
    from repro_torch.optim.optimizers import adagrad
    from repro_torch.tier import TieredStore
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("dlrm-rm2").make_smoke()
    dcn, din = (get_config(a).make_smoke() for a in ("dcn-v2", "din"))
    freq = get_config("dlrm-rm2").make_smoke(embedding_kind="freq")
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
        "Recsys xdeepfm": lambda: Recsys(
            get_config("xdeepfm").make_smoke()),
        "Recsys dcn": lambda: Recsys(dcn),
        "Recsys din": lambda: Recsys(din),
        "params_from_jax dcn": lambda: params_from_jax(
            {"embedding": {}, "cross": {}, "deep": {}, "head": {}}, dcn),
        "params_from_jax din": lambda: params_from_jax(
            {"embedding": {}, "att": {}, "head": {}}, din),
        "buffers_from_numpy freq": lambda: buffers_from_numpy(
            {"freq_hot_ids": np.arange(4, dtype=np.int32)}),
        "EmbeddingTable.make_buffers freq": lambda: EmbeddingTable(
            freq.embedding).make_buffers(np.ones(freq.embedding.total_vocab)),
        "Trainer": lambda: Trainer(TrainerConfig(1), None,
                                   torch.nn.Linear(2, 2), adagrad(0.1),
                                   None),
        "Trainer durable": lambda: Trainer(
            TrainerConfig(1, ckpt_dir=os.devnull + "-never-made",
                          ckpt_delta=True), None, torch.nn.Linear(2, 2),
            adagrad(0.1), None, faults=FaultInjector("nan_grad@0")),
        "launcher durable": lambda: launcher.main(
            ["--smoke", "--steps", "1", "--ckpt-dir",
             os.devnull + "-never-made", "--ckpt-delta", "--faults",
             "nan_grad@0"]),
        "EmbeddingTable.make_buffers csr": lambda: EmbeddingTable(
            cfg.embedding).make_buffers(synthetic_signature_store(
                cfg.embedding.total_vocab, 3, 4)),
        "TieredStore": lambda: TieredStore(np.zeros(1024, np.float32), 256,
                                           block=128, stage_blocks=2),
        "launcher tiered": lambda: launcher.main(
            ["--arch", "din", "--smoke", "--steps", "1",
             "--tier-budget-mb", "0.01"]),
        "run_ranks data": lambda: run_ranks(print, 4, data=2),
        "launcher exchange": lambda: launcher.main(
            ["--smoke", "--steps", "1", "--exchange", "ring"]),
        "Transformer deepseek": lambda: transformer.init(
            get_config("deepseek-v3-671b").make_smoke()),
        "Transformer llama4": lambda: transformer.init(
            get_config("llama4-scout-17b-a16e").make_smoke()),
    }


@pytest.mark.parametrize("name", ["seed_stream", "buffers_from_numpy",
                                  "params_from_jax", "init_memory",
                                  "synthetic_dense_store",
                                  "planted_dense_store",
                                  "EmbeddingTable.init", "Recsys",
                                  "Recsys xdeepfm", "Recsys dcn",
                                  "Recsys din", "params_from_jax dcn",
                                  "params_from_jax din",
                                  "buffers_from_numpy freq",
                                  "EmbeddingTable.make_buffers freq",
                                  "Trainer", "Trainer durable",
                                  "launcher durable",
                                  "EmbeddingTable.make_buffers csr",
                                  "TieredStore", "launcher tiered",
                                  "run_ranks data", "launcher exchange",
                                  "Transformer deepseek",
                                  "Transformer llama4"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """With no device named, tensors go to the card; without one, raise."""
    import torch

    from repro_torch.dist import exchange as exl
    monkeypatch.setattr(exl, "FORCED", exl.FORCED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_guard_and_sharded_restore_take_no_device(tmp_path, monkeypatch):
    """``ExchangeGuard`` and the sharded checkpoint restore make no tensor
    on any device of their own: the guard compares what its probe returns,
    and the restore gives host arrays, a rank's slab of each pool leaf
    (``slab_shardings``)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.dist import exchange as exl
    from repro_torch.dist.context import Mesh
    from repro_torch.dist.sharding import slab_shardings
    from repro_torch.resilience.exchange_guard import ExchangeGuard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        assert ExchangeGuard(lambda name: np.zeros(3, np.float32),
                             log=lambda _: None).validate() == "all_to_all"
    finally:
        exl.reset_demotions()
    pool = np.arange(8, dtype=np.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": {"embedding": {"memory": pool}},
                 "opt_state": {"w": np.ones(3, np.float32)},
                 "step": np.asarray(2, np.int32)})
    step, tree = mgr.restore(shardings=slab_shardings(Mesh(model=4, rank=1)))
    assert step == 2
    np.testing.assert_array_equal(tree["params"]["embedding"]["memory"],
                                  pool[2:4])
    np.testing.assert_array_equal(tree["opt_state"]["w"], np.ones(3))
    assert isinstance(tree["params"]["embedding"]["memory"], np.ndarray)


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.configs as c, repro_torch.models.recsys\n"
            "import repro_torch.serve, repro_torch.convert\n"
            "import repro_torch.kernels.build\n"
            "import repro_torch.kernels.embedding_bag.ops\n"
            "import repro_torch.kernels.sparse_update.ops\n"
            "import repro_torch.launch.train, repro_torch.optim.sparse\n"
            "import repro_torch.dist.sharded_memory as sm\n"
            "from repro_torch.dist.context import Mesh, use_mesh\n"
            "with use_mesh(Mesh(model=4, rank=1)) as mesh:\n"
            "    assert mesh.shape == {'data': 1, 'model': 4}\n"
            "assert Mesh(model=2, rank=1, data=2, data_rank=1).world_rank == 3\n"
            "from repro_torch.resilience.exchange_guard import ExchangeGuard\n"
            "from repro_torch.resilience.faults import wrap_exchange\n"
            "from repro_torch.dist.sharding import slab_shardings\n"
            "import repro_torch.embed.freq\n"
            "from repro_torch.data.synthetic_ctr import DINGenerator, DINSpec\n"
            "from repro_torch.embed import list_schemes\n"
            "assert len(list_schemes()) == 7, list_schemes()\n"
            "DINGenerator(DINSpec(n_items=50, n_clusters=5)).batch(2, 0)\n"
            "import repro_torch.models.transformer as tt\n"
            "import repro_torch.nn.moe\n"
            "from repro_torch.serve import LMServer\n"
            "from repro_torch.data.lm_data import LMGenerator\n"
            "import repro_torch.models.gnn as gnn\n"
            "from repro_torch.data.graph import sbm_graph, NeighborSampler\n"
            "NeighborSampler(sbm_graph(30, 60, 4, 3), (2,)).sample([0, 1])\n"
            "assert c.get_config('gat-cora').family == 'gnn'\n"
            "for a in c.list_archs():\n"
            "    cfg = c.get_config(a).make_smoke()\n"
            "    if c.get_config(a).family == 'lm':\n"
            "        tt.init(cfg, device='cpu')\n"
            "    elif c.get_config(a).family == 'gnn':\n"
            "        gnn.init(cfg, device='cpu')\n"
            "    else:\n"
            "        repro_torch.models.recsys.init(cfg, device='cpu')\n"
            "for k in ('qr', 'md', 'freq'):\n"
            "    cfg = c.get_config('dlrm-rm2').make_smoke(embedding_kind=k)\n"
            "    repro_torch.models.recsys.init(cfg, device='cpu')\n"
            "import tempfile, numpy as np\n"
            "from repro_torch.checkpoint.manager import CheckpointManager\n"
            "from repro_torch.resilience import chaos, faults, guard\n"
            "from repro_torch.resilience import integrity\n"
            "from repro_torch.convert import state_to_jax, state_from_jax\n"
            "from repro_torch.core.minhash import gather_ragged_sets\n"
            "from repro_torch.core.signatures import "
            "synthetic_signature_store\n"
            "d = tempfile.mkdtemp()\n"
            "m = CheckpointManager(d, delta=True)\n"
            "m.save(0, {'params': {'memory': np.ones(9000, np.float32)}})\n"
            "assert m.restore()[0] == 0\n"
            "faults.FaultInjector(chaos.make_schedule(48, seed=1))\n"
            "assert guard.guard_enabled()\n"
            "synthetic_signature_store(5, 2, 4)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


class _OnCard:
    """Stands for a 1-D tensor on the card (this test runs without one)."""
    is_cuda = True
    device = "cuda:0"

    def dim(self):
        return 1


@pytest.mark.parametrize("name", ["fused_locations", "sparse_update", "cin",
                                  "sparse_sgd", "sparse_adam",
                                  "embedding_bag"])
def test_card_tensors_go_to_the_kernels(name, monkeypatch):
    """A tensor on the card goes to the CUDA kernel, never to the plain
    version; a CPU tensor to the plain version."""
    import types

    import torch

    from repro_torch.kernels.cin import ops as ci
    from repro_torch.kernels.fused_embed import ops as fe
    from repro_torch.kernels.sparse_update import ops as su

    calls = []
    if name == "cin":
        monkeypatch.setattr(ci, "cin_cuda", lambda *a: calls.append("kernel"))
        monkeypatch.setattr(ci, "cin_ref", lambda *a: calls.append("plain"))
        ctx = types.SimpleNamespace(save_for_backward=lambda *a: None)
        ci._CIN.forward(ctx, _OnCard(), None, None)
        ci._CIN.forward(ctx, torch.zeros((2, 3, 4)), None, None)
    elif name == "fused_locations":
        monkeypatch.setattr(fe, "fused_locations_cuda",
                            lambda *a: calls.append("kernel"))
        monkeypatch.setattr(fe, "locations_ref",
                            lambda *a: calls.append("plain"))
        spec = fe.hashed_spec("hashed_elem", 4, 64, 0)
        fe.fused_locations(spec, _OnCard())
        fe.fused_locations(spec, torch.zeros(3, dtype=torch.int32))
    elif name == "embedding_bag":
        from repro_torch.kernels.embedding_bag import ops as eb
        monkeypatch.setattr(eb, "embedding_bag_cuda",
                            lambda *a: calls.append("kernel"))
        monkeypatch.setattr(eb, "embedding_bag_ref",
                            lambda *a: calls.append("plain"))
        eb.embedding_bag(_OnCard(), None, None)
        eb.embedding_bag(torch.zeros((4, 2)), None, None)
    else:
        algo = {"sparse_update": "adagrad", "sparse_sgd": "sgd",
                "sparse_adam": "adam"}[name]
        monkeypatch.setattr(su, f"sparse_{algo}_cuda",
                            lambda *a, **k: calls.append("kernel"))
        monkeypatch.setattr(su, f"sparse_{algo}_ref",
                            lambda *a, **k: calls.append("plain"))
        n = 2 if algo == "adam" else 1
        hyper = {"momentum": 0.9} if algo == "sgd" else {}
        su.sparse_update(algo, None, torch.zeros(3), (_OnCard(),) * n,
                         lr=0.1, **hyper)
        su.sparse_update(algo, None, torch.zeros(3), (torch.zeros(4),) * n,
                         lr=0.1, **hyper)
    assert calls == ["kernel", "plain"]
