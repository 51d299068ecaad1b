"""The port's ``repro_torch.dist.flash_decode.sharded_flash_decode`` on 4
gloo ranks (CPU) against the reference's live ``sharded_flash_decode`` on
4 forced host devices, on the (1, 4), (2, 2) and (4, 1) meshes.

The reference runs in one subprocess for the file (``lm_mesh_reference.py``:
``XLA_FLAGS`` must precede JAX's import), beside one ``run_ranks`` spawn a
mesh.  Cases (``lm_mesh_ranks.fd_cases``): float and int8 caches, B = 4
and 1, a mid-cache write, ``cache_len = L`` (the write clamps to L - 1),
an L that only 'model' divides, one that the mesh cannot shard (the
``_unsharded`` fallback), MLA's shared K/V.  Each rank's slab of the
updated cache and scales is bit-equal to the reference's at the same
rows; ``o`` (the whole batch's, on every rank) within 1e-6 of the
reference's largest |o| (the port sums each slab a block at a time, the
reference in one softmax).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_mesh_ranks as lr  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.dist.flash_decode import plan  # noqa: E402
from repro_torch.dist.context import Mesh  # noqa: E402

HERE = Path(__file__).resolve().parent
O_TOL = 1e-6


def reference(path: Path, kind: str) -> subprocess.Popen:
    """Start ``lm_mesh_reference.py`` writing ``path``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, str(HERE / "lm_mesh_reference.py"),
                             str(path), kind], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def finish(proc: subprocess.Popen, path: Path) -> dict:
    out, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, out.decode()[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("fd") / "ref.npz"
    proc = reference(path, "flash")
    cases = lr.fd_cases()
    ranks = {m: run_ranks(lr.flash_rank, m[0] * m[1], cases, data=m[0],
                          device="cpu") for m in lr.MESHES}
    return cases, ranks, finish(proc, path)


def test_plan_matches_the_cache_rules():
    """``plan`` gives the axes ``LM_CACHE_RULES`` resolves for B and L."""
    from repro_torch.dist.sharding import LM_CACHE_RULES, spec_for_path
    for D, M in lr.MESHES:
        mesh = Mesh(model=M, data=D)
        for B in (1, 2, 4, 3):
            for L in (16, 18, 17):
                spec = spec_for_path("/layers_0/k", (2, B, L, 2, 8),
                                     LM_CACHE_RULES, mesh)
                got = plan(mesh, lr.DP_AXES, B, L)
                seq = spec[2] if isinstance(spec[2], tuple) else \
                    ((spec[2],) if spec[2] else ())
                bat = spec[1] if isinstance(spec[1], tuple) else \
                    ((spec[1],) if spec[1] else ())
                if got is None:
                    assert not seq, (D, M, B, L, spec)
                else:
                    assert got == (bat, seq), (D, M, B, L, spec, got)


@pytest.mark.parametrize("mesh", lr.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_flash_decode_matches_reference(runs, mesh):
    cases, ranks, ref = runs
    tag = f"{mesh[0]}x{mesh[1]}"
    sharded = 0
    for i, case in enumerate(cases):
        want_o = ref[f"flash/{tag}/{i}/o"]
        scale = float(np.abs(want_o).max())
        names = ["k"] + ([] if case["mla"] else ["v"])
        if case["quant"]:
            names += ["ks"] + ([] if case["mla"] else ["vs"])
        for rank in ranks[mesh]:
            r = rank[i]
            np.testing.assert_allclose(r["o"], want_o, rtol=0,
                                       atol=O_TOL * scale,
                                       err_msg=f"{tag} case {case}")
            (b0, b1), (lo, hi) = r["rows"], r["pos"]
            sharded += (hi - lo) < case["L"]
            for name in names:
                want = ref[f"flash/{tag}/{i}/{name}"][b0:b1, lo:hi]
                np.testing.assert_array_equal(
                    r[name], want, err_msg=f"{tag} {name} case {case}")
    assert sharded > 0


def test_clamp_and_fallback_cases_ran(runs):
    """The clamp wrote the last row on exactly one slab of each replica
    set, and the fallback held whole caches."""
    cases, ranks, _ = runs
    for mesh, rs in ranks.items():
        for i, case in enumerate(cases):
            pl = plan(Mesh(model=mesh[1], data=mesh[0]), lr.DP_AXES,
                      case["B"], case["L"])
            for rank in rs:
                whole = rank[i]["pos"] == (0, case["L"])
                assert whole == (pl is None), (mesh, case)
            if case["pos"] == case["L"] and pl is not None:
                owners = {rank[i]["rows"] for rank in rs
                          if rank[i]["pos"][1] == case["L"]}
                assert owners, (mesh, case)
