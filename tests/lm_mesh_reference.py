"""The reference's sharded LM primitives on forced host devices, run as a
script in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/lm_mesh_reference.py OUT.npz {flash,moe}
    XLA_FLAGS=... python tests/lm_mesh_reference.py OUT.pkl train IN.pkl

``XLA_FLAGS`` must be set before JAX is imported, which a test process
has already done with one device.  Every case of ``lm_mesh_ranks`` runs
through ``repro.dist.flash_decode.sharded_flash_decode`` or
``repro.nn.moe.moe_apply_sharded`` on the (1, 4), (2, 2) and (4, 1)
meshes, jitted (an eager ``shard_map`` compiles op by op, seconds a
call); each output is turned into numpy before any further JAX call on it
(an op on a still-sharded output is where the reference's own test
breaks) and saved as ``{kind}/{D}x{M}/{i}/{name}``.

``train`` takes the pickled ``{name: (config, params, batches)}`` of
``test_torch_lm_mesh_train.py`` and runs each config's steps under the
installed (2, 2) mesh (``Auto`` axes, which ``with_sharding_constraint``
needs): ``jax.grad`` of ``transformer.loss_fn``, whose MoE layers take
``moe_apply_sharded``, then the launcher's optimizer; it pickles each
case's losses, first gradients and last parameters.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lm_mesh_ranks as lr  # noqa: E402
from repro.dist.flash_decode import sharded_flash_decode  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402


def flash(mesh, tag: str, out: dict) -> None:
    for i, case in enumerate(lr.fd_cases()):
        a = {k: jnp.asarray(v) for k, v in lr.fd_inputs(case, i).items()}
        kw = {}
        if case["quant"]:
            kw = dict(k_scale=a["ks"], v_scale=a["vs"],
                      k_scale_new=a["ksn"], v_scale_new=a["vsn"])

        def fn(q, k, v, kn, vn, pos, kw):
            return sharded_flash_decode(
                q, k, v, kn, vn, pos, sm_scale=1.0 / np.sqrt(lr.FD_HD),
                mesh=mesh, dp_axes=lr.DP_AXES, **kw)
        res = jax.jit(fn)(a["q"], a["k"], a["v"], a["kn"], a["vn"],
                          jnp.asarray(case["pos"], jnp.int32), kw)
        res = [np.asarray(r) for r in res]
        names = ("o", "k", "v", "ks", "vs")[:len(res)]
        for name, r in zip(names, res):
            out[f"flash/{tag}/{i}/{name}"] = r


def moe(mesh, shape: tuple, tag: str, out: dict) -> None:
    for i, case in enumerate(lr.moe_cases(shape)):
        a = lr.moe_inputs(case, i)
        cfg = jmoe.MoEConfig(lr.MOE_D, lr.MOE_F, case["E"], lr.MOE_K,
                             n_shared_experts=1, router=case["router"],
                             capacity_factor=case["cf"])
        p = {"router": {"kernel": a["router"]},
             **{k: a[k] for k in ("w_gate", "w_up", "w_down")},
             "shared": {n: {"kernel": a[f"shared_{n}"]}
                        for n in ("gate", "up", "down")}}
        p = jax.tree_util.tree_map(jnp.asarray, p)
        y, aux = jax.jit(lambda p, x: jmoe.moe_apply_sharded(
            p, cfg, x, mesh, lr.DP_AXES, full_token_sharding=case["full"],
            lead=case["lead"]))(p, jnp.asarray(a["x"]))
        out[f"moe/{tag}/{i}/out"] = np.asarray(y)
        out[f"moe/{tag}/{i}/aux"] = np.asarray(aux)


def train(in_path: str, out_path: str) -> None:
    import pickle

    from jax.sharding import AxisType

    from repro.configs.base import get_config
    from repro.dist.context import use_mesh
    from repro.launch import train as jlaunch
    from repro.models import transformer as jt
    from repro.optim import optimizers as jopt

    with open(in_path, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, (jcfg, params, batches) in cases.items():
        params = jax.tree_util.tree_map(jnp.asarray, params)
        opt = jlaunch.make_optimizer(get_config(name.split("+")[0]))
        with use_mesh(mesh):
            vg = jax.jit(jax.value_and_grad(
                lambda p, t, y: jt.loss_fn(p, jcfg, t, y)[0]))
            update = jax.jit(opt.update)
            state = opt.init(params)
            losses, grads = [], None
            for s in range(len(batches["tokens"])):
                loss, g = vg(params, jnp.asarray(batches["tokens"][s]),
                             jnp.asarray(batches["labels"][s]))
                g = jax.tree_util.tree_map(np.asarray, g)
                losses.append(float(loss))
                grads = g if grads is None else grads
                upd, state = update(g, state, params)
                params = jax.tree_util.tree_map(
                    np.asarray, jopt.apply_updates(params, upd))
        out[name] = {"losses": losses, "grads": grads, "params": params}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def main(path: str, kind: str) -> None:
    out = {}
    for D, M in lr.MESHES:
        mesh = jax.make_mesh((D, M), ("data", "model"))
        tag = f"{D}x{M}"
        if kind == "flash":
            flash(mesh, tag, out)
        else:
            moe(mesh, (D, M), tag, out)
    np.savez(path, **out)


if __name__ == "__main__":
    if sys.argv[2] == "train":
        train(sys.argv[3], sys.argv[1])
    else:
        main(sys.argv[1], sys.argv[2])
