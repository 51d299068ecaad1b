"""The port's ``adafactor`` (``repro_torch.optim.optimizers``) against
``repro.optim.optimizers.adafactor`` on the CPU, and the launcher's
``adafactor`` arm for deepseek-v3-671b.

The reference keeps an LM layer group's parameters stacked, ``[count,
...]``, and its kernels ``[in, out]``; the port keeps one module a layer
and ``weight [out, in]``.  Parameters, gradients and states cross by
``convert.lm_params_from_jax``'s naming (gradients as numpy arrays drawn
from a seed with heavy tails, so the RMS clip acts).  Each case holds one
update and three chained updates, and every state, within 1e-6 relative
of a float64 evaluation of the reference's formulas, and within a fixed
relative tolerance of the reference itself: 1e-6, but 1e-5 for the
updates of the stacked group and the MoE stack, where XLA sums the leaf's
means and RMS in float32 in an order that strays past 1e-6 (readings on
the CPU: port against reference at most 1.4e-6 and 3.8e-6 there, the
reference against float64 1.2e-6 and 3.7e-6, the port against float64
4.2e-7; every other update and every state at most 7.1e-7 from the
reference).  The cases: a factored leaf, an unfactored one, a 1-D one, a
stacked group of 3 layers below the ``_map_leading`` threshold (one clip
over the group), one stacked leaf just over ``1 << 27`` bytes (a clip per
layer), a MoE expert stack, a transposed ``weight``.  deepseek-v3-671b's smoke config trains 3 steps through the
launcher's ``make_optimizer`` and LM setup from the reference's initial
parameters, each loss within 1e-5 of the reference Trainer's; the other
registered LM archs train 2 steps through the port's launcher.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.lm_data import LMGenerator as JLMGenerator  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.checkpoint.manager import _flatten, _unflatten  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

LM_ARCHS = ["tinyllama-1.1b", "stablelm-3b", "qwen1.5-32b",
            "deepseek-v3-671b", "llama4-scout-17b-a16e"]
LR = 1e-2
RTOL = 1e-6
# the reference's float32 sums over a stacked leaf: the updates of these
# cases held to it within 1e-5 (module docstring)
REF_RTOL = {"stacked_group": 1e-5, "moe_experts": 1e-5}

# each case: a reference parameter tree (shapes; a layers_{g} leaf stacked
# over its group's count)
CASES = {
    "factored": {"embed": {"table_0": (192, 160)}},
    "unfactored": {"embed": {"table_0": (300, 64)}},
    "one_dim": {"final_norm": {"scale": (96,)}},
    "stacked_group": {"layers_0": {"ffn": {"up": {"kernel": (3, 128, 144)},
                                          "down": {"kernel": (3, 144, 40)}},
                                  "norm_ffn": {"scale": (3, 128)}}},
    # 2 x 128 x 131,073 float32: 256 bytes past 1 << 27
    "stacked_over_threshold": {"layers_0": {"moe": {
        "w_up": (2, 128, 131_073)}}},
    "moe_experts": {"layers_0": {"moe": {"w_gate": (2, 4, 128, 160),
                                        "w_down": (2, 4, 160, 128)}}},
    "transposed": {"lm_head": {"kernel": (128, 256)}},
}


def _groups(params: dict):
    """A stand-in config for ``lm_params_from_jax``: each ``layers_{g}``'s
    count from its leaves' leading axis."""
    counts = [("dense", next(iter(_flatten(params[g]).values())).shape[0])
              for g in sorted(k for k in params if k.startswith("layers_"))]
    return types.SimpleNamespace(layer_groups=lambda: counts)


def _draw(rng, shapes: dict) -> dict:
    """Heavy-tailed float32 arrays of ``shapes``' tree: ``z * exp(1.5 z')``,
    z' the normal draws z shifted by one element (one draw a leaf)."""
    def one(s):
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        z = rng.standard_normal(s, dtype=np.float32)
        return z * np.exp(np.float32(1.5) * np.roll(z, 1))
    return one(shapes)


def _zeros(shapes: dict) -> dict:
    """Parameters of ``shapes``' tree (Adafactor reads only their shapes)."""
    if isinstance(shapes, dict):
        return {k: _zeros(v) for k, v in shapes.items()}
    return np.zeros(shapes, np.float32)


def _port_states(ref_vs: dict) -> dict:
    """The reference's ``AdafactorState.vs`` -> the port's: by parameter
    name (``lm_params_from_jax``'s), a stacked leaf's states unstacked per
    layer, an unfactored kernel's ``v`` transposed with it."""
    out: dict = {}
    for path, a in _flatten(jax.tree_util.tree_map(np.asarray,
                                                   ref_vs)).items():
        *parts, leaf = path.split("/")
        kernel = parts[-1] == "kernel"
        if kernel:
            parts = parts[:-1] + ["weight"]
        layers = [(f"{parts[0]}.{i}." + ".".join(parts[1:]), a[i])
                  for i in range(a.shape[0])] \
            if parts[0].startswith("layers_") else [(".".join(parts), a)]
        for name, x in layers:
            out.setdefault(name, {})[leaf] = x.T if kernel and leaf == "v" \
                else x
    return out


def _oracle(g, v: dict, step: int, mapped: bool):
    """The reference's update of one leaf (its layout) in float64 from the
    float32 ``beta2``: -> (update, new state)."""
    if mapped:
        outs = [_oracle(g[i], {k: x[i] for k, x in v.items()}, step, False)
                for i in range(g.shape[0])]
        return (np.stack([u for u, _ in outs]),
                {k: np.stack([s[k] for _, s in outs]) for k in v})
    b2 = np.float32(1) - np.float32(step) ** np.float32(-0.8)
    b2, ob2, eps = float(b2), float(np.float32(1) - b2), 1e-30
    g = g.astype(np.float64)
    g2 = g * g + eps
    if "v_row" in v:
        row = b2 * v["v_row"] + ob2 * g2.mean(-1)
        col = b2 * v["v_col"] + ob2 * g2.mean(-2)
        r = row / np.maximum(row.mean(-1, keepdims=True), eps)
        vhat, new = r[..., :, None] * col[..., None, :], {"v_row": row,
                                                          "v_col": col}
    else:
        vhat = b2 * v["v"] + ob2 * g2
        new = {"v": vhat}
    u = g / np.sqrt(vhat + eps)
    u = u / max(1.0, np.sqrt(np.mean(u * u) + eps))
    return -LR * u, new


def _held(got, want, exact, what: str, ref_rtol: float = RTOL) -> None:
    """``got`` (the port) within RTOL of ``exact`` (the float64 oracle) and
    within ``ref_rtol`` of ``want`` (the reference), both relative."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for bad, against in (
            (np.abs(got - exact) > RTOL * np.abs(exact), "float64"),
            (np.abs(got - want) > ref_rtol * np.abs(want), "the reference")):
        if bad.any():
            i = np.flatnonzero(bad)[0]
            raise AssertionError(
                f"{what} against {against}: {bad.sum()} of {bad.size} "
                f"elements, first at {i}: port {got.flat[i]!r}, reference "
                f"{want.flat[i]!r}, float64 {exact.flat[i]!r}")


def _ref_named(tree: dict) -> dict:
    """A reference tree (numpy leaves, or a state's per-leaf dicts) by
    "a/b/c" path, a state's dicts kept whole."""
    out = {}
    for path, a in _flatten(tree).items():
        head, leaf = path.rsplit("/", 1)
        if leaf in ("v", "v_row", "v_col"):
            out.setdefault(head, {})[leaf] = np.asarray(a, np.float64)
        else:
            out[path] = a
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_adafactor_matches_reference(case):
    shapes = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = _zeros(shapes)
    cfg = _groups(params)
    jo, to = jopt.adafactor(LR), topt.adafactor(LR)
    jstate = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    tparams = lm_params_from_jax(params, cfg, "cpu")
    tstate = to.init(tparams)
    assert set(tstate.vs) == set(tparams)
    exact_vs = _ref_named(jax.tree_util.tree_map(np.asarray, jstate.vs))
    for step in range(1, 4):
        grads = _draw(rng, shapes)
        jup, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                jstate)
        tup, tstate = to.update(lm_params_from_jax(grads, cfg, "cpu"), tstate)
        assert tstate.step == int(jstate.step) == step
        exact = {}
        for path, g in _ref_named(grads).items():
            # _map_leading's test: the update layer by layer
            mapped = g.ndim >= 3 and g.shape[0] > 1 and g.size * 4 > 1 << 27
            exact[path], exact_vs[path] = _oracle(g, exact_vs[path], step,
                                                  mapped)
        want = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jup),
                                  cfg, "cpu")
        exact_t = lm_params_from_jax(_unflatten(exact), cfg, "cpu")
        assert set(tup) == set(want)
        for name, u in tup.items():
            assert u.dtype == torch.float32 and u.shape == want[name].shape
            _held(u, want[name], exact_t[name].numpy(),
                  f"{case} step {step} update {name}",
                  REF_RTOL.get(case, RTOL))
        want_vs = _port_states(jstate.vs)
        exact_ts = _port_states(_unflatten(
            {f"{p}/{k}": x for p, v in exact_vs.items() for k, x in
             v.items()}))
        assert set(tstate.vs) == set(want_vs)
        for name, v in tstate.vs.items():
            assert set(v) == set(want_vs[name]), name
            for leaf, x in v.items():
                _held(x, want_vs[name][leaf], exact_ts[name][leaf],
                      f"{case} step {step} state {name}/{leaf}")


def test_clip_units():
    """The reference's leaves: a group's layers together below the
    threshold, each alone past it; a top-level leaf alone."""
    units = topt._clip_units({
        "layers_0.0.a.weight": (4, 8), "layers_0.1.a.weight": (4, 8),
        "layers_1.0.a.weight": (4, 8),
        "layers_2.0.w": (128, 131_073), "layers_2.1.w": (128, 131_073),
        "embed.table_0": (16, 4)})
    assert units == [["layers_0.0.a.weight", "layers_0.1.a.weight"],
                     ["layers_1.0.a.weight"], ["layers_2.0.w"],
                     ["layers_2.1.w"], ["embed.table_0"]]


@pytest.mark.parametrize("layout", ["across_layers", "leading_axis"])
def test_unported_layouts_refused(layout):
    """Two layouts no registered config has are refused: a 1-D parameter
    of a group of 128 layers (the reference factors it across them), and
    a parameter outside the groups that the reference maps by its leading
    axis (3-D, past 1 << 27 bytes; a meta tensor, no memory)."""
    if layout == "across_layers":
        params = {f"layers_0.{i}.norm.scale": torch.zeros(128)
                  for i in range(128)}
        fewer = dict(list(params.items())[:127])
    else:
        params = {"embed.big": torch.empty((2, 128, 131_073),
                                           device="meta")}
        fewer = {"embed.big": torch.empty((2, 128, 131_072),
                                          device="meta")}
    with pytest.raises(NotImplementedError):
        topt.adafactor(LR).init(params)
    topt.adafactor(LR).init(fewer)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_make_optimizer_builds(arch):
    """Every registered LM arch's optimizer builds, as the reference's
    launcher maps it: deepseek-v3-671b's is adafactor, with no sparse
    partner."""
    opt = tlaunch.make_optimizer(tget(arch))
    state = opt.init({"embed.memory": torch.zeros(8),
                      "lm_head.weight": torch.zeros(4, 2)})
    want = {"adafactor": topt.AdafactorState, "adam": dict}[
        jget(arch).optimizer]
    assert isinstance(state, want)


def test_deepseek_launcher_matches_reference_trainer():
    """deepseek-v3-671b's smoke config: the launcher's optimizer
    (adafactor) and LM setup from the reference launcher's initial
    parameters, 3 steps, each loss within 1e-5 of the reference Trainer's
    on the same batches."""
    arch_j, arch_t = jget("deepseek-v3-671b"), tget("deepseek-v3-671b")
    assert arch_j.optimizer == arch_t.optimizer == "adafactor"
    jcfg, tcfg = arch_j.make_smoke(), arch_t.make_smoke()
    jparams = jtransformer.init(jax.random.key(0), jcfg)
    gen = JLMGenerator(jcfg.vocab_size, seed=0)

    def jbatch(step):
        return {k: jnp.asarray(v) for k, v in gen.batch(4, 64, step).items()}

    def jloss(p, b):
        return jtransformer.loss_fn(p, jcfg, b["tokens"], b["labels"])

    model = ttransformer.init(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu"))
    tbatch, tloss = tlaunch._lm_setup(tcfg, 4)
    jt = JTrainer(JTrainerConfig(total_steps=0, log_every=0), jloss,
                  jparams, jlaunch.make_optimizer(arch_j), jbatch)
    tt = Trainer(TrainerConfig(total_steps=0, log_every=0), tloss, model,
                 tlaunch.make_optimizer(arch_t), tbatch, device="cpu")
    assert isinstance(tt.opt_state, topt.AdafactorState)
    for s in range(1, 4):
        jt.cfg.total_steps = tt.cfg.total_steps = s
        jl = jt.fit(log=lambda _: None)["loss"]
        tl = tt.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {s}")
    assert tt.opt_state.step == 3


def _launch(monkeypatch, arch: str):
    """The port's launcher on the CPU, 2 steps of ``arch``'s smoke config;
    -> (its result, the Trainer it built)."""
    made = []

    class Recorded(tlaunch.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(tlaunch, "Trainer", Recorded)
    out = tlaunch.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                        "--batch", "4"])
    (trainer,) = made
    assert out["train"]["step"] == 2 and out["train"]["skipped_steps"] == 0
    assert np.isfinite(out["train"]["loss"])
    return out, trainer


@pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                  if a != "deepseek-v3-671b"])
def test_launcher_trains_lm_arch(arch, monkeypatch):
    """The port's launcher trains each other registered LM arch's smoke
    config 2 steps on the CPU with finite losses, by Adam (multi_transform
    keeps an Adam state a parameter)."""
    _, trainer = _launch(monkeypatch, arch)
    st = trainer.opt_state
    assert all(isinstance(x, topt.AdamState)
               for x in (st.values() if isinstance(st, dict) else [st]))


def test_launcher_deepseek_runs(monkeypatch):
    """The fault's own command: ``--arch deepseek-v3-671b`` trains with
    adafactor, finite losses."""
    _, trainer = _launch(monkeypatch, "deepseek-v3-671b")
    assert isinstance(trainer.opt_state, topt.AdafactorState)
    assert trainer.opt_state.step == 2
