"""LM serving demo on the PyTorch port: train a smoke-scale tinyllama on
synthetic bigram data with the port's ``adam``, then serve generations
through the port's ``LMServer`` (prefill + batched greedy decode).

Run on the card:  PYTHONPATH=src python examples/lm_generate_torch.py
or on the CPU:    PYTHONPATH=src python examples/lm_generate_torch.py --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_data import LMGenerator
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_lib
from repro_torch.serve import LMServer


def train(model, cfg, gen, steps: int, dev, lr: float = 3e-3) -> float:
    params = dict(model.named_parameters())
    opt = opt_lib.adam(lr)
    state = opt.init(params)
    loss = float("nan")
    for i in range(steps):
        b = gen.batch(16, 64, i)
        out, _ = transformer.loss_fn(model, cfg,
                                     torch.from_numpy(b["tokens"]).to(dev),
                                     torch.from_numpy(b["labels"]).to(dev))
        model.zero_grad(set_to_none=True)
        out.backward()
        grads = {k: p.grad for k, p in params.items()}
        updates, state = opt.update(grads, state, params)
        opt_lib.apply_updates(params, updates)
        loss = float(out.detach())
        if (i + 1) % max(steps // 5, 1) == 0:
            print(f"  step {i + 1}: loss {loss:.3f} "
                  f"(random = {np.log(cfg.vocab_size):.3f})")
    return loss


def bigram_hits(results, gen) -> tuple[int, int]:
    """Generated (token, next) pairs that follow the generator's bigram
    successor, of those whose first token is patterned."""
    hits = total = 0
    for r in results:
        seq = r.prompt + r.tokens
        for a, b in zip(seq[:-1], seq[1:]):
            if gen.is_patterned[a]:
                total += 1
                hits += int(b == gen.successor[a])
    return hits, total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("tinyllama-1.1b").make_smoke()
    gen = LMGenerator(cfg.vocab_size, seed=0)
    model = transformer.init(cfg, seed=0, device=dev)
    print(f"training {cfg.name} ({args.steps} steps, vocab {cfg.vocab_size}) "
          f"on {dev}")
    loss = train(model, cfg, gen, args.steps, dev)

    server = LMServer(model, cfg, n_slots=4, max_len=96)
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, 8)))
               for _ in range(6)]
    out = server.generate(prompts, max_new_tokens=16)
    hits, total = bigram_hits(out, gen)
    print(f"\nserved {len(out)} prompts in {server.stats['waves']} waves, "
          f"{server.stats['decode_steps']} decode steps")
    print(f"bigram-successor hit rate in generations: "
          f"{hits}/{total} = {hits / max(total, 1):.2f} "
          f"(random ~ 1/{cfg.vocab_size})")
    return {"loss": loss, "results": out, "stats": dict(server.stats),
            "hits": hits, "total": total}


if __name__ == "__main__":
    main()
