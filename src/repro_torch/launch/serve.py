"""LM serving driver: batched greedy (or sampled) decoding with a KV/SSM
cache, for every architecture in `repro_torch.configs`.

Port of `src/repro/launch/serve.py`:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma2-2b --full --batch 4 --prompt-len 16 --gen-len 32

    # on a machine without a card
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch olmoe-1b-7b --reduced --device cpu

Decodes from step 0, as the reference does: the prompt goes through the
same decode step (prefill-by-decode), so one code path covers pure-SSM,
hybrid, sliding-window and global-attention archs; the cache holds
``prompt_len + gen_len`` positions and step ``t`` is passed to each
decode call (M-RoPE archs take their three position streams from it).
Random weights from a `torch.Generator` seeded with ``--seed``; the
prompt from numpy's ``default_rng(--seed)``, as in the reference: token
ids for a token frontend; for an ``embeds`` frontend (musicgen,
qwen2-vl) standard-normal frames, then a fixed random codebook drawn
from the same generator after them, which re-embeds each generated id.
Sampling at ``--temperature > 0`` from a `torch.Generator` seeded with
``--seed + 1``.  Prints the reference's ``[serve] ... tok/s=`` line
(batch x steps over the host clock around the loop, which ends on the
last step's tokens on the host).

The port's one flag beside the reference's: ``--device cuda|cpu``
(default cuda; raises without CUDA).  There is no ``--backend``: decode
runs no kernel, so there is nothing to choose; prefill's choice is
`repro_torch.models.lm.make_prefill_step(backend=)`.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(argv=None, *, params=None, keep_logits: bool = False) -> dict:
    """Parse ``argv`` and serve; returns ``{"tok_per_s", "tokens" (batch,
    gen_len) numpy, "steps", "seconds", "cfg"}`` plus ``"logits"`` (one (B, V)
    tensor per step) with ``keep_logits``.  ``params`` replaces the
    seeded random weights (the tests pass carried reference weights)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import LMModel, make_decode_step
    from repro_torch.nn.transformer import init_lm_cache

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = arch.reduced() if args.reduced else arch.full()
    if params is None:
        params = LMModel.create(cfg, args.seed, device=dev).params
    max_seq = args.prompt_len + args.gen_len
    cache = init_lm_cache(cfg, args.batch, max_seq=max_seq,
                          dtype=torch.float32 if cfg.dtype == torch.float32
                          else torch.bfloat16, device=dev)
    decode = make_decode_step(cfg)

    rng = np.random.default_rng(args.seed)
    if cfg.frontend == "tokens":
        prompt = torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)),
            device=dev)
        codebook = None
    else:
        prompt = torch.as_tensor(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32),
            device=dev)
        codebook = torch.as_tensor(rng.standard_normal(
            (cfg.vocab, cfg.d_model)).astype(np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    out_tokens, logits_seen = [], []
    prev = torch.zeros((args.batch,), dtype=torch.long, device=dev)
    t0 = time.time()
    for t in range(max_seq):
        if t < args.prompt_len:
            tok = prompt[:, t]
        else:
            tok = prev if codebook is None else codebook[prev]
        logits, cache = decode(params, cache, tok, t)
        if args.temperature > 0:
            probs = torch.softmax(logits / args.temperature, dim=-1)
            prev = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            prev = logits.argmax(-1)
        if keep_logits:
            logits_seen.append(logits)
        if t >= args.prompt_len - 1:
            out_tokens.append(prev.cpu().numpy())
    dt = time.time() - t0
    toks = np.stack(out_tokens[: args.gen_len], axis=1)
    tps = args.batch * max_seq / dt
    print(f"[serve] arch={cfg.name} batch={args.batch} steps={max_seq} "
          f"tok/s={tps:.1f}", flush=True)
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {toks[b][:16].tolist()} ...", flush=True)
    res = {"tok_per_s": tps, "tokens": toks, "steps": max_seq,
           "seconds": dt, "cfg": cfg}
    if keep_logits:
        res["logits"] = logits_seen
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
