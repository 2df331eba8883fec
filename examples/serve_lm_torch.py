"""Serving example on the PyTorch/CUDA port: batched generation for any
model family.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch qwen3_8b]
    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2_7b --device cpu

The flow of ``examples/serve_lm.py`` on ``repro_torch``, on the reduced
SMOKE config: a dense, MoE, SSM or hybrid model goes through
:class:`repro_torch.serving.ServeEngine` (continuous batching over
prefill/decode with explicit caches, categorical sampling at temperature
0.8, as the reference example samples).  The engine prefills tokens
alone, so a vlm (InternVL2, which also takes patch embeddings) or an
encdec (Whisper, frame embeddings) goes through the model's
``prefill_into``/``decode_step`` instead, with random embeddings for the
stubbed front end and greedy tokens.  On the card (the default device)
every prefill's attention runs K8; ``--device cpu`` runs its plain
version.  An SSM prompt is at most ``ssm_chunk`` tokens here (a longer
one must be a multiple of it).
"""

import argparse
import time

import numpy as np


def serve_direct(cfg, params, prompts, max_new: int, device) -> list:
    """Greedy generation for a vlm or encdec through prefill_into and
    decode_step, one slot per prompt, every slot at its own position."""
    import torch

    from repro_torch.models.model import decode_step, init_decode_cache, prefill_into

    gen = torch.Generator(device=device).manual_seed(0)
    offset = cfg.n_patches if cfg.family == "vlm" else 0
    length = cfg.n_patches if cfg.family == "vlm" else cfg.enc_len
    key = "patches" if cfg.family == "vlm" else "frames"
    cache = init_decode_cache(cfg, len(prompts), offset + max(map(len, prompts)) + max_new,
                              device=device)
    outs = []
    for slot, prompt in enumerate(prompts):
        embeddings = torch.randn((1, length, cfg.d_model), generator=gen, device=device)
        logits = prefill_into(params, prompt[None, :], cfg, cache, slot,
                              **{key: embeddings.to(cfg.act_dtype())})
        outs.append([int(logits.argmax(dim=-1)[0])])
    pos = np.array([offset + len(p) for p in prompts])
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, [[o[-1]] for o in outs], pos, cache, cfg)
        for o, tok in zip(outs, logits.argmax(dim=-1).tolist()):
            o.append(tok)
        pos = pos + 1
    return outs


def main(argv=None) -> dict:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_8b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.engine import SERVED_FAMILIES

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=rng.integers(4, 12))
               for _ in range(args.requests)]

    t0 = time.time()
    if cfg.family in SERVED_FAMILIES:
        eng = ServeEngine(cfg, params, batch_slots=4, max_seq=128, sampler="categorical",
                          temperature=0.8, device=device)
        reqs = [Request(rid=i, prompt=p, max_new=args.max_new) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=1000)
        outs = [r.out for r in reqs]
    else:
        outs = serve_direct(cfg, params, prompts, args.max_new, device)
    dt = time.time() - t0

    total = sum(map(len, outs))
    print(f"arch={args.arch} family={cfg.family} device={device}")
    for i, (p, out) in enumerate(zip(prompts, outs)):
        print(f"  req {i}: prompt[{len(p)}] -> {out}")
    print(f"{total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, SMOKE config on {device})")
    return dict(arch=args.arch, family=cfg.family, outs=outs)


if __name__ == "__main__":
    main()
