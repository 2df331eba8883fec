#!/usr/bin/env python3
"""Host time of K8's wrappers a call, on a CUDA device, with no counter active.

    PYTHONPATH=<tree>/src python3 scripts/k8_host_times.py [--label NAME]

Runs with whichever ``repro_torch`` is first on the path and prints one
JSON line: the host microseconds a call of ``flash_attention`` (forward)
and of ``flash_attention_bwd`` (Delta, dK/dV and dQ) take at a shape whose
kernels are shorter than their launch (q (1, 1, 32, 128), k/v (1, 64, 8,
128), bf16, causal), so that the host sets the pace: CALLS calls with no
synchronization between them, then one, the wall time over the calls; the
median and the range of REPEATS such loops after one warm-up loop.  Every
call runs what the serving and training paths run around a launch,
checks, routing, launch counts and the counting hook among them.

To compare two commits on one card, unpack the other into a directory that
``.gitignore`` lists and run this script with each tree's ``src`` first on
the path, in turns (parent, change, change, parent), in one call.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

CALLS = 2000
REPEATS = 7
SEED = 0


def host_us(fn) -> dict:
    """Host microseconds a call of ``fn``: CALLS calls, then a
    synchronization, over CALLS; the median and range of REPEATS loops
    after a warm-up loop."""
    loops = []
    for i in range(REPEATS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if i:
            loops.append((time.perf_counter() - t0) / CALLS * 1e6)
    return dict(median=statistics.median(loops), min=min(loops), max=max(loops))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import repro_torch.kernels.flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((1, 1, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, 64, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    print(json.dumps(dict(
        label=args.label, module=fa.__file__, card=torch.cuda.get_device_name(0),
        calls=CALLS, repeats=REPEATS,
        forward_host_us=host_us(lambda: fa.flash_attention(q, k, v)),
        backward_host_us=host_us(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do)),
    )), flush=True)


if __name__ == "__main__":
    main()
