"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter LM for
a few hundred steps, with the paper's analog solver as the optimizer's
SPD-solve backend.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--optimizer analog_newton|adamw] [--smoke] [--device cpu]

The flow of ``examples/train_lm.py`` on ``repro_torch``, with its configs,
flags and printed summary.  The model is a qwen3-family decoder sized to
~100M params.  With ``--optimizer analog_newton`` every preconditioner
refresh solves its block systems through the simulated RNM circuit as
ONE batched ``solve_batch`` call over all layer blocks on a cached stamp
pattern (2n transform -> netlist -> non-ideal operating point) — the
paper's accelerator in the training loop; the refresh accounting
(:data:`repro_torch.optim.analog_newton.REFRESH_STATS`) is printed at the
end.  On the card (the default device) every attention runs K8 forward
and its hand-written backward.  Checkpointing/resume runs through the
fault-tolerant manager (the checkpoint directory defaults to
``repro_train_lm_torch`` under the temporary directory); kill and rerun
to see auto-resume.  ``--smoke`` shrinks the model and step count to a
seconds-scale CI configuration.
"""

import argparse
import dataclasses
import importlib
import os
import tempfile


def lm_100m():
    from repro_torch.configs import get_config

    base = get_config("qwen3_8b")
    return dataclasses.replace(
        base,
        arch_id="qwen3_100m",
        n_layers=6,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=3072,
        vocab=32768,
        dtype="float32",
        param_dtype="float32",
    )


def lm_smoke():
    """Seconds-scale CI model: same architecture family, tiny dims."""
    from repro_torch.configs import get_config

    base = get_config("qwen3_8b")
    return dataclasses.replace(
        base,
        arch_id="qwen3_smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        dtype="float32",
        param_dtype="float32",
    )


def analog_config(smoke: bool):
    an = importlib.import_module("repro_torch.optim.analog_newton")
    if smoke:
        return an.AnalogNewtonConfig(block=16, min_dim=32, max_blocks=8, refresh_every=2,
                                     backend="analog_2n", opamp="AD712")
    return an.AnalogNewtonConfig(block=32, min_dim=256, max_blocks=24, refresh_every=100,
                                 backend="analog_2n", opamp="AD712")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--optimizer", default="analog_newton",
                    choices=["adamw", "analog_newton"])
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-4 adamw / 0.02 analog_newton "
                         "(relative step via the LAMB trust ratio)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_lm_torch"))
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + few steps (CI configuration)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    an = importlib.import_module("repro_torch.optim.analog_newton")
    from repro_torch.launch.train import train_loop

    if args.smoke:
        cfg = lm_smoke()
        steps = args.steps or 4
        batch = args.batch or 2
        seq = args.seq or 32
        ckpt_dir = None
    else:
        cfg = lm_100m()
        steps = args.steps or 300
        batch = args.batch or 4
        seq = args.seq or 192
        ckpt_dir = args.ckpt_dir
    acfg = analog_config(args.smoke)

    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models.model import count_params, init_params

    dev = resolve_device(args.device)
    n = count_params(init_params(cfg, torch.Generator(device=dev), device=dev))
    print(f"model: {cfg.arch_id}, {n/1e6:.1f}M params, optimizer={args.optimizer}")

    an.reset_refresh_stats()
    lr = args.lr or (0.02 if args.optimizer == "analog_newton" else 3e-4)
    out = train_loop(
        cfg,
        steps=steps,
        batch_size=batch,
        seq_len=seq,
        optimizer_name=args.optimizer,
        lr=lr,
        ckpt_dir=ckpt_dir,
        ckpt_every=100,
        analog_cfg=acfg if args.optimizer == "analog_newton" else None,
        device=args.device,
    )
    hist = out["history"]
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over {steps} steps")
    if args.optimizer == "analog_newton":
        rs = an.REFRESH_STATS
        print(f"refreshes: {rs.refreshes}, solve_batch calls: "
              f"{rs.solve_batch_calls} (one per refresh), systems solved: "
              f"{rs.systems_solved}, stamp patterns derived: "
              f"{rs.pattern_derivations}")
    return out


if __name__ == "__main__":
    main()
