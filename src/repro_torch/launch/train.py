"""Training driver: config -> data -> fault-tolerant loop, on one device.

Counterpart of :mod:`repro.launch.train`, whose loop, too, builds no
mesh.  Features exercised here:

* auto-resume from the latest checkpoint (params + optimizer + data
  iterator state),
* periodic async checkpointing with atomic commit + keep-K GC,
* optional AnalogNewton optimizer with its preconditioner refresh
  through the paper's simulated circuit (the port's ``solve_batch`` on
  the training device),
* the reference's history and log lines.

Usage (smoke scale):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_8b \\
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.device import resolve_device, stage
from repro_torch.optim.adamw import adamw
from repro_torch.optim.analog_newton import (
    AnalogNewtonConfig,
    analog_newton,
    refresh_preconditioner,
)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.training.step import init_train_state, make_train_step


def build_optimizer(name: str, lr_peak: float, total_steps: int,
                    analog_cfg: AnalogNewtonConfig | None = None):
    lr = cosine_schedule(lr_peak, warmup_steps=min(100, total_steps // 10 + 1),
                         total_steps=total_steps)
    if name == "adamw":
        return adamw(lr), None
    if name == "analog_newton":
        acfg = analog_cfg or AnalogNewtonConfig()
        return analog_newton(lr, acfg), acfg
    raise ValueError(name)


def train_loop(
    cfg,
    *,
    steps: int,
    batch_size: int,
    seq_len: int,
    optimizer_name: str = "adamw",
    lr: float = 3e-4,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    analog_cfg: AnalogNewtonConfig | None = None,
    log_fn=print,
    device=None,
    timings: dict | None = None,
) -> dict:
    """Train ``cfg`` for ``steps`` steps on ``device`` (default ``"cuda"``).
    Returns ``{"state", "history"}``, the history one entry ``{"step",
    "loss", "acc"}`` per logged step (every ``log_every`` steps and the
    first step of the run).  ``timings`` (a dict) collects wall seconds by
    stage — ``data``, ``step``, ``refresh``, ``checkpoint`` (the host
    snapshot; the commit runs behind) — synchronizing the device at each
    stage boundary."""
    dev = resolve_device(device)
    optimizer, acfg = build_optimizer(optimizer_name, lr, steps, analog_cfg)
    step_fn = make_train_step(cfg, optimizer)

    data = SyntheticTokens(vocab=cfg.vocab, seq_len=seq_len, batch_size=batch_size, seed=seed)

    state = init_train_state(cfg, optimizer, torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    start_step = 0

    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        latest, restored, ds = mgr.restore_latest(state)
        if latest is not None:
            state = restored
            start_step = latest
            if ds:
                data.close()
                data = SyntheticTokens.from_state(
                    ds, vocab=cfg.vocab, seq_len=seq_len, batch_size=batch_size)
            log_fn(f"resumed from step {latest}")

    history = []
    t_last = time.time()
    for step in range(start_step, steps):
        with stage(timings, "data", dev):
            batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        with stage(timings, "step", dev):
            state, metrics = step_fn(state, batch)

        if acfg is not None and (step + 1) % acfg.refresh_every == 0:
            # the analog-circuit preconditioner refresh
            with stage(timings, "refresh", dev):
                state["opt_state"] = refresh_preconditioner(state["opt_state"], acfg)

        if (step + 1) % log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            acc = float(metrics["accuracy"])
            dt = (time.time() - t_last) / log_every
            t_last = time.time()
            history.append({"step": step + 1, "loss": loss, "acc": acc})
            log_fn(f"step {step+1:5d}  loss {loss:7.4f}  acc {acc:.3f}  "
                   f"{dt*1e3:7.1f} ms/step")

        if mgr is not None and (step + 1) % ckpt_every == 0:
            with stage(timings, "checkpoint", dev):
                mgr.save(step + 1, state, data_state=data.state())

    if mgr is not None:
        with stage(timings, "checkpoint", dev):
            mgr.save(steps, state, data_state=data.state())
        mgr.wait()
    data.close()
    return {"state": state, "history": history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "analog_newton"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = train_loop(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        optimizer_name=args.optimizer, lr=args.lr, ckpt_dir=args.ckpt_dir,
        device=args.device)
    final = out["history"][-1] if out["history"] else {}
    print("final:", final)


if __name__ == "__main__":
    main()
