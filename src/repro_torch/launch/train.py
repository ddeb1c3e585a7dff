"""End-to-end training CLI (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

Composes the config registry (--arch), the TBN policy override
(--tbn-p / --mode), the deterministic synthetic data pipeline, AdamW with
a cosine schedule, microbatch accumulation, checkpoint/restart through
the RecoveryManager (resume is automatic if --ckpt-dir holds a
checkpoint) and the straggler watchdog. It runs on the GPU; ``--device
cpu`` runs on the host instead (without a card and without it, the CLI
raises). Tiled layers train through the materialized effective weight;
the fused path through kernel B5 is ``ModelContext(fused_train=True)``,
which ``chip_smoke.py`` drives. ``--arch`` takes every registered id;
the SSM and hybrid families (mamba2-370m, recurrentgemma-2b) are trained
here at ``--reduced`` size on the host, not yet on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Optional

from repro_torch.configs import ArchConfig, build_model, get_config
from repro_torch.core.policy import bwnn_policy, fp32_policy
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import lm_batch
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.recovery import RecoveryManager
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.nn import module as mod
from repro_torch.nn.context import ModelContext
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train.step import build_train_step, init_state

MESH_ITEM = "ROADMAP.md queue A item 9 (distributed and the platform layer)"


def make_policy(cfg: ArchConfig, mode: str, tbn_p: Optional[int]):
    if mode == "fp32":
        return fp32_policy()
    if mode == "bwnn":
        return bwnn_policy()
    return dataclasses.replace(cfg.tbn, p=tbn_p or cfg.tbn.p)


@dataclasses.dataclass
class Training:
    """A model, its train step and the recovery loop around them."""

    model: Any
    step_fn: Callable
    ckpt: CheckpointManager
    recovery: RecoveryManager


def build_training(cfg: ArchConfig, ctx: ModelContext, *, seed: int, batch: int,
                   seq: int, lr: float, warmup: int, total_steps: int,
                   grad_accum: int, ckpt_dir, ckpt_every: int) -> Training:
    """Wire model, AdamW(cosine(lr, warmup, total_steps), wd 0.1), the
    clipped train step, the data pipeline over ``lm_batch``, checkpoints
    and the recovery manager, as the CLI runs them."""
    model = build_model(cfg, ctx)
    opt = adamw(cosine_with_warmup(lr, warmup, total_steps), weight_decay=0.1)
    step_fn = build_train_step(model.train_forward, opt, grad_accum=grad_accum)

    def make_state():
        return init_state(model.init(seed), opt)

    def make_data(start):
        return DataPipeline(lambda step: lm_batch(seed, step, batch, seq, cfg.vocab),
                            start_step=start, prefetch=2)

    ckpt = CheckpointManager(ckpt_dir, save_every=ckpt_every, max_to_keep=3)
    rm = RecoveryManager(ckpt, make_state=make_state, make_data=make_data,
                         watchdog=StepWatchdog(threshold=5.0))
    return Training(model, step_fn, ckpt, rm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--mode", default="tbn", choices=["tbn", "bwnn", "fp32"])
    ap.add_argument("--tbn-p", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: tbn_torch_<arch> in the temp directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, help=f"not ported yet: {MESH_ITEM}")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(f"--mesh is not ported yet: {MESH_ITEM}")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, tbn=make_policy(cfg, args.mode, args.tbn_p))
    ctx = ModelContext(policy=cfg.tbn, device=device)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"tbn_torch_{cfg.name}")
    tr = build_training(cfg, ctx, seed=args.seed, batch=args.batch, seq=args.seq,
                        lr=args.lr, warmup=args.warmup, total_steps=args.steps,
                        grad_accum=args.grad_accum, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every)
    specs = tr.model.specs()
    n_tiled = sum(r.spec is not None for r in ctx.ledger.records)
    print(f"arch={cfg.name} mode={cfg.tbn.mode} p={cfg.tbn.p} "
          f"params={sum(math.prod(s.shape) for _, s in mod.walk(specs)):,} "
          f"tiled_layers={n_tiled} device={device}")

    history = []

    def hooks(step, state, metrics):
        if step % args.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    final = tr.recovery.run(tr.step_fn, args.steps, hooks=hooks)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s), "
          f"final step={final.step}")
    if history:
        print(f"loss: first={history[0][1]:.4f} last={history[-1][1]:.4f}")
    return final, history


if __name__ == "__main__":
    main()
