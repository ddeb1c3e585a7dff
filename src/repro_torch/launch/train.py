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
which ``chip_smoke.py`` drives.

``--mesh DPxTP`` trains on the ranks of a ``torch.distributed.run`` job
(``launch/mesh.init_mesh``: gloo when ranks share a card or run on the
CPU, nccl with a card each):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch granite-8b --reduced --mesh 2x2

Each rank holds r/TP unique rows of every tiled Dense's masters (and
under the config's ``fsdp_weights`` a block of their n_in), takes its rows
of each global batch, and the step averages the loss and gradients over
"data" (``train.step``); checkpoints hold the one-device format (the first
rank writes them) and a restart restores every rank. Only the first rank
prints. ``--arch`` takes every registered id:
the encoder-decoder family (seamless-m4t-large-v2) trains on synthetic
frames (``frames_batch``), the VLM family (chameleon-34b) on token batches
with an all-text image mask, as the reference's CLI feeds them.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ArchConfig, build_model, get_config
from repro_torch.core.policy import bwnn_policy, fp32_policy
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import frames_batch, lm_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    TrainShardings,
    place_train_params,
    train_shards,
)
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.ft.recovery import RecoveryManager
from repro_torch.ft.watchdog import StepWatchdog
from repro_torch.nn import module as mod
from repro_torch.launch.mesh import init_mesh, parse_mesh_arg
from repro_torch.nn.context import ModelContext
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train.step import build_train_step, init_state


def make_policy(cfg: ArchConfig, mode: str, tbn_p: Optional[int]):
    if mode == "fp32":
        return fp32_policy()
    if mode == "bwnn":
        return bwnn_policy()
    return dataclasses.replace(cfg.tbn, p=tbn_p or cfg.tbn.p)


def batch_fn(cfg: ArchConfig, seed: int, batch: int, seq: int):
    """step -> the training batch of ``cfg``'s family: frames and decoder
    tokens (encdec), tokens with an empty image mask and zero image
    embeddings (vlm), or tokens."""
    def gen(step):
        if cfg.family == "encdec":
            return frames_batch(seed, step, batch, seq, cfg)
        b = lm_batch(seed, step, batch, seq, cfg.vocab)
        if cfg.modality == "vlm":
            b["image_mask"] = torch.zeros((batch, seq), dtype=torch.bool)
            b["image_embeds"] = torch.zeros((batch, seq, cfg.d_model),
                                            dtype=torch.bfloat16)
        return b

    return gen


@dataclasses.dataclass
class Training:
    """A model, its train step and the recovery loop around them."""

    model: Any
    step_fn: Callable
    ckpt: CheckpointManager
    recovery: RecoveryManager
    shardings: Optional[TrainShardings] = None


def build_training(cfg: ArchConfig, ctx: ModelContext, *, seed: int, batch: int,
                   seq: int, lr: float, warmup: int, total_steps: int,
                   grad_accum: int, ckpt_dir, ckpt_every: int,
                   mesh=None) -> Training:
    """Wire model, AdamW(cosine(lr, warmup, total_steps), wd 0.1), the
    clipped train step, the data pipeline over the family's synthetic
    batches (``batch_fn``), checkpoints and the recovery manager, as the
    CLI runs them. Under ``mesh`` each rank holds its blocks of the masters
    (``train_shards`` with the context's ``fsdp_weights``) and the step,
    the checkpoints and the restarts work across the ranks."""
    model = build_model(cfg, ctx)
    opt = adamw(cosine_with_warmup(lr, warmup, total_steps), weight_decay=0.1)
    shardings = None
    if mesh is not None:
        shardings = TrainShardings(mesh, train_shards(
            model.specs(), mesh, fsdp=ctx.fsdp_weights))
    step_fn = build_train_step(
        model.train_forward, opt, grad_accum=grad_accum, mesh=mesh,
        shards=None if shardings is None else shardings.shards)

    def make_state():
        params = model.init(seed)
        if shardings is not None:
            params = place_train_params(params, shardings.shards, mesh)
        return init_state(params, opt)

    def make_data(start):
        return DataPipeline(batch_fn(cfg, seed, batch, seq), start_step=start,
                            prefetch=2)

    ckpt = CheckpointManager(ckpt_dir, save_every=ckpt_every, max_to_keep=3,
                             shardings=shardings)
    rm = RecoveryManager(ckpt, make_state=make_state, make_data=make_data,
                         watchdog=StepWatchdog(threshold=5.0),
                         shardings=shardings)
    return Training(model, step_fn, ckpt, rm, shardings)


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
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2x4' data x model over the ranks of "
                         "torch.distributed.run")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    dims = parse_mesh_arg(args.mesh) if args.mesh else None
    mesh, first = None, True
    if dims is not None:
        mesh, device, backend, why = init_mesh(*dims, args.device)
        first = dist.get_rank() == 0
    else:
        device = resolve_device(args.device)
    say = print if first else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, tbn=make_policy(cfg, args.mode, args.tbn_p))
    ctx = ModelContext(policy=cfg.tbn, device=device,
                       fsdp_weights=cfg.fsdp_weights)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             f"tbn_torch_{cfg.name}")
    tr = build_training(cfg, ctx, seed=args.seed, batch=args.batch, seq=args.seq,
                        lr=args.lr, warmup=args.warmup, total_steps=args.steps,
                        grad_accum=args.grad_accum, ckpt_dir=ckpt_dir,
                        ckpt_every=args.ckpt_every, mesh=mesh)
    specs = tr.model.specs()
    n_tiled = sum(r.spec is not None for r in ctx.ledger.records)
    say(f"arch={cfg.name} mode={cfg.tbn.mode} p={cfg.tbn.p} "
        f"params={sum(math.prod(s.shape) for _, s in mod.walk(specs)):,} "
        f"tiled_layers={n_tiled} device={device}")
    if mesh is not None:
        say(f"mesh={dims[0]}x{dims[1]} backend={backend} ({why}) "
            f"fsdp_weights={cfg.fsdp_weights}")

    history = []

    def hooks(step, state, metrics):
        if step % args.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            history.append((step, loss))
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    final = tr.recovery.run(tr.step_fn, args.steps, hooks=hooks)
    dt = time.time() - t0
    say(f"done: {args.steps} steps in {dt:.1f}s ({args.steps / dt:.2f} steps/s), "
        f"final step={final.step}")
    if history:
        say(f"loss: first={history[0][1]:.4f} last={history[-1][1]:.4f}")
    if mesh is not None:
        dist.destroy_process_group()
    return final, history


if __name__ == "__main__":
    main()
