"""Training launcher: the port's fault-tolerant trainer as a CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \\
        --batch 8 --seq 1024 [--dtype bfloat16]
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --arch granite-moe-3b-a800m --batch 8 --seq 1024 \\
        --micro-batches 8 --dtype bfloat16

The port of ``repro.launch.train``: trains the chosen architecture
(qwen1.5-0.5b by default; the reduced config unless ``--full``) with
AdamW, checkpointing, straggler monitoring and deterministic resume, from
weights drawn from seed 0.  Runs on the card unless ``--device cpu`` is
given (without a card it raises, as the other launchers do).  ``--dtype``
is the weights' type (float32, the reference's, or bfloat16; AdamW's m
and v stay float32).  Two options are the port's own:
``--micro-batches`` splits each step's batch for gradient accumulation
(``TrainConfig.micro_batches``), and ``--n-layers`` cuts the depth of the
chosen spec (its first layers, at its width).  The reference's
``--devices/--tp`` (a sharded run) wait for ``DeviceMesh``: ROADMAP item
15.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import registry
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..models import build_model
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainConfig, Trainer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--n-layers", type=int, default=None)
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, **kw) -> Trainer:
    """The trainer ``args`` describe, its weights drawn from seed 0 on the
    device (``kw`` goes to ``Trainer``: a failure injector)."""
    dev = resolve_device(args.device)
    spec = (registry.get_reduced(args.arch) if args.reduced
            else registry.get_spec(args.arch))
    if args.n_layers is not None:
        spec = spec.scaled(n_layers=args.n_layers)
    model = build_model(spec, device=dev, dtype=DTYPES[args.dtype])
    data_cfg = DataConfig(vocab=spec.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    cfg = TrainConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir,
                      micro_batches=args.micro_batches,
                      optimizer=AdamWConfig(lr=args.lr, warmup_steps=10,
                                            total_steps=args.steps))
    gen = torch.Generator(device=dev).manual_seed(0)
    return Trainer(model, data_cfg, cfg, generator=gen, **kw)


def main(argv: list[str] | None = None) -> Trainer:
    args = parse(argv)
    tr = make_trainer(args)

    def cb(step, loss):
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}")

    start = tr.resume() if args.resume else 0
    if start:
        print(f"resumed from step {start}")
    tr.run(start, args.steps, callback=cb)
    n_straggle = len(tr.monitor.flagged)
    print(f"done: {len(tr.history)} steps this run, "
          f"{n_straggle} straggler events, final loss "
          f"{tr.history[-1]['loss']:.4f}" if tr.history else "done (resumed)")
    return tr


if __name__ == "__main__":
    main()
