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
chosen spec (its first layers, at its width).

``--devices N --tp T`` (the reference's sharded run) trains on a
``(data = N / T, model = T)`` mesh of N ranks with policy ``train_2d``
(``build_model(mesh=)``, ``Trainer(mesh=)``): with ``--device cpu``, N
gloo ranks; on the card, N ranks sharing it over gloo when one card is
visible (which proves the path and measures nothing of collectives
between cards), or a card a rank over nccl when N are (written, not yet
run on such a machine).  Rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --devices 4 --tp 2 --steps 5
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
from .mesh import make_mesh

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
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--tp", type=int, default=1)
    return ap.parse_args(argv)


def make_trainer(args: argparse.Namespace, mesh=None, **kw) -> Trainer:
    """The trainer ``args`` describe, its weights drawn from seed 0 on the
    device (``kw`` goes to ``Trainer``: a failure injector); with ``mesh``
    this rank's part of the mesh-sharded trainer."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    spec = (registry.get_reduced(args.arch) if args.reduced
            else registry.get_spec(args.arch))
    if args.n_layers is not None:
        spec = spec.scaled(n_layers=args.n_layers)
    model = build_model(spec, device=dev, dtype=DTYPES[args.dtype],
                        mesh=mesh, policy="train_2d" if mesh else None)
    data_cfg = DataConfig(vocab=spec.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    cfg = TrainConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir,
                      micro_batches=args.micro_batches,
                      optimizer=AdamWConfig(lr=args.lr, warmup_steps=10,
                                            total_steps=args.steps))
    gen = torch.Generator(device=dev).manual_seed(0)
    return Trainer(model, data_cfg, cfg, generator=gen, mesh=mesh, **kw)


def _mesh_device(args: argparse.Namespace) -> tuple[str, str]:
    """(backend, device) of this launch's ranks."""
    if args.device == "cpu":
        return "gloo", "cpu"
    resolve_device(args.device)  # raises without a card
    if torch.cuda.device_count() >= args.devices:
        return "nccl", "cuda"
    return "gloo", args.device


def _rank(args: argparse.Namespace) -> list[dict]:
    """One rank of a ``--devices`` run: its mesh, its trainer, its run;
    returns the history (rank 0 prints)."""
    import torch.distributed as dist
    backend, device = _mesh_device(args)
    if backend == "nccl":
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    mesh = make_mesh((args.devices // args.tp, args.tp), ("data", "model"),
                     device)
    if mesh.rank == 0:
        print(f"mesh: {mesh.shape} over {backend}", flush=True)
    return _run(args, make_trainer(args, mesh=mesh), quiet=mesh.rank != 0
                ).history


def main(argv: list[str] | None = None):
    """Train as ``argv`` says; returns the trainer (with ``--devices``,
    each rank's history)."""
    args = parse(argv)
    if args.devices and args.devices > 1:
        from ..serving.sharded import spawn
        if args.devices % args.tp:
            raise ValueError(f"--tp {args.tp} must divide --devices "
                             f"{args.devices}")
        backend, _ = _mesh_device(args)
        return spawn(args.devices, _rank, args, backend=backend)
    return _run(args, make_trainer(args))


def _run(args: argparse.Namespace, tr: Trainer, quiet: bool = False
         ) -> Trainer:
    def cb(step, loss):
        if not quiet and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}", flush=True)

    start = tr.resume() if args.resume else 0
    if start and not quiet:
        print(f"resumed from step {start}")
    tr.run(start, args.steps, callback=cb)
    n_straggle = len(tr.monitor.flagged)
    if not quiet:
        print(f"done: {len(tr.history)} steps this run, "
              f"{n_straggle} straggler events, final loss "
              f"{tr.history[-1]['loss']:.4f}" if tr.history
              else "done (resumed)", flush=True)
    return tr


if __name__ == "__main__":
    main()
