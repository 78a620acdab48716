"""Fault-tolerant training demo (the port of ``examples/train_faulty.py``):
train a small model, inject a node failure mid-run, restart from the
newest committed checkpoint, and check that the final weights equal an
uninterrupted run's.

    PYTHONPATH=src python -m repro_torch.launch.train_faulty --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_faulty   # the card

Reduced deepseek-7b at a 128-token vocabulary, float32, 8 rows of 64
tokens, a checkpoint every 10 steps, weights drawn from seed 0.  Runs on
the card unless ``--device cpu`` is given.  Asserts the reference's
bound: every weight within 1e-5 of the uninterrupted run's.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from ..configs import registry
from ..data.pipeline import DataConfig
from ..device import resolve_device
from ..models import build_model
from ..training.fault import FailureInjector, run_with_restarts
from ..training.optimizer import AdamWConfig
from ..training.train_loop import TrainConfig, Trainer


def max_divergence(a: Trainer, b: Trainer) -> float:
    """The largest |difference| of any weight between two trainers'
    models."""
    sb = b.model.state_dict()
    return max(float((t.float() - sb[n].float()).abs().max())
               for n, t in a.model.state_dict().items())


def run(steps: int = 40, fail_at: int = 25, device="cuda",
        log=print) -> tuple[Trainer, Trainer, float]:
    """(uninterrupted trainer, restarted trainer, max weight divergence)."""
    dev = resolve_device(device)
    spec = registry.get_reduced("deepseek-7b").scaled(vocab=128)
    data_cfg = DataConfig(vocab=128, seq_len=64, global_batch=8, seed=0)

    def trainer(d, injector=None):
        model = build_model(spec, device=dev, dtype=torch.float32)
        return Trainer(
            model, data_cfg,
            TrainConfig(checkpoint_every=10, checkpoint_dir=d,
                        optimizer=AdamWConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=steps)),
            generator=torch.Generator(device=dev).manual_seed(0),
            failure_injector=injector)

    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_ft:
        log("== reference run (no failures) ==")
        ref = trainer(d_ref)
        ref.run(0, steps, callback=lambda s, l: s % 10 == 0 and log(
            f"  step {s:3d} loss {l:.4f}"))

        log(f"\n== fault-tolerant run (failure injected at step "
            f"{fail_at}) ==")
        injector = FailureInjector(fail_at_steps=(fail_at,))

        def make(attempt):
            if attempt:
                log(f"  [supervisor] restart #{attempt}: restoring from "
                    "latest committed checkpoint, replaying data stream")
            return trainer(d_ft, injector)

        tr = run_with_restarts(
            make, total_steps=steps,
            on_restart=lambda a, e: log(f"  [supervisor] caught: {e}"))
    return ref, tr, max_divergence(ref, tr)


def main(argv: list[str] | None = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fail-at", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ref, tr, diff = run(args.steps, args.fail_at, args.device)
    print(f"\nmax param divergence vs uninterrupted run: {diff:.2e}")
    print("straggler monitor flagged:", tr.monitor.flagged)
    assert diff < 1e-5, "restart must be deterministic"
    print("OK: crash-restart run converged to identical weights")
    return diff


if __name__ == "__main__":
    main()
