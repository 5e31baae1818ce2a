"""Train a reduced SmolLM-family decoder for a few hundred steps — the port
of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]

Runs on the card unless ``--device cpu`` (the reference's runs on the
CPU).  Demonstrates the training stack end to end: the decoder, AdamW,
async checkpointing, failure injection + recovery, straggler monitoring —
the same training loop the production launch uses (``launch/train``), at smoke
scale; on the card each step is a captured CUDA graph.  Loss must drop;
an injected failure at step 30 must not change the final trajectory
(restore-from-checkpoint determinism): the recovered run's final loss is
within 1e-4 of the clean run's.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.launch.train import make_args, run


def clean_and_faulty(base: dict, fail_at_step: int) -> tuple:
    """``launch/train.run`` twice on ``base``'s arguments, each
    checkpointing into a fresh temporary directory: clean, then with a
    node failure injected at ``fail_at_step``."""
    out = []
    for fail in (-1, fail_at_step):
        with tempfile.TemporaryDirectory() as d:
            print("=== clean run ===" if fail < 0 else
                  f"\n=== run with injected node failure at step {fail} ===")
            out.append(run(make_args(**base, ckpt_dir=os.path.join(d, "ckpt"),
                                     fail_at_step=fail)))
    return tuple(out)


def check(clean: dict, faulty: dict, tol: float = 1e-4) -> float:
    """The example's two checks; returns |faulty - clean| of the final
    losses."""
    if not clean["final_loss"] < clean["losses"][0]:
        raise AssertionError("loss must drop")
    diff = abs(faulty["final_loss"] - clean["final_loss"])
    if not diff < tol:
        raise AssertionError("checkpoint recovery must reproduce the clean "
                             f"trajectory (|faulty - clean| = {diff:.3g})")
    return diff


def main(device="cuda", *, arch: str = "smollm-360m", steps: int = 120,
         batch: int = 8, seq: int = 128, lr: float = 1e-3,
         ckpt_every: int = 10, log_every: int = 20,
         fail_at_step: int = 30) -> dict:
    """Both runs at the reference's sizes and its checks; returns what it
    prints."""
    dev = resolve_device(device)
    base = dict(arch=arch, smoke=True, steps=steps, batch=batch, seq=seq,
                lr=lr, ckpt_every=ckpt_every, log_every=log_every,
                device=str(dev))
    clean, faulty = clean_and_faulty(base, fail_at_step)
    print(f"loss {clean['losses'][0]:.3f} -> {clean['final_loss']:.3f}")
    print(f"failures={faulty['failures']}, final loss "
          f"{faulty['final_loss']:.4f} (clean {clean['final_loss']:.4f})")
    diff = check(clean, faulty)
    print("recovery reproduced the clean trajectory exactly.")
    return dict(device=str(dev), first_loss=clean["losses"][0],
                final_loss=clean["final_loss"],
                faulty_final_loss=faulty["final_loss"],
                failures=faulty["failures"], final_loss_diff=diff,
                steps=clean["steps"], clean_wall_s=clean["wall_s"],
                faulty_wall_s=faulty["wall_s"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the run fails when it "
                    "is absent)")
    main(ap.parse_args().device)
