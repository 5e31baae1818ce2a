"""Fault-tolerant training driver — the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --ckpt-every 10 [--compress int8|topk]

Runs on the CUDA device unless ``--device cpu`` (and raises without one).
The supervisor loop is the reference's:
  * async step-granular checkpoints (params + opt [+ hier]), atomic on
    disk, auto-GC'd, in the JAX package's format (a checkpoint of either
    package restores in the other);
  * resume: ``--resume`` restarts from the latest complete checkpoint and
    reproduces the no-failure loss trajectory (step s's batch comes from a
    generator seeded from (seed + 1, s));
  * failure injection: ``--fail-at-step N`` raises mid-run; the supervisor
    loop catches, restores, and continues;
  * straggler mitigation: per-step deadline EMA (``runtime/straggler.py``);
    persistent stragglers escalate to the failure path;
  * cross-pod gradient compression of the ``lm`` family (``--compress
    int8|topk``, ``optim/compression.py``) with error feedback — the
    compress->wire->decompress roundtrip runs in-step; its error tree is
    part of the checkpointed state;
  * hierarchical sparse embedding-grad accumulation for recsys
    (``--hier-embed``): the paper's technique as an optimizer feature.

Families: ``lm`` (the five LM archs; ``--smoke`` trains with one
microbatch, as the reference does; on the card each step runs under
``set_sync_debug_mode("error")``, so it makes the host wait for nothing),
``recsys`` (DCN-v2) and ``gnn``.  ``--compress`` only touches the ``lm``
setup, as in the reference.  The step function is called directly (the
reference wraps it in its ``stages`` compile front door, which the port
does not have yet).

Every family's adapter exposes the same contract:
    state0, step(state, batch) -> (state, metrics), data(step) -> batch
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import generator, resolve_device
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.registry import family, get_config, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.straggler import StragglerEvicted, StragglerMonitor


class InjectedFailure(RuntimeError):
    pass


def step_seed(seed: int, step: int) -> int:
    """Step ``step``'s data seed, from ``(seed + 1, step)``: the port's
    counterpart of ``fold_in(PRNGKey(seed + 1), step)``."""
    return ((int(seed) + 1) << 32) | int(step)


def _lm_setup(cfg, args, device):
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import no_host_sync
    from repro_torch.models import common
    from repro_torch.models import transformer as tf
    from repro_torch.optim.compression import (CompressionConfig, ef_init,
                                               roundtrip)

    params = tf.init(args.seed, cfg, device=device)
    opt_cfg = AdamWConfig(lr=args.lr)

    if args.compress:
        comp = CompressionConfig(args.compress)

        def step_body(state, batch):
            (_, m), (g,) = common.value_and_grad(
                lambda p: tf.loss_fn(p, batch, cfg), state["params"])
            # error-feedback compression: what crosses the pod link
            g, err = roundtrip(g, state["err"], comp)
            p, o, gnorm = adamw_update(g, state["opt"], state["params"],
                                       opt_cfg)
            return dict(params=p, opt=o, err=err), dict(m, gnorm=gnorm)

        state0 = dict(params=params, opt=adamw_init(params),
                      err=ef_init(params))
    else:
        raw = tf.make_train_step(cfg, opt_cfg)

        def step_body(state, batch):
            p, o, m = raw(state["params"], state["opt"], batch)
            return dict(params=p, opt=o), m

        state0 = dict(params=params, opt=adamw_init(params))

    def step_fn(state, batch):
        with no_host_sync(device):
            return step_body(state, batch)

    def data(step):
        return token_batch(step_seed(args.seed, step), args.batch, args.seq,
                           cfg.vocab, device=device)

    return state0, step_fn, data


def _gnn_setup(cfg, args, device):
    from repro_torch.data import graphs as G
    from repro_torch.models import gnn

    n_classes = 8
    g = G.random_graph(args.seed, n_nodes=max(args.batch * 16, 256),
                       n_edges=max(args.batch * 64, 1024), d_feat=32,
                       n_classes=n_classes, device=device)
    n_out = cfg.n_vars if cfg.kind == "graphcast" else n_classes
    params = gnn.init(args.seed, cfg, d_feat=32, n_out=n_out, device=device)
    task = "regress" if cfg.kind == "graphcast" else "node"
    if task == "regress":
        g["targets"] = torch.randn((g["node_feat"].shape[0], n_out),
                                   generator=generator(args.seed, device),
                                   device=device)
    raw = gnn.make_train_step(cfg, AdamWConfig(lr=args.lr), task)

    def step_fn(state, batch):
        p, o, m = raw(state["params"], state["opt"], batch)
        return dict(params=p, opt=o), m

    return (dict(params=params, opt=adamw_init(params)), step_fn,
            lambda step: g)


def _recsys_setup(cfg, args, device):
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.models import dcn

    params = dcn.init(args.seed, cfg, device=device)
    if args.hier_embed:
        raw = dcn.make_train_step_hier(cfg, AdamWConfig(lr=args.lr))
        hstate = dcn.hier_embed_init(cfg, args.batch,
                                     cuts=(1024, 8192, 65536), device=device)

        def step_fn(state, batch):
            p, o, h, m = raw(state["params"], state["opt"], state["hier"],
                             batch)
            return dict(params=p, opt=o, hier=h), m

        state0 = dict(params=params, opt=adamw_init(dcn.rest_params(params)),
                      hier=hstate)
    else:
        raw = dcn.make_train_step(cfg, AdamWConfig(lr=args.lr))

        def step_fn(state, batch):
            p, o, m = raw(state["params"], state["opt"], batch)
            return dict(params=p, opt=o), m

        state0 = dict(params=params, opt=adamw_init(params))

    def data(step):
        return recsys_batch(step_seed(args.seed, step), args.batch,
                            n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                            vocab_per_field=min(cfg.table_sizes),
                            device=device)

    return state0, step_fn, data


def run_with_state(args):
    """Train; returns ``(result dict, final state)``.  The result adds
    ``step_s`` (host seconds of each completed step, ended by reading its
    loss) and ``gnorms`` (each step's pre-clip gradient norm) to the
    reference's keys."""
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    fam = family(args.arch)
    if fam == "lm" and args.smoke:
        cfg = dataclasses.replace(cfg, num_microbatches=1)
    setup = dict(lm=_lm_setup, gnn=_gnn_setup, recsys=_recsys_setup)[fam]
    state, step_fn, data = setup(cfg, args, device)

    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore(args.ckpt_dir, last, state)
            start = last
            print(f"[resume] restored step {last}")

    monitor = StragglerMonitor(threshold=args.straggler_threshold)
    losses, step_s, gnorms = [], [], []
    failures = 0
    step = start
    t_start = time.time()
    while step < args.steps:
        try:
            batch = data(step)
            monitor.start()
            if args.fail_at_step == step and failures == 0:
                failures += 1
                raise InjectedFailure(f"injected node failure @ step {step}")
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))          # waits for the step
            step_s.append(time.perf_counter() - t0)
            gnorms.append(float(m["gnorm"]))
            slow = monitor.stop()
            if args.log_every and step % args.log_every == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f}"
                      f"{'  [STRAGGLER]' if slow else ''}")
            step += 1
            if ckpt and step % args.ckpt_every == 0:
                ckpt.save(step, state)
        except (InjectedFailure, StragglerEvicted) as e:
            print(f"[failure] {e} — restoring from checkpoint")
            if ckpt:
                ckpt.wait()
            last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
            if last is None:
                print("[failure] no checkpoint yet; restarting from step 0")
                step = 0
                continue
            state = restore(args.ckpt_dir, last, state)
            step = last
    if ckpt:
        ckpt.save(step, state)
        ckpt.wait()
    wall = time.time() - t_start
    out = dict(losses=losses, steps=step, wall_s=wall,
               straggler_flags=monitor.flagged, failures=failures,
               final_loss=losses[-1] if losses else float("nan"),
               step_s=step_s, gnorms=gnorms)
    return out, state


def run(args) -> dict:
    return run_with_state(args)[0]


def make_args(**kw) -> argparse.Namespace:
    """Programmatic entry (tests / examples): the reference's defaults and
    ``device`` (default cuda)."""
    defaults = dict(arch="smollm-360m", smoke=True, steps=20, batch=4,
                    seq=64, lr=3e-4, seed=0, ckpt_dir="", ckpt_every=5,
                    resume=False, fail_at_step=-1, straggler_threshold=10.0,
                    compress="", hier_embed=False, log_every=0,
                    device="cuda")
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--straggler-threshold", type=float, default=10.0)
    ap.add_argument("--compress", default="", choices=["", "int8", "topk"],
                    help="cross-pod gradient compression of the lm family "
                    "(no effect on recsys and gnn)")
    ap.add_argument("--hier-embed", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the run fails when it "
                    "is absent)")
    return ap


def main():
    out = run(parser().parse_args())
    print(f"done: {out['steps']} steps, final loss {out['final_loss']:.4f}, "
          f"{out['wall_s']:.1f}s, stragglers={out['straggler_flags']}, "
          f"failures={out['failures']}")


if __name__ == "__main__":
    main()
