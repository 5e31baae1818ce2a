"""DCN-v2 with the paper's technique as an optimizer feature — the port of
``examples/recsys_hier_embeddings.py``.

    PYTHONPATH=src python -m repro_torch.examples.recsys_hier_embeddings \\
        [--device cpu] [--use-kernel]

Trains the same reduced DCN-v2 twice from the same initial weights:
  * dense path — autodiff table grads, scatter into HBM every step;
  * hier path  — row-sparse grads block-added into a hierarchical
    accumulator (core/vassoc); the master table is only touched on spill/
    drain, i.e. most update traffic stays in fast memory — the paper's
    claim transplanted into training.

Also serves a batch and runs the 1M-candidate retrieval scoring shape at
reduced size, from the hier path's weights.  The port's steps update the
parameters in place, so the dense path trains a copy.  ``use_kernel`` is
the config's: serving and retrieval on the ``embedding_bag`` kernel route
(training takes the gather route, as the kernel route has no autograd);
off as in the reference.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import recsys_batch, retrieval_batch
from repro_torch.models import dcn
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def batches(cfg, seed: int, batch: int, device):
    """Step i's batch from the seed ``(seed << 32) | i`` (the reference
    folds i into its key)."""
    def data(i):
        return recsys_batch((int(seed) << 32) | i, batch,
                            n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
                            vocab_per_field=min(cfg.table_sizes),
                            device=device)
    return data


def train_dense(cfg, params, data, steps: int, lr: float = 1e-3) -> tuple:
    """The dense path on ``params`` (in place); returns ``(params, each
    step's metrics)``."""
    step = dcn.make_train_step(cfg, AdamWConfig(lr=lr))
    opt, out = adamw_init(params), []
    for i in range(steps):
        params, opt, m = step(params, opt, data(i))
        out.append(m)
    return params, out


def train_hier(cfg, params, data, steps: int, batch: int, *,
               lr: float = 1e-3, embed_lr: float = 0.05,
               drain_every: int = 16, cuts=(2048, 8192, 32768)) -> tuple:
    """The hier path on ``params`` (in place): the table's gradient rows
    into a ``HierVec``, drained on pressure or every ``drain_every``
    steps; returns ``(params, hier state, each step's metrics)``."""
    step = dcn.make_train_step_hier(cfg, AdamWConfig(lr=lr),
                                    embed_lr=embed_lr,
                                    drain_every=drain_every)
    opt = adamw_init(dcn.rest_params(params))
    h = dcn.hier_embed_init(cfg, batch, cuts=tuple(cuts),
                            device=params.table.device)
    out = []
    for i in range(steps):
        params, opt, h, m = step(params, opt, h, data(i))
        out.append(m)
    return params, h, out


def run_with_state(device="cuda", *, use_kernel: bool = False,
                   seed: int = 0, batch: int = 256, steps: int = 60,
                   drain_every: int = 16, cuts=(2048, 8192, 32768),
                   n_candidates: int = 100_000) -> tuple:
    """Both paths, serving and retrieval; returns ``(what main prints,
    (hier-trained params, the serving batch, the serving config))``."""
    dev = resolve_device(device)
    cfg = get_smoke_config("dcn-v2")
    params = dcn.init(seed, cfg, device=dev)
    data = batches(cfg, seed, batch, dev)

    t0 = time.perf_counter()
    _, dense = train_dense(cfg, copy.deepcopy(params), data, steps)
    dense_loss = float(dense[-1]["loss"])
    dense_s = time.perf_counter() - t0
    print(f"dense path: final loss {dense_loss:.4f} ({dense_s:.1f}s)")

    t0 = time.perf_counter()
    p2, _, hier = train_hier(cfg, params, data, steps, batch,
                             drain_every=drain_every, cuts=cuts)
    m2 = hier[-1]
    hier_loss, hier_s = float(m2["loss"]), time.perf_counter() - t0
    drains = sum(int(m["drained"]) for m in hier)
    spills = m2["spills"].tolist()
    print(f"hier path:  final loss {hier_loss:.4f} ({hier_s:.1f}s) — "
          f"table touched on {drains}/{steps} steps, "
          f"pending={int(m2['pending_nnz'])} rows, spills={spills}")

    serve_cfg = dataclasses.replace(cfg, use_kernel=use_kernel)
    serve_batch = data(999)
    scores = dcn.serve_scores(p2, serve_batch, serve_cfg)
    print(f"serve: {scores.shape[0]} CTRs in [{float(scores.min()):.3f}, "
          f"{float(scores.max()):.3f}]")
    cand = retrieval_batch(seed, 1, n_candidates, cfg.mlp[-1],
                           device=dev)["candidates"]
    tv, ti = dcn.retrieval_topk(
        p2, {k: serve_batch[k] for k in ("dense", "sparse")}, cand,
        serve_cfg, 10)
    print(f"retrieval: top-10 of {n_candidates // 1000}k candidates per "
          f"query, best score {float(tv[0, 0]):.2f}")
    out = dict(device=str(dev), use_kernel=use_kernel,
               dense_loss=dense_loss, dense_s=dense_s, hier_loss=hier_loss,
               hier_s=hier_s, drains=drains,
               pending_nnz=int(m2["pending_nnz"]), spills=spills,
               scores=scores.tolist(), best_score=float(tv[0, 0]),
               top_ids=ti[0].tolist())
    return out, (p2, serve_batch, serve_cfg)


def main(device="cuda", **kw) -> dict:
    return run_with_state(device, **kw)[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the run fails when it "
                    "is absent)")
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    help="serve and retrieve on the embedding_bag kernel "
                    "route (the config's use_kernel)")
    cli = ap.parse_args()
    main(cli.device, use_kernel=cli.use_kernel)
