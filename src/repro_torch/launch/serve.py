"""Batched LM serving: prefill + greedy decode with a static KV cache
— the port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --smoke --batch 8 --prompt-len 64 --gen 32

Runs on the CUDA device unless ``--device cpu`` (and raises without one).
Prefill builds the cache, then the decode loop appends greedily chosen
tokens.  Reports prefill tokens/s and decode tokens/s.  Both go through
the ``stages`` front door as the reference's do (``serve_steps``):
``serve.prefill`` eagerly, ``serve.decode`` as a ``"graph"`` entry — on
the card its first step runs eagerly, its second is captured as a CUDA
graph, and every later step (of this run or the next one of the same
shapes) replays it.  The cache length is a 0-d device tensor, so a
replayed step writes where the length it is given says.  On the card the
decode loop runs under ``torch.cuda.set_sync_debug_mode("error")``: like
the reference's, it makes the host wait for the device only once, after
the last step.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch

from repro_torch import resolve_device, stages
from repro_torch.configs.registry import get_config, get_smoke_config


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On a CUDA device, any operation that makes the host wait for the
    device raises inside the block."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def serve_steps(cfg, max_len: int, arch: str, smoke: bool):
    """``(prefill, decode)`` as the reference wraps them, under one
    signature of (arch, smoke, max_len): ``serve.prefill`` (eager) and
    ``serve.decode`` (``"graph"``; the cache, argument 2, is donated: it is
    written in place, and the returned logits stay valid until the next
    decode step of the same shapes).  The config rides in ``static``, so
    two configs of one arch never share a program."""
    from repro_torch.models import transformer as tf

    sig = stages.signature_of(
        extra=(("arch", arch), ("smoke", bool(smoke)),
               ("max_len", int(max_len))))
    static = (("cfg", cfg),)
    prefill = stages.wrap(
        lambda p, t: tf.prefill(p, t, cfg, max_len=max_len),
        "serve.prefill", sig, static=static)
    decode = stages.wrap(
        lambda p, t, c, n: tf.decode_step(p, t, c, n, cfg),
        "serve.decode", sig, static=static, donate_argnums=(2,),
        kind="graph")
    return prefill, decode


def generate(params, prompts: torch.Tensor, cfg, gen: int, *,
             arch: str = "", smoke: bool = False) -> dict:
    """Prefill ``prompts`` [B, S], then ``gen`` greedy decode steps into a
    cache of S + gen positions, through ``serve_steps`` (``arch`` defaults
    to ``cfg.name``).  Returns the tokens [B, gen + 1] (the prefill's
    choice, then one per step), the last logits, the cache, its length,
    the seconds of prefill and of the steady decode steps, each ended by a
    synchronize, and how many steps those were (``decode_steps``): on the
    card the step that warms the decode up and the one that captures it
    are not timed.  The decode's graphs are released at the end (the
    logits stay valid), so the caller's params are not pinned."""
    from repro_torch.models.attention import as_length

    dev = prompts.device
    s = prompts.shape[1]
    prefill, decode = serve_steps(cfg, s + gen, arch or cfg.name, smoke)
    t0 = time.perf_counter()
    logits, cache, cache_len = prefill(params, prompts)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    tokens = [torch.argmax(logits, dim=-1).to(torch.int32)]
    length = as_length(cache_len, dev)

    def step(i, untimed):
        nonlocal logits, cache
        # a copy of the token: a captured step's inputs are the tensors its
        # capturing dispatch was given, and later steps copy into them
        args = (params, tokens[-1][:, None].clone(), cache, length + i)
        if untimed and decode.is_steady(*args):
            return False
        logits, cache = decode(*args)
        tokens.append(torch.argmax(logits, dim=-1).to(torch.int32))
        return True

    i = 0
    with no_host_sync(dev):
        while i < gen and step(i, untimed=True):
            i += 1
    _sync(dev)
    t0 = time.perf_counter()
    with no_host_sync(dev):
        for j in range(i, gen):
            step(j, untimed=False)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    decode.release()
    return dict(tokens=torch.stack(tokens, dim=1), logits=logits,
                cache=cache, cache_len=cache_len + gen, prefill_s=prefill_s,
                decode_s=decode_s, decode_steps=gen - i)


def run_config(cfg, args):
    """Serve ``cfg`` (prefill_microbatch set to 0, as the reference does)
    at ``args``' batch, prompt length, generation length, seed and device;
    returns ``(result dict, state)``: the reference's keys, and the params,
    prompts, config and ``generate``'s output."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import transformer as tf

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(cfg, prefill_microbatch=0)
    params = tf.init(args.seed, cfg, device=dev)
    prompts = token_batch(args.seed, args.batch, args.prompt_len - 1,
                          cfg.vocab, device=dev)["tokens"]
    prompts = torch.cat([prompts, torch.zeros((args.batch, 1),
                                              dtype=torch.int32,
                                              device=dev)], dim=1)
    state = generate(params, prompts, cfg, args.gen, arch=args.arch,
                     smoke=args.smoke)
    steps = state["decode_steps"]
    out = dict(
        prefill_tok_s=args.batch * args.prompt_len / state["prefill_s"],
        decode_tok_s=(args.batch * steps / state["decode_s"]
                      if steps else 0.0),
        prefill_s=state["prefill_s"], decode_s=state["decode_s"],
        generated=tuple(state["tokens"].shape),
        finite=bool(torch.isfinite(state["logits"]).all()))
    return out, dict(state, params=params, prompts=prompts, cfg=cfg)


def run_with_state(args):
    """Serve ``args.arch``; returns ``(result dict, state)`` as
    ``run_config``."""
    resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return run_config(cfg, args)


def run(args) -> dict:
    return run_with_state(args)[0]


def make_args(**kw) -> argparse.Namespace:
    """Programmatic entry (tests): the CLI's defaults, and ``device``
    (default cuda)."""
    args = parser().parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu")
    return ap


def main():
    out = run(parser().parse_args())
    print(f"prefill {out['prefill_tok_s']:.0f} tok/s "
          f"({out['prefill_s']:.2f}s) | decode {out['decode_tok_s']:.0f} "
          f"tok/s ({out['decode_s']:.2f}s) | generated {out['generated']} "
          f"finite={out['finite']}")


if __name__ == "__main__":
    main()
