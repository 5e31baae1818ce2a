"""PyTorch/CUDA port of the hierarchical D4M reproduction (``repro``).

The package mirrors ``src/repro/`` file for file: ``core/`` (semirings,
associative segments, the hierarchy, instance-batched streaming),
``kernels/`` (hand-written CUDA kernels for Hopper beside their plain
PyTorch versions), ``models/``, ``optim/``, ``query/``, ``obs/``,
``data/`` and ``launch/``.  It imports ``torch`` only: nothing of JAX and
nothing of ``repro``.

Entry points (``core.hier.create``, ``core.distributed.create_instances``,
``core.hier.state_from_numpy``, ``launch.ingest``, ``launch.query``,
``launch.train``) place state on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of falling back.
Every kernel wrapper runs its plain PyTorch version for a tensor on the
CPU and launches its CUDA kernel for a tensor on the card.

Importing the package itself loads nothing: ``analysis.lint`` and
``analysis.baseline`` run with neither torch nor jax installed.
"""
from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point builds its state on: ``"cuda"`` unless the
    caller names another.  Raises when CUDA is asked for and absent — the
    port never drops to the CPU on its own."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    return dev


def generator(seed: int, device=None) -> "torch.Generator":
    """A ``torch.Generator`` on ``device`` (resolved as above) seeded with
    ``seed``: the port's stand-in for a JAX PRNG key."""
    import torch
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
