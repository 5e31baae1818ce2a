"""Static and runtime contract enforcement for the port — the counterpart
of ``repro/analysis``, at every level the port's programs exist at:

1. **source** — ``repro_torch.analysis.lint`` (**reprolint**): an AST
   lint, stdlib ``ast`` only, run as ``python -m
   repro_torch.analysis.lint src/repro_torch``.  Rules R001-R006 encode
   the front-door, canonical-form and kernel-universe contracts in their
   PyTorch form.
2. **recorded calls** — ``repro_torch.analysis.tracekit``: rules
   J001-J006 over one seeded call sequence of every fleet entry
   (``stages.fleet_jobs``) recorded under a ``TorchDispatchMode`` (float64
   leaks, closure-held tensors, unhonored donation, host reads, int64
   widening, retrace sprawl), plus per-entry ``flops`` / ``bytes_accessed``
   / ``peak_bytes`` pinned as committed budgets in
   ``analysis/COST_BUDGETS.json``.  Run as ``python -m
   repro_torch.analysis.tracekit --check``.
3. **kernel** — ``repro_torch.analysis.palkit``: rules K000-K006 over
   every CUDA kernel job of ``kernels/registry.jobs()`` on the card (build
   and launch, block alignment, shared memory against the H100's ceiling
   and the committed ``analysis/SMEM_BUDGETS.json``, out-of-bounds
   accesses, reads before writes, divergence from the plain version,
   async-copy and barrier discipline under ``compute-sanitizer`` or the
   checked build).  Run as ``python -m repro_torch.analysis.palkit
   --check``; it exits 2 without a CUDA device.
4. **runtime** — ``repro_torch.analysis.contracts``: the eager contract
   checks behind ``REPRO_CHECK=1``.

``repro_torch.analysis.baseline`` is the shared accepted-debt machinery
(allow comments and committed baseline files) of the three analyzers.

Do NOT import ``contracts``, ``tracekit`` or ``palkit`` here: ``lint``
and ``baseline`` must stay importable with neither torch nor jax
installed.
"""
