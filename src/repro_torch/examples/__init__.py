"""The JAX package's four examples (``examples/*.py``), ported: each is a
module run as ``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu``.

- ``quickstart``: associative arrays, the paper's Fig 1 query, a
  hierarchy, live reads, max.plus and the obs monitor;
- ``stream_ingest``: the paper's §III experiment at container scale
  (``launch/ingest``), a checkpoint restart and the global degree
  histogram on a one-rank fleet;
- ``recsys_hier_embeddings``: DCN-v2 trained dense and with the
  hierarchical embedding-gradient accumulator, serving and retrieval;
- ``train_lm``: a smoke-size decoder through ``launch/train``, clean and
  with an injected failure.

Importing one runs nothing: each has functions and a ``main(device="cuda",
**sizes)`` that takes the sizes the reference hard-codes (its values are
the defaults) and returns a dict of what it prints.
"""
