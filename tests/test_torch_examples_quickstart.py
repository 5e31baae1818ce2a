"""``repro_torch.examples.quickstart`` against the JAX package's same
calls (``examples/quickstart.py``), section by section, on the same numpy
inputs, on the CPU: the Fig 1 array's nnz, overflow and dense view, the
``spmv`` and row-extract neighbors, the streamed hierarchy's
``nnz_per_layer`` and spills, the live lookups, row 3's live columns, the
top-3 rows, the degree vector and the max.plus view — all exact (integer
streams).  Section 6's fleet sample equals the reference's, and both
monitors count the records it emitted.  ``main`` on the CPU returns what
it printed."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import assoc as jassoc
from repro.core import hier as jhier
from repro.core import semiring as jsr
from repro.launch import monitor as jmonitor
from repro.query import analytics as janalytics
from repro.query import engine as jengine
from repro_torch.examples import quickstart as qs

CUTS = (64, 256, 1024)


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


@pytest.fixture(scope="module")
def streamed():
    """The port's stream (its seeded blocks, as numpy too) through both
    packages' hierarchies."""
    blocks = qs.stream_blocks(0, 32, 32, 512, "cpu")
    h = qs.stream(blocks, CUTS, "cpu")
    jh = jhier.create(CUTS, block_size=32)
    for r, c in blocks:
        jh = jhier.update(jh, jnp.asarray(r.numpy()), jnp.asarray(c.numpy()),
                          jnp.ones(32))
    return blocks, h, jh


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fig1_and_neighbors():
    src, dst, val = qs.traffic("cpu")
    A, overflow = qs.fig1(src, dst, val)
    jA, joverflow = jassoc.from_coo(*(jnp.asarray(x.numpy())
                                      for x in (src, dst, val)),
                                    capacity=16)
    assert int(A.nnz) == int(jA.nnz) == 6
    assert int(overflow) == int(joverflow) == 0
    _eq(qs.assoc.to_dense(A, 4, 4), jassoc.to_dense(jA, 4, 4))
    nb = qs.neighbors(A)
    e0 = jnp.zeros(4).at[0].set(1.0)
    _eq(nb["spmv"], jassoc.spmv(jA, e0, num_rows=4))
    cols, vals, mask = jassoc.extract_row(jA, 0)
    assert nb["row"] == [(int(c), float(v))
                         for c, v, m in zip(cols, vals, mask) if m]


def test_max_plus():
    src, dst, _ = qs.traffic("cpu")
    ts = jnp.arange(7, dtype=jnp.float32)
    jl, _ = jassoc.from_coo(jnp.asarray(src.numpy()),
                            jnp.asarray(dst.numpy()), ts, capacity=16,
                            sr=jsr.MAX_PLUS)
    _eq(qs.max_plus(src, dst), jassoc.to_dense(jl, 4, 4, sr=jsr.MAX_PLUS))


def test_stream(streamed):
    _, h, jh = streamed
    _eq(h.nnz_per_layer(), jh.nnz_per_layer())
    _eq(h.spills, jh.spills)
    merged, jmerged = qs.hier.query_all(h), jhier.query_all(jh)
    assert int(merged.nnz) == int(jmerged.nnz)
    assert float(qs.assoc.total(merged)) == float(jassoc.total(jmerged)) \
        == 1024


def test_live_reads(streamed):
    blocks, h, jh = streamed
    r, c = blocks[-1]
    live = qs.live_reads(h, r[:3], c[:3])
    jr, jc = jnp.asarray(r.numpy()[:3]), jnp.asarray(c.numpy()[:3])
    _eq(live["lookups"], jhier.lookup(jh, jr, jc))
    jrow, jtrunc = jengine.extract_rows(jh, jnp.array([3]), num_cols=512)
    _eq(live["row"], jrow)
    assert int((live["row"] != 0).sum()) == int((jrow != 0).sum())
    _eq(live["truncated"], jtrunc)
    totals, hot = janalytics.top_k_rows(jh, num_rows=512, k=3)
    _eq(live["top_rows"], hot)
    _eq(live["top_totals"], totals)
    _eq(live["degrees"], janalytics.out_degrees(jh, num_rows=512))


def test_observe_counts_what_it_emitted(streamed, tmp_path):
    _, h, jh = streamed
    d, jd = str(tmp_path / "port"), str(tmp_path / "ref")
    sample, summary = qs.observe(h, d)
    jobs.enable(jd)
    try:
        jsample = jobs.metrics.fleet_sample(jh)
        jobs.emit("fleet", **jsample)
    finally:
        jobs.disable()
    jsummary = jmonitor.main(["--once", "--obs-dir", jd])
    assert sample == jsample
    with open(os.path.join(d, "obs.jsonl")) as f:
        evs = [json.loads(line)["ev"] for line in f]
    # the port also writes its span of the sample's one dispatch
    assert summary["records"] == len(evs)
    assert len(evs) - evs.count("span") == jsummary["records"]
    assert evs.count("span") == 1 and summary["spans"][
        "hier.metrics_snapshot"]["count"] == 1
    assert evs.count("fleet") == 1 and summary["sources"] == 1
    assert summary["per_layer"] == jsummary["per_layer"]


def test_main_on_the_cpu_returns_what_it_printed(capsys):
    out = qs.main("cpu")
    printed = capsys.readouterr().out
    assert out["device"] == "cpu" and out["nnz"] == 6
    assert f"{out['unique_edges']} unique edges" in printed
    assert f"monitor saw {out['monitor_records']} records" in printed
    assert out["sample"]["updates"] == 32 * 32
    json.dumps(out)                 # plain values: it crosses processes
    assert torch.equal(torch.tensor(out["max_plus"]),
                       qs.max_plus(*qs.traffic("cpu")[:2]))
