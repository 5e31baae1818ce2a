"""Port parity: the hier_merge kernels' plain PyTorch versions against the
JAX Pallas kernels (interpret mode) on every runnable registry job, the
port's ``ops.merge`` / ``ops.merge_multi`` against the JAX package's, and
the port's registry input makers against the reference's, bit for bit.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against these plain versions there); on a CPU tensor each wrapper runs
its plain version and counts no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.hier_merge import ops as jops
from repro_torch.kernels import registry as treg
from repro_torch.kernels.hier_merge import hier_merge as thm
from repro_torch.kernels.hier_merge import ops as tops
from repro_torch.kernels.hier_merge import ref as tref

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _jax_shim():
    # repro/stages.py calls jax.core.raise_to_shaped, gone from newer JAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "raise_to_shaped",
                   lambda a, weak_type=None: a, raising=False)
        yield


def _port_name(ref_name: str) -> str:
    return ref_name.replace("_pallas", "_cuda")


_JAX_JOBS = {j.name: j for j in jreg.jobs() if j.family == "hier_merge"}
_PORT_JOBS = {j.name: j for j in treg.jobs()}
_RUNNABLE = sorted(n for n, j in _JAX_JOBS.items() if not j.audit_only)


def _torch_args(args):
    if isinstance(args[3], list):                  # merge_multi layout
        bh, bl, bv, runs = args
        return (*(torch.from_numpy(x) for x in (bh, bl, bv)),
                [tuple(torch.from_numpy(x) for x in r) for r in runs])
    return tuple(torch.from_numpy(x) for x in args)


def _assert_out(got, want, exact, rtol):
    got = [np.asarray(x) for x in got]
    want = [np.asarray(x) for x in want]
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    if exact:
        np.testing.assert_array_equal(got[2], want[2])
    else:
        fin = np.isfinite(want[2])
        np.testing.assert_array_equal(got[2][~fin], want[2][~fin])
        np.testing.assert_allclose(got[2][fin], want[2][fin], rtol=rtol,
                                   atol=1e-6)


def test_port_registry_matches_reference_jobs():
    """One port job per reference job, every family (the audit-only n65536
    row runs on the card in the port), and one CUDA source per family."""
    assert sorted(j.name for j in treg.jobs()) == \
        sorted(_port_name(j.name) for j in jreg.jobs())
    assert treg.AUDITED_FILES == ("hier_merge/csrc/hier_merge.cu",
                                  "embedding_bag/csrc/embedding_bag.cu",
                                  "segment_agg/csrc/segment_agg.cu")
    assert {j.counter for j in treg.jobs()} <= set(treg.LAUNCHES)


@pytest.mark.parametrize("name", sorted(_JAX_JOBS))
def test_input_makers_bit_for_bit(name):
    a = _JAX_JOBS[name].make_inputs(3)
    b = _PORT_JOBS[_port_name(name)].make_inputs(3)
    flat = lambda x: [y for v in x for y in (flat(v) if isinstance(
        v, (list, tuple)) else [v])]
    fa, fb = flat(a), flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", _RUNNABLE)
def test_plain_matches_pallas_interpret(name):
    """The plain version (what a CPU tensor runs) equals the Pallas kernel
    in interpret mode and the port's sort-based oracle."""
    jjob, tjob = _JAX_JOBS[name], _PORT_JOBS[_port_name(name)]
    args = jjob.make_inputs(0)
    want = jjob.fn(*args, interpret=True)
    targs = _torch_args(args)
    exact = args[2].dtype == np.int32
    got = tjob.fn(*targs)                        # CPU -> plain version
    _assert_out(got, want, exact, tjob.rtol)
    _assert_out(tjob.oracle(*targs), want, exact, tjob.rtol)


def test_wrappers_route_by_device():
    """CPU tensors run the plain version and count no launch; a tensor on
    another device is refused, never silently moved."""
    args = _torch_args(_PORT_JOBS["hier_merge.merge_cuda/n512.plus.times"
                                  ".float32"].make_inputs(0))
    treg.reset_launches()
    got = thm.merge_cuda(*args, sr_name="plus.times")
    _assert_out(got, thm.merge_plain(*args, sr_name="plus.times"), True, 0)
    assert treg.launches()["hier_merge.merge"] == 0
    meta = tuple(x.to("meta") for x in args)
    with pytest.raises(ValueError, match="unsupported device"):
        thm.merge_cuda(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        thm.merge_multi_cuda(meta[:3], [meta[3:]])


def _seg(seed, n, cap, nkeys, dtype, sr_name):
    rng = np.random.default_rng(seed)
    seg = treg._canonical_segment(rng, 2 * n, nkeys, dtype, sr_name)
    return tuple(np.concatenate([x[:n], x[-1:].repeat(cap - n)])
                 for x in seg)


@pytest.mark.parametrize("sr_name", ["plus.times", "max.plus", "min.plus"])
@pytest.mark.parametrize("caps,out_cap", [((48, 80), 128), ((1000, 24), 1024),
                                          ((100, 100), 64)])
def test_ops_merge_matches(caps, out_cap, sr_name):
    """Padding, the kernel's size rule, truncation and overflow of
    ``ops.merge`` against the JAX package's (its XLA path: the same padding
    and finalize around an independent sort)."""
    a = _seg(1, caps[0] // 2, caps[0], 10**5, np.float32, sr_name)
    b = _seg(2, caps[1] // 2, caps[1], 10**5, np.float32, sr_name)
    want = jops.merge(*map(jnp.asarray, a + b), out_capacity=out_cap,
                      sr_name=sr_name, use_kernel=False)
    for use_kernel in (True, False):
        got = tops.merge(*map(torch.from_numpy, a + b), out_capacity=out_cap,
                         sr_name=sr_name, use_kernel=use_kernel)
        _assert_out(got[:4], want[:4], False, tp.RTOL)
        assert int(got[4]) == int(want[4])


@pytest.mark.parametrize("out_cap", [2048, 300])
def test_ops_merge_multi_matches(out_cap):
    rng = np.random.default_rng(5)
    block = (rng.integers(0, 40, 96).astype(np.int32),
             rng.integers(-40, 40, 96).astype(np.int32),
             rng.normal(size=96).astype(np.float32))
    runs = _seg(6, 200, 400, 10**4, np.float32, "plus.times") \
        + _seg(7, 300, 700, 10**4, np.float32, "plus.times")
    want = jops.merge_multi(*map(jnp.asarray, block + runs),
                            out_capacity=out_cap, use_kernel=False)
    assert tops.multi_padded_capacity(96, (400, 700)) == 2048
    for use_kernel in (True, False):
        got = tops.merge_multi(*map(torch.from_numpy, block + runs),
                               out_capacity=out_cap, use_kernel=use_kernel)
        _assert_out(got[:4], want[:4], False, tp.RTOL)
        assert int(got[4]) == int(want[4])


def test_ops_merge_multi_pallas_interpret_once():
    """One multi-way merge through the JAX Pallas kernel itself."""
    rng = np.random.default_rng(8)
    block = (rng.integers(0, 30, 64).astype(np.int32),
             rng.integers(0, 30, 64).astype(np.int32),
             rng.integers(1, 4, 64).astype(np.float32))
    run = _seg(9, 50, 100, 900, np.float32, "plus.times")
    want = jops.merge_multi(*map(jnp.asarray, block + run), out_capacity=200,
                            use_kernel=True, interpret=True)
    got = tops.merge_multi(*map(torch.from_numpy, block + run),
                           out_capacity=200)
    _assert_out(got[:4], want[:4], True, 0)


def test_zero_for_matches_reference():
    from repro.kernels.hier_merge import ref as jref
    for sr_name in ("plus.times", "max.plus", "min.plus", "max.min"):
        for td, nd in ((torch.float32, np.float32), (torch.int32, np.int32)):
            assert np.asarray(tref._zero_for(sr_name, td), nd) == \
                jref._zero_for(sr_name, np.dtype(nd))


# ------------------------------------------- operands of any length ------

def _np_block(rng, n, nkeys, dtype):
    return (rng.integers(0, nkeys, n).astype(np.int32),
            rng.integers(-nkeys, nkeys, n).astype(np.int32),
            (rng.integers(-5, 5, n) if dtype == np.int32
             else rng.normal(size=n)).astype(dtype))


def _np_pad(x, n, zero):
    """Append SENTINEL keys (zero values) up to length ``n``."""
    hi, lo, val = x
    pad = n - hi.shape[0]
    fill = np.full((pad,), tref.SENTINEL, np.int32)
    return (np.concatenate([hi, fill]), np.concatenate([lo, fill]),
            np.concatenate([val, np.full((pad,), zero, val.dtype)]))


def _next_pow2(n):
    return 1 << (max(n, 1) - 1).bit_length()


@pytest.mark.parametrize("sr_name,dtype", [("plus.times", np.float32),
                                           ("max.plus", np.float32),
                                           ("min.plus", np.int32)])
@pytest.mark.parametrize("block,run_caps", [(100, (150,)), (37, (50, 90)),
                                            (300, ()), (5, (257,))])
def test_multi_any_length_matches_pallas(block, run_caps, sr_name, dtype):
    """``merge_multi_cuda`` (its plain version on the CPU) takes operands of
    any length and returns a segment of the summed length: equal to the
    Pallas kernel in interpret mode on the same operands padded with
    sentinels (sliced back), and to the sort-based oracle."""
    from repro.kernels.hier_merge import hier_merge as jhm
    rng = np.random.default_rng(block + len(run_caps))
    zero = treg._np_zero(sr_name, np.dtype(dtype))
    b = _np_block(rng, block, 60, dtype)
    runs = [treg._canonical_segment(rng, c, 60, dtype, sr_name)
            for c in run_caps]
    n = block + sum(run_caps)
    cum = _next_pow2(block)
    jb, jruns = _np_pad(b, cum, zero), []
    for r in runs:
        nxt = _next_pow2(cum + r[0].shape[0])
        jruns.append(_np_pad(r, nxt - cum, zero))
        cum = nxt
    want = jhm.merge_multi_pallas(tuple(map(jnp.asarray, jb)),
                                  [tuple(map(jnp.asarray, r)) for r in jruns],
                                  sr_name=sr_name, interpret=True)
    want = [np.asarray(x)[:n] for x in want[:3]] + [np.asarray(want[3])]
    treg.reset_launches()
    got = thm.merge_multi_cuda(tuple(map(torch.from_numpy, b)),
                               [tuple(map(torch.from_numpy, r)) for r in runs],
                               sr_name=sr_name)
    assert treg.launches()["hier_merge.merge_multi"] == 0
    assert got[0].shape == (n,)
    exact = dtype == np.int32
    _assert_out(got, want, exact, tp.RTOL)
    oracle = tref.merge_multi_ref(
        [torch.from_numpy(b[0])] + [torch.from_numpy(r[0]) for r in runs],
        [torch.from_numpy(b[1])] + [torch.from_numpy(r[1]) for r in runs],
        [torch.from_numpy(b[2])] + [torch.from_numpy(r[2]) for r in runs],
        sr_name=sr_name)
    _assert_out(got, oracle, exact, tp.RTOL)


@pytest.mark.parametrize("caps", [(100, 60), (250, 7), (1, 300)])
def test_pair_any_length_matches_pallas(caps):
    from repro.kernels.hier_merge import hier_merge as jhm
    rng = np.random.default_rng(sum(caps))
    a = treg._canonical_segment(rng, caps[0], 80, np.float32, "plus.times")
    b = treg._canonical_segment(rng, caps[1], 80, np.float32, "plus.times")
    n = sum(caps)
    jb = _np_pad(b, _next_pow2(n) - caps[0], np.float32(0))
    want = jhm.merge_pallas(*map(jnp.asarray, a + jb), interpret=True)
    want = [np.asarray(x)[:n] for x in want[:3]] + [np.asarray(want[3])]
    got = thm.merge_cuda(*map(torch.from_numpy, a + b))
    assert got[0].shape == (n,)
    _assert_out(got, want, False, tp.RTOL)
    _assert_out(got, tref.merge_ref(*map(torch.from_numpy, a + b)), False,
                tp.RTOL)


@pytest.mark.parametrize("out_cap", [200, 700, 1024, 1500])
@pytest.mark.parametrize("block,run_caps", [(96, (400, 300)), (300, (500,)),
                                            (513, ())])
def test_ops_merge_multi_unpadded_matches(block, run_caps, out_cap):
    """``ops.merge_multi`` no longer pads for the kernel route; results,
    nnz and overflow equal the JAX package's at shapes where the padded
    width (1024 / 2048) differs from the total, with ``out_capacity``
    below, between and above both."""
    rng = np.random.default_rng(block + out_cap)
    b = _np_block(rng, block, 300, np.float32)
    runs = [x for c in run_caps for x in treg._canonical_segment(
        rng, c, 300, np.float32, "plus.times")]
    want = jops.merge_multi(*map(jnp.asarray, b + tuple(runs)),
                            out_capacity=out_cap, use_kernel=False)
    got = tops.merge_multi(*map(torch.from_numpy, b + tuple(runs)),
                           out_capacity=out_cap)
    assert got[0].shape == (out_cap,)
    _assert_out(got[:4], want[:4], False, tp.RTOL)
    assert int(got[4]) == int(want[4])


@pytest.mark.parametrize("out_cap", [100, 600, 1024, 2000])
@pytest.mark.parametrize("caps", [(300, 300), (1000, 24), (513, 1)])
def test_ops_merge_unpadded_matches(caps, out_cap):
    rng = np.random.default_rng(caps[0] + out_cap)
    a = treg._canonical_segment(rng, caps[0], 10**4, np.int32, "plus.times")
    b = treg._canonical_segment(rng, caps[1], 10**4, np.int32, "plus.times")
    want = jops.merge(*map(jnp.asarray, a + b), out_capacity=out_cap,
                      use_kernel=False)
    got = tops.merge(*map(torch.from_numpy, a + b), out_capacity=out_cap)
    assert got[0].shape == (out_cap,)
    _assert_out(got[:4], want[:4], True, 0)
    assert int(got[4]) == int(want[4])


@pytest.mark.parametrize("block,run_caps", [
    (3072, (16384,)), (3072, (16384, 131072)), (1024, ()), (32768, (1,)),
    (32769, ()), (40000, (20000,)), (16384, (16384, 16384)), (1, (65535,)),
    (2, (65535,))])
def test_route_rule_matches_reference(block, run_caps, monkeypatch):
    """The kernel route is taken exactly when the JAX package's
    ``multi_padded_capacity(...) <= MAX_KERNEL_CAPACITY`` holds, although
    the CUDA kernel itself takes any length."""
    assert tops.MAX_KERNEL_CAPACITY == jops.MAX_KERNEL_CAPACITY
    assert tops.multi_padded_capacity(block, run_caps) == \
        jops.multi_padded_capacity(block, run_caps)
    routes = []
    monkeypatch.setattr(tops, "merge_multi_cuda",
                        lambda *a, **k: routes.append("kernel") or
                        (torch.zeros(1, dtype=torch.int32),) * 2
                        + (torch.zeros(1), torch.zeros(1, dtype=torch.int32)))
    monkeypatch.setattr(tops.ref, "merge_multi_ref",
                        lambda *a, **k: routes.append("sort") or
                        (torch.zeros(1, dtype=torch.int32),) * 2
                        + (torch.zeros(1), torch.zeros(1, dtype=torch.int32)))
    key = torch.zeros(block, dtype=torch.int32)
    run_arrays = []
    for c in run_caps:
        run_arrays += [torch.zeros(c, dtype=torch.int32)] * 2 + \
            [torch.zeros(c)]
    tops.merge_multi(key, key, torch.zeros(block), *run_arrays,
                     out_capacity=1)
    want = "kernel" if jops.multi_padded_capacity(block, run_caps) <= \
        jops.MAX_KERNEL_CAPACITY else "sort"
    assert routes == [want]


@pytest.mark.parametrize("bad", ["val_dtype", "key_dtype", "strided",
                                 "lengths", "two_d", "devices"])
def test_cuda_argument_checks_raise_before_launch(bad):
    """The CUDA route's argument checks run before anything is built or
    launched (``meta`` tensors stand in for card tensors)."""
    def op(n, vdtype=torch.float32):
        return [torch.empty(n, dtype=torch.int32, device="meta"),
                torch.empty(n, dtype=torch.int32, device="meta"),
                torch.empty(n, dtype=vdtype, device="meta")]

    block, run = op(40), op(24)
    if bad == "val_dtype":
        block[2] = torch.empty(40, dtype=torch.float64, device="meta")
    elif bad == "key_dtype":
        run[0] = torch.empty(24, dtype=torch.int64, device="meta")
    elif bad == "strided":
        run[1] = torch.empty(48, dtype=torch.int32, device="meta")[::2]
    elif bad == "lengths":
        run[2] = torch.empty(23, device="meta")
    elif bad == "two_d":
        block = [x.reshape(8, 5) for x in block]
    else:
        run[2] = torch.empty(24)
    thm._BOUND.pop("lib", None)
    treg.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        thm._launch("merge_multi_cuda", "hier_merge.merge_multi",
                    [tuple(block), tuple(run)], True, "plus.times")
    assert "lib" not in thm._BOUND
    assert treg.launches()["hier_merge.merge_multi"] == 0


@pytest.mark.parametrize("block_len,run_lens,ok", [
    (256 * 4096, [0], True),                # 256 chunks, the run is empty
    (256 * 4096, [7], False),               # 256 chunks + 1 run
    (256 * 4096 + 1, [], False),            # 257 chunks
    (4096, [5] * 255, True),                # 1 chunk + 255 runs
    (4097, [5] * 255, False),               # 2 chunks + 255 runs
    (0, [5] * 256, True),                   # no block, 256 runs
])
def test_cuda_operand_limit_checked_before_launch(block_len, run_lens, ok):
    """More sorted operands (the block's chunks plus the non-empty runs)
    than the C side takes are refused with a ValueError that says so,
    before anything is built or launched."""
    def op(n):
        return tuple(torch.empty(n, dtype=dt, device="meta")
                     for dt in (torch.int32, torch.int32, torch.float32))

    srcs = [op(block_len)] + [op(n) for n in run_lens]
    assert thm.MAX_SORTED_OPERANDS == 256 and thm.RANK_CHUNK == 4096
    if ok:
        assert thm._check_operands(srcs, "merge_multi_cuda", True) == \
            block_len + sum(run_lens)
        return
    thm._BOUND.pop("lib", None)
    treg.reset_launches()
    with pytest.raises(ValueError, match="sorted operands, at most 256"):
        thm._launch("merge_multi_cuda", "hier_merge.merge_multi", srcs, True,
                    "plus.times")
    assert "lib" not in thm._BOUND
    assert treg.launches()["hier_merge.merge_multi"] == 0


# ------------------------------------------------- 16-bit values ---------

RTOL16 = {"bfloat16": 1e-2, "float16": 2e-3}   # the order of 16-bit adds


def _assert_out16(got, want, dtype, exact):
    """Keys and nnz exact; 16-bit values in float32 exactly, or within the
    dtype's rtol (atol the same) where the adds may round in another
    order."""
    for i in (0, 1, 3):
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]))
    assert got[2].dtype == getattr(torch, dtype)
    g = got[2].to(torch.float32).numpy()
    w = np.asarray(jnp.asarray(want[2]).astype(jnp.float32))
    fin = np.isfinite(w)
    np.testing.assert_array_equal(g[~fin], w[~fin])
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g[fin], w[fin], rtol=RTOL16[dtype],
                                   atol=RTOL16[dtype])


def _np_operands16(seed, sr_name, integer, block, run_caps):
    """float32 numpy operands (an unsorted block, canonical runs) whose
    values are exact in 16 bits when ``integer``: at most 100 in
    magnitude, few duplicates, so every partial sum stays below 256."""
    rng = np.random.default_rng(seed)
    dt = np.int32 if integer else np.float32
    b = _np_block(rng, block, 40, dt)
    maker_sr = "max.plus" if sr_name == "max.min" else sr_name
    runs = [treg._canonical_segment(rng, c, 40, dt, maker_sr)
            for c in run_caps]
    zero = treg._np_zero(sr_name, np.dtype(np.float32))

    def f32(seg):
        hi, lo, v = seg
        v = np.where(hi == tref.SENTINEL, zero, v.astype(np.float32))
        return hi, lo, v.astype(np.float32)
    return f32(b), [f32(r) for r in runs]


@pytest.mark.parametrize("sr_name", ["plus.times", "max.plus", "min.plus",
                                     "max.min"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["merge_multi", "merge"])
def test_plain_16bit_matches_pallas_interpret(kind, dtype, sr_name):
    """The plain versions carry float16 and bfloat16 values, combining in
    the value dtype as the Pallas kernels do (interpret mode, the same
    operands): integer-valued payloads exactly, normal ones within the
    dtype's rtol; the result keeps the operands' dtype."""
    from repro.kernels.hier_merge import hier_merge as jhm
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for integer in (True, False):
        if kind == "merge_multi":
            b, runs = _np_operands16(3, sr_name, integer, 32, (96,))
            srcs = [b] + runs
        else:
            _, srcs = _np_operands16(4, sr_name, integer, 0, (48, 80))
        jops_ = [tuple(jnp.asarray(x) for x in s[:2]) +
                 (jnp.asarray(s[2]).astype(jdt),) for s in srcs]
        tops_ = [tuple(torch.from_numpy(x) for x in s[:2]) +
                 (torch.from_numpy(s[2]).to(tdt),) for s in srcs]
        if kind == "merge_multi":
            want = jhm.merge_multi_pallas(jops_[0], jops_[1:],
                                          sr_name=sr_name, interpret=True)
            got = thm.merge_multi_plain(tops_[0], tops_[1:], sr_name=sr_name)
        else:
            want = jhm.merge_pallas(*jops_[0], *jops_[1], sr_name=sr_name,
                                    interpret=True)
            got = thm.merge_plain(*tops_[0], *tops_[1], sr_name=sr_name)
        _assert_out16(got, want, dtype, integer)
        assert int(got[3][0]) > 0


@pytest.mark.parametrize("vdtype", [torch.float16, torch.bfloat16,
                                    torch.float32, torch.int32])
def test_cuda_operand_check_takes_16bit_values(vdtype):
    """The CUDA route's operand check takes float16 and bfloat16 values
    (the kernels carry them) as it takes float32 and int32, and still
    refuses float64 and mixed value types, before anything is built."""
    def op(n, dt):
        return tuple(torch.empty(n, dtype=t, device="meta")
                     for t in (torch.int32, torch.int32, dt))

    srcs = [op(40, vdtype), op(24, vdtype)]
    assert thm._check_operands(srcs, "merge_multi_cuda", True) == 64
    assert thm._check_operands(srcs, "merge_cuda", False) == 64
    thm._BOUND.pop("lib", None)
    for bad in ([op(40, torch.float64), op(24, torch.float64)],
                [op(40, vdtype), op(24, torch.float64
                                    if vdtype != torch.float64 else
                                    torch.float32)]):
        with pytest.raises((TypeError, ValueError)):
            thm._launch("merge_multi_cuda", "hier_merge.merge_multi", bad,
                        True, "plus.times")
    assert "lib" not in thm._BOUND
