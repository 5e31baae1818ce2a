"""reprolint for the port (``repro_torch.analysis.lint``): every rule fires
exactly once on its seeded fixture and stays quiet on the good twin, the
suppression and baseline mechanics behave as the reference's
(``tests/test_reprolint.py``), the shared machinery (``baseline``, the
allow regex) gives the reference's outputs on identical inputs, the port's
tree lints clean against the EMPTY committed baseline, and the CLI exits 0
clean and 1 on each seeded rule."""
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import baseline as jbaseline
from repro.analysis import lint as jlint
from repro_torch.analysis import baseline, lint

PORT = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))


def violations(src, rule=None, path="repro_torch/fake/mod.py", **kw):
    out = lint.lint_source(textwrap.dedent(src), path, **kw)
    if rule is not None:
        out = [v for v in out if v.rule == rule]
    return out


# One seeded violation per rule: (rule, source, path).
SEEDED = {
    "R001": ("""
        import torch
        step = torch.compile(lambda x: x + 1)
        """, "repro_torch/core/mod.py"),
    "R002": ("""
        import torch

        def pick(x):
            if torch.any(x > 0):
                return x
            return -x

        run = torch.vmap(pick)
        """, "repro_torch/core/mod.py"),
    "R003": ("""
        from repro_torch import stages
        step = stages.wrap(body, "entry", sig, donate_argnums=(0,))

        def drive(state, batch):
            out = step(state, batch)
            return out, state
        """, "repro_torch/core/mod.py"),
    "R004": ("""
        from repro_torch import stages

        def body(x):
            return x * x.item()

        out = stages.wrap(body, "entry", None, kind="graph")
        """, "repro_torch/core/mod.py"),
    "R005": ("""
        import torch

        def total(seg):
            return torch.sum(seg.val)
        """, "repro_torch/core/mod.py"),
    "R006": ("""
        from repro_torch.kernels import build
        SOURCE = "rogue/csrc/rogue.cu"

        def lib():
            return build.load(SOURCE)
        """, "repro_torch/kernels/rogue/rogue.py"),
}


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_each_seeded_rule_fires_exactly_once(rule):
    src, path = SEEDED[rule]
    vs = violations(src, path=path)
    assert [v.rule for v in vs] == [rule], [v.render() for v in vs]


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_cli_exits_1_on_each_seeded_rule(rule, tmp_path):
    src, path = SEEDED[rule]
    f = tmp_path / "repro_torch" / path.split("/", 1)[1]
    f.parent.mkdir(parents=True)
    f.write_text(textwrap.dedent(src))
    assert lint.main([str(f), "--baseline", str(tmp_path / "b.txt"),
                      "-q"]) == 1


# ------------------------------------------------------------------- R001 --


@pytest.mark.parametrize("src", [
    "import torch\ng = torch.cuda.CUDAGraph()\n",
    "import torch\nwith torch.cuda.graph(g):\n    pass\n",
    "import torch\nf = torch.jit.script(fn)\n",
    "import torch\nf = torch.jit.trace(fn, x)\n",
    "from torch import compile\nf = compile(fn)\n",
    "from torch.cuda import graph as cg\nwith cg(g):\n    pass\n",
    "import torch\n@torch.compile\ndef f(x):\n    return x\n",
])
def test_r001_every_capture_spelling_fires(src):
    vs = violations(src, "R001")
    assert len(vs) == 1 and "stages.wrap" in vs[0].message


def test_r001_good_twin_quiet_and_stages_exempt():
    assert violations("""
        from repro_torch import stages
        step = stages.wrap(lambda x: x + 1, "entry", None, kind="graph")
        """, "R001") == []
    assert violations("import torch\ng = torch.cuda.CUDAGraph()\n",
                      "R001", path="repro_torch/stages.py") == []


# ------------------------------------------------------------------- R002 --


def test_r002_torch_cond_and_gate():
    assert len(violations("""
        import torch

        def pick(p, x):
            return torch.cond(p, lambda v: v, lambda v: -v, (x,))

        run = torch.func.vmap(pick)
        """, "R002")) == 1
    assert violations("""
        import torch

        def pick(x, batch_mode="switch"):
            if torch.any(x > 0):
                return x
            return -x

        run = torch.vmap(pick)
        """, "R002") == []
    assert violations("""
        import torch

        def pick(x):
            if torch.any(x > 0):
                return x
            return -x
        """, "R002") == []


# ------------------------------------------------------------------- R003 --


def test_r003_rebound_quiet():
    assert violations("""
        from repro_torch import stages
        step = stages.wrap(body, "entry", sig, donate_argnums=(0,))

        def drive(state, batch):
            state = step(state, batch)
            return state
        """, "R003") == []


# ------------------------------------------------------------------- R004 --


@pytest.mark.parametrize("expr", ["x.tolist()", "x.cpu()", "x.numpy()",
                                  "int(x)", "bool(x)", "print(x)"])
def test_r004_host_escapes_in_a_graph_entry(expr):
    vs = violations(f"""
        from repro_torch import stages

        def body(x):
            return {expr}

        out = stages.wrap(body, "entry", None, kind="graph")
        """, "R004")
    assert len(vs) == 1


def test_r004_exemptions():
    # static metadata, an eager entry, host code, a maker's knob
    assert violations("""
        from repro_torch import stages

        def make(k):
            def body(x):
                return x.reshape(int(x.shape[0]), int(k))
            return stages.wrap(body, "entry", None, kind="graph")

        def eager(x):
            return x.item()

        e = stages.wrap(eager, "entry2", None)
        """, "R004") == []


# ------------------------------------------------------------------- R005 --


def test_r005_variants():
    assert len(violations("""
        def total(seg):
            x = seg.val * 2
            return x.sum()
        """, "R005")) == 1
    assert len(violations("""
        def scatter(out, seg, ids):
            return out.index_add_(0, ids, seg.val)
        """, "R005")) == 1
    assert violations("""
        import torch

        def total(seg, sorted=True):
            return torch.sum(seg.val)
        """, "R005") == []
    assert violations("""
        import torch

        def total(seg):
            live = torch.arange(seg.val.shape[0]) < seg.nnz
            return torch.sum(torch.where(live, seg.val, 0))
        """, "R005") == []


# ------------------------------------------------------------------- R006 --


def test_r006_registry_and_loaders():
    files = lint.audited_kernel_files()
    assert files == {"hier_merge/csrc/hier_merge.cu",
                     "embedding_bag/csrc/embedding_bag.cu",
                     "segment_agg/csrc/segment_agg.cu"}
    # the registered sources and the registry's own loader are quiet
    assert violations("""
        from repro_torch.kernels import build
        SOURCE = "hier_merge/csrc/hier_merge.cu"
        lib = build.load(SOURCE)
        """, "R006", path="repro_torch/kernels/hier_merge/hier_merge.py") \
        == []
    assert violations("import ctypes\nlib = ctypes.CDLL(path)\n", "R006",
                      path="repro_torch/kernels/build.py") == []
    # a library or Triton kernel anywhere else fires
    assert len(violations("import ctypes\nlib = ctypes.CDLL(path)\n",
                          "R006")) == 1
    assert len(violations("""
        import triton

        @triton.jit
        def k(x_ptr):
            pass
        """, "R006", path="repro_torch/kernels/fused/fused.py")) == 1
    assert len(violations("""
        from torch.utils import cpp_extension
        ext = cpp_extension.load(name="x", sources=["x.cu"])
        """, "R006")) == 1


# ------------------------------------------------------------ suppression --

_BAD = "import torch\nstep = torch.compile(fn)"


def test_allow_comments():
    on_line = _BAD + "  # reprolint: allow(R001) reasoned\n"
    assert violations(on_line, "R001") == []
    assert len(violations(on_line, "R001", with_suppressed=True)) == 1
    above = "import torch\n# reprolint: allow(R001) wrapped\n" \
            "step = torch.compile(fn)\n"
    assert violations(above, "R001") == []
    too_far = "import torch\n# reprolint: allow(R001) far\n#\n" \
              "step = torch.compile(fn)\n"
    assert len(violations(too_far, "R001")) == 1
    bare = _BAD + "  # reprolint: allow(R001)\n"
    assert len(violations(bare, "R001")) == 1
    wrong = _BAD + "  # reprolint: allow(R002) nope\n"
    assert len(violations(wrong, "R001")) == 1


@pytest.mark.parametrize("line", [
    "x = 1  # reprolint: allow(R001) legacy path",
    "x = 1  # reprolint: allow(R001, R004) two rules",
    "# reprolint:allow(R005)",
    "x = 1  # reprolint: allow(R00x) <reason>",
    "x = 1  # tracekit: allow(J004) entry=a.b reason",
    "no comment here",
])
def test_allow_regex_matches_the_reference(line):
    a, b = lint._ALLOW_RE.search(line), jlint._ALLOW_RE.search(line)
    assert (a and a.groups()) == (b and b.groups())


# --------------------------------------------------------------- baseline --


def test_baseline_roundtrip_line_free_and_counted(tmp_path):
    vs = violations(_BAD)
    path = str(tmp_path / "base.txt")
    lint.write_baseline(path, vs)
    base = lint.load_baseline(path)
    assert lint.new_violations(vs, base) == []
    assert lint.new_violations(vs + vs, base) == vs
    a = violations("import torch\nstep = torch.compile(fn)")
    b = violations("import torch\n\n\nstep = torch.compile(fn)")
    assert [v.key for v in a] == [v.key for v in b]


def test_baseline_machinery_matches_the_reference(tmp_path):
    vs = violations(SEEDED["R001"][0]) + violations(SEEDED["R005"][0]) * 2
    port, ref = tmp_path / "port.txt", tmp_path / "ref.txt"
    baseline.write_baseline(str(port), vs, "# h\n")
    jbaseline.write_baseline(str(ref), vs, "# h\n")
    assert port.read_text() == ref.read_text()
    base = baseline.load_baseline(str(port))
    assert base == jbaseline.load_baseline(str(ref))
    more = vs + violations(SEEDED["R004"][0])
    assert baseline.new_violations(more, base) == \
        jbaseline.new_violations(more, base)
    assert baseline.per_rule_counts(more, lint.RULES) == \
        jbaseline.per_rule_counts(more, lint.RULES)


def test_committed_baseline_is_empty():
    assert sum(lint.load_baseline(lint.DEFAULT_BASELINE).values()) == 0


# -------------------------------------------------------------------- CLI --


def test_cli_exit_codes(tmp_path, capsys):
    f = tmp_path / "mod.py"
    f.write_text(_BAD + "\n")
    base = str(tmp_path / "base.txt")
    assert lint.main([str(f), "--baseline", base, "-q"]) == 1
    assert lint.main([str(f), "--baseline", base, "--write-baseline"]) == 0
    assert lint.main([str(f), "--baseline", base]) == 0
    assert "reprolint per-rule counts" in capsys.readouterr().out
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert lint.main([str(broken), "--no-baseline", "-q"]) == 1


# -------------------------------------------------------------- the port --


def test_port_is_lint_clean():
    """src/repro_torch stays clean against the EMPTY committed baseline: a
    new violation fails tier-1."""
    vs = lint.lint_paths([PORT])
    fresh = lint.new_violations(vs, lint.load_baseline(lint.DEFAULT_BASELINE))
    assert fresh == [], "\n".join(v.render() for v in fresh)
    assert lint.main([PORT, "-q"]) == 0


def test_cli_module_runs_clean_on_the_port():
    env = dict(os.environ, PYTHONPATH=os.path.dirname(PORT))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                          PORT, "--check", "-q"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout
