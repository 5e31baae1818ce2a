"""What the benchmark imports: never JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is not ``repro``); the
reference, the judge and the arithmetic nothing of the program; and no
module reads the ``benchmarks/`` folder."""
import ast
import subprocess
import sys

import pytest

from port_bench import spec

FILES = sorted(spec.BENCH_DIR.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = ("reference.py", "judge.py", "arith.py", "gen.py", "spec.py",
             "tracing.py")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(spec.BENCH_DIR))
                              for p in FILES])
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN
    if path.name != "test_port_bench_imports.py":
        assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(name):
    assert "repro_torch" not in top_level_imports(spec.BENCH_DIR / name)


def test_reference_loads_alone():
    code = ("import sys; import port_bench.reference, port_bench.judge; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}; print(sorted(bad))")
    done = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"
