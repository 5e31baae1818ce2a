"""Import audit of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package, and the entry points refuse
to run on the CPU unless asked — with no CUDA device they raise."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = [m for m in _imported_roots(f) if m in FORBIDDEN]
        assert not bad, (f, bad)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import assoc, distributed, hier
    from repro_torch.launch import ingest
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hier.create((64, 256), 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.create_instances(2, (64, 256), 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assoc.empty(8)
    d = hier.state_to_numpy(hier.create((64, 256), 32, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hier.state_from_numpy(d)
    args = ingest.parser().parse_args(["--instances", "2", "--blocks", "2",
                                       "--rounds", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.run(args)
    np.testing.assert_array_equal(
        hier.state_from_numpy(d, device="cpu").spills.numpy(), d["spills"])


def test_query_service_entry_points_raise_without_cuda(monkeypatch):
    """``launch/query.py`` defaults to cuda and raises without it, like
    ``launch/ingest.py``; the service, engine and analytics modules (and
    obs) import without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import obs  # noqa: F401
    from repro_torch.launch import query
    from repro_torch.query import analytics, engine, service  # noqa: F401
    args = query.parser().parse_args(["--instances", "2", "--blocks", "4",
                                      "--rounds", "2"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.run(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query.run_with_states(args)
    for name in ("query/analytics.py", "query/service.py", "launch/query.py",
                 "obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                 "obs/slo.py"):
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)


def test_model_and_data_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import registry
    from repro_torch.data import graphs, synthetic
    from repro_torch.models import dcn, gnn
    dcn_cfg = registry.get_smoke_config("dcn-v2")
    gnn_cfg = registry.get_smoke_config("gin-tu")
    for call in (lambda: dcn.init(0, dcn_cfg),
                 lambda: gnn.init(0, gnn_cfg, 4, 2),
                 lambda: graphs.random_graph(0, 16, 32, 4),
                 lambda: graphs.batched_molecules(0, 2, 4, 6, 3),
                 lambda: synthetic.recsys_batch(0, 4),
                 lambda: synthetic.retrieval_batch(0, 1, 8, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    tree = dcn.params_to_numpy(dcn.init(0, dcn_cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn.params_from_numpy(tree, dcn_cfg)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_fault_tolerance_modules_import_no_jax(monkeypatch, tmp_path):
    """The checkpoint, contracts and runtime modules import neither JAX nor
    anything of the JAX package (each file, and in a fresh process);
    restoring onto the card, and resuming the ingest CLI, raise without
    one."""
    names = ("analysis/__init__.py", "analysis/contracts.py",
             "checkpoint/__init__.py", "checkpoint/ckpt.py",
             "runtime/__init__.py", "runtime/elastic.py",
             "runtime/straggler.py")
    for name in names:
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "import repro_torch.analysis.contracts, repro_torch.checkpoint\n"
            "import repro_torch.runtime\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    from repro_torch.checkpoint import restore, save
    from repro_torch.core import distributed
    from repro_torch.launch import ingest
    fleet = distributed.create_instances(2, (64, 256), 32, device="cpu")
    save(str(tmp_path), 1, fleet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(str(tmp_path), 1, fleet, device="cuda")
    args = ingest.parser().parse_args(["--instances", "2", "--blocks", "2",
                                       "--rounds", "1", "--ckpt-dir",
                                       str(tmp_path), "--resume"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingest.run(args)
    assert restore(str(tmp_path), 1, fleet, device="cpu").device.type \
        == "cpu"


def test_training_modules_import_no_jax_and_default_to_cuda(monkeypatch):
    """The training slice (optim, vassoc, the train driver) imports neither
    JAX nor anything of the JAX package; its entry points default to cuda
    and raise without it."""
    for name in ("optim/__init__.py", "optim/adamw.py",
                 "optim/sparse_update.py", "core/vassoc.py",
                 "launch/train.py", "models/common.py", "models/dcn.py",
                 "models/gnn.py", "data/graphs.py"):
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "import repro_torch.optim, repro_torch.optim.sparse_update\n"
            "import repro_torch.core.vassoc, repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import dcn
    assert train.parser().parse_args([]).device == "cuda"
    assert train.make_args().device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(train.make_args(arch="dcn-v2"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn.hier_embed_init(registry.get_smoke_config("dcn-v2"), 4)


def test_fleet_modules_import_no_jax(monkeypatch, tmp_path):
    """The fleet-across-ranks layer (``launch/mesh.py``,
    ``core/distributed.py``) imports neither JAX nor anything of the JAX
    package (each file, and in a fresh process); a fleet's ranks default
    to the card and raise without one, and nccl refuses more ranks than
    cards before it starts any."""
    for name in ("launch/mesh.py", "core/distributed.py", "stages.py"):
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "import repro_torch.launch.mesh, repro_torch.core.distributed\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh._rank_device("gloo", None, 0)
    assert mesh._rank_device("gloo", "cpu", 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl runs one rank per card"):
        mesh.spawn_fleet(print, 1, "nccl", None, str(tmp_path))
    with pytest.raises(ValueError, match="nccl runs on CUDA devices"):
        mesh._rank_device("nccl", "cpu", 0)


def test_lm_modules_import_no_jax_and_default_to_cuda(monkeypatch):
    """The LM serving slice (configs, attention, MoE, transformer, token
    data, ``launch/serve.py``) imports neither JAX nor anything of the JAX
    package (each file, and in a fresh process); its entry points default
    to cuda and raise without it."""
    names = ["models/attention.py", "models/moe.py", "models/transformer.py",
             "models/common.py", "data/synthetic.py", "launch/serve.py",
             "configs/base.py", "configs/registry.py"]
    names += [f"configs/{m}.py" for m in (
        "smollm_360m", "granite_moe_3b_a800m", "deepseek_v2_236b",
        "mistral_nemo_12b", "phi3_mini_3_8b")]
    for name in names:
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "import repro_torch.models.transformer, repro_torch.launch.serve\n"
            "from repro_torch.configs import registry\n"
            "for a in registry.list_archs('lm'): registry.get_config(a)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = registry.get_smoke_config("smollm-360m")
    assert serve.parser().parse_args([]).device == "cuda"
    assert serve.make_args().device == "cuda"
    tree = transformer.params_to_numpy(transformer.init(0, cfg,
                                                        device="cpu"))
    for call in (lambda: transformer.init(0, cfg),
                 lambda: transformer.init_cache(cfg, 2, 8),
                 lambda: transformer.params_from_numpy(tree),
                 lambda: synthetic.token_batch(0, 2, 8, cfg.vocab),
                 lambda: serve.run(serve.make_args(smoke=True))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_lm_training_modules_import_no_jax_and_default_to_cuda(monkeypatch):
    """The LM training slice (``cross_entropy``, ``loss_fn`` and
    ``make_train_step``, gradient compression, the prefetching stream, the
    trainer's lm family) imports neither JAX nor anything of the JAX
    package (each file, and in a fresh process); the trainer defaults to
    cuda and raises without it, for every LM arch and with
    ``--compress``."""
    for name in ("optim/compression.py", "data/pipeline.py",
                 "models/transformer.py", "models/common.py",
                 "launch/train.py", "optim/adamw.py"):
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "import repro_torch.optim.compression, repro_torch.data.pipeline\n"
            "import repro_torch.launch.train, repro_torch.models.transformer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs import registry
    from repro_torch.launch import train
    for arch in registry.list_archs("lm"):
        for compress in ("", "int8", "topk"):
            args = train.make_args(arch=arch, compress=compress)
            assert args.device == "cuda"
            with pytest.raises(RuntimeError, match="no CUDA device"):
                train.run(args)


def test_stages_front_door_imports_no_jax(monkeypatch):
    """The ``stages`` front door and what hangs from it (the kernel build
    directory, the dispatch spans and gauges, the wrapped entries of the
    core, query and launch modules) import neither JAX nor anything of the
    JAX package (each file, and in a fresh process that also builds a
    fleet's job list); a captured entry's launchers default to cuda and
    raise without it."""
    for name in ("stages.py", "kernels/build.py", "kernels/registry.py",
                 "obs/trace.py", "obs/metrics.py", "analysis/contracts.py",
                 "core/hier.py", "core/stream.py", "query/engine.py",
                 "query/service.py", "launch/ingest.py", "launch/query.py",
                 "launch/serve.py", "launch/train.py"):
        bad = [m for m in _imported_roots(PORT / name) if m in FORBIDDEN]
        assert not bad, (name, bad)
    code = ("import sys\n"
            "from repro_torch import stages\n"
            "from repro_torch.configs import d4m_stream\n"
            "jobs = stages.fleet_jobs(d4m_stream.smoke_config(), "
            "device='cpu')\n"
            "assert jobs and stages.kernel_jobs()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import stages
    from repro_torch.configs import d4m_stream
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stages.fleet_jobs(d4m_stream.smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(serve.make_args(arch="smollm-360m", smoke=True))
