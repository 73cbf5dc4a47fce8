"""Guards of the port's boundaries, on the CPU.

- ``repro_torch`` (every module), ``chip_smoke.py`` and
  ``examples/quickstart_torch.py`` import neither ``jax`` nor anything of
  ``repro``, at import time or in their sources; nor do the transformer
  zoo's SPMD modules and the dry run, imported and run alone, nor the
  GNN example twins (``serve_gnn_torch.py``, ``heterogeneous_rapa_torch.py``),
  which default to the card;
- the kernel dispatch goes by tensor device: CPU tensors take the plain
  versions and launch nothing, the kernel wrappers refuse CPU tensors;
- a CUDA request on a machine without CUDA raises instead of falling back
  to the CPU (``launch.serve``, ``launch.train``, ``launch.mesh``), and so
  does ``chip_smoke.py``; ``launch.mesh.spawn`` refuses NCCL, before any
  process starts, with fewer cards than ranks;
- the ``lm`` subcommands run on the card by default and raise without
  CUDA unless given ``--device cpu``; the flags this port has taken over
  from the JAX package's CLIs run on the CPU and print the JAX package's
  keys (``--strategy spmm_15d``, ``--trace``, ``--faults``, the guard's
  knobs, ``--ckpt-dir`` / ``--resume``, ``--store-dir`` /
  ``--load-store``).
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import cache_gather, csr_spmm, ell_spmm, ops
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import train as ttrain
from repro_torch.models.gnn import GNNConfig, init_gnn
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _run(code: str, cwd=ROOT, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})


def test_import_pulls_in_neither_jax_nor_repro():
    res = _run(
        "import importlib, pkgutil, sys\n"
        "sys.path.insert(0, '.')\n"
        "import repro_torch, repro_torch.launch.serve, chip_smoke\n"
        "import repro_torch.launch.train\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith('jax.') or n == 'repro' or\n"
        "             n.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "print('N', sum(n.startswith('repro_torch.') for n in sys.modules))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n_mods = int(res.stdout.split("N ")[1])
    assert n_mods >= 30, f"only {n_mods} repro_torch modules imported"


def test_sources_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(list((ROOT / "examples").glob("*_torch.py"))) >= 6
    assert len(files) > 30
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert offenders == []


def test_spmd_slice_modules_import_neither_jax_nor_repro():
    res = _run(
        "import importlib.util, sys\n"
        "import repro_torch.dist.capgnn_spmd, repro_torch.dist.collectives\n"
        "import repro_torch.launch.mesh, repro_torch.core.halo\n"
        "import repro_torch.dist.strategy_15d, repro_torch.launch.train\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'quickstart_torch', 'examples/quickstart_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('BAD', sorted(n for n in sys.modules if n == 'jax' or\n"
        "      n.startswith('jax.') or n == 'repro' or\n"
        "      n.startswith('repro.')))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_gnn_example_twins_import_neither_jax_nor_repro():
    """The serving walkthrough's and the heterogeneous-group demo's twins
    imported alone, and their ``main`` refusing the card it defaults to
    when there is none."""
    res = _run(
        "import importlib.util, inspect, sys, torch\n"
        "for name in ('serve_gnn_torch', 'heterogeneous_rapa_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    dev = inspect.signature(mod.main).parameters['device'].default\n"
        "    assert dev == 'cuda', (name, dev)\n"
        "    if not torch.cuda.is_available():\n"
        "        try:\n"
        "            mod.main()\n"
        "        except RuntimeError:\n"
        "            pass\n"
        "        else:\n"
        "            raise AssertionError(name + ' ran without CUDA')\n"
        "print('BAD', sorted(n for n in sys.modules if n == 'jax' or\n"
        "      n.startswith('jax.') or n == 'repro' or\n"
        "      n.startswith('repro.')))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_lm_slice_modules_import_neither_jax_nor_repro():
    """The transformer zoo, its configs, the token stream, both ``lm``
    CLIs and the two LM example twins, imported alone."""
    res = _run(
        "import importlib.util, sys\n"
        "import repro_torch.models.transformer, repro_torch.configs\n"
        "import repro_torch.data.token_stream, repro_torch.nn.layers\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "[get_config(a) for a in ARCH_IDS]\n"
        "for name in ('serve_transformer_torch', 'train_lm_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('BAD', sorted(n for n in sys.modules if n == 'jax' or\n"
        "      n.startswith('jax.') or n == 'repro' or\n"
        "      n.startswith('repro.')))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_spmd_lm_modules_import_neither_jax_nor_repro():
    """The transformer zoo's SPMD half imported alone: the context, the
    sharding rules, the dry run and its cost roll-up, the staged backend,
    the production meshes, and the dry run's example twin; the dry run
    runs once on a fake group without either."""
    res = _run(
        "import importlib.util, sys\n"
        "import repro_torch.models.transformer.spmd\n"
        "import repro_torch.launch.sharding, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.hlo_cost, repro_torch.launch.mesh\n"
        "import repro_torch.dist.staged\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'multipod_dryrun_torch', 'examples/multipod_dryrun_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "from repro_torch.launch.dryrun import run_one\n"
        "run_one('qwen3-1.7b', 'decode_32k', device='cpu')\n"
        "print('BAD', sorted(n for n in sys.modules if n == 'jax' or\n"
        "      n.startswith('jax.') or n == 'repro' or\n"
        "      n.startswith('repro.')))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


@pytest.mark.parametrize("cards,ranks", [(0, 2), (1, 2), (3, 4)])
def test_nccl_spawn_refuses_fewer_cards_than_ranks(monkeypatch, cards,
                                                   ranks):
    """NCCL needs one card per rank: with fewer, ``spawn`` raises before
    any process starts or any group is initialised."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    started = []
    monkeypatch.setattr(mesh.mp, "spawn", lambda *a, **k: started.append(a))
    with pytest.raises(ValueError, match="one card per rank"):
        mesh.spawn(print, ranks, backend="nccl", devices="cuda")
    assert started == [] and not dist.is_initialized()


def test_rank_devices_refuse_what_a_backend_cannot_run(monkeypatch):
    from repro_torch.launch.mesh import rank_devices
    assert rank_devices(3, "gloo", "cpu") == ["cpu"] * 3
    with pytest.raises(ValueError, match="unknown backend"):
        rank_devices(2, "mpi", "cpu")
    with pytest.raises(ValueError, match="2 devices for 3 ranks"):
        rank_devices(3, "gloo", ["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_devices(2, "gloo", "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_devices(4, "nccl", "cuda") == [f"cuda:{i}" for i in range(4)]
    assert rank_devices(4, "gloo", ["cuda:0"] * 4) == ["cuda:0"] * 4
    with pytest.raises(ValueError, match="one card per rank"):
        rank_devices(2, "nccl", ["cuda:1", "cuda:1"])
    with pytest.raises(ValueError, match="CUDA devices only"):
        rank_devices(2, "nccl", ["cpu", "cuda:0"])


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.kernels import ops", "import repro",
                 "    from repro.dist import y"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.kernels import ops",
                 "from .ops import x", "import jaxtyping"):
        assert not FORBIDDEN.search(line), line


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    counters = (ell_spmm.ell_spmm, ell_spmm.ell_spmm_chunked,
                csr_spmm.csr_spmm, csr_spmm.csr_spmm_accumulate,
                ell_spmm.ell_spmm_dvals, cache_gather.gather_rows)
    for fn in counters:
        fn.launches = 0
    rng = np.random.default_rng(0)
    cols = torch.from_numpy(rng.integers(0, 30, (2, 20, 4)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(2, 20, 4)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(2, 30, 8)).astype(np.float32))
    tail = (torch.tensor([[1, 2], [3, 0]]), torch.tensor([[0, 20], [5, 20]]),
            torch.tensor([[1.0, 0.0], [2.0, 0.0]]))
    assert ops.ell_spmm(cols, vals, h).shape == (2, 20, 8)
    assert ops.hybrid_spmm(cols, vals, *tail, h).shape == (2, 20, 8)
    assert ops.gather_rows(h[0], torch.tensor([3, 1])).shape == (2, 8)
    x = h.clone().requires_grad_(True)
    v = vals.clone().requires_grad_(True)
    ops.ell_spmm(cols, v, x, col_chunk=10).sum().backward()
    assert x.grad.shape == h.shape and v.grad.shape == vals.shape
    x.grad = None
    ops.hybrid_spmm(cols, vals, *tail, x).sum().backward()
    assert x.grad.shape == h.shape
    assert [fn.launches for fn in counters] == [0] * len(counters)


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the wrapper of a CUDA kernel raises on a CPU tensor."""
    cols = torch.zeros((1, 4, 2), dtype=torch.int32)
    vals = torch.zeros((1, 4, 2))
    h = torch.zeros((1, 6, 3))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ell_spmm.ell_spmm(cols, vals, h)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        cache_gather.gather_rows(h[0], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ell_spmm.ell_spmm_chunked(cols, vals, h, 3)
    pack = ops.transpose_csr(cols, vals, 6)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        csr_spmm.csr_spmm(pack, torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        csr_spmm.csr_spmm_accumulate(pack, torch.zeros((4, 3)),
                                     torch.zeros((6, 3)))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        ell_spmm.ell_spmm_dvals(cols, torch.zeros((1, 4, 3)), h)
    assert ell_spmm.ell_spmm.launches == 0
    assert csr_spmm.csr_spmm.launches == 0
    assert cache_gather.gather_rows.launches == 0


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.resolve_device("cuda")
    assert tlaunch.resolve_device("cpu") == torch.device("cpu")
    # the CLIs' default device is cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["gnn", "--scale", "0.01", "--queries", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["gnn", "--scale", "0.01", "--epochs", "1"])


def test_train_import_pulls_in_neither_jax_nor_repro():
    res = _run("import sys\n"
               "import repro_torch.launch.train\n"
               "print('BAD', sorted(n for n in sys.modules if n == 'jax' or\n"
               "      n.startswith('jax.') or n == 'repro' or\n"
               "      n.startswith('repro.')))\n")
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


@pytest.mark.parametrize("module", ["profile_serve", "profile_train"])
def test_profiler_refuses_the_cpu(module):
    import importlib
    prof = importlib.import_module(f"repro_torch.launch.{module}")
    with pytest.raises(SystemExit, match="--device cuda"):
        prof.main(["gnn", "--device", "cpu"])


_TINY = ["--device", "cpu", "--scale", "0.005", "--feat-dim", "8",
         "--hidden", "8"]


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ck"], ["--store-dir", "st"],
                                  ["--load-store"], ["--trace"]])
def test_unported_cli_flags_exit(flag, tmp_path, monkeypatch, capsys):
    """The serving CLI's checkpoint, store and trace flags (refused until
    they were ported) run on the CPU: ``--ckpt-dir`` loads the parameters
    ``launch.train --ckpt-dir`` saved, ``--store-dir`` saves the store
    that ``--load-store`` loads (with ``--store-dir``; alone it exits as
    the JAX package's does), ``--trace`` prints ``trace_file`` and
    ``metrics_file``."""
    from repro_torch.checkpoint import latest_step
    monkeypatch.chdir(tmp_path)
    argv = ["gnn", *_TINY, "--queries", "16"]
    if flag[0] == "--ckpt-dir":
        ttrain.main(["gnn", *_TINY, "--epochs", "1", "--ckpt-dir", "ck"])
        assert latest_step("ck") == 1
    if flag == ["--load-store"]:
        with pytest.raises(SystemExit, match="requires --store-dir"):
            tlaunch.main(argv + flag)
        tlaunch.main(argv + ["--store-dir", "st"])
        flag = flag + ["--store-dir", "st"]
    capsys.readouterr()
    out = tlaunch.main(argv + flag)
    assert json.loads(capsys.readouterr().out) == out
    assert np.isfinite(out["p50_ms"]) and out["queries"] == 16
    if flag[0] == "--store-dir":
        assert sorted(os.listdir("st")) == ["ckpt_00000000.json",
                                            "ckpt_00000000.npz",
                                            "store_meta.json"]
    if flag == ["--trace"]:
        assert os.path.isfile(out["trace_file"])
        assert os.path.isfile(out["metrics_file"])


@pytest.mark.parametrize("flag", [
    ["--strategy", "spmm_15d"], ["--trace"], ["--device-trace-dir", "dt"],
    ["--faults", "grad_nan@3"], ["--guard-every", "2"], ["--checksums"],
    ["--fetch-retries", "1"], ["--ckpt-dir", "ck"], ["--resume"]])
def test_unported_train_flags_exit(flag, tmp_path, monkeypatch, capsys):
    """Every flag of the JAX package's CLI that the port once refused runs
    on the CPU and prints its JAX key: ``--strategy spmm_15d`` (a tiny
    training on 4 gloo ranks) ``block_rows`` / ``group_size`` /
    ``fwd_collective_bytes_per_device``, the fault flags ``faults`` /
    ``faults_injected`` / ``fault_events`` (the guard's knobs alone
    ``fault_events``), ``--trace`` ``phase_stats`` / ``trace_file`` /
    ``metrics_file``; ``--ckpt-dir`` saves a checkpoint and ``--resume``
    with none starts at ``resumed_from`` 0."""
    if flag[0] == "--strategy":
        out = ttrain.main(["gnn", *_TINY, "--epochs", "2", *flag,
                           "--parts", "4", "--replication", "2"])
        assert json.loads(capsys.readouterr().out) == out
        assert {"block_rows", "group_size", "comm_reduction_vs_vanilla",
                "fwd_collective_bytes_per_device"} <= set(out)
        assert (out["strategy"], out["block_rows"], out["group_size"]) == \
            ("spmm_15d", 2, 1)
        assert out["fwd_collective_bytes_per_device"] > 0
        assert np.isfinite(out["final_loss"]) and out["refresh_steps"] == 2
        return
    monkeypatch.chdir(tmp_path)
    out = ttrain.main(["gnn", *_TINY, "--epochs", "2", *flag])
    assert json.loads(capsys.readouterr().out) == out
    assert np.isfinite(out["final_loss"]) and out["resumed_from"] == 0
    keys = {"--trace": ("phase_stats", "trace_file", "metrics_file"),
            "--device-trace-dir": ("device_trace_file",),
            "--faults": ("faults", "faults_injected", "fault_events")}.get(
        flag[0], ("fault_events",) if flag[0] in (
            "--guard-every", "--checksums", "--fetch-retries") else ())
    assert set(keys) <= set(out)
    if flag[0] == "--faults":
        assert out["faults"] == "grad_nan@3"
        assert out["faults_injected"]["grad_nan"] == 0   # 2 epochs: 0, 1
    if flag[0] == "--ckpt-dir":
        from repro_torch.checkpoint import latest_step
        assert latest_step("ck") == 2


def _reference_layout(cfg) -> list:
    """The JAX package's ``init_gnn`` of ``cfg``: per layer its parameter
    names and shapes."""
    import jax
    from repro.models.gnn import GNNConfig as JConfig, init_gnn as jinit
    jp = jinit(jax.random.PRNGKey(0), JConfig(**{
        f: getattr(cfg, f) for f in ("model", "in_dim", "hidden_dim",
                                     "out_dim", "num_layers", "num_heads")}))
    return [{k: tuple(v.shape) for k, v in layer.items()} for layer in jp]


@pytest.mark.parametrize("model", ["sage", "gat", "gin"])
def test_train_cli_runs_model(model):
    """The training CLI trains every model the JAX package does: finite
    losses, and the parameters it trained laid out as the JAX package's
    ``init_gnn`` lays them out."""
    args = ttrain.build_parser().parse_args(
        ["gnn", "--device", "cpu", "--model", model, "--scale", "0.01",
         "--feat-dim", "8", "--hidden", "8", "--epochs", "2"])
    out, ctx = ttrain.train_gnn(args)
    assert out["model"] == model and np.isfinite(out["final_loss"])
    got = [{k: tuple(v.shape) for k, v in layer.items()}
           for layer in ctx["params"]]
    assert got == _reference_layout(ctx["cfg"])


@pytest.mark.parametrize("backend,adj", [("ell", "EllAdj"),
                                         ("hybrid", "HybridAdj")])
def test_gat_refuses_ell_and_hybrid(backend, adj):
    """GAT's edge softmax needs the edge list: the training CLI raises
    naming the backend's adjacency and the ``edges`` fallback, as the
    reference does (``tests/test_backends.py:88-95``)."""
    with pytest.raises(NotImplementedError, match=f"{adj}.*edges"):
        ttrain.main(["gnn", "--device", "cpu", "--model", "gat",
                     "--backend", backend, "--scale", "0.01",
                     "--epochs", "1"])


def test_unported_runtime_options_raise(monkeypatch, capsys):
    """``get_strategy("spmm_15d")`` is the ported strategy, its
    capabilities the JAX package's; an unknown features mode raises.  The
    ``lm`` subcommands are ported: they run on the card by default, raise
    without CUDA, and run with ``--device cpu``."""
    from repro.dist import get_strategy as jget
    from repro_torch.dist import get_strategy, init_caches
    s = get_strategy("spmm_15d")
    assert s.name == "spmm_15d"
    assert vars(s.caps) == vars(jget("spmm_15d").caps)
    with pytest.raises(ValueError, match="features mode"):
        init_caches(GNNConfig(), None, 4, features="disk")
    assert ttrain.build_parser().parse_args(
        ["lm", "--arch", "qwen3-1.7b"]).device == "cuda"
    assert tlaunch.build_parser().parse_args(["lm"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["lm", "--arch", "qwen3-1.7b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["lm", "--steps", "2"])
    out = ttrain.main(["lm", "--arch", "qwen3-1.7b", "--steps", "1",
                       "--batch", "1", "--seq-len", "8", "--device", "cpu"])
    assert np.isfinite(out["loss_first"])
    out = tlaunch.main(["lm", "--steps", "2", "--batch", "1",
                        "--cache-len", "4", "--device", "cpu"])
    assert out["logits_finite"]
    capsys.readouterr()


def test_slice_entry_points_default_to_the_card(monkeypatch):
    """The host store, ``measure_profile`` and the host-features runtime
    run on the card unless the caller asks for the CPU: without CUDA they
    raise instead of falling back."""
    from repro_torch.core import measure_profile
    from repro_torch.dist import HostFeatureStore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HostFeatureStore(np.zeros((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_profile(size=8, repeats=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["gnn", "--scale", "0.01", "--epochs", "1",
                     "--features", "host", "--cache-policy", "lru"])


@pytest.mark.parametrize("model", ["sage", "gat", "gin"])
def test_init_gnn_matches_reference_layout(model):
    """``init_gnn`` gives the JAX package's parameter names and shapes
    (GIN's ``eps`` 0-d, GAT's last layer ``dh = max(1, 3 // 4) = 1``)."""
    cfg = GNNConfig(model=model, in_dim=8, hidden_dim=8, out_dim=3)
    params = init_gnn(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [{k: tuple(v.shape) for k, v in layer.items()}
            for layer in params] == _reference_layout(cfg)
    with pytest.raises(ValueError, match="nope"):
        init_gnn(GNNConfig(model="nope"), torch.Generator(), device="cpu")


def test_chip_smoke_refuses_without_cuda():
    """Without CUDA the smoke run exits non-zero and prints no result."""
    res = _run("import runpy, torch\n"
               "torch.cuda.is_available = lambda: False\n"
               "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "is_available() is False" in res.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds nothing else of the repo, the smoke run
    fails before any result, whatever the machine has."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = _run("import runpy, torch\n"
               "torch.cuda.is_available = lambda: True\n"
               "runpy.run_path('chip_smoke.py', run_name='__main__')\n",
               cwd=tmp_path, PYTHONPATH="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
