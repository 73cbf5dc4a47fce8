"""The port's sharding rules and dry run against the JAX package.

- The rules, with no devices: for all ten full configs at the production
  meshes' sizes (``(16, 16)`` ``("data", "model")`` and ``(2, 16, 16)``
  ``("pod", "data", "model")``), ``param_specs`` (ZeRO-1 on and off) equal
  the JAX package's leaf by leaf, as tuples of axis names (the JAX side
  over ``eval_shape``, the port over the meta build); so do the
  per-device argument bytes (the JAX side ``NamedSharding.shard_shape``
  over an ``AbstractMesh``), the ``decode_state_specs`` of the
  ``decode_32k`` and ``long_500k`` caches, and ``make_spmd_ctx``'s specs
  for every shape kind.
- ``shard_params``: each of 4 gloo ranks' local shards equal the JAX
  package's ``NamedSharding`` shards of the same leaves on the forced
  2 x 2 mesh (reduced deepseek, every layout rule but Mamba's).
- The dry run on a fake group of 4 gives the FLOPs, the bytes and the
  collective bytes and counts per kind of one gloo rank that really runs
  the same step at the same 2 x 2 mesh, for a training, a prefill and a
  decode step; the CLI and the example run; ``analyse_ops`` counts a
  matmul and a collective.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, INPUT_SHAPES
from repro.configs import get_config as jget
from repro.launch import sharding as jshd
from repro.optim import adam as jadam
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.hlo_cost import analyse_ops
from repro_torch.launch.mesh import AbstractMesh, spawn
from repro_torch.optim import adam
from torch_lm_spmd_ranks import counted_rank, shards_rank
from torch_threads import torch_threads_per_worker  # noqa: F401

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "..", "src")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree):
    from jax.sharding import PartitionSpec as JP
    return {jshd._path_names(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _pflat(tree):
    out = {}
    shd.tree_map_with_path(lambda n, v: out.__setitem__(n, v), tree)
    return out


def _jmesh(name):
    shape, axes = MESHES[name]
    return jax.sharding.AbstractMesh(shape, axes)


def _pmesh(name):
    return AbstractMesh(*MESHES[name])


def _jbytes(structs, mesh):
    from jax.sharding import NamedSharding
    total = 0
    for leaf, spec in structs:
        n = int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape)))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_bytes_equal_reference(arch):
    jc, c = jget(arch), get_config(arch)
    jp, p = jshd.abstract_params(jc), shd.abstract_params(c)
    jo = jax.eval_shape(jadam(3e-4).init, jp)
    po = adam(3e-4).init(p)
    for name in MESHES:
        jm, pm = _jmesh(name), _pmesh(name)
        sizes = dict(zip(pm.mesh_dim_names, pm.shape))
        for tree_j, tree_p, zd in ((jp, p, False), (jo, po, True)):
            js = _jflat(jshd.param_specs(jc, tree_j, model_size=16,
                                         data_size=16, zero_data=zd))
            ps = _pflat(shd.param_shardings(pm, c, tree_p, zero_data=zd))
            assert {k: tuple(v) for k, v in js.items()} == \
                {k: tuple(v) for k, v in ps.items()}, (arch, name, zd)
            leaves = _jflat(tree_j)
            jb = _jbytes([(leaves[k], js[k]) for k in js], jm)
            pb = shd.per_device_bytes(shd.attach(tree_p, shd.param_shardings(
                pm, c, tree_p, zero_data=zd)), sizes)
            assert jb == pb, (arch, name, zd, jb, pb)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    jc, c = jget(arch), get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        seq, batch, _ = INPUT_SHAPES[shape]
        if shape == "long_500k":
            from repro.configs import long_context_variant as jlong
            from repro_torch.configs import long_context_variant
            jc, c = jlong(jc), long_context_variant(c)
        for name in MESHES:
            jm, pm = _jmesh(name), _pmesh(name)
            js = {k: v for k, v in _jflat(jshd.decode_state_specs(
                jm, jc, batch, seq, batch == 1)).items()}
            ps = _pflat(shd.decode_state_specs(pm, c, batch, seq, batch == 1))
            assert sorted(js) == sorted(ps)
            for k in js:
                assert tuple(js[k].sharding.spec) == tuple(ps[k].sharding), \
                    (arch, shape, name, k)
                assert tuple(js[k].shape) == ps[k].shape
            sizes = dict(zip(pm.mesh_dim_names, pm.shape))
            assert _jbytes([(v, v.sharding.spec) for v in js.values()],
                           jm) == shd.per_device_bytes(ps, sizes)


@pytest.mark.parametrize("name", list(MESHES))
def test_spmd_ctx_specs_equal_reference(name):
    cfg_j, cfg = jget("qwen3-14b"), get_config("qwen3-14b")
    jm, pm = _jmesh(name), _pmesh(name)
    for kind in ("train", "prefill", "decode"):
        for seq_shard in (False, True):
            for mode in ("baseline", "block_sp"):
                j = jshd.make_spmd_ctx(jm, cfg_j, kind, seq_shard, mode)
                p = shd.make_spmd_ctx(pm, cfg, kind, seq_shard, mode)
                assert tuple(j.act_spec) == tuple(p.act_spec)
                assert tuple(j.logits_spec) == tuple(p.logits_spec)
                assert j.dp_axes == p.dp_axes
                assert (j.block_sp, j.moe_group) == (p.block_sp, p.moe_group)
    for seq_shard, kind in ((False, "train"), (True, "decode")):
        for arch in ("qwen3-14b", "phi3_vision_4_2b"):
            jb = jshd.batch_specs(jm, jget(arch), 4096, 256, kind, seq_shard)
            pb = shd.batch_specs(pm, get_config(arch), 4096, 256, kind,
                                 seq_shard)
            assert sorted(jb) == sorted(pb)
            for k in jb:
                assert tuple(jb[k].sharding.spec) == tuple(pb[k].sharding)
                assert tuple(jb[k].shape) == pb[k].shape


def test_shard_params_match_reference_shards(tmp_path):
    from repro.models.transformer import init_model
    from torch_lm_common import f32_configs
    out = str(tmp_path / "shards.npz")
    proc = subprocess.run(
        [sys.executable, os.path.join(_HERE, "lm_spmd_reference_script.py"),
         out, "shards:deepseek-v3-671b:2x2"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    jcfg, _ = f32_configs("deepseek-v3-671b")
    jp = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(0), jcfg))
    got = spawn(shards_rank, 4, backend="gloo", devices="cpu",
                args=("deepseek-v3-671b", jp, (2, 2)))[0]
    keys = {k.split("|")[1] for k in ref.files}
    assert {f"{k}@{r}" for k in got for r in range(4)} == keys
    # a rule that shards shows as shards that differ across the ranks
    sharded = sum(any(not np.array_equal(s, shards[0]) for s in shards)
                  for shards in got.values())
    assert sharded > 10


def _dryrun_script(*args, wait=True):
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "torch_dryrun_script.py"),
         *map(str, args)],
        env=dict(os.environ, PYTHONPATH=_SRC), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return _result(proc) if wait else proc


def _result(proc):
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


DRYRUN_CASES = [("mixtral-8x7b", (32, 4, "train")),
                ("qwen3-1.7b", (32, 4, "prefill")),
                ("deepseek-v3-671b", (16, 4, "decode"))]


@pytest.fixture(scope="module")
def dryrun_pairs():
    """The fake group's dry run and one gloo rank's counted run of each
    case, side by side (the subprocess runs beside the ranks)."""
    names = [f"{a}:{s}:{b}:{k}" for a, (s, b, k) in DRYRUN_CASES]
    proc = _dryrun_script("run", 2, 2, *names, wait=False)
    real = spawn(counted_rank, 4, backend="gloo", devices="cpu",
                 args=(DRYRUN_CASES, (2, 2)))[0]
    fake = _result(proc)
    return {n: (fake[n], r) for n, r in zip(names, real)}


@pytest.mark.parametrize("case", range(len(DRYRUN_CASES)))
def test_dryrun_equals_counted_gloo_rank(dryrun_pairs, case):
    arch, (s, b, k) = DRYRUN_CASES[case]
    fake, real = dryrun_pairs[f"{arch}:{s}:{b}:{k}"]
    assert fake["hlo_flops_per_device"] == real["flops"]
    assert fake["collectives"] == real["collectives"]
    assert fake["collective_counts"] == real["counts"]
    assert fake["hlo_bytes_per_device"] == real["bytes"]
    assert fake["hlo_flops_per_device"] > 0
    assert fake["collective_bytes_per_device"] > 0
    assert fake["unresolved_loops"] == 0


def test_dryrun_cli_writes_json(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(tmp_path)], env=dict(os.environ, PYTHONPATH=_SRC),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads((tmp_path / "qwen3_1_7b_decode_32k_16x16.json")
                     .read_text())
    assert res["devices"] == 256 and res["mesh"] == "16x16"
    assert res["hlo_flops_per_device"] > 0
    assert res["memory"]["argument_size"] > 0
    assert set(res["collectives"]) >= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"}


def test_multipod_example_runs():
    proc = subprocess.run(
        [sys.executable, os.path.join(_HERE, "..", "examples",
                                      "multipod_dryrun_torch.py"),
         "--arch", "qwen3-1.7b", "--shape", "decode_32k", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=_SRC), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "roofline terms" in proc.stdout


def test_analyse_ops_counts_a_matmul():
    a, b = torch.ones(8, 6), torch.ones(6, 4)
    out, cost = analyse_ops(torch.mm, a, b)
    assert torch.equal(out, a @ b)
    assert cost.flops == 2 * 8 * 6 * 4
    assert cost.bytes_accessed == 4 * (8 * 6 + 6 * 4 + 8 * 4)
    assert cost.collective_total == 0


def test_analyse_ops_counts_a_collective_by_kind():
    got = _dryrun_script("collective")
    assert got["counts"]["all-gather"] == 1
    assert got["bytes"]["all-gather"] == 2 * 3 * 5 * 4
    assert sum(got["counts"].values()) == 1
