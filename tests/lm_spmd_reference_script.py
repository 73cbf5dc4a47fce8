"""Subprocess helper for the transformer zoo's SPMD parity tests
(``tests/test_torch_lm_spmd.py``): runs the JAX package's model under an
``SpmdCtx`` on forced host devices and writes what the port's sharded run
is compared with to an ``.npz`` file.

The expert-parallel and per-dp-group MoE compute something other than the
single-device model (capacity and ``aux`` are taken per device block or
dp group), so those cases are held against the JAX package's own SPMD run
on the same mesh, not against its single-device run.

    python tests/lm_spmd_reference_script.py OUT.npz CASE [CASE ...]

Cases (reduced configs in f32, parameters ``init_model(PRNGKey(0))``, the
batch of ``tests/torch_lm_common.batches`` at seed 0):

- ``<arch>:<D>x<M>:<S>``  forward logits and aux, loss, and the gradients
  of ``loss_fn``'s total, at B = 4 and S tokens on a ``("data",
  "model")`` mesh of D x M devices;
- ``decode:<arch>:<D>x<M>``  8 ``serve_step``s at B = 4 into a 16-slot
  cache laid out by ``decode_state_specs``: each step's logits and the
  final caches;
- ``shards:<arch>:<D>x<M>``  each device's shard of every parameter leaf
  placed by ``param_shardings`` (``<leaf>@<device index>``).
"""
import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=8 "
    # the XLA-CPU all-reduce promotion pass check-fails on the variadic
    # all-reduces of SPMD-partitioned MoE graphs (see repro.launch.dryrun)
    "--xla_disable_hlo_passes=all-reduce-promotion "
    + os.environ.get("XLA_FLAGS", ""))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

DECODE_B, DECODE_W, DECODE_STEPS = 4, 16, 8


def _cfg(arch):
    from repro.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _mesh(shape):
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(devs, ("data", "model"),
                axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _flat(tree, prefix):
    from repro.launch.sharding import _path_names
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(_path_names(path))] = np.asarray(leaf)
    return out


def batch_arrays(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def forward_case(arch, shape, s):
    from repro.launch import sharding as shd
    from repro.models.transformer import init_model, forward, loss_fn
    from repro.models.transformer import use_spmd
    cfg = _cfg(arch)
    mesh = _mesh(shape)
    params = init_model(jax.random.PRNGKey(0), cfg)
    params = jax.device_put(params, shd.param_shardings(mesh, cfg, params))
    arrs = batch_arrays(cfg, 4, s)
    structs = shd.batch_specs(mesh, cfg, s, 4, "train", False)
    batch = {k: jax.device_put(jnp.asarray(v), structs[k].sharding)
             for k, v in arrs.items()}
    ctx = shd.make_spmd_ctx(mesh, cfg, "train", False)
    with use_spmd(ctx), jax.set_mesh(mesh):
        logits, aux = jax.jit(lambda p, b: forward(cfg, p, b))(params, batch)
        (total, met), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(cfg, p, b), has_aux=True))(params, batch)
    out = {"logits": np.asarray(logits), "aux": np.asarray(aux),
           "total": np.asarray(total), "loss": np.asarray(met["loss"])}
    out.update(_flat(grads, "grads"))
    return out


def decode_case(arch, shape):
    from repro.launch import sharding as shd
    from repro.models.transformer import (init_model, init_decode_cache,
                                          serve_step, use_spmd)
    from jax.sharding import NamedSharding, PartitionSpec as P
    cfg = _cfg(arch)
    mesh = _mesh(shape)
    params = init_model(jax.random.PRNGKey(0), cfg)
    params = jax.device_put(params, shd.param_shardings(mesh, cfg, params))
    structs = shd.decode_state_specs(mesh, cfg, DECODE_B, DECODE_W, False)
    caches = jax.device_put(init_decode_cache(cfg, DECODE_B, DECODE_W),
                            jax.tree.map(lambda s: s.sharding, structs))
    toks = batch_arrays(cfg, DECODE_B, DECODE_STEPS)["tokens"]
    tok_sh = NamedSharding(mesh, P(shd.dp_axes(mesh), None))
    ctx = shd.make_spmd_ctx(mesh, cfg, "decode", False)
    out = {}
    with use_spmd(ctx), jax.set_mesh(mesh):
        step = jax.jit(lambda p, c, t, i: serve_step(cfg, p, c, t, i))
        for i in range(DECODE_STEPS):
            tok = jax.device_put(jnp.asarray(toks[:, i:i + 1]), tok_sh)
            logits, caches = step(params, caches, tok, jnp.int32(i))
            out[f"logits{i}"] = np.asarray(logits)
    out.update(_flat(caches, "caches"))
    return out


def shards_case(arch, shape):
    """Each device's shard of every parameter leaf under
    ``param_shardings``, in the mesh's device order."""
    from repro.launch import sharding as shd
    from repro.models.transformer import init_model
    cfg = _cfg(arch)
    mesh = _mesh(shape)
    params = init_model(jax.random.PRNGKey(0), cfg)
    placed = jax.device_put(params, shd.param_shardings(mesh, cfg, params))
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = "/".join(shd._path_names(path))
        for s in leaf.addressable_shards:
            out[f"{name}@{order[s.device]}"] = np.asarray(s.data)
    return out


def main():
    path, cases = sys.argv[1], sys.argv[2:]
    out = {}
    for case in cases:
        parts = case.split(":")
        if parts[0] == "shards":
            got = shards_case(parts[1], tuple(map(int, parts[2].split("x"))))
        elif parts[0] == "decode":
            got = decode_case(parts[1], tuple(map(int, parts[2].split("x"))))
        else:
            got = forward_case(parts[0], tuple(map(int, parts[1].split("x"))),
                               int(parts[2]))
        out.update({f"{case}|{k}": v for k, v in got.items()})
    np.savez(path, **out)
    print("OK", len(out))


if __name__ == "__main__":
    main()
