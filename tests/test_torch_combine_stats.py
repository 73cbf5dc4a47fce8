"""The port's last public helpers against the JAX package's, on the CPU.

- ``kernels.ops.cache_combine`` (the three-way tier scatter into the halo
  buffer, plain torch as the reference's is plain jnp) and
  ``kernels.ref.cache_combine_ref``: bit-equal to the JAX functions on
  seeded inputs, with every tier filled and with empty tiers;
- ``kernels.ref.masked_mean_ref``: within one f32 rounding of the JAX
  function's, and zeros where the mask selects no row;
- ``kernels.ops.ell_stats``: the JAX function's dict on the same
  ``ell_pack`` / ``ell_pack_hybrid`` packs;
- ``obs.annotate_function``: the wrapped function returns what the
  function does, and under ``torch.profiler`` its range appears once a
  call, named by ``name`` or the function's qualified name.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch import obs
from repro_torch.kernels import ops, ref
from torch_threads import torch_threads_per_worker  # noqa: F401


def _tiers(seed: int, sizes: tuple, d: int = 8):
    """Rows of three tiers at disjoint positions of a halo buffer of
    ``sum(sizes) + 3`` slots (three slots no tier covers)."""
    rng = np.random.default_rng(seed)
    n_halo = sum(sizes) + 3
    pos = rng.permutation(n_halo)[:sum(sizes)].astype(np.int32)
    out, at = [], 0
    for n in sizes:
        out.append((rng.normal(size=(n, d)).astype(np.float32),
                    pos[at:at + n]))
        at += n
    return out, n_halo


@pytest.mark.parametrize("sizes", [(10, 8, 12), (0, 0, 5), (0, 7, 0),
                                   (6, 0, 0), (4, 0, 9)])
@pytest.mark.parametrize("fn", ["ops", "ref"])
def test_cache_combine_bit_equal(sizes, fn):
    tiers, n_halo = _tiers(sum(sizes), sizes)
    want = np.asarray(jops.cache_combine(
        *[jnp.asarray(a) for rows_pos in tiers for a in rows_pos], n_halo))
    combine = ops.cache_combine if fn == "ops" else ref.cache_combine_ref
    got = combine(*[torch.from_numpy(a) for rows_pos in tiers
                    for a in rows_pos], n_halo)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_combine_empty_tiers_take_the_received_width():
    """The reference's empty-tier case: two empty tiers, the received
    rows set the width and dtype, the uncovered slots stay zero."""
    want = np.asarray(jops.cache_combine(
        jnp.zeros((0, 4)), jnp.zeros((0,), jnp.int32), jnp.zeros((0, 4)),
        jnp.zeros((0,), jnp.int32), jnp.ones((3, 4)), jnp.asarray([0, 1, 2]),
        5))
    got = ops.cache_combine(
        torch.zeros((0, 4)), torch.zeros((0,), dtype=torch.int32),
        torch.zeros((0, 4)), torch.zeros((0,), dtype=torch.int32),
        torch.ones((3, 4)), torch.tensor([0, 1, 2]), 5)
    assert got.shape == (5, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p_row", [0.5, 0.0, 1.0])
def test_masked_mean_matches_reference(p_row):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    mask = (rng.random(50) < p_row).astype(np.float32)
    want = np.asarray(jref.masked_mean_ref(jnp.asarray(x), jnp.asarray(mask)))
    got = ref.masked_mean_ref(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    if not mask.any():
        np.testing.assert_array_equal(got.numpy(), np.zeros(6, np.float32))


def _pareto_edges():
    """The heavy-tailed graph of the JAX package's hybrid-pack test."""
    rng = np.random.default_rng(6)
    n_rows, m = 300, 4000
    dst = (rng.pareto(1.2, m) * 8).astype(np.int64) % n_rows
    src = rng.integers(0, n_rows, m)
    return src, dst, np.ones(m, np.float32), n_rows


@pytest.mark.parametrize("pack", ["ell_pack", "ell_pack_hybrid"])
def test_ell_stats_match_reference(pack):
    src, dst, w, n_rows = _pareto_edges()
    cols_j, vals_j = getattr(jops, pack)(src, dst, w, n_rows)[:2]
    cols_t, vals_t = getattr(ops, pack)(src, dst, w, n_rows)[:2]
    want = jops.ell_stats(cols_j, vals_j)
    got = ops.ell_stats(cols_t, vals_t)
    assert got == want
    assert got["nnz"] <= got["slots"] and 0.0 <= got["pad_waste"] < 1.0


def test_hybrid_pack_wastes_less_than_the_plain_pack():
    src, dst, w, n_rows = _pareto_edges()
    plain = ops.ell_stats(*ops.ell_pack(src, dst, w, n_rows))
    hybrid = ops.ell_stats(*ops.ell_pack_hybrid(src, dst, w, n_rows)[:2])
    assert hybrid["pad_waste"] < plain["pad_waste"]


def test_leftover_names_are_exported():
    assert {"cache_combine", "ell_stats"} <= set(ops.__all__)
    assert {"cache_combine_ref", "masked_mean_ref"} <= set(ref.__all__)
    assert "annotate_function" in obs.__all__
    assert obs.annotate_function is obs.annotations.annotate_function


def _scaled(x, k=2.0):
    return x * k


@pytest.mark.parametrize("name", [None, "layer/scale"])
def test_annotate_function_records_one_range_a_call(name):
    wrapped = obs.annotate_function(_scaled, name=name)
    label = name or _scaled.__qualname__
    assert wrapped.__name__ == "_scaled" and wrapped.__wrapped__ is _scaled
    x = torch.arange(6.0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [wrapped(x, k=3.0), wrapped(x)]
    torch.testing.assert_close(outs[0], _scaled(x, k=3.0), rtol=0, atol=0)
    torch.testing.assert_close(outs[1], _scaled(x), rtol=0, atol=0)
    assert sum(e.name == label for e in prof.events()) == 2
