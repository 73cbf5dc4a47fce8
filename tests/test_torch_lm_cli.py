"""The port's ``lm`` subcommands (``repro_torch.launch.serve lm`` /
``repro_torch.launch.train lm``), their checkpoints and the two example
twins, against the JAX package's, on the CPU.

- both CLIs print the JAX CLI's keys on the same flags, and run every
  architecture with ``--device cpu`` (serve at its defaults, train 3
  steps);
- with both packages on the f32 variant of the reduced config
  (``get_reduced`` patched in both) and the JAX package's ``init_model``
  patched into the port: ``serve lm`` feeds the same greedy tokens step by
  step, ``train lm``'s ``loss_first`` / ``loss_last`` agree within 1e-5;
- an LM checkpoint written by either package resumes in the other:
  ``train lm --ckpt-dir ... --resume`` to 4 steps from 2, against the JAX
  package's uninterrupted 4 steps, ``loss_last`` within 1e-6;
- ``examples/serve_transformer_torch.py`` and ``train_lm_torch.py`` run
  with ``--device cpu``.
"""
import argparse
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.models.transformer as jtransformer
from repro.launch import serve as jserve_cli, train as jtrain_cli
import repro_torch.configs as tconfigs
import repro_torch.models.transformer as ttransformer
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as tserve_cli, train as ttrain_cli
from torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH_IDS = jconfigs.ARCH_IDS
TOL = 1e-5
RESUME_TOL = 1e-6


def _jax_args(cli, argv):
    """The JAX CLI's namespace for ``argv`` (the port's parser without
    ``--device``)."""
    args = cli.build_parser().parse_args(["lm", *argv])
    del args.device
    return argparse.Namespace(**vars(args))


def _f32_everywhere(monkeypatch, seed: int = 0):
    """Both packages on the f32 variant of the reduced configs, the port
    starting from the JAX package's ``init_model`` of ``seed``."""
    jred, tred = jconfigs.get_reduced, tconfigs.get_reduced
    monkeypatch.setattr(jconfigs, "get_reduced", lambda a: dataclasses.replace(
        jred(a), dtype="float32"))
    monkeypatch.setattr(tconfigs, "get_reduced", lambda a: dataclasses.replace(
        tred(a), dtype="float32"))

    def init(cfg, generator, device="cuda"):
        jcfg = jconfigs.get_reduced(cfg.name.removesuffix("-reduced"))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        jp = jtransformer.init_model(jax.random.PRNGKey(seed), jcfg)
        return lm_params_from_reference(jax.tree.map(np.asarray, jp), device)
    monkeypatch.setattr(ttransformer, "init_model", init)


@pytest.mark.parametrize("which", ["serve", "train"])
def test_lm_cli_keys_match_reference(which, capsys):
    argv = ["--arch", "qwen3-1.7b", "--steps", "3"] + \
        (["--batch", "2", "--cache-len", "16"] if which == "serve"
         else ["--batch", "2", "--seq-len", "16"])
    tcli, jcli = ((tserve_cli, jserve_cli) if which == "serve"
                  else (ttrain_cli, jtrain_cli))
    want = jcli.run_lm(_jax_args(tcli, argv))
    capsys.readouterr()
    got = tcli.main(["lm", "--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert list(got) == list(want)
    for k in got:
        if k != "tokens_per_s":
            assert type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_clis_run_every_arch_on_the_cpu(arch, capsys):
    out = tserve_cli.main(["lm", "--device", "cpu", "--arch", arch])
    assert out["logits_finite"] and out["steps"] == 32
    out = ttrain_cli.main(["lm", "--device", "cpu", "--arch", arch,
                           "--steps", "3"])
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    capsys.readouterr()


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "deepseek_v3_671b"])
def test_serve_cli_greedy_tokens_match_reference(arch, monkeypatch, capsys):
    _f32_everywhere(monkeypatch)
    fed = {"jax": [], "port": []}
    jstep, tstep = jtransformer.serve_step, ttransformer.serve_step

    def jrecord(cfg, p, c, t, pos):
        jax.debug.callback(lambda x: fed["jax"].append(np.asarray(x)), t)
        return jstep(cfg, p, c, t, pos)

    def trecord(cfg, p, c, t, pos):
        fed["port"].append(t.numpy().copy())
        return tstep(cfg, p, c, t, pos)
    monkeypatch.setattr(jtransformer, "serve_step", jrecord)
    monkeypatch.setattr(ttransformer, "serve_step", trecord)
    argv = ["--arch", arch, "--steps", "12", "--batch", "3",
            "--cache-len", "16"]
    want = jserve_cli.run_lm(_jax_args(tserve_cli, argv))
    got = tserve_cli.main(["lm", "--device", "cpu", *argv])
    capsys.readouterr()
    assert got["logits_finite"] and want["logits_finite"]
    assert len(fed["port"]) == len(fed["jax"]) == 12
    for t, (a, b) in enumerate(zip(fed["port"], fed["jax"])):
        np.testing.assert_array_equal(a, b, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "mixtral_8x7b"])
def test_train_cli_losses_match_reference(arch, monkeypatch, capsys):
    _f32_everywhere(monkeypatch)
    argv = ["--arch", arch, "--steps", "4", "--batch", "2", "--seq-len", "24"]
    want = jtrain_cli.run_lm(_jax_args(ttrain_cli, argv))
    got = ttrain_cli.main(["lm", "--device", "cpu", *argv])
    capsys.readouterr()
    for k in ("loss_first", "loss_last"):
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])
    assert got["resumed_from"] == want["resumed_from"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lm_checkpoint_resumes_across_packages(writer, tmp_path, monkeypatch,
                                               capsys):
    """Two steps in ``writer``'s package with ``--ckpt-dir``, then the
    other package resumes to 4 steps; against the JAX package's
    uninterrupted 4 steps from the same parameters."""
    _f32_everywhere(monkeypatch)
    base = ["--arch", "qwen3_1_7b", "--batch", "2", "--seq-len", "16"]
    whole = jtrain_cli.run_lm(_jax_args(ttrain_cli, base + ["--steps", "4"]))
    ck = ["--ckpt-dir", str(tmp_path)]
    first = base + ["--steps", "2"] + ck
    second = base + ["--steps", "4", "--resume"] + ck
    if writer == "jax":
        jtrain_cli.run_lm(_jax_args(ttrain_cli, first))
        got = ttrain_cli.main(["lm", "--device", "cpu", *second])
    else:
        ttrain_cli.main(["lm", "--device", "cpu", *first])
        got = jtrain_cli.run_lm(_jax_args(ttrain_cli, second))
    capsys.readouterr()
    assert got["resumed_from"] == 2
    assert abs(got["loss_last"] - whole["loss_last"]) <= RESUME_TOL, \
        (got["loss_last"], whole["loss_last"])
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == \
        ["ckpt_00000002.npz", "ckpt_00000004.npz"]


def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_transformer_example_runs_on_the_cpu(capsys):
    outs = _load_example("serve_transformer_torch").main(
        ["--all", "--device", "cpu", "--steps", "3"])
    assert [o["arch"] for o in outs] == [
        tconfigs.get_reduced(a).name for a in ARCH_IDS]
    assert all(o["logits_finite"] for o in outs)
    capsys.readouterr()


def test_train_lm_example_runs_on_the_cpu(tmp_path, capsys):
    out = _load_example("train_lm_torch").main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq-len", "16",
         "--ckpt-dir", str(tmp_path)])
    assert out["params_m"] > 50 and np.isfinite(out["loss_last"])
    assert (tmp_path / "ckpt_00000002.npz").exists()
    # the checkpoint resumes through the CLI's payload layout
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path)) == 2
    capsys.readouterr()
