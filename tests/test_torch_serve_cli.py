"""The serving CLI ``repro_torch.launch.serve`` against the reference's
``repro.launch.serve`` on the host.

Both CLIs run in this process on the same small testbed (patched through
each module's ``TestbedConfig`` name) and the port's router trains from
the reference's initial draw (``main(init_params=...)``).  Over the
simulator backend (closed loop on ``paper5`` and on ``hybrid9`` behind a
retrieval cache, and the open loop in virtual time) every printed line is
identical, and so are the trace and metrics files.  Over the continuous
engine at qwen SMOKE the port's model gets the reference's weights
through the bridge: in float32 every line is identical; in the default
bf16 the outcome, action and engine lines are identical and the average
reward is held to ``BF16_REWARD_TOL``.
"""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as port_configs
import repro_torch.models as port_models
from repro.core.config import RouterConfig as RefRouterConfig
from repro.core.config import TestbedConfig as RefTestbedConfig
from repro.core.policy import init_policy as ref_init_policy
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.core.config import RouterConfig, TestbedConfig
from repro_torch.launch import serve

SIZE = dict(n_train=60, n_eval=40, n_paragraphs=60)
EPOCHS = 8
# bf16 in both packages, the same bf16 weights: the two decoders round
# their activations in other orders, so a greedy token may differ.  The
# answers of random weights are never correct and every generation runs
# its 8 tokens, so outcome and cost agree; the reward is printed to 4
# decimals and may move by one unit in the last place (at this size the
# whole output was observed identical).
BF16_REWARD_TOL = 1e-4


def _ref_init(rc):
    return params_from_numpy(
        {k: np.asarray(v) for k, v in
         ref_init_policy(jax.random.PRNGKey(rc.seed), rc).items()},
        device="cpu")


@pytest.fixture
def sized(monkeypatch):
    monkeypatch.setattr(ref_serve, "TestbedConfig", lambda: RefTestbedConfig(
        **SIZE, router=RefRouterConfig(n_epochs=EPOCHS)))
    monkeypatch.setattr(serve, "TestbedConfig", lambda: TestbedConfig(
        **SIZE, router=RouterConfig(n_epochs=EPOCHS)))


def _run_both(argv, monkeypatch, capsys, port_argv=None):
    """stdout of the reference CLI on ``argv`` and of the port's on
    ``port_argv`` (default ``argv``), and the port's run record."""
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref_serve.main()
    want = capsys.readouterr().out
    run = serve.main([*(port_argv or argv), "--device", "cpu"],
                     init_params=_ref_init)
    got = capsys.readouterr().out
    return want, got, run


@pytest.mark.parametrize("argv", [
    ["-n", "20"],
    ["-n", "20", "--space", "hybrid9", "--retrieval-cache", "8",
     "--slo", "cheap"],
    ["-n", "24", "--open-loop", "40", "--objective", "constrained",
     "--refusal-cap", "0.45", "--adaptive"],
], ids=["paper5", "hybrid9-cache", "open-loop"])
def test_simulator_cli_prints_the_reference_lines(sized, monkeypatch,
                                                  capsys, tmp_path, argv):
    """The same lines; on the open loop also ``--trace-out`` and
    ``--metrics-out``, whose files are the reference's on the virtual
    clock."""
    telemetry = "--open-loop" in argv
    port_argv = argv
    if telemetry:
        files = {tag: (tmp_path / f"{tag}.json", tmp_path / f"{tag}.prom")
                 for tag in ("ref", "port")}
        argv, port_argv = ([*argv, "--trace-out", str(files[tag][0]),
                            "--metrics-out", str(files[tag][1])]
                           for tag in ("ref", "port"))
    want, got, run = _run_both(argv, monkeypatch, capsys, port_argv)
    assert got.replace("port.", "ref.") == want
    assert got.count("# error budgets:") == 1
    if telemetry:
        assert run["report"].offered == 24
        assert "# admission: shed=" in got and "# trace: " in got
        for ref_path, port_path in zip(files["ref"], files["port"]):
            assert port_path.stat().st_size > 0
            assert port_path.read_text() == ref_path.read_text()
        assert "# TYPE" in files["port"][1].read_text()
    else:
        assert run["stats"].served == 20
        assert re.search(r"# served=20 avg_reward=[+-]\d", got)
    if "hybrid9" in argv:
        assert "# retrieval cache: " in got
    assert set(run["seconds"]) >= {"build_testbed", "train_router", "serve"}


def _engine_lines(out: str):
    return [line for line in out.splitlines()
            if line.startswith(("# engine:", "# serving", "q="))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_continuous_cli_at_qwen_smoke(sized, monkeypatch, capsys, dtype):
    """``--backend continuous`` at qwen SMOKE with the reference's
    weights bridged into the port's model."""
    ref_get, port_get = ref_configs.get_config, port_configs.get_config
    monkeypatch.setattr(ref_configs, "get_config", lambda a, v="full":
                        dataclasses.replace(ref_get(a, v), dtype=dtype))
    monkeypatch.setattr(port_configs, "get_config", lambda a, v="full":
                        dataclasses.replace(port_get(a, v), dtype=dtype))
    real_build = port_models.build_model

    def bridged_build(cfg):
        model = real_build(cfg)
        ref_model = ref_build_model(ref_configs.get_config("qwen1.5-32b",
                                                           "smoke"))
        weights = jax.tree_util.tree_map(
            np.asarray, ref_model.init(jax.random.PRNGKey(0)))
        model.init = lambda seed=0, device="cuda": params_from_numpy(
            weights, device=device)
        return model

    monkeypatch.setattr(port_models, "build_model", bridged_build)
    argv = ["--backend", "continuous", "-n", "12", "--num-slots", "4"]
    want, got, run = _run_both(argv, monkeypatch, capsys)
    es = run["gateway"].engine_stats
    assert es.n_prefills > 0 and es.n_decode_chunks > 0
    assert run["stats"].served == 12
    assert run["backend"].engine.params["embed"].dtype == \
        getattr(torch, dtype)
    if dtype == "float32":
        assert got == want
        return
    assert _engine_lines(got) == _engine_lines(want)
    pat = r"# served=(\d+) avg_reward=(\S+) actions=(.*)"
    (g_n, g_r, g_a), = re.findall(pat, got)
    (w_n, w_r, w_a), = re.findall(pat, want)
    assert (g_n, g_a) == (w_n, w_a)
    assert abs(float(g_r) - float(w_r)) <= BF16_REWARD_TOL


def test_mesh_is_refused_with_the_roadmap_item(capsys):
    """Multi-GPU serving (ROADMAP.md queue 1, item 9) now serves, so
    what is refused is what the reference refuses: a mesh without the
    continuous backend; and a mesh wider than the world, before any
    weight is drawn."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--mesh", "dp=2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--mesh requires --backend continuous" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs 2 processes but the world "
                                         "has 1"):
        serve.main(["--mesh", "dp=2", "--backend", "continuous",
                    "--device", "cpu"])


CLI_ARGV = ["--backend", "continuous", "-n", "8", "--num-slots", "4",
            "--device", "cpu"]


def test_mesh_of_one_in_process_prints_the_unsharded_lines(sized, capsys):
    """``--mesh dp=1`` without torchrun: a world of one in this process,
    the same lines as the run without ``--mesh``; the CLI destroys the
    process group it made."""
    import torch.distributed as dist
    serve.main(CLI_ARGV)
    want = capsys.readouterr().out
    try:
        run = serve.main(CLI_ARGV + ["--mesh", "dp=1"])
        assert not dist.is_initialized()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert capsys.readouterr().out == want
    assert type(run["backend"].engine.executor).__name__ == "ShardedExecutor"


@pytest.mark.parametrize("mesh", ["dp=2", "dp=1,mp=2"])
def test_mesh_on_a_gloo_world_prints_the_unsharded_lines(sized, capsys,
                                                          tmp_path, mesh):
    """``--mesh`` over two spawned processes (``tests/torch_dist.py``):
    rank 0 prints the lines of the run without ``--mesh``, rank 1
    prints nothing, and both serve every request."""
    import torch_dist
    serve.main(CLI_ARGV)
    want = capsys.readouterr().out
    size = dict(SIZE, n_epochs=EPOCHS)
    ranks = torch_dist.run_world(torch_dist.serve_cli, 2, tmp_path,
                                 CLI_ARGV + ["--mesh", mesh], size)
    assert ranks[0]["out"] == want
    assert ranks[1]["out"] == ""
    assert [r["served"] for r in ranks] == [8, 8]


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["-n", "4"])


def test_torchrun_serves_the_example_over_a_mesh(capsys):
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.examples.serve_rag_slo --mesh dp=2``: the process group
    comes from torchrun's environment, rank 0 alone prints, the answers
    are the run's without a mesh, and the world exits 0 with no
    teardown message: ``main`` destroys the group it made (left to the
    interpreter's teardown, gloo's threads aborted a rank now and then
    on a loaded host, "terminate called without an active
    exception")."""
    import os
    import subprocess
    from pathlib import Path

    from repro_torch.examples import serve_rag_slo
    serve_rag_slo.main(["--device", "cpu", "--batch", "4"])
    want = capsys.readouterr().out
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.examples.serve_rag_slo",
         "--mesh", "dp=2", "--device", "cpu", "--batch", "4"],
        env=env, capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    for msg in ("terminate called", "SIGABRT", "destroy_process_group"):
        assert msg not in run.stderr, run.stderr[-2000:]

    def answers(out):
        return [line for line in out.splitlines()
                if line.startswith("  a") or "avg SLO reward" in line]
    got = answers(run.stdout)
    assert len(got) == 5 and [g.split("s; ")[-1] for g in got] == \
        [w.split("s; ")[-1] for w in answers(want)]
    assert run.stdout.count("# sharded executor over mesh dp=2") == 1
