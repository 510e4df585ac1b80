"""The port's example twins (``python -m repro_torch.examples.*``) run end
to end on the host with ``--device cpu``: ``serve_rag_slo`` on both
engines and ``open_loop_serving`` over the simulator and over the
continuous engine, every arrival resolved and shedding only when
over-offered; without a card, the default device raises instead of
falling back."""
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
import pytest
import torch

from repro_torch.examples import open_loop_serving, serve_rag_slo


@pytest.mark.parametrize("engine", ["continuous", "padded"])
def test_serve_rag_slo_runs_on_the_host(engine, capsys):
    stats = serve_rag_slo.main(["--device", "cpu", "--engine", engine,
                                "--batch", "4", "--max-new-tokens", "4"])
    assert stats.served == 4
    out = capsys.readouterr().out
    assert f"({engine} engine)" in out and "avg SLO reward" in out


def test_open_loop_serving_sweep(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.prom"
    reports = open_loop_serving.main([
        "--device", "cpu", "--requests", "40", "--trace-out", str(trace),
        "--metrics-out", str(metrics)])
    for rep in reports.values():
        assert rep.completed == rep.offered == 40
    assert reports["poisson 50"].shed == 0
    assert reports["poisson 3200"].shed > 0
    # the traced rerun of poisson 200/s serves the same, plus its stages
    traced = reports["traced"].as_dict()
    assert set(traced.pop("stages")) >= {"queue_wait", "decode", "e2e"}
    assert traced == reports["poisson 200"].as_dict()
    assert trace.stat().st_size > 0 and "# TYPE" in metrics.read_text()


def test_open_loop_serving_over_the_engine(tmp_path):
    """``--backend engine``: the same sweep through
    ``ContinuousEngineBackend`` over qwen SMOKE on the virtual clock."""
    reports = open_loop_serving.main([
        "--device", "cpu", "--backend", "engine", "--requests", "12",
        "--trace-out", str(tmp_path / "t.json"),
        "--metrics-out", str(tmp_path / "m.prom")])
    for rep in reports.values():
        assert rep.completed == rep.offered == 12
    assert reports["poisson 3200"].shed > 0


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_rag_slo.main(["--batch", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_loop_serving.main(["--requests", "4"])
