"""The port's telemetry smoke (``benchmarks_torch/telemetry_smoke.py``) on
the CPU. Its overhead gate is held on the card (``chip_smoke.py`` phase
12); here, as the reference documents for shared runners,
``REPRO_TELEMETRY_MAX_OVERHEAD`` is set high and one run a mode is timed
(``REPEATS`` 1), and everything else it asserts holds: bitwise parity of the disabled and enabled runs, the
round -> cohort -> step trace with 25 round spans, the manifest's kernel
build count, and the comm gauges (which ``build_result`` publishes).
"""
import json

import torch

from benchmarks_torch import telemetry_smoke

torch.set_num_threads(1)


def test_telemetry_smoke_passes_on_the_cpu(tmp_path, monkeypatch, capsys):
    from repro_torch import telemetry
    from repro_torch.kernels import _build

    monkeypatch.setenv("REPRO_TELEMETRY_MAX_OVERHEAD", "100")
    monkeypatch.setattr(telemetry_smoke, "REPEATS", 1)
    out = tmp_path / "run"
    try:
        assert telemetry_smoke.main(["--device", "cpu", "--out", str(out)]) == 0
    finally:
        telemetry.disable()
        telemetry.reset(reset_metrics=True)
    printed = capsys.readouterr().out
    assert "telemetry_smoke: OK" in printed
    assert "spans and events a run" in printed      # the gated estimate is printed
    assert sorted(p.name for p in out.iterdir()) == [
        "events.jsonl", "manifest.json", "metrics.json", "trace.json"]
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["jit_compiles"] == len(_build.build_info) == 0   # no kernel on the CPU
    metrics = json.loads((out / "metrics.json").read_text())
    assert metrics["comm.upload_scalars"]["value"] > 0
    # XLA's compile counter has no counterpart (tests/test_torch_api.py LEFT_OUT).
    assert "jax.jit_compiles" not in metrics
