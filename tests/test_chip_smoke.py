"""chip_smoke.py's phases at toy sizes on the CPU (the fused kernel in the
Pallas interpreter), and its refusal to run without a GPU. On the card the
script runs the same phases at full size, the kernel compiled."""
import importlib.util
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASES = {
    "forward": lambda m: m.phase_forward(32, 2),
    "cli": lambda m: m.phase_cli(32, 2),
    "direct": lambda m: m.phase_direct(32, 2),
    "train": lambda m: m.phase_train(16),
    "grad_route": lambda m: m.phase_grad_route(16, bounces=1),
    "parity_fused": lambda m: m.phase_parity_fused(16, interpret=True),
    "parity_cpu": lambda m: m.phase_parity_cpu(32, 16, 16),
    "oracle": lambda m: m.phase_oracle(32),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_at_toy_size(smoke, phase, capsys):
    PHASES[phase](smoke)
    out = capsys.readouterr().out
    assert out.strip() and "nan" not in out.lower()


def test_refuses_without_gpu(smoke, monkeypatch, capsys):
    """No accelerator: non-zero exit and no result line."""
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
