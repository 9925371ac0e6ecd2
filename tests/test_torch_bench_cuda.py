"""`chip_smoke.bench_phase`, the port's bench as the chip run drives it, on a
CUDA device: the smoke cell passes on its kernels' path, and a cell whose
first gate fails, so that its numbers come from the gate-safe re-measure,
fails the phase. Needs the card: marked `cuda`, skipped elsewhere
(`python -m pytest --noconftest tests/test_torch_*_cuda.py` on a GPU
machine without JAX).
"""

import pytest
import torch

import chip_smoke
from direct12pbrrenderer_tpu_torch import bench

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_bench_phase_passes_on_the_smoke_cell(device, capsys):
    chip_smoke.bench_phase(runs=(["--smoke", "--frames", "2"],))
    out = capsys.readouterr().out
    assert "[bench] smoke: one frame's kernel calls held to their plain versions" in out
    assert "every gate passes on the kernels' path" in out


def test_bench_phase_fails_a_cell_that_fell_back(device, monkeypatch, capsys):
    real, seen = bench._rmse_vs_plain, []

    def failing_once(pipe, cam):
        seen.append(2e-3 if not seen else real(pipe, cam))
        return seen[-1]

    monkeypatch.setattr(bench, "_rmse_vs_plain", failing_once)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.bench_phase(runs=(["--smoke", "--frames", "2"],))
    assert exc.value.code == 1 and len(seen) == 2 and seen[1] <= bench.RMSE_BAR
    assert ("[bench] FAIL fidelity_fallback is 'xla-samplers'"
            in capsys.readouterr().out)
