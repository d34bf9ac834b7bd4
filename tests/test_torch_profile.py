"""profile_step's handling of a tracer that drops records: a window whose
trace lost a record of the port's own kernels, or every record, is traced
again, and a profile with no device record at all reports its device
numbers as not measured instead of failing. The tracer is replaced by a
scripted one and the System by a stand-in whose steps only sleep."""

import time
from types import SimpleNamespace

import pytest
import torch

from admm_elastic_tpu_torch.ops.kernels import nh_local
from admm_elastic_tpu_torch.utils import profile_step

OWN = "void admm::nh::fused_kernel<float, 0>"


def _event(name, start, end):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA,
                           name=name,
                           time_range=SimpleNamespace(start=start, end=end))


def _scripted_tracer(windows):
    """A torch.profiler.profile stand-in: window i records the events
    windows[i][1] after bumping nh_local's launch counter by windows[i][0]
    (the launches the traced steps would have made on the card)."""
    script = iter(windows)

    class Tracer:
        def __init__(self, activities):
            self.bump, self.recorded = next(script)

        def __enter__(self):
            nh_local.nh_local_step_fused.launches += self.bump
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self.recorded

    return Tracer


@pytest.fixture
def system(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(nh_local.nh_local_step_fused, "launches", 0)
    return SimpleNamespace(run=lambda steps: time.sleep(1e-4),
                           _solver_mode="dia")


@pytest.mark.parametrize("windows,traced,busy_us,records,lost", [
    # every window empty: not measured, after every attempt
    ([(1, [])] * profile_step.ATTEMPTS, profile_step.ATTEMPTS, None, 0, 1),
    # an empty window, then a whole one
    ([(1, []), (1, [_event(OWN, 0.0, 4.0), _event("copy", 2.0, 6.0)])],
     2, 6.0, 2, 0),
    # a window that lost the kernel's record, then only empty ones: the
    # window with records is reported, with its loss
    ([(1, [_event("copy", 0.0, 3.0)])]
     + [(1, [])] * (profile_step.ATTEMPTS - 1),
     profile_step.ATTEMPTS, 3.0, 1, 1),
], ids=["all-empty", "empty-then-whole", "partial-then-empty"])
def test_profile_retraces_and_reports(system, monkeypatch, capsys, windows,
                                      traced, busy_us, records, lost):
    monkeypatch.setattr(torch.profiler, "profile", _scripted_tracer(windows))
    steps = 2
    out = profile_step.profile(5, steps, s=system)
    line = capsys.readouterr().out.splitlines()[0]
    assert out["traced_windows"] == traced
    assert out["lost_kernel_records"] == lost
    assert out["unprofiled_wall_ms_per_step"] > 0
    assert out["profiled_wall_ms_per_step"] > 0
    if busy_us is None:
        assert out["device_busy_ms_per_step"] is None
        assert out["idle_share"] is None
        assert out["device_ops_per_step"] is None
        assert "idle_share=not measured" in line
    else:
        assert out["device_busy_ms_per_step"] == pytest.approx(
            busy_us / 1e3 / steps)
        assert out["device_ops_per_step"] == records / steps
        assert "not measured" not in line


def test_profile_counts_the_multigrid_solve(monkeypatch, capsys):
    """A multigrid window's solve kernel is one of the port's own: a trace
    that holds its record is not taken again, and the line names the
    budget mgN."""
    from admm_elastic_tpu_torch.ops.kernels import banded_step

    class Tracer:
        def __init__(self, activities):
            pass

        def __enter__(self):
            banded_step.banded_rollout.ops += 1
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return [_event("void admm::mg::solve_kernel<float, "
                           "admm::dia::Rows<float> >", 0.0, 5.0)]

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(banded_step.banded_rollout, "ops", 0)
    monkeypatch.setattr(torch.profiler, "profile", Tracer)
    s = SimpleNamespace(run=lambda steps: time.sleep(1e-4),
                        _solver_mode="dia",
                        _stepper=SimpleNamespace(cfg=SimpleNamespace(
                            mg=object())))
    out = profile_step.profile(8, 1, "fast", s=s)
    assert out["traced_windows"] == 1 and out["lost_kernel_records"] == 0
    assert capsys.readouterr().out.startswith("[profile tet100k fast mg8]")
