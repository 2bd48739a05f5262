"""The comparison that decides ``correct``, at tiny sizes on the CPU: a
sound run of each cell comes out correct, and its control (the
reference one step below the stated precision put in the program's
place) comes out not correct under the cell's own limits."""
import pytest
import torch

from conftest import CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    _, _, config, traffic, limits, kind = tiny_cell(name)
    job = kind.Job(config, traffic, 3, torch.device("cpu"))
    answer, _ = job.run(0)
    control = kind.readings(job, answer, kind.control(job, answer))
    assert set(control) == set(limits)
    assert not all(control[k] <= limits[k] for k in limits), control
    sound = kind.readings(job, answer)
    assert all(sound[k] <= limits[k] for k in limits), sound
