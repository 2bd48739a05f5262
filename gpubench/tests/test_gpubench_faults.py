"""The harness with the timed path broken underneath, at tiny sizes on
the CPU: each fault that a cell's job kind lists (``FAULTS`` of
``jobs/<kind>.py``) makes ``correct`` come out false.  (The cells run on
one card, so there is no exchange between chips to leave out.)"""
import pytest

from conftest import FAULTS, run_tiny, tiny_cell


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f}" for n, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, name, fault):
    kind = tiny_cell(name)[-1]
    kind.FAULTS[fault](monkeypatch)
    result = run_tiny(name)
    assert not result["correct"], result["checks"]
