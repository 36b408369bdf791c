"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; a sound run comes out correct.  No cell
runs a batch or spans chips, so none can leave out half a batch or an
exchange between them."""
import pytest

from portbench.tests import tiny


def _unchanged_state(monkeypatch):
    from repro_torch.core.functions import facility_location as fl

    for cls in (fl.FacilityLocation, fl.FacilityLocationMF):
        monkeypatch.setattr(cls, "update", lambda self, state, j: state)


def _altered_answer(monkeypatch):
    """The middle pick of every answer moved to another index as the greedy
    writes it out."""
    from repro_torch.core.optimizers import greedy, spec

    impl = greedy._naive_impl

    def altered(fns, *a, **k):
        res = impl(fns, *a, **k)
        n = fns[0].n
        col = res.order.shape[1] // 2
        res.order[:, col] = (res.order[:, col] + n // 2) % n
        return res

    monkeypatch.setattr(greedy, "_naive_impl", altered)
    monkeypatch.setattr(spec, "_naive_impl", altered)


FAULTS = {"unchanged_state": _unchanged_state, "altered_answer": _altered_answer}
CASES = [(c, f) for c in tiny.CELLS for f in FAULTS]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_sound_run_is_correct(name):
    _, checks, line = tiny.run(tiny.cell(name))
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    _, checks, line = tiny.run(tiny.cell(name))
    assert line["correct"] is False, checks
