"""The harness's run with the timed path broken underneath sees ``correct``
come out false, for each fault a cell can have: a step that leaves the
state unchanged; half of the batch left out, the mean taken over the rest;
an answer altered where it is produced.  (The cells run on one card: no
exchange between chips to leave out.)  A sound run of the same cell
comes out true."""
import pytest
import torch

from wire_tpu_torch.nn.models import INR
from wire_tpu_torch.operators.radon import RadonOp
from wire_tpu_torch.train import trainer

from benchmark import calibrate
from benchmark.tests import short

CELLS = list(short.CELLS)


def _unchanged(monkeypatch, cell):
    monkeypatch.setattr(trainer.Adam, "step", lambda self, p, g: None)


def _half_step(real):
    """The step's gradients over the first half of the rows, the mean
    taken over those; its prediction and sums over all rows."""
    def step(self, params, coords, target, **kw):
        pred, _, sums = real(self, params, coords, target, **kw)
        n = target.shape[-2] // 2
        c = target.shape[-1]
        half = dict(kw, gt=None if kw.get("gt") is None
                    else kw["gt"][..., :n, :], denom=float(n * c))
        _, grads, _ = real(self, params, coords[..., :n, :],
                           target[..., :n, :], **half)
        return pred, grads, sums
    return step


def _half(monkeypatch, cell):
    if cell == "wire300.ct":
        real = RadonOp.__call__

        def call(self, field):
            est = real(self, field)
            a = est.shape[-2] // 2
            return torch.cat([est[..., :a, :], est[..., a:, :].detach()], -2)
        monkeypatch.setattr(RadonOp, "__call__", call)
    else:
        monkeypatch.setattr(INR, "step_grads", _half_step(INR.step_grads))
        monkeypatch.setattr(INR, "step_grads_many",
                            _half_step(INR.step_grads_many))


def _answer(monkeypatch, cell):
    monkeypatch.setattr(trainer, "_keep_best",
                        calibrate.altered_keep_best(trainer))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _unchanged, _half, _answer])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    s = short.cell_run(cell, monkeypatch)
    if fault is not None:
        fault(monkeypatch, cell)
    correct, rows = short.run(s, 2 ** 31 + 77)
    assert correct is (fault is None), rows
