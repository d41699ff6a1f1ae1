"""Runs with the timed path broken underneath come out not correct, and the
control (the reference in the program's place, in fp8 where the program
computes in bf16) fails a number that the program passes. At tiny sizes on
the CPU; the readings the limits were set from are the chip's, at the
cells' own sizes (``calibrate.py``, PERF.md)."""

import pytest
import torch

from portbench import calibrate, run
from portbench.tests import tiny
from tpurec_torch.train.trainer import DeviceBatch, Trainer

CPU = torch.device("cpu")
TRAIN = ["din_amazon.train", "deepfm_criteo.train_dense"]


def _run(workload):
    return run.run_cell(tiny.cell(workload), 2**31 + 5, 0.3, False, CPU, 0.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(workload, monkeypatch):
    def unchanged(self, state, batch, metric_state):
        with torch.no_grad():
            outputs = state.model.train()(batch)
            loss, _ = self._loss(outputs, batch, batch)
        return state, metric_state, {"loss": loss}

    monkeypatch.setattr(Trainer, "train_step", unchanged)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_on_half_of_the_batch_is_not_correct(workload, monkeypatch):
    step = Trainer.train_step

    def half(self, state, batch, metric_state):
        n = len(batch["label"]) // 2
        return step(self, state, DeviceBatch({k: v[:n] for k, v in batch.items()}), metric_state)

    monkeypatch.setattr(Trainer, "train_step", half)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_fails_a_number_the_program_passes(workload):
    # 1024 rows: at 64 the program's bf16 gradients of DeepFM are too few to
    # average out the rounding of the cells' 8192-row limit
    cell = tiny.cell(workload, batch=1024)
    sides = calibrate.train_sides(cell, 2**31 + 9, CPU, ["program", "control"])
    limits = cell.limits
    assert all(sides["program"][k] <= v for k, v in limits.items()), sides
    assert any(sides["control"][k] > v for k, v in limits.items()), sides
