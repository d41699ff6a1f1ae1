"""The plain references against the port on the CPU at tiny sizes, where
the port's kernel wrappers run their plain versions: three steps of DIN and
DeepFM in the dense engine, with the port in
fp32 (the reference's precision) and in bf16 (the configuration's)."""


import pytest
import torch

from portbench.lib import check, spec
from portbench.lib.trace import Tracer
from portbench.reference.common import make_weights, train_readings
from portbench.tests import tiny

CPU = torch.device("cpu")


def _train_numbers(workload, dtype):
    c = tiny.cell(workload)
    c.config["compute_dtype"] = dtype
    driver = spec.load_module("drivers", "train").Driver(c, 4242, CPU, Tracer(False))
    driver.setup()
    weights = make_weights(driver.reference.layout(c.config), 4242, CPU)
    ref = train_readings(driver.reference.forward, c.config, weights, driver.pool[:3], CPU)
    return check.train_numbers(driver.readings, ref)


@pytest.mark.parametrize("workload", ["din_amazon.train", "deepfm_criteo.train_dense"])
def test_three_steps_agree_in_fp32(workload):
    n = _train_numbers(workload, "float32")
    assert n["loss_gap"] < 1e-6 and n["grad_gap"] < 1e-5 and n["change_gap"] < 1e-3, n


@pytest.mark.parametrize("workload", ["din_amazon.train", "deepfm_criteo.train_dense"])
def test_three_steps_in_bf16_stay_within_bf16_rounding(workload):
    n = _train_numbers(workload, "bfloat16")
    assert n["loss_gap"] < 2e-3 and n["grad_gap"] < 2e-2 and n["change_gap"] < 5e-2, n


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for kind in ("reference", "work"):
        for path in (spec.PACKAGE / kind).glob("*.py"):
            for node in ast.walk(ast.parse(path.read_text())):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                for name in names:
                    assert name.split(".")[0] not in ("tpurec_torch", "tpurec", "jax", "jaxlib", "flax"), path
