"""The families' bf16 runs on the model axis drift from float32 no further
than one rank's bf16 runs do.

``chip_tp_drift.drift`` runs each family at ``chip_smoke.py``'s
serve_tp2_families depth and the config's reduced widths in bf16, from
seed 0: one rank's bf16 and float32 plain runs and a (data 1, model 2)
gloo world's bf16 plain run, each of three draws of the E2E rows (a
prefill and TP_FAMILY_STEPS decode steps).  The world's median request
(relative Frobenius error from the float32 run) must lie within
E2E_RATIO times the one-rank bf16 run's median request, or E2E_FLOOR:
the verdict ``serve_tp2_families`` applies to the kernel path on the
card.  Sublayer by sublayer (``chip_tp_drift.py --by-layer``: each
sublayer fed the one-rank float32 run's input, rounded to bf16) the
world's error from float32 must lie within E2E_RATIO times one rank's
wherever neither run picks other experts than float32 (a flipped
near-tied pick is a draw of the rounding, not of the split).  The
float32 parity (``test_torch_tensor_parallel_families.py``) holds the
split's arithmetic; this holds its rounding.
"""

import importlib
import os
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
drift_lib = importlib.import_module("chip_tp_drift")
chip_smoke = drift_lib.chip_smoke

DRAWS = 3


@pytest.fixture(scope="module")
def drift():
    return drift_lib.drift(tuple(drift_lib.FAMILIES), draws=DRAWS)


@pytest.mark.parametrize("name", tuple(drift_lib.FAMILIES))
def test_model_axis_bf16_drift_within_one_rank(drift, name):
    r = drift[name, 0]
    assert len(r["rows_kernel"]) == DRAWS * chip_smoke.E2E_ROWS
    assert r["limit"] == max(
        chip_smoke.E2E_RATIO * r["median_rel_err_plain_bf16_vs_f32"],
        chip_smoke.E2E_FLOOR)
    assert 0 < r["median_rel_err_kernel_vs_f32"] <= r["limit"], r


def test_model_axis_bf16_sublayers_within_one_rank():
    rows = drift_lib.by_layer(("dsv2", "jamba", "xlstm"))
    held = [r for r in rows
            if not r.get("flips_one_rank") and not r.get("flips_world")]
    assert len(held) >= len(rows) - 2, rows
    for r in held:
        assert 0 < r["world"] <= chip_smoke.E2E_RATIO * r["one_rank"], r
