"""OVCOS class-aware metric parity against the REFERENCE'S OWN metricer.

Oracle: `/root/reference/recorder/ovcos_metricer.py` loaded verbatim with its
py_sod_metrics bases supplied by the reference's `recorder/sod_metric.py`
(see tests/_reference_oracle.load_ref_ovcos). Checks `calc_ovcamo` and the
accumulating `OVCOSMetricer.show()` on random, degenerate (empty/full GT,
constant pred) and class-mismatch inputs at 1e-8.
"""

import numpy as np
import pytest

from camouflaged_vlm_tpu.metrics import OVCOSMetricer, calc_ovcamo

from _reference_oracle import load_ref_ovcos

KEYS = ("sm", "wfm", "mae", "adpfm", "maxfm", "avgfm",
        "adpem", "maxem", "avgem", "adpiou", "maxiou", "avgiou")


def _maps(rng, h=48, w=40, fg_frac=0.3, const_pred=None):
    gt = ((rng.random((h, w)) < fg_frac) * 255).astype(np.uint8)
    if const_pred is None:
        pred = rng.random((h, w)) * 255
        pred = (0.55 * pred + 0.45 * gt).astype(np.uint8)
    else:
        pred = np.full((h, w), const_pred, np.uint8)
    return pred, gt


@pytest.mark.parametrize(
    "fg_frac,const_pred,match",
    [
        (0.3, None, True),
        (0.3, None, False),   # class mismatch: zeroing (MAE -> 1)
        (0.0, None, True),    # empty GT
        (1.0, None, True),    # full GT
        (0.3, 0, True),       # constant-zero pred
        (0.3, 255, True),     # constant-one pred
        (0.05, None, True),
    ],
)
def test_calc_ovcamo_matches_reference(fg_frac, const_pred, match):
    ref = load_ref_ovcos()
    rng = np.random.default_rng(11)
    pred, gt = _maps(rng, fg_frac=fg_frac, const_pred=const_pred)
    pre_cls, gt_cls = ("cat", "cat") if match else ("dog", "cat")

    want = ref.calc_ovcamo(pred, gt, pre_cls, gt_cls)
    got = calc_ovcamo(pred, gt, pre_cls, gt_cls)
    for k in KEYS:
        np.testing.assert_allclose(got[k], float(want[k]), atol=1e-8, err_msg=k)


def test_metricer_aggregation_matches_reference():
    """Multi-image accumulation: adp means, curve-mean-then-max/mean."""
    ref_mod = load_ref_ovcos()
    rng = np.random.default_rng(5)
    ref = ref_mod.OVCOSMetricer(class_names=["a", "b", "c"])
    ours = OVCOSMetricer(class_names=["a", "b", "c"], num_workers=2)

    cases = [
        (*_maps(rng, 64, 64, 0.4), "a", "a"),
        (*_maps(rng, 50, 70, 0.2), "b", "a"),   # mismatch
        (*_maps(rng, 33, 41, 0.0), "c", "c"),   # empty gt
        (*_maps(rng, 64, 64, 0.9), "b", "b"),
        (*_maps(rng, 40, 40, 0.5, const_pred=128), "c", "c"),
    ]
    for pred, gt, pc, gc in cases:
        ref.step(pred, gt, pc, gc)
        ours.step(pred, gt, pc, gc)

    want = ref.show(num_bits=8)
    got = ours.show(num_bits=8)
    assert set(KEYS).issubset(got)
    for k in KEYS:
        np.testing.assert_allclose(got[k], float(want[k]), atol=1e-6, err_msg=k)
