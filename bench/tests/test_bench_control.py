"""The readings the limits are set from (``bench/calibrate.py``), at a size a
test run holds: on the tiny cells the program agrees with the reference,
and the float8 control and the faults read far above it."""

from __future__ import annotations

import pytest

from bench import calibrate


@pytest.fixture()
def context(tiny_root, monkeypatch):
    monkeypatch.setattr(calibrate, "ROOT", tiny_root)

    def make(workload):
        ctx = calibrate._context(workload, 2**31 + 5)
        ctx.device = "cpu"
        return ctx

    return make


def test_train_readings(context):
    sound = calibrate.train_readings(context("dense-tiny.train-tiny"), False)["program"]
    broken = calibrate.train_readings(context("dense-tiny.train-tiny"), True)
    for name, value in sound.items():
        assert value < 1e-4
        assert broken["half_batch"][name] > 100 * max(value, 1e-7)
    assert max(broken["control"][k] / max(sound[k], 1e-7) for k in sound) > 100


def test_serve_readings(context):
    out = calibrate.serve_readings(context("dense-tiny.serve-tiny"), True)
    assert out["program"]["token_gap"] < 1e-4 < out["control"]["token_gap"]
    assert out["off_by_one"]["token_gap"] > 1.0 and out["checked_tokens"] >= 16
