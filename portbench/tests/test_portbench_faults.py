"""The check catches a broken timed path: a whole run on the CPU at a small
size, the card's look skipped, with the program broken underneath, must
come out not correct: frames altered where they are produced (in every
frame, or in every other one) or with half of the image's rays left out;
a training step that leaves its state unchanged, or that takes half of the
batch (the mean over the rest)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402
from portbench.tests.conftest import small  # noqa: E402


def _row_altered(img):
    out = img.clone()
    out[0] = torch.where(out[0] < 128.0, out[0] + 1.0, out[0] - 1.0)
    return out


def _half_left_out(img):
    out = img.clone()
    out[img.shape[0] // 2:] = 0.0
    return out


def _every_other(fault):
    calls = []

    def f(img):
        calls.append(1)
        return fault(img) if len(calls) % 2 else img
    return f


def _pixel_altered(img):
    out = img.clone()
    out[1, 2, 0] = 255.0 - out[1, 2, 0]
    return out


@pytest.mark.parametrize("fault, failing", [
    (lambda: _row_altered, "mismatch_pct"),
    (lambda: _half_left_out, "mismatch_pct"),
    (lambda: _every_other(_pixel_altered), "frames_differ"),
])
def test_a_broken_frame_is_not_correct(fault, failing):
    cell = small("spheres-cpu512-frames", 8)
    # a window long enough for several frames
    result, checks = run.run(cell.name, 2**31 + 91, 2.5, False, device="cpu", cell=cell,
                             fault=fault(), t_start=0.0)
    assert not result["correct"]
    assert checks[failing][0] > checks[failing][1]


def _unchanged(step_fn):
    def step(state, scene, coords, target):
        keep = {k: p.detach().clone() for k, p in state.params.items()}
        state, loss = step_fn(state, scene, coords, target)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(keep[k])
        return state, loss
    return step


def _half_batch(step_fn):
    def step(state, scene, coords, target):
        n = target.shape[0] // 2
        return step_fn(state, scene, coords[:4 * n], target[:n])
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_training_step_is_not_correct(fault):
    cell = small("spheres-train256-steps", 8)
    result, checks = run.run(cell.name, 2**31 + 92, 0.2, False, device="cpu", cell=cell,
                             fault=fault, t_start=0.0)
    assert not result["correct"], checks
