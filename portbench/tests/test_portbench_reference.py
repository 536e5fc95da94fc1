"""The plain reference and the work count, on the CPU: the count rule on a
hand-made two-triangle scene, the reference against the program on small
frames and training steps, and the control (the reference in TF32) failing
the cells' limits."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, reference, run, scenes  # noqa: E402
from portbench.tests.conftest import small  # noqa: E402


def _two_triangles():
    """Object 0: the lower-left half of the square [-1,1]^2 at z = 5;
    object 1: the same at z = 10. Rays start at z = 0 along +z."""
    tri = lambda z: np.array([[[-1, -1, z], [1, -1, z], [-1, 1, z]]], np.float32)  # noqa: E731
    nrm = np.array([[[0, 0, -1]] * 3], np.float32)
    objs = [scenes.Obj(tri(z), nrm, np.zeros(3, np.float32), np.zeros(3, np.float32),
                       np.zeros(3, np.float32), 1.0, 0.0) for z in (5.0, 10.0)]
    arrays = scenes.SceneArrays(4, 4, np.zeros(3, np.float32), np.array([1, 0, 0], np.float32),
                                np.array([0, 1, 0], np.float32), 90.0, (0,),
                                np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), objs)
    return reference.ref_scene(arrays, "cpu")


def test_work_count_takes_the_boxes_entered_before_the_nearest_hit():
    tracer = reference.Tracer(_two_triangles(), count=True)
    o = torch.tensor([[-0.2, -0.3, 0.0], [-0.5, -0.5, 0.0], [0.8, 0.8, 0.0], [5.0, 5.0, 0.0],
                      [reference.PARKED] * 3])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4 + [[0.0, 0.0, 0.0]])
    dist, win = tracer.nearest(o, d)
    # hits on object 0 at t = 5; (0.8, 0.8) is in both boxes but on neither
    # triangle; (5, 5) misses both boxes; the parked ray traces nothing
    assert torch.equal(torch.isfinite(dist), torch.tensor([True, True, False, False, False]))
    assert win[:2].tolist() == [0, 0] and dist[1].item() == 5.0
    assert tracer.pairs == 1 + 1 + 2 + 0 and tracer.rays == 4
    # a shadow ray stops at its nearest occluder, or at its limit (a point
    # light at t = 1 along d): only the boxes entered before it count
    tracer.pairs = 0
    occ = tracer.occluded(o[:3], torch.tensor([[0.0, 0.0, 20.0], [0.0, 0.0, 7.0],
                                               [0.0, 0.0, 7.0]]),
                          torch.tensor([1.0, 1.0, 1.0]))
    assert occ.tolist() == [True, True, False]
    assert tracer.pairs == 1 + 1 + 1


def test_the_other_order_on_ties_takes_the_highest_index():
    sc = _two_triangles()
    sc.V[1] = sc.V[0]  # object 1 now lies on object 0: every hit is a tie
    o, d = torch.tensor([[-0.5, -0.5, 0.0]]), torch.tensor([[0.0, 0.0, 1.0]])
    assert reference.Tracer(sc).nearest(o, d)[1].tolist() == [0]
    assert reference.Tracer(sc, last_on_tie=True).nearest(o, d)[1].tolist() == [1]


@pytest.mark.parametrize("name", ["spheres-cpu512-frames", "spheres-gpu3-frames"])
def test_the_program_matches_the_reference_on_small_frames(name):
    cell = small(name, 8 if "gpu" not in name else 6)
    result, checks = run.run(name, 2**31 + 77, 0.2, False, device="cpu", cell=cell,
                             t_start=0.0)
    # exact ties between triangles that share an edge go to the lowest
    # clustered slot in the program and to the lowest file index here: on
    # these few-triangle spheres a mirror ray through such an edge can end
    # elsewhere, a few channel values in a frame
    assert checks["frames_differ"][0] == 0.0 and checks["mismatch_pct"][0] < 1.5


def test_the_program_matches_the_reference_on_small_training_steps():
    cell = small("spheres-train256-steps", 8)
    result, checks = run.run(cell.name, 2**31 + 78, 0.2, False, device="cpu", cell=cell,
                             t_start=0.0)
    assert result["correct"], checks
    assert checks["first_loss_gap"][0] < 1e-5 and checks["grad_gap"][0] < 1e-5


@pytest.mark.parametrize("name", ["spheres-cpu512-frames", "spheres-gpu3-frames"])
def test_the_control_fails_the_frame_limits(name):
    cell = small(name, 16 if "gpu" not in name else 8)
    arrays = scenes.build(cell.config, cell.traffic["width"], cell.traffic["height"], 5)
    pix = torch.arange(arrays.width * arrays.height)
    ref = reference.frame_pixels(reference.ref_scene(arrays, "cpu"), cell.traffic["render"], pix)
    low = reference.frame_pixels(reference.ref_scene(arrays, "cpu", reference.round_tf32),
                                 cell.traffic["render"], pix)
    mismatch = float(((ref.long() - low.long()).abs() > 0).float().mean() * 100.0)
    assert mismatch > cell.check["limits"]["mismatch_pct"]


def test_the_control_and_the_half_batch_fail_the_training_limits():
    cell = small("spheres-train256-steps", 8)
    arrays = scenes.build(cell.config, 8, 8, 5)
    tr = cell.traffic
    train = harness.plugin("traffic", "train")
    start = train.perturbed_start(arrays, tr["perturb"], 5)
    ref = reference.train_steps(arrays, tr["render"], start, tr["free"], 3, "cpu")
    limits = cell.check["limits"]
    for got in (reference.train_steps(arrays, tr["render"], start, tr["free"], 3, "cpu",
                                      q=reference.round_tf32),
                reference.train_steps(arrays, tr["render"], start, tr["free"], 3, "cpu",
                                      pixels=torch.arange(32))):
        gaps = {"first_loss_gap": abs(got["losses"][0] - ref["losses"][0]) / ref["losses"][0],
                "grad_gap": train.gaps(got["grads"], ref["grads"])[0],
                "change_gap": train.gaps({k: got["params"][k] - start[k] for k in tr["free"]},
                                          {k: ref["params"][k] - start[k] for k in tr["free"]})[0]}
        assert any(gaps[k] > limits[k] for k in gaps), gaps


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.5, 3e29, 0.0])
    y = reference.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -2.5, y[5].item(), 0.0]
    assert abs(y[5].item() / 3e29 - 1) < 2**-11
