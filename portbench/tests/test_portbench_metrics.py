"""The metric readers on a recorded context: each reads what it names, and
returns nothing (the metric is left out) where there is nothing sound to
read."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

PEAKS = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def _frames_ctx(**over):
    ctx = {"window": {"unit": "frame", "seconds": 2.0, "items": 10, "times": [0.2] * 9 + [0.3],
                      "events_ms": [190.0] * 10},
           "counters": {"scene_load_ms": 25.0, "capture_ms": 700.0, "steps_per_frame": 132.0},
           "profile": {"kernels": 5000, "items": 1, "ops": [
               ("void (anonymous namespace)::sweep_kernel<0>(float const*)", 0, 2_000_000),
               ("void (anonymous namespace)::sweep_list_kernel<long>(long*)", 0, 10_000),
               ("void (anonymous namespace)::fetch_rows_kernel<8>(float const*)", 0, 90_000),
               ("void at::native::vectorized_elementwise_kernel<4>()", 0, 5_000_000)]},
           "launches": {"nearest_hit": 1, "nearest_dist": 0, "fetch_rows": 1},
           "profile_launches": {"nearest_hit": 1, "nearest_dist": 0, "fetch_rows": 1},
           "work": {"pairs": 10**9, "rays": 10**6, "nearest_rays": 10**5, "triangles": 4812},
           "peaks": PEAKS}
    ctx.update(over)
    return ctx


def test_frame_readers_read_the_window_counters_and_trace():
    ctx = _frames_ctx()
    read = lambda m: harness.reader(m)(ctx)  # noqa: E731
    assert read("frame_ms") == pytest.approx(200.0)
    assert read("scene_load_ms") == 25.0 and read("capture_ms.frame") == 700.0
    assert read("bounce_steps.frame") == 132.0 and read("kernels_per_frame") == 5000
    assert read("sweep_ms.frame") == pytest.approx(2.1)
    least = max(60e9 / 67e12, (32e6 + 256e5 + 36 * 4812) / 3.35e12) * 1e3
    assert read("sweep_roofline.frame") == pytest.approx(least / 2.1 * 100)
    for m in ("step_ms", "capture_ms.train", "bounce_steps.train", "sweep_ms.train"):
        assert read(m) is None


def test_kernel_readers_say_nothing_where_the_launches_disagree():
    ctx = _frames_ctx(profile_launches={"nearest_hit": 2, "nearest_dist": 0, "fetch_rows": 1})
    for m in ("kernels_per_frame", "sweep_ms.frame", "sweep_roofline.frame"):
        assert harness.reader(m)(ctx) is None
    # the profile names fewer sweeps than were counted
    ctx = _frames_ctx(launches={"nearest_hit": 2, "fetch_rows": 1},
                      profile_launches={"nearest_hit": 2, "fetch_rows": 1})
    assert harness.reader("sweep_ms.frame")(ctx) is None


def test_train_readers():
    ctx = {"window": {"unit": "step", "seconds": 1.0, "items": 10, "times": [0.1] * 10},
           "counters": {"capture_ms": 3000.0, "k1_per_step": 24},
           "profile": {"items": 2, "ops": [("void sweep_kernel<1>(x)", 0, 4_000_000),
                                           ("void at::native::indexFuncLargeIndex<float>()", 0, 2_000_000),
                                           ("void at::native::elementwise_kernel<128>()", 0, 9_000_000)]}}
    read = lambda m: harness.reader(m)(ctx)  # noqa: E731
    assert read("step_ms") == pytest.approx(100.0) and read("capture_ms.train") == 3000.0
    assert read("bounce_steps.train") == 24 and read("sweep_ms.train") == pytest.approx(3.0)
    assert read("frame_ms") is None and read("kernels_per_frame") is None


def test_short_names_drop_namespaces_and_arguments():
    assert harness.short_name("void (anonymous namespace)::sweep_kernel<0>(float const*, int)") \
        == "sweep_kernel<0>"
    assert harness.short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
