"""Nothing the benchmark runs may load JAX or the JAX package: the check
compares whole top-level module names, and the reference loads nothing of
the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def test_the_check_compares_whole_top_level_names():
    f = harness.forbidden_modules
    assert f(["raytracing_gpu_tpu_torch", "raytracing_gpu_tpu_torch.ops.camera",
              "jax_like", "jaxtyping", "flaxen", "numpy"]) == []
    assert f(["raytracing_gpu_tpu", "raytracing_gpu_tpu.ops"]) == ["raytracing_gpu_tpu"]
    assert f(["jax", "jaxlib.xla_client", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def _loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] "
         "for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program_nor_jax():
    loaded = _loaded_after("import portbench.reference, portbench.scenes, portbench.kernels\n"
                           "portbench.scenes.shape({'shape': 'box', 'lo': [0, 0, 0], "
                           "'hi': [1, 1, 1]})")
    assert not set(loaded) & {"raytracing_gpu_tpu_torch", "raytracing_gpu_tpu", "jax",
                              "jaxlib", "flax"}


def test_the_harness_and_the_program_load_no_jax():
    loaded = _loaded_after(
        "import portbench.run, portbench.common, portbench.control\n"
        "import raytracing_gpu_tpu_torch, raytracing_gpu_tpu_torch.parallel\n"
        "from portbench import harness\n"
        "for m in ('frame_ms', 'sweep_ms.frame', 'sweep_roofline.frame'):\n"
        "    harness.reader(m)\n"
        "for k in ('frames', 'train'):\n"
        "    harness.plugin('traffic', k)")
    assert "raytracing_gpu_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "spheres-cpu512-frames", "--seed", str(2**31 + 3), "--seconds",
                          "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                           "HOME": str(ROOT)})
    assert out.returncode != 0 and out.stdout.strip() == ""
