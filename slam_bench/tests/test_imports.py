"""Nothing a run imports is jax, jaxlib, flax or the JAX package, compared
by whole top-level names; the plain reference imports nothing of the
program."""

import subprocess
import sys

from slam_bench import registry, run

RUN_IMPORTS = """
import sys
import slam_bench.run as r
from slam_bench import arith, registry, render, trace
from slam_bench.reference import frontend
import ppg_slam_tpu_torch.pipeline, ppg_slam_tpu_torch.utils
bench = registry.benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    registry.reader(m["name"])
print(",".join(r.forbidden_modules()))
"""


def python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_a_run_loads_no_jax():
    assert python(RUN_IMPORTS) == ""


def test_the_reference_imports_nothing_of_the_program():
    got = python("import sys; import slam_bench.reference.frontend; "
                 "import slam_bench.render, slam_bench.arith; "
                 "print(sorted(m for m in sys.modules "
                 "if m.split('.')[0].startswith('ppg_slam')))")
    assert got == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ppg_slam_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    base = set(run.forbidden_modules())
    assert "ppg_slam_tpu_torch_x" not in base and "jaxlibrary" not in base
    monkeypatch.setitem(sys.modules, "ppg_slam_tpu.ops", sys)
    assert "ppg_slam_tpu" in run.forbidden_modules()


def test_without_a_card_the_run_fails_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "slam_bench.run",
                          "--workload", "tumvi-cruise", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin",
                                           "HOME": str(tmp_path),
                                           "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
