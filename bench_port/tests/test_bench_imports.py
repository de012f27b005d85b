"""Nothing the benchmark loads has the top-level name jax, jaxlib, flax or
box2d_tpu (compared whole: box2d_tpu_torch is the port), and its
reference loads nothing of box2d_tpu_torch."""

import os
import subprocess
import sys

from harness import registry

REPO = os.path.dirname(registry.ROOT)


def _modules_after(code):
    prog = (f"import sys\nsys.path[:0] = [{registry.ROOT!r}, {REPO!r}]\n"
            + code + "\nprint(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    top = _modules_after(
        "sys.path.insert(0, " + repr(os.path.join(registry.ROOT, "tests"))
        + ")\nimport tiny\nfor n in tiny.SIZES: tiny.run(n, seconds=0.05)\n"
        "from harness import cli\nassert cli.forbidden_modules() == []")
    assert not {"jax", "jaxlib", "flax", "box2d_tpu"} & set(top)
    assert "box2d_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    top = _modules_after(
        "import reference.tank_column, reference.water")
    assert not {"jax", "jaxlib", "flax", "box2d_tpu",
                "box2d_tpu_torch"} & set(top)


def test_forbidden_names_compare_whole():
    from harness import cli

    sys.modules.setdefault("box2d_tpu_torch_x", sys)
    try:
        assert "box2d_tpu" not in cli.forbidden_modules()
    finally:
        del sys.modules["box2d_tpu_torch_x"]
