"""Every public name of the JAX package has a counterpart in the port.

Both packages are parsed with `ast`; neither is imported. A public name
of box2d_tpu/<m>.py (a function, class or assignment at module level
whose name does not start with "_"; names it imports are not its own)
must be defined or imported by box2d_tpu_torch/<m>.py, or stand on one
of the lists below with the reason it has no counterpart. A stale entry
(a name the JAX module no longer has, or one the port now has) fails
too. The ported functions are held to the JAX package in
tests/test_torch_public_names.py.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "box2d_tpu")
PORT_DIR = os.path.join(ROOT, "box2d_tpu_torch")

# modules that hold the TPU kernels: each became a CUDA source of the port
# with its own wrapper module
KERNEL_MODULES = {
    "particles_pallas.py": "ported as csrc/particles.cu, its wrappers and "
                           "twins in particles_kernels.py",
    "solver_pallas.py": "ported as csrc/contact_solver.cu and "
                        "csrc/joint_sweep.cuh, their wrappers and twins in "
                        "contact_solver.py (packers in solver.py, joints.py)",
}

_XLA_SOLVE = ("the XLA path's per-colour solve; the solver kernel "
              "(csrc/contact_solver.cu, csrc/joint_sweep.cuh) and its twin "
              "in contact_solver.py replace it")
NO_COUNTERPART = {
    "coloring.color_constraints": "nothing in the JAX package calls it; "
                                  "the step colors with repair_colors",
    "sleep.propagate_islands": "nothing in the JAX package calls it",
    "joints.solve_joints_color": _XLA_SOLVE,
    "joints.warm_start_joints_color": _XLA_SOLVE,
    "solver.integrate_positions": _XLA_SOLVE,
    "solver.integrate_velocities": _XLA_SOLVE,
    "solver.restitution_color": _XLA_SOLVE,
    "solver.solve_color": _XLA_SOLVE,
    "solver.warm_start_color": _XLA_SOLVE,
    "native.build_pairs_native": "renamed native.build_pairs",
    "native.build_triads_native": "renamed native.build_triads",
    "native.compute_hull_native": "geometry.compute_hull computes the hull "
                                  "(the quickhull in Python, no fast path)",
    "native.fill_box_native": "particles.fill_box walks the same loop",
}


def _names(path: str, with_imports: bool) -> set[str]:
    """Public names defined at the top level of a module (and those it
    imports, with_imports)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_")}


JAX_MODULES = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_public_names_have_a_counterpart(module):
    if module in KERNEL_MODULES:
        assert module.endswith("_pallas.py") and KERNEL_MODULES[module]
        return
    port = os.path.join(PORT_DIR, module)
    assert os.path.exists(port), f"box2d_tpu_torch/{module} is missing"
    have = _names(port, with_imports=True)
    stem = module[:-3]
    missing = sorted(n for n in _names(os.path.join(JAX_DIR, module), False)
                     - have if f"{stem}.{n}" not in NO_COUNTERPART)
    assert not missing, (f"box2d_tpu/{module}: no counterpart in "
                         f"box2d_tpu_torch/{module} for {missing}")


def test_exclusions_are_current():
    """Every excluded name exists in the JAX module, has no counterpart in
    the port, and carries a reason."""
    for key, reason in NO_COUNTERPART.items():
        stem, name = key.split(".")
        assert reason.strip(), key
        assert name in _names(os.path.join(JAX_DIR, stem + ".py"), False), (
            f"{key}: not a public name of the JAX package")
        assert name not in _names(os.path.join(PORT_DIR, stem + ".py"),
                                  True), f"{key}: the port has it now"
    assert set(KERNEL_MODULES) <= set(JAX_MODULES)
