"""Every public name of ppg_slam_tpu has a counterpart in ppg_slam_tpu_torch.

Both packages are read with `ast`, never imported. For each module of the
JAX package, its public functions, classes, class methods and UPPER_CASE
module constants must each be defined (or imported) under the same name in
the same module of the port; each environment variable the JAX package
reads must be read by the port too. What the port leaves out on purpose
stands in EXCLUDED / EXCLUDED_ENV below with its reason; an entry that no
longer names a gap fails the test, so the list stays true.

Private TPU workarounds are left out as well and need no entry here: the
slot-major and kf-major observation layouts (estimator/ba.py:103-141),
sharded_ba._shard_obs_layout and the _pow2 shape buckets.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "ppg_slam_tpu")
PORT_PKG = os.path.join(ROOT, "ppg_slam_tpu_torch")

_NET_API = ("the functional net API over a params pytree; the port's "
            "models.PPGNet (an nn.Module) holds the same layers as its "
            "submodules and its forward() is ppg_forward")
_TPU_TILING = ("a TPU tiling constant of the JAX decode; the port gathers "
               "directly (ROADMAP: TPU workarounds are not the contract)")

# (module, name) -> why the port has no counterpart
EXCLUDED = {
    ("models.ppg_net", "ppg_forward"): _NET_API,
    ("models.ppg_net", "ppg_forward_jit"): _NET_API + " (jax.jit of it)",
    ("models.ppg_net", "backbone_apply"): _NET_API,
    ("models.ppg_net", "junction_apply"): _NET_API,
    ("models.ppg_net", "heatmap_apply"): _NET_API,
    ("models.ppg_net", "descriptor_apply"): _NET_API,
    ("models", "ppg_forward"): _NET_API,
    ("models", "ppg_forward_jit"): _NET_API,
    ("models", "backbone_apply"): _NET_API,
    ("models", "junction_apply"): _NET_API,
    ("models", "heatmap_apply"): _NET_API,
    ("models", "descriptor_apply"): _NET_API,
    ("ops.pairs", "make_pair_tables"): (
        "the dense lex-ordered pair table; nothing in the JAX package "
        "calls it (probe_and_select enumerates pairs itself)"),
    ("ops.pairs", "PAIR_PAD"): "the padded length of make_pair_tables",
    ("ops.pairs", "POOL"): (
        "the fixed validation sample pool of the TPU decode; the port's "
        "validate_candidates and line_validate.cu size by the candidates"),
    ("ops.sampling", "remap_banded"): (
        "the banded heat remap, a TPU gather workaround; the port remaps "
        "with sampling.remap_bilinear (ops.heatmap.remap_heatmap's values)"),
    ("ops.sampling", "band_params"): "remap_banded's host-side band table",
    ("ops.sampling", "CHUNK"): _TPU_TILING,
    ("ops.sampling", "COLTILE"): _TPU_TILING,
    ("ops.sampling", "ROWCHUNK"): _TPU_TILING,
    ("parallel.sharded_ba", "AXIS"): (
        "the shard_map axis name; the port's parallel.Mesh is a list of "
        "devices with no named axis"),
}

# environment variables the JAX package reads -> why the port does not
EXCLUDED_ENV = {
    "PPG_DEFAULT_MATMUL": (
        "JAX-only configuration: opts out of the pinned float32 matmul "
        "precision; the port always runs true f32 (TF32 off)"),
    "PPG_PALLAS": (
        "selects the Pallas kernel off the TPU; the port launches its CUDA "
        "kernels on every CUDA tensor"),
    "PPG_FORCE_ONEHOT": "forces the one-hot MXU gathers (TPU workaround)",
    "PPG_FINE_BUCKETS": "pow2 shape buckets (TPU workaround)",
    "PPG_NO_PAD": "pow2 shape buckets (TPU workaround)",
    "PPG_SLOTS": "the slot-major observation layout (TPU workaround)",
    "PPG_BA_IMPLICIT_MIN_N": (
        "the implicit route's threshold over pow2 buckets; the port fixes "
        "estimator.ba.IMPLICIT_MIN_KF"),
    "PPG_BA_DEBUG": (
        "debug prints inside the JAX solver loop; the port's solve_ba "
        "returns its chi2 history instead"),
}


def _modules(pkg):
    """{dotted module name: path} of a package's .py files ('' for the
    package's own __init__)."""
    out = {}
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), pkg)[:-3]
                parts = rel.split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out[".".join(parts)] = os.path.join(dirpath, f)
    return out


def _tree(path):
    with open(path, encoding="utf-8") as f:
        return ast.parse(f.read(), path)


def public_names(path):
    """The public functions, classes, class methods (Class.method) and
    UPPER_CASE constants a module defines at its top level, and the public
    names its package __init__ re-exports."""
    tree = _tree(path)
    names = set()
    is_init = path.endswith("__init__.py")
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not m.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name)
                         and t.id.isupper() and not t.id.startswith("_"))
        elif is_init and isinstance(node, ast.ImportFrom) and node.level:
            names.update(a.asname or a.name for a in node.names
                         if not (a.asname or a.name).startswith("_"))
    return names


def bound_names(path):
    """Every name a module binds at its top level (definitions, class
    methods as Class.method, assignments and imports)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names.update(
                    f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def env_vars(pkg):
    """The environment variables a package reads by a literal name."""
    out = set()
    for path in _modules(pkg).values():
        for node in ast.walk(_tree(path)):
            if (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "getenv")
                    and "environ" in ast.unparse(node.func.value)
                    + node.func.attr):
                out.add(node.args[0].value)
    return out


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)


@pytest.mark.parametrize("module", sorted(JAX_MODULES))
def test_module_names_have_port_counterparts(module):
    assert module in PORT_MODULES, f"the port has no module {module!r}"
    have = bound_names(PORT_MODULES[module])
    missing = sorted(n for n in public_names(JAX_MODULES[module])
                     if n not in have and (module, n) not in EXCLUDED)
    assert not missing, f"{module or 'ppg_slam_tpu'}: no port counterpart " \
                        f"for {missing}"


def test_exclusions_name_real_gaps():
    """Each exclusion names a public JAX name the port lacks, and gives a
    reason."""
    for (module, name), why in EXCLUDED.items():
        assert why.strip(), (module, name)
        assert name in public_names(JAX_MODULES[module]), (module, name)
        assert name not in bound_names(PORT_MODULES[module]), (module, name)


def test_environment_options_have_counterparts():
    jax_env, port_env = env_vars(JAX_PKG), env_vars(PORT_PKG)
    assert "PPG_SLOTS" in jax_env  # the scan sees the JAX package's reads
    missing = sorted(jax_env - port_env - set(EXCLUDED_ENV))
    assert not missing, f"environment options without a port counterpart: " \
                        f"{missing}"
    for name, why in EXCLUDED_ENV.items():
        assert why.strip() and name in jax_env and name not in port_env, name


def test_the_checker_sees_a_missing_name(tmp_path):
    """public_names / bound_names on a pair of small modules: a method
    missing from the port's class is a gap; an imported name is not."""
    ref = tmp_path / "ref.py"
    ref.write_text("import os\nX_CAP = 4\n_PRIVATE = 1\n"
                   "def f():\n    pass\n"
                   "class C:\n    def m(self):\n        pass\n"
                   "    def _p(self):\n        pass\n")
    port = tmp_path / "port.py"
    port.write_text("from .other import f\nX_CAP = 4\nclass C:\n    pass\n")
    assert public_names(str(ref)) == {"X_CAP", "f", "C", "C.m"}
    assert public_names(str(ref)) - bound_names(str(port)) == {"C.m"}
