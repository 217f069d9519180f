"""Import isolation of the PyTorch port.

`paddle_tpu_torch`, `chip_smoke.py`, the port's probes
(`tools/torch_*.py`) and the op-case table chip_smoke reads
(`tests/torch_op_cases.py`) must run where JAX is absent:
they import neither `jax` (nor `jaxlib`) nor the JAX package
`paddle_tpu`, not even one of its JAX-free modules.  Two guards: a fresh
interpreter imports every submodule and chip_smoke's import graph and
then finds no such module in `sys.modules`; an AST scan finds no such
import statement (including lazy ones inside functions).
"""
import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
sys.path.insert(0, "tests")
import torch_op_cases
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print("FORBIDDEN=" + ",".join(bad))
"""


def _forbidden(name):
    return (name or "").split(".")[0] in ("jax", "jaxlib", "paddle_tpu")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    tools = os.path.join(ROOT, "tools")
    for f in sorted(os.listdir(tools)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(tools, f)
    yield os.path.join(ROOT, "tests", "torch_op_cases.py")


def test_fresh_import_loads_no_jax_and_no_paddle_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("FORBIDDEN=")][-1]
    assert line == "FORBIDDEN=", line


def test_no_source_imports_jax_or_paddle_tpu():
    offenders = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", None))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            offenders += [(os.path.relpath(path, ROOT), node.lineno, n)
                          for n in names if _forbidden(n)]
    assert not offenders, offenders


# the modules of the sparse CTR slice: each walked by the fresh-import
# probe and the AST scan above, and importable alone with no JAX loaded
SPARSE_CTR_MODULES = ("paddle_tpu_torch.core.lod",
                      "paddle_tpu_torch.learning_rate_decay",
                      "paddle_tpu_torch.models.ctr",
                      "paddle_tpu_torch.optimizer",
                      "paddle_tpu_torch.ops.optimizer_ops")


@pytest.mark.parametrize("module", SPARSE_CTR_MODULES)
def test_sparse_ctr_module_is_scanned_and_imports_alone(module):
    path = os.path.join(ROOT, *module.split(".")) + ".py"
    assert path in set(_sources())
    probe = (f"import sys, {module}\n"
             "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
             "('jax', 'jaxlib', 'paddle_tpu'))\n"
             "print('FORBIDDEN=' + ','.join(bad))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "FORBIDDEN="


# the port's C, C++ and CUDA sources: the native runtime (and its C
# inference ABI, which embeds the interpreter) and the kernels.  A
# kernel's source names the TPU kernel it replaces by file
# (paddle_tpu/kernels/<file>.py, as the guide to the kernels asks); no
# source names a module of the JAX package (paddle_tpu.<module>), and the
# native runtime's name the JAX package in no form
NATIVE_SRC = os.path.join(PKG, "native", "src")
C_SOURCE_DIRS = (NATIVE_SRC, os.path.join(PKG, "kernels", "csrc"))
_JAX_MODULE = re.compile(r"\bpaddle_tpu(?!_torch)\.\w")
_JAX_PACKAGE_NAME = re.compile(r"\bpaddle_tpu(?!_torch)(?=[./\"'\s:]|$)")


def _c_sources():
    for d in C_SOURCE_DIRS:
        for f in sorted(os.listdir(d)):
            if f.endswith((".c", ".cc", ".h", ".cu", ".cuh")):
                yield os.path.join(d, f)


def test_c_sources_name_no_module_of_the_jax_package():
    """No C source imports or names a module of paddle_tpu (the extern-C
    names paddle_tpu_inference_* are the ABI's, not a module); the C
    inference ABI imports the port's runtime."""
    offenders, imports = [], []
    for path in _c_sources():
        native = os.path.dirname(path) == NATIVE_SRC
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _JAX_MODULE.search(line) or (
                        native and _JAX_PACKAGE_NAME.search(line)):
                    offenders.append((os.path.relpath(path, ROOT), i, line))
                imports += re.findall(r'PyImport_ImportModule\("([^"]+)"\)',
                                      line)
    assert not offenders, offenders
    assert imports == ["paddle_tpu_torch.capi_runtime"]
    assert len(list(_c_sources())) >= 10


# the user-facing tools (A10c): each walked by the fresh-import probe and
# the AST scan above, importable alone with no JAX loaded, and loading
# none of the optional packages the card's machine lacks (PIL,
# matplotlib) or the corpora's own (sklearn, nltk, scipy) at import
A10C_MODULES = ("paddle_tpu_torch.cli", "paddle_tpu_torch.debugger",
                "paddle_tpu_torch.image", "paddle_tpu_torch.plot",
                "paddle_tpu_torch.profiler", "paddle_tpu_torch.dataset",
                "paddle_tpu_torch.dataset.common",
                "paddle_tpu_torch.dataset.flowers",
                "paddle_tpu_torch.dataset.voc2012",
                "paddle_tpu_torch.dataset.sentiment")


_OPTIONAL_PROBE = r"""
import importlib, sys
tops = ("jax", "jaxlib", "paddle_tpu", "PIL", "matplotlib", "sklearn",
        "nltk", "scipy")
for m in sys.argv[1:]:
    importlib.import_module(m)
    bad = sorted(n for n in sys.modules if n.split(".")[0] in tops)
    print(m + " FORBIDDEN=" + ",".join(bad))
"""


@pytest.fixture(scope="module")
def tools_imports():
    """One fresh interpreter importing the tools modules in turn -> {module:
    the forbidden modules loaded once it was imported}."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _OPTIONAL_PROBE,
                          *A10C_MODULES], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(ln.split(" ", 1) for ln in res.stdout.splitlines()
                if " FORBIDDEN=" in ln)


@pytest.mark.parametrize("module", A10C_MODULES)
def test_tools_module_is_scanned_and_imports_alone(module, tools_imports):
    path = os.path.join(ROOT, *module.split("."))
    path = (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")
    assert path in set(_sources())
    assert tools_imports[module] == "FORBIDDEN="


def _jax_all(*parts):
    """The `__all__` list of a JAX package module, read from its source
    (not imported)."""
    path = os.path.join(ROOT, "paddle_tpu", *parts)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def test_cloud_cluster_is_scanned_and_clouds_names_are_the_jax_packages():
    """cloud/cluster.py (the elastic cluster) is in the scanned sources,
    imports alone with no JAX, and the port's `cloud` names are the JAX
    package's — its `__all__` and those of its master, registry,
    cluster, router and autoscaler modules — every one of them working,
    the serving front door's (router, autoscaler) included."""
    path = os.path.join(PKG, "cloud", "cluster.py")
    assert path in set(_sources())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _OPTIONAL_PROBE, "paddle_tpu_torch.cloud",
         "paddle_tpu_torch.cloud.cluster"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    for ln in res.stdout.splitlines():
        mod, found = ln.split(" ", 1)
        assert not [m for m in found.split("=", 1)[1].split(",")
                    if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                    and m], ln
    import paddle_tpu_torch.cloud as cloud

    front_door = {"ReplicaRouter", "NoReplicasAvailable", "Autoscaler",
                  "AutoscalerPolicy", "SubprocessReplicaLauncher"}
    jax_names = set(_jax_all("cloud", "__init__.py"))
    for mod in ("master.py", "registry.py", "cluster.py"):
        jax_names |= set(_jax_all("cloud", mod))
    front_door_modules = set()
    for mod in ("router.py", "autoscaler.py"):
        front_door_modules |= set(_jax_all("cloud", mod))
    assert front_door <= front_door_modules
    jax_names.discard("task_record_reader")
    port = set(cloud.__all__)
    assert jax_names <= port | {"task_record_reader"}
    assert port - jax_names <= {"task_record_reader",
                                "resolve_pserver_cluster"}
    assert front_door <= jax_names
    for name in sorted(port):
        assert getattr(cloud, name) is not None, name
    import paddle_tpu_torch.cloud.autoscaler as autoscaler
    import paddle_tpu_torch.cloud.router as router

    assert set(_jax_all("cloud", "router.py")) == set(router.__all__)
    assert set(_jax_all("cloud", "autoscaler.py")) == set(
        autoscaler.__all__)


# the modules of the fleet slice (the telemetry plane and the serving
# fleet): each walked by the fresh-import probe and the AST scan above,
# importable alone with no JAX loaded, with the JAX module's `__all__`
FLEET_MODULES = ("paddle_tpu_torch.observability.timeseries",
                 "paddle_tpu_torch.observability.exporters",
                 "paddle_tpu_torch.observability.slo",
                 "paddle_tpu_torch.observability.collector",
                 "paddle_tpu_torch.serving.replica",
                 "paddle_tpu_torch.cloud.router",
                 "paddle_tpu_torch.cloud.autoscaler")


@pytest.fixture(scope="module")
def fleet_imports():
    """Each fleet module imported alone in a fresh interpreter (all of
    them at once) -> {module: the forbidden modules loaded once it was
    imported}."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {module: subprocess.Popen(
        [sys.executable, "-c", _OPTIONAL_PROBE, module], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for module in FLEET_MODULES}
    out = {}
    for module, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=180)
        assert proc.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines()
                if " FORBIDDEN=" in ln][-1]
        out[module] = line.split(" ", 1)[1]
    return out


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_module_is_scanned_and_imports_alone(module, fleet_imports):
    import importlib

    parts = module.split(".")
    path = os.path.join(ROOT, *parts) + ".py"
    assert path in set(_sources())
    found = fleet_imports[module].split("=", 1)[1]
    assert not [m for m in found.split(",")
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                and m], found
    mod = importlib.import_module(module)
    assert set(mod.__all__) == set(_jax_all(parts[1], parts[2] + ".py"))
