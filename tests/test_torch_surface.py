"""The port's public surface against the JAX package's, and its self-tests.

Every public top-level name (a def, a class or an assignment) and every
``__all__`` entry of each JAX module has a counterpart of the same name
in the port's module of the same path, except the written allow-list
below. The JAX names are read from source (no JAX import); the port's
are looked up on the imported module, so a lazily exported name counts.
``lua_mapreduce_tpu_torch.utest()`` (the reference's ``mapreduce.utest()``,
test.lua:30-39) passes on the CPU, and each module self-test is a case
of one parametrised test.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "lua_mapreduce_tpu")
PORT_PKG = os.path.join(REPO, "lua_mapreduce_tpu_torch")

# JAX modules and names with no counterpart, each with its reason
NO_COUNTERPART_MODULES = {
    "utils/jax_compat.py": "JAX version shims; the port imports no JAX",
    "utils/jax_env.py": "JAX backend selection and its CPU fallback; the "
                        "port's is device.py::resolve_device, which never "
                        "falls back",
}
NO_COUNTERPART_NAMES = {
    ("ops/__init__.py", "out_struct"):
        "a jax.ShapeDtypeStruct for a pallas_call's output; the port's "
        "wrappers allocate their outputs with torch.empty",
    ("ops/__init__.py", "default_backend"):
        "the port picks the kernel or the plain version by the tensor's "
        "device (ops/__init__.py::device_kind), not by a backend name",
    ("ops/__init__.py", "resolve_backend"):
        "the same: no backend names in the port",
    ("parallel/zero1.py", "state_specs"):
        "jax PartitionSpec trees; the port's ZeRO-1 shards by rank",
    ("analysis/rules.py", "JaxPurityRule"):
        "LMR007 polices the port's graph captures instead: "
        "rules.CapturePurityRule",
    ("analysis/dataflow.py", "JIT_TRACE"):
        "LMR017's seed is a graph capture: dataflow.CAPTURE",
}


def _jax_modules():
    out = []
    for dirpath, _dirs, files in os.walk(JAX_PKG):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f),
                                           JAX_PKG).replace(os.sep, "/"))
    return sorted(out)


def _public_names(path):
    """(public top-level names, ``__all__``) of a module, from source."""
    tree = ast.parse(open(path).read())
    names, exported = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for leaf in ast.walk(target):
                    if not isinstance(leaf, ast.Name):
                        continue
                    if leaf.id == "__all__":
                        exported = set(ast.literal_eval(node.value))
                    names.add(leaf.id)
    return {n for n in names if not n.startswith("_")}, exported


def _module_name(package, rel):
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([package, *parts])


def _port_module(rel):
    return importlib.import_module(_module_name("lua_mapreduce_tpu_torch",
                                                rel))


JAX_MODULES = _jax_modules()


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_names_have_counterparts(rel):
    if rel in NO_COUNTERPART_MODULES:
        assert not os.path.exists(os.path.join(PORT_PKG, rel))
        return
    port_path = os.path.join(PORT_PKG, rel)
    assert os.path.exists(port_path), f"no port module for {rel}"
    names, exported = _public_names(os.path.join(JAX_PKG, rel))
    mod = _port_module(rel)
    missing = sorted(n for n in names | exported if not hasattr(mod, n)
                     and (rel, n) not in NO_COUNTERPART_NAMES)
    assert missing == [], f"{rel}: no counterpart for {missing}"
    if exported:
        allowed = {n for (r, n) in NO_COUNTERPART_NAMES if r == rel}
        assert exported - allowed <= set(mod.__all__), \
            sorted(exported - allowed - set(mod.__all__))


def test_allow_list_names_only_real_gaps():
    """Every allow-listed name exists in the JAX module and not in the
    port's: the list cannot outlive the gap it excuses."""
    for rel in NO_COUNTERPART_MODULES:
        assert os.path.exists(os.path.join(JAX_PKG, rel))
    for (rel, name), reason in NO_COUNTERPART_NAMES.items():
        names, _ = _public_names(os.path.join(JAX_PKG, rel))
        assert name in names and reason
        assert not hasattr(_port_module(rel), name), (rel, name)


def test_top_level_lazy_exports_resolve_to_their_modules():
    import lua_mapreduce_tpu_torch as port
    _, exported = _public_names(os.path.join(JAX_PKG, "__init__.py"))
    assert exported <= set(port.__all__)
    for name, (modname, attr) in port._LAZY.items():
        assert getattr(port, name) is getattr(
            importlib.import_module(modname), attr)
    with pytest.raises(AttributeError):
        port.no_such_name        # noqa: B018


def test_store_router_alias_and_fault_labels():
    from lua_mapreduce_tpu_torch import store
    from lua_mapreduce_tpu_torch.faults import (InjectedFault,
                                                describe_classification,
                                                is_transient_fault)
    a = store.router("mem:_surface_router")
    assert a is store.get_storage_from("mem:_surface_router")
    assert is_transient_fault(InjectedFault("x"))
    assert not is_transient_fault(ValueError("x"))
    assert describe_classification(InjectedFault("x")) == "infra-transient"
    assert describe_classification(ValueError("x")) == "user-code"


def test_package_utest_sweep_passes():
    import lua_mapreduce_tpu_torch
    lua_mapreduce_tpu_torch.utest()


def _self_tested(package, root):
    out = []
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            if any(isinstance(n, ast.FunctionDef) and n.name == "utest"
                   for n in tree.body):
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                out.append(_module_name(package, rel))
    return sorted(out)


# every module self-test but the package's sweep (its own test above)
SELF_TESTED = [m for m in _self_tested("lua_mapreduce_tpu_torch", PORT_PKG)
               if m != "lua_mapreduce_tpu_torch"]


def test_every_jax_self_test_has_a_port_copy():
    want = _self_tested("lua_mapreduce_tpu", JAX_PKG)
    assert len(want) == 47
    assert [m.replace("lua_mapreduce_tpu", "lua_mapreduce_tpu_torch", 1)
            for m in want] == sorted(SELF_TESTED + ["lua_mapreduce_tpu_torch"])


@pytest.mark.parametrize("module", SELF_TESTED)
def test_module_self_test(module):
    importlib.import_module(module).utest()
