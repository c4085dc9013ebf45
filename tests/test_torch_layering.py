"""The port's kernel layer points one way: no module of
`seal3d_tpu_torch/ops/` imports a layer above it (models, train, seal,
render, gui), function-local imports included, and only the runtime module
binds and launches the CUDA kernels (`runtime/kernels.py`): no ops module
imports ctypes but for `tensorf_vm`'s struct of factor pointers, and none
declares argument types, takes a stream or loads the library itself.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = sorted(glob.glob(os.path.join(ROOT, "seal3d_tpu_torch", "ops", "*.py")))
ABOVE = tuple(f"seal3d_tpu_torch.{layer}"
              for layer in ("models", "train", "seal", "render", "gui"))
C_CALL = ("argtypes", "cuda_stream", "load_library")


def _imports(path):
    """Every module an ops file imports, at its top or inside a function,
    with relative imports resolved -> [(line, module)]."""
    out = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = "seal3d_tpu_torch.ops".split(".")
                base = ".".join(pkg[:len(pkg) + 1 - node.level]
                                + ([base] if base else []))
            out += [(node.lineno, f"{base}.{a.name}") for a in node.names]
    return out


@pytest.mark.parametrize("path", OPS, ids=os.path.basename)
def test_ops_module_imports_no_layer_above(path):
    up = [(line, mod) for line, mod in _imports(path)
          if mod.startswith(ABOVE)]
    assert not up, f"{os.path.basename(path)} imports upward: {up}"


@pytest.mark.parametrize("path", OPS, ids=os.path.basename)
def test_ops_module_calls_kernels_through_the_runtime(path):
    name = os.path.basename(path)
    mods = [mod for _, mod in _imports(path)]
    if name != "tensorf_vm.py":
        assert "ctypes" not in mods, f"{name} imports ctypes"
    src = open(path).read()
    assert not [w for w in C_CALL if w in src], \
        f"{name} holds C-call glue: {[w for w in C_CALL if w in src]}"


def test_raymarch_and_ladder_import_each_other_one_way():
    path = os.path.join(ROOT, "seal3d_tpu_torch", "ops", "{}.py")
    ladder = {m for _, m in _imports(path.format("ladder"))}
    raymarch = {m for _, m in _imports(path.format("raymarch"))}
    assert any(m.startswith("seal3d_tpu_torch.ops.raymarch.")
               for m in ladder)
    assert not any(m.startswith("seal3d_tpu_torch.ops.ladder")
                   for m in raymarch)
