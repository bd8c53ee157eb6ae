"""The PyTorch port stands alone: no module under paddle_tpu_torch/ (its
subpackage tools/ included: the port's load generator, chaos harness
and trace_export), and not chip_smoke.py, time_fp32.py, time_step.py,
probe_decode_rows.py, probe_fetch.py, probe_profile_records.py,
probe_profilez.py, probe_replica_start.py, probe_serving_host.py or
probe_train_guard.py, imports jax or the JAX package paddle_tpu."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "time_fp32.py"),
             os.path.join(REPO, "time_step.py"),
             os.path.join(REPO, "probe_decode_rows.py"),
             os.path.join(REPO, "probe_fetch.py"),
             os.path.join(REPO, "probe_profile_records.py"),
             os.path.join(REPO, "probe_profilez.py"),
             os.path.join(REPO, "probe_replica_start.py"),
             os.path.join(REPO, "probe_serving_host.py"),
             os.path.join(REPO, "probe_train_guard.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        files.extend(os.path.join(root, n) for n in sorted(names)
                     if n.endswith(".py"))
    return sorted(files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(src, filename="<src>"):
    tree = ast.parse(src, filename=filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_port_tree_is_scanned():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) >= 20, files


@pytest.mark.parametrize("rel", [os.path.relpath(p, REPO)
                                 for p in _port_files()])
def test_port_module_imports_neither_jax_nor_paddle_tpu(rel):
    with open(os.path.join(REPO, rel)) as f:
        src = f.read()
    bad = [(line, mod) for line, mod in _imports(src, rel)
           if _forbidden(mod)]
    assert not bad, f"{rel} imports {bad}"


def test_lint_catches_forbidden_forms():
    src = ("import jax.numpy as jnp\nfrom paddle_tpu.ops import registry\n"
           "import paddle_tpu_torch\n__import__('jax')\n")
    tree_mods = [m for _, m in _imports(src) if _forbidden(m)]
    assert tree_mods == ["jax.numpy", "paddle_tpu.ops", "jax"]
