"""The PyTorch port, ``chip_smoke.py`` and the port's measurement scripts
import no JAX.

An AST scan, not a ``sys.modules`` check: the test process may have JAX
loaded already. Also checks that ``regex`` (which the GPU machine lacks),
PIL (imported only where images are decoded) and ``triton`` are not imported
at module level.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "refining_clip_via_dinov2_representations_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "refining_clip_via_dinov2_representations_tpu")
NOT_AT_MODULE_LEVEL = ("regex", "PIL", "triton")
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                      REPO / "scripts" / "profile_torch_serving.py",
                                      REPO / "scripts" / "step_noise_floor.py",
                                      REPO / "scripts" / "probe_attention_kernels.py",
                                      REPO / "scripts" / "tune_attention_bwd.py"]


def _imported(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module]
    return []


def test_scan_covers_the_port():
    names = {p.relative_to(REPO).as_posix() for p in FILES}
    for must in ("chip_smoke.py", f"{PORT.name}/ops/fused_attention.py",
                 f"{PORT.name}/ops/flash_attention.py", f"{PORT.name}/serve.py",
                 f"{PORT.name}/models/clip.py"):
        assert must in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        for mod in _imported(node):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {mod}"
    for node in tree.body:  # module level only
        for mod in _imported(node):
            assert mod.split(".")[0] not in NOT_AT_MODULE_LEVEL, (
                f"{path.name}:{node.lineno} imports {mod} at module level")
