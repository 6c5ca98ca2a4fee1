"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, none imports ``triton``
at module level (the CPU tests import every module), and no library
attention call or ``torch.compile`` stands in for a kernel. Each port
module mirrors exactly one reference module."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# port modules with no reference counterpart (the reference's sharded
# train step is ``jax.jit`` over the specs, in no module of its own)
OWN = {"bridge.py", "kernels/_build.py", "sharding/training.py"}
# host-only modules: plain Python and numpy, the engine's scheduling,
# policy, fault, telemetry and network-simulation path between device steps,
# the procedural data (the language-model token streams too) and the fleet
# loop
HOST_ONLY = ["engine/scheduler.py", "engine/policy.py", "engine/faults.py",
             "engine/observability.py", "engine/api.py",
             "engine/transport.py", "core/controller.py",
             "network/__init__.py", "network/channel.py",
             "network/energy.py", "network/traces.py",
             "data/__init__.py", "data/floodseg.py", "data/requests.py",
             "data/lm.py", "runtime/fleet.py"]


def _names(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [(node.module or "").split(".")[0]]
    return []


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_reference_no_toplevel_triton(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [n for node in ast.walk(tree) for n in _names(node)
           if n in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"
    top = [n for node in tree.body for n in _names(node) if n == "triton"]
    assert not top, f"{path} imports triton at module level"


@pytest.mark.parametrize("rel", HOST_ONLY)
def test_host_only_modules_import_no_jax_and_no_torch(rel):
    tree = ast.parse((PORT / rel).read_text(), rel)
    bad = [n for node in ast.walk(tree) for n in _names(node)
           if n in ("jax", "jaxlib", "torch", "triton")]
    assert not bad, f"{rel} imports {bad}"


def test_port_package_calls_no_library_attention_or_compile():
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile",
                       "flash_attn"):
            assert banned not in src, f"{path} uses {banned}"


def test_port_modules_mirror_reference_modules():
    ref = ROOT / "src" / "repro"
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(PORT).as_posix()
        if rel in OWN:
            continue
        assert (ref / rel).exists(), f"{rel} has no reference counterpart"


def test_no_refusal_names_the_ported_zoo():
    """The attention and MoE zoo (ROADMAP.md, Queue 1 item 3a) is ported:
    no model module or config refuses a path as not ported yet."""
    for sub in ("models", "configs"):
        for path in (PORT / sub).rglob("*.py"):
            src = path.read_text()
            for word in ("3a", "not ported yet"):
                assert word not in src, f"{path} still names {word!r}"


def test_no_refusal_names_the_ported_training_path():
    """Training (ROADMAP.md, Queue 1 items 6a and 6b) is ported: no port
    module names item 6, 6a or 6b; what still raises as not ported names
    item 5, sharding."""
    for path in PORT.rglob("*.py"):
        src = path.read_text()
        for word in ("6a", "6b"):
            assert word not in src, f"{path} still names item {word}"
        for line in src.splitlines():
            assert "item 6)" not in line and "item 6 " not in line \
                and not line.rstrip().endswith("item 6"), \
                f"{path}: {line.strip()!r} names item 6"
        if "not ported yet" in src:
            assert "item 5" in src, f"{path} refuses without naming item 5"


def test_no_refusal_names_the_ported_serving_sharding():
    """Sharding (ROADMAP.md, Queue 1 item 5) is ported: tensor-parallel
    paged serving (5a), the dry-run with the GSPMD hints (5b-i) and the
    sharded train step (5b-ii): ``sharding/{__init__,specs,serving,
    training}.py``, ``launch/mesh.py`` and ``launch/dryrun.py`` exist, and
    no port module names item 5 as still to come."""
    for rel in ("sharding/__init__.py", "sharding/specs.py",
                "sharding/serving.py", "sharding/training.py",
                "launch/mesh.py", "launch/dryrun.py"):
        assert (PORT / rel).exists(), f"{rel} is missing"
    for path in PORT.rglob("*.py"):
        src = path.read_text().replace("\n", " ")
        assert "item 5" not in src, f"{path} still names item 5"
