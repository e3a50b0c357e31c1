"""The port does all the JAX package does: a guard over every module.

Walks every module of ``multimot_track_tpu/`` by its syntax tree (nothing
is imported, so no JAX): each public top-level function, class and
constant must have a counterpart of the same name in the port's module of
the same path (defined there or imported into it), or stand on the
waiting list below with its reason.  The list holds no name the port has
already: a name ported later must leave it.  Every module of the port is
also checked, with ``chip_smoke.py``, to import neither ``jax`` nor the JAX
package.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "multimot_track_tpu"
PORT_PKG = REPO / "multimot_track_tpu_torch"

# whole modules not ported, by path (a trailing "/" covers a directory)
WAITING_MODULES = {
    "parallel/": "ROADMAP item 25: torch.distributed (the next bring-up)",
    "io/native_loader.py": "ROADMAP item 22: the card's machine has no libpng headers",
    "ops/pallas_match.py": "TPU kernel K2, replaced by csrc/match_projected.cu "
                           "(ops/match_cuda.py)",
    "solvers/flow_ba_pallas.py": "TPU kernel K1, replaced by csrc/flow_ba_lm.cu "
                                 "(solvers/flow_ba_cuda.py)",
}
# single names not ported: the TPU transfer workarounds (ROADMAP rules)
WAITING_NAMES = {
    "pipeline/tracker.py": {"pack_pytree", "unpack_pytree", "light_result_spec"},
    "pipeline/live_refine.py": {"packed_offsets", "split_refined"},
    "pipeline/batch.py": {"track_batch_packed", "batch_result_spec"},
    "solvers/flow_ba.py": {"pallas_scan_selfcheck"},
}
# names the port gives another name, because the JAX one names a JAX tool
RENAMED = {"utils/profiling.py": {"xla_trace": "trace"}}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(path: pathlib.Path) -> set:
    """Public top-level functions, classes and assigned names."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def available(path: pathlib.Path) -> set:
    """What a module defines, plus the names it imports at top level."""
    names = defined(path)
    for node in _tree(path).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


def _waiting_module(rel: str):
    for key, why in WAITING_MODULES.items():
        if rel == key or (key.endswith("/") and rel.startswith(key)):
            return why
    return None


def jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", jax_modules())
def test_module_has_its_counterpart(rel):
    names = defined(JAX_PKG / rel)
    port = PORT_PKG / rel
    why = _waiting_module(rel)
    if why is not None:
        assert not port.exists(), f"{rel} is ported: take it off the waiting list ({why})"
        return
    assert port.exists(), f"the port has no {rel}"
    have = available(port)
    renamed = RENAMED.get(rel, {})
    waiting = WAITING_NAMES.get(rel, set())
    for old, new in renamed.items():
        assert new in have, f"{rel}: {old} has no counterpart {new}"
    missing = sorted(names - have - set(renamed) - waiting)
    assert not missing, f"{rel}: no counterpart for {missing}"
    stale = sorted(waiting & have)
    assert not stale, f"{rel}: {stale} are ported; take them off the waiting list"
    assert waiting <= names, f"{rel}: the waiting list names {sorted(waiting - names)}"


def test_waiting_list_names_real_modules():
    rels = set(jax_modules())
    for key in WAITING_MODULES:
        assert any(r == key or (key.endswith("/") and r.startswith(key)) for r in rels), key
    assert set(WAITING_NAMES) | set(RENAMED) <= rels


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in sorted(PORT_PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                if root in ("jax", "jaxlib", "multimot_track_tpu"):
                    bad.append(f"{path.relative_to(REPO)}: {m}")
    assert not bad, bad
