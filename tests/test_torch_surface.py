"""The port's surface against the JAX package's, read from the sources.

Every public top-level function, class, method and assignment of
``src/repro/**/*.py`` (found with ``ast``; a name is public when no part
of it starts with ``_``) has a twin of the same name in the mirrored
``src/repro_torch`` file, or an entry in ``EXEMPT`` that names the
port's counterpart (which must exist) and the reason. Every script of
``examples/`` has a twin under ``src/repro_torch/examples/``. No file of
the port, and not ``chip_smoke.py``, imports ``jax`` or ``repro``.

This file imports neither package: it reads their sources.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: module (relative to the package) → {reference name: (the port's
#: counterpart in the mirrored file, or None; the reason)}
EXEMPT = {
    "core/stream.py": {
        "VMEM_BYTES": ("SMEM_BYTES", "renamed: the tile budget is one "
                       "thread block's shared memory"),
        "StreamConfig.vmem_footprint_bytes": (
            "StreamConfig.smem_footprint_bytes", "renamed with the budget"),
        "StreamConfig.check_vmem_budget": (
            "StreamConfig.check_smem_budget", "renamed with the budget"),
        "HBM_BYTES": (None, "TPU-only constant: a v5e core's HBM"),
    },
    "core/burst_model.py": {
        "TPU_V5E_HBM": ("H100_HBM", "TPU-only constant: v5e's HBM; the "
                        "card's burst model stands beside it"),
        "TPU_V5E_ICI": (None, "TPU-only constant: v5e's inter-chip links"),
    },
    "memhier/hierarchy.py": {
        "TPU_V5E": ("H100", "TPU-only preset; the card's preset"),
        "TPU_V5E_2STACK": (None, "TPU-only preset: two v5e HBM stacks"),
    },
    "roofline/analysis.py": {
        "HW_V5E": ("HW_H100", "TPU-only constant; the card's peaks"),
        "analyze_compiled": ("analyze_step", "XLA-only: reads a compiled "
                             "executable; the port counts a walk of the "
                             "step (count_step)"),
        "normalize_cost_analysis": (None, "XLA-only: normalises XLA's "
                                    "cost_analysis() result"),
    },
    "distributed/sharding.py": {
        "shard_map": ("ModelSplit", "XLA-only: jax.shard_map; the port "
                      "splits the dense layers' compute itself"),
        "constrain": (None, "XLA-only: with_sharding_constraint; the port "
                      "places each shard explicitly (local_shard)"),
        "logical_sharding": ("logical_spec", "XLA-only: a NamedSharding; "
                             "the port keeps the spec"),
        "tree_shardings": ("tree_specs", "XLA-only: NamedShardings; the "
                           "port keeps the spec tree"),
    },
    "kernels/stream_copy.py": {
        f"stream_{op}_pallas": (f"stream_{op}_kernel",
                                f"kernel: ported as K1 through the c0_{op} "
                                f"template")
        for op in ("copy", "scale", "add", "triad")},
    "kernels/prefix_scan.py": {
        "prefix_sum_pallas": ("prefix_sum_kernel", "kernel: ported as K3, "
                              "csrc/prefix_scan.cu"),
        "chunk_scan_pallas": ("chunk_scan_kernel", "kernel: ported as K4, "
                              "csrc/prefix_scan.cu"),
    },
    "kernels/sortnet.py": {
        "sort_chunks_pallas": ("sort_chunks_kernel", "kernel: ported as K5, "
                               "csrc/sortnet.cu"),
        "merge_sorted_pallas": ("merge_sorted_kernel", "kernel: ported as "
                                "K6, csrc/sortnet.cu"),
    },
    "kernels/topk.py": {
        "topk_pallas": ("topk_kernel", "kernel: ported as K7, csrc/topk.cu"),
    },
    "obs/trace.py": {
        "Tracer.export_otlp_json": (None, "no entry point of the port "
                                    "writes OTLP"),
    },
    "kernels/flashattn.py": {
        "flash_attention_pallas": ("FlashAttentionKernel", "kernel: ported "
                                   "as K8, csrc/flashattn.cu"),
    },
}


REASONS = ("renamed", "TPU-only", "XLA-only", "kernel: ported as",
           "no entry point of the port")


def _targets(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        out += [e.id for e in elts if isinstance(e, ast.Name)]
    return out


def public_names(path: Path) -> set[str]:
    """The public top-level functions, classes, class members (methods
    and assignments, as ``Class.name``) and assignments of a file."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(f"{node.name}.{sub.name}")
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    names.update(f"{node.name}.{t}" for t in _targets(sub))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update(_targets(node))
    return {n for n in names
            if not any(part.startswith("_") for part in n.split("."))}


def imported_packages(path: Path) -> set[str]:
    """The top-level package of every import in a file, at any depth."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
EXAMPLES = sorted(p.name for p in (ROOT / "examples").glob("*.py"))


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_a_twin(module):
    twin = PORT / module
    assert twin.exists(), f"{module}: no twin file in src/repro_torch"
    exempt = EXEMPT.get(module, {})
    missing = sorted(public_names(REF / module) - public_names(twin)
                     - set(exempt))
    assert not missing, (f"{module}: no twin of {missing} in "
                         f"src/repro_torch/{module} and no EXEMPT entry")


@pytest.mark.parametrize("module", sorted(EXEMPT))
def test_exempt_entries_are_current(module):
    """Each entry names a reference name the port lacks, a reason, and a
    counterpart the mirrored port file has."""
    ref, port = public_names(REF / module), public_names(PORT / module)
    for name, (counterpart, reason) in EXEMPT[module].items():
        assert name in ref, f"{module}: {name} is not in the reference"
        assert name not in port, f"{module}: {name} has a twin now"
        assert reason.startswith(REASONS), f"{module}: {name}: {reason}"
        if counterpart is not None:
            assert counterpart in port, (f"{module}: counterpart "
                                         f"{counterpart} of {name} missing")


@pytest.mark.parametrize("example", EXAMPLES)
def test_every_example_has_a_twin(example):
    twin = PORT / "examples" / example
    assert twin.exists(), f"examples/{example}: no twin"
    names = public_names(twin)
    assert "main" in names, f"{example}: its twin has no main(argv)"
    src = twin.read_text()
    assert '"--device"' in src and "pick_device" in src, (
        f"{example}: its twin takes no --device or falls back")


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_port_imports_no_jax_or_repro(path):
    pkgs = imported_packages(ROOT / path)
    assert not pkgs & {"jax", "jaxlib", "repro"}, (
        f"{path} imports {sorted(pkgs & {'jax', 'jaxlib', 'repro'})}")
