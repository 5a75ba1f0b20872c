"""Inventory of the port against is3d_tpu, read with ast (nothing imported,
no jax): every public top-level name of every is3d_tpu module, and every
Config field, is in the port's module of the same path or in JAX_ONLY,
the one table of names that are JAX machinery with nothing to port -- each
with its reason and the port's counterpart where it has one.  README.md's
decided differences carry the same table.

A name counts as in the port when the port's module defines it at top
level or imports it there.  Every JAX_ONLY entry must still be a public
name of is3d_tpu and still be absent from the port, so the table cannot
go stale.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "is3d_tpu", "is3d_tpu_torch"

# (module, name) -> (why nothing is ported, the port's counterpart or None);
# name "*" covers every public name of the module
JAX_ONLY = {
    ("utils", "enable_persistent_compilation_cache"): (
        "XLA's persistent compilation cache: the port compiles nothing at "
        "run time; nvcc builds each CUDA library once per checkout",
        "native/build.build_cuda_libraries (into is3d_tpu_torch/_build/)"),
    ("kernels/common", "accum_dtype"): (
        "the dtype XLA's chunk scans accumulate bf16 blocks in; the port "
        "refuses bf16 and its kernels fix their accumulators in the source",
        None),
    ("kernels/common", "carry_seed_zero"): (
        "a shard_map scan-carry seed; the port has no scan carries", None),
    ("kernels/common", "chunk_element_budget"): (
        "the element budget of an XLA scan step, by backend",
        "kernels/common.CHUNK_ELEMENT_BUDGET, effective_chunk"),
    ("kernels/common", "next_pow2"): (
        "pads XLA chunk shapes to powers of two; the port's launches take "
        "any shape", None),
    ("kernels/feqmod", "routed_switch"): (
        "XLA's per-chunk branch routing of the df 3-4 chains",
        "kernels/feqmod.chain_split (one instantiation a chain)"),
    ("kernels/feqmod", "feqmod_kernel_mode"): (
        "chooses XLA's code generation for the df 3-4 chains; the port's "
        "chains are separate launches", "kernels/feqmod.chain_split"),
    ("kernels/decays", "do_resonance_decays_async"): (
        "JAX's asynchronous dispatch of the feed-down; the CUDA stream "
        "queues the port's cascade while the host writes",
        "api.IS3D.run_particlization (kernels/decays.do_resonance_decays)"),
    ("kernels/pallas_smooth", "*"): (
        "the Pallas kernel K1 and its tiling constants",
        "kernels/smooth.smooth_spectra_cuda (csrc/smooth_spectra.cu)"),
    ("kernels/sample", "YIELDS_DF_FIELDS"): (
        "the df columns JAX stacks for its yields block",
        "kernels/sample.YIELDS_VH_COLS"),
    ("config", "Config.remat_scan"): (
        "jax.checkpoint of the chunk scan bodies; the port's backward "
        "kernels keep the packed cells and recompute the rest",
        "the backward kernels' autograd Functions (kernels/smooth.py "
        "_SpectraKernel and its kin)"),
}


def _modules() -> list:
    out = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, JAX_PKG)):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f),
                                      os.path.join(ROOT, JAX_PKG))
                out.append(rel[:-3].replace(os.sep, "/"))
    return sorted(out)


def _tree(pkg: str, module: str):
    path = os.path.join(ROOT, pkg, *module.split("/")) + ".py"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ast.parse(f.read(), path)


def _defined(tree) -> set:
    """Top-level functions, classes and assigned names."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
    return out


def _public(tree) -> set:
    return {n for n in _defined(tree) if not n.startswith("_")}


def _present(tree) -> set:
    """Defined or imported at top level."""
    out = _defined(tree)
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _config_fields(tree) -> list:
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Config")
    return [s.target.id for s in cls.body if isinstance(s, ast.AnnAssign)]


def _jax_only(module: str) -> set:
    return {name for (m, name) in JAX_ONLY if m == module}


MODULES = _modules()


def test_every_module_is_listed():
    assert "analysis" in MODULES and "kernels/smooth" in MODULES
    assert len(MODULES) > 30


@pytest.mark.parametrize("module", MODULES)
def test_public_names_are_ported_or_jax_only(module):
    names = _public(_tree(JAX_PKG, module))
    skip = _jax_only(module)
    if "*" in skip:
        assert _tree(PORT_PKG, module) is None, (
            f"{module} is ported now: list its names, not the module")
        return
    port = _tree(PORT_PKG, module)
    assert port is not None, f"no is3d_tpu_torch/{module}.py"
    missing = sorted(names - _present(port) - skip)
    assert not missing, (f"{module}: {missing} are neither in the port nor "
                         "in JAX_ONLY")


def test_config_fields_are_ported_or_jax_only():
    jax_fields = _config_fields(_tree(JAX_PKG, "config"))
    port_fields = set(_config_fields(_tree(PORT_PKG, "config")))
    skip = {n.split(".", 1)[1] for n in _jax_only("config")
            if n.startswith("Config.")}
    assert [f for f in jax_fields
            if f not in port_fields and f not in skip] == []


@pytest.mark.parametrize("key", sorted(JAX_ONLY), ids="/".join)
def test_jax_only_entries_are_current(key):
    module, name = key
    reason, _ = JAX_ONLY[key]
    assert reason
    jax_tree, port_tree = _tree(JAX_PKG, module), _tree(PORT_PKG, module)
    if name == "*":
        assert jax_tree is not None and port_tree is None
    elif name.startswith("Config."):
        field = name.split(".", 1)[1]
        assert field in _config_fields(jax_tree)
        assert field not in _config_fields(port_tree)
    else:
        assert name in _public(jax_tree)
        assert port_tree is None or name not in _present(port_tree)


def test_readme_lists_the_jax_only_table():
    with open(os.path.join(ROOT, "README.md")) as f:
        readme = f.read()
    for module, name in JAX_ONLY:
        shown = (f"{module}.py" if name == "*"
                 else f"{module.replace('/', '.')}.{name}")
        assert shown in readme, shown
