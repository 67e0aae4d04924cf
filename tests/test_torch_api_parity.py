"""The port's public API against the JAX package's, read from the sources.

Both packages are parsed with `ast`; neither is imported. For every module
of `pytheiasfm_tpu/` the port's module of the same path (or the one named in
`MODULE_COUNTERPARTS`) must have:
- each public top-level name the JAX module defines (by `def`, `class` or
  assignment; in a package's `__init__.py` also each name it imports, which
  is the package's re-export). A name the JAX module only imports for its
  own use (`jnp`, `partial`) is not its API;
- each entry of its `__all__`, in the port module's `__all__`;
- each public member of each public class (methods, properties, fields and
  class attributes, through the bases each module defines or imports from
  its own package);
- each parameter of each public function and of each public method,
  `__init__` and `__call__` included.

A difference is kept only with an entry in `ALLOWLIST` (left out on
purpose) or `RENAMED` (a counterpart under another name), each with its
reason, or when it is a JAX `key` that the port takes as `generator`
(`PARAM_RENAMES`). A new public JAX name without a counterpart or an entry
fails `test_module_api_has_a_counterpart`; an entry that no longer matches a
difference fails `test_every_allowlist_entry_is_used`.

Differences are written as
`module`, `module::name`, `module::__all__.name`, `module::Class.member`,
`module::function(param)` or `module::Class.method(param)`, with `module`
the JAX module's path in its package.
"""

from __future__ import annotations

import ast
import sys
from functools import lru_cache
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "pytheiasfm_tpu"
PORT_ROOT = REPO / "pytheiasfm_tpu_torch"

MODULE_COUNTERPARTS = {
    "matching/pallas_matcher.py": "matching/streaming_matcher.py",
}

ALLOWLIST = {
    "utils/fetch.py":
        "a TPU form: batched device-to-host pulls of JAX arrays (ROADMAP \"Left out\")",
    "utils/cache.py":
        "turns on JAX's persistent XLA cache; the port has no XLA and builds its "
        "CUDA kernels once into `_build/` (ROADMAP \"Left out\")",
    "ba/lm.py::run_launch_chunked":
        "a TPU form: splits one jitted LM program into launches (ROADMAP \"Left out\")",
    "sfm/reconstruction.py::Reconstruction.device_arrays":
        "a TPU form: the padded jnp pytree; the BA entry gathers from the host "
        "container, and nothing calls it (ROADMAP \"Left out\")",
    "sfm/reconstruction.py::Reconstruction.update_from_device":
        "the inverse of `device_arrays`, left out with it (ROADMAP \"Left out\")",
    "sfm/two_view_match_geometric_verification.py::refine_relative_pose_batch_jit":
        "a `jax.jit` alias of `refine_relative_pose_batch`, which the port has",
    "matching/pallas_matcher.py::streaming_top2(d2t)":
        "the Pallas kernel's pre-transposed operand; the CUDA kernel reads d2 "
        "in one layout for both directions",
    "matching/pallas_matcher.py::streaming_top2(tile_i)":
        "a Pallas tile size; the CUDA kernel's tiles are fixed by its design",
    "matching/pallas_matcher.py::streaming_top2(tile_j)":
        "a Pallas tile size; the CUDA kernel's tiles are fixed by its design",
    "matching/pallas_matcher.py::streaming_top2(interpret)":
        "Pallas interpret mode; on a CPU tensor the wrapper runs the plain version",
    "matching/pallas_matcher.py::match_descriptors_batch_pallas(tile_i)":
        "as `streaming_top2(tile_i)`, which it passes on",
    "matching/pallas_matcher.py::match_descriptors_batch_pallas(tile_j)":
        "as `streaming_top2(tile_j)`, which it passes on",
    "matching/pallas_matcher.py::match_descriptors_batch_pallas(interpret)":
        "as `streaming_top2(interpret)`, which it passes on",
    "parallel/distributed.py::sharded_segment_sum(axis_name)":
        "a `shard_map` axis name; the port's mesh is one flat process group",
    "parallel/distributed.py::distributed_normal_equation_blocks(axis_name)":
        "a `shard_map` axis name; the port's mesh is one flat process group",
    "parallel/multihost.py::initialize(coordinator)":
        "`jax.distributed`'s argument; the port takes `torch.distributed`'s init_method",
    "parallel/multihost.py::initialize(num_processes)":
        "`jax.distributed`'s argument; the port takes `torch.distributed`'s world_size",
    "parallel/multihost.py::initialize(process_id)":
        "`jax.distributed`'s argument; the port takes `torch.distributed`'s rank",
    "parallel/multihost.py::initialize(local_device_ids)":
        "`jax.distributed`'s argument; the port takes local_world_size and maps "
        "rank r to cuda:(r % local_world_size)",
    "native/__init__.py::available":
        "the JAX package falls back to Python without the library; the port's "
        "graph core has none, and a failed build raises",
    "native/__init__.py::__all__.available":
        "the JAX module exports `available`, left out as above",
    "native/__init__.py::build(force)":
        "the port's library is named by the hash of its source and flags, so a "
        "changed source rebuilds without a force flag",
}

RENAMED = {
    "matching/pallas_matcher.py::match_descriptors_batch_pallas":
        ("match_descriptors_batch_streaming", "the K1 entry over pairs, on the CUDA kernel"),
    "matching/pallas_matcher.py::__all__.match_descriptors_batch_pallas":
        ("match_descriptors_batch_streaming", "the K1 entry over pairs, on the CUDA kernel"),
    "math/sdp.py::certificate_min_eig(key)":
        ("v0", "the power iteration's start vector is passed in, not drawn from a key"),
    "math/sdp.py::riemannian_staircase(key)":
        ("v0", "the power iteration's start vector is passed in, not drawn from a key"),
}

PARAM_RENAMES = {
    "key": ("generator", "a `torch.Generator` draws where the JAX function splits a key"),
}

PUBLIC_DUNDERS = ("__init__", "__call__")


def _public(name: str) -> bool:
    return not name.startswith("_")


def _statements(body):
    """Top-level statements, looking into `if` / `try` / `with` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody):
                yield from _statements(part)
            for handler in node.handlers:
                yield from _statements(handler.body)
        elif isinstance(node, ast.With):
            yield from _statements(node.body)
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)


def _strings(node):
    if isinstance(node, (ast.List, ast.Tuple)):
        return [e.value for e in node.elts if isinstance(e, ast.Constant)]
    return []


def _params(fn) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


class _Module:
    """What one source file exposes: names it defines, names it imports
    (name -> (module path relative to its package root, or None; the
    imported name)), its `__all__`, its classes and functions."""

    def __init__(self, path: Path, root: Path):
        self.path, self.root = path, root
        tree = ast.parse(path.read_text(), filename=str(path))
        self.defined, self.imports, self.all = set(), {}, []
        self.classes, self.functions = {}, {}
        for node in _statements(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defined.add(node.name)
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.defined.add(node.name)
                self.classes[node.name] = node
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    for name in _targets(target):
                        self.defined.add(name)
                        if name == "__all__":
                            self.all = _strings(node.value)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                self.defined.add(node.target.id)
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
                if node.target.id == "__all__":
                    self.all += _strings(node.value)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = (None, alias.name)
            elif isinstance(node, ast.ImportFrom):
                source = self._resolve(node)
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (source, alias.name)

    def _resolve(self, node: ast.ImportFrom):
        """The module path (relative to the package root) of a relative
        import, or None for an import from outside the package."""
        if node.level == 0:
            return None
        base = self.path.parent
        for _ in range(node.level - 1):
            base = base.parent
        parts = node.module.split(".") if node.module else []
        target = base.joinpath(*parts)
        for candidate in (target.with_suffix(".py"), target / "__init__.py"):
            if candidate.is_file():
                return candidate.relative_to(self.root).as_posix()
        return None

    @property
    def is_package(self) -> bool:
        return self.path.name == "__init__.py"

    def bound(self) -> set[str]:
        return self.defined | set(self.imports)

    def api_names(self) -> set[str]:
        names = set(self.defined)
        if self.is_package:
            names |= set(self.imports)
        return {n for n in names if _public(n)}


@lru_cache(maxsize=None)
def _module(root: str, rel: str) -> _Module:
    return _Module(Path(root) / rel, Path(root))


def _class_members(root: Path, rel: str, name: str, seen=()) -> dict:
    """Members of class `name` of module `rel` (name -> the FunctionDef, or
    None for an attribute), its bases' first, the bases followed where the
    module defines them or imports them from its own package."""
    if (rel, name) in seen:
        return {}
    mod = _module(str(root), rel)
    node = mod.classes.get(name)
    if node is None:
        source = mod.imports.get(name)
        if source and source[0]:
            return _class_members(root, source[0], source[1], seen + ((rel, name),))
        return {}
    members = {}
    for base in node.bases:
        if isinstance(base, ast.Name):
            members.update(_class_members(root, rel, base.id, seen + ((rel, name),)))
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            members[item.name] = item
        elif isinstance(item, ast.ClassDef):
            members[item.name] = None
        elif isinstance(item, ast.Assign):
            for target in item.targets:
                for n in _targets(target):
                    members[n] = None
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            members[item.target.id] = None
    return members


def _function(root: Path, rel: str, name: str, seen=()):
    """The FunctionDef that module `rel` binds to `name`, following its
    imports from its own package; None for anything else."""
    if (rel, name) in seen:
        return None
    mod = _module(str(root), rel)
    if name in mod.functions:
        return mod.functions[name]
    source = mod.imports.get(name)
    if source and source[0]:
        return _function(root, source[0], source[1], seen + ((rel, name),))
    return None


def jax_modules() -> list[str]:
    return sorted(
        p.relative_to(JAX_ROOT).as_posix()
        for p in JAX_ROOT.rglob("*.py")
        if "__pycache__" not in p.parts
    )


def _param_differences(key: str, jfn, tfn) -> list[tuple[str, str | None]]:
    """(difference, the port's name that stands for it or None)."""
    port = _params(tfn)
    out = []
    for p in _params(jfn):
        if p in port:
            continue
        diff = f"{key}({p})"
        renamed = RENAMED.get(diff, (PARAM_RENAMES.get(p) or (None,)))[0]
        out.append((diff, renamed if renamed in port else None))
    return out


def differences(rel: str) -> list[tuple[str, str | None]]:
    """Every public part of JAX module `rel` that the port lacks under the
    same name, before the allowlist: (difference, the port's name that
    stands for it by `RENAMED` / `PARAM_RENAMES`, or None)."""
    port_rel = MODULE_COUNTERPARTS.get(rel, rel)
    if not (PORT_ROOT / port_rel).is_file():
        return [(rel, None)]
    jmod, tmod = _module(str(JAX_ROOT), rel), _module(str(PORT_ROOT), port_rel)
    port_names = tmod.bound()
    out = []

    def check(diff: str, name: str, available) -> str | None:
        """The port's name for `name`; records the difference if not `name`."""
        if name in available:
            return name
        new = RENAMED.get(diff, (None,))[0]
        new = new if new in available else None
        out.append((diff, new))
        return new

    for name in sorted(jmod.api_names()):
        check(f"{rel}::{name}", name, port_names)
    for name in jmod.all:
        check(f"{rel}::__all__.{name}", name, tmod.all)

    for name in sorted(n for n in jmod.functions if _public(n)):
        port_name = name if name in port_names else RENAMED.get(f"{rel}::{name}", (None,))[0]
        tfn = port_name and _function(PORT_ROOT, port_rel, port_name)
        if tfn is not None:
            out += _param_differences(f"{rel}::{name}", jmod.functions[name], tfn)

    for cname in sorted(n for n in jmod.classes if _public(n)):
        if cname not in port_names:
            continue
        jmembers = _class_members(JAX_ROOT, rel, cname)
        tmembers = _class_members(PORT_ROOT, port_rel, cname)
        for m, jfn in sorted(jmembers.items()):
            if not (_public(m) or m in PUBLIC_DUNDERS):
                continue
            if m not in tmembers:
                if _public(m):
                    out.append((f"{rel}::{cname}.{m}", None))
                continue
            if jfn is not None and tmembers[m] is not None:
                out += _param_differences(f"{rel}::{cname}.{m}", jfn, tmembers[m])
    return out


def _all_differences():
    return [d for rel in jax_modules() for d in differences(rel)]


@pytest.mark.parametrize("rel", jax_modules())
def test_module_api_has_a_counterpart(rel):
    unexplained = [d for d, new in differences(rel) if new is None and d not in ALLOWLIST]
    assert not unexplained, (
        f"public parts of pytheiasfm_tpu/{rel} with no counterpart in "
        f"pytheiasfm_tpu_torch/{MODULE_COUNTERPARTS.get(rel, rel)} and no "
        f"allowlist entry: {unexplained}"
    )


def test_every_allowlist_entry_is_used():
    found = _all_differences()
    stale = sorted(set(ALLOWLIST) - {d for d, new in found if new is None})
    assert not stale, f"allowlist entries that match no missing part: {stale}"
    renamed = {d for d, new in found if new is not None}
    stale = sorted(set(RENAMED) - renamed)
    assert not stale, f"renames that match no difference: {stale}"
    for old, (new, _) in PARAM_RENAMES.items():
        assert any(d.endswith(f"({old})") and n == new for d, n in found), old


def test_every_entry_has_a_reason():
    for table in (ALLOWLIST, {k: v[1] for k, v in RENAMED.items()},
                  {k: v[1] for k, v in PARAM_RENAMES.items()}):
        for entry, reason in table.items():
            assert isinstance(reason, str) and len(reason.split()) >= 4, entry


def test_the_comparison_sees_a_missing_name(tmp_path, monkeypatch):
    """The check itself: a public function added to a copy of a JAX module,
    and a parameter added to one, are reported."""
    src = (JAX_ROOT / "models/camera.py").read_text()
    copy = tmp_path / "pytheiasfm_tpu" / "models"
    copy.mkdir(parents=True)
    (copy / "camera.py").write_text(
        src.replace("def position(extrinsics: jax.Array)",
                    "def position(extrinsics: jax.Array, unported=None)")
        + "\n\ndef an_unported_function(x):\n    return x\n"
    )
    monkeypatch.setattr(sys.modules[__name__], "JAX_ROOT", tmp_path / "pytheiasfm_tpu")
    _module.cache_clear()
    try:
        found = dict(differences("models/camera.py"))
    finally:
        monkeypatch.undo()
        _module.cache_clear()
    assert found["models/camera.py::an_unported_function"] is None
    assert found["models/camera.py::position(unported)"] is None
