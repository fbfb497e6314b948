"""The port's public API against the JAX package's, by AST (neither package
is imported, so this runs in well under a second).

For every `.py` and `.cpp` file of `simple_mmd_renderer_tpu/`, the port
has a file of the same path under `simple_mmd_renderer_tpu_torch/`. For
every `.py` module (one test case each):

- every public top-level name (function, class, constant) has a
  counterpart in the port's module of the same path, of the same kind
  (function or class), but for the named exceptions below;
- every public function, and every public method of a public class
  (`__init__` included), is callable as the reference's: the reference's
  parameters are a prefix of the port's, with the same names, order and
  kinds (positional-only, positional-or-keyword, `*args`, keyword-only,
  `**kwargs`), so the port's own parameters follow the reference's last;
- where the reference gives a parameter a default, the port gives the
  equal one after `_normal_default`'s normalisation (`jnp.float32` is
  `torch.float32`; flax's `struct.field(pytree_node=False, default=x)` is
  `x`). A port default where the reference has none still binds every
  call written against the reference, so it is allowed;
- a method is a property, a static or a class method on both sides;
- a dataclass's fields are its constructor's parameters and are held the
  same way. The flax dataclasses that are `nn.Module`s in the port are
  named below (their tensors are registered buffers, not fields): their
  reference fields are held against the port's `__init__` parameters after
  `self` by the same rule, port-only parameters (`device`) last;
- a field with a `default_factory` matches a parameter whose default is
  `None`, where the port resolves `None` to the factory's value (the
  reference's `Scene.config = field(default_factory=AppConfig)` against
  the port's `config=None`, which the constructor turns into
  `AppConfig()`).

Before `Scene` took the reference's order (its `device` parameter stood
after `cubemap`, so `Scene(s, p, m, cfg, tex, cube, camera)` handed the
camera to `device`), the `core/scene.py` case failed for `Scene` alone;
`CameraArrays` and `LightArrays` already agreed.
"""

import ast
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = REPO / "simple_mmd_renderer_tpu"
PORT = REPO / "simple_mmd_renderer_tpu_torch"

# public top-level names of the reference that the port does not have
NO_COUNTERPART = {
    ("ops/tiled_raster.py", "WIN"): "the width of the row-window strip "
    "bodies, a TPU layout workaround inside K1, K2 and K4",
    ("ops/tiled_raster.py", "RASTER_WINDOWS"): "the row-window strip "
    "bodies' table, the same TPU layout workaround",
    ("ops/tiled_raster.py", "GROUP"): "the entries a Pallas kernel's "
    "vector loop takes at once; the port checks `chunk` against "
    "CHUNK_GROUP, the same 8",
    ("ops/tiled_raster.py", "COMPACT_RUNGS"): "the static ladder of the "
    "reference's compaction sizes (its compiler needs static shapes); the "
    "port compacts to the exact count",
    ("ops/tiled_raster.py", "CROWD_COMPACT_DIV"): "the crowd's static "
    "compaction passes; the port bins a crowd in one pass",
    ("ops/shadow_pcf.py", "TILE_H"): "K3's TPU tile height; the card's "
    "kernel takes any map size",
    ("ops/shadow_pcf.py", "TILE_W"): "K3's TPU tile width (S % 128 == 0 "
    "in the reference's pcf_lit_map_tiled); the card's kernel takes any "
    "map size",
}

# flax dataclasses of the reference that are nn.Modules in the port: their
# fields are compared with the port's __init__ parameters after `self`
MODULE_CLASSES = {
    ("core/scene.py", "Scene"): "an nn.Module holding the device tables",
    ("render/camera_anim.py", "CameraArrays"): "an nn.Module; the track's "
    "tensors are buffers, so `.to()` moves them",
    ("render/camera_anim.py", "LightArrays"): "an nn.Module, as "
    "CameraArrays",
}

KINDS = ("positional-only", "positional", "*args", "keyword-only",
         "**kwargs")
METHOD_KINDS = ("property", "staticmethod", "classmethod")


def _sources(suffixes=(".py",)):
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*")
                  if p.suffix in suffixes)


def _normal_default(node):
    """A default as comparable text: the array library's dtypes under one
    name, a dataclass field's default (None where it has none)."""
    if node is None:
        return None
    if (isinstance(node, ast.Call)
            and ast.unparse(node.func) in ("struct.field", "field",
                                           "dataclasses.field")):
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            return _normal_default(kw["default"])
        if "default_factory" in kw:
            return "factory " + ast.unparse(kw["default_factory"])
        return None
    text = ast.unparse(node)
    for lib in ("jnp.", "np.", "torch."):
        if text.startswith(lib) and text[len(lib):] in (
                "float16", "float32", "float64", "int32", "int64", "bool_",
                "uint8"):
            return "dtype " + text[len(lib):]
    return text


def _params(args):
    """[(name, kind, normalised default)] of an ast.arguments."""
    pos = args.posonlyargs + args.args
    defaults = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = [(a.arg, KINDS[0] if i < len(args.posonlyargs) else KINDS[1],
            _normal_default(d)) for i, (a, d) in enumerate(zip(pos,
                                                                defaults))]
    if args.vararg:
        out.append((args.vararg.arg, KINDS[2], None))
    out += [(a.arg, KINDS[3], _normal_default(d))
            for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    if args.kwarg:
        out.append((args.kwarg.arg, KINDS[4], None))
    return out


def _is_dataclass(cls):
    return any("dataclass" in ast.unparse(d) for d in cls.decorator_list)


def _fields(cls):
    return [(s.target.id, KINDS[1], _normal_default(s.value))
            for s in cls.body if isinstance(s, ast.AnnAssign)
            and isinstance(s.target, ast.Name)]


def _api(path):
    """{name: ("function", params) | ("class", None) | ("constant", None)}
    of a module's public top level, and {"Class.method": ("method",
    params, decorators)} / {"Class.<fields>": ("fields", fields)} of its
    public classes."""
    out = {}
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = ("constant", None)
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        if node.name.startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ("function", _params(node.args))
            continue
        out[node.name] = ("class", None)
        if _is_dataclass(node):
            out[f"{node.name}.<fields>"] = ("fields", _fields(node))
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and (
                    not sub.name.startswith("_") or sub.name == "__init__"):
                kinds = sorted(k for k in METHOD_KINDS if k in [
                    ast.unparse(d) for d in sub.decorator_list])
                out[f"{node.name}.{sub.name}"] = ("method",
                                                  _params(sub.args), kinds)
    return out


def _constructor(port_api, cls):
    """The port's constructor parameters of class `cls`: its fields if it
    is a dataclass, else its __init__'s without `self`."""
    if f"{cls}.<fields>" in port_api:
        return port_api[f"{cls}.<fields>"][1]
    init = port_api.get(f"{cls}.__init__")
    return init[1][1:] if init else None


def _fmt(params):
    return ", ".join(f"{n}" + ("" if k == KINDS[1] else f" ({k})")
                     + ("" if d is None else f"={d}") for n, k, d in params)


def divergences(rel):
    """The places where the port's module `rel` is not callable as the
    reference's, as readable lines."""
    ref_api = _api(REF / rel)
    port_api = _api(PORT / rel)
    found = []
    for name, (kind, *rest) in ref_api.items():
        where = f"{rel}:{name}"
        if kind == "fields":
            ref_params = rest[0]
            got = _constructor(port_api, name.split(".")[0])
        elif (rel, name) in NO_COUNTERPART:
            continue
        elif name not in port_api:
            found.append(f"{where}: missing in the port")
            continue
        elif port_api[name][0] != kind:
            found.append(f"{where}: a {kind} in the reference, a "
                         f"{port_api[name][0]} in the port")
            continue
        elif kind in ("class", "constant"):
            continue
        else:
            ref_params, got = rest[0], port_api[name][1]
            if kind == "method" and rest[1] != port_api[name][2]:
                found.append(f"{where}: decorated {rest[1]} in the "
                             f"reference, {port_api[name][2]} in the port")
        if got is None:
            found.append(f"{where}: the port has no constructor to compare")
            continue
        head = got[:len(ref_params)]
        if [p[:2] for p in head] != [p[:2] for p in ref_params]:
            found.append(f"{where}: the reference takes "
                         f"({_fmt(ref_params)}), the port ({_fmt(got)})")
            continue
        for (n, _, rd), (_, _, pd) in zip(ref_params, head):
            # a default factory's counterpart is None, resolved to it
            if rd is not None and rd != pd and not (
                    rd.startswith("factory ") and pd == "None"):
                found.append(f"{where}: default of {n} is {rd} in the "
                             f"reference, {pd} in the port")
    return found


def test_every_reference_file_has_a_port_file():
    missing = [rel for rel in _sources((".py", ".cpp"))
               if not (PORT / rel).is_file()]
    assert not missing, missing


@pytest.mark.parametrize("rel", _sources())
def test_module_is_callable_as_the_reference(rel):
    found = divergences(rel)
    assert not found, "\n".join(found)


def test_exceptions_name_what_the_reference_has():
    """Each exception names a public name of the reference's module (the
    list cannot go stale), and each has a reason."""
    for (rel, name), why in {**NO_COUNTERPART, **MODULE_CLASSES}.items():
        assert name in _api(REF / rel), (rel, name)
        assert why
    for rel, name in NO_COUNTERPART:
        assert name not in _api(PORT / rel), (rel, name)


def test_the_walk_catches_a_divergence(tmp_path, monkeypatch):
    """The check itself: a moved parameter, a missing function, another
    default and a port-only parameter before the reference's last are each
    found, in functions and in a dataclass's fields against a class's
    `__init__`; a port-only parameter at the end, a port default where the
    reference has none and a `None` default against a default factory are
    not."""
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    (ref / "m.py").write_text(
        "def a(x, y=1, z=None): pass\n"
        "def b(x): pass\n"
        "def c(x, dtype=jnp.float32): pass\n"
        "def d(x, y): pass\n"
        "def e(x, y): pass\n"
        "@dataclass\n"
        "class F:\n"
        "    s: int\n"
        "    cfg: list = field(default_factory=list)\n"
        "    cam: object = None\n"
        "@dataclass\n"
        "class G:\n"
        "    s: int\n"
        "    cfg: list = field(default_factory=list)\n"
        "    cam: object = None\n")
    (port / "m.py").write_text(
        "def a(x, z=None, y=1): pass\n"
        "def c(x, dtype=torch.float64): pass\n"
        "def d(x, w, y): pass\n"
        "def e(x, y=2, w=3): pass\n"
        "class F:\n"
        "    def __init__(self, s, cfg=None, device='cuda', cam=None): pass\n"
        "class G:\n"
        "    def __init__(self, s, cfg=None, cam=None, device='cuda'): pass\n")
    monkeypatch.setattr(sys.modules[__name__], "REF", ref)
    monkeypatch.setattr(sys.modules[__name__], "PORT", port)
    found = divergences("m.py")
    assert [f.split(":")[1] for f in found] == ["a", "b", "c", "d",
                                                "F.<fields>"], found
