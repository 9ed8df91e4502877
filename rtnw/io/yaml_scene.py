"""YAML scene loader — reference-schema compatible.

Parses the exact schema of resources/scenes/*.yaml so reference scene files
load verbatim (SCENE 1 branch, main.cu:623-786):

    camera: {eye, center, up, aperture, fov}
    objects:
      - sphere: {type: 0, center, radius, materialId, material: {...}}
      - plane:  {type: 1, orientation, position, normal, extend, materialId,
                 twoSide, material: {...}}
      - mesh:   {type: 2, model, scale, rotate, offset, materialId,
                 material: {...}}

Material `type`: 0 Lambertian{albedo} / 1 Metal{albedo, fuzz} /
2 Dieletric{indexOfRefraction} / 3 Emission{albedo, intensity}
(MaterialType enum order, Material.h:8-13; parse at main.cu:710-747).
First definition of a materialId wins (create-if-null semantics).

Divergence noted: the reference binds every YAML mesh to materials[3]
regardless of its materialId (main.cu:781 — an apparent bug); we honor the
declared materialId, which is identical for the shipped scenes.

The files are read by `parse_yaml`, a parser of the YAML subset that
schema uses (block mappings and sequences, flow `[...]`/`{...}`, plain or
quoted scalars, `#` comments), so loading a scene needs no YAML package.
"""

from __future__ import annotations

import os
import re

from rtnw.io.obj import load_obj
from rtnw.io.ply import load_ply
from rtnw.models.camera import Camera
from rtnw.models.scene import Scene, SceneBuilder

_FLOW_TOKEN = re.compile(r"""\s*("[^"]*"|'[^']*'|[\[\]{},:]|[^\[\]{},:\s][^\[\]{},:]*)""")


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "~", ""):
        return None
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _flow(text: str):
    """Parse one flow value: `[...]`, `{...}` or a scalar."""
    tokens = [t.strip() for t in _FLOW_TOKEN.findall(text)]
    pos = 0

    def value():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok == "[":
            out = []
            while tokens[pos] != "]":
                out.append(value())
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return out
        if tok == "{":
            out = {}
            while tokens[pos] != "}":
                key = _scalar(tokens[pos])
                if tokens[pos + 1] != ":":
                    raise ValueError(f"expected ':' in flow mapping: {text!r}")
                pos += 2
                out[key] = value()
                if tokens[pos] == ",":
                    pos += 1
            pos += 1
            return out
        return _scalar(tok)

    try:
        out = value()
    except IndexError:
        raise ValueError(f"unterminated flow value: {text!r}") from None
    if pos != len(tokens):
        raise ValueError(f"trailing text after flow value: {text!r}")
    return out


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


def parse_yaml(text: str):
    """Parse the YAML subset of the reference scene schema."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip():
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError(f"tab indentation: {raw!r}")
            lines.append((len(line) - len(line.lstrip()), line.strip()))

    def block(i, indent):
        """Parse the block starting at line i (indented `indent`)."""
        if lines[i][1].startswith("- ") or lines[i][1] == "-":
            return sequence(i, indent)
        return mapping(i, indent, {})

    def sequence(i, indent):
        out = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].lstrip()
            if not rest:
                item, i = block(i + 1, lines[i + 1][0])
            elif _is_key(rest):
                # "- key: ..." opens a mapping at the item's column.
                col = indent + len(lines[i][1]) - len(rest)
                lines[i] = (col, rest)
                item, i = mapping(i, col, {})
            else:
                item, i = _flow(rest), i + 1
            out.append(item)
        return out, i

    def mapping(i, indent, out):
        while i < len(lines) and lines[i][0] == indent:
            text_ = lines[i][1]
            if not _is_key(text_):
                raise ValueError(f"expected 'key: value', got {text_!r}")
            key, _, rest = text_.partition(":")
            key, rest = _scalar(key), rest.strip()
            i += 1
            if rest:
                out[key] = _flow(rest)
            elif i < len(lines) and (lines[i][0] > indent or (
                    lines[i][0] == indent and lines[i][1].startswith("-"))):
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if not lines:
        return None
    doc, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return doc


def _is_key(text: str) -> bool:
    key, sep, rest = text.partition(":")
    return bool(sep) and (not rest or rest[0] == " ") and not key.startswith(
        ("[", "{", '"', "'"))


# MaterialType enum order (Material.h:8-13).
_MAT_LAMBERTIAN, _MAT_METAL, _MAT_DIELECTRIC, _MAT_EMISSION = 0, 1, 2, 3

# $RTNW_MODEL_ROOTS (colon-separated) extends the search path — the analogue
# of the reference's env-based asset root (Filesystem.h/root_directory.h).
DEFAULT_MODEL_ROOTS = [
    *os.environ.get("RTNW_MODEL_ROOTS", "").split(":"),
    "assets/models",
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "models"),
]
DEFAULT_MODEL_ROOTS = [r for r in DEFAULT_MODEL_ROOTS if r]


def _resolve_model(path: str, model_roots) -> str:
    for root in model_roots:
        candidate = os.path.join(root, path)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(
        f"model '{path}' not found under any of {list(model_roots)}"
    )


def _register_material(builder: SceneBuilder, material_id: int, spec: dict) -> None:
    mtype = int(spec["type"])
    if mtype == _MAT_LAMBERTIAN:
        builder.lambertian(material_id, tuple(spec["albedo"]))
    elif mtype == _MAT_METAL:
        builder.metal(material_id, tuple(spec["albedo"]), float(spec.get("fuzz", 1.0)))
    elif mtype == _MAT_DIELECTRIC:
        builder.dielectric(material_id, float(spec["indexOfRefraction"]))
    elif mtype == _MAT_EMISSION:
        builder.emission(
            material_id, tuple(spec["albedo"]), float(spec.get("intensity", 1.0))
        )
    else:
        raise ValueError(f"unknown material type {mtype}")


def register_scene1_materials(builder: SceneBuilder) -> None:
    """Pre-register the reference's 9 hard-coded material slots.

    initialize() creates materials 0-8 BEFORE parsing the YAML
    (main.cu:643-651), and the parser's create-if-null check
    (main.cu:710-747) then IGNORES every inline material definition whose
    slot is taken — so at runtime cornellbox2's "light" plane (declared
    Lambertian in the file) is actually Emission((1,1,1), 5.0) from slot 8.
    Calling this before load populates the builder with those runtime
    materials; first-definition-wins makes the YAML's inline defs inert,
    byte-matching the reference's effective scene.
    """
    builder.lambertian(0, (1.0, 0.0, 0.0))
    builder.lambertian(1, (0.0, 1.0, 0.0))
    builder.lambertian(2, (0.0, 0.0, 1.0))
    builder.lambertian(3, (1.0, 1.0, 1.0))
    builder.lambertian(4, (0.75, 0.25, 0.25))
    builder.lambertian(5, (0.25, 0.25, 0.75))
    builder.metal(6, (1.0, 1.0, 1.0), 0.0)
    builder.dielectric(7, 1.5)
    builder.emission(8, (1.0, 1.0, 1.0), 5.0)


def load_scene(
    path: str, model_roots=None, extra_camera_kw=None,
    scene1_materials: bool = False,
) -> tuple[Scene, Camera]:
    """Load a reference-format YAML scene file -> (Scene, Camera).

    scene1_materials=True reproduces the reference's RUNTIME material
    binding (pre-created slots 0-8 override the file's inline defs; see
    register_scene1_materials) instead of the file's declarative intent.
    """
    builder, camera = load_scene_builder(
        path, model_roots, extra_camera_kw,
        scene1_materials=scene1_materials,
    )
    return builder.build(), camera


def load_scene_builder(
    path: str, model_roots=None, extra_camera_kw=None,
    scene1_materials: bool = False,
) -> tuple[SceneBuilder, Camera]:
    """Like load_scene, but returns the un-built SceneBuilder so callers
    can append objects first (e.g. bench.py adds the reference's
    materialball mesh on top of cornellbox2.yaml, mirroring
    prepareCUDAscene's composition at main.cu:428-432 + :675-786)."""
    if model_roots is None:
        model_roots = DEFAULT_MODEL_ROOTS + [os.path.dirname(os.path.abspath(path))]
    with open(path) as f:
        doc = parse_yaml(f.read())

    camera = Camera.from_yaml_block(doc["camera"])

    builder = SceneBuilder()
    if scene1_materials:
        register_scene1_materials(builder)
    for entry in doc.get("objects", []):
        (kind_name, obj), = entry.items()
        if "materialId" not in obj or "material" not in obj:
            # The reference's loader hard-crashes on such entries (yaml-cpp
            # throw at main.cu:698-702; the shipped scene.yaml ends with one).
            # Skipping with a warning is strictly more robust.
            import warnings

            warnings.warn(
                f"{path}: skipping {kind_name} without materialId/material"
            )
            continue
        material_id = int(obj["materialId"])
        _register_material(builder, material_id, obj["material"])
        prim_type = int(obj["type"])
        if prim_type == 0:  # Sphere (PrimitiveType order, Hitable.h:7-11)
            builder.sphere(tuple(obj["center"]), float(obj["radius"]), material_id)
        elif prim_type == 1:  # Plane
            builder.plane(
                position=tuple(obj["position"]),
                normal=tuple(obj["normal"]),
                extend=tuple(obj["extend"]),
                orientation=int(obj["orientation"]),
                material_id=material_id,
                two_sided=bool(obj.get("twoSide", True)),
            )
        elif prim_type == 2:  # TriangleMesh
            model_path = _resolve_model(obj["model"], model_roots)
            scale = tuple(obj.get("scale", (1.0, 1.0, 1.0)))
            rotate = tuple(obj.get("rotate", (0.0, 0.0, 0.0)))
            offset = tuple(obj.get("offset", (0.0, 0.0, 0.0)))
            if model_path.lower().endswith(".ply"):
                tris = load_ply(model_path, offset=offset)
            else:
                tris = load_obj(model_path, scale=scale, rotate=rotate, offset=offset)
            builder.mesh(tris, material_id)
        else:
            raise ValueError(f"unknown primitive type {prim_type} ({kind_name})")

    return builder, camera
