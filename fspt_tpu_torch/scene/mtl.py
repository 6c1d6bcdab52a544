"""Wavefront MTL material-library parser.

Parity with reference mtl_loader.js:3-41: scalar tokens (ns ni d illum
dielectric ior), vector tokens (ka kd kem ks ke pr pm pmr pmr_swizzle), map
tokens (map_bump map_kd map_kem map_ks map_d map_ns map_pmr).  Map values are
paths relative to the .mtl's directory; `texture_paths` collects them for
deferred loading (the reference defers these downloads, main.js:320-324).
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

SCALAR_TOKENS = {"ns", "ni", "d", "illum", "dielectric", "ior"}
VECTOR_TOKENS = {"ka", "kd", "kem", "ks", "ke", "pr", "pm", "pmr", "pmr_swizzle"}
MAP_TOKENS = {"map_bump", "map_kd", "map_kem", "map_ks", "map_d", "map_ns",
              "map_pmr"}


def parse_mtl(text: str, base_path: str = "") -> Tuple[Dict[str, dict], Set[str]]:
    """Returns ({material_name: {token: value}}, set_of_texture_paths)."""
    materials: Dict[str, dict] = {}
    paths: Set[str] = set()
    name = None
    for line in text.split("\n"):
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0].lower()
        if key == "newmtl" and len(tokens) > 1:
            name = tokens[1]
            materials[name] = {}
            continue
        if name is None:
            continue
        if key in SCALAR_TOKENS and len(tokens) > 1:
            materials[name][key] = float(tokens[1])
        elif key in VECTOR_TOKENS and len(tokens) > 1:
            materials[name][key] = [float(t) for t in tokens[1:]]
        elif key in MAP_TOKENS and len(tokens) > 1:
            rel = tokens[1]
            full = f"{base_path}/{rel}" if base_path else rel
            materials[name][key] = full
            paths.add(full)
    return materials, paths
