"""Model-graph diagram renderer (reference utils.py:1703-1814
`create_block_diagram`, which shells out to the external `blockdiag` CLI).

Here the [model] DSL program renders directly to a standalone SVG (no
external tool): features/labels as rounded inputs, compute blocks labeled
with their architecture, ops as small nodes, layered by dataflow depth.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..config.model_dsl import OPS, ModelStatement

_W, _H, _GAPX, _GAPY = 150, 40, 40, 60


def _layout(stmts: Sequence[ModelStatement], fea_names, lab_names):
    """Assign (layer, column) grid positions by dataflow depth."""
    depth: Dict[str, int] = {n: 0 for n in list(fea_names) + list(lab_names)}
    nodes: List[Tuple[str, str, int]] = [
        (n, "input", 0) for n in fea_names
    ] + [(n, "label", 0) for n in lab_names]
    for s in stmts:
        kinds = OPS[s.op]
        d = 0
        for arg, kind in ((s.arg1, kinds[0]), (s.arg2, kinds[1])):
            if kind in ("input", "label") and arg in depth:
                d = max(d, depth[arg])
        depth[s.out] = d + 1
        label = f"{s.out}\n{s.op}" + (
            f"({s.arg1})" if s.op == "compute" else ""
        )
        nodes.append((s.out, label, d + 1))
    # columns within each layer
    by_layer: Dict[int, List] = {}
    pos = {}
    for name, label, layer in nodes:
        col = len(by_layer.setdefault(layer, []))
        by_layer[layer].append(name)
        pos[name] = (layer, col, label)
    return pos


def render_svg(
    stmts: Sequence[ModelStatement],
    fea_names: Sequence[str],
    lab_names: Sequence[str],
) -> str:
    pos = _layout(stmts, fea_names, lab_names)
    max_layer = max(l for l, _, _ in pos.values())
    max_col = max(c for _, c, _ in pos.values())
    width = (max_col + 1) * (_W + _GAPX) + _GAPX
    height = (max_layer + 1) * (_H + _GAPY) + _GAPY

    def xy(name):
        layer, col, _ = pos[name]
        return (
            _GAPX + col * (_W + _GAPX),
            _GAPY + layer * (_H + _GAPY),
        )

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">'
    ]
    # edges
    for s in stmts:
        kinds = OPS[s.op]
        x2, y2 = xy(s.out)
        for arg, kind in ((s.arg1, kinds[0]), (s.arg2, kinds[1])):
            if arg in pos and kind != "arch" and kind != "const":
                x1, y1 = xy(arg)
                parts.append(
                    f'<line x1="{x1 + _W // 2}" y1="{y1 + _H}" '
                    f'x2="{x2 + _W // 2}" y2="{y2}" stroke="#667" '
                    f'marker-end="url(#a)"/>'
                )
    parts.insert(
        1,
        '<defs><marker id="a" markerWidth="8" markerHeight="8" refX="6" '
        'refY="3" orient="auto"><path d="M0,0 L6,3 L0,6 z" fill="#667"/>'
        "</marker></defs>",
    )
    # nodes
    for name, (layer, col, label) in pos.items():
        x, y = xy(name)
        kind = label if label in ("input", "label") else "op"
        fill = {"input": "#cde8ff", "label": "#ffe3c2"}.get(kind, "#e8f5dc")
        rx = 14 if kind in ("input", "label") else 4
        parts.append(
            f'<rect x="{x}" y="{y}" width="{_W}" height="{_H}" rx="{rx}" '
            f'fill="{fill}" stroke="#445"/>'
        )
        text = name if kind in ("input", "label") else label.split("\n")[1]
        parts.append(
            f'<text x="{x + _W // 2}" y="{y + 16}" text-anchor="middle" '
            f'font-weight="bold">{name}</text>'
        )
        if kind == "op":
            parts.append(
                f'<text x="{x + _W // 2}" y="{y + 32}" text-anchor="middle" '
                f'fill="#556">{text}</text>'
            )
    parts.append("</svg>")
    return "\n".join(parts)


def create_block_diagram(exp, out_path: str) -> str:
    """Render the experiment's [model] program to `out_path` (model.svg in
    the out_folder, like the reference's blockdiag output)."""
    ds = exp.datasets[exp.train_with[0] if not exp.production
                      else exp.forward_with[0]]
    svg = render_svg(exp.model, list(ds.features), list(ds.labels))
    with open(out_path, "w") as f:
        f.write(svg)
    return out_path
