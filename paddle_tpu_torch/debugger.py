"""Program debugging utilities: pseudo-code printer + graphviz drawing
(counterpart of paddle_tpu/debugger.py).

Mirror of the reference's python/paddle/v2/fluid/debuger.py
(pprint_program_codes, draw_block_graphviz) and graphviz.py /
net_drawer.py: render a Program as readable pseudo-code and as a .dot
graph.  Pure text emission — no graphviz python package required; feed
the .dot to `dot -Tpng` offline.  The same Program built in either
package gives the same text and the same .dot; the verifier's
annotations (`diagnostics=`, `verify=True`) put each finding beside the
op it flags.
"""
from __future__ import annotations

import re
from typing import Optional, Set

from .core.framework import Parameter, Program

__all__ = ["program_to_code", "print_program", "draw_block_graphviz"]


def _attr_repr(value, maxlen=40):
    s = repr(value)
    return s if len(s) <= maxlen else s[: maxlen - 3] + "..."


def _op_to_code(op) -> str:
    outs = ", ".join(
        f"{slot}={names}" if len(op.outputs) > 1 else ", ".join(names)
        for slot, names in sorted(op.outputs.items()) if names
    )
    ins = ", ".join(
        f"{slot}={names}" for slot, names in sorted(op.inputs.items())
        if names
    )
    attrs = ", ".join(
        f"{k}={_attr_repr(v)}" for k, v in sorted(op.attrs.items())
        if not k.startswith("_") and k != "sub_block"
    )
    parts = [p for p in (ins, attrs) if p]
    return f"{outs or '()'} = {op.type}({', '.join(parts)})"


def _var_to_code(v) -> str:
    kind = "param" if isinstance(v, Parameter) else (
        "persist" if getattr(v, "persistable", False) else "var")
    return (f"{kind} {v.name} : shape={list(v.shape) if v.shape else '?'}"
            f", dtype={v.dtype}, lod={getattr(v, 'lod_level', 0)}")


def _diag_index(diagnostics):
    """{(block_idx, op_idx): [Diagnostic]} (program/block-level entries
    keyed with op_idx None are kept under (block_idx, None))."""
    index = {}
    for d in diagnostics or ():
        index.setdefault((d.block_idx, d.op_idx), []).append(d)
    return index


def program_to_code(program: Program, skip_vars: bool = False,
                    diagnostics=None, verify: bool = False) -> str:
    """Render every block of `program` as indented pseudo-code
    (reference debuger.py pprint_program_codes).

    `diagnostics`: analysis Diagnostic list (Program.verify output) —
    flagged ops get `// !! [severity] pass-id: message` annotations so a
    dump shows WHERE the verifier complained.  `verify=True` runs the
    analyzer itself (never raising) and annotates with its findings.
    """
    if verify and diagnostics is None:
        diagnostics = program.verify(level=None)
    index = _diag_index(diagnostics)
    lines = []
    for block in program.blocks:
        head = f"// block {block.idx}"
        if block.parent_idx >= 0:
            head += f" (parent {block.parent_idx})"
        lines.append(head + " {")
        for d in index.get((block.idx, None), ()):
            lines.append(f"  // !! [{d.severity}] {d.pass_id}: "
                         f"{d.message}")
        if not skip_vars:
            for name in sorted(block.vars):
                lines.append("  " + _var_to_code(block.vars[name]))
            if block.vars and block.ops:
                lines.append("")
        for i, op in enumerate(block.ops):
            lines.append("  " + _op_to_code(op))
            for d in index.get((block.idx, i), ()):
                lines.append(f"    // !! [{d.severity}] {d.pass_id}: "
                             f"{d.message}")
            sub = op.attrs.get("sub_block")
            if sub is not None:
                lines.append(f"    // -> sub_block {sub}")
        lines.append("}")
    return "\n".join(lines)


def print_program(program: Program, **kw) -> None:
    print(program_to_code(program, **kw))


def _dot_id(name: str) -> str:
    return re.sub(r"[^0-9a-zA-Z_]", "_", name)


_SEVERITY_COLORS = {"error": "salmon", "warning": "orange",
                    "info": "khaki"}


def draw_block_graphviz(block, path: Optional[str] = None,
                        highlights: Optional[Set[str]] = None,
                        diagnostics=None) -> str:
    """Emit a graphviz digraph for one block: op nodes (boxes) wired
    through var nodes (ellipses; params shaded).  Returns the .dot text
    and writes it to `path` if given (reference debuger.py
    draw_block_graphviz).

    `diagnostics` (analysis Diagnostic list): ops flagged by the
    verifier are colored by worst severity (error=salmon,
    warning=orange, info=khaki) with the pass ids in the label."""
    highlights = highlights or set()
    diag_by_op = {}
    for d in diagnostics or ():
        if d.block_idx == block.idx and d.op_idx is not None:
            diag_by_op.setdefault(d.op_idx, []).append(d)
    lines = ["digraph G {", "  rankdir=TB;"]
    seen_vars: Set[str] = set()

    def var_node(name):
        if name in seen_vars or not name:
            return
        seen_vars.add(name)
        style = ["shape=ellipse"]
        try:
            v = block.var(name)
        except KeyError:
            v = None
        if isinstance(v, Parameter):
            style.append('style=filled fillcolor="lightgrey"')
        if name in highlights:
            style.append('color="red"')
        label = name
        if v is not None and v.shape is not None:
            label += f"\\n{list(v.shape)}"
        lines.append(f'  var_{_dot_id(name)} [{" ".join(style)} '
                     f'label="{label}"];')

    from .analysis import max_severity

    for i, op in enumerate(block.ops):
        color, label = "lightblue", op.type
        flagged = diag_by_op.get(i)
        if flagged:
            color = _SEVERITY_COLORS[max_severity(flagged)]
            label += "\\n!! " + ",".join(
                sorted({d.pass_id for d in flagged}))
        lines.append(f'  op_{i} [shape=box style=filled '
                     f'fillcolor="{color}" label="{label}"];')
        for names in op.inputs.values():
            for n in names:
                if not n:
                    continue
                var_node(n)
                lines.append(f"  var_{_dot_id(n)} -> op_{i};")
        for names in op.outputs.values():
            for n in names:
                if not n:
                    continue
                var_node(n)
                lines.append(f"  op_{i} -> var_{_dot_id(n)};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
