"""Pass ``pad-convention``: raw pad literals (AST, imports no torch).

The pad / tombstone convention lives in ``repro_torch.core.padding``
(``PAD_ID`` = -1, ``PAD_SQNORM`` = +inf, ``pad_ids`` / ``pad_dists``
with their dtypes pinned). This pass flags raw ``-1`` / ``inf`` literals
used AS PAD VALUES inside the modules that share the convention, so
every new sentinel goes through the helpers (a port of
``repro.analysis.padlint``).

Scope: ``src/repro_torch/{index,mutate,dist}`` only. ``kernels/`` stays
out, as in the reference: its masking literals are an internal contract
below the index layout.

Flagged forms (direct arguments only: ``x < inf`` comparisons and
arithmetic like ``x.add(-1)`` never match):

  torch/np.full(shape, -1), full_like(x, inf), x.new_full(shape, -1)
  x.fill_(inf), masked_fill(_)(mask, -1), index_fill(_)(dim, idx, -1)
  torch.where(mask, -1, x) / where(mask, x, inf)
  F.pad(x, pad, value=inf) (and np.pad's constant_values=)
  x[idx] = -1                       (the ``.at[].set`` counterpart)

A literal is ``-1`` (an int, not a bool, not ``-1.0``: a float -1 is a
legitimate recall-prediction sentinel) or ``inf`` spelled
``float("inf")``, ``math.inf``, ``torch.inf`` or ``np.inf`` (``-inf``
mask floors are NOT flagged: -inf is never a pad value here). Waive a
deliberate non-pad use with a ``# padlint: ok`` comment on the same or
the preceding line.
"""
from __future__ import annotations

import ast
import os
from typing import List

from repro_torch.analysis.findings import Finding

PASS_NAME = "pad-convention"

#: subpackages of src/repro_torch that share the pad convention (the
#: module docstring says why kernels/ is excluded).
SCOPE = ("index", "mutate", "dist")

WAIVER = "padlint: ok"

# call name -> (positional index of the pad value, its keyword names)
_VALUE_ARGS = {
    "full": (1, ("fill_value",)),
    "full_like": (1, ("fill_value",)),
    "new_full": (1, ("fill_value",)),
    "fill_": (0, ("value",)),
    "masked_fill": (1, ("value",)),
    "masked_fill_": (1, ("value",)),
    "index_fill": (2, ("value",)),
    "index_fill_": (2, ("value",)),
    "pad": (3, ("value", "constant_values")),
}


def _is_pad_literal(node: ast.expr) -> str:
    """'' if not a pad literal, else a short description of it."""
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        v = node.operand.value
        if isinstance(v, int) and not isinstance(v, bool) and v == 1:
            return "-1"
    if isinstance(node, ast.Attribute) and node.attr == "inf":
        return "inf"
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "float" and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and node.args[0].value.strip().lower() in ("inf", "+inf",
                                                       "infinity")):
        return "inf"
    return ""


def _basename(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _flag_args(call: ast.Call) -> List[ast.expr]:
    """The arguments of ``call`` where a raw literal means "this is a pad
    value" (see the module docstring)."""
    name = _basename(call.func)
    if name == "where":
        return call.args[1:3] + [kw.value for kw in call.keywords
                                 if kw.arg in ("input", "other")]
    if name not in _VALUE_ARGS:
        return []
    pos, kws = _VALUE_ARGS[name]
    return call.args[pos:pos + 1] + [kw.value for kw in call.keywords
                                     if kw.arg in kws]


def _flagged(tree: ast.AST):
    """(node, literal, context) for every pad literal in a flagged form."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for arg in _flag_args(node):
                lit = _is_pad_literal(arg)
                if lit:
                    yield arg, lit, f"{_basename(node.func)}(...)"
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in node.targets):
            lit = _is_pad_literal(node.value)
            if lit:
                yield node.value, lit, "a subscript assignment"


def lint_source(path: str, text: str) -> List[Finding]:
    """Lint one module's source text; ``path`` is only used for reporting
    and waiver lookup (tests feed synthetic sources directly)."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding(PASS_NAME, "tree", f"unparseable: {e}", path,
                        e.lineno)]
    lines = text.splitlines()

    def waived(lineno: int) -> bool:
        for ln in (lineno - 1, lineno - 2):
            if 0 <= ln < len(lines) and WAIVER in lines[ln]:
                return True
        return False

    out = [Finding(PASS_NAME, "tree",
                   f"raw pad literal {lit} in {ctx} — use "
                   f"repro_torch.core.padding (PAD_ID / PAD_SQNORM / "
                   f"pad_ids / pad_dists), or waive with `# {WAIVER}`",
                   path, node.lineno)
           for node, lit, ctx in _flagged(tree) if not waived(node.lineno)]
    return sorted(out, key=lambda f: f.line)


def lint_tree(src_root: str) -> List[Finding]:
    """Lint every .py under src_root/repro_torch/{index,mutate,dist}."""
    out: List[Finding] = []
    for sub in SCOPE:
        root = os.path.join(src_root, "repro_torch", sub)
        for dirpath, _, names in sorted(os.walk(root)):
            for name in sorted(names):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, "r") as f:
                    out.extend(lint_source(
                        os.path.relpath(path, os.path.dirname(src_root)),
                        f.read()))
    return out
