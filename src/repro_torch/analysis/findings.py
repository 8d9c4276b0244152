"""Finding: one gate failure, with a file:line anchor when the pass
recovered one (an AST node, or the stack of the offending call)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding. `entry` is the registered entry-point name for
    program-level passes and "tree" for source-level ones; file/line
    point at the offending source when the pass could recover them (the
    AST node, or the first stack frame inside the package or the corpus
    module of the offending call)."""
    pass_name: str
    entry: str
    message: str
    file: Optional[str] = None
    line: Optional[int] = None

    def location(self) -> str:
        """`file:line` when known, else the entry-point name."""
        if self.file:
            return f"{self.file}:{self.line}" if self.line else self.file
        return self.entry

    def to_dict(self) -> dict:
        """JSON-friendly form (the --json report)."""
        return dataclasses.asdict(self)


def format_findings(findings: List[Finding]) -> str:
    """Render findings one per line, `location: [pass/entry] message`."""
    lines = []
    for f in findings:
        lines.append(f"{f.location()}: [{f.pass_name}/{f.entry}] "
                     f"{f.message}")
    return "\n".join(lines)
