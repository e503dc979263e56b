"""Source-hygiene gates for invariants the code can't enforce at runtime.

Two classes of silent footguns have bitten this codebase (CLAUDE.md):

* module-level ``jnp`` constants initialize the JAX backend at IMPORT
  time, before a caller can choose the platform;
* raw ``problem.<field> =`` mutation outside ``problems/`` bypasses the
  ``Problem.version`` bump that keys every compiled-solve cache, leaving
  solvers silently stale (the exact bug class ``run_pseudosection`` once
  shipped).

Both are grep-shaped properties, so the gate is a grep.
"""

import re
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "dcrmontecarlo_tpu"


def _source_files():
    return sorted(PKG.rglob("*.py"))


def test_no_module_level_jnp_constants():
    """No ``NAME = jnp.<...>`` at module scope (column 0)."""
    pat = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*\s*=\s*jnp\.")
    offenders = []
    for f in _source_files():
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if pat.match(line):
                offenders.append(f"{f.relative_to(PKG.parent)}:{i}: {line}")
    assert not offenders, (
        "module-level jnp constants initialize the backend at import "
        "(breaking the forced-CPU recipe); use np scalars instead:\n"
        + "\n".join(offenders)
    )


def test_no_raw_problem_mutation_outside_problems():
    """Physics fields of Problem are only assigned via version-bumping
    setters (or inside problems/ itself)."""
    pat = re.compile(
        r"\bproblem\.(source|source_importance|bc_dirichlet|alpha|sigma)"
        r"\s*=[^=]"
    )
    offenders = []
    for f in _source_files():
        if f.parent.name == "problems":
            continue
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if pat.search(line):
                offenders.append(f"{f.relative_to(PKG.parent)}:{i}: {line}")
    assert not offenders, (
        "raw Problem mutation bypasses the version bump that keys "
        "compiled-solve caches; use set_source_term/"
        "set_source_importance/set_boundary_conditions:\n"
        + "\n".join(offenders)
    )
