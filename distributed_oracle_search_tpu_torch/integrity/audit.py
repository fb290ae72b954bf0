"""Not ported: the JAX package's ``integrity/audit.py`` (ROADMAP.md A14.5)."""

raise ImportError("integrity.audit is not ported (ROADMAP.md A14.5)")
