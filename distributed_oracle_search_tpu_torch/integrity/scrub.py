"""Not ported: the JAX package's ``integrity/scrub.py`` (ROADMAP.md A14.5)."""

raise ImportError("integrity.scrub is not ported (ROADMAP.md A14.5)")
