"""Pedagogical re-derivations of the production code paths (port of
``playground/``)."""
