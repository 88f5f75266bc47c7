"""Observability: the shared percentile convention (:mod:`.stats`)."""
