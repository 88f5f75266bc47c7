"""Quorum serving on the card and the continuous-batching engine."""
