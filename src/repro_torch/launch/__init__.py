"""Entry points: :mod:`.serve` (prefill + greedy decode for an ``--arch``)."""
