"""Entry points: :mod:`.serve` (prefill + greedy decode for an ``--arch``)
and :mod:`.microbench` (timed portion forwards → a fitted device spec)."""
