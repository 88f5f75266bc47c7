"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions. Public names are in :mod:`.ops`."""
