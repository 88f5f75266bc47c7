"""Model configurations: the ``--arch`` registry (:mod:`.base`) and the ten
registered architectures (:mod:`.archs`)."""
