"""Planning and simulation (numpy copies of the JAX package's modules) and
the runtime-phase ensemble."""
