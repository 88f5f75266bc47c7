"""Coding layouts a :class:`~repro_torch.core.plan_ir.PlanIR` can carry
(numpy copies of the JAX package's modules). Coded serving is not ported
yet; these are here because the plan IR imports them."""
