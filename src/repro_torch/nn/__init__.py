"""Dense layers of the recsys towers: initializers and MLP stacks."""
