"""Neural-net building blocks: initializers, MLP and GLU FFN stacks,
normalization, rotary embeddings and attention."""
