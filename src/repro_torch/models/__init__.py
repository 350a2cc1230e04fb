"""Model families; this slice ports only the recsys field-embedding
config helper."""
