"""Synthetic data, copied verbatim from the JAX package (numpy only), so
both packages draw identical streams from one seed."""
