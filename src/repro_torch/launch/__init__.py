"""Launchers: the serving engine, the serving and training CLIs and the
recsys model registry.  Nothing in the package touches the card at
import time."""
