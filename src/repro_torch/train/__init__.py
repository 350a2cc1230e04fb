"""Training substrate: optimizers (adam, adamw, adagrad, sgd, updated
in place), LR schedules, checkpointing in the JAX package's on-disk
layout with auto-resume, straggler detection and failure injection.
Gradient compression and elastic (re-sharded) restore wait for the
distributed slice in ROADMAP.md."""
