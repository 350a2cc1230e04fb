"""Training substrate: optimizers (adam, adamw, adagrad, sgd, updated
in place), LR schedules, checkpointing in the JAX package's on-disk
layout with auto-resume, straggler detection and failure injection.
Gradient compression and elastic (re-sharded) restore wait for the
training half of the distributed layer (ROADMAP.md §1 item 8)."""
