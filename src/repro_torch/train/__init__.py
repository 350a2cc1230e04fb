"""Training substrate: optimizers (adam, adamw, adagrad, sgd, updated
in place; a global-norm clip over row-sharded blocks), LR schedules,
checkpointing in the JAX package's on-disk layout with auto-resume and
elastic restore onto any mesh, int8 gradient compression with error
feedback, straggler detection and failure injection."""
