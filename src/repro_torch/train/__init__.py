"""Training of the port: the train step (remat, microbatches, the cross-pod gradient sync, AdamW)."""
