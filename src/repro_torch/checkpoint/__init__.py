"""Checkpoint and restart of the train state (port of ``repro.checkpoint``)."""
