"""Optimizer-side helpers of the port: AdamW and gradient compression."""
