"""Optimizer-side helpers of the port: gradient compression."""
