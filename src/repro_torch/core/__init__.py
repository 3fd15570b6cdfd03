"""Collective communication of the port: rank groups, Hoplite chain schedules, link model."""
