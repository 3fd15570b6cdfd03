"""Link model and chain-shape rule of the port (port of the parts of
``repro.core.planner`` that the collectives use).

``LinkSpec`` and ``use_two_dimensional`` are the paper's Appendix-A model.
The JAX package feeds them TPU constants (ICI and DCN); the port has one
link of its own, measured on the card's machine: the exchange of
``core.group.exchange`` between two rank processes that share the card,
staged through host buffers and carried by gloo over the host.  The numpy
planner (recursive chain plans, the simulator's costs) comes with the data
plane.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bandwidth/latency of one node-to-node link."""

    bandwidth: float  # bytes / second
    latency: float  # seconds

    def transfer_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth


# One exchange between two of four rank processes on the machine of one
# NVIDIA H100 80GB HBM3 (power limit 700.00 W), CUDA tensor to CUDA tensor
# through pinned host buffers and gloo: latency from a 1 KiB message,
# bandwidth from a 64 MiB one, each half the median ping-pong.  Measured by
# `python -m repro_torch.launch.sync --arch qwen3-14b --ranks 4` on
# that card; chip_smoke.py measures and prints it again on every run.
HOST_STAGED_LINK = LinkSpec(bandwidth=2.162e9, latency=480.1e-6)


def use_two_dimensional(n: int, link: LinkSpec, size: float) -> bool:
    """Paper condition: two-dimensional chain iff n * B * L > S."""
    return n * link.bandwidth * link.latency > size
