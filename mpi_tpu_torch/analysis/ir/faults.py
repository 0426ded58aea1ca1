"""Seeded faults the verifier must catch, for its own checks on a device.

``tests/test_torch_ir_verify.py`` seeds each contract's fault on the CPU;
``chip_smoke.py`` phase 11 seeds this one on the card, where the launch
order is the stream's, to show that ``ir-donation`` reads the card's
records as it reads the CPU's.
"""

from __future__ import annotations

import torch

from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.utils.segmenting import segmented_evolve


def late_band_seam(engine):
    """A seam stepper for ``engine`` (a periodic padded engine) that takes
    its band from the pass's input after the kernel launch instead of
    before it: on one stream its grid is still right, and ``ir-donation``
    must flag the read (``parallel/seam.py:fused_band`` reads the band in
    a launch of its own)."""
    C, rule = engine.config.cols, engine.config.rule

    def local(src, k, dst):
        d = k * rule.radius
        out = engine._pass(src, k, dst)
        strip = seam.extract_band(src, C, d)
        return seam.stitch_band(out, seam.evolve_band(strip, rule, k), C, d)

    # the band's index tensors at every pass depth, made now: made inside a
    # pass on the card they are host copies, which the recorder's
    # synchronisation check refuses
    row = torch.zeros((1, engine._shape()[1]), dtype=torch.int32,
                      device=engine.device)
    for k in engine.depths:
        d = k * rule.radius
        seam.stitch_band(row, seam.extract_band(row, C, d), C, d)
    return segmented_evolve(local, engine.config.comm_every)
