"""The yardstick of the kernels' roofline shares: the least time the card
could take for the work a window did, from frozen counts of the work and
the card's peaks.

Least time = max(int32 instructions / the int32 peak, bytes / the
published HBM bandwidth).  The work is the rule's, not an
implementation's: a kernel that gets faster moves its time, never this.

Instructions per word-generation (32 cells for one generation), frozen
here so that a change to the program's own counters does not move them:

* ``B3/S23`` (Life), 15: the least cover, in three-input LOP3 and funnel
  shift (SHF) instructions, of the bit-sliced word graph of one
  generation: carry-save column sums of the three rows (4 LOP3), the two
  side columns' 2-bit sums shifted in from the neighbouring words (4 SHF),
  the weight-1 parity and carry (2 LOP3), and the rule as a function of
  the four remaining addends and the cell (5 LOP3).  It is what the
  program's ``ops/bitlife.py:word_ops`` gave for Life when this table was
  written.
* ``R5,C0,M1,S34..58,B34..45`` (Bosco), 7: a lower bound on the LOP3 and
  SHF instructions of any program that sums each column's 11 cells into
  bit planes and takes the neighbouring words' planes by shuffle: an
  instruction joins at most three values, so joining the n values the next
  state depends on takes at least ceil((n - 1) / 2) of them, with n found
  by flipping each value on random words.  It is what the program's
  ``ops/bitltl.py:ltl_word_ops_lower`` gave for Bosco when this table was
  written.  At 7 a Bosco generation is bound by its bytes, not by these.

K2, the dense stencil that steps the seam band, is held to 1.5
instructions a cell-generation: sliding window sums take about six a
cell-generation whatever the radius (a three-input add to slide each of
the vertical and horizontal windows, the centre, the rule's test, the
result), and every sum fits a byte (<= 225), so four cells share one
32-bit instruction.

Bytes: one read and one write of the board for each launch.

A rule this table does not hold takes its count from its configuration
file's ``word_generation_ops``, with the derivation beside it.

The int32 peak is the card's own: SMs x 64 int32 lanes x the SM clock,
read from the device's properties.  Off the card there is no peak and
this module raises: a roofline share is a device number.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, published HBM3 bandwidth
HBM_BYTES_PER_S = 3.35e12

# int32 lanes per SM by compute capability major (Volta to Hopper)
INT32_LANES_PER_SM = {7: 64, 8: 64, 9: 64}

WORD_GEN_OPS = {
    "B3/S23": 15,
    "R5,C0,M1,S34..58,B34..45": 7,
}

# K2's instructions a cell-generation, for a reader of the seam band's or
# a dense cell's roofline
K2_CELL_GEN_OPS = 1.5


def word_gen_ops(config: dict) -> float:
    """Frozen instructions per word-generation of a configuration's rule:
    this table's, or, for a rule it does not hold, the configuration file's
    ``word_generation_ops`` (which states its derivation beside it)."""
    rule = config["rule"].strip().upper()
    if rule in WORD_GEN_OPS:
        return WORD_GEN_OPS[rule]
    if "word_generation_ops" in config:
        return config["word_generation_ops"]
    raise KeyError(f"no frozen instruction count for rule {rule!r}")


def int32_ops_per_s(index: int = 0) -> float:
    """The card's int32 instruction rate: SMs x int32 lanes per SM x SM
    clock (``clock_rate`` of the device's properties, in kHz).  Raises off
    the card."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the int32 peak is the card's")
    props = torch.cuda.get_device_properties(index)
    lanes = INT32_LANES_PER_SM.get(props.major)
    khz = getattr(props, "clock_rate", 0)
    if lanes is None or not khz:
        raise RuntimeError(f"no int32 lane count or SM clock for "
                           f"{props.name} (compute capability "
                           f"{props.major}.{props.minor})")
    return float(props.multi_processor_count * lanes * khz * 1e3)


def least_time_s(ops: float, nbytes: float, ops_per_s: float,
                 bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """The least time for ``ops`` int32 instructions and ``nbytes`` bytes
    of HBM traffic."""
    return max(ops / ops_per_s, nbytes / bytes_per_s)
