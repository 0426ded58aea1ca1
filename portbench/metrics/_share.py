"""What the roofline readers share: a kernel's share of its roofline."""

from portbench import roofline


def kernel_roofline(trace, work, kid: str, board_passes=None):
    """The least time for the work of kernel ``kid`` in the traced window
    over its device time there, in percent; None without a record of it,
    or off the card.  The work is ``board_passes`` boards each stepped
    ``gens_per_pass`` generations (default: one board a launch record), at
    the rule's frozen instructions per word-generation (``word_gen_ops``),
    and one read and one write of each board."""
    launches, seconds = trace.kernel(kid)
    if not launches or seconds <= 0 or "int32_ops_per_s" not in work:
        return None
    passes = launches if board_passes is None else board_passes
    ops = (passes * work["gens_per_pass"] * work["cells"] / 32
           * work["word_gen_ops"])
    nbytes = 2 * passes * work["board_bytes"]
    least = roofline.least_time_s(ops, nbytes, work["int32_ops_per_s"],
                                  work["hbm_bytes_per_s"])
    return 100 * least / seconds
