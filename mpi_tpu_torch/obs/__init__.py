"""``mpi_tpu_torch.obs`` — the tracing context the serve layer carries
across threads (``trace.py``: request ids; ``tracectx.py``: trace
contexts).  The rest of the reference's ``mpi_tpu.obs`` (metrics, usage
ledger, cost cards, profiles) is ROADMAP queue 1 item 11b."""
