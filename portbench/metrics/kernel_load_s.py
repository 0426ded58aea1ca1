"""Host seconds the program spent building and loading its kernel
libraries (``ops/_build.py``: ``load_library``, ``load_variant_library``,
``load_rule_library``, nvcc included), read from the program's counter
``load_seconds`` when the run ends.  Every library loads in set-up
(``Engine.warm_up``), so that is its value at the end of set-up.  None
where the program keeps no such counter."""

import sys


def read(trace, work):
    build = sys.modules.get("mpi_tpu_torch.ops._build")
    return getattr(build, "load_seconds", None)
