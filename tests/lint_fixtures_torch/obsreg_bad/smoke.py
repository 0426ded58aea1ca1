"""Fixture smoke: expects a family and a span that do not exist."""

REQUIRED = [
    "mpi_tpu_fixture_steps_total",
    "mpi_tpu_fixture_phantom_total",
]
SPAN_KINDS = {"fixture_step", "fixture_ghost2"}
