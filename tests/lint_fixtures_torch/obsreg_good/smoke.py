"""Fixture smoke: expectations match the registry exactly."""

REQUIRED = ["mpi_tpu_fixture_steps_total"]
SPAN_KINDS = {"fixture_step"}
