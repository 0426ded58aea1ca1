"""Fixture module: drifted in every direction the rule checks."""


class Obs:
    def __init__(self, m):
        self.steps = m.counter(
            "mpi_tpu_fixture_steps_total", "steps taken")
        # registered but never mentioned in the README
        self.latency = m.histogram(
            "mpi_tpu_fixture_latency_seconds", "step latency")

    def tick(self, tracer):
        with tracer.span("fixture_step"):
            self.steps.series(status="ok").inc()
        # emitted but missing from the README span table
        tracer.event("fixture_orphan", note="oops")
